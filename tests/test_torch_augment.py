"""The port's augmentation and the losses and targets of the training
settings against the JAX package's, on the CPU.

The same numpy inputs (seeded) go through the JAX functions and the port's,
in f32 (JAX at ``precision=highest``, as ``tests/conftest.py`` sets it).
Tolerances, each stated again where it is asserted:

* scale jitter (``random_augment``): images within 1e-5; masks equal
  wherever JAX's value before the 0.5 threshold lies more than 1e-5 from
  0.5 (a value within that band may round to either side in two
  frameworks); the interpolation matrices within 1e-6;
* colour jitter: within 1e-5, with the factors of JAX's key tree;
* SSIM, soft IoU and the BASNet-hybrid saliency loss, values and
  gradients: 1e-5;
* the bilinear GT fallback of the targets and the dense loss: 1e-5.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basi_tpu.data import transforms as JT
from basi_tpu.models.basi import BASIOutputs as JaxOutputs
from basi_tpu.models.heads import candidate_masks as jax_candidates
from basi_tpu.ops import losses as JL
from basi_tpu.ops.resize import maxpool_hw as jax_maxpool_hw
from basi_tpu.train import loss as jax_loss
from basi_tpu.train import targets as jax_targets
from basi_tpu_torch.data import transforms as T
from basi_tpu_torch.models.basi import BASIOutputs, candidate_masks
from basi_tpu_torch.ops import losses as L
from basi_tpu_torch.train import loss as TL
from basi_tpu_torch.train import step as TSTEP
from basi_tpu_torch.train import targets as TT
from basi_tpu_torch.train.state import TrainState

from helpers import tiny_batch, tiny_config

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
TIE_BAND = 1e-5


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


# --- scale jitter -----------------------------------------------------------

def _jax_pre_threshold(masks, scale, off_y, off_x):
    """JAX's resampled masks before ``> 0.5``: ``scale_jitter_one``'s own
    steps, one image at a time."""
    out = []
    h, w = masks.shape[-2:]
    prec = jax.lax.Precision.HIGHEST
    for m, s, oy, ox in zip(masks, scale, off_y, off_x):
        r = 1.0 / jnp.float32(s)
        wy = JT.dynamic_interp_matrix(h, h, r, jnp.float32(oy) * (h - r * h))
        wx = JT.dynamic_interp_matrix(w, w, r, jnp.float32(ox) * (w - r * w))
        v = jnp.einsum("oh,mhw->mow", wy, jnp.asarray(m, jnp.float32),
                       precision=prec)
        out.append(np.asarray(jnp.einsum("pw,mow->mop", wx, v,
                                         precision=prec)))
    return np.stack(out)


SCALES = {"zoom in and out": [0.75, 1.25, 1.0, 0.9, 1.13, 0.8],
          "the preset's range, seeded": None}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scales", list(SCALES))
def test_random_augment_matches_jax(scales, dtype):
    """Per-image scale and offsets (offsets 0 and 1 among them): images
    within 1e-5 (bf16: the same rounding of values within 1e-5, so within
    one bf16 step where they tie), masks equal outside the 1e-5 band
    around 0.5 of JAX's pre-threshold values, flips none (the ingest's)."""
    rng = np.random.RandomState(3)
    n, m, h, w = 6, 4, 40, 48
    s = SCALES[scales]
    scale = (np.asarray(s, np.float32) if s is not None
             else rng.uniform(0.75, 1.25, n).astype(np.float32))
    off_y = rng.rand(n).astype(np.float32)
    off_x = rng.rand(n).astype(np.float32)
    off_y[:2], off_x[:2] = (0.0, 1.0), (1.0, 0.0)
    imgs = rng.randn(n, h, w, 3).astype(np.float32)
    b = tiny_batch(rng, n=n, size=48, m=m)
    masks = b["masks"][:, :, :h].astype(np.float32)
    jdt = jnp.dtype(dtype)
    want_i, want_m = jax.vmap(JT.scale_jitter_one)(
        jnp.asarray(imgs, jdt), jnp.asarray(masks), jnp.asarray(scale),
        jnp.asarray(off_y), jnp.asarray(off_x))
    tdt = getattr(torch, dtype)
    got_i, got_m = T.random_augment(_t(imgs).to(tdt), _t(masks), _t(scale),
                                    _t(off_y), _t(off_x))
    assert got_i.dtype == tdt and got_m.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * np.abs(imgs).max()
    np.testing.assert_allclose(got_i.float().numpy(),
                               np.asarray(want_i.astype(jnp.float32)),
                               atol=tol, rtol=0)
    pre = _jax_pre_threshold(masks, scale, off_y, off_x)
    np.testing.assert_array_equal(np.asarray(want_m), pre > 0.5)
    clear = np.abs(pre - 0.5) > TIE_BAND
    np.testing.assert_array_equal(got_m.numpy()[clear],
                                  np.asarray(want_m)[clear])
    assert clear.mean() > 0.99
    if s is not None:
        # zoomed out at the top: the bottom row is zero; zoomed in: the
        # crop fills the frame
        assert np.all(got_i[0, -1].float().numpy() == 0)
        assert np.count_nonzero(got_i[1, -1].float().numpy()) > 0


def test_dynamic_interp_matrix_matches_jax(rng):
    """Zoom in, zoom out and placements off the frame: within 1e-6."""
    scale = np.array([0.8, 1.25, 1.0], np.float32)
    off = np.array([-3.5, 7.25, 0.0], np.float32)
    got = T.dynamic_interp_matrix(24, 20, _t(scale), _t(off))
    for i in range(3):
        want = JT.dynamic_interp_matrix(24, 20, jnp.float32(scale[i]),
                                        jnp.float32(off[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   atol=1e-6, rtol=0)


def test_true_f32_matmul_restores_the_setting():
    m = torch.backends.cuda.matmul
    before = m.allow_tf32
    for prev in (True, False):
        m.allow_tf32 = prev
        with T.true_f32_matmul():
            assert m.allow_tf32 is False
        assert m.allow_tf32 is prev
    m.allow_tf32 = before


# --- colour jitter ----------------------------------------------------------

def _jax_factors(key, n, strengths):
    """The factors ``color_jitter`` draws from ``key``: its own key tree."""
    out = []
    for k, x in zip(jax.random.split(key, 3), strengths):
        out.append(np.asarray(jax.random.uniform(
            k, (n, 1, 1, 1), jnp.float32, minval=max(0.0, 1.0 - x),
            maxval=1.0 + x)).reshape(n))
    return out


@pytest.mark.parametrize("strengths", [(0.2, 0.2, 0.2), (0.5, 0.0, 0.0),
                                       (0.0, 0.5, 0.0), (0.0, 0.0, 0.5),
                                       (0.4, 0.3, 0.5)])
def test_color_jitter_matches_jax(strengths):
    """Each op alone and all three, with JAX's factors: within 1e-5; bf16
    images come back bf16."""
    rng = np.random.RandomState(1)
    pix = rng.rand(3, 16, 12, 3).astype(np.float32)
    x = ((pix - np.asarray(MEAN, np.float32)) / np.asarray(STD, np.float32)
         ).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = JT.color_jitter(key, jnp.asarray(x), MEAN, STD, *strengths)
    f = [_t(v) for v in _jax_factors(key, 3, strengths)]
    got = T.color_jitter(_t(x), MEAN, STD, *strengths, *f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    bf = T.color_jitter(_t(x).bfloat16(), MEAN, STD, *strengths, *f)
    assert bf.dtype == torch.bfloat16


def test_color_jitter_off_and_packed_layout():
    x = torch.ones(2, 4, 4, 3)
    one = torch.ones(2)
    assert T.color_jitter(x, MEAN, STD, 0.0, 0.0, 0.0, one, one, one) is x
    with pytest.raises(ValueError, match="C % 3"):
        T.color_jitter(torch.ones(2, 4, 4, 4), MEAN, STD, 0.2, 0, 0,
                       one, one, one)
    with pytest.raises(ValueError, match="not ported"):
        T.color_jitter(torch.ones(2, 4, 4, 12), MEAN, STD, 0.2, 0, 0,
                       one, one, one)


def test_draw_augment_streams_are_independent():
    """The seven draws come in one fixed order, so turning the jitter or
    the scale jitter on changes no flip or scale; the ranges are
    ``scale_range`` and [max(0, 1 - x), 1 + x)."""
    cfg = tiny_config().data

    def draws(**kw):
        state = TrainState(None, None, None, 0,
                           torch.Generator().manual_seed(3))
        return TSTEP.draw_augment(state, 64, dataclasses.replace(cfg, **kw))

    plain = draws()
    both = draws(color_jitter=(0.2, 0.5, 1.5), multiscale=True)
    for a, b in zip(plain[:4], both[:4]):
        assert torch.equal(a, b)
    assert plain.flip.dtype == torch.int32 and 0 < plain.flip.sum() < 64
    lo, hi = cfg.scale_range
    assert lo <= float(plain.scale.min()) and float(plain.scale.max()) < hi
    assert float(both.brightness.min()) >= 0.8
    assert float(both.brightness.max()) < 1.2
    assert float(both.saturation.min()) >= 0.0
    assert float(both.saturation.max()) < 2.5
    assert torch.equal(plain.brightness, torch.ones(64))


# --- the hybrid loss --------------------------------------------------------

@pytest.mark.parametrize("name", ["ssim_loss", "soft_iou_loss",
                                  "saliency_loss"])
def test_hybrid_losses_match_jax(name, rng):
    """SSIM (11 x 11 box window over zero padding), soft IoU and the
    BASNet-hybrid saliency loss: value and gradient within 1e-5."""
    logits = (rng.randn(3, 20, 24, 1) * 2).astype(np.float32)
    target = (rng.rand(3, 20, 24) > 0.6).astype(np.float32)
    if name == "saliency_loss":
        def jf(lg):
            return JL.saliency_loss(lg, target, "basnet_hybrid")

        def tf(lg):
            return L.saliency_loss(lg, _t(target), "basnet_hybrid")
    else:
        lg2 = logits[..., 0]

        def jf(lg):
            return getattr(JL, name)(lg, target)

        def tf(lg):
            return getattr(L, name)(lg, _t(target))

        logits = lg2
    want, want_g = jax.value_and_grad(jf)(jnp.asarray(logits))
    xt = _t(logits).clone().requires_grad_()
    got = tf(xt)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                               atol=1e-5, rtol=0)


def test_ssim_takes_both_layouts(rng):
    lg = _t(rng.randn(2, 16, 16).astype(np.float32))
    tg = _t((rng.rand(2, 16, 16) > 0.5).astype(np.float32))
    assert torch.equal(L.ssim_loss(lg, tg), L.ssim_loss(lg[..., None],
                                                        tg[..., None]))
    with pytest.raises(ValueError, match="ssim expects"):
        L.ssim_loss(lg[0], tg[0])


# --- targets and the dense loss ---------------------------------------------

@pytest.fixture(scope="module")
def gt():
    b = tiny_batch(np.random.RandomState(5), n=4)
    return b["masks"], b["valid"]


@pytest.mark.parametrize("size", [60, 50])
def test_bilinear_gt_fallback_matches_jax(gt, size):
    """GT that is not an integer multiple of the 16 x 16 mask resolution
    (60 and 50 pixels) goes through the bilinear resize and the 0.5
    threshold: sparse and dense targets within 1e-5, indices equal. Both
    sides take JAX's instance statistics, so the cells are assigned alike
    and only the resize is compared (at 60 pixels one cell centre lies on
    an instance's centre-box edge, where the two frameworks' sums of the
    centre round to either side)."""
    masks, valid = gt
    masks = masks[..., :size, :size]
    stats = jax.vmap(jax_targets.instance_stats)(jnp.asarray(masks),
                                                 jnp.asarray(valid))
    tstats = {k: _t(v) for k, v in stats.items()}
    kw = dict(grid_size=8, mask_hw=(16, 16), center_sigma=0.2)
    want = jax.vmap(lambda m, v, st: jax_targets.assign_targets_sparse(
        m, v, max_pos_cells=64, stats=st, **kw))(
        jnp.asarray(masks), jnp.asarray(valid), stats)
    got = TT.assign_targets_sparse(_t(masks), _t(valid), max_pos_cells=64,
                                   stats=tstats, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    assert float(got[1].sum()) > 0
    want_d = jax_targets.assign_targets_batch(
        jnp.asarray(masks), jnp.asarray(valid), stats=stats, **kw)
    got_d = TT.assign_targets(_t(masks), _t(valid), stats=tstats, **kw)
    for g, w in zip(got_d, want_d):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("with_stats", [True, False])
def test_dense_targets_match_jax(gt, with_stats):
    """``assign_targets`` on /4 masks, with full-resolution stats or
    without: within 1e-5."""
    masks, valid = gt
    small = np.asarray(jax_maxpool_hw(jnp.asarray(masks), 4, 4))
    stats = jax.vmap(jax_targets.instance_stats)(jnp.asarray(masks),
                                                 jnp.asarray(valid))
    kw = dict(grid_size=8, mask_hw=(16, 16), center_sigma=0.2)
    want = jax_targets.assign_targets_batch(
        jnp.asarray(small), jnp.asarray(valid),
        stats=stats if with_stats else None, **kw)
    got = TT.assign_targets(
        _t(small), _t(valid),
        stats={k: _t(v) for k, v in stats.items()} if with_stats else None,
        **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_candidate_masks_match_jax(rng):
    feats = rng.randn(2, 16, 16, 32).astype(np.float32)
    kernels = rng.randn(2, 8, 8, 32).astype(np.float32)
    want = jax_candidates(jnp.asarray(feats), jnp.asarray(kernels))
    got = candidate_masks(_t(feats), _t(kernels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("loss_kind", ["bce_dice", "basnet_hybrid"])
def test_dense_basi_loss_matches_jax(gt, rng, loss_kind):
    """The dense path (the model's candidate masks, every cell weighted by
    its positivity) with either saliency loss: the total, each metric and
    the gradient w.r.t. every output within 1e-5."""
    masks, valid = gt
    n = masks.shape[0]
    outs = {"saliency_logits": rng.randn(n, 16, 16, 1),
            "cell_scores": rng.randn(n, 8, 8, 1) - 2,
            "cell_kernels": rng.randn(n, 8, 8, 32) * 0.3,
            "mask_feats": rng.randn(n, 16, 16, 32) * 0.3,
            "mask_logits": rng.randn(n, 64, 16, 16) * 2,
            "aux": rng.randn(4, n, 16, 16, 1)}
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    small = np.asarray(jax_maxpool_hw(jnp.asarray(masks), 4, 4), np.float32)
    stats = jax.vmap(jax_targets.instance_stats)(jnp.asarray(masks),
                                                 jnp.asarray(valid))

    def jax_fn(o):
        out = JaxOutputs(o["saliency_logits"], tuple(o["aux"]),
                         o["cell_scores"], o["cell_kernels"], o["mask_feats"],
                         o["mask_logits"])
        return jax_loss.basi_loss(out, jnp.asarray(small), jnp.asarray(valid),
                                  gt_stats=stats, loss_kind=loss_kind,
                                  max_pos_cells=0)

    (want, want_m), want_g = jax.value_and_grad(jax_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outs.items()})
    to = {k: _t(v).requires_grad_() for k, v in outs.items()}
    out = BASIOutputs(to["saliency_logits"], to["cell_scores"],
                      to["cell_kernels"], to["mask_feats"], tuple(to["aux"]),
                      to["mask_logits"])
    got, got_m = TL.basi_loss(out, _t(small), _t(valid), loss_kind=loss_kind,
                              max_pos_cells=0,
                              gt_stats={k: _t(v) for k, v in stats.items()})
    got.backward()
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    for k in outs:
        want_k = np.asarray(want_g[k])
        if to[k].grad is None:  # not read by the dense path: JAX's zeros
            assert not want_k.any(), k
            continue
        np.testing.assert_allclose(to[k].grad.numpy(), want_k, atol=1e-5,
                                   rtol=0, err_msg=k)
    with pytest.raises(ValueError, match="with_candidates"):
        TL.basi_loss(out._replace(mask_logits=None), _t(small), _t(valid),
                     max_pos_cells=0)
