"""The roi mechanism's operations against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``basi_tpu/ops/roi.py`` (vmapped
over the batch and ROI dims) and ``basi_tpu_torch/ops/roi.py``, and the
heads, targets and loss of the mechanism through both packages, in f32
with JAX at ``precision=highest``. Tolerances, each stated again where it
is asserted:

* ``roi_align``, ``paste_rois``, ``decode_cell_boxes`` and ``box_iou``:
  1e-5, on the same boxes bit for bit (XLA fuses the sample coordinates'
  multiply-adds, so they part by an ulp of a coordinate up to the grid's
  size: 7.6e-6 at 128), with degenerate (y1 <= y0), edge-clipped and zero
  boxes among them; the decode's and the IoU's gradients within 1e-5, the
  IoU's in float64 within 1e-12 with ties (touching, equal and zero
  boxes), where the gradient of a maximum splits on both sides;
* the heads, on converted weights: 1e-5;
* ``assign_targets_roi``: indices and boxes exactly, masks exactly; on a
  batch of edge cases (an empty valid slot, an image with no valid
  instance, contested cells) it, ``assign_targets_sparse`` and
  ``instance_stats`` exactly, but the centres of mass within 1e-6;
* ``basi_roi_loss``: the loss, each metric and the gradients w.r.t. every
  output within 1e-5.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basi_tpu.models import heads as JH
from basi_tpu.models.basi import BASIOutputs as JaxOutputs
from basi_tpu.ops import roi as J
from basi_tpu.ops.resize import maxpool_hw as jax_maxpool_hw
from basi_tpu.train import loss as jax_loss
from basi_tpu.train import targets as jax_targets
from basi_tpu_torch import convert
from basi_tpu_torch.models import heads as H
from basi_tpu_torch.models.basi import BASIOutputs
from basi_tpu_torch.ops import roi as T
from basi_tpu_torch.train import loss as TL
from basi_tpu_torch.train import targets as TT

from helpers import tiny_batch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def boxes_with_edge_cases(rng, n: int, k: int) -> np.ndarray:
    """(n, k, 4) f32 boxes: random ordered ones, and in each image a
    full-frame box, boxes clipped at 0 and at 1, a degenerate one (y1 <
    y0, x1 == x0), a zero box and a tiny one."""
    b = rng.rand(n, k, 4).astype(np.float32)
    b = np.concatenate([np.minimum(b[..., :2], b[..., 2:]),
                        np.maximum(b[..., :2], b[..., 2:])], -1)
    special = np.array([[0.0, 0.0, 1.0, 1.0],
                        [0.0, 0.0, 0.4, 0.3],
                        [0.6, 0.7, 1.0, 1.0],
                        [0.7, 0.6, 0.5, 0.6],
                        [0.0, 0.0, 0.0, 0.0],
                        [0.45, 0.3, 0.46, 0.31]], np.float32)
    b[:, :len(special)] = special
    return b


def test_roi_align_matches_jax():
    """(N, K, R, R, E) crops within 1e-5, f32 and bf16 features (bf16: the
    f32 result rounded once, equal to JAX's but where the f32 sums part
    across a rounding boundary: within one bf16 ulp)."""
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 16, 12, 5).astype(np.float32)
    boxes = boxes_with_edge_cases(rng, 2, 9)
    for r in (7, 8):
        want = jax.vmap(lambda f, b: J.roi_align(f, b, r))(
            jnp.asarray(feats), jnp.asarray(boxes))
        got = T.roi_align(_t(feats), _t(boxes), r)
        assert got.shape == (2, 9, r, r, 5) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    fb = jnp.asarray(feats, jnp.bfloat16)
    want = jax.vmap(lambda f, b: J.roi_align(f, b, 8))(fb, jnp.asarray(boxes))
    got = T.roi_align(_t(np.asarray(fb.astype(jnp.float32))).bfloat16(),
                      _t(boxes), 8)
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w, rtol=2 ** -8, atol=1e-5)


def test_paste_rois_matches_jax():
    """(N, K, oh, ow) canvases within 1e-5 on the same boxes: a pixel is
    inside a box on both sides alike (the same f32 comparison of the same
    numbers); outside every box the canvas is 0."""
    rng = np.random.RandomState(1)
    boxes = boxes_with_edge_cases(rng, 2, 9)
    patches = rng.rand(2, 9, 8, 8).astype(np.float32)
    for hw in ((16, 16), (16, 12)):
        want = jax.vmap(lambda p, b: J.paste_rois(p, b, hw))(
            jnp.asarray(patches), jnp.asarray(boxes))
        got = T.paste_rois(_t(patches), _t(boxes), hw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
        assert np.array_equal(got.numpy() == 0, np.asarray(want) == 0)
    zero = T.paste_rois(_t(patches), _t(boxes), (16, 16))[:, 4]
    assert float(zero.abs().max()) == 0.0  # the zero box pastes nothing


def test_decode_cell_boxes_and_gradient_match_jax():
    """Boxes within 1e-5 (one ulp apart at most: XLA's softplus rounds
    otherwise), clipped at 0 and 1 where large logits push them; the
    gradient of a weighted sum within 1e-5."""
    rng = np.random.RandomState(2)
    raw = (rng.randn(3, 8, 8, 4) * 3).astype(np.float32)
    raw[0, 0, 0] = 40.0  # every side far past the frame: clipped
    w = rng.randn(3, 8, 8, 4).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda r: jnp.sum(J.decode_cell_boxes(r, 8) * w))(jnp.asarray(raw))
    x = _t(raw).clone().requires_grad_()
    boxes = T.decode_cell_boxes(x, 8)
    got = (boxes * _t(w)).sum()
    got.backward()
    np.testing.assert_allclose(
        boxes.detach().numpy(),
        np.asarray(J.decode_cell_boxes(jnp.asarray(raw), 8)), atol=1e-5,
        rtol=0)
    assert boxes[0, 0, 0].tolist() == [0.0, 0.0, 1.0, 1.0]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-5,
                               rtol=0)


def test_box_iou_and_gradient_match_jax():
    """IoU within 1e-5 in f32; in float64 the IoU within 1e-12 and its
    gradient w.r.t. both boxes within 1e-12, with ties: boxes that touch,
    equal boxes and zero boxes."""
    rng = np.random.RandomState(3)
    a = boxes_with_edge_cases(rng, 1, 40)[0]
    b = boxes_with_edge_cases(rng, 1, 40)[0][::-1].copy()
    b[10] = a[10]  # equal
    b[11] = [a[11, 2], a[11, 1], 1.0, a[11, 3]]  # touching at y
    np.testing.assert_allclose(
        T.box_iou(_t(a), _t(b)).numpy(),
        np.asarray(J.box_iou(jnp.asarray(a), jnp.asarray(b))), atol=1e-5,
        rtol=0)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    with jax.enable_x64(True):
        want, (ga, gb) = jax.value_and_grad(
            lambda x, y: jnp.sum(J.box_iou(x, y) * jnp.arange(40.0)),
            argnums=(0, 1))(jnp.asarray(a64), jnp.asarray(b64))
        want, ga, gb = (np.asarray(v) for v in (want, ga, gb))
    x, y = (_t(v).clone().requires_grad_() for v in (a64, b64))
    got = (T.box_iou(x, y) * torch.arange(40.0, dtype=torch.float64)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-12)
    np.testing.assert_allclose(x.grad.numpy(), ga, atol=1e-12, rtol=0)
    np.testing.assert_allclose(y.grad.numpy(), gb, atol=1e-12, rtol=0)


def _head_state_dict(params: dict) -> dict:
    """A JAX head's params as the port's head's state dict."""
    out: dict = {}
    for name, entry in params.items():
        if name.startswith("gn"):
            convert._put_norm(out, name, entry)
        else:
            convert._put_conv(out, name, entry)
    return {k: _t(v) for k, v in out.items()}


def test_roi_box_head_matches_jax():
    """Objectness and box logits within 1e-5 on converted weights."""
    rng = np.random.RandomState(4)
    feat = rng.randn(2, 8, 8, 32).astype(np.float32)
    jhead = JH.RoiBoxHead(grid_size=8, channels=32)
    params = jax.tree.map(np.asarray, jhead.init(
        jax.random.PRNGKey(0), jnp.asarray(feat))["params"])
    scores, boxes = jhead.apply({"params": params}, jnp.asarray(feat))
    head = H.RoiBoxHead(32, 32, 8, 3)
    head.load_state_dict(_head_state_dict(params), strict=True)
    with torch.no_grad():
        s, b = head(_t(feat).permute(0, 3, 1, 2))
    for got, want in ((s, scores), (b, boxes)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=1e-5, rtol=0)


def test_roi_mask_head_matches_jax():
    """(N, K, R, R) mask logits within 1e-5 on converted weights, and no
    gradient reaches the boxes (they are detached, as JAX stops it)."""
    rng = np.random.RandomState(5)
    feats = rng.randn(2, 16, 16, 32).astype(np.float32)
    boxes = boxes_with_edge_cases(rng, 2, 7)
    jhead = JH.RoiMaskHead(resolution=8, channels=32)
    params = jax.tree.map(np.asarray, jhead.init(
        jax.random.PRNGKey(1), jnp.asarray(feats),
        jnp.asarray(boxes))["params"])
    want = jhead.apply({"params": params}, jnp.asarray(feats),
                       jnp.asarray(boxes))
    head = H.RoiMaskHead(32, 32, 8, 2)
    head.load_state_dict(_head_state_dict(params), strict=True)
    b = _t(boxes).clone().requires_grad_()
    f = _t(feats).clone().requires_grad_()
    got = head(f, b)
    assert got.shape == (2, 7, 8, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    got.sum().backward()
    assert b.grad is None and float(f.grad.abs().sum()) > 0


@pytest.fixture(scope="module")
def gt():
    b = tiny_batch(np.random.RandomState(5), n=4)
    return b["masks"], b["valid"]


def _jax_roi_targets(small, valid, stats, max_pos):
    kw = dict(grid_size=8, mask_hw=(16, 16), max_pos_cells=max_pos)
    if stats is None:
        return jax.vmap(lambda m, v: jax_targets.assign_targets_roi(
            m, v, **kw))(jnp.asarray(small), jnp.asarray(valid))
    return jax.vmap(lambda m, v, s: jax_targets.assign_targets_roi(
        m, v, stats=s, **kw))(jnp.asarray(small), jnp.asarray(valid), stats)


@pytest.mark.parametrize("with_stats,max_pos", [(True, 64), (False, 64),
                                                (True, 2)])
def test_assign_targets_roi_matches_jax(gt, with_stats, max_pos):
    """/4 masks with full-resolution stats (as the step runs it) or
    without (full-resolution masks then, as the multiscale step gives
    them), and a cap below the positives count: every output equal."""
    masks, valid = gt
    small = np.asarray(jax_maxpool_hw(jnp.asarray(masks), 4, 4))
    stats = jax.vmap(jax_targets.instance_stats)(jnp.asarray(masks),
                                                 jnp.asarray(valid))
    if with_stats:
        want = _jax_roi_targets(small, valid, stats, max_pos)
        got = TT.assign_targets_roi(
            _t(small), _t(valid), grid_size=8, mask_hw=(16, 16),
            max_pos_cells=max_pos, stats={k: _t(v) for k, v in stats.items()})
    else:
        full = masks.astype(np.float32)
        want = _jax_roi_targets(full, valid, None, max_pos)
        got = TT.assign_targets_roi(_t(full), _t(valid), grid_size=8,
                                    mask_hw=(16, 16), max_pos_cells=max_pos)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[4].max()) > max_pos or max_pos == 64  # the cap bites
    assert float(got[2].sum()) > 0 and float(got[5].abs().sum()) > 0


def _edge_case_gt():
    """(masks (3, 4, 64, 64) u8, valid (3, 4) u8). Image 0: a large square
    and a small one on the same centre, so the small one claims every cell
    of the large one's centre region; a valid slot with an empty mask (the
    +-2 sentinels); an invalid slot with content. Image 1: content in every
    slot, none valid (every cell ``inf``: argmin's first index). Image 2:
    two equal squares 4 px apart; the second's centre region is a column of
    the first's (the tie goes to the first), and a valid empty slot."""
    masks = np.zeros((3, 4, 64, 64), np.uint8)
    valid = np.zeros((3, 4), np.uint8)
    masks[0, 0, 8:56, 8:56] = 1
    masks[0, 1, 28:36, 28:36] = 1
    masks[0, 3, 2:10, 50:60] = 1
    valid[0, :3] = 1
    masks[1, :, 10:30, 20:40] = 1
    masks[2, 0, 28:36, 28:36] = 1
    masks[2, 1, 28:36, 32:40] = 1
    valid[2, :3] = 1
    return masks, valid


@pytest.mark.parametrize("fn,with_stats", [
    ("instance_stats", True), ("sparse", True), ("sparse", False),
    ("roi", True), ("roi", False)])
def test_targets_edge_cases_equal_jax(fn, with_stats):
    """``instance_stats`` and the sparse and roi targets on a valid empty
    slot, an image with no valid instance and cells claimed by two
    instances (smaller and equal areas): every output equal to the JAX
    package's, but the centres of mass within 1e-6 (sums taken in another
    order). With stats, each package's own full-resolution stats and the
    /4 masks, as the step runs it; without, the full-resolution masks."""
    masks, valid = _edge_case_gt()
    jstats = jax.vmap(jax_targets.instance_stats)(jnp.asarray(masks),
                                                  jnp.asarray(valid))
    tstats = TT.instance_stats(_t(masks), _t(valid))
    assert float(tstats["area"][0, 2]) == float(tstats["valid"][0, 2]) == 0
    assert float(tstats["valid"][1].sum()) == 0
    if fn == "instance_stats":
        for k, v in tstats.items():
            w = np.asarray(jstats[k])
            assert v.dtype == torch.float32, k
            if k in ("cy", "cx"):
                np.testing.assert_allclose(v.numpy(), w, atol=1e-6, rtol=0)
            else:
                np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
        return
    small = np.asarray(jax_maxpool_hw(jnp.asarray(masks), 4, 4), np.float32)
    kw = dict(grid_size=8, mask_hw=(16, 16), max_pos_cells=64)
    jfn = {"sparse": jax_targets.assign_targets_sparse,
           "roi": jax_targets.assign_targets_roi}[fn]
    tfn = {"sparse": TT.assign_targets_sparse,
           "roi": TT.assign_targets_roi}[fn]
    if with_stats:
        want = jax.vmap(lambda m, v, s: jfn(m, v, stats=s, **kw))(
            jnp.asarray(small), jnp.asarray(valid), jstats)
        got = tfn(_t(small), _t(valid), stats=tstats, **kw)
    else:
        full = masks.astype(np.float32)
        want = jax.vmap(lambda m, v: jfn(m, v, **kw))(jnp.asarray(full),
                                                      jnp.asarray(valid))
        got = tfn(_t(full), _t(valid), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert all(g.dtype == torch.float32 for g in got[1:])
    _, tgt, pos, _, num_pos = got[:5]
    # image 0: the small square wins all four of the large one's cells
    assert float(num_pos[0]) == 4 and float(num_pos[1]) == 0
    np.testing.assert_array_equal(tgt[0, :4].numpy(),
                                  np.broadcast_to(small[0, 1], (4, 16, 16)))
    # image 2: the second square's column of cells goes to the first
    assert float(num_pos[2]) == 4 and float(pos[2, :4].sum()) == 4
    np.testing.assert_array_equal(tgt[2, :4].numpy(),
                                  np.broadcast_to(small[2, 0], (4, 16, 16)))


def test_basi_roi_loss_matches_jax(gt):
    """The roi loss, each metric (``box_iou`` among them) and the
    gradients w.r.t. every output, the box logits through the decode,
    within 1e-5, on random outputs and the assigned targets of /4 GT with
    full-resolution stats."""
    masks, valid = gt
    n, p, r = masks.shape[0], 16, 8
    rng = np.random.RandomState(6)
    outs = {"saliency_logits": rng.randn(n, 16, 16, 1),
            "cell_scores": rng.randn(n, 8, 8, 1) - 2,
            "box_raw": rng.randn(n, 8, 8, 4),
            "mask_feats": rng.randn(n, 16, 16, 32) * 0.3,
            "roi_mask_logits": rng.randn(n, p, r, r) * 2,
            "aux": rng.randn(4, n, 16, 16, 1)}
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    small = np.asarray(jax_maxpool_hw(jnp.asarray(masks), 4, 4), np.float32)
    stats = jax.vmap(jax_targets.instance_stats)(jnp.asarray(masks),
                                                 jnp.asarray(valid))
    parts = _jax_roi_targets(small, valid, stats, p)
    targets = dict(zip(TL.ROI_TARGETS, (np.asarray(v) for v in parts)))
    assert targets["pos_sel"].sum() > 0

    def jax_fn(o):
        out = JaxOutputs(o["saliency_logits"], tuple(o["aux"]),
                         o["cell_scores"], None, o["mask_feats"], None,
                         cell_boxes=J.decode_cell_boxes(o["box_raw"], 8),
                         roi_mask_logits=o["roi_mask_logits"])
        return jax_loss.basi_roi_loss(
            out, {k: jnp.asarray(v) for k, v in targets.items()},
            jnp.asarray(small), jnp.asarray(valid))

    (want, want_m), want_g = jax.value_and_grad(jax_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outs.items()})
    to = {k: _t(v).requires_grad_() for k, v in outs.items()}
    out = BASIOutputs(to["saliency_logits"], to["cell_scores"], None,
                      to["mask_feats"], tuple(to["aux"]),
                      cell_boxes=T.decode_cell_boxes(to["box_raw"], 8),
                      roi_mask_logits=to["roi_mask_logits"])
    got, got_m = TL.basi_roi_loss(out, {k: _t(v) for k, v in targets.items()},
                                  _t(small), _t(valid))
    got.backward()
    assert set(got_m) == set(want_m) and "box_iou" in got_m
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    for k in outs:
        if k == "mask_feats":  # the roi loss reads no mask features
            assert to[k].grad is None and not np.asarray(want_g[k]).any()
            continue
        np.testing.assert_allclose(to[k].grad.numpy(), np.asarray(want_g[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
