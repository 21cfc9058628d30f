"""The port in bf16 against the JAX package in bf16, on the CPU.

Serving (``infer.dtype=bfloat16``, the main path's dtype): the JAX
``Inferencer`` and the port's, on the same JAX variables
(``test_torch_model.jax_variables``) and the uint8 batch of
``test_torch_slice``. Measured on this batch: slot scores within 5.2e-3,
/4 slot masks within 0.027 and full-resolution masks within 0.026 (bf16
probabilities: 2^-8 apart near 1). Held at:

* scores: ``SCORE_TOL`` = 1e-2 slot by slot, so slots come in the same order
  wherever JAX's neighbouring scores are further apart than that;
* masks: ``MASK_TOL`` = 5e-2 at the slot they match (``assert_slots_match``);
* a slot scored within ``SCORE_TOL`` of ``infer.score_threshold`` on one
  side may be empty on the other: whether it passes the threshold is a
  rounding decision, as the order of two scores within the tolerance is.
  On this batch JAX keeps one slot at 0.1007 that the port drops.

Where the two round apart: selection alone, fed JAX's own bf16 model
outputs, gives JAX's slots (scores within 2.3e-3, masks within one bf16
ulp, 2^-8; ``test_bf16_selection_on_jax_outputs_matches_jax``), so the
flips come from the model, whose bf16 outputs differ from JAX's by up to
4% of their largest magnitude (``test_torch_model``). Module by module
(``test_bf16_modules_round_as_the_reference``), the two part from the
first 3x3 convolution on (``layer1.0.conv2``: 6e-4 of the mean magnitude,
growing to 2e-2 at the heads), because the convolutions accumulate in
another order and so round to bf16 elsewhere; each framework's bf16
output lies as far from its own f32 output as the other's does, so no
module rounds where its counterpart does not. Thresholds (the 0.5 mask
binarization, the score threshold) and Matrix NMS's IoU decay then turn
these small differences into selection flips on a random model, whose
masks sit near 0.5.

The train step in bf16 compute on f32 params (``bench_accuracy``'s
recipe), one step of each ``model.bn_impl`` against JAX's step with the
same setting. Measured (batch of ``_run_steps``): loss within 3.2e-3
relative, every gradient within 0.133 of the largest gradient magnitude
and the gradients within 0.185 in norm. That is bf16's own noise: JAX's
bf16 gradients lie 0.162 in norm from JAX's f32 ones on the same batch
(``test_bf16_step_lies_within_bf16_noise_of_jax``). Held at 1e-2 (loss
and each metric, relative), 0.25 of the largest gradient and 0.3 in norm.

The ``fused`` and ``stats`` BatchNorms give another bf16 loss than
``xla``'s in both frameworks: (fused - xla) / xla is 1.31e-3 in JAX and
1.40e-3 in the port; the gaps agree within 3e-4 of the loss (measured
8.8e-5). So the gap belongs to the reference's BatchNorm forms (the fused
form's one-pass f32 variance of bf16 inputs against XLA's), not to the
port.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basi_tpu.infer import Inferencer as JaxInferencer
from basi_tpu.models.basi import create_model as jax_create_model
from basi_tpu_torch.convert import load_jax_variables, to_jax_variables
from basi_tpu_torch.infer import Inferencer
from basi_tpu_torch.models.basi import create_model
from basi_tpu_torch.ops.nms import select_instances_from_kernels

from helpers import tiny_batch, tiny_config
from test_torch_model import jax_variables
from test_torch_slice import BATCH, assert_slots_match
from test_torch_train import _TORCH_DTYPES, _run_steps

SCORE_TOL = 1e-2
MASK_TOL = 5e-2
ULP_NEAR_ONE = 2.0 ** -8  # a bf16 probability in [0.5, 1)


def _bf16_config(batch_size=BATCH):
    cfg = tiny_config(batch_size=batch_size)
    return dataclasses.replace(
        cfg, infer=dataclasses.replace(cfg.infer, dtype="bfloat16"))


@pytest.fixture(scope="module")
def served():
    cfg = _bf16_config()
    params, stats = jax_variables(cfg)
    images = (np.random.RandomState(2).rand(BATCH, 64, 64, 3) * 255).astype(
        np.uint8)
    jinf = JaxInferencer(cfg, params=params, batch_stats=stats)
    masks, scores, sal = jinf.predict_batch(images)
    full = jinf.full_res_masks(masks)
    want = {"masks": np.asarray(masks, np.float32),
            "scores": np.asarray(scores, np.float32),
            "sal": np.asarray(sal, np.float32),
            "full": np.asarray(full, np.float32)}
    return cfg, params, stats, images, jinf, want


def _drop_threshold_slots(got_scores, got_masks, want_scores, want_masks,
                          threshold):
    """Copies with the slots that one side leaves empty and the other fills
    within ``SCORE_TOL`` of ``threshold`` emptied on both sides; the count
    of such slots."""
    gs, gm = got_scores.copy(), got_masks.copy()
    ws, wm = want_scores.copy(), want_masks.copy()
    near = ((np.minimum(gs, ws) == 0) & (np.maximum(gs, ws) > 0)
            & (np.maximum(gs, ws) <= threshold + SCORE_TOL))
    gs[near], ws[near] = 0.0, 0.0
    gm[near], wm[near] = 0.0, 0.0
    return gs, gm, ws, wm, int(near.sum())


def test_bf16_inferencer_matches_jax(served):
    """Slot scores within ``SCORE_TOL``, /4 and full-resolution masks within
    ``MASK_TOL`` at the slot they match, saliency logits within 4% of their
    largest magnitude (``test_torch_model``'s bf16 bound); at most one slot
    of the batch differs by lying at the score threshold."""
    cfg, params, stats, images, _, want = served
    assert (want["scores"] > 0).sum() >= BATCH, "too few slots filled"
    inf = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    masks, scores, sal = inf.predict_batch(images)
    assert masks.dtype == torch.bfloat16 and scores.dtype == torch.float32
    full = inf.full_res_masks(masks)
    assert full.dtype == torch.float32 and full.shape == want["full"].shape
    thr = cfg.infer.score_threshold
    for got_m, want_m in ((masks.float().numpy(), want["masks"]),
                          (full.numpy(), want["full"])):
        gs, gm, ws, wm, dropped = _drop_threshold_slots(
            scores.numpy(), got_m, want["scores"], want_m, thr)
        assert dropped <= 1, dropped
        assert_slots_match(gs, gm, ws, wm, tol=SCORE_TOL, mask_tol=MASK_TOL)
    np.testing.assert_allclose(sal.float().numpy(), want["sal"], rtol=0,
                               atol=0.04 * np.abs(want["sal"]).max())


def test_bf16_selection_on_jax_outputs_matches_jax(served):
    """The port's selection on JAX's own bf16 model outputs (as the JAX
    ``Inferencer`` computes them) gives JAX's slots: every slot filled on
    both sides, scores within ``SCORE_TOL``, masks within one bf16 ulp of a
    probability near 1 (the f32 einsum rounds the logits to bf16 at the
    same place; the sums run in another order)."""
    cfg, _, _, images, jinf, want = served
    x = images.astype(np.float32) / 255.0
    x = (x - np.asarray(cfg.data.mean, np.float32)) / np.asarray(
        cfg.data.std, np.float32)
    model = jax_create_model(cfg.model).clone(dtype=jnp.bfloat16)
    out = model.apply({"params": jinf.params, "batch_stats": jinf.batch_stats},
                      jnp.asarray(x, jnp.bfloat16), False,
                      with_candidates=False)
    feats, kernels, cells = (
        torch.from_numpy(np.asarray(getattr(out, k), np.float32)).to(
            torch.bfloat16)
        for k in ("mask_feats", "cell_kernels", "cell_scores"))
    n, s1, s2, e = kernels.shape
    icfg = cfg.infer
    masks, scores = select_instances_from_kernels(
        feats, kernels.reshape(n, s1 * s2, e), cells.reshape(n, s1 * s2),
        num_slots=cfg.model.num_slots, score_threshold=icfg.score_threshold,
        mask_threshold=icfg.mask_threshold, nms=icfg.nms,
        nms_sigma=icfg.nms_sigma, nms_iou_threshold=icfg.nms_iou_threshold,
        pre_top_k=icfg.pre_nms_top_k)
    np.testing.assert_array_equal(scores.numpy() > 0, want["scores"] > 0)
    assert_slots_match(scores.numpy(), masks.float().numpy(), want["scores"],
                       want["masks"], tol=SCORE_TOL, mask_tol=ULP_NEAR_ONE)


# --- the bf16 train step ------------------------------------------------------

BN_IMPLS = ("xla", "fused", "stats")


def _step_config(bn_impl):
    cfg = tiny_config(batch_size=4)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, bn_impl=bn_impl),
        data=dataclasses.replace(cfg.data, hflip_prob=0.0),
        train=dataclasses.replace(cfg.train, lr=0.01, schedule="cosine",
                                  grad_clip_norm=0.05, ema_decay=0.999,
                                  warmup_steps=0))


@pytest.fixture(scope="module")
def bf16_steps():
    """One step on f32 params of each ``model.bn_impl`` in bf16, and of
    ``xla`` in f32 (key ``"f32"``), JAX and the port: {key: ((JAX metrics,
    JAX grads), (port metrics, port grads))}, metrics as floats and grads
    as flat float64 vectors in one order. The port's convolutions run on
    every core (``torch_threads.all_cores``), as these steps were
    measured: with one torch thread they sum in another order, and the
    f32 steps part by 2.4e-3 in norm (bound 1e-3) and the port's bf16
    ``fused - xla`` loss gap lies 8.0e-4 from JAX's (bound 3e-4)."""
    out = {}
    for key, impl, dtype in [(impl, impl, "bfloat16") for impl in BN_IMPLS] + [
            ("f32", "xla", "float32")]:
        with pytest.MonkeyPatch.context() as mp, torch_threads.all_cores():
            for jm, jg, _, tm, tg, _ in _run_steps(
                    _step_config(impl), dtype, mp, n_steps=1,
                    param_dtype="float32"):
                out[key] = tuple(
                    ({k: float(v) for k, v in m.items()},
                     np.concatenate([np.ravel(np.asarray(a, np.float64))
                                     for a in jax.tree.leaves(g)]))
                    for m, g in ((jm, jg), (tm, tg)))
    return out


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("bn_impl", BN_IMPLS)
def test_bf16_train_step_matches_jax(bf16_steps, bn_impl):
    """Loss and each metric within 1e-2 relative; every gradient within
    0.25 of the largest gradient magnitude, and within 0.3 in norm."""
    (jm, jg), (tm, tg) = bf16_steps[bn_impl]
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-2, atol=0,
                                   err_msg=k)
    gmax = np.abs(jg).max()
    assert np.abs(tg - jg).max() <= 0.25 * gmax, np.abs(tg - jg).max() / gmax
    assert _rel(tg, jg) <= 0.3, _rel(tg, jg)


def test_bf16_step_lies_within_bf16_noise_of_jax(bf16_steps):
    """``xla``: the port's bf16 gradients lie no further from JAX's bf16
    gradients than 1.5 times as far as JAX's bf16 gradients lie from JAX's
    own f32 ones (measured 0.185 against 0.162 in norm), so what parts them
    is bf16's rounding noise; the f32 steps agree within 1e-3 in norm
    (measured 6.9e-4)."""
    (_, jg), (_, tg) = bf16_steps["xla"]
    (_, jg32), (_, tg32) = bf16_steps["f32"]
    assert _rel(tg32, jg32) <= 1e-3, _rel(tg32, jg32)
    assert _rel(tg, jg) <= 1.5 * _rel(jg, jg32), (_rel(tg, jg),
                                                  _rel(jg, jg32))


def test_bf16_fused_bn_loss_gap_is_the_references(bf16_steps):
    """(fused - xla) / xla and (stats - xla) / xla of the bf16 loss, in the
    port and in JAX, agree within 3e-4."""
    loss = {impl: (bf16_steps[impl][0][0]["loss"],
                   bf16_steps[impl][1][0]["loss"]) for impl in BN_IMPLS}
    for impl in ("fused", "stats"):
        jgap = (loss[impl][0] - loss["xla"][0]) / loss["xla"][0]
        tgap = (loss[impl][1] - loss["xla"][1]) / loss["xla"][1]
        assert abs(tgap - jgap) <= 3e-4, (impl, jgap, tgap)


def _module_paths(model) -> dict:
    """Port module name -> path of the JAX module that holds the same
    parameters, through the weight mapping (``to_jax_variables``)."""
    named = dict(model.named_parameters())
    marks = {k: torch.full_like(v, float(i)) for i, (k, v) in
             enumerate(named.items())}
    paths = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            to_jax_variables(model, marks)[0]):
        name = list(named)[int(np.asarray(leaf).ravel()[0])]
        paths.setdefault(name.rsplit(".", 1)[0],
                         tuple(k.key for k in path[:-1]))
    return paths


def _train_outputs(cfg, params, stats, x, dtype: str):
    """Train-mode outputs, as NHWC f32 arrays, of every module that holds
    parameters: {port module name: (port output, JAX output)}, from forward
    hooks on the port and ``capture_intermediates`` on JAX."""
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype=dtype, param_dtype="float32"))
    _, state = jax_create_model(cfg.model).apply(
        {"params": params, "batch_stats": stats},
        jnp.asarray(x, jnp.dtype(dtype)), train=True, with_candidates=False,
        mutable=["batch_stats", "intermediates"], capture_intermediates=True)
    model = create_model(cfg.model, "cpu", train=True)
    load_jax_variables(model, params, stats)
    got = {}

    def keep(name):
        def hook(module, inputs, output):
            got[name] = output.detach().float().permute(0, 2, 3, 1).numpy()
        return hook

    paths = _module_paths(model)
    for name in paths:
        model.get_submodule(name).register_forward_hook(keep(name))
    with torch.no_grad():
        model(torch.from_numpy(x).to(_TORCH_DTYPES[dtype]), train=True)
    out = {}
    for name, path in paths.items():
        tree = state["intermediates"]
        for key in path:
            tree = tree[key]
        out[name] = (got[name], np.asarray(tree["__call__"][0], np.float32))
    return out


def test_bf16_modules_round_as_the_reference():
    """Module by module (every conv and norm, train mode, ``xla``), the
    port's bf16 output lies as far from its own f32 output as JAX's bf16
    output lies from JAX's f32 output: the ratio of the two mean relative
    differences within [0.8, 1.25] (measured 0.90 to 1.10). The f32 outputs
    agree within 1e-4 (measured 2.3e-5 at most), so neither framework
    rounds a module to bf16 where the other does not: the bf16 parts of
    the two grow as the convolutions' roundings fall apart."""
    cfg = tiny_config(batch_size=4)
    params, stats = jax_variables(cfg)
    x = tiny_batch(np.random.RandomState(7), n=4)["image"].astype(
        np.float32) / 255.0
    x = (x - np.asarray(cfg.data.mean, np.float32)) / np.asarray(
        cfg.data.std, np.float32)
    f32 = _train_outputs(cfg, params, stats, x, "float32")
    bf16 = _train_outputs(cfg, params, stats, x, "bfloat16")

    def rel(a, b):
        return np.abs(a - b).mean() / np.abs(b).mean()

    assert len(f32) > 50
    for name, (p32, j32) in f32.items():
        p16, j16 = bf16[name]
        assert rel(p32, j32) <= 1e-4, (name, rel(p32, j32))
        ratio = rel(p16, p32) / rel(j16, j32)
        assert 0.8 <= ratio <= 1.25, (name, ratio)


def test_bf16_loss_terms_round_as_the_reference():
    """Each loss term of the port on JAX's own bf16 train-mode outputs
    equals JAX's term on them within 2e-6 relative (f32 sums in another
    order; measured 8.5e-7 at most over three batches), so no term rounds
    apart from the reference: the bf16 - f32 loss gaps of the two (JAX
    1.4e-2 against the port's 6.0e-2 on ``_run_steps``' batch; JAX's own
    gap ranges 8.9e-3 to -4.1e-2 over three batches) part in the model's
    bf16 outputs, where the convolutions accumulate in another order
    (``test_bf16_modules_round_as_the_reference``)."""
    from basi_tpu.ops.resize import maxpool_hw as jax_maxpool
    from basi_tpu.train.loss import basi_loss as jax_basi_loss
    from basi_tpu.train.targets import instance_stats as jax_stats
    from basi_tpu_torch.models.basi import BASIOutputs
    from basi_tpu_torch.ops.resize import maxpool_hw
    from basi_tpu_torch.train.loss import basi_loss
    from basi_tpu_torch.train.targets import instance_stats

    cfg = tiny_config(batch_size=4)
    params, stats = jax_variables(cfg)
    b = tiny_batch(np.random.RandomState(7), n=4)
    x = (b["image"].astype(np.float32) / 255.0
         - np.asarray(cfg.data.mean, np.float32)) / np.asarray(
        cfg.data.std, np.float32)
    model = jax_create_model(cfg.model).clone(dtype=jnp.bfloat16)
    out, _ = model.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x, jnp.bfloat16), train=True,
                         with_candidates=False, mutable=["batch_stats"])
    masks, valid = jnp.asarray(b["masks"]), jnp.asarray(b["valid"])
    _, want = jax_basi_loss(
        out, jax_maxpool(masks, 4, 4).astype(jnp.float32), valid,
        gt_stats=jax.vmap(jax_stats)(masks, valid),
        max_pos_cells=cfg.train.max_pos_cells)

    def bf16(a):
        return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)

    tout = BASIOutputs(bf16(out.saliency_logits), bf16(out.cell_scores),
                       bf16(out.cell_kernels), bf16(out.mask_feats),
                       tuple(bf16(a) for a in out.saliency_aux))
    tm, tv = torch.from_numpy(b["masks"]), torch.from_numpy(b["valid"])
    _, got = basi_loss(tout, maxpool_hw(tm, 4, 4).float(), tv,
                       gt_stats=instance_stats(tm, tv),
                       max_pos_cells=cfg.train.max_pos_cells)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-6,
                                   atol=0, err_msg=k)
