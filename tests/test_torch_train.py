"""The port's training slice against the JAX package's, on the tiny config.

The same numpy inputs (``helpers.tiny_batch``, seeded logits) and the same
JAX variables go through the JAX functions and their ports, in f32 on the
CPU (JAX at ``precision=highest``, as ``tests/conftest.py`` sets it).
Tolerances, each stated again where it is asserted:

* targets and losses: 1e-5 (the same f32 formulas; sums in another order);
* the train-mode forward and its new BN running statistics: 1e-4 (two
  frameworks' convolutions and reductions round differently, a few 1e-6;
  the repo's budget is 1e-3);
* a train step (in float64 on both sides, and once in f32): loss within
  1e-4 relative, every gradient within 1e-3 of the gradient's largest
  magnitude, params, BN statistics and EMA within 1e-5 after one and after
  two steps;
* schedules: 1e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from basi_tpu.config import get_config
from basi_tpu.data import transforms as jax_transforms
from basi_tpu.models.basi import BASIOutputs as JaxOutputs
from basi_tpu.models import norm as jax_norm
from basi_tpu.models.basi import create_model as jax_create_model
from basi_tpu.ops import losses as jax_losses
from basi_tpu.ops.pallas import bn_stats as jax_bn_stats
from basi_tpu.ops.resize import maxpool_hw as jax_maxpool_hw
from basi_tpu.train import loss as jax_loss
from basi_tpu.train import targets as jax_targets
from basi_tpu.train.state import create_train_state as jax_create_state
from basi_tpu.train.state import make_optimizer as jax_make_optimizer
from basi_tpu.train.state import make_schedule as jax_make_schedule
from basi_tpu.train.step import make_train_step as jax_make_train_step
from basi_tpu_torch.convert import (
    load_jax_train_state,
    load_jax_variables,
    to_jax_variables,
)
from basi_tpu_torch.data import transforms as T
from basi_tpu_torch.models.basi import BASIOutputs, create_model
from basi_tpu_torch.ops import losses as L
from basi_tpu_torch.ops.resize import maxpool_hw
from basi_tpu_torch.train import loss as TL
from basi_tpu_torch.train import state as TS
from basi_tpu_torch.train import step as TSTEP
from basi_tpu_torch.train import targets as TT
from basi_tpu_torch.train.loop import Trainer

from helpers import tiny_batch, tiny_config
from test_torch_model import jax_variables


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


def assert_trees_close(got: dict, want: dict, atol: float, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_close(got[k], want[k], atol, f"{path}/{k}")
        else:
            np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                       np.asarray(want[k], np.float32),
                                       atol=atol, rtol=0, err_msg=f"{path}/{k}")


# --- masks, targets, losses -------------------------------------------------

def test_pack_unpack_round_trip_and_jax_unpack(rng):
    """``pack_masks_host`` -> ``unpack_masks`` is lossless, also for a W
    that is not a multiple of 8, and equals the JAX unpack."""
    for w in (64, 61):
        masks = (rng.rand(2, 3, 16, w) > 0.5).astype(np.uint8)
        packed = T.pack_masks_host(masks)
        assert packed.shape[-1] == -(-w // 8)
        got = T.maybe_unpack_masks(_t(packed), w)
        np.testing.assert_array_equal(got.numpy(), masks)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_transforms.unpack_masks(
                jnp.asarray(packed), w)))
        assert T.maybe_unpack_masks(_t(masks), w) is not None
        np.testing.assert_array_equal(T.maybe_unpack_masks(_t(masks), w).numpy(),
                                      masks)
    with pytest.raises(ValueError):
        T.maybe_unpack_masks(torch.zeros(1, 4, 5, dtype=torch.uint8), 64)


def test_maxpool_hw_matches_jax(rng):
    x = (rng.rand(2, 3, 16, 24) > 0.7).astype(np.uint8)
    np.testing.assert_array_equal(maxpool_hw(_t(x), 4, 4).numpy(),
                                  np.asarray(jax_maxpool_hw(jnp.asarray(x), 4, 4)))


@pytest.fixture(scope="module")
def gt():
    b = tiny_batch(np.random.RandomState(5), n=4)
    return b["masks"], b["valid"]


def test_instance_stats_matches_jax(gt):
    """Every statistic within 1e-5."""
    masks, valid = gt
    want = jax.vmap(jax_targets.instance_stats)(jnp.asarray(masks),
                                                jnp.asarray(valid))
    got = TT.instance_stats(_t(masks), _t(valid))
    assert_trees_close({k: v.numpy() for k, v in got.items()},
                       {k: np.asarray(v) for k, v in want.items()}, 1e-5)


@pytest.mark.parametrize("with_stats,max_pos", [(True, 64), (False, 64),
                                                (True, 3)])
def test_assign_targets_sparse_matches_jax(gt, with_stats, max_pos):
    """/4 masks with full-resolution stats (as the step runs it) or without,
    and a cap below the positives count: indices equal, targets within
    1e-5."""
    masks, valid = gt
    small = np.asarray(jax_maxpool_hw(jnp.asarray(masks), 4, 4))
    stats = jax.vmap(jax_targets.instance_stats)(jnp.asarray(masks),
                                                 jnp.asarray(valid))
    kw = dict(grid_size=8, mask_hw=(16, 16), center_sigma=0.2,
              max_pos_cells=max_pos)
    if with_stats:
        want = jax.vmap(lambda m, v, s: jax_targets.assign_targets_sparse(
            m, v, stats=s, **kw))(jnp.asarray(small), jnp.asarray(valid), stats)
        tstats = {k: _t(v) for k, v in stats.items()}
    else:
        want = jax.vmap(lambda m, v: jax_targets.assign_targets_sparse(
            m, v, **kw))(jnp.asarray(small), jnp.asarray(valid))
        tstats = None
    got = TT.assign_targets_sparse(_t(small), _t(valid), stats=tstats, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    assert float(got[4].sum()) > max_pos or max_pos == 64


def test_losses_match_jax(rng):
    """BCE (weighted and not), Dice (with and without valid), focal and the
    saliency loss, values and gradients within 1e-5."""
    logits = (rng.randn(3, 5, 8, 8) * 3).astype(np.float32)
    targets = (rng.rand(3, 5, 8, 8) > 0.6).astype(np.float32)
    w = (rng.rand(3, 5) > 0.4).astype(np.float32)
    sal = (rng.randn(3, 8, 8, 1) * 2).astype(np.float32)
    cases = [
        (lambda lg: jax_losses.sigmoid_bce(lg, targets),
         lambda lg: L.sigmoid_bce(lg, _t(targets)), logits),
        (lambda lg: jax_losses.sigmoid_bce(
            lg, targets, weights=jnp.broadcast_to(w[..., None, None], lg.shape)),
         lambda lg: L.sigmoid_bce(lg, _t(targets), weights=_t(
             w)[..., None, None].expand_as(lg)), logits),
        (lambda lg: jax_losses.dice_loss(lg, targets),
         lambda lg: L.dice_loss(lg, _t(targets)), logits),
        (lambda lg: jax_losses.dice_loss(lg, targets, valid=w),
         lambda lg: L.dice_loss(lg, _t(targets), valid=_t(w)), logits),
        (lambda lg: jax_losses.focal_loss(lg, targets),
         lambda lg: L.focal_loss(lg, _t(targets)), logits),
        (lambda lg: jax_losses.saliency_loss(lg, targets[:, 0]),
         lambda lg: L.saliency_loss(lg, _t(targets[:, 0])), sal),
    ]
    for jf, tf, x in cases:
        want, want_g = jax.value_and_grad(jf)(jnp.asarray(x))
        xt = _t(x).clone().requires_grad_()
        got = tf(xt)
        got.backward()
        np.testing.assert_allclose(float(got), float(want), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                                   atol=1e-5, rtol=0)


def test_basi_loss_matches_jax(gt, rng):
    """The sparse-path total loss, each metric and the gradients w.r.t.
    every model output, within 1e-5, on random outputs and /4 GT with
    full-resolution stats."""
    masks, valid = gt
    n = masks.shape[0]
    outs = {"saliency_logits": rng.randn(n, 16, 16, 1),
            "cell_scores": rng.randn(n, 8, 8, 1) - 2,
            "cell_kernels": rng.randn(n, 8, 8, 32) * 0.3,
            "mask_feats": rng.randn(n, 16, 16, 32) * 0.3,
            "aux": rng.randn(4, n, 16, 16, 1)}
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    small = np.asarray(jax_maxpool_hw(jnp.asarray(masks), 4, 4), np.float32)
    stats = jax.vmap(jax_targets.instance_stats)(jnp.asarray(masks),
                                                 jnp.asarray(valid))

    def jax_fn(o):
        out = JaxOutputs(o["saliency_logits"], tuple(o["aux"]),
                         o["cell_scores"], o["cell_kernels"], o["mask_feats"],
                         None)
        return jax_loss.basi_loss(out, jnp.asarray(small), jnp.asarray(valid),
                                  gt_stats=stats)

    (want, want_m), want_g = jax.value_and_grad(jax_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outs.items()})
    to = {k: _t(v).requires_grad_() for k, v in outs.items()}
    out = BASIOutputs(to["saliency_logits"], to["cell_scores"],
                      to["cell_kernels"], to["mask_feats"], tuple(to["aux"]))
    got, got_m = TL.basi_loss(out, _t(small), _t(valid),
                              gt_stats={k: _t(v) for k, v in stats.items()})
    got.backward()
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    for k in outs:
        np.testing.assert_allclose(to[k].grad.numpy(), np.asarray(want_g[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TL.basi_loss(out, _t(small), _t(valid), max_pos_cells=0)


# --- model in train mode -----------------------------------------------------

def test_train_mode_forward_and_bn_stats_match_jax():
    """Train-mode outputs (saliency_aux included) and the updated BN running
    statistics against ``model.apply(..., train=True, mutable=
    ["batch_stats"])``, f32, within 1e-4."""
    cfg = tiny_config()
    params, stats = jax_variables(cfg)
    x = np.random.RandomState(1).randn(3, 64, 64, 3).astype(np.float32)
    jmodel = jax_create_model(cfg.model)
    want, mutated = jmodel.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x), train=True,
                                 with_candidates=False, mutable=["batch_stats"])
    model = create_model(cfg.model, "cpu", train=True)
    load_jax_variables(model, params, stats)
    with torch.no_grad():
        got = model(_t(x))
    for k in ("saliency_logits", "cell_scores", "cell_kernels", "mask_feats"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-4,
                                   rtol=0, err_msg=k)
    assert len(got.saliency_aux) == len(want.saliency_aux) == 4
    for a, b in zip(got.saliency_aux, want.saliency_aux):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)
    assert_trees_close(to_jax_variables(model)[1],
                       jax.tree.map(np.asarray, mutated["batch_stats"]), 1e-4)
    # eval mode reads the running statistics and leaves them alone
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        ev = model(_t(x), train=False)
    assert ev.saliency_aux == ()
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def test_to_jax_variables_round_trips_the_jax_tree():
    cfg = tiny_config()
    params, stats = jax_variables(cfg)
    model = create_model(cfg.model, "cpu")
    load_jax_variables(model, params, stats)
    p2, s2 = to_jax_variables(model)
    assert_trees_close(p2, params, 0.0)
    assert_trees_close(s2, stats, 0.0)
    with pytest.raises(KeyError):
        to_jax_variables(model, {"not.a.param": torch.zeros(1)})


# --- the step -----------------------------------------------------------------

MAX_STEPS = 10


def _capturing(tx, sink):
    """``tx`` that first hands the raw gradients to the host."""
    def update(g, s, p=None):
        jax.debug.callback(lambda g: sink.append(jax.tree.map(np.array, g)), g)
        return tx.update(g, s, p)
    return optax.GradientTransformation(tx.init, update)


_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "bfloat16": torch.bfloat16}


def _run_steps(cfg, dtype: str, monkeypatch, n_steps: int = 2,
               param_dtype: str = ""):
    """``n_steps`` of the JAX and the port's ``make_train_step`` from the
    same variables on the same batches (masks raw for JAX, bit-packed for
    the port), activations in ``dtype`` and params in ``param_dtype``
    (default: ``dtype``) on both sides. Yields, after each step, (JAX
    metrics, JAX raw grads, JAX state, port metrics, port raw grads as a
    JAX tree, port state)."""
    param_dtype = param_dtype or dtype
    tdtype = _TORCH_DTYPES[dtype]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype=dtype, param_dtype=param_dtype))
    rng = np.random.RandomState(7)
    batches = [tiny_batch(rng, n=4) for _ in range(n_steps)]
    model = create_model(cfg.model, "cpu", train=True).to(
        _TORCH_DTYPES[param_dtype])
    names = [k for k, _ in model.named_parameters()]
    tgrads: list = []
    real_clip = TSTEP.clip_by_global_norm

    def capture(grads, max_norm):
        tgrads.append({k: g.clone() for k, g in zip(names, grads)})
        return real_clip(grads, max_norm)

    monkeypatch.setattr(TSTEP, "clip_by_global_norm", capture)
    step = TSTEP.make_train_step(cfg.train, cfg.data,
                                 TS.make_schedule(cfg.train, MAX_STEPS), tdtype)
    with jax.enable_x64(dtype == "float64"):
        jmodel = jax_create_model(cfg.model)
        tx, _ = jax_make_optimizer(cfg.train, MAX_STEPS)
        jstate = jax_create_state(jmodel, cfg.model, cfg.train, MAX_STEPS,
                                  tx=tx)
        jgrads: list = []
        jstep = jax_make_train_step(jmodel, _capturing(tx, jgrads), cfg.train,
                                    cfg.data, donate=False)
        state = load_jax_train_state(model, cfg.train, _host(jstate.params),
                                     _host(jstate.batch_stats))
        for i, b in enumerate(batches):
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
            jax.effects_barrier()
            tb = {"image": _t(b["image"]), "valid": _t(b["valid"]),
                  "masks": _t(T.pack_masks_host(b["masks"]))}
            tm = step(state, tb)
            assert state.step == int(jstate.step) == i + 1
            yield (jm, jgrads[i], jstate, tm,
                   to_jax_variables(model, tgrads[i])[0], state)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_step_matches(jm, jg, jstate, tm, tg, state, grad_tol):
    """Loss within 1e-4 relative, each metric within 1e-4, every gradient
    within ``grad_tol`` of the largest gradient magnitude, params, BN
    statistics and EMA within 1e-5."""
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4, atol=0)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    gmax = max(np.abs(w).max() for w in jax.tree.leaves(jg))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jg),
                            jax.tree.leaves(tg)):
        np.testing.assert_allclose(g, w, rtol=0, atol=grad_tol * gmax,
                                   err_msg=jax.tree_util.keystr(path))
    p, s = to_jax_variables(state.model)
    assert_trees_close(p, _host(jstate.params), 1e-5)
    assert_trees_close(s, _host(jstate.batch_stats), 1e-5)
    assert_trees_close(to_jax_variables(state.model, state.ema)[0],
                       _host(jstate.ema_params), 1e-5)


@pytest.mark.parametrize("hflip,clip", [(0.0, 0.05), (1.0, 0.05),
                                        (0.0, 1e4), (1.0, 1e4)])
def test_train_steps_match_jax(hflip, clip, monkeypatch):
    """Two steps, JAX and the port both in float64, hflip 0 or 1, clipping
    active (0.05) or not (1e4): after each step the loss within 1e-4
    relative, each metric within 1e-4, every gradient within 1e-3 of the
    largest gradient magnitude, params, BN statistics and EMA within 1e-5.

    float64 makes this a test of the semantics: in f32 the tiny model's
    gradients are too ill-conditioned to hold at 1e-3 against any other
    computation. Its BatchNorms see 16 to 1024 values per channel and flax's
    GroupNorm takes the variance as E[x^2] - E[x]^2, which cancels in f32;
    with hflip 1, one ``instance.gn0.bias`` gradient entry is 0.0418 in JAX
    f32 and 0.0145 in JAX f64, the port's f32 and the port's f64. The f32
    step has its own test below. The losses upcast to f32 on both sides,
    and the images are normalized in f32, as in the f32 step."""
    cfg = tiny_config(batch_size=4)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, hflip_prob=hflip),
        train=dataclasses.replace(cfg.train, lr=0.01, schedule="cosine",
                                  grad_clip_norm=clip, ema_decay=0.999,
                                  warmup_steps=0))
    clipped = []
    params0 = None
    for jm, jg, jstate, tm, tg, state in _run_steps(cfg, "float64",
                                                    monkeypatch):
        if params0 is None:
            params0 = to_jax_variables(state.model)[0]
        _assert_step_matches(jm, jg, jstate, tm, tg, state, 1e-3)
        norm = np.sqrt(sum(np.sum(np.square(g)) for g in jax.tree.leaves(jg)))
        clipped.append(norm >= clip)
    assert all(clipped) == (clip < 1.0) and any(clipped) == (clip < 1.0)
    moved = to_jax_variables(state.model)[0]
    assert not np.allclose(moved["fpn"]["smooth0"]["kernel"],
                           params0["fpn"]["smooth0"]["kernel"])


class _Float32As64:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("bn_impl", ["fused", "stats"])
def test_fused_bn_train_steps_match_jax(bn_impl, monkeypatch):
    """``model.bn_impl`` fused or stats on both sides, two steps in float64,
    hflip 1, clipping active: the tolerances of ``test_train_steps_match_jax``
    (loss 1e-4 relative, metrics 1e-4, gradients 1e-3 of the largest,
    params, BN statistics and EMA 1e-5). On the CPU the port's BNs run the
    ``bn_stats`` kernels' plain versions and the hand-written backward.

    The JAX ``FusedBatchNorm`` casts x, scale, bias and its sums to f32
    whatever its input, so under x64 it would still normalize in f32 and
    this would compare f32 BN against f64 BN (a gradient entry 0.026 apart
    against a bound of 0.009). Its modules read ``jnp.float32`` at trace
    time; for this test they read float64, so both sides compute the same
    function in float64 (the JAX package is not changed)."""
    monkeypatch.setattr(jax_norm, "jnp", _Float32As64())
    monkeypatch.setattr(jax_bn_stats, "jnp", _Float32As64())
    cfg = tiny_config(batch_size=4)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, bn_impl=bn_impl),
        data=dataclasses.replace(cfg.data, hflip_prob=1.0),
        train=dataclasses.replace(cfg.train, lr=0.01, schedule="cosine",
                                  grad_clip_norm=0.05, ema_decay=0.999,
                                  warmup_steps=0))
    for out in _run_steps(cfg, "float64", monkeypatch):
        _assert_step_matches(*out, 1e-3)


def test_f32_train_step_matches_jax(monkeypatch):
    """One f32 step on both sides (hflip 0, clipping active): loss within
    1e-4 relative, each metric within 1e-4, every gradient within 1e-3 of
    the largest gradient magnitude, params, BN statistics and EMA within
    1e-5."""
    cfg = tiny_config(batch_size=4)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, hflip_prob=0.0),
        train=dataclasses.replace(cfg.train, lr=0.05, grad_clip_norm=0.05,
                                  ema_decay=0.999))
    for out in _run_steps(cfg, "float32", monkeypatch, n_steps=1):
        _assert_step_matches(*out, 1e-3)


@pytest.mark.parametrize("kind,warmup", [("poly", 0), ("poly", 3),
                                         ("cosine", 4), ("constant", 2)])
def test_schedules_match_jax(kind, warmup):
    """Every step 0..max_steps+2 within 1e-7."""
    cfg = dataclasses.replace(tiny_config().train, schedule=kind,
                              warmup_steps=warmup, lr=0.03)
    want = jax_make_schedule(cfg, 12)
    got = TS.make_schedule(cfg, 12)
    for s in range(15):
        assert abs(got(s) - float(want(s))) <= 1e-7, (s, got(s), float(want(s)))
    with pytest.raises(ValueError):
        TS.make_schedule(dataclasses.replace(cfg, schedule="step"), 12)


def test_clip_by_global_norm_is_optax_formula(rng):
    """Above the bound every leaf becomes ``g / norm * max_norm`` (optax,
    no epsilon); below it the gradients stay bit for bit."""
    gs = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in gs)))
    for max_norm in (0.5 * norm, 2 * norm):
        want = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in gs], optax.EmptyState())[0]
        got = [_t(g).clone() for g in gs]
        n = TS.clip_by_global_norm(got, max_norm)
        assert abs(float(n) - norm) <= 1e-5 * norm
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=0)
        if max_norm > norm:
            for a, g in zip(got, gs):
                np.testing.assert_array_equal(a.numpy(), g)


# --- the trainer --------------------------------------------------------------

def test_trainer_runs_three_steps_on_cpu(capsys):
    """``Trainer(cfg, device="cpu").train(max_steps=3)``: finite loss, a ``[train]``
    record per step, the step count and the EMA advanced; then ``train()``
    runs the epoch to its end and returns with the eval metrics."""
    cfg = tiny_config(batch_size=4)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, synthetic_n=16),
        train=dataclasses.replace(cfg.train, ema_decay=0.99))
    tr = Trainer(cfg, device="cpu")
    ema0 = {k: v.clone() for k, v in tr.state.ema.items()}
    last = tr.train(max_steps=3)
    assert tr.state.step == 3 and last["step"] == 3
    assert np.isfinite(last["loss"]) and last["imgs_per_s"] > 0
    assert [r["step"] for r in tr.records] == [1, 2, 3]
    out = capsys.readouterr().out
    assert out.count("[train] ") == 3
    assert any(not torch.equal(ema0[k], v) for k, v in tr.state.ema.items())
    # the rest of the epoch, then the per-epoch eval on the val split
    last = tr.train()
    assert tr.state.step == 4 and last["step"] == 4
    assert last["num_images"] == 4 and "saliency_S" in last
    out = capsys.readouterr().out
    assert out.count("[train] ") == 1 and out.count("[val] ") == 1


@pytest.mark.parametrize("overrides", [
    ["data.multiscale=true"],
    ["data.color_jitter=0.2,0.2,0.2"],
    ["train.grad_accum=2"],
    ["train.steps_per_dispatch=2"],
    ["train.freeze_bn=true"],
    ["model.refine=true"],
    ["train.optimizer=adamw"],
    ["train.remat=true"],
    ["train.checkpoint_dir=ckpt", "train.async_checkpoint=true"],
    ["parallel.num_devices=2"],
    ["model.instance_mechanism=roi"],
    ["tensorboard_dir=tb"],
])
def test_unported_training_settings_raise(overrides):
    cfg = get_config("bench_accuracy", ["data.synthetic_orig_scale=1.0",
                                        "data.synthetic_n=16",
                                        "model.image_size=64",
                                        "data.image_size=64", *overrides])
    with pytest.raises(NotImplementedError, match="not yet ported"):
        Trainer(cfg, device="cpu")
