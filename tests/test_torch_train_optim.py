"""AdamW, bf16 params and the presets on the port's train step (moved
out of ``test_torch_train_settings.py``, whose harness they share, so that
another worker runs them).

AdamW: one float64 step against JAX's ``make_train_step`` with JAX's
draws, and the optimizer alone against optax at 1e-12; one f32 step of
the multiscale preset's settings together; bf16 params against JAX's bf16
params (bf16's tolerances, stated there); a JAX bf16 tree loaded and
exported exactly; the six presets through ``Trainer``, the settings that
still raise, and the AdamW moments through a checkpoint bit for bit.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as TT
from basi_tpu.config import get_config as jax_get_config
from basi_tpu_torch.config import PRESETS, get_config
from basi_tpu_torch.convert import load_jax_variables, to_jax_variables
from basi_tpu_torch.models.basi import cast_params, create_model
from basi_tpu_torch.train import state as TS
from basi_tpu_torch.train import step as TSTEP
from basi_tpu_torch.train.loop import Trainer

from helpers import tiny_config
from test_torch_model import jax_variables
from test_torch_train_settings import _settings_config, jax_draws


def test_adamw_step_matches_jax(monkeypatch):
    """One float64 AdamW step (``train.optimizer=adamw``): loss, metrics,
    gradients, BN statistics and EMA at the tolerances above; each param
    within 1e-5 plus ``lr * min(2, |dg| / eps)``, dg the port's gradient
    entry minus JAX's. Adam's first update is ``lr * g / (|g| + eps)``
    (plus the decay), a function of g bounded by 1 with slope at most
    1/eps: where |g| is near eps (1e-8), gradients apart only by f32
    rounding (both sides' losses compute in f32) give updates apart by up
    to lr * 1e-3 on this batch. The optimizer alone is held at 1e-12
    (``test_adamw_matches_optax_adamw``)."""
    cfg = _settings_config(train={"optimizer": "adamw"})
    monkeypatch.setattr(TSTEP, "draw_augment", jax_draws(cfg))
    lr = TS.make_schedule(cfg.train, TT.MAX_STEPS)(0)
    for jm, jg, jstate, tm, tg, state in TT._run_steps(
            cfg, "float64", monkeypatch, n_steps=1):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, atol=0)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-4,
                                       rtol=1e-4, err_msg=k)
        gmax = max(np.abs(w).max() for w in jax.tree.leaves(jg))
        p, s = TT.to_jax_variables(state.model)
        for (path, w), g, got, want in zip(
                jax.tree_util.tree_leaves_with_path(jg), jax.tree.leaves(tg),
                jax.tree.leaves(p), jax.tree.leaves(TT._host(jstate.params))):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * gmax)
            bound = 1e-5 + lr * np.minimum(2.0, np.abs(g - w) / 1e-8)
            assert np.all(np.abs(got - want) <= bound), \
                jax.tree_util.keystr(path)
        TT.assert_trees_close(s, TT._host(jstate.batch_stats), 1e-5)
        ema = TT.to_jax_variables(state.model, state.ema)[0]
        want_ema = TT._host(jstate.ema_params)
        d = 1.0 - min(cfg.train.ema_decay, 2.0 / 11.0)
        for g, w, got, want in zip(jax.tree.leaves(tg), jax.tree.leaves(jg),
                                   jax.tree.leaves(ema),
                                   jax.tree.leaves(want_ema)):
            bound = 1e-5 + d * lr * np.minimum(2.0, np.abs(g - w) / 1e-8)
            assert np.all(np.abs(got - want) <= bound)


def test_setting_f32_step_matches_jax(monkeypatch):
    """One f32 step with the preset's multiscale, colour jitter and
    ``grad_accum=2`` together (JAX's draws): loss within 1e-4 relative,
    each metric within 1e-4, every gradient within 1e-3 of the largest
    magnitude, params, BN statistics and EMA within 1e-5."""
    cfg = _settings_config(data={"multiscale": True,
                                 "color_jitter": (0.2, 0.2, 0.2)},
                           train={"grad_accum": 2, "lr": 0.05})
    monkeypatch.setattr(TSTEP, "draw_augment", jax_draws(cfg))
    for out in TT._run_steps(cfg, "float32", monkeypatch, n_steps=1):
        TT._assert_step_matches(*out, 1e-3)


def test_adamw_matches_optax_adamw(rng):
    """Three steps of ``make_optimizer``'s AdamW (after the clip, as the
    step runs it) and of optax's ``clip_by_global_norm`` + ``adamw`` on
    the same float64 gradients and schedule: every param within 1e-12
    relative of optax's."""
    import optax

    cfg = dataclasses.replace(tiny_config().train, optimizer="adamw",
                              lr=0.01, weight_decay=5e-4, grad_clip_norm=1.0)
    params = [rng.randn(5, 3), rng.randn(7) * 1e-3]
    grads = [[rng.randn(*p.shape) * 10.0 ** -k for p in params]
             for k in (0, 4, 8)]
    sched = TS.make_schedule(cfg, 10)
    with jax.enable_x64(True):
        tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip_norm),
                         optax.adamw(learning_rate=lambda c: jnp.asarray(
                             [sched(i) for i in range(10)])[c],
                             weight_decay=cfg.weight_decay))
        jp = [jnp.asarray(p) for p in params]
        opt = tx.init(jp)
        for g in grads:
            upd, opt = tx.update([jnp.asarray(x) for x in g], opt, jp)
            jp = optax.apply_updates(jp, upd)
        jp = [np.asarray(p) for p in jp]
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = TS.make_optimizer(cfg, tp)
    for i, g in enumerate(grads):
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        TS.clip_by_global_norm([p.grad for p in tp], cfg.grad_clip_norm)
        for group in topt.param_groups:
            group["lr"] = sched(i)
        topt.step()
    for p, w in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-12,
                                   atol=0)


# --- bf16 params ----------------------------------------------------------------------

def test_bf16_params_step_matches_jax(monkeypatch):
    """``model.param_dtype=bfloat16`` with bf16 compute, one step against
    JAX's (clipping inactive, JAX's draws): params and optimizer state
    bf16, BN statistics and EMA f32 on both sides (the JAX EMA turns f32
    at its first update); loss and each metric within 1e-2 relative
    (``test_torch_bf16``'s bound). The gradients are noisier than on f32
    params, each weight gradient being rounded to bf16 once more: measured
    0.34 apart in norm and 0.29 of the largest magnitude at most (0.18 and
    0.13 on f32 params), held at 0.5 and 0.4. Each param within what that
    gradient gap moves it plus the roundings: one bf16 ulp of the param
    (2^-7 of it), one of each side's step ``lr * (g + wd * p)``, and
    ``lr`` times the gap; the EMA within its (1 - d) share of that; BN
    statistics within 4% of their largest magnitude (the bf16 model bound
    of ``test_torch_model``)."""
    cfg = _settings_config(train={"grad_clip_norm": 1e4})
    monkeypatch.setattr(TSTEP, "draw_augment", jax_draws(cfg))
    for jm, jg, jstate, tm, tg, state in TT._run_steps(
            cfg, "bfloat16", monkeypatch, n_steps=1, param_dtype="bfloat16"):
        pass
    model = state.model
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert {b.dtype for k, b in model.named_buffers()
            if "running" in k} == {torch.float32}
    assert {v.dtype for v in state.ema.values()} == {torch.float32}
    assert {s["momentum_buffer"].dtype for s in
            state.optimizer.state.values()} == {torch.bfloat16}
    assert {str(x.dtype) for x in jax.tree.leaves(jstate.params)} == {
        "bfloat16"}
    assert {str(x.dtype) for x in jax.tree.leaves(jstate.ema_params)} == {
        "float32"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-2,
                                   atol=0, err_msg=k)

    def f64(tree):
        return [np.asarray(a, np.float64) for a in jax.tree.leaves(tree)]

    jgs, tgs = f64(jg), f64(tg)
    jflat, tflat = np.concatenate([a.ravel() for a in jgs]), np.concatenate(
        [a.ravel() for a in tgs])
    assert np.abs(tflat - jflat).max() <= 0.4 * np.abs(jflat).max()
    assert np.linalg.norm(tflat - jflat) <= 0.5 * np.linalg.norm(jflat)
    lr, wd = TS.make_schedule(cfg.train, TT.MAX_STEPS)(0), cfg.train.weight_decay
    d = 1.0 - min(cfg.train.ema_decay, 2.0 / 11.0)
    p, s = to_jax_variables(model)
    ema = to_jax_variables(model, state.ema)[0]
    for p0, g_j, g_t, got, want, e_t, e_j in zip(
            f64(TT._host(jax.tree.map(lambda a: a.astype(jnp.float32),
                                      jstate.params))),
            jgs, tgs, f64(p), f64(jax.tree.map(
                lambda a: a.astype(jnp.float32), jstate.params)),
            f64(ema), f64(jstate.ema_params)):
        step = lr * (np.maximum(np.abs(g_j), np.abs(g_t)) + wd * np.abs(p0))
        bound = 2.0 ** -7 * (np.abs(want) + 2 * step) + lr * np.abs(g_t - g_j)
        assert np.all(np.abs(got - want) <= bound * 1.001 + 1e-12)
        assert np.all(np.abs(e_t - e_j) <= d * bound * 1.001 + 1e-7)
    for w, g in zip(jax.tree.leaves(jstate.batch_stats), jax.tree.leaves(s)):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 0.04 * np.abs(w).max()


def test_bf16_param_tree_loads_and_exports():
    """A JAX bf16 ``params`` tree (``model.param_dtype=bfloat16``) loads
    into bf16 params exactly, BN statistics f32, and ``to_jax_variables``
    gives it back value for value (widened to f32: numpy has no bf16)."""
    cfg = tiny_config()
    params, stats = jax_variables(cfg)
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                      params)
    model = cast_params(create_model(cfg.model, "cpu"), torch.bfloat16)
    load_jax_variables(model, bf, stats)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    p2, s2 = to_jax_variables(model)
    TT.assert_trees_close(p2, jax.tree.map(
        lambda a: np.asarray(a, np.float32), bf), 0.0)
    TT.assert_trees_close(s2, stats, 0.0)


# --- the Trainer ---------------------------------------------------------------------

TINY = ["model.backbone=resnet_tiny", "model.fpn_channels=32",
        "model.mask_channels=32", "model.grid_size=8", "model.image_size=64",
        "data.image_size=64", "data.max_instances=4", "data.batch_size=4",
        "data.dataset=synthetic", "data.synthetic_n=8",
        "data.synthetic_orig_scale=1.0", "train.checkpoint_dir=",
        "train.log_every=1", "infer.batch_size=4", "infer.native_gt_cache="]


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_every_preset_trains_on_the_port(preset):
    """``Trainer(get_config(preset, tiny), device="cpu")`` takes a step
    with a finite loss (``train_v4-32_dp`` on one device: ``num_devices``
    0 means the devices there are), and the port's config equals JAX's."""
    assert dataclasses.asdict(get_config(preset, TINY)) == dataclasses.asdict(
        jax_get_config(preset, TINY))
    tr = Trainer(get_config(preset, TINY), device="cpu")
    last = tr.train(max_steps=1)
    assert tr.state.step == 1 and np.isfinite(last["loss"])


@pytest.mark.parametrize("overrides", [["train.steps_per_dispatch=2"],
                                       ["parallel.num_devices=2"],
                                       ["parallel.spatial_shards=2"]])
def test_what_still_raises(overrides):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        Trainer(get_config("train_multiscale_fused", TINY + overrides),
                device="cpu")


def test_adamw_resumes_bit_for_bit(tmp_path):
    """Two AdamW steps saved and restored into a fresh Trainer: params,
    both moments and the count equal bit for bit; a third step from each
    gives the same params. A checkpoint of another optimizer is refused."""
    over = TINY + ["train.optimizer=adamw", "data.multiscale=true",
                   f"train.checkpoint_dir={tmp_path}", "train.resume=none",
                   "train.checkpoint_every_steps=2", "data.synthetic_n=16"]
    a = Trainer(get_config("train_multiscale_fused", over), device="cpu")
    a.train(max_steps=2)
    b = Trainer(get_config("train_multiscale_fused", over[:-3] + [
        f"train.checkpoint_dir={tmp_path}", "train.resume=auto",
        "data.synthetic_n=16"]), device="cpu")
    assert b.state.step == 2
    sa, sb = a.state.optimizer.state_dict(), b.state.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], sb["state"][i][k]), (i, k)
    for (k, p), q in zip(a.state.model.named_parameters(),
                         b.state.model.parameters()):
        assert torch.equal(p, q), k
    a.train(max_steps=3)
    b.train(max_steps=3)
    for (k, p), q in zip(a.state.model.named_parameters(),
                         b.state.model.parameters()):
        assert torch.equal(p, q), k
    with pytest.raises(ValueError, match="AdamW"):
        Trainer(get_config("train_multiscale_fused", TINY + [
            f"train.checkpoint_dir={tmp_path}", "train.resume=auto",
            "data.synthetic_n=16"]), device="cpu")
