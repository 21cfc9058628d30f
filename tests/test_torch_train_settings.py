"""The port's train step in every training setting against the JAX
package's ``make_train_step``, on the CPU at the tiny config.

``test_torch_train._run_steps`` runs the JAX step and the port's step from
the same variables on the same batches; the port's ``draw_augment`` is
replaced by the numbers of JAX's own key tree (``jax_draws``), so both
sides flip, zoom and jitter alike. Each setting takes two steps in float64
on both sides, held at ``test_torch_train``'s tolerances: loss within 1e-4
relative, each metric within 1e-4, every gradient within 1e-3 of the
largest gradient magnitude, params, BN statistics and EMA within 1e-5.
Where the JAX package casts to ``jnp.float32`` inside the augmentation,
its ``data/transforms.py`` reads float64 for the test (as
``test_fused_bn_train_steps_match_jax`` does for its BatchNorm), so both
sides compute the same function in float64. The settings are split
between this file and ``test_torch_train_settings2.py``;
``test_torch_train_optim.py`` holds AdamW, bf16 params and the presets.

Also: remat's running statistics and gradients against the plain step's
(equal), and a batch that ``grad_accum`` does not divide.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as TT
from basi_tpu.data import transforms as jax_transforms
from basi_tpu_torch.models.basi import create_model
from basi_tpu_torch.train import state as TS
from basi_tpu_torch.train import step as TSTEP

from helpers import tiny_batch, tiny_config


def jax_draws(cfg):
    """A stand-in for ``draw_augment`` that returns the draws of the JAX
    step's key tree for the state's step and the micro-batch's index:
    ``fold_in(fold_in(rng, step), 0)`` (then ``fold_in`` of the index under
    accumulation) split into the flip key and ``k_aug``; ``split(k_aug,
    4)`` for the scale and the two offsets; ``split(fold_in(k_aug, 1), 3)``
    for the jitter factors. Draws in JAX's dtypes (float64 under x64)."""
    seen = {"step": None, "micro": 0}

    def draw(state, n, cfg_data):
        if seen["step"] != state.step:
            seen.update(step=state.step, micro=0)
        rng = jax.random.fold_in(jax.random.PRNGKey(cfg.train.seed),
                                 state.step)
        rng = jax.random.fold_in(rng, jnp.zeros((), jnp.int32))
        if cfg.train.grad_accum > 1:
            rng = jax.random.fold_in(rng, seen["micro"])
        seen["micro"] += 1
        k_flip, k_aug = jax.random.split(rng)
        flip = jax.random.bernoulli(k_flip, cfg_data.hflip_prob, (n,))
        _, k_scale, k_oy, k_ox = jax.random.split(k_aug, 4)
        lo, hi = cfg_data.scale_range
        scale = jax.random.uniform(k_scale, (n,), minval=lo, maxval=hi)
        oy = jax.random.uniform(k_oy, (n,))
        ox = jax.random.uniform(k_ox, (n,))
        f32 = jax_transforms.jnp.float32  # float64 where the test says so
        factors = [jax.random.uniform(k, (n, 1, 1, 1), f32,
                                      minval=max(0.0, 1.0 - x),
                                      maxval=1.0 + x).reshape(n)
                   for k, x in zip(jax.random.split(
                       jax.random.fold_in(k_aug, 1), 3),
                       cfg_data.color_jitter)]
        return TSTEP.AugmentDraws(
            torch.from_numpy(np.asarray(flip, np.int32)),
            *(torch.from_numpy(np.array(a)) for a in (scale, oy, ox,
                                                      *factors)))

    return draw


def _settings_config(**changes):
    """The step tests' config (batch 4, hflip 0.5, clipping active, cosine,
    EMA) with ``changes`` as {"train": {...}, "data": {...}}."""
    cfg = tiny_config(batch_size=4)
    data = {"hflip_prob": 0.5, **changes.get("data", {})}
    train = {"lr": 0.01, "schedule": "cosine", "grad_clip_norm": 0.05,
             "ema_decay": 0.999, "warmup_steps": 0, **changes.get("train", {})}
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data),
                               train=dataclasses.replace(cfg.train, **train))


SETTINGS = {
    "multiscale": {"data": {"multiscale": True}},
    "color_jitter": {"data": {"color_jitter": (0.2, 0.2, 0.2)}},
    "grad_accum": {"train": {"grad_accum": 2}},
    "freeze_bn": {"train": {"freeze_bn": True}},
    "remat": {"train": {"remat": True}},
    "dense_loss": {"train": {"max_pos_cells": 0}},
    "basnet_hybrid": {"train": {"loss": "basnet_hybrid"}},
}


def check_setting_steps(setting, monkeypatch):
    """Two float64 steps of the setting, JAX's draws on both sides: loss
    within 1e-4 relative, each metric within 1e-4, every gradient within
    1e-3 of the largest gradient magnitude, params, BN statistics and EMA
    within 1e-5 after each step. Under ``freeze_bn`` the BN running
    statistics do not move; under ``grad_accum`` the metrics are the
    micro-batches' mean."""
    cfg = _settings_config(**SETTINGS[setting])
    monkeypatch.setattr(TSTEP, "draw_augment", jax_draws(cfg))
    monkeypatch.setattr(jax_transforms, "jnp", TT._Float32As64())
    stats0 = None
    for out in TT._run_steps(cfg, "float64", monkeypatch):
        if stats0 is None:
            stats0 = {k: v.clone() for k, v in out[5].model.named_buffers()}
        TT._assert_step_matches(*out, 1e-3)
    moved = [k for k, v in out[5].model.named_buffers()
             if k.endswith("running_mean") and not torch.equal(v, stats0[k])]
    assert bool(moved) != cfg.train.freeze_bn, moved


# The settings' cases are spread over this file and
# ``test_torch_train_settings2.py``, so that two workers run them.
@pytest.mark.parametrize("setting", ["multiscale", "remat", "freeze_bn"])
def test_setting_steps_match_jax(setting, monkeypatch):
    """``check_setting_steps`` of the setting."""
    check_setting_steps(setting, monkeypatch)


def test_grad_accum_needs_a_divisible_batch():
    cfg = _settings_config(train={"grad_accum": 3})
    state = TS.create_train_state(create_model(cfg.model, "cpu", train=True),
                                  cfg.train)
    step = TSTEP.make_train_step(cfg.train, cfg.data,
                                 TS.make_schedule(cfg.train, 4), torch.float32)
    b = tiny_batch(np.random.RandomState(0), n=4)
    with pytest.raises(ValueError, match="does not divide"):
        step(state, {k: torch.from_numpy(v) for k, v in b.items()})


# --- remat -------------------------------------------------------------------------

@pytest.mark.parametrize("bn_impl", ["xla", "fused"])
def test_remat_step_equals_the_plain_step(bn_impl):
    """One f32 step with ``train.remat`` and one without, from the same
    weights and batch: the BN running statistics equal (the recompute moves
    none of them), every gradient equal, and the trunk's BatchNorms ran
    twice under remat (the recompute), once without."""
    out = {}
    b = tiny_batch(np.random.RandomState(4), n=4)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    for remat in (False, True):
        cfg = _settings_config(train={"remat": remat})
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, bn_impl=bn_impl))
        model = create_model(cfg.model, "cpu", train=True)
        calls = []
        model.backbone.bn1.register_forward_hook(
            lambda *a: calls.append(1))
        state = TS.create_train_state(model, cfg.train)
        grads = {}
        real_clip = TSTEP.clip_by_global_norm

        def capture(g, max_norm, grads=grads):
            grads.update({k: t.clone() for k, t in
                          zip([k for k, _ in model.named_parameters()], g)})
            return real_clip(g, max_norm)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TSTEP, "clip_by_global_norm", capture)
            step = TSTEP.make_train_step(cfg.train, cfg.data,
                                         TS.make_schedule(cfg.train, 4),
                                         torch.float32)
            step(state, batch)
        out[remat] = (grads, {k: v.clone() for k, v in
                              model.named_buffers()}, len(calls))
    (g0, s0, n0), (g1, s1, n1) = out[False], out[True]
    assert (n0, n1) == (1, 2)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
