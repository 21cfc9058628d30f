"""Two train steps of the port against the JAX package's
``make_train_step``, both in float64 (moved out of ``test_torch_train.py``,
whose harness ``_run_steps`` they use, so that another worker runs them):
hflip 0 or 1, clipping active or not; the tolerances are
``test_torch_train``'s."""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import dataclasses

import jax
import numpy as np
import pytest

from basi_tpu_torch.convert import to_jax_variables
from test_torch_train import _assert_step_matches, _run_steps

from helpers import tiny_config


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
    step has its own test in ``test_torch_train.py``. The losses upcast to
    f32 on both sides, and the images are normalized in f32, as in the f32
    step."""
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
