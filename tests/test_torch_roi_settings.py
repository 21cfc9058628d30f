"""The roi mechanism's train step with the settings of
``train_multiscale_fused`` against the JAX package's, in float64 on the
CPU at ``tests/test_roi.py``'s tiny configuration (``_check_steps`` of
``test_torch_roi_train.py``, its tolerances), in a file of its own so that
another worker runs it."""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import dataclasses

import test_torch_train as TT
from basi_tpu.data import transforms as jax_transforms
from basi_tpu.models import norm as jax_norm
from basi_tpu.ops.pallas import bn_stats as jax_bn_stats

from test_torch_roi_train import _check_steps, _roi_settings_config


def test_roi_settings_steps_match_jax(monkeypatch):
    """Two float64 steps of the roi mechanism (``_check_steps``) with the
    scale jitter, ``grad_accum=2``, remat and ``model.bn_impl=fused`` at
    once. JAX's augmentation and
    fused BatchNorm read float64 where they cast to float32
    (``test_fused_bn_train_steps_match_jax``)."""
    for mod in (jax_transforms, jax_norm, jax_bn_stats):
        monkeypatch.setattr(mod, "jnp", TT._Float32As64())
    cfg = _roi_settings_config(data={"multiscale": True},
                               train={"grad_accum": 2, "remat": True})
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, bn_impl="fused"))
    _check_steps(cfg, monkeypatch)
