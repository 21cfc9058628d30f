"""Train state, LR schedules and the SGD chain (port of
``basi_tpu/train/state.py``).

The JAX package's optimizer is the optax chain clip-by-global-norm ->
``add_decayed_weights`` on every leaf (BN and GN included) -> momentum trace
``g + m * trace`` -> ``-lr * trace``, with ``lr = schedule(count)`` and the
count starting at 0. ``clip_by_global_norm`` below writes optax's formula;
``torch.optim.SGD`` (momentum, ``weight_decay``, no dampening) is the rest
of the chain, its lr set from the schedule before each update. With
``train.optimizer=adamw`` the rest is ``optax.adamw(schedule,
weight_decay)``: Adam with b1 0.9, b2 0.999, eps 1e-8 (outside the square
root), then ``lr * wd * param`` decoupled, on every leaf, which is
``torch.optim.AdamW``'s function with its arithmetic in another order.
The optimizer state takes the params' dtype (``model.param_dtype``), as
optax's does. The EMA holds f32 copies of the params (no BN statistics)
and starts at them: under bf16 params the JAX EMA starts in bf16 and its
first update (an f32 decay) makes it f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

Schedule = Callable[[int], float]


def poly_schedule(base_lr: float, max_steps: int, power: float = 0.9,
                  warmup_steps: int = 0) -> Schedule:
    """``base_lr * (1 - step/max_steps)^power`` times a linear warmup
    ramp, evaluated in f32 as the JAX schedule is."""
    return _schedule("poly", base_lr, max_steps, power, warmup_steps)


def make_schedule(cfg, max_steps: int) -> Schedule:
    """LR schedule from a TrainConfig: poly, cosine or constant, each with
    the same linear warmup."""
    if cfg.schedule not in ("poly", "cosine", "constant"):
        raise ValueError(f"unknown train.schedule {cfg.schedule!r} "
                         "(poly | cosine | constant)")
    return _schedule(cfg.schedule, cfg.lr, max_steps, cfg.poly_power,
                     cfg.warmup_steps)


def _schedule(kind: str, base_lr: float, max_steps: int, power: float,
              warmup_steps: int) -> Schedule:
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        frac = np.clip(s / f32(max(max_steps, 1)), f32(0), f32(1))
        if kind == "poly":
            lr = f32(base_lr) * (f32(1) - frac) ** f32(power)
        elif kind == "cosine":
            lr = f32(base_lr) * f32(0.5) * (f32(1) + np.cos(f32(math.pi) * frac))
        else:
            lr = f32(base_lr)
        if warmup_steps > 0:
            lr = lr * np.clip(s / f32(warmup_steps), f32(0), f32(1))
        return float(f32(lr))

    return schedule


def check_train_config(cfg) -> None:
    """Raise NotImplementedError for training settings outside the port."""
    todo = [
        (cfg.train.steps_per_dispatch > 1, "train.steps_per_dispatch > 1"),
        (cfg.parallel.num_devices > 1 or cfg.parallel.spatial_shards > 1,
         "multi-device training"),
    ]
    for bad, what in todo:
        if bad:
            raise NotImplementedError(f"{what} not yet ported")


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: when the global norm is at least
    ``max_norm``, every gradient becomes ``g / norm * max_norm`` (no 1e-6
    as in ``torch.nn.utils.clip_grad_norm_``). In place; returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = norm >= max_norm
    one = torch.ones_like(norm)
    # g / 1 * 1 == g exactly, so unclipped gradients stay bit for bit;
    # no host sync on the decision.
    torch._foreach_div_(grads, torch.where(clip, norm, one))
    torch._foreach_mul_(grads, torch.where(clip, max_norm * one, one))
    return norm


def make_optimizer(cfg_train, params) -> torch.optim.Optimizer:
    """The chain after the clip: SGD (momentum trace, decayed weights on
    every leaf) or AdamW (``train.optimizer``); its lr is set from the
    schedule before each step."""
    if cfg_train.optimizer == "adamw":
        return torch.optim.AdamW(list(params), lr=0.0, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg_train.weight_decay)
    if cfg_train.optimizer != "sgd":
        raise ValueError(f"unknown train.optimizer {cfg_train.optimizer!r} "
                         "(sgd | adamw)")
    return torch.optim.SGD(list(params), lr=0.0, momentum=cfg_train.momentum,
                           weight_decay=cfg_train.weight_decay)


def ema_of(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """f32 (or wider) copies of the model's params: a fresh EMA."""
    return {k: p.detach().to(torch.promote_types(p.dtype, torch.float32),
                             copy=True)
            for k, p in model.named_parameters()}


@dataclass
class TrainState:
    """What a step reads and updates in place: the model (master params in
    ``model.param_dtype`` and f32 BN running statistics), the optimizer
    (momentum buffers or Adam moments), the EMA of the params (or None),
    the step count and the generator that draws the augmentation
    (``train/step.py::draw_augment``)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema: dict[str, torch.Tensor] | None
    step: int
    generator: torch.Generator


def create_train_state(model: torch.nn.Module, cfg_train) -> TrainState:
    """Fresh state around ``model``: empty optimizer state, EMA at the
    params (``train.ema_decay > 0``), step 0, a CPU generator seeded from
    ``train.seed`` (the same draws on every device)."""
    ema = None
    if cfg_train.ema_decay > 0:
        ema = ema_of(model)
    return TrainState(model=model,
                      optimizer=make_optimizer(cfg_train, model.parameters()),
                      ema=ema, step=0,
                      generator=torch.Generator().manual_seed(cfg_train.seed))
