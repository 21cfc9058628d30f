"""The single-device train step (port of ``basi_tpu/train/step.py``).

One call does, in the JAX step's order: draw the flip flags from the
state's generator; unpack the bit-packed GT masks on the device;
``normalize_and_flip`` the uint8 images into the compute dtype (the CUDA
kernel on the card); ``instance_stats`` on the full-resolution masks, with
``cx``, ``x0`` and ``x1`` mirrored for flipped images; the masks max-pooled
to /4, then flipped; the train-mode forward, the loss and the backward;
then clip, weight decay, momentum SGD and the EMA update with the
``min(d, (1 + t) / (10 + t))`` ramp. The state is updated in place (the
JAX step returns a new one): params, momentum and EMA are written where
they lie, so no second copy of them is ever held.

The flip flags come from a ``torch.Generator``, not JAX's threefry, so the
two draw different flips from the same seed; with ``hflip_prob`` 0 or 1
both draw the same (none or all).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from basi_tpu_torch.data.transforms import maybe_unpack_masks
from basi_tpu_torch.kernels.normalize_aug import normalize_and_flip
from basi_tpu_torch.ops.resize import maxpool_hw
from basi_tpu_torch.train.loss import basi_loss
from basi_tpu_torch.train.state import Schedule, TrainState, clip_by_global_norm
from basi_tpu_torch.train.targets import instance_stats

MASK_STRIDE = 4  # the mask features are H/4 x W/4
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(mcfg) -> torch.dtype:
    """The activations' dtype (``model.dtype``); params stay
    ``model.param_dtype``, which must be float32."""
    if mcfg.param_dtype != "float32":
        raise NotImplementedError(
            f"model.param_dtype={mcfg.param_dtype!r} not yet ported")
    if mcfg.dtype not in _DTYPES:
        raise ValueError(f"unknown model.dtype {mcfg.dtype!r}")
    return _DTYPES[mcfg.dtype]


def prepare_batch(batch: dict, flip: torch.Tensor, cfg_data, dtype):
    """(images in ``dtype``, /4 float masks, valid, full-res stats) from a
    device batch with uint8 ``image`` (N, H, W, 3), ``masks`` raw or
    bit-packed and ``valid`` (N, M)."""
    images = batch["image"]
    gt_u8 = maybe_unpack_masks(batch["masks"], images.shape[2])
    imgs = normalize_and_flip(images, flip, mean=tuple(cfg_data.mean),
                              std=tuple(cfg_data.std), out_dtype=dtype)
    stats = instance_stats(gt_u8, batch["valid"])
    fx = flip[:, None] > 0
    x0, x1 = stats["x0"], stats["x1"]
    stats["cx"] = torch.where(fx, 1.0 - stats["cx"], stats["cx"])
    stats["x0"] = torch.where(fx, 1.0 - x1, x0)
    stats["x1"] = torch.where(fx, 1.0 - x0, x1)
    small = maxpool_hw(gt_u8, MASK_STRIDE, MASK_STRIDE)
    small = torch.where(flip[:, None, None, None] > 0, small.flip(3), small)
    return imgs, small.float(), batch["valid"], stats


def loss_and_grads(state: TrainState, batch: dict, flip: torch.Tensor,
                   cfg_train, cfg_data, dtype):
    """Forward in train mode (BN running statistics update), the loss and
    its backward into the params' ``.grad``. Returns (loss, metrics)."""
    imgs, masks, valid, stats = prepare_batch(batch, flip, cfg_data, dtype)
    model = state.model
    model.zero_grad(set_to_none=True)
    out = model(imgs, train=True)
    loss, metrics = basi_loss(
        out, masks, valid, loss_kind=cfg_train.loss,
        mask_weight=cfg_train.mask_loss_weight,
        score_weight=cfg_train.score_loss_weight,
        saliency_weight=cfg_train.saliency_loss_weight,
        max_pos_cells=cfg_train.max_pos_cells, gt_stats=stats)
    loss.backward()
    return loss, metrics


def draw_flip(state: TrainState, n: int, hflip_prob: float,
              device) -> torch.Tensor:
    """(n,) int32 flags, 1 with probability ``hflip_prob``, from the
    state's generator (on the CPU, then copied to ``device``)."""
    u = torch.rand(n, generator=state.generator)
    return (u < hflip_prob).to(torch.int32).to(device, non_blocking=True)


def make_train_step(cfg_train, cfg_data, schedule: Schedule, dtype
                    ) -> Callable[[TrainState, dict], dict]:
    """``step(state, batch) -> metrics`` (device scalars; reading one
    waits for the step). ``batch``: device tensors ``image``, ``masks``
    and ``valid``."""
    ema_decay = float(cfg_train.ema_decay)
    clip = float(cfg_train.grad_clip_norm)

    def step(state: TrainState, batch: dict) -> dict:
        n = batch["image"].shape[0]
        flip = draw_flip(state, n, cfg_data.hflip_prob, batch["image"].device)
        _, metrics = loss_and_grads(state, batch, flip, cfg_train, cfg_data,
                                    dtype)
        named = dict(state.model.named_parameters())
        with torch.no_grad():
            if clip > 0:
                clip_by_global_norm([p.grad for p in named.values()], clip)
            for group in state.optimizer.param_groups:
                group["lr"] = schedule(state.step)
            state.optimizer.step()
            state.step += 1
            if state.ema is not None:
                # d and 1 - d in f32, as the JAX step computes them
                t = np.float32(state.step)
                d = np.minimum(np.float32(ema_decay),
                               (np.float32(1) + t) / (np.float32(10) + t))
                ema = [state.ema[k] for k in named]
                torch._foreach_mul_(ema, float(d))
                torch._foreach_add_(ema, list(named.values()),
                                    alpha=float(np.float32(1) - d))
        return {k: v.detach() for k, v in metrics.items()}

    return step
