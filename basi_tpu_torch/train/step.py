"""The single-device train step (port of ``basi_tpu/train/step.py``).

One call does, in the JAX step's order, for each of ``train.grad_accum``
micro-batches: the augmentation draws (``draw_augment``); unpack the
bit-packed GT masks on the device; ``normalize_and_flip`` the uint8 images
into the compute dtype (the CUDA kernel on the card); the colour jitter
(``data.color_jitter``); then either the scale jitter (``data.multiscale``:
the full-resolution masks flipped and cast to f32, image and masks zoomed
by ``data/transforms.py::random_augment``, the loss taking its statistics
from them) or ``instance_stats`` on the full-resolution masks, with ``cx``,
``x0`` and ``x1`` mirrored for flipped images, and the masks max-pooled to
/4, then flipped; the train-mode forward (the trunk frozen or
rematerialized by ``train.freeze_bn`` and ``train.remat``; every cell's
candidate mask when ``train.max_pos_cells=0``), the loss and the backward.
The roi mechanism assigns its targets before the forward, whose ROI mask
head predicts at the assigned GT boxes, and takes ``basi_roi_loss``; it
keeps ``max_pos_cells`` cells (64 where that is 0: it has no dense path).
Micro-batches run in turn, each normalizing its own loss and moving the
BN running statistics in sequence; the gradient kept is their mean,
accumulated as ``g / accum`` as JAX's scan carries it, and the metrics
are averaged. Then one clip, one update (SGD or AdamW) and one EMA update
with the ``min(d, (1 + t) / (10 + t))`` ramp. The state is updated in
place (the JAX step returns a new one): params, optimizer state and EMA
are written where they lie, so no second copy of them is ever held.

The draws: ``draw_augment(state, n, cfg_data)`` takes every random number
of one micro-batch from the state's ``torch.Generator``, in one fixed
order whatever the settings (flip, scale, the two offsets, the three
jitter factors), so turning one augmentation on changes none of the
others' draws, as JAX's key tree keeps them apart. JAX draws from
threefry keys (``fold_in(fold_in(rng, step), 0)``, then ``fold_in`` of
the micro-batch's index under accumulation, split into the flip key and
the augmentation key), so the same seed gives other numbers here; the
parity tests monkeypatch ``draw_augment`` with the numbers of JAX's key
tree. With ``hflip_prob`` 0 or 1 and no other augmentation both sides
draw alike (no flip, or all).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from basi_tpu_torch.data.transforms import (
    color_jitter,
    maybe_unpack_masks,
    random_augment,
)
from basi_tpu_torch.kernels.normalize_aug import normalize_and_flip
from basi_tpu_torch.ops.resize import maxpool_hw
from basi_tpu_torch.train.loss import ROI_TARGETS, basi_loss, basi_roi_loss
from basi_tpu_torch.train.state import Schedule, TrainState, clip_by_global_norm
from basi_tpu_torch.train.targets import assign_targets_roi, instance_stats

MASK_STRIDE = 4  # the mask features are H/4 x W/4
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str, what: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown {what} {name!r} (float32 | bfloat16)")
    return _DTYPES[name]


def compute_dtype(mcfg) -> torch.dtype:
    """The activations' dtype (``model.dtype``)."""
    param_dtype(mcfg)  # an unknown param_dtype fails as early
    return _dtype(mcfg.dtype, "model.dtype")


def param_dtype(mcfg) -> torch.dtype:
    """The master params' dtype (``model.param_dtype``)."""
    return _dtype(mcfg.param_dtype, "model.param_dtype")


class AugmentDraws(NamedTuple):
    """One micro-batch's draws, (n,) each: flip flags (int32, 1 with
    probability ``hflip_prob``), scale in [lo, hi) of ``scale_range``,
    offsets in [0, 1), and the brightness, contrast and saturation factors
    in [max(0, 1 - x), 1 + x) of ``color_jitter``'s strengths (f32)."""

    flip: torch.Tensor
    scale: torch.Tensor
    off_y: torch.Tensor
    off_x: torch.Tensor
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor


def draw_augment(state: TrainState, n: int, cfg_data) -> AugmentDraws:
    """Every draw of one micro-batch of ``n`` images from the state's
    generator (on the CPU: the same numbers on every device), all seven
    vectors always, in ``AugmentDraws``' order."""
    u = torch.rand(7, n, generator=state.generator)

    def between(row, lo, hi):
        return u[row] * np.float32(hi - lo) + np.float32(lo)

    lo, hi = cfg_data.scale_range
    jit = [between(4 + i, max(0.0, 1.0 - x), 1.0 + x)
           for i, x in enumerate(cfg_data.color_jitter)]
    return AugmentDraws((u[0] < cfg_data.hflip_prob).to(torch.int32),
                        between(1, lo, hi), u[2], u[3], *jit)


def prepare_batch(batch: dict, draws: AugmentDraws, cfg_data, dtype):
    """(images in ``dtype``, float masks, valid, full-resolution stats or
    None) from a device batch with uint8 ``image`` (N, H, W, 3), ``masks``
    raw or bit-packed and ``valid`` (N, M): the masks at /4 with their
    stats, or under ``data.multiscale`` at full resolution, rescaled with
    the image, and no stats (the loss takes them from the masks)."""
    images = batch["image"]
    flip = draws.flip.to(images.device, non_blocking=True)
    gt_u8 = maybe_unpack_masks(batch["masks"], images.shape[2])
    imgs = normalize_and_flip(images, flip, mean=tuple(cfg_data.mean),
                              std=tuple(cfg_data.std), out_dtype=dtype)
    if any(v > 0 for v in cfg_data.color_jitter):
        imgs = color_jitter(imgs, cfg_data.mean, cfg_data.std,
                            *cfg_data.color_jitter, draws.brightness,
                            draws.contrast, draws.saturation)
    flipped = flip[:, None, None, None] > 0
    if cfg_data.multiscale:
        masks = gt_u8.float()
        masks = torch.where(flipped, masks.flip(3), masks)
        imgs, masks = random_augment(imgs, masks, draws.scale, draws.off_y,
                                     draws.off_x)
        return imgs, masks, batch["valid"], None
    stats = instance_stats(gt_u8, batch["valid"])
    fx = flip[:, None] > 0
    x0, x1 = stats["x0"], stats["x1"]
    stats["cx"] = torch.where(fx, 1.0 - stats["cx"], stats["cx"])
    stats["x0"] = torch.where(fx, 1.0 - x1, x0)
    stats["x1"] = torch.where(fx, 1.0 - x0, x1)
    small = maxpool_hw(gt_u8, MASK_STRIDE, MASK_STRIDE)
    small = torch.where(flipped, small.flip(3), small)
    return imgs, small.float(), batch["valid"], stats


def loss_and_grads(state: TrainState, batch: dict, draws: AugmentDraws,
                   cfg_train, cfg_data, dtype):
    """Forward in train mode (BN running statistics update unless
    ``train.freeze_bn``), the loss and its backward into the params'
    ``.grad`` (set, not added to). Returns (loss, metrics)."""
    imgs, masks, valid, stats = prepare_batch(batch, draws, cfg_data, dtype)
    model = state.model
    model.zero_grad(set_to_none=True)
    weights = dict(loss_kind=cfg_train.loss,
                   mask_weight=cfg_train.mask_loss_weight,
                   score_weight=cfg_train.score_loss_weight,
                   saliency_weight=cfg_train.saliency_loss_weight)
    run = dict(train=True, frozen_bn=cfg_train.freeze_bn,
               remat=cfg_train.remat)
    if model.instance_mechanism == "roi":
        # the targets first: the ROI mask head predicts at their GT boxes
        mask_hw = (imgs.shape[1] // MASK_STRIDE, imgs.shape[2] // MASK_STRIDE)
        cells = cfg_train.max_pos_cells if cfg_train.max_pos_cells > 0 else 64
        targets = dict(zip(ROI_TARGETS, assign_targets_roi(
            masks, valid, grid_size=model.grid_size, mask_hw=mask_hw,
            max_pos_cells=cells, stats=stats)))
        out = model(imgs, roi_boxes=targets["sel_boxes"], **run)
        loss, metrics = basi_roi_loss(
            out, targets, masks, valid,
            box_weight=cfg_train.box_loss_weight, **weights)
    else:
        dense = cfg_train.max_pos_cells <= 0
        out = model(imgs, with_candidates=dense, **run)
        loss, metrics = basi_loss(
            out, masks, valid, max_pos_cells=cfg_train.max_pos_cells,
            gt_stats=stats, **weights)
    loss.backward()
    return loss, metrics


def accumulate_grads(state: TrainState, batch: dict, cfg_train, cfg_data,
                     dtype) -> dict:
    """The mean gradient of ``train.grad_accum`` micro-batches of
    ``batch`` into the params' ``.grad``, each micro-batch with its own
    draws; returns the metrics, averaged over them."""
    accum = cfg_train.grad_accum
    n = batch["image"].shape[0]
    if accum < 1 or n % accum:
        raise ValueError(f"train.grad_accum={accum} does not divide the "
                         f"batch size {n}")
    params = list(state.model.parameters())
    acc = None
    metrics = []
    for i in range(accum):
        micro = {k: batch[k].chunk(accum)[i] for k in ("image", "masks",
                                                        "valid")}
        draws = draw_augment(state, n // accum, cfg_data)
        _, m = loss_and_grads(state, micro, draws, cfg_train, cfg_data, dtype)
        metrics.append({k: v.detach() for k, v in m.items()})
        if accum == 1:
            return metrics[0]
        with torch.no_grad():
            g = [p.grad for p in params]
            torch._foreach_div_(g, float(accum))
            if acc is None:
                acc = g
            else:
                torch._foreach_add_(acc, g)
    for p, g in zip(params, acc):
        p.grad = g
    return {k: torch.stack([m[k] for m in metrics]).mean(0)
            for k in metrics[0]}


def make_train_step(cfg_train, cfg_data, schedule: Schedule, dtype
                    ) -> Callable[[TrainState, dict], dict]:
    """``step(state, batch) -> metrics`` (device scalars; reading one
    waits for the step). ``batch``: device tensors ``image``, ``masks``
    and ``valid``."""
    ema_decay = float(cfg_train.ema_decay)
    clip = float(cfg_train.grad_clip_norm)

    def step(state: TrainState, batch: dict) -> dict:
        metrics = accumulate_grads(state, batch, cfg_train, cfg_data, dtype)
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
        return metrics

    return step
