"""Losses: BCE, Dice, focal and the saliency loss (port of
``basi_tpu/ops/losses.py``, single device: no ``axis_name``).

Every loss upcasts to f32 first, so bf16 logits are safe; ratios divide by
the clamped sum of their weights, as the JAX package's ``_ratio`` does.
The BASNet-hybrid saliency loss (SSIM + IoU) is not ported.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def _bce_elems(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    targets = targets.float()
    return (logits.clamp_min(0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor,
                weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean (or ``weights``-weighted mean) binary cross-entropy from logits."""
    per = _bce_elems(logits, targets)
    if weights is None:
        return per.sum() / max(float(per.numel()), _EPS)
    w = weights.float()
    return (per * w).sum() / (w.sum()).clamp_min(_EPS)


def dice_loss(logits: torch.Tensor, targets: torch.Tensor,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """Soft Dice loss per mask over the last two dims, averaged over masks
    (or over ``valid`` ones)."""
    p = torch.sigmoid(logits.float())
    t = targets.float()
    inter = (p * t).sum(dim=(-2, -1))
    denom = (p * p).sum(dim=(-2, -1)) + (t * t).sum(dim=(-2, -1))
    dice = 1.0 - (2.0 * inter + _EPS) / (denom + _EPS)
    if valid is None:
        return dice.sum() / max(float(dice.numel()), _EPS)
    v = valid.float()
    return (dice * v).sum() / v.sum().clamp_min(_EPS)


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Sigmoid focal loss, summed over cells, normalized by #positives."""
    logits = logits.float()
    t = targets.float()
    p = torch.sigmoid(logits)
    ce = _bce_elems(logits, t)
    p_t = p * t + (1.0 - p) * (1.0 - t)
    alpha_t = alpha * t + (1.0 - alpha) * (1.0 - t)
    loss = alpha_t * (1.0 - p_t) ** gamma * ce
    return loss.sum() / t.sum().clamp_min(1.0)


def saliency_loss(logits: torch.Tensor, target: torch.Tensor,
                  kind: str = "bce_dice") -> torch.Tensor:
    """One saliency map: (N, H, W, 1) logits vs (N, H, W) target."""
    lg = logits[..., 0]
    if kind == "bce_dice":
        return sigmoid_bce(lg, target) + dice_loss(lg, target)
    if kind == "basnet_hybrid":
        raise NotImplementedError("train.loss='basnet_hybrid' not yet ported")
    raise ValueError(f"unknown loss kind {kind!r}")
