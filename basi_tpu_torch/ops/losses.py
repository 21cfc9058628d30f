"""Losses: BCE, Dice, focal, soft IoU, SSIM and the saliency loss (port of
``basi_tpu/ops/losses.py``, single device: no ``axis_name``).

Every loss upcasts to f32 first, so bf16 logits are safe; ratios divide by
the clamped sum of their weights, as the JAX package's ``_ratio`` does.
The saliency loss is BCE + Dice, or the BASNet hybrid BCE + SSIM + soft
IoU (``train.loss=basnet_hybrid``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def soft_iou_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """1 - soft IoU per map over the last two dims, averaged over maps."""
    p = torch.sigmoid(logits.float())
    t = targets.float()
    inter = (p * t).sum(dim=(-2, -1))
    union = (p + t - p * t).sum(dim=(-2, -1))
    per = 1.0 - (inter + _EPS) / (union + _EPS)
    return per.sum() / max(float(per.numel()), _EPS)


def ssim_loss(logits: torch.Tensor, targets: torch.Tensor, window: int = 11,
              c1: float = 0.01 ** 2, c2: float = 0.03 ** 2) -> torch.Tensor:
    """1 - mean SSIM of sigmoid(logits) against targets, (N, H, W[, 1]),
    with a ``window`` x ``window`` box window: the JAX package's
    ``reduce_window`` sum over "SAME" zero padding divided by window^2,
    which is ``avg_pool2d`` counting the padding."""
    p = torch.sigmoid(logits.float())
    t = targets.float()
    if p.dim() == 4:
        p, t = p[..., 0], t[..., 0]
    if p.dim() != 3:
        raise ValueError(f"ssim expects (N,H,W[,1]) got {tuple(logits.shape)}")
    p, t = p[:, None], t[:, None]

    def box(x):
        return F.avg_pool2d(x, window, 1, window // 2, count_include_pad=True)

    mu_p, mu_t = box(p), box(t)
    var_p = box(p * p) - mu_p ** 2
    var_t = box(t * t) - mu_t ** 2
    cov = box(p * t) - mu_p * mu_t
    ssim = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2))
    per = 1.0 - ssim
    return per.sum() / max(float(per.numel()), _EPS)


def saliency_loss(logits: torch.Tensor, target: torch.Tensor,
                  kind: str = "bce_dice") -> torch.Tensor:
    """One saliency map: (N, H, W, 1) logits vs (N, H, W) target."""
    lg = logits[..., 0]
    if kind == "bce_dice":
        return sigmoid_bce(lg, target) + dice_loss(lg, target)
    if kind == "basnet_hybrid":
        return (sigmoid_bce(lg, target) + ssim_loss(lg, target)
                + soft_iou_loss(lg, target))
    raise ValueError(f"unknown loss kind {kind!r}")
