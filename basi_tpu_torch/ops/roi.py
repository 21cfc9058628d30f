"""ROI crop and paste as separable matmuls (port of ``basi_tpu/ops/roi.py``).

Bilinear sampling along an axis is a linear map, so cropping a box of a
feature map to an R x R grid is ``W_y @ F @ W_x^T`` with banded hat-weight
matrices built from the box coordinates, and pasting an R x R patch back
onto a canvas is the same product with the inverse maps. No gathers with
data-dependent indices and no data-dependent shapes: every function takes
the batch and ROI dims (N, K) written out, where the JAX functions take
one image's ROIs and are vmapped.

Conventions: boxes are (y0, x0, y1, x1) in normalized [0, 1] image
coordinates; sampling uses half-pixel centres (align_corners=False). The
operations are the JAX package's in its order, as XLA compiles them on
the CPU: a division by a constant is a product with its f32 reciprocal,
and the box decode's ``* 0.05 / softplus(0)`` one product with their f32
quotient. XLA also fuses multiply-adds into FMAs, and its ``exp`` and
``log1p`` round otherwise than torch's, so on the same inputs sample
coordinates and decoded boxes can differ from JAX's by an ulp. Pairwise
minima and maxima, clips among them, are ``torch.minimum`` and
``torch.maximum``, whose gradient splits at ties as JAX's does (the
sampling weights, which take no gradient, clip with ``clamp``).
"""

from __future__ import annotations

import numpy as np
import torch

from basi_tpu_torch.utils.profiling import span

_EPS = 1e-6
# softplus(raw) * 0.05 / softplus(0.0), as XLA folds the two constants
_BOX_SCALE = float(np.float32(0.05) / np.float32(np.log(2.0)))


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)``: at a tie the gradient splits."""
    return torch.maximum(x, torch.full((), c, dtype=x.dtype, device=x.device))


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)``, a maximum then a minimum."""
    return torch.minimum(_max(x, 0.0),
                         torch.ones((), dtype=x.dtype, device=x.device))


def _centres(n: int, device) -> torch.Tensor:
    """(arange(n) + 0.5) / n in f32: pixel or cell centres in [0, 1]."""
    idx = torch.arange(n, dtype=torch.float32, device=device)
    return (idx + 0.5) * (1.0 / n)


def _crop_axis_weights(c0: torch.Tensor, c1: torch.Tensor, out_size: int,
                       in_size: int) -> torch.Tensor:
    """(..., out_size, in_size) bilinear sampling matrices for one box
    axis: output bin r samples source coordinate
    ``(c0 + (r + .5) / R * (c1 - c0)) * in_size - 0.5``, clipped to the
    grid; each row holds the two-tap hat weights (rows sum to 1)."""
    r = _centres(out_size, c0.device)
    src = (c0[..., None] + r * (c1 - c0)[..., None]) * in_size - 0.5
    src = src.clamp(0.0, in_size - 1.0)
    idx = torch.arange(in_size, dtype=torch.float32, device=c0.device)
    return (1.0 - (src[..., None] - idx).abs()).clamp_min(0.0)


def _paste_axis_weights(c0: torch.Tensor, c1: torch.Tensor, out_size: int,
                        roi_size: int) -> torch.Tensor:
    """(..., out_size, roi_size) inverse maps, canvas pixels <- ROI grid:
    pixel p (half-pixel centre, normalized) lands at ROI coordinate
    ``(p - c0) / (c1 - c0) * R - 0.5``; pixels outside [c0, c1) get
    all-zero rows, and edge ROI cells extend to the box border."""
    p = _centres(out_size, c0.device)
    c0, c1 = c0[..., None], c1[..., None]
    u = (p - c0) / (c1 - c0).clamp_min(_EPS) * roi_size - 0.5
    inside = (p >= c0) & (p < c1)
    u = u.clamp(0.0, roi_size - 1.0)
    idx = torch.arange(roi_size, dtype=torch.float32, device=c0.device)
    w = (1.0 - (u[..., None] - idx).abs()).clamp_min(0.0)
    return w * inside[..., None].to(w.dtype)


def roi_align(feats: torch.Tensor, boxes: torch.Tensor,
              resolution: int) -> torch.Tensor:
    """Crop and resample K boxes of each image: feats (N, H, W, E), boxes
    (N, K, 4) -> (N, K, R, R, E) in the features' dtype, computed in f32.
    Degenerate boxes (y1 <= y0) sample one clipped line: no NaNs, no
    special cases. The rows are contracted first, then the columns (the
    JAX order); the intermediate is (N, K, R, W, E) f32. Runs in the
    ``roi.align`` span."""
    n, h, w, e = feats.shape
    with span("roi.align"):
        b = boxes.float()
        wy = _crop_axis_weights(b[..., 0], b[..., 2], resolution, h)
        wx = _crop_axis_weights(b[..., 1], b[..., 3], resolution, w)
        k = b.shape[1]
        rows = torch.bmm(wy.reshape(n, k * resolution, h),
                         feats.float().reshape(n, h, w * e))
        rows = rows.reshape(n, k, resolution, w, e)
        return torch.matmul(wx[:, :, None], rows).to(feats.dtype)


def paste_rois(patches: torch.Tensor, boxes: torch.Tensor,
               out_hw: tuple[int, int]) -> torch.Tensor:
    """Paste ROI-frame patches back onto zero canvases (the inverse crop):
    patches (N, K, R, R) (sigmoid probabilities: the canvas outside a box
    stays 0), boxes (N, K, 4) -> (N, K, out_h, out_w) in the patches'
    dtype, computed in f32 as ``W_y @ patch @ W_x^T``."""
    oh, ow = out_hw
    r = patches.shape[-1]
    b = boxes.float()
    wy = _paste_axis_weights(b[..., 0], b[..., 2], oh, r)  # (N, K, oh, R)
    wx = _paste_axis_weights(b[..., 1], b[..., 3], ow, r)  # (N, K, ow, R)
    out = (wy @ patches.float()) @ wx.transpose(-1, -2)
    return out.to(patches.dtype)


def decode_cell_boxes(raw: torch.Tensor, grid_size: int) -> torch.Tensor:
    """FCOS-style box decode on the cell grid: raw (..., S, S, 4)
    unconstrained (l, t, r, b) distance logits around each cell's centre ->
    (..., S, S, 4) f32 normalized (y0, x0, y1, x1) clipped to [0, 1].
    Distances are ``softplus(raw) * 0.05 / softplus(0)`` (softplus as
    JAX's ``logaddexp(x, 0)``)."""
    cc = _centres(grid_size, raw.device)
    cy, cx = cc[:, None], cc[None, :]
    x = raw.float()
    d = torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))
    left, top, right, bottom = (d * _BOX_SCALE).unbind(-1)
    return torch.stack([_clip01(cy - top), _clip01(cx - left),
                        _clip01(cy + bottom), _clip01(cx + right)], dim=-1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of (..., 4) normalized (y0, x0, y1, x1) boxes."""
    ay0, ax0, ay1, ax1 = a.unbind(-1)
    by0, bx0, by1, bx1 = b.unbind(-1)
    iy = _max(torch.minimum(ay1, by1) - torch.maximum(ay0, by0), 0.0)
    ix = _max(torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0), 0.0)
    inter = iy * ix
    area_a = _max(ay1 - ay0, 0.0) * _max(ax1 - ax0, 0.0)
    area_b = _max(by1 - by0, 0.0) * _max(bx1 - bx0, 0.0)
    return inter / _max(area_a + area_b - inter, _EPS)
