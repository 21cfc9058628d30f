"""BASI heads (port of ``basi_tpu/models/heads.py``).

NCHW tensors in ``channels_last`` memory; every resize goes through
``ops.resize`` so bf16 integer-factor upsamples reach the ``upsample_int``
kernel on the card. Convs and GroupNorm keep the JAX package's mixed
precision (``models/layers.py``). Module names follow the JAX package's
parameter tree as ``export_basinet`` maps it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from basi_tpu_torch.models.layers import Conv2d, GroupNorm
from basi_tpu_torch.ops.resize import resize_nchw
from basi_tpu_torch.ops.roi import roi_align

GN_GROUPS = 32
GN_EPS = 1e-5


def coord_features(n: int, h: int, w: int, dtype: torch.dtype,
                   device) -> torch.Tensor:
    """Normalized (-1..1) coordinate maps, (N, 2, H, W), channel order
    (x, y) — CoordConv. Built in f32, then cast."""
    ys = torch.linspace(-1.0, 1.0, h, dtype=torch.float32, device=device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=torch.float32, device=device)
    grid = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)])
    return grid[None].expand(n, 2, h, w).to(dtype)


def _cat_coords(x: torch.Tensor) -> torch.Tensor:
    n, _, h, w = x.shape
    coords = coord_features(n, h, w, x.dtype, x.device)
    return torch.cat([x, coords], dim=1).contiguous(
        memory_format=torch.channels_last)


class SaliencyHead(nn.Module):
    """Per level: 3x3 tower + ReLU, resized to /4; the concat of all levels
    goes through a 1x1 ``fuse`` conv to the fused /4 logits. With
    ``with_aux`` (training) each level's 1x1 ``out{i}`` conv gives its own
    logits, resized to /4: the loss's deep supervision."""

    def __init__(self, ch_in: int = 256, ch: int = 64, levels: int = 4):
        super().__init__()
        for i in range(levels):
            setattr(self, f"tower{i}", Conv2d(ch_in, ch, 3, padding=1))
            setattr(self, f"out{i}", Conv2d(ch, 1, 1))
        self.fuse = Conv2d(ch * levels, 1, 1)
        self.levels = levels

    def forward(self, pyramid, with_aux: bool = False):
        """Returns (fused logits (N, 1, H/4, W/4), per-level logits at /4,
        empty without ``with_aux``)."""
        base_hw = pyramid[0].shape[-2:]
        feats, aux = [], []
        for i, p in enumerate(pyramid):
            f = F.relu(getattr(self, f"tower{i}")(p))
            if with_aux:
                aux.append(resize_nchw(getattr(self, f"out{i}")(f), base_hw))
            feats.append(resize_nchw(f, base_hw))
        return self.fuse(torch.cat(feats, dim=1)), aux


class MaskFeatureHead(nn.Module):
    """Unified /4 mask features: per level 3x3 conv + GN + ReLU resized to
    /4 and summed (CoordConv at the coarsest level), then a 1x1 to E."""

    def __init__(self, ch_in: int = 256, ch: int = 128, embed: int = 64,
                 levels: int = 4):
        super().__init__()
        for i in range(levels):
            cin = ch_in + (2 if i == levels - 1 else 0)
            setattr(self, f"level{i}", Conv2d(cin, ch, 3, padding=1))
            setattr(self, f"gn{i}", GroupNorm(GN_GROUPS, ch, eps=GN_EPS))
        self.embed = Conv2d(ch, embed, 1)
        self.levels = levels

    def forward(self, pyramid):
        base_hw = pyramid[0].shape[-2:]
        acc = None
        for i, p in enumerate(pyramid):
            if i == self.levels - 1:
                p = _cat_coords(p)
            f = F.relu(getattr(self, f"gn{i}")(getattr(self, f"level{i}")(p)))
            f = resize_nchw(f, base_hw)
            acc = f if acc is None else acc + f
        return self.embed(acc)


class _GridHead(nn.Module):
    """A cell-grid head: P3 + CoordConv resized to the S x S grid, a
    ``depth``-deep conv/GN/ReLU tower, then two 3x3 prediction convs, the
    objectness logits ``score`` (N, 1, S, S) and a second one named
    ``second`` with ``second_ch`` channels (N, second_ch, S, S)."""

    def __init__(self, ch_in: int, ch: int, second: str, second_ch: int,
                 grid: int, depth: int):
        super().__init__()
        for i in range(depth):
            cin = (ch_in + 2) if i == 0 else ch
            setattr(self, f"tower{i}", Conv2d(cin, ch, 3, padding=1))
            setattr(self, f"gn{i}", GroupNorm(GN_GROUPS, ch, eps=GN_EPS))
        self.score = Conv2d(ch, 1, 3, padding=1)
        setattr(self, second, Conv2d(ch, second_ch, 3, padding=1))
        self.second = second
        self.grid = grid
        self.depth = depth

    def forward(self, feat):
        x = resize_nchw(_cat_coords(feat), (self.grid, self.grid))
        for i in range(self.depth):
            x = F.relu(getattr(self, f"gn{i}")(getattr(self, f"tower{i}")(x)))
        return self.score(x), getattr(self, self.second)(x)


class InstanceKernelHead(_GridHead):
    """The kernels mechanism's cell-grid head: per-cell objectness logits
    (N, 1, S, S) and dynamic mask kernels (N, E, S, S)."""

    def __init__(self, ch_in: int = 256, ch: int = 128, embed: int = 64,
                 grid: int = 16, depth: int = 3):
        super().__init__(ch_in, ch, "kernel", embed, grid, depth)


class RoiBoxHead(_GridHead):
    """The roi mechanism's proposal head: the same grid and tower as
    ``InstanceKernelHead``, with per-cell objectness logits (N, 1, S, S)
    and unconstrained (l, t, r, b) box-distance logits (N, 4, S, S), for
    ``ops.roi.decode_cell_boxes``. The grid is the proposal set."""

    def __init__(self, ch_in: int = 256, ch: int = 128, grid: int = 16,
                 depth: int = 3):
        super().__init__(ch_in, ch, "box", 4, grid, depth)


class RoiMaskHead(nn.Module):
    """Per-ROI mask FCN: the boxes crop the (N, H/4, W/4, E) mask features
    to R x R (``ops.roi.roi_align``, boxes detached: box geometry has its
    own loss), then a ``depth``-deep conv/GN/ReLU tower and a 1x1 ``out``
    give one mask logit map per ROI in the ROI frame."""

    def __init__(self, ch_in: int = 64, ch: int = 64, resolution: int = 28,
                 depth: int = 2):
        super().__init__()
        for i in range(depth):
            setattr(self, f"tower{i}",
                    Conv2d(ch_in if i == 0 else ch, ch, 3, padding=1))
            setattr(self, f"gn{i}", GroupNorm(GN_GROUPS, ch, eps=GN_EPS))
        self.out = Conv2d(ch, 1, 1)
        self.resolution = resolution
        self.depth = depth

    def forward(self, mask_feats: torch.Tensor,
                boxes: torch.Tensor) -> torch.Tensor:
        """mask_feats (N, H, W, E) NHWC; boxes (N, K, 4) normalized
        (y0, x0, y1, x1). Returns (N, K, R, R) mask logits."""
        n, k, _ = boxes.shape
        r = self.resolution
        crops = roi_align(mask_feats, boxes.detach(), r)  # (N, K, R, R, E)
        x = crops.reshape(n * k, r, r, -1).permute(0, 3, 1, 2)
        for i in range(self.depth):
            x = F.relu(getattr(self, f"gn{i}")(getattr(self, f"tower{i}")(x)))
        return self.out(x).reshape(n, k, r, r)
