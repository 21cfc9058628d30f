"""Exact-semantics bilinear resize (port of ``basi_tpu/ops/resize.py``).

Two dense 1-D interpolation matrices applied as einsums,

    out[n, i, j, c] = sum_{h, w} Wh[i, h] * x[n, h, w, c] * Ww[j, w],

with torch ``F.interpolate(mode='bilinear')`` coordinate conventions. bf16
integer-factor (2/4/8) upsamples of CUDA tensors go to the ``upsample_int``
kernel under the same conditions as the JAX package's Pallas route; every
other resize (f32, downsamples, odd channel counts) takes the einsum. Both
routes carry gradients (the kernel's through its ``autograd.Function``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from basi_tpu_torch.kernels.upsample_int import FACTORS, upsample_int


@functools.lru_cache(maxsize=256)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic linear-interpolation matrix."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    if align_corners:
        # out_size == 1: torch samples index 0, not the input centre.
        src = (np.zeros(1, dtype=np.float64) if out_size == 1 else
               np.arange(out_size, dtype=np.float64) * (in_size - 1)
               / (out_size - 1))
    else:
        scale = in_size / out_size
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float64)
    w = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    np.add.at(w, (rows, lo), 1.0 - frac)
    np.add.at(w, (rows, hi), frac)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=64)
def interp_tensor(in_size: int, out_size: int, align_corners: bool,
                  device: torch.device) -> torch.Tensor:
    """``_interp_matrix`` as an f32 tensor on ``device``, copied there once:
    a copy from pageable host memory would wait for the device's queue on
    every call. Made outside inference mode, so autograd may save it."""
    with torch.inference_mode(False):
        return torch.from_numpy(
            _interp_matrix(in_size, out_size, align_corners)).to(device)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear-resize NHWC (or HWC / HW) ``x`` to spatial size ``out_hw``."""
    if x.dim() == 2:
        y = resize_bilinear(x[None, :, :, None], out_hw, align_corners)
        return y[0, :, :, 0]
    if x.dim() == 3:
        return resize_bilinear(x[None], out_hw, align_corners)[0]
    if x.dim() != 4:
        raise ValueError(f"expected 2-4D input, got shape {tuple(x.shape)}")
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    f = kernel_upsample_factor(x, oh, ow, align_corners)
    if f and x.is_cuda:
        return upsample_int(x.contiguous(), f)
    return _resize_einsum(x, (oh, ow), align_corners)


def kernel_upsample_factor(x: torch.Tensor, oh: int, ow: int,
                           align_corners: bool) -> int:
    """The factor of a resize the ``upsample_int`` kernel takes, else 0:
    bf16 NHWC, half-pixel centres, the same factor 2/4/8 on both axes and
    C % 8 == 0 (the JAX package's ``_use_pallas_upsample`` rule)."""
    if align_corners or x.dtype != torch.bfloat16 or x.dim() != 4:
        return 0
    _, h, w, c = x.shape
    if h == 0 or w == 0 or oh % h or ow % w:
        return 0
    f = oh // h
    if f != ow // w or f not in FACTORS or c % 8:
        return 0
    return f


def _resize_einsum(x: torch.Tensor, out_hw: tuple[int, int],
                   align_corners: bool) -> torch.Tensor:
    """Separable-matmul resize in f32, rounded once to ``x.dtype``; returns
    an NHWC-contiguous tensor."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    wh = interp_tensor(h, oh, align_corners, x.device)
    ww = interp_tensor(w, ow, align_corners, x.device)
    y = torch.einsum("oh,nhwc->nowc", wh, x.float())
    y = torch.einsum("pw,nowc->nopc", ww, y)
    return y.to(x.dtype).contiguous()


def resize_nchw(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``resize_bilinear`` for an NCHW tensor: NHWC view in, NCHW view out.
    A channels_last input and the result are NHWC-contiguous in memory, so
    no copy is made on the way."""
    y = resize_bilinear(x.permute(0, 2, 3, 1), tuple(out_hw))
    return y.permute(0, 3, 1, 2)


def maxpool_hw(x: torch.Tensor, fh: int, fw: int) -> torch.Tensor:
    """Exact integer-factor max-pool over the trailing (H, W) dims, any
    leading dims and dtype: the single definition of GT-mask downsampling
    for the train step, the targets and the loss (as in the JAX package)."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // fh, fh, w // fw, fw).amax(dim=(-3, -1))
