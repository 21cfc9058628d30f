"""Bilinear resize of uint8 images, byte for byte as Pillow's
``Image.resize(size, Image.BILINEAR)`` computes it, in numpy.

The JAX package letterboxes non-square scenes with PIL; the port has no
PIL (the card's machine lacks it), so it carries Pillow's fixed-point
two-pass resample (``libImaging/Resample.c``) here:

* per output index, a triangle filter of support ``max(in/out, 1)``
  centred at ``(x + 0.5) * in/out``; the taps' weights are normalised by
  their sum in double, then rounded half away from zero to 22 fractional
  bits;
* each pass seeds its integer accumulator with ``1 << 21``, adds
  ``pixel * weight`` and shifts right by 22, clipped to [0, 255];
* the horizontal pass runs first and is clipped to uint8 before the
  vertical one; a pass whose size does not change is skipped.

Each pass gathers its ``2 * ceil(support) + 1`` taps for every output
index at once, so a 768 x 768 x 3 scene costs a few vectorised numpy
operations per tap.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(first tap (out,) int64, fixed-point weights (out, ksize) int32) of
    Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the
    bilinear filter; taps past an output's window have weight 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize)
    arg = ((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) \
        * (1.0 / filterscale)
    w = np.maximum(1.0 - np.abs(arg), 0.0)
    w[taps[None, :] >= xmax[:, None]] = 0.0
    ww = np.zeros(out_size)
    for t in range(ksize):  # Pillow's order of additions
        ww = ww + w[:, t]
    # ww > 0: the input pixel under each centre has a positive weight. The
    # weights are non-negative, so Pillow's rounding half away from zero
    # is +0.5, then truncation.
    w = w / ww[:, None]
    return xmin, np.trunc(0.5 + w * (1 << PRECISION_BITS)).astype(np.int32)


def _clip8(acc: np.ndarray) -> np.ndarray:
    out = np.right_shift(np.maximum(acc, 0), PRECISION_BITS)
    return np.minimum(out, 255).astype(np.uint8)


def _resample_axis(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along ``axis`` of a uint8
    array."""
    in_size = img.shape[axis]
    xmin, k = _coeffs(in_size, out_size)
    shape = [1] * img.ndim
    shape[axis] = out_size
    # int32 as Pillow's: 255 times weights summing to about 2^22, plus
    # 2^21, stays below 2^31
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int32)
    for t in range(k.shape[1]):
        idx = np.minimum(xmin + t, in_size - 1)
        acc += np.take(img, idx, axis=axis).astype(np.int32) \
            * k[:, t].reshape(shape)
    return _clip8(acc)


def resize_bilinear_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``(H, W[, C])`` uint8 -> ``(out_h, out_w[, C])`` uint8, equal byte
    for byte to ``PIL.Image.fromarray(img).resize((out_w, out_h),
    Image.BILINEAR)``."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"want (H, W) or (H, W, C) uint8, got "
                         f"{img.dtype} {img.shape}")
    if out_h < 1 or out_w < 1:
        raise ValueError(f"output size {out_h}x{out_w} must be positive")
    out = img
    if out_w != img.shape[1]:
        out = _resample_axis(out, 1, out_w)
    if out_h != img.shape[0]:
        out = _resample_axis(out, 0, out_h)
    return out.copy() if out is img else out
