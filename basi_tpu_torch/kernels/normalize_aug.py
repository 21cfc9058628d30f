"""Fused uint8 -> normalized image ingest with per-image hflip (CUDA kernel).

Replaces ``basi_tpu/ops/pallas/normalize_aug.py::normalize_and_flip``; the
kernel is ``csrc/normalize_aug.cu``. ``normalize_and_flip`` launches the
kernel for a CUDA tensor and runs ``normalize_and_flip_reference`` (plain
PyTorch) for a CPU tensor; a CUDA tensor the kernel cannot take raises, it
never falls back. Only the raw (N, H, W, 3) layout: the port has no s2d
stem, so the JAX package's (N, H/2, W/2, 12) packed feed raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from basi_tpu_torch.kernels import _build

_ENTRY = {torch.bfloat16: "basi_normalize_flip_bf16",
          torch.float32: "basi_normalize_flip_f32"}


def _affine(mean, std) -> tuple[np.ndarray, np.ndarray]:
    """(1/std, -mean/std) in f32, as the JAX kernel's pre-tiled rows."""
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    return np.float32(1.0) / s, -m / s


@functools.lru_cache(maxsize=16)
def _affine_args(mean: tuple, std: tuple):
    """``_affine`` as the kernel's two arguments, 3 host floats each; made
    once per (mean, std)."""
    return tuple((ctypes.c_float * 3)(*a.tolist()) for a in _affine(mean, std))


def _check(images_u8: torch.Tensor, flip: torch.Tensor, out_dtype) -> None:
    if images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError("normalize_and_flip: expected raw (N, H, W, 3), got "
                         f"{tuple(images_u8.shape)} (s2d-packed input is not "
                         "ported)")
    if images_u8.dtype != torch.uint8:
        raise ValueError(f"normalize_and_flip: expected uint8, got {images_u8.dtype}")
    if flip.shape != images_u8.shape[:1]:
        raise ValueError(f"normalize_and_flip: flip {tuple(flip.shape)} does "
                         f"not match batch {images_u8.shape[0]}")
    if out_dtype not in _ENTRY and not (out_dtype == torch.float64
                                        and images_u8.device.type == "cpu"):
        raise ValueError(f"normalize_and_flip: out_dtype {out_dtype} is not "
                         "bfloat16 or float32 (float64: CPU only)")


def normalize_and_flip(images_u8: torch.Tensor, flip: torch.Tensor,
                       mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                       out_dtype=torch.float32) -> torch.Tensor:
    """Flip image i horizontally where ``flip[i] > 0``, then
    ``x * (1/255) * (1/std) + (-mean/std)`` per channel in f32, rounded once
    to ``out_dtype``. images_u8: (N, H, W, 3) uint8; flip: (N,) integer or
    bool on the same device. Returns (N, H, W, 3) ``out_dtype``."""
    _check(images_u8, flip, out_dtype)
    if images_u8.device.type == "cpu":
        return normalize_and_flip_reference(images_u8, flip, mean, std,
                                            out_dtype)
    if images_u8.device.type != "cuda":
        raise ValueError(f"normalize_and_flip: unsupported device {images_u8.device}")
    if flip.device != images_u8.device:
        raise ValueError("normalize_and_flip: flip must be on the images' device")
    if not images_u8.is_contiguous():
        raise ValueError("normalize_and_flip: images must be contiguous NHWC")
    n, h, w, _ = images_u8.shape
    y = torch.empty(images_u8.shape, dtype=out_dtype, device=images_u8.device)
    if y.numel() == 0:
        return y
    flags = flip.to(torch.int32).contiguous()
    err = getattr(_build.library(), _ENTRY[out_dtype])(
        images_u8.data_ptr(), flags.data_ptr(), y.data_ptr(), n, h, w,
        *_affine_args(tuple(mean), tuple(std)), _build.stream(images_u8.device))
    _build.check(err, "normalize_and_flip")
    normalize_and_flip.launches += 1
    return y


normalize_and_flip.launches = 0


def normalize_and_flip_reference(images_u8: torch.Tensor, flip: torch.Tensor,
                                 mean=(0.485, 0.456, 0.406),
                                 std=(0.229, 0.224, 0.225),
                                 out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version: ``where`` + flip of the bytes, then the Pallas
    body's f32 arithmetic (``* (1/255)``, ``* (1/std)``, ``+ (-mean/std)``,
    each rounded in f32), then the cast."""
    inv_std, neg_mean = (torch.from_numpy(a).to(images_u8.device)
                         for a in _affine(mean, std))
    sel = (flip > 0).reshape(-1, 1, 1, 1)
    imgs = torch.where(sel, torch.flip(images_u8, dims=(2,)), images_u8)
    x = imgs.float() * np.float32(1.0 / 255.0)
    x = x * inv_std
    x = x + neg_mean
    return x.to(out_dtype)
