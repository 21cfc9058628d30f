"""Integer-factor bilinear upsample of NHWC bf16 features (CUDA kernel).

Replaces ``basi_tpu/ops/pallas/upsample_int.py::upsample_int``; the kernel
is ``csrc/upsample_int.cu``. ``upsample_int`` launches the kernel for a CUDA
tensor and runs ``upsample_int_reference`` (plain PyTorch) for a CPU tensor;
a CUDA tensor the kernel cannot take raises, it never falls back.
"""

from __future__ import annotations

import torch

from basi_tpu_torch.kernels import _build

FACTORS = (2, 4, 8)
_GRID_MAX = 65535  # the kernel's grid puts output rows and images on y, z


def _check(x: torch.Tensor, f: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"upsample_int: expected NHWC, got shape {tuple(x.shape)}")
    if f not in FACTORS:
        raise ValueError(f"upsample_int: factor must be one of {FACTORS}, got {f}")
    if x.shape[-1] % 8:
        raise ValueError(f"upsample_int: C={x.shape[-1]} is not a multiple of 8")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"upsample_int: expected bfloat16, got {x.dtype}")


def upsample_int(x: torch.Tensor, f: int) -> torch.Tensor:
    """Bilinear-upsample NHWC bf16 ``x`` by ``f`` (2/4/8), half-pixel centres.

    Same function as ``resize_bilinear(x, (f*h, f*w))``: weights are equal,
    the blend is f32 and rounds to bf16 once. A CUDA ``x`` must be
    NHWC-contiguous (a channels_last NCHW tensor permuted to NHWC is).
    """
    _check(x, f)
    if x.device.type == "cpu":
        return upsample_int_reference(x, f)
    if x.device.type != "cuda":
        raise ValueError(f"upsample_int: unsupported device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("upsample_int: x must be NHWC-contiguous and 16-byte aligned")
    n, h, w, c = x.shape
    if n > _GRID_MAX or f * h > _GRID_MAX:
        raise ValueError(f"upsample_int: batch {n} or output height {f * h} "
                         f"above the kernel grid's {_GRID_MAX}")
    y = torch.empty((n, f * h, f * w, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.basi_upsample_int_bf16(x.data_ptr(), y.data_ptr(),
                                         n, h, w, c, f, stream)
    _build.check(err, "upsample_int")
    upsample_int.launches += 1
    return y


upsample_int.launches = 0


def upsample_int_reference(x: torch.Tensor, f: int) -> torch.Tensor:
    """Plain PyTorch version: the separable interpolation-matrix einsum in
    f32, rounded once to ``x.dtype``."""
    from basi_tpu_torch.ops.resize import _resize_einsum

    _, h, w, _ = x.shape
    return _resize_einsum(x, (f * h, f * w), align_corners=False)
