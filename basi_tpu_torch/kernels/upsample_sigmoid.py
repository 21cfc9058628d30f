"""Fused bilinear upsample + sigmoid of mask logits (CUDA kernel).

Replaces ``basi_tpu/ops/pallas/upsample_sigmoid.py::upsample_sigmoid``; the
kernel is ``csrc/upsample_sigmoid.cu``. ``upsample_sigmoid`` launches the
kernel for a CUDA tensor and runs ``upsample_sigmoid_reference`` (plain
PyTorch) for a CPU tensor; a CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

import torch

from basi_tpu_torch.kernels import _build
from basi_tpu_torch.ops.resize import interp_tensor

_ENTRY = {torch.float32: "basi_upsample_sigmoid_f32",
          torch.bfloat16: "basi_upsample_sigmoid_bf16"}


def upsample_sigmoid(logits: torch.Tensor,
                     out_hw: tuple[int, int]) -> torch.Tensor:
    """``sigmoid(bilinear_resize(logits, out_hw))`` in f32, half-pixel
    centres. ``logits``: (..., h, w), any leading dims; returns
    (..., *out_hw) float32 probabilities."""
    if logits.dim() < 2:
        raise ValueError(f"upsample_sigmoid: expected (..., h, w), got {tuple(logits.shape)}")
    lead, (h, w) = logits.shape[:-2], logits.shape[-2:]
    oh, ow = out_hw
    if (h, w) == (oh, ow):  # identity resize: only the sigmoid remains
        return torch.sigmoid(logits.float())
    if logits.device.type == "cpu":
        return upsample_sigmoid_reference(logits, out_hw)
    if logits.device.type != "cuda":
        raise ValueError(f"upsample_sigmoid: unsupported device {logits.device}")
    if logits.dtype not in _ENTRY:
        raise ValueError(f"upsample_sigmoid: expected float32 or bfloat16, got {logits.dtype}")
    if min(h, w, oh, ow) <= 0:
        raise ValueError(f"upsample_sigmoid: empty spatial size {(h, w)} -> {(oh, ow)}")
    x = logits.reshape(-1, h, w).contiguous()
    b = x.shape[0]
    y = torch.empty((b, oh, ow), dtype=torch.float32, device=x.device)
    if b:
        err = getattr(_build.library(), _ENTRY[x.dtype])(
            x.data_ptr(), y.data_ptr(), b, h, w, oh, ow,
            _build.stream(x.device))
        _build.check(err, "upsample_sigmoid")
        upsample_sigmoid.launches += 1
    return y.reshape(*lead, oh, ow)


upsample_sigmoid.launches = 0


def upsample_sigmoid_reference(logits: torch.Tensor,
                               out_hw: tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version: f32 interpolation-matrix products, then the
    sigmoid (the same numerics as the JAX kernel at HIGHEST precision)."""
    lead, (h, w) = logits.shape[:-2], logits.shape[-2:]
    oh, ow = out_hw
    dev = logits.device
    wh = interp_tensor(h, oh, False, dev)
    ww = interp_tensor(w, ow, False, dev)
    x = logits.reshape(-1, h, w).float()
    y = torch.einsum("oh,bhw->bow", wh, x)
    y = torch.einsum("pw,bow->bop", ww, y)
    return torch.sigmoid(y).reshape(*lead, oh, ow)
