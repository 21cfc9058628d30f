"""Integer-factor bilinear upsample of NHWC bf16 features (CUDA kernels).

Replaces ``basi_tpu/ops/pallas/upsample_int.py::upsample_int`` and its
custom VJP. ``upsample_int`` is a ``torch.autograd.Function``: its forward
is ``csrc/upsample_int.cu``, its backward (the exact adjoint, ``_bwd`` in
the JAX package) ``csrc/upsample_int_bwd.cu``. Each launches its kernel for
a CUDA tensor and runs its plain PyTorch version (``upsample_int_reference``,
``upsample_int_backward_reference``) for a CPU tensor; a CUDA tensor the
kernel cannot take raises, it never falls back.
"""

from __future__ import annotations

import torch

from basi_tpu_torch.kernels import _build

FACTORS = (2, 4, 8)
_GRID_MAX = 65535  # the kernel's grid puts output rows and images on y, z


def _check(x: torch.Tensor, f: int, what: str = "upsample_int") -> None:
    if x.dim() != 4:
        raise ValueError(f"{what}: expected NHWC, got shape {tuple(x.shape)}")
    if f not in FACTORS:
        raise ValueError(f"{what}: factor must be one of {FACTORS}, got {f}")
    if x.shape[-1] % 8:
        raise ValueError(f"{what}: C={x.shape[-1]} is not a multiple of 8")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: expected bfloat16, got {x.dtype}")


def _launch(entry: str, x: torch.Tensor, out_shape, n: int, h: int, w: int,
            f: int, what: str) -> torch.Tensor:
    """Run C entry point ``entry`` on NHWC bf16 ``x`` into a new tensor of
    ``out_shape``; (n, h, w) are the forward's input sizes."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: input must be NHWC-contiguous and 16-byte aligned")
    if n > _GRID_MAX or f * h > _GRID_MAX:
        raise ValueError(f"{what}: batch {n} or output height {f * h} "
                         f"above the kernel grid's {_GRID_MAX}")
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    err = getattr(_build.library(), entry)(x.data_ptr(), y.data_ptr(), n, h,
                                           w, x.shape[-1], f,
                                           _build.stream(x.device))
    _build.check(err, what)
    return y


def _forward(x: torch.Tensor, f: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return upsample_int_reference(x, f)
    n, h, w, c = x.shape
    y = _launch("basi_upsample_int_bf16", x, (n, f * h, f * w, c), n, h, w,
                f, "upsample_int")
    upsample_int.launches += 1
    return y


def upsample_int_backward(g: torch.Tensor, f: int) -> torch.Tensor:
    """The adjoint of ``upsample_int``: (N, f*h, f*w, C) bf16 cotangent ->
    (N, h, w, C) bf16 gradient. Launches ``csrc/upsample_int_bwd.cu`` for a
    CUDA ``g`` (made NHWC-contiguous first), the plain version for a CPU
    one."""
    _check(g, f, "upsample_int_backward")
    n, fh, fw, c = g.shape
    if fh % f or fw % f:
        raise ValueError(f"upsample_int_backward: {fh}x{fw} is not a multiple "
                         f"of the factor {f}")
    if g.device.type == "cpu":
        return upsample_int_backward_reference(g, f)
    h, w = fh // f, fw // f
    gx = _launch("basi_upsample_int_bwd_bf16", g.contiguous(), (n, h, w, c),
                 n, h, w, f, "upsample_int_backward")
    upsample_int_backward.launches += 1
    return gx


upsample_int_backward.launches = 0


class _UpsampleInt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, f):
        ctx.f = f
        return _forward(x, f)

    @staticmethod
    def backward(ctx, g):
        return upsample_int_backward(g, ctx.f), None


def upsample_int(x: torch.Tensor, f: int) -> torch.Tensor:
    """Bilinear-upsample NHWC bf16 ``x`` by ``f`` (2/4/8), half-pixel centres,
    with a gradient.

    Same function as ``resize_bilinear(x, (f*h, f*w))``: weights are equal,
    the blend is f32 and rounds to bf16 once. A CUDA ``x`` must be
    NHWC-contiguous (a channels_last NCHW tensor permuted to NHWC is).
    """
    _check(x, f)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"upsample_int: unsupported device {x.device}")
    return _UpsampleInt.apply(x, f)


upsample_int.launches = 0


def upsample_int_reference(x: torch.Tensor, f: int) -> torch.Tensor:
    """Plain PyTorch version: the separable interpolation-matrix einsum in
    f32, rounded once to ``x.dtype``."""
    from basi_tpu_torch.ops.resize import _resize_einsum

    _, h, w, _ = x.shape
    return _resize_einsum(x, (f * h, f * w), align_corners=False)


def upsample_int_backward_reference(g: torch.Tensor, f: int) -> torch.Tensor:
    """Plain PyTorch version of the adjoint, as the JAX package's ``_bwd``
    computes it: the transposed interpolation matrices in bf16 (exact),
    f32 accumulation, rows then columns, one cast to bf16."""
    from basi_tpu_torch.ops.resize import _interp_matrix

    _, fh, fw, _ = g.shape
    wh = torch.from_numpy(_interp_matrix(fh // f, fh, False)).to(g.device)
    ww = torch.from_numpy(_interp_matrix(fw // f, fw, False)).to(g.device)
    gx = torch.einsum("oh,nopc->nhpc", wh, g.float())
    gx = torch.einsum("pw,nhpc->nhwc", ww, gx)
    return gx.to(g.dtype)
