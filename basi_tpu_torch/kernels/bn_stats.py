"""Per-channel f32 sums for the fused BatchNorm (CUDA kernels).

Replaces ``basi_tpu/ops/pallas/bn_stats.py::channel_moments`` and
``::channel_dual_sums``; the kernels are ``csrc/bn_stats.cu``. Each function
takes NHWC tensors (the NHWC view of a ``channels_last`` activation, which
is contiguous) and reduces over (N, H, W). A CUDA tensor launches the
kernel: it must be NHWC-contiguous bf16 or f32 (``channel_dual_sums``: g and
x of one shape and dtype), and anything else raises; no hidden copy is
made. A CPU tensor runs the plain PyTorch version (``*_reference``),
which takes any layout and accumulates in f32 (f64 for f64 input).
"""

from __future__ import annotations

import functools

import torch

from basi_tpu_torch.kernels import _build

_ENTRY = {
    ("moments", torch.bfloat16): "basi_channel_moments_bf16",
    ("moments", torch.float32): "basi_channel_moments_f32",
    ("dual", torch.bfloat16): "basi_channel_dual_sums_bf16",
    ("dual", torch.float32): "basi_channel_dual_sums_f32",
}
_THREADS = 256  # the partial kernel's block
_GROUPS_MAX = 32  # channel groups of 8 in one block
_BLOCKS_PER_SM = 4  # partial blocks in flight per SM that the split aims at
_MIN_ROWS_PER_THREAD = 8


def launch_layout(rows: int, c: int, sms: int) -> tuple[int, int]:
    """(channel groups of 8 per block, row splits) of the partial kernel:
    as many channel groups per block as C has (a power of two, at most 32),
    the other threads on rows, and enough row splits for about
    ``_BLOCKS_PER_SM`` blocks per SM while each thread still reads at least
    ``_MIN_ROWS_PER_THREAD`` rows."""
    groups = -(-c // 8)
    g = 1
    while 2 * g <= min(groups, _GROUPS_MAX):
        g *= 2
    row_lanes = _THREADS // g
    tiles = -(-groups // g)
    parts = min(-(-rows // (row_lanes * _MIN_ROWS_PER_THREAD)),
                -(-_BLOCKS_PER_SM * sms // tiles))
    return g, max(1, parts)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(what: str, *ts: torch.Tensor) -> None:
    x = ts[-1]
    if x.dim() != 4:
        raise ValueError(f"{what}: expected NHWC, got shape {tuple(x.shape)}")
    for t in ts[:-1]:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                f"{what}: g {tuple(t.shape)} {t.dtype} on {t.device} does "
                f"not match x {tuple(x.shape)} {x.dtype} on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def _launch(kind: str, what: str, *ts: torch.Tensor):
    x = ts[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: expected bfloat16 or float32, got {x.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: input must be NHWC-contiguous (the NHWC "
                         "view of a channels_last tensor)")
    n, h, w, c = x.shape
    rows = n * h * w
    if rows * c == 0:  # nothing to sum: no launch
        out = torch.zeros((2, c), dtype=torch.float32, device=x.device)
        return out[0], out[1]
    if rows * c >= 2 ** 31:
        raise ValueError(f"{what}: {rows} x {c} elements above the kernel's "
                         "int32 sizes")
    g, parts = launch_layout(rows, c, _sm_count(x.device.index or 0))
    ws = torch.empty((2, parts, c), dtype=torch.float32, device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[kind, x.dtype])(
            *(t.data_ptr() for t in ts), ws.data_ptr(), out.data_ptr(),
            rows, c, g, parts, stream)
    _build.check(err, what)
    return out[0], out[1]


def channel_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (sum x, sum x^2) over (N, H, W) of NHWC ``x``, two f32
    (C,) tensors."""
    _check("channel_moments", x)
    if x.device.type == "cpu":
        return channel_moments_reference(x)
    out = _launch("moments", "channel_moments", x)
    if x.numel():
        channel_moments.launches += 1
    return out


channel_moments.launches = 0


def channel_dual_sums(g: torch.Tensor, x: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (sum g, sum g*x) over (N, H, W) of NHWC ``g`` and ``x``
    (one shape and dtype), two f32 (C,) tensors: the BN backward's two
    reductions in one pass."""
    _check("channel_dual_sums", g, x)
    if x.device.type == "cpu":
        return channel_dual_sums_reference(g, x)
    out = _launch("dual", "channel_dual_sums", g, x)
    if x.numel():
        channel_dual_sums.launches += 1
    return out


channel_dual_sums.launches = 0


def _acc(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def channel_moments_reference(x: torch.Tensor):
    """Plain PyTorch version: (sum, sum of squares) over (N, H, W) in f32
    (f64 for f64 input)."""
    xf = _acc(x)
    return xf.sum(dim=(0, 1, 2)), (xf * xf).sum(dim=(0, 1, 2))


def channel_dual_sums_reference(g: torch.Tensor, x: torch.Tensor):
    """Plain PyTorch version: (sum g, sum g*x) over (N, H, W) in f32 (f64
    for f64 input)."""
    gf = _acc(g)
    return gf.sum(dim=(0, 1, 2)), (gf * _acc(x)).sum(dim=(0, 1, 2))
