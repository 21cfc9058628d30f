"""Per-channel f32 sums for the fused BatchNorm, and its per-channel terms
(CUDA kernels).

Replaces ``basi_tpu/ops/pallas/bn_stats.py::channel_moments`` and
``::channel_dual_sums``; the kernels are ``csrc/bn_stats.cu``, one launch a
call. Each function takes NHWC tensors (the NHWC view of a ``channels_last``
activation, which is contiguous) and reduces over (N, H, W):

* ``channel_moments(x)``: (sum x, sum x^2); ``channel_dual_sums(g, x)``:
  (sum g, sum g*x). The sums alone, as the JAX kernels return them (a
  data-parallel BatchNorm averages them across replicas before the math).
* The same kernels with the BatchNorm's per-channel math in their last
  block: ``channel_means(x)`` (E[x], E[x^2]: mode "stats"),
  ``bn_forward_terms`` (mean, var, inv, a, b of
  ``basi_tpu/models/norm.py::_bn_fwd_math``) and ``bn_backward_terms``
  (dscale, dbias and the dx coefficients of ``_bn_bwd``). Their launches
  count on ``channel_moments.launches`` and ``channel_dual_sums.launches``.

A CUDA tensor launches the kernel: it must be NHWC-contiguous bf16 or f32
(``g`` and ``x`` of one shape and dtype; the per-channel parameters f32 and
contiguous), and anything else raises; no hidden copy is made. A CPU
tensor runs the plain PyTorch version (``*_reference``), which takes any
layout and accumulates in f32 (f64 for f64 input); so does an empty input,
which launches nothing.
"""

from __future__ import annotations

import ctypes

import torch

from basi_tpu_torch.kernels import _build

_ENTRY = {
    ("moments", torch.bfloat16): "basi_channel_moments_bf16",
    ("moments", torch.float32): "basi_channel_moments_f32",
    ("dual", torch.bfloat16): "basi_channel_dual_sums_bf16",
    ("dual", torch.float32): "basi_channel_dual_sums_f32",
}
# the kernel's epilogues (csrc/bn_stats.cu) and the f32 rows of C each writes
_SUMS, _MEANS, _BN_FORWARD, _BN_BACKWARD = 0, 1, 2, 3
_OUT_ROWS = {_SUMS: 2, _MEANS: 2, _BN_FORWARD: 5, _BN_BACKWARD: 5}
_THREADS = 256  # the kernel's block
_GROUPS_MAX = 8  # 16-byte channel groups in one block: 128 bytes of a row
_MIN_ROWS_PER_THREAD = 8  # one trip of the kernel's load pipeline
# slabs whose partials one block sums: all of a tile's up to _ONE_LEVEL,
# else groups of _GROUP (the kernel's kOneLevel and kGroup)
_ONE_LEVEL, _GROUP = 64, 32


def launch_layout(rows: int, c: int, itemsize: int,
                  blocks: int) -> tuple[int, int, int]:
    """(channel groups per block, slabs, rows per slab) of the kernel: as
    many 16-byte channel groups per block as C has (a power of two, at most
    8), the other threads on rows, and the rows cut into contiguous slabs,
    at most ``blocks`` blocks in all (the card's SMs times the blocks each
    holds at once: no block waits for another to finish) while each thread
    still reads at least ``_MIN_ROWS_PER_THREAD`` rows."""
    groups = -(-c // (16 // itemsize))
    g = 1
    while 2 * g <= min(groups, _GROUPS_MAX):
        g *= 2
    tiles = -(-groups // g)
    parts = max(1, min(blocks // tiles,
                       -(-rows // (_THREADS // g * _MIN_ROWS_PER_THREAD))))
    slab = -(-rows // parts)
    return g, -(-rows // slab), slab


# (kernel, dtype, rows, C, device) -> the launch plan, one for every
# epilogue: an epilogue's sums are the plain sums' bit for bit
_plans: dict = {}
# (device, stream) -> (f32 workspace, u32 counters); a stream's launches run
# in order, so they share them; the counters are 0 between launches
_work: dict = {}


def _plan(kind: str, x: torch.Tensor, rows: int, c: int):
    """(entry point, g, slabs, rows per slab, workspace floats, counters)
    of a launch on a grid of as many blocks as the card holds at once."""
    key = (kind, x.dtype, rows, c, x.device)
    plan = _plans.get(key)
    if plan is None:
        lib = _build.library()
        held = ctypes.c_int(0)
        _build.check(lib.basi_bn_stats_blocks_per_sm(
            kind == "dual", x.dtype == torch.float32,
            ctypes.byref(held)), "bn_stats occupancy")
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        vec = 16 // x.element_size()
        g, parts, slab = launch_layout(rows, c, x.element_size(),
                                       sms * max(1, held.value))
        tiles = -(-c // (vec * g))
        # partial rows of 2 * g * vec floats: one a slab, one a group of
        # slabs; a counter a group and one a tile
        groups = 1 if parts <= _ONE_LEVEL else -(-parts // _GROUP)
        plan = (getattr(lib, _ENTRY[kind, x.dtype]), g, parts, slab,
                (parts + groups) * tiles * 2 * g * vec, tiles * (groups + 1))
        _plans[key] = plan
    return plan


def _workspace(device: torch.device, stream: int, size: int, count: int):
    ws, counters = _work.get((device, stream), (None, None))
    if ws is None or ws.numel() < size:
        ws = torch.empty(size, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < count:
        counters = torch.zeros(count, dtype=torch.int32, device=device)
    _work[device, stream] = ws, counters
    return ws, counters


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


def _plain(x: torch.Tensor) -> bool:
    """True where the plain version runs: a CPU tensor, or nothing to sum."""
    return x.device.type == "cpu" or x.numel() == 0


def _launch(counted, kind: str, epilogue: int, what: str, ts, scale=None,
            bias=None, mean=None, inv=None, eps: float = 0.0) -> torch.Tensor:
    """One launch of the kernel; returns its (rows, C) f32 output."""
    x = ts[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: expected bfloat16 or float32, got {x.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: input must be NHWC-contiguous (the NHWC "
                         "view of a channels_last tensor)")
    n, h, w, c = x.shape
    rows = n * h * w
    if rows * c >= 2 ** 31:
        raise ValueError(f"{what}: {rows} x {c} elements above the kernel's "
                         "int32 sizes")
    params = [scale, bias, mean, inv]
    for p in params:
        if p is not None and (p.dtype != torch.float32 or p.shape != (c,)
                              or p.device != x.device
                              or not p.is_contiguous()):
            raise ValueError(f"{what}: per-channel parameters must be "
                             f"contiguous float32 ({c},) on {x.device}, got "
                             f"{p.dtype} {tuple(p.shape)} on {p.device}")
    fn, g, parts, slab, size, count = _plan(kind, x, rows, c)
    stream = _build.stream(x.device)
    ws, counters = _workspace(x.device, stream, size, count)
    out = torch.empty((_OUT_ROWS[epilogue], c), dtype=torch.float32,
                      device=x.device)
    a, b = (ts[0], ts[1]) if len(ts) == 2 else (x, None)
    err = fn(a.data_ptr(), b.data_ptr() if b is not None else None,
             ws.data_ptr(), counters.data_ptr(), out.data_ptr(),
             *(p.data_ptr() if p is not None else None for p in params),
             rows, c, g, parts, slab, epilogue, eps, stream)
    if err:
        # a refused launch may leave a counter behind: start afresh
        _work.pop((x.device, stream), None)
        _build.check(err, what)
    counted.launches += 1
    return out


def channel_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (sum x, sum x^2) over (N, H, W) of NHWC ``x``, two f32
    (C,) tensors."""
    _check("channel_moments", x)
    if _plain(x):
        return channel_moments_reference(x)
    return _launch(channel_moments, "moments", _SUMS, "channel_moments",
                   (x,)).unbind()


channel_moments.launches = 0


def channel_means(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (E[x], E[x^2]) over (N, H, W) of NHWC ``x``, f32: the
    ``channel_moments`` kernel with the division by M in its last block."""
    _check("channel_means", x)
    if _plain(x):
        return channel_means_reference(x)
    return _launch(channel_moments, "moments", _MEANS, "channel_means",
                   (x,)).unbind()


def bn_forward_terms(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> tuple[torch.Tensor, ...]:
    """The train-mode BN forward's per-channel f32 terms of NHWC ``x``:
    (mean, biased var, inv = rsqrt(var + eps), a = scale*inv, b = bias -
    mean*a), so that y = x*a + b. The ``channel_moments`` kernel with
    ``bn_forward_math`` in its last block."""
    _check("bn_forward_terms", x)
    if _plain(x):
        return bn_forward_terms_reference(x, scale, bias, eps)
    return _launch(channel_moments, "moments", _BN_FORWARD, "bn_forward_terms",
                   (x,), scale=scale, bias=bias, eps=eps).unbind()


def channel_dual_sums(g: torch.Tensor, x: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (sum g, sum g*x) over (N, H, W) of NHWC ``g`` and ``x``
    (one shape and dtype), two f32 (C,) tensors: the BN backward's two
    reductions in one pass."""
    _check("channel_dual_sums", g, x)
    if _plain(x):
        return channel_dual_sums_reference(g, x)
    return _launch(channel_dual_sums, "dual", _SUMS, "channel_dual_sums",
                   (g, x)).unbind()


channel_dual_sums.launches = 0


def bn_backward_terms(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                      mean: torch.Tensor, inv: torch.Tensor
                      ) -> tuple[torch.Tensor, ...]:
    """The train-mode BN backward's per-channel f32 terms from the gradient
    ``g`` of y and the input ``x`` (NHWC, one shape and dtype) and the
    forward's mean and inv: (dscale, dbias, a, a*m_g, a*inv*m_gxn), so that
    dx = a*g - a*m_g - (a*inv*m_gxn)*(x - mean). The ``channel_dual_sums``
    kernel with ``bn_backward_math`` in its last block."""
    _check("bn_backward_terms", g, x)
    if _plain(x):
        return bn_backward_terms_reference(g, x, scale, mean, inv)
    return _launch(channel_dual_sums, "dual", _BN_BACKWARD,
                   "bn_backward_terms", (g, x), scale=scale, mean=mean,
                   inv=inv).unbind()


# --- the plain versions ------------------------------------------------------


def _acc(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _count(x: torch.Tensor) -> int:
    return x.shape[0] * x.shape[1] * x.shape[2]


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


def channel_means_reference(x: torch.Tensor):
    """Plain PyTorch version of ``channel_means``."""
    sx, sx2 = channel_moments_reference(x)
    m = _count(x)
    return sx / m, sx2 / m


def bn_forward_math(mean, mean2, scale, bias, eps: float):
    """(mean, var, inv, a, b) from the means of x and x^2, in the order of
    ``_bn_fwd_math``: the one-pass variance clamped at 0. Plain tensor
    operations, so autograd differentiates it (mode "stats")."""
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    a = scale.to(inv.dtype) * inv
    b = bias.to(inv.dtype) - mean * a
    return mean, var, inv, a, b


def bn_forward_terms_reference(x, scale, bias, eps: float):
    """Plain PyTorch version of ``bn_forward_terms``."""
    return bn_forward_math(*channel_means_reference(x), scale, bias, eps)


def bn_backward_math(sg, sgx, m: int, scale, mean, inv):
    """(dscale, dbias, a, a*m_g, a*inv*m_gxn) from the sums of g and g*x
    over M = ``m`` rows, in the order of ``_bn_bwd``."""
    sgxn = (sgx - mean * sg) * inv  # sum of g * xn
    m_g, m_gxn = sg / m, sgxn / m
    a = scale.to(inv.dtype) * inv
    return sgxn, sg, a, a * m_g, a * inv * m_gxn


def bn_backward_terms_reference(g, x, scale, mean, inv):
    """Plain PyTorch version of ``bn_backward_terms``."""
    return bn_backward_math(*channel_dual_sums_reference(g, x), _count(x),
                            scale, mean, inv)
