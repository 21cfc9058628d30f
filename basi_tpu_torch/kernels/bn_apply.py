"""The fused BatchNorm's elementwise passes (CUDA kernels): the forward's
apply and the backward's input gradient, one launch each.

They replace no Pallas kernel: on the TPU, XLA fuses these passes of
``basi_tpu/models/norm.py`` (``_bn_fwd_math``, ``_bn_bwd``) into the
neighbouring convolutions. The kernels are ``csrc/bn_apply.cu``; they move
the compulsory bytes alone, 4 bytes an element forward (read x, write y) and
6 backward (read g and x, write dx) in bf16, twice that in f32, against the
bound of 3.35 TB/s:

* ``bn_apply(x, a, b)``: y = x*a + b;
* ``bn_input_gradient(g, x, mean, a, a_mg, a_inv_mgxn)``:
  dx = a*g - a_mg - a_inv_mgxn*(x - mean); g is only read.

x (and g) is an NCHW activation in ``channels_last`` memory, which the
kernel reads as its NHWC view, a (rows = N*H*W, C) matrix; the per-channel
terms are the f32 (C,) rows of ``bn_forward_terms`` and
``bn_backward_terms`` (``kernels/bn_stats.py``). The output has x's dtype
and layout (``torch.empty_like(x)``). Each value is rounded as the plain
versions round it: every product, sum and difference in f32 in their order,
then once to x's dtype; so the kernels equal them bit for bit.

A CUDA tensor launches the kernel: it must be bf16 or f32 in
``channels_last`` memory (g and x of one shape and dtype; the terms f32,
contiguous, (C,), on x's device), and anything else raises; no hidden copy
is made. A CPU tensor runs the plain PyTorch version (``*_reference``,
which takes any layout and dtype); so does an empty one, which launches
nothing. Launches count on ``bn_apply.launches`` and
``bn_input_gradient.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from basi_tpu_torch.kernels import _build

_ENTRY = {
    ("apply", torch.bfloat16): "basi_bn_apply_bf16",
    ("apply", torch.float32): "basi_bn_apply_f32",
    ("grad", torch.bfloat16): "basi_bn_input_grad_bf16",
    ("grad", torch.float32): "basi_bn_input_grad_f32",
}
_THREADS = 256  # the kernels' largest block


def launch_layout(rows: int, c: int, vec: int,
                  blocks: int) -> tuple[int, int, int]:
    """(threads along C, row lanes, blocks over rows) of a launch: a row's
    C / ``vec`` units (16-byte vectors, or channels where ``vec`` is 1) cut
    into as few tiles of at most 256 as there must be, one thread a unit;
    the rest of the 256 threads on rows; the blocks over rows as many as
    the card holds at once (``blocks``, spread over the tiles), but no more
    than the rows fill."""
    q = c // vec
    tiles = -(-q // _THREADS)
    tx = -(-q // tiles)
    ty = max(1, _THREADS // tx)
    return tx, ty, max(1, min(blocks // tiles, -(-rows // ty)))


# (kind, dtype, rows, C, device, vec) -> (entry point, tx, ty, blocks)
_plans: dict = {}


def _plan(kind: str, x: torch.Tensor, rows: int, c: int, vec: bool):
    key = (kind, x.dtype, rows, c, x.device, vec)
    plan = _plans.get(key)
    if plan is None:
        lib = _build.library()
        width = 16 // x.element_size() if vec else 1
        tx, ty, _ = launch_layout(rows, c, width, 1)
        held = ctypes.c_int(0)
        _build.check(lib.basi_bn_apply_blocks_per_sm(
            kind == "grad", x.dtype == torch.float32, vec, tx * ty,
            ctypes.byref(held)), "bn_apply occupancy")
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        plan = (getattr(lib, _ENTRY[kind, x.dtype]),
                *launch_layout(rows, c, width, sms * max(1, held.value)))
        _plans[key] = plan
    return plan


def _check(what: str, ts, terms) -> None:
    """Raise unless the tensors ``ts`` (g and x, or x) are one 4-D shape,
    dtype and device, and on CUDA bf16 or f32 in ``channels_last`` memory
    with f32 contiguous (C,) ``terms`` on the same device."""
    x = ts[-1]
    if x.dim() != 4:
        raise ValueError(f"{what}: expected NCHW, got shape {tuple(x.shape)}")
    for t in ts[:-1]:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                f"{what}: g {tuple(t.shape)} {t.dtype} on {t.device} does "
                f"not match x {tuple(x.shape)} {x.dtype} on {x.device}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(
            f"{what}: expected bfloat16 or float32, got {x.dtype}")
    if not all(t.is_contiguous(memory_format=torch.channels_last)
               for t in ts):
        raise ValueError(f"{what}: input must be channels_last (its NHWC "
                         "view contiguous)")
    c = x.shape[1]
    for p in terms:
        if (p.dtype != torch.float32 or p.shape != (c,)
                or p.device != x.device or not p.is_contiguous()):
            raise ValueError(f"{what}: per-channel terms must be contiguous "
                             f"float32 ({c},) on {x.device}, got {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")


def _launch(counted, kind: str, what: str, ts, terms) -> torch.Tensor:
    x = ts[-1]
    out = torch.empty_like(x)
    n, c, h, w = x.shape
    rows = n * h * w
    ptrs = [t.data_ptr() for t in ts] + [out.data_ptr()]
    vec = c % (16 // x.element_size()) == 0 and all(p % 16 == 0 for p in ptrs)
    fn, tx, ty, blocks = _plan(kind, x, rows, c, vec)
    err = fn(*ptrs[:-1], *(p.data_ptr() for p in terms), ptrs[-1], rows, c,
             tx, ty, blocks, vec, _build.stream(x.device))
    _build.check(err, what)
    counted.launches += 1
    return out


def bn_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """y = x*a + b of NCHW ``x`` (a and b per channel, f32), in f32 and
    rounded once to x's dtype; y in x's layout."""
    _check("bn_apply", (x,), (a, b))
    if x.device.type == "cpu" or x.numel() == 0:
        return bn_apply_reference(x, a, b)
    return _launch(bn_apply, "apply", "bn_apply", (x,), (a, b))


bn_apply.launches = 0


def bn_input_gradient(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                      a: torch.Tensor, a_mg: torch.Tensor,
                      a_inv_mgxn: torch.Tensor) -> torch.Tensor:
    """dx = a*g - a_mg - a_inv_mgxn*(x - mean) of NCHW ``g`` and ``x`` (the
    four terms per channel, f32), in f32 and rounded once to x's dtype; dx
    in x's layout. ``g`` is not written."""
    terms = (mean, a, a_mg, a_inv_mgxn)
    _check("bn_input_gradient", (g, x), terms)
    if x.device.type == "cpu" or x.numel() == 0:
        return bn_input_gradient_reference(g, x, *terms)
    # the kernel's argument order: g, x, mean, a, a_mg, a_inv_mgxn, dx
    return _launch(bn_input_gradient, "grad", "bn_input_gradient", (g, x),
                   terms)


bn_input_gradient.launches = 0


# --- the plain versions ------------------------------------------------------


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def bn_apply_reference(x, a, b):
    """Plain PyTorch version: y = x*a + b in f32 (f64 for f64 terms), cast
    to x's dtype once."""
    return (x * _per_channel(a)).add_(_per_channel(b)).to(x.dtype)


def bn_input_gradient_reference(g, x, mean, a, a_mg, a_inv_mgxn):
    """Plain PyTorch version: dx = a*g - a_mg - a_inv_mgxn*(x - mean) in
    f32 (f64 for f64 terms), cast to x's dtype once."""
    dx = g * _per_channel(a)
    dx.sub_(_per_channel(a_mg))
    xc = (x - _per_channel(mean)).mul_(_per_channel(a_inv_mgxn))
    return dx.sub_(xc).to(x.dtype)
