"""The ConvNeXt block's depthwise 7x7 convolution (CUDA kernels): stride 1,
padding 3, one filter a channel, with bias; forward and both gradients.

It replaces no Pallas kernel (the JAX package has no ConvNeXt): it takes the
place of the library's depthwise kernels behind ``F.conv2d(groups=C)`` in
``models/convnext.py``. The kernels are ``csrc/dwconv.cu``: all 49
multiply-adds of an output in f32 on the CUDA cores, from bf16 (or f32)
inputs and taps widened once, the output rounded once. ``dwconv7x7`` is the
``torch.autograd.Function`` the model calls; its three parts are also
public:

* ``dwconv_forward(x, w, b)``: y = conv(x, w) + b;
* ``dwconv_input_grad(g, w)``: dx, the forward with the taps turned 180
  degrees and no bias;
* ``dwconv_weight_grad(g, x)``: (dw, db), each block's f32 sums written to
  a workspace and summed in a fixed order by a second kernel, rounded once
  to x's dtype (no atomics: two calls agree bit for bit).

Each launch is a grid of blocks that the card holds at once (``plan``),
each walking a list of 16 x 16 output tiles of its channels.

x and g are NCHW in ``channels_last`` memory, which the kernels read as
their NHWC view; w is (C, 1, 7, 7) and b (C,), contiguous, in x's dtype.
A CUDA tensor launches the kernels: bf16 or f32, C a multiple of 8, and
anything else raises; no hidden copy is made. A CPU tensor runs the plain
version (``*_reference``: today's ``F.conv2d`` and its autograd backward,
any layout and dtype); so does an empty one, which launches nothing.
Launches count on ``dwconv_forward.launches``, ``dwconv_input_grad.launches``
and ``dwconv_weight_grad.launches`` (two a call).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from basi_tpu_torch.kernels import _build

K = 7
PAD = 3
GROUP = 8  # the kernels take C a multiple of it
TILE = 16  # the side of a block's output tile
THREAD_ROWS, THREAD_COLS = 4, 8  # a thread's outputs of a tile
PARTS = K * K + 1  # a channel's weight-gradient sums: 49 taps and the bias
_ENTRY = {torch.bfloat16: "basi_dwconv7x7_bf16",
          torch.float32: "basi_dwconv7x7_f32"}
_WGRAD_ENTRY = {torch.bfloat16: "basi_dwconv7x7_wgrad_bf16",
                torch.float32: "basi_dwconv7x7_wgrad_f32"}


def channels_a_block(c: int) -> int:
    """32 channels a block where C is a multiple of 32, else 8
    (``GROUP``)."""
    return 32 if c % 32 == 0 else GROUP


def plan(n: int, h: int, w: int, c: int, per_sm: int,
         sms: int) -> tuple[int, int]:
    """(channels a block, blocks) of a launch: as many blocks as the card
    holds at once, ``per_sm`` an SM, but no more than the items (a channel
    group's 16 x 16 output tile of one image) and a multiple of the channel
    groups, so that each block keeps its channels through its list."""
    cb = channels_a_block(c)
    groups = c // cb
    items = groups * math.ceil(h / TILE) * math.ceil(w / TILE) * n
    cap = per_sm * sms // groups * groups
    return cb, min(items, max(groups, cap))


def weight_grad_depth(shape, cb: int, blocks: int) -> int:
    """How many f32 terms deep the weight gradient's sums go at most, for
    its rounding error, at NCHW ``shape`` launched as ``(cb, blocks)``: a
    thread's outputs of a tile over its block's list of tiles, then the
    block's threads of a channel, then the sets of partials."""
    n, c, h, w = shape
    groups = c // cb
    items = groups * math.ceil(h / TILE) * math.ceil(w / TILE) * n
    threads = (TILE // THREAD_ROWS) * (TILE // THREAD_COLS)
    return (THREAD_ROWS * THREAD_COLS * math.ceil(items / blocks) + threads
            + blocks // groups)


# (weight gradient, dtype, channels a block, device) -> blocks an SM
_held: dict = {}


def launch_plan(wgrad: bool, x: torch.Tensor) -> tuple[int, int]:
    """(channels a block, blocks) of the forward's and input gradient's
    launch (``wgrad`` false) or the weight gradient's on x's device, from
    what an SM holds of the kernel (asked of the card once)."""
    n, c, h, w = x.shape
    cb = channels_a_block(c)
    key = (wgrad, x.dtype, cb, x.device)
    if key not in _held:
        held = ctypes.c_int(0)
        _build.check(_build.library().basi_dwconv7x7_blocks_per_sm(
            wgrad, x.dtype == torch.float32, cb, ctypes.byref(held)),
            "dwconv occupancy")
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        _held[key] = (max(1, held.value), sms)
    return plan(n, h, w, c, *_held[key])


def _check(what: str, acts, w=None, b=None) -> None:
    """Raise unless the activations ``acts`` are one NCHW shape, dtype and
    device, and (on CUDA) bf16 or f32 in ``channels_last`` memory with C a
    multiple of 8, and ``w`` / ``b`` are the contiguous (C, 1, 7, 7) / (C,)
    taps and bias in that dtype on that device."""
    x = acts[-1]
    if x.dim() != 4:
        raise ValueError(f"{what}: expected NCHW, got shape {tuple(x.shape)}")
    for t in acts[:-1]:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                f"{what}: g {tuple(t.shape)} {t.dtype} on {t.device} does "
                f"not match x {tuple(x.shape)} {x.dtype} on {x.device}")
    c = x.shape[1]
    for name, p, shape in (("weight", w, (c, 1, K, K)), ("bias", b, (c,))):
        if p is not None and (p.shape != shape or p.dtype != x.dtype
                              or p.device != x.device):
            raise ValueError(
                f"{what}: {name} must be {shape} {x.dtype} on {x.device}, got "
                f"{tuple(p.shape)} {p.dtype} on {p.device}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _ENTRY:
        raise ValueError(
            f"{what}: expected bfloat16 or float32, got {x.dtype}")
    if c % GROUP:
        raise ValueError(f"{what}: C={c} is not a multiple of {GROUP}")
    if not all(t.is_contiguous(memory_format=torch.channels_last)
               for t in acts):
        raise ValueError(f"{what}: input must be channels_last (its NHWC "
                         "view contiguous)")
    if not all(p is None or p.is_contiguous() for p in (w, b)):
        raise ValueError(f"{what}: weight and bias must be contiguous")


def _conv(what: str, counted, x, w, b, flip: bool) -> torch.Tensor:
    n, c, h, wd = x.shape
    y = torch.empty_like(x)
    cb, blocks = launch_plan(False, x)
    err = getattr(_build.library(), _ENTRY[x.dtype])(
        x.data_ptr(), w.data_ptr(), 0 if b is None else b.data_ptr(),
        y.data_ptr(), n, h, wd, c, cb, blocks, flip, _build.stream(x.device))
    _build.check(err, what)
    counted.launches += 1
    return y


def dwconv_forward(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """y = conv(x, w) + b, 7x7, padding 3, one filter a channel; y in x's
    dtype and layout."""
    _check("dwconv_forward", (x,), w, b)
    if x.device.type == "cpu" or x.numel() == 0:
        return dwconv_forward_reference(x, w, b)
    return _conv("dwconv_forward", dwconv_forward, x, w, b, False)


dwconv_forward.launches = 0


def dwconv_input_grad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of the forward for the cotangent ``g`` of y; in g's dtype and
    layout."""
    _check("dwconv_input_grad", (g,), w)
    if g.device.type == "cpu" or g.numel() == 0:
        return dwconv_input_grad_reference(g, w)
    return _conv("dwconv_input_grad", dwconv_input_grad, g, w, None, True)


dwconv_input_grad.launches = 0


def dwconv_weight_grad(g: torch.Tensor, x: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dw (C, 1, 7, 7), db (C,)) of the forward at input ``x`` for the
    cotangent ``g`` of y, summed in f32 and rounded once to x's dtype."""
    _check("dwconv_weight_grad", (g, x))
    if x.device.type == "cpu" or x.numel() == 0:
        return dwconv_weight_grad_reference(g, x)
    n, c, h, w = x.shape
    cb, blocks = launch_plan(True, x)
    part = torch.empty(blocks // (c // cb) * c * PARTS, dtype=torch.float32,
                       device=x.device)
    dw = torch.empty((c, 1, K, K), dtype=x.dtype, device=x.device)
    db = torch.empty((c,), dtype=x.dtype, device=x.device)
    err = getattr(_build.library(), _WGRAD_ENTRY[x.dtype])(
        g.data_ptr(), x.data_ptr(), part.data_ptr(), dw.data_ptr(),
        db.data_ptr(), n, h, w, c, cb, blocks, _build.stream(x.device))
    _build.check(err, "dwconv_weight_grad")
    dwconv_weight_grad.launches += 2
    return dw, db


dwconv_weight_grad.launches = 0


class _DwConv7x7(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return dwconv_forward(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if x.device.type == "cuda":  # the kernels read the NHWC view
            g = g.contiguous(memory_format=torch.channels_last)
        dx = dwconv_input_grad(g, w) if ctx.needs_input_grad[0] else None
        dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = dwconv_weight_grad(g, x)
        return dx, dw, db


def dwconv7x7(x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """The depthwise 7x7 convolution of NCHW ``x`` (padding 3, with bias),
    computed in x's dtype: ``weight`` (C, 1, 7, 7) and ``bias`` (C,) are
    cast to it, so their gradients reach f32 masters through the cast.
    Differentiable in all three."""
    return _DwConv7x7.apply(x, weight.to(x.dtype), bias.to(x.dtype))


# --- the plain versions ------------------------------------------------------


def _conv_backward(g, x, w, mask):
    return torch.ops.aten.convolution_backward(
        g, x, w, None, [1, 1], [PAD, PAD], [1, 1], False, [0, 0], x.shape[1],
        mask)


def dwconv_forward_reference(x, w, b):
    """Plain PyTorch version: ``F.conv2d`` with ``groups=C``, padding 3."""
    return F.conv2d(x, w, b, padding=PAD, groups=x.shape[1])


def dwconv_input_grad_reference(g, w):
    """Plain PyTorch version: the input gradient of ``F.conv2d``'s
    backward (what autograd computes for it)."""
    return _conv_backward(g, g, w, [True, False, False])[0]


def dwconv_weight_grad_reference(g, x):
    """Plain PyTorch version: the weight and bias gradients of
    ``F.conv2d``'s backward (what autograd computes for them)."""
    w = x.new_empty((x.shape[1], 1, K, K))
    _, dw, db = _conv_backward(g, x, w, [False, True, True])
    return dw, db
