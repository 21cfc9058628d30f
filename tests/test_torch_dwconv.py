"""ConvNeXt's depthwise 7x7 convolution (``kernels/dwconv.py``) on the CPU:
the plain versions that a CPU tensor runs, the autograd function the model
calls, the module that calls it, and the launch plan of the card's kernels.
The kernels themselves run on the card (``tests/test_torch_gpu.py``,
``-k dwconv``).

On the CPU ``dwconv7x7`` is today's computation: ``F.conv2d`` with
``groups=C`` forward and ``aten.convolution_backward`` backward, which is
what autograd runs for ``F.conv2d``. So its output and its three gradients
equal those of ``F.conv2d`` through autograd bit for bit, in f32 and in
bf16 (taps cast to the input's dtype in both).
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import math

import pytest
import torch
import torch.nn.functional as F

from basi_tpu_torch.kernels import dwconv as D
from basi_tpu_torch.models.convnext import (
    CONVNEXT,
    Block,
    ConvNeXtTrunk,
    DepthwiseConv7x7,
)
from basi_tpu_torch.models.layers import Conv2d

WIDTHS = CONVNEXT["convnext_test"][1]


def _inputs(shape, dtype, seed=0):
    n, c, h, w = shape
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, w, c), generator=gen).to(dtype).permute(0, 3, 1, 2)
    g = torch.randn((n, h, w, c), generator=gen).to(dtype).permute(0, 3, 1, 2)
    w32 = torch.randn((c, 1, 7, 7), generator=gen) / 7
    b32 = torch.randn((c,), generator=gen)
    return x, g, w32, b32


def _grads(fn, x, g, w32, b32):
    x = x.clone().requires_grad_()
    w32 = w32.clone().requires_grad_()
    b32 = b32.clone().requires_grad_()
    y = fn(x, w32, b32)
    y.backward(g)
    return y.detach(), x.grad, w32.grad, b32.grad


def _library(x, w32, b32):
    """Today's computation: the taps cast to x's dtype, then F.conv2d."""
    return F.conv2d(x, w32.to(x.dtype), b32.to(x.dtype), padding=3,
                    groups=x.shape[1])


@pytest.mark.parametrize("shape", [(2, c, 16, 16) for c in WIDTHS]
                         + [(2, 16, 13, 11), (1, 24, 7, 9)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_twin_equals_conv2d_and_its_autograd(shape, dtype):
    """Output, dx, dw and db of ``dwconv7x7`` on the CPU equal those of
    ``F.conv2d`` (``groups=C``, padding 3) through autograd, bit for bit,
    at ``convnext_test``'s widths and at odd sides; dw and db reach the f32
    masters as f32."""
    x, g, w32, b32 = _inputs(shape, dtype)
    got = _grads(D.dwconv7x7, x, g, w32, b32)
    want = _grads(_library, x, g, w32, b32)
    for name, a, b in zip(("y", "dx", "dw", "db"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, float((a - b).abs().max()))
    assert got[2].dtype == torch.float32 and got[3].dtype == torch.float32


def test_plain_parts_are_the_gradients():
    """The three plain parts each equal their share of autograd's
    backward of ``F.conv2d``, in the input's dtype."""
    x, g, w32, b32 = _inputs((2, 32, 10, 12), torch.float32, 3)
    y, dx, dw, db = _grads(_library, x, g, w32, b32)
    assert torch.equal(D.dwconv_forward(x, w32, b32), y)
    assert torch.equal(D.dwconv_input_grad(g, w32), dx)
    got_dw, got_db = D.dwconv_weight_grad(g, x)
    assert torch.equal(got_dw, dw) and torch.equal(got_db, db)


def test_no_launch_on_the_cpu():
    """A CPU tensor runs the plain versions: no launch counted."""
    counters = (D.dwconv_forward, D.dwconv_input_grad, D.dwconv_weight_grad)
    n0 = [f.launches for f in counters]
    _grads(D.dwconv7x7, *_inputs((1, 16, 9, 9), torch.float32))
    assert [f.launches for f in counters] == n0


def test_wrappers_refuse_mismatched_arguments():
    """On any device: a non-4-D input, a cotangent of another shape or
    dtype, taps or a bias of another shape or dtype raise."""
    x, g, w32, b32 = _inputs((2, 16, 8, 8), torch.float32)
    with pytest.raises(ValueError, match="NCHW"):
        D.dwconv_forward(x[0], w32, b32)
    with pytest.raises(ValueError, match="does not match"):
        D.dwconv_weight_grad(g[:, :, :4], x)
    with pytest.raises(ValueError, match="does not match"):
        D.dwconv_weight_grad(g.double(), x)
    with pytest.raises(ValueError, match="weight"):
        D.dwconv_forward(x, w32[:8], b32)
    with pytest.raises(ValueError, match="weight"):
        D.dwconv_input_grad(g, w32.double())
    with pytest.raises(ValueError, match="bias"):
        D.dwconv_forward(x, w32, b32[:8])


def test_module_keeps_conv2d_names_shapes_and_init():
    """``DepthwiseConv7x7`` is a ``Conv2d`` (``init_weights`` finds it by
    ``isinstance(m, nn.Conv2d)``) with its parameters' names and shapes
    and, from one seed, its init; it loads a state dict written by
    today's ``Conv2d(dim, dim, 7, padding=3, groups=dim)`` and then
    computes what that module computes."""
    dim = 32
    torch.manual_seed(5)
    old = Conv2d(dim, dim, 7, padding=3, groups=dim)
    torch.manual_seed(5)
    new = DepthwiseConv7x7(dim)
    assert isinstance(new, torch.nn.Conv2d)
    assert {k: v.shape for k, v in new.state_dict().items()} == {
        "weight": (dim, 1, 7, 7), "bias": (dim,)}
    assert all(torch.equal(a, b) for a, b in zip(old.state_dict().values(),
                                                 new.state_dict().values()))
    with torch.no_grad():
        old.weight.normal_()
        old.bias.normal_()
    fresh = DepthwiseConv7x7(dim)
    fresh.load_state_dict(old.state_dict(), strict=True)
    x = torch.randn(2, dim, 11, 13).to(memory_format=torch.channels_last)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(fresh(x.to(dtype)), old(x.to(dtype)))


def test_trunk_state_dict_names_unchanged():
    """A block's depthwise conv keeps the published names
    (``stages.i.j.dwconv.weight``, ``.bias``), so checkpoints written
    before load as they are."""
    block = Block(16)
    assert isinstance(block.dwconv, DepthwiseConv7x7)
    names = list(ConvNeXtTrunk(*CONVNEXT["convnext_test"]).state_dict())
    assert "stages.0.0.dwconv.weight" in names
    assert "stages.3.0.dwconv.bias" in names


@pytest.mark.parametrize("c,want", [(128, 32), (1024, 32), (32, 32),
                                    (16, 8), (24, 8), (8, 8)])
def test_channels_a_block(c, want):
    """32 channels a block where C allows, else 8."""
    assert D.channels_a_block(c) == want
    assert D.plan(2, 16, 16, c, 2, 132)[0] == want


@pytest.mark.parametrize("shape", [(64, 128, 128, 128), (64, 256, 64, 64),
                                   (64, 512, 32, 32), (64, 1024, 16, 16),
                                   (2, 16, 13, 11), (1, 8, 7, 7),
                                   (3, 24, 37, 45)])
@pytest.mark.parametrize("per_sm", [1, 2, 8])
@pytest.mark.parametrize("sms", [1, 132])
def test_launch_plan(shape, per_sm, sms):
    """The grid: a positive multiple of the channel groups (a block keeps
    its channels through its list) and no more blocks than items (16 x 16
    tiles of a channel group and an image); where the items allow, within
    one group of what the card holds at once."""
    n, c, h, w = shape
    cb, blocks = D.plan(n, h, w, c, per_sm, sms)
    groups = c // cb
    items = groups * math.ceil(h / 16) * math.ceil(w / 16) * n
    held = per_sm * sms
    assert blocks % groups == 0 and groups <= blocks <= items
    if items >= held:
        assert held - groups < blocks <= max(held, groups)


@pytest.mark.parametrize("shape,per_sm", [((64, 128, 128, 128), 2),
                                          ((64, 1024, 16, 16), 2),
                                          ((3, 24, 37, 45), 8)])
def test_weight_grad_depth_counts_every_sum(shape, per_sm):
    """The depth of the weight gradient's sums: 32 outputs a thread and
    tile over the longest list, the 8 threads of a channel, the sets; and
    no shallower than the terms' count over the sets of partials would
    allow (every term of a channel is summed somewhere)."""
    n, c, h, w = shape
    cb, blocks = D.plan(n, h, w, c, per_sm, 132)
    groups = c // cb
    items = groups * math.ceil(h / 16) * math.ceil(w / 16) * n
    depth = D.weight_grad_depth(shape, cb, blocks)
    assert depth == 32 * math.ceil(items / blocks) + 8 + blocks // groups
    # a channel's 16 x 16 outputs of its tiles spread over its blocks
    terms = n * math.ceil(h / 16) * math.ceil(w / 16) * 256
    assert depth * 8 * (blocks // groups) >= terms
