"""ConvNeXt trunk returning C2..C5 (Liu et al., "A ConvNet for the 2020s",
arXiv 2201.03545; facebookresearch/ConvNeXt, the detection backbone).

The JAX package has no ConvNeXt: this trunk is the port's own, and no JAX
checkpoint maps onto it (``convert.py`` refuses it). Module and state-dict
names are the published code's (``downsample_layers``, ``stages``,
``dwconv``, ``norm``, ``pwconv1``, ``pwconv2``, ``gamma``, ``norm{i}``).

- Stem: a 4x4 conv with stride 4 (bias), then a channels-first LayerNorm.
- Between stages: a channels-first LayerNorm, then a 2x2 conv with stride 2
  (bias).
- Block: ``x + gamma * pwconv2(GELU(pwconv1(LN(dwconv7x7(x)))))``, the
  depthwise 7x7 conv with padding 3 and bias (``DepthwiseConv7x7``: the
  hand-written kernels of ``kernels/dwconv.py`` on the card, ``F.conv2d``
  on the CPU), LN over channels (eps 1e-6),
  the Linears C -> 4C -> C with bias, exact (erf) GELU, the layer scale
  ``gamma`` per channel (1e-6 at init). No stochastic depth: the branch is
  always computed and always kept.
- Outputs: a channels-first LayerNorm on each stage's output, at strides
  4, 8, 16 and 32, as ResNet's C2..C5.

Tensors are NCHW in ``channels_last`` memory, so the NHWC view that the
LayerNorms and the Linears take (``permute(0, 2, 3, 1)``) is free and so is
the way back: no layout copy. Mixed precision as ``models/layers.py``:
activations in the input's dtype, every weight cast to it in the layer;
LayerNorm takes its statistics in float32 and rounds its output once. The
forward's parts run in ``utils/profiling.py`` spans, summed over calls:
``convnext.dwconv`` (the depthwise convs), ``convnext.norm`` (every
LayerNorm of the trunk) and ``convnext.mlp`` (Linear, GELU, Linear and
``gamma``). They are the forward's only: the backward runs inside the
caller's span (``train.backward``), and under ``train.remat`` the
recompute opens them again there.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from basi_tpu_torch.kernels.dwconv import dwconv7x7
from basi_tpu_torch.models.layers import Conv2d
from basi_tpu_torch.utils.profiling import span

# (depths, widths) by name; ``convnext_test`` is a one-block cut for the
# CPU tests, as ``resnet_tiny`` is ResNet's.
CONVNEXT = {
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_test": ((1, 1, 1, 1), (16, 32, 64, 128)),
}
LN_EPS = 1e-6
LAYER_SCALE_INIT = 1e-6


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dimension in the input's dtype (statistics
    in float32), its weight and bias cast to that dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("convnext.norm"):
            return F.layer_norm(x, self.normalized_shape,
                                self.weight.to(x.dtype),
                                self.bias.to(x.dtype), self.eps)


class LayerNorm2d(LayerNorm):
    """Channels-first LayerNorm: over C of an NCHW tensor, through its
    NHWC view."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class DepthwiseConv7x7(Conv2d):
    """The block's depthwise 7x7 conv (padding 3, bias): ``Conv2d``'s
    parameters, names and init, computed by ``kernels/dwconv.py``."""

    def __init__(self, dim: int):
        super().__init__(dim, dim, 7, padding=3, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dwconv7x7(x, self.weight, self.bias)


class Block(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = DepthwiseConv7x7(dim)
        self.norm = LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = Linear(dim, 4 * dim)
        self.pwconv2 = Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("convnext.dwconv"):
            y = self.dwconv(x)
        y = self.norm(y.permute(0, 2, 3, 1))
        with span("convnext.mlp"):
            y = self.pwconv2(F.gelu(self.pwconv1(y))) * self.gamma.to(y.dtype)
        return x + y.permute(0, 3, 1, 2)


class ConvNeXtTrunk(nn.Module):
    """NCHW in, (C2, C3, C4, C5) out (module doc)."""

    def __init__(self, depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)):
        super().__init__()
        stem = nn.Sequential(Conv2d(3, dims[0], 4, stride=4),
                             LayerNorm2d(dims[0], eps=LN_EPS))
        self.downsample_layers = nn.ModuleList([stem] + [
            nn.Sequential(LayerNorm2d(dims[i - 1], eps=LN_EPS),
                          Conv2d(dims[i - 1], dims[i], 2, stride=2))
            for i in range(1, 4)])
        self.stages = nn.ModuleList(
            nn.Sequential(*(Block(d) for _ in range(n)))
            for n, d in zip(depths, dims))
        for i, d in enumerate(dims):
            setattr(self, f"norm{i}", LayerNorm2d(d, eps=LN_EPS))
        self.dims = tuple(dims)

    @property
    def out_channels(self) -> list[int]:
        return list(self.dims)

    def forward(self, x, train: bool = False):
        """``train`` is the ResNet trunk's flag: this trunk has no batch
        statistics, so both modes compute the same."""
        feats = []
        for i in range(4):
            x = self.stages[i](self.downsample_layers[i](x))
            feats.append(getattr(self, f"norm{i}")(x))
        return tuple(feats)
