"""ResNet trunk returning C2..C5 (port of ``basi_tpu/models/resnet.py``).

Module and state-dict names are torchvision's, so the JAX package's
``export_basinet`` output loads with ``load_state_dict(strict=True)``. BN
(eps 1e-5) runs on running statistics, or with ``train=True`` on batch
statistics with flax's running update (``models/layers.py``); every BN site
is built by ``models/norm.py::make_batch_norm`` from ``model.bn_impl``
(``xla``, ``fused`` or ``stats``). Convs compute in the input's dtype. Only
the conv7 stem is ported: the JAX package's ``s2d`` and ``conv7p8`` stems
compute the same function from the same (7, 7, 3, 64) parameter, so every
``stem_mode`` runs conv7 here on raw 3-channel input.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from basi_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    update_running_stats,
)
from basi_tpu_torch.models.norm import make_batch_norm

# Block counts, torchvision numbering (same table as the JAX package).
STAGE_SIZES = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
    "resnet_tiny": (1, 1, 1, 1),  # 1-block stages, for fast tests
}

# 18/34 use the two-conv BasicBlock; everything else the 4x Bottleneck.
BLOCK_KIND = {
    "resnet18": "basic",
    "resnet34": "basic",
}

BN_EPS = 1e-5


class ConvBN(nn.Sequential):
    """Conv (no bias) + BatchNorm as ``.0`` / ``.1``: the projection
    shortcut, named ``downsample`` as in torchvision."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 bn_impl: str = "xla"):
        super().__init__(
            Conv2d(cin, cout, kernel, stride=stride,
                   padding=(kernel - 1) // 2, bias=False),
            make_batch_norm(bn_impl, cout, eps=BN_EPS),
        )

    def forward(self, x, train: bool = False):
        return self[1](self[0](x), train)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided, ResNet v1.5) -> 1x1 with a residual shortcut."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 bn_impl: str = "xla"):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = make_batch_norm(bn_impl, planes, eps=BN_EPS)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = make_batch_norm(bn_impl, planes, eps=BN_EPS)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = make_batch_norm(bn_impl, planes * 4, eps=BN_EPS)
        self.downsample = downsample

    def forward(self, x, train: bool = False):
        identity = x if self.downsample is None else self.downsample(x, train)
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        return F.relu(out + identity)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 bn_impl: str = "xla"):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.bn1 = make_batch_norm(bn_impl, planes, eps=BN_EPS)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = make_batch_norm(bn_impl, planes, eps=BN_EPS)
        self.downsample = downsample

    def forward(self, x, train: bool = False):
        identity = x if self.downsample is None else self.downsample(x, train)
        out = F.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        return F.relu(out + identity)


class ResNetTrunk(nn.Module):
    """torchvision ResNet minus avgpool/fc; NCHW in, (C2, C3, C4, C5) out."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), block: str = "bottleneck",
                 bn_impl: str = "xla"):
        super().__init__()
        self.block = BasicBlock if block == "basic" else Bottleneck
        self.bn_impl = bn_impl
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = make_batch_norm(bn_impl, 64, eps=BN_EPS)
        self.inplanes = 64
        self.layer1 = self._make_layer(64, stage_sizes[0], stride=1)
        self.layer2 = self._make_layer(128, stage_sizes[1], stride=2)
        self.layer3 = self._make_layer(256, stage_sizes[2], stride=2)
        self.layer4 = self._make_layer(512, stage_sizes[3], stride=2)

    def _make_layer(self, planes, blocks, stride):
        exp = self.block.expansion
        downsample = None
        if stride != 1 or self.inplanes != planes * exp:
            downsample = ConvBN(self.inplanes, planes * exp, 1, stride,
                                self.bn_impl)
        layers = [self.block(self.inplanes, planes, stride, downsample,
                             self.bn_impl)]
        self.inplanes = planes * exp
        for _ in range(1, blocks):
            layers.append(self.block(self.inplanes, planes,
                                     bn_impl=self.bn_impl))
        return nn.Sequential(*layers)

    @property
    def out_channels(self) -> list[int]:
        exp = self.block.expansion
        return [64 * exp, 128 * exp, 256 * exp, 512 * exp]

    def forward(self, x, train: bool = False):
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = block(x, train)
            feats.append(x)
        if train:
            update_running_stats([m for m in self.modules()
                                  if isinstance(m, BatchNorm2d)])
        return tuple(feats)
