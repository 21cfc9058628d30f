"""FPN decoder (port of ``basi_tpu/models/fpn.py``): lateral 1x1 convs onto
one width, a top-down 2x bilinear upsample (half-pixel centres), 3x3
smoothing convs. NCHW in and out; P2..P5 at strides 4/8/16/32."""

from __future__ import annotations

import torch.nn as nn

from basi_tpu_torch.models.layers import Conv2d
from basi_tpu_torch.ops.resize import resize_nchw


class FPN(nn.Module):
    def __init__(self, in_chs, ch: int = 256):
        super().__init__()
        for i, c in enumerate(in_chs):
            setattr(self, f"lateral{i}", Conv2d(c, ch, 1))
            setattr(self, f"smooth{i}", Conv2d(ch, ch, 3, padding=1))
        self.n = len(in_chs)

    def forward(self, feats):
        lats = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        outs = [None] * self.n
        prev = outs[-1] = lats[-1]
        for i in range(self.n - 2, -1, -1):  # coarsest to finest
            prev = lats[i] + resize_nchw(prev, lats[i].shape[-2:])
            outs[i] = prev
        return [getattr(self, f"smooth{i}")(o) for i, o in enumerate(outs)]
