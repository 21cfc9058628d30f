"""The frozen bound of the ConvNeXt trunk's forward depthwise convolutions.

Each 7x7 depthwise conv (padding 3, stride 1, bias) of a block reads its
bf16 input once and writes its bf16 output once, with its float32 weights
and bias, and does 49 multiply-adds (98 operations) an output element.
Its bound is ``roofline.bound_ms`` of those bytes and operations: the
compulsory bytes over the memory rate or the operations over the float32
rate, the larger.
"""

from __future__ import annotations

from perfbench.harness.roofline import BF16, bound_ms

F32 = 4  # bytes
TAPS = 49


def dwconv_calls(n: int, size: int, depths, dims) -> list:
    """((N, C, H, W), blocks) of a forward's depthwise convs at batch ``n``
    and ``size``^2: one a block, stage i at stride 4 * 2^i."""
    return [((n, c, size // (4 << i), size // (4 << i)), blocks)
            for i, (blocks, c) in enumerate(zip(depths, dims))]


def dwconv_bound_ms(calls) -> float:
    """Bound of one forward's depthwise convs (module doc)."""
    total = 0.0
    for (n, c, h, w), blocks in calls:
        elems = n * c * h * w
        nbytes = 2 * BF16 * elems + F32 * (TAPS * c + c)
        total += blocks * bound_ms(nbytes, 2 * TAPS * elems)
    return total
