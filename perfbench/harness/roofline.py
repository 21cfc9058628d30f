"""The card's peaks and the frozen byte and bound functions of the port's
hand-written kernels.

A kernel's bound is the least time the card could take for its call: its
compulsory bytes (each input read once, each output written once) over
the memory rate, or its float32 operations over the float32 rate, the
larger. The byte counts are those the port's kernel timing has used since
its first measurements, frozen here so that the yardstick does not move
with the program.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
H100 = {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}

BF16 = 2  # bytes

# (H*W at 512^2, C, layers) of ResNet-50's 53 BatchNorms: the stem,
# layer1 (3 blocks), layer2 (4), layer3 (6), layer4 (3)
BN_SHAPES_512 = [(65536, 64, 1), (16384, 64, 6), (16384, 256, 4),
                 (16384, 128, 1), (4096, 128, 7), (4096, 512, 5),
                 (4096, 256, 1), (1024, 256, 11), (1024, 1024, 7),
                 (1024, 512, 1), (256, 512, 5), (256, 2048, 4)]


def bound_ms(nbytes: float, flops: float) -> float:
    """The least milliseconds: bytes over the memory rate or float32
    operations over the float32 rate, the larger."""
    return 1e3 * max(nbytes / H100["hbm_bytes_per_s"],
                     flops / H100["f32_flops"])


def upsample_int_calls(n: int, size: int, fpn: int = 256) -> list:
    """((N, H, W, C), factor) of the nine integer-factor bf16 upsamples of
    a BASI forward at batch ``n`` and ``size``^2: the FPN's top-down path
    (three 2x at ``fpn`` channels), the saliency towers (64 channels) and
    the mask features (128 channels), each of P3..P5 to /4."""
    s8, s16, s32 = size // 8, size // 16, size // 32
    calls = [((n, s32, s32, fpn), 2), ((n, s16, s16, fpn), 2),
             ((n, s8, s8, fpn), 2)]
    for c in (64, 128):
        calls += [((n, s8, s8, c), 2), ((n, s16, s16, c), 4),
                  ((n, s32, s32, c), 8)]
    return calls


def _numel(shape) -> int:
    out = 1
    for d in shape:
        out *= d
    return out


def upsample_int_bound_ms(calls) -> float:
    """Bound of ``upsample_int`` over ``calls``: bf16 in and out, four taps
    (7 operations) per output."""
    total = 0.0
    for shape, f in calls:
        n_in = _numel(shape)
        n_out = n_in * f * f
        total += bound_ms(BF16 * (n_in + n_out), 7 * n_out)
    return total


def upsample_int_bwd_bound_ms(calls) -> float:
    """Bound of the ``upsample_int`` backward over the forward's ``calls``:
    the cotangent (the forward's output) in, the input's gradient out, each
    cotangent feeding four taps (8 operations)."""
    total = 0.0
    for shape, f in calls:
        n_in = _numel(shape)
        n_g = n_in * f * f
        total += bound_ms(BF16 * (n_g + n_in), 8 * n_g)
    return total


def bn_shapes(size: int) -> list:
    """``BN_SHAPES_512`` at ``size``^2."""
    scale = (size / 512) ** 2
    return [(int(hw * scale), c, layers) for hw, c, layers in BN_SHAPES_512]


def channel_moments_bound_ms(n: int, size: int) -> float:
    """Bound of one step's 53 ``channel_moments`` calls at batch ``n``:
    x (bf16) read once, two f32 sums per channel written, 3 operations
    per element."""
    return sum(layers * bound_ms(BF16 * n * hw * c + 8 * c, 3 * n * hw * c)
               for hw, c, layers in bn_shapes(size))


def channel_dual_sums_bound_ms(n: int, size: int) -> float:
    """Bound of one step's 53 ``channel_dual_sums`` calls: the gradient and
    x (bf16) read once each, two f32 sums per channel written."""
    return sum(layers * bound_ms(2 * BF16 * n * hw * c + 8 * c,
                                 3 * n * hw * c)
               for hw, c, layers in bn_shapes(size))
