"""GT-mask bit packing (port of ``basi_tpu/data/transforms.py``).

The host packs binary GT masks 8 to a byte along W before the upload (the
bulk of a train batch's bytes); the step unpacks them on the device.
Multiscale ``random_augment`` and ``color_jitter`` are not ported.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_masks_host(masks: np.ndarray) -> np.ndarray:
    """Bit-pack binary masks along W: (..., H, W) u8 -> (..., H, ceil(W/8))
    u8, big-endian bit order (``np.packbits``). Lossless for ``> 0``."""
    return np.packbits(masks > 0, axis=-1)


def unpack_masks(packed: torch.Tensor, w: int) -> torch.Tensor:
    """On-device inverse of ``pack_masks_host``: (..., H, W/8) u8 ->
    (..., H, w) u8 in {0, 1}; ``w`` trims the zero padding of a W that is
    not a multiple of 8."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)[..., :w]


def maybe_unpack_masks(masks: torch.Tensor, full_w: int) -> torch.Tensor:
    """GT masks raw (..., H, full_w) or bit-packed (..., H, ceil(full_w/8))
    -> the raw form."""
    if masks.shape[-1] == full_w:
        return masks
    if masks.shape[-1] == -(-full_w // 8):
        return unpack_masks(masks, full_w)
    raise ValueError(f"GT masks W={masks.shape[-1]} is neither the full width "
                     f"{full_w} nor its bit-packed /8 form")
