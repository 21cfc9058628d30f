"""On-device augmentation and GT-mask bit packing (port of
``basi_tpu/data/transforms.py``).

* ``random_augment``: the scale jitter of ``data.multiscale``. Each image
  and its masks go through a per-image separable bilinear resample, two
  batched f32 matmuls against (H, H) and (W, W) hat-function matrices
  built from the image's scale and offsets: zoom in crops at the offset,
  zoom out shrinks onto a zero canvas; masks are thresholded at 0.5 after.
  The JAX package runs these einsums at ``Precision.HIGHEST``; here TF32
  is turned off around them, whatever the process's default.
* ``color_jitter``: brightness, contrast and saturation (torchvision's
  ColorJitter formulas in [0, 1] pixels, in that order) applied to the
  normalized image, where each is affine; raw (N, H, W, 3) layout only.
* The host packs binary GT masks 8 to a byte along W before the upload
  (the bulk of a train batch's bytes); the step unpacks them on the device.

The draws (scales, offsets, factors) come from the caller:
``train/step.py::draw_augment``.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

# ITU-R BT.601 luma, torchvision's rgb_to_grayscale constants
LUMA = (0.2989, 0.587, 0.114)


@contextlib.contextmanager
def true_f32_matmul():
    """CUDA matmuls in full f32 (no TF32) inside, the setting restored
    after."""
    m = torch.backends.cuda.matmul
    prev = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = prev


def dynamic_interp_matrix(out_size: int, in_size: int, scale: torch.Tensor,
                          offset: torch.Tensor) -> torch.Tensor:
    """(N, out, in) bilinear sampling matrices for source coordinates
    ``src = (i + 0.5) * scale + offset - 0.5`` (``scale``, ``offset``: (N,)):
    ``W[i, j] = max(0, 1 - |src_i - j|)``, rows whose centre lies outside
    (-1, in) zeroed (zero padding). In the dtype of ``scale``."""
    dt, dev = scale.dtype, scale.device
    i = torch.arange(out_size, dtype=dt, device=dev)[:, None]
    j = torch.arange(in_size, dtype=dt, device=dev)[None, :]
    src = (i + 0.5) * scale[:, None, None] + offset[:, None, None] - 0.5
    w = (1.0 - (src - j).abs()).clamp_min(0.0)
    inside = (src > -1.0) & (src < in_size)
    return w * inside


def random_augment(images: torch.Tensor, masks: torch.Tensor,
                   scale: torch.Tensor, off_y: torch.Tensor,
                   off_x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Zoom each image (N, H, W, C) and its masks (N, M, H, W) by ``scale``
    (N,): above 1 a crop of 1/scale of the image at the (``off_y``,
    ``off_x``) in [0, 1] fraction of the room, resized back; below 1 the
    image shrunk onto a zero canvas at that place. The resample runs in at
    least f32; images come back in their dtype, masks thresholded at 0.5 in
    theirs. The flip is the ingest's (``normalize_and_flip``)."""
    n, h, w, c = images.shape
    work = torch.promote_types(images.dtype, torch.float32)
    scale, off_y, off_x = (t.to(images.device, work)
                           for t in (scale, off_y, off_x))
    r = 1.0 / scale  # source pixels per output pixel
    wy = dynamic_interp_matrix(h, h, r, off_y * (h - r * h))
    wx = dynamic_interp_matrix(w, w, r, off_x * (w - r * w))
    with true_f32_matmul():
        img = torch.bmm(wy, images.to(work).reshape(n, h, w * c))
        img = img.reshape(n, h, w, c).transpose(1, 2).reshape(n, w, h * c)
        img = torch.bmm(wx, img).reshape(n, w, h, c).transpose(1, 2)
        m = masks.shape[1]
        msk = torch.matmul(wy[:, None], masks.to(work))  # (N, M, H, W)
        msk = torch.matmul(msk, wx[:, None].transpose(-1, -2))
    return (img.to(images.dtype).contiguous(),
            (msk > 0.5).to(masks.dtype).reshape(n, m, h, w))


@functools.lru_cache(maxsize=16)
def _jitter_constants(mean: tuple, std: tuple, dtype: torch.dtype,
                      device: torch.device) -> tuple:
    """(mean, std, luma) as ``dtype`` tensors on ``device``, copied there
    once (a copy from pageable memory would wait for the device's queue)."""
    with torch.inference_mode(False):
        return tuple(torch.tensor(v, dtype=dtype).to(device)
                     for v in (mean, std, LUMA))


def color_jitter(images: torch.Tensor, mean, std, brightness: float,
                 contrast: float, saturation: float,
                 f_brightness: torch.Tensor, f_contrast: torch.Tensor,
                 f_saturation: torch.Tensor) -> torch.Tensor:
    """Per-image brightness, contrast and saturation jitter of normalized
    (N, H, W, 3) ``images``, each applied where its strength is above 0
    with its factor (N,) in [max(0, 1 - x), 1 + x]: brightness ``p * f``,
    contrast ``g0 + (p - g0) * f`` (g0 the image's mean luma), saturation
    ``g + (p - g) * f`` (g the pixel's luma), written on ``(p - mean) /
    std``. Computes in at least f32, returns ``images``' dtype."""
    if brightness <= 0 and contrast <= 0 and saturation <= 0:
        return images
    n, _, _, c = images.shape
    if c % 3:
        raise ValueError(f"color_jitter expects C % 3 == 0 layouts, got {c}")
    if c != 3:
        raise ValueError("color_jitter: the s2d-packed (C=12) feed is not "
                         "ported")
    work = torch.promote_types(images.dtype, torch.float32)
    m, s, lw = _jitter_constants(tuple(mean), tuple(std), work, images.device)

    def factor(f):
        return f.to(images.device, work).reshape(n, 1, 1, 1)

    def gray(x):  # pixel-space luma, (N, H, W, 1)
        return ((x * s + m) * lw).sum(-1, keepdim=True)

    x = images.to(work)
    if brightness > 0:
        f = factor(f_brightness)
        x = f * x + (f - 1.0) * (m / s)
    if contrast > 0:
        f = factor(f_contrast)
        g0 = gray(x).mean(dim=(1, 2, 3)).reshape(n, 1, 1, 1)
        x = f * x + (1.0 - f) * (g0 - m) / s
    if saturation > 0:
        f = factor(f_saturation)
        x = f * x + (1.0 - f) * (gray(x) - m) / s
    return x.to(images.dtype)


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
