"""Full-resolution mask pasting (port of ``basi_tpu/ops/paste.py``).

Inverts the letterbox: a mask over the model grid, whose content fills the
top-left ``valid_hw`` region, is bilinearly resampled (half-pixel centres)
onto a fixed ``canvas_hw`` so that the original image fills its top-left
``orig_hw`` region; the rest of the canvas is 0. Sample taps clamp to the
valid letterbox region, not to the mask grid, so the padding's predictions
never blend into the border rows. Every image of a batch has its own
extents; the taps are index tensors and the blend runs in f32.
"""

from __future__ import annotations

import torch


def _taps(valid: torch.Tensor, orig: torch.Tensor, n_out: int, n_in: int):
    """Per image, the two source indices and the weight of the second for
    each output position along one axis: valid/orig (N,) ints ->
    (i0, i1, frac, inside), each (N, n_out)."""
    v = valid.float()[:, None]
    o = orig.float()[:, None]
    r = torch.arange(n_out, dtype=torch.float32, device=valid.device)[None]
    # (r + 0.5) * scale - 0.5 with one rounding, as the reference's fused
    # multiply-add gives it: the f32 product is exact in f64. At a source
    # coordinate of a few hundred one f32 ulp is 3e-5, more than the
    # paste's tolerance where a mask changes fast.
    scale = (v / torch.clamp(o, min=1.0)).double()
    s = ((r + 0.5).double() * scale - 0.5).float()
    s = torch.clamp(s, min=torch.zeros_like(v), max=torch.clamp(v - 1.0, min=0.0))
    i0 = torch.floor(s).to(torch.int64)
    i1 = torch.minimum(i0 + 1, valid.to(torch.int64)[:, None] - 1)
    i1 = torch.clamp(i1, 0, n_in - 1)
    return i0, i1, s - i0, (r < o).float()


def paste_masks_batch(masks: torch.Tensor, valid_hw: torch.Tensor,
                      canvas_hw: tuple[int, int],
                      orig_hw: torch.Tensor) -> torch.Tensor:
    """masks (N, K, h, w) probabilities; valid_hw, orig_hw (N, 2) ints ->
    (N, K, ch, cw) f32, each image's original extent at the top left."""
    ch, cw = canvas_hw
    n, k, h, w = masks.shape
    valid_hw = torch.as_tensor(valid_hw, device=masks.device)
    orig_hw = torch.as_tensor(orig_hw, device=masks.device)
    y0, y1, fy, row_in = _taps(valid_hw[:, 0], orig_hw[:, 0], ch, h)
    x0, x1, fx, col_in = _taps(valid_hw[:, 1], orig_hw[:, 1], cw, w)
    m = masks.float()

    def rows(iy):  # (N, K, ch, w)
        return torch.gather(m, 2, iy[:, None, :, None].expand(n, k, ch, w))

    def cols(r, ix):  # (N, K, ch, cw)
        return torch.gather(r, 3, ix[:, None, None, :].expand(n, k, ch, cw))

    fx = fx[:, None, None, :]
    fy = fy[:, None, :, None]
    r0, r1 = rows(y0), rows(y1)
    top = cols(r0, x0) * (1 - fx) + cols(r0, x1) * fx
    del r0
    bot = cols(r1, x0) * (1 - fx) + cols(r1, x1) * fx
    del r1
    out = top * (1 - fy) + bot * fy
    return out * row_in[:, None, :, None] * col_in[:, None, None, :]


def paste_masks(masks: torch.Tensor, valid_hw, canvas_hw: tuple[int, int],
                orig_hw) -> torch.Tensor:
    """One image's slots: (K, h, w), valid_hw/orig_hw (2,) -> (K, ch, cw)."""
    return paste_masks_batch(
        masks[None], torch.as_tensor(valid_hw, device=masks.device)[None],
        canvas_hw, torch.as_tensor(orig_hw, device=masks.device)[None])[0]


def paste_mask(mask: torch.Tensor, valid_hw, canvas_hw: tuple[int, int],
               orig_hw) -> torch.Tensor:
    """One mask: (h, w) -> (ch, cw)."""
    return paste_masks(mask[None], valid_hw, canvas_hw, orig_hw)[0]
