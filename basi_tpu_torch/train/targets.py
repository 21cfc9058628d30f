"""GT -> cell-grid target assignment (port of ``basi_tpu/train/targets.py``).

The JAX functions work on one image and are ``vmap``-ed; these take the
batch dimension N first. Rule (center region, SOLO-flavoured): a cell is
positive for an instance when the cell's centre lies inside the instance's
centre box (centre +/- sigma * extent / 2, at least half a cell); a cell
claimed by several instances goes to the smallest. The GT goes to the mask
resolution by max-pool where it is an integer multiple of it, else by a
bilinear resize thresholded at 0.5. The sparse path keeps the first
``max_pos_cells`` cells of a stable sort that puts positives first, so
positives beyond the cap drop by index, as in JAX; the dense path
(``assign_targets``) gives every cell its target, and the roi mechanism's
(``assign_targets_roi``) adds each kept cell's GT box.

Shapes: gt_masks (N, M, H, W) 0/1 (any dtype), gt_valid (N, M).
"""

from __future__ import annotations

import torch

from basi_tpu_torch.ops.resize import maxpool_hw, resize_bilinear

_EPS = 1e-6


def instance_stats(gt_masks: torch.Tensor,
                   gt_valid: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-instance centre of mass, extents, bbox corners and area in
    normalized [0, 1] coordinates: dict of (N, M) f32 tensors (cy, cx, eh,
    ew, y0, x0, y1, x1, area, valid)."""
    *_, h, w = gt_masks.shape
    dev = gt_masks.device
    row_mass = gt_masks.sum(-1, dtype=torch.float32)  # (N, M, H)
    col_mass = gt_masks.sum(-2, dtype=torch.float32)  # (N, M, W)
    area = row_mass.sum(-1)
    safe_area = area.clamp_min(_EPS)
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    cy = (row_mass * ys).sum(-1) / safe_area
    cx = (col_mass * xs).sum(-1) / safe_area
    row_any = row_mass > 0
    col_any = col_mass > 0
    y_min = torch.where(row_any, ys, 2.0).amin(-1)
    y_max = torch.where(row_any, ys, -2.0).amax(-1)
    x_min = torch.where(col_any, xs, 2.0).amin(-1)
    x_max = torch.where(col_any, xs, -2.0).amax(-1)
    valid = gt_valid.float() * (area > 0)
    on = valid > 0
    zero = torch.zeros((), device=dev)
    hp_y, hp_x = 0.5 / h, 0.5 / w
    return {
        "cy": cy, "cx": cx,
        "eh": (y_max - y_min).clamp_min(0.0),
        "ew": (x_max - x_min).clamp_min(0.0),
        "y0": torch.where(on, (y_min - hp_y).clamp_min(0.0), zero),
        "x0": torch.where(on, (x_min - hp_x).clamp_min(0.0), zero),
        "y1": torch.where(on, (y_max + hp_y).clamp_max(1.0), zero),
        "x1": torch.where(on, (x_max + hp_x).clamp_max(1.0), zero),
        "area": area, "valid": valid,
    }


def _assignment_core(gt_masks, gt_valid, grid_size: int, mask_hw,
                     center_sigma: float, stats: dict | None = None):
    """(small (N, M, h, w) f32 GT at the mask resolution, flat_winner
    (N, S*S), cell_pos (N, S*S) f32, cell_score_tgt (N, S, S, 1) f32).

    ``stats``: precomputed ``instance_stats`` (normalized coordinates, so
    resolution-free): the step passes full-resolution stats with /4 masks.
    """
    s = grid_size
    if stats is None:
        stats = instance_stats(gt_masks, gt_valid)
    dev = gt_masks.device
    cc = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    half_h = (center_sigma * stats["eh"] * 0.5).clamp_min(0.5 / s)  # (N, M)
    half_w = (center_sigma * stats["ew"] * 0.5).clamp_min(0.5 / s)
    # (N, M, S, S): is cell (i, j) inside instance m's centre region?
    in_y = ((cc[:, None] - stats["cy"][..., None, None]).abs()
            <= half_h[..., None, None])
    in_x = ((cc[None, :] - stats["cx"][..., None, None]).abs()
            <= half_w[..., None, None])
    hit = in_y & in_x & (stats["valid"][..., None, None] > 0)
    area_rank = torch.where(hit, stats["area"][..., None, None], float("inf"))
    winner = area_rank.argmin(dim=1)  # (N, S, S): first minimum, as jnp
    any_hit = hit.any(dim=1)

    mh, mw = mask_hw
    gh, gw = gt_masks.shape[-2:]
    fh, fw = gh // mh, gw // mw
    n, m = gt_masks.shape[:2]
    if fh * mh == gh and fw * mw == gw and fh >= 1:
        small = maxpool_hw(gt_masks, fh, fw).float()
    else:  # not an integer factor: bilinear, then the 0.5 threshold
        hwc = gt_masks.float().reshape(n * m, gh, gw, 1)
        small = (resize_bilinear(hwc, (mh, mw)) > 0.5).float()
        small = small.reshape(n, m, mh, mw)
    return (small, winner.reshape(n, -1), any_hit.reshape(n, -1).float(),
            any_hit.float()[..., None])


def assign_targets(gt_masks, gt_valid, grid_size: int = 16,
                   mask_hw=(128, 128), center_sigma: float = 0.2,
                   stats: dict | None = None):
    """Dense targets of every cell: (cell_target_mask (N, S*S, h, w) f32,
    cell_pos (N, S*S) f32, cell_score_tgt (N, S, S, 1) f32)."""
    small, flat_winner, cell_pos, score_tgt = _assignment_core(
        gt_masks, gt_valid, grid_size, mask_hw, center_sigma, stats)
    rows = torch.arange(small.shape[0], device=small.device)[:, None]
    tgt = small[rows, flat_winner] * cell_pos[..., None, None]
    return tgt, cell_pos, score_tgt


def _positive_cells(small, flat_winner, cell_pos, max_pos_cells: int):
    """The first ``max_pos_cells`` cells of a stable sort that puts the
    positives first: (sel_idx (N, P), pos_sel (N, P), win (N, P) their
    instances, tgt_sel (N, P, h, w) their instances' masks, zero where
    the cell is not positive)."""
    order = torch.argsort(-cell_pos, dim=-1, stable=True)
    sel_idx = order[:, :max_pos_cells]
    pos_sel = cell_pos.gather(1, sel_idx)
    win = flat_winner.gather(1, sel_idx)
    rows = torch.arange(small.shape[0], device=small.device)[:, None]
    return sel_idx, pos_sel, win, small[rows, win] * pos_sel[..., None, None]


def assign_targets_sparse(gt_masks, gt_valid, grid_size: int = 16,
                          mask_hw=(128, 128), center_sigma: float = 0.2,
                          max_pos_cells: int = 64, stats: dict | None = None):
    """Targets of the positive-cells-only loss. Returns (sel_idx (N, P)
    int64, tgt_masks (N, P, h, w) f32, pos_sel (N, P) f32, cell_score_tgt
    (N, S, S, 1), num_pos (N,))."""
    small, flat_winner, cell_pos, score_tgt = _assignment_core(
        gt_masks, gt_valid, grid_size, mask_hw, center_sigma, stats)
    sel_idx, pos_sel, _, tgt_sel = _positive_cells(
        small, flat_winner, cell_pos, max_pos_cells)
    return sel_idx, tgt_sel, pos_sel, score_tgt, cell_pos.sum(-1)


def assign_targets_roi(gt_masks, gt_valid, grid_size: int = 16,
                       mask_hw=(128, 128), center_sigma: float = 0.2,
                       max_pos_cells: int = 64, stats: dict | None = None):
    """Targets of the roi mechanism: the sparse path's cells, each with its
    instance's GT box (the ROI mask head trains at GT boxes; the box head
    has its own loss). Returns ``assign_targets_sparse``'s five and
    sel_boxes (N, P, 4) f32 normalized (y0, x0, y1, x1), zero where the
    cell is not positive."""
    if stats is None:
        stats = instance_stats(gt_masks, gt_valid)
    small, flat_winner, cell_pos, score_tgt = _assignment_core(
        gt_masks, gt_valid, grid_size, mask_hw, center_sigma, stats)
    sel_idx, pos_sel, win, tgt_sel = _positive_cells(
        small, flat_winner, cell_pos, max_pos_cells)
    boxes = torch.stack([stats["y0"], stats["x0"], stats["y1"], stats["x1"]],
                        dim=-1)  # (N, M, 4)
    sel_boxes = boxes.gather(1, win[..., None].expand(-1, -1, 4))
    return (sel_idx, tgt_sel, pos_sel, score_tgt, cell_pos.sum(-1),
            sel_boxes * pos_sel[..., None])
