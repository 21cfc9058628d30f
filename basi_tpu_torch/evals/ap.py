"""Mask AP and AR (port of ``basi_tpu/evals/ap.py``).

The predicted-vs-GT IoU matrix is computed on the device, one matmul per
image (``ops/nms.py::mask_iou_matrix``); only the small (K, M) matrices
come back. Greedy COCO matching, the 101-point precision envelope and the
recall bookkeeping run in float64 numpy on the host, as in the reference:
``APAccumulator`` is the same host code.
"""

from __future__ import annotations

import numpy as np
import torch

from basi_tpu_torch.ops.nms import mask_iou_matrix


def match_image(pred_masks: torch.Tensor, gt_masks: torch.Tensor,
                mask_threshold: float = 0.5) -> torch.Tensor:
    """IoU matrix of one image: (K, H, W) probabilities x (M, H, W) 0/1
    GT -> (K, M) f32."""
    return match_batch(pred_masks[None], gt_masks[None], mask_threshold)[0]


def match_batch(pred_masks: torch.Tensor, gt_masks: torch.Tensor,
                mask_threshold: float = 0.5) -> torch.Tensor:
    """``match_image`` over a batch: (N, K, H, W) x (N, M, H, W) ->
    (N, K, M). The products are f32 sums of 0/1 terms: exact below 2^24
    pixels, whatever the matmul's precision."""
    pm = (pred_masks > mask_threshold).float()
    return mask_iou_matrix(pm, gt_masks.float())


class APAccumulator:
    """Streaming AP over a val split at multiple IoU thresholds.

    add(scores, iou, gt_valid) per image; ap() returns {thr: AP} plus mAP
    over the 0.5:0.95:0.05 COCO ladder.

    Host cost: ``add`` is vectorized over ALL thresholds at once (one
    (T, M) boolean pass per prediction — the greedy matched-state makes the
    prediction loop inherently sequential, but K <= 20), and ``ap`` runs
    the full PR sweep as (T, E) cumulative sums. At 10x val-set scale the
    accumulator stays off the eval critical path (microbenched ~20x faster
    than the per-threshold-loop formulation on 10k entries).
    """

    # COCO area ranges (pixels in the matching frame — letterbox frame by
    # default, original frame under infer.ap_at_original)
    AREA_BINS = {"small": (0, 32 ** 2), "medium": (32 ** 2, 96 ** 2),
                 "large": (96 ** 2, np.inf)}

    def __init__(self, thresholds=(0.5, 0.7)):
        self.thresholds = tuple(thresholds)
        self.coco_ladder = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))
        # Python floats (dict keys) and the float64 compute vector share
        # the exact same values, so index-based lookup is safe.
        self._thr_list = sorted(set(self.thresholds) | set(self.coco_ladder))
        self._thr = np.asarray(self._thr_list, np.float64)
        self._scores: list[np.ndarray] = []  # per-image kept scores (desc)
        self._tp: list[np.ndarray] = []  # per-image (T, k) TP flags
        self._num_gt = 0
        # recall bookkeeping: per image, the detection rank (0 = highest
        # score) at which each GT slot was matched, -1 if never (T, M)
        self._match_rank: list[np.ndarray] = []
        self._gt_valid: list[np.ndarray] = []  # per-image (M,) bool
        self._gt_areas: list[np.ndarray | None] = []  # per-image (M,)

    def add(self, scores: np.ndarray, iou: np.ndarray, gt_valid: np.ndarray,
            gt_areas: np.ndarray | None = None):
        """scores (K,), iou (K, M), gt_valid (M,) for one image;
        gt_areas (M,) in pixels enables the size-binned AR metrics."""
        scores = np.asarray(scores, np.float64)
        iou = np.asarray(iou, np.float64)
        gt_valid = np.asarray(gt_valid).astype(bool)
        self._num_gt += int(gt_valid.sum())
        # stable: equal scores keep slot order (matches global sort in ap())
        order = np.argsort(-scores, kind="stable")
        keep = order[scores[order] > 0]
        t_count = self._thr.size
        tp = np.zeros((t_count, keep.size), bool)
        matched = np.zeros((t_count, iou.shape[1]), bool)
        rank = np.full((t_count, iou.shape[1]), -1, np.int32)
        thr_col = self._thr[:, None]
        # Greedy match, all thresholds at once: highest-score pred takes
        # the best unmatched GT with IoU >= thr (COCO matching).
        for out_i, k in enumerate(keep):
            row = iou[k][None, :]  # (1, M)
            cand = gt_valid[None, :] & ~matched & (row >= thr_col)  # (T, M)
            has = cand.any(axis=1)
            best = np.argmax(np.where(cand, row, -1.0), axis=1)
            matched[has, best[has]] = True
            rank[has, best[has]] = out_i  # first (and only) assignment
            tp[:, out_i] = has
        self._scores.append(scores[keep])
        self._tp.append(tp)
        self._match_rank.append(rank)
        self._gt_valid.append(gt_valid)
        self._gt_areas.append(
            None if gt_areas is None else np.asarray(gt_areas, np.float64))

    def ar(self) -> dict[str, float]:
        """COCO-style average recall over the 0.5:0.95 ladder: AR@K for
        K in {1, 10, 100} detections/image, plus AR@100 split by the COCO
        GT-size bins when ``add`` received areas. Bins with zero GT report
        -1.0 (the pycocotools convention)."""
        ladder_ix = [self._thr_list.index(t) for t in self.coco_ladder]
        if self._num_gt == 0:
            out = {f"AR@{k}": 0.0 for k in (1, 10, 100)}
            return out | {f"AR@100_{b}": -1.0 for b in self.AREA_BINS}
        rank = np.concatenate(self._match_rank, axis=1)[ladder_ix]  # (L, G)
        valid = np.concatenate(self._gt_valid)  # (G,)
        out = {}
        for k in (1, 10, 100):
            hit = (rank >= 0) & (rank < k) & valid[None, :]
            out[f"AR@{k}"] = float(hit.sum(axis=1).mean() / valid.sum())
        have_areas = all(a is not None for a in self._gt_areas)
        for name, (lo, hi) in self.AREA_BINS.items():
            if not have_areas:
                out[f"AR@100_{name}"] = -1.0
                continue
            areas = np.concatenate(self._gt_areas)
            in_bin = valid & (areas >= lo) & (areas < hi)
            if not in_bin.any():
                out[f"AR@100_{name}"] = -1.0
                continue
            hit = (rank >= 0) & (rank < 100) & in_bin[None, :]
            out[f"AR@100_{name}"] = float(
                hit.sum(axis=1).mean() / in_bin.sum())
        return out

    def ap(self) -> dict[str, float]:
        zero = {f"AP@{t}": 0.0 for t in self.thresholds} | {"mAP": 0.0}
        if self._num_gt == 0:
            return zero
        scores = (np.concatenate(self._scores) if self._scores
                  else np.zeros((0,), np.float64))
        if scores.size == 0:
            return zero
        tps = np.concatenate(self._tp, axis=1)  # (T, E)
        order = np.argsort(-scores, kind="stable")
        tps = tps[:, order]
        tp_cum = np.cumsum(tps, axis=1)
        fp_cum = np.cumsum(~tps, axis=1)
        recall = tp_cum / self._num_gt  # (T, E)
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1)
        # 101-point interpolated AP (COCO), all thresholds at once.
        prec_interp = np.maximum.accumulate(precision[:, ::-1], axis=1)[:, ::-1]
        rec_grid = np.linspace(0, 1, 101)
        n_e = recall.shape[1]
        ap_by_thr = {}
        for ti, t in enumerate(self._thr_list):
            idx = np.searchsorted(recall[ti], rec_grid, side="left")
            p = np.where(idx < n_e, prec_interp[ti][np.minimum(idx, n_e - 1)],
                         0.0)
            ap_by_thr[t] = float(p.mean())
        out = {f"AP@{t}": ap_by_thr[t] for t in self.thresholds}
        out["mAP"] = float(np.mean([ap_by_thr[t] for t in self.coco_ladder]))
        return out
