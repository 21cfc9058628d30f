"""Combined BASI training loss (port of ``basi_tpu/train/loss.py``, kernels
mechanism, single device).

* instance masks: Dice + BCE on the positive cells' masks, each cell's
  dynamic kernel applied to the mask features (sparse path); with
  ``max_pos_cells=0`` on the model's (N, S*S, h, w) candidate masks
  (``outputs.mask_logits``, the dense path), every cell weighted by its
  positivity;
* objectness: focal loss on the S x S grid;
* saliency: BCE + Dice (or the BASNet hybrid) on the fused map and each
  deep-supervision level, target = union of the valid GT masks max-pooled
  to /4, averaged over the heads.
"""

from __future__ import annotations

import torch

from basi_tpu_torch.models.basi import BASIOutputs
from basi_tpu_torch.ops.losses import (
    dice_loss,
    focal_loss,
    saliency_loss,
    sigmoid_bce,
)
from basi_tpu_torch.ops.resize import maxpool_hw
from basi_tpu_torch.train.targets import assign_targets, assign_targets_sparse


def saliency_branch_loss(outputs: BASIOutputs, gt_masks: torch.Tensor,
                         gt_valid: torch.Tensor,
                         loss_kind: str = "bce_dice") -> torch.Tensor:
    """Fused map + each aux level vs the union of the valid GT masks
    (max-pooled to the saliency resolution), averaged over the heads."""
    union = (gt_masks * gt_valid[..., None, None].to(gt_masks.dtype)).amax(1)
    gh, gw = union.shape[1:]
    sh, sw = outputs.saliency_logits.shape[1:3]
    union_small = maxpool_hw(union, gh // sh, gw // sw).float()
    sal = saliency_loss(outputs.saliency_logits, union_small, loss_kind)
    for aux in outputs.saliency_aux:
        sal = sal + saliency_loss(aux, union_small, loss_kind)
    return sal / (1 + len(outputs.saliency_aux))


def basi_loss(outputs: BASIOutputs, gt_masks: torch.Tensor,
              gt_valid: torch.Tensor, *, loss_kind: str = "bce_dice",
              mask_weight: float = 3.0, score_weight: float = 1.0,
              saliency_weight: float = 1.0, center_sigma: float = 0.2,
              max_pos_cells: int = 64, gt_stats: dict | None = None
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Total loss and metrics for a batch. gt_masks: (N, M, H, W) at any
    integer multiple of the mask-feature resolution (the step passes /4);
    gt_valid: (N, M); gt_stats: full-resolution ``instance_stats``.
    ``outputs.mask_logits`` present: the dense path (``max_pos_cells`` is
    then not read)."""
    s = outputs.cell_scores.shape[1]
    n, mh, mw, e = outputs.mask_feats.shape
    if outputs.mask_logits is None:
        if max_pos_cells <= 0:
            raise ValueError("max_pos_cells=0 needs the model's candidate "
                             "masks (forward with_candidates=True)")
        sel_idx, tgt_masks, pos_sel, score_tgt, num_pos = \
            assign_targets_sparse(gt_masks, gt_valid, grid_size=s,
                                  mask_hw=(mh, mw), center_sigma=center_sigma,
                                  max_pos_cells=max_pos_cells, stats=gt_stats)
        kernels = outputs.cell_kernels.reshape(n, s * s, e)
        sel_kernels = kernels.gather(1, sel_idx[..., None].expand(-1, -1, e))
        # f32 products of the compute-dtype operands, as JAX's
        # preferred_element_type=f32
        logits = torch.einsum("nhwe,npe->nphw", outputs.mask_feats.float(),
                              sel_kernels.float())
        total_pos = num_pos.sum()
    else:
        tgt_masks, pos_sel, score_tgt = assign_targets(
            gt_masks, gt_valid, grid_size=s, mask_hw=(mh, mw),
            center_sigma=center_sigma, stats=gt_stats)
        logits = outputs.mask_logits
        total_pos = pos_sel.sum()
    inst_dice = dice_loss(logits, tgt_masks, valid=pos_sel)
    inst_bce = sigmoid_bce(logits, tgt_masks,
                           weights=pos_sel[..., None, None].expand_as(logits))
    mask_loss = inst_dice + inst_bce
    score_loss = focal_loss(outputs.cell_scores, score_tgt)
    sal = saliency_branch_loss(outputs, gt_masks, gt_valid, loss_kind)
    total = (mask_weight * mask_loss + score_weight * score_loss
             + saliency_weight * sal)
    metrics = {
        "loss": total,
        "mask_dice": inst_dice,
        "mask_bce": inst_bce,
        "score_focal": score_loss,
        "saliency": sal,
        "num_pos_cells": total_pos / n,
    }
    return total, metrics
