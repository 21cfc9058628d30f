"""Combined BASI training losses (port of ``basi_tpu/train/loss.py``,
single device): ``basi_loss`` for the kernels mechanism,
``basi_roi_loss`` for the roi mechanism.

The kernels mechanism's terms:

* instance masks: Dice + BCE on the positive cells' masks, each cell's
  dynamic kernel applied to the mask features (sparse path); with
  ``max_pos_cells=0`` on the model's (N, S*S, h, w) candidate masks
  (``outputs.mask_logits``, the dense path), every cell weighted by its
  positivity;
* objectness: focal loss on the S x S grid;
* saliency: BCE + Dice (or the BASNet hybrid) on the fused map and each
  deep-supervision level, target = union of the valid GT masks max-pooled
  to /4, averaged over the heads.

The roi mechanism replaces the instance mask term with BCE + Dice in the
ROI frame and adds box regression, (1 - IoU) of the decoded cell boxes
at the positive cells (``basi_roi_loss``).
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
from basi_tpu_torch.ops.roi import box_iou, roi_align
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


ROI_TARGETS = ("sel_idx", "tgt_masks", "pos_sel", "score_tgt", "num_pos",
               "sel_boxes")


def basi_roi_loss(outputs: BASIOutputs, targets: dict[str, torch.Tensor],
                  gt_masks: torch.Tensor, gt_valid: torch.Tensor, *,
                  loss_kind: str = "bce_dice", mask_weight: float = 3.0,
                  score_weight: float = 1.0, box_weight: float = 1.0,
                  saliency_weight: float = 1.0
                  ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Total loss and metrics of the roi mechanism. ``targets``: the
    ``assign_targets_roi`` outputs by their ``ROI_TARGETS`` names, made
    before the forward (the mask head predicts at the assigned GT boxes);
    ``outputs.roi_mask_logits`` (N, P, R, R) are the predictions at those
    boxes. Terms: BCE + Dice in the ROI frame against the /4 GT masks
    cropped to the same boxes by the same ``roi_align`` and binarized at
    0.5; focal objectness; box regression, the mean (1 - IoU) of the
    decoded cell boxes against the GT boxes over the positive cells
    (metric ``box_iou``); the shared saliency branch."""
    n, p = targets["pos_sel"].shape
    roi_logits = outputs.roi_mask_logits
    r = roi_logits.shape[-1]
    h, w = targets["tgt_masks"].shape[-2:]
    crops = roi_align(targets["tgt_masks"].float().reshape(n * p, h, w, 1),
                      targets["sel_boxes"].reshape(n * p, 1, 4), r)
    tgt_roi = (crops.reshape(n, p, r, r) > 0.5).float()
    pos = targets["pos_sel"]
    inst_dice = dice_loss(roi_logits, tgt_roi, valid=pos)
    inst_bce = sigmoid_bce(roi_logits, tgt_roi,
                           weights=pos[..., None, None].expand_as(roi_logits))
    mask_loss = inst_dice + inst_bce
    score_loss = focal_loss(outputs.cell_scores, targets["score_tgt"])
    s = outputs.cell_scores.shape[1]
    pred_boxes = outputs.cell_boxes.reshape(n, s * s, 4).gather(
        1, targets["sel_idx"][..., None].expand(-1, -1, 4))
    iou = box_iou(pred_boxes.float(), targets["sel_boxes"].float())
    box_loss = ((1.0 - iou) * pos).sum() / pos.sum().clamp_min(1.0)
    sal = saliency_branch_loss(outputs, gt_masks, gt_valid, loss_kind)
    total = (mask_weight * mask_loss + score_weight * score_loss
             + box_weight * box_loss + saliency_weight * sal)
    metrics = {
        "loss": total,
        "mask_dice": inst_dice,
        "mask_bce": inst_bce,
        "score_focal": score_loss,
        "box_iou": box_loss,
        "saliency": sal,
        "num_pos_cells": targets["num_pos"].sum() / n,
    }
    return total, metrics
