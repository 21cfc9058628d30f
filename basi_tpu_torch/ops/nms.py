"""Mask NMS and slot selection (port of ``basi_tpu/ops/nms.py``).

The JAX functions work on one image and are vmapped; here every function
takes leading batch dims written out, so a batch is one set of launches.
Top-k is a stable descending sort, so ties keep the lower index first as
``jax.lax.top_k`` does — Matrix NMS's tie-break and the slot packing both
depend on that order.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last dim, descending, lower index first among
    ties (``jax.lax.top_k`` order)."""
    idx = torch.sort(-x, dim=-1, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def mask_iou_matrix(masks_a: torch.Tensor, masks_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of two mask stacks: (..., A, H, W), (..., B, H, W) ->
    (..., A, B) f32. The products run in f32: intersections are pixel counts
    up to H*W, which bf16 cannot hold exactly."""
    a = masks_a.flatten(-2).float()
    b = masks_b.flatten(-2).float()
    inter = a @ b.transpose(-1, -2)
    area_a = a.sum(-1)[..., :, None]
    area_b = b.sum(-1)[..., None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=_EPS)


def matrix_nms(masks: torch.Tensor, scores: torch.Tensor, sigma: float = 2.0,
               kind: str = "gauss") -> torch.Tensor:
    """Matrix NMS decayed scores (SOLOv2). masks: (..., K, H, W) binary;
    scores: (..., K). Candidates need not be sorted: candidate i suppresses
    j when it scores higher, or ties and comes first."""
    iou = mask_iou_matrix(masks, masks)  # (..., K, K)
    k = scores.shape[-1]
    idx = torch.arange(k, device=scores.device)
    si, sj = scores[..., :, None], scores[..., None, :]
    higher = (si > sj) | ((si == sj) & (idx[:, None] < idx[None, :]))
    sup_iou = iou * higher.float()  # (i, j): IoU with higher-scored i
    comp_iou = sup_iou.amax(dim=-2)  # each i's own worst suppressor
    if kind == "gauss":
        decay = torch.exp(-(sup_iou ** 2 - comp_iou[..., :, None] ** 2) * sigma)
    else:  # linear
        decay = (1.0 - sup_iou) / torch.clamp(1.0 - comp_iou[..., :, None],
                                              min=_EPS)
    decay = torch.where(higher, decay, torch.ones_like(decay)).amin(dim=-2)
    return scores * decay


def greedy_nms(masks: torch.Tensor, scores: torch.Tensor,
               iou_threshold: float = 0.5) -> torch.Tensor:
    """Exact greedy mask NMS, highest score first: keep (..., K) int32 0/1.
    The loop runs over the K candidates, batched over the leading dims."""
    k = scores.shape[-1]
    order = torch.sort(-scores, dim=-1, stable=True).indices
    iou = mask_iou_matrix(masks, masks)
    iou = torch.gather(iou, -2, order[..., :, None].expand(iou.shape))
    iou = torch.gather(iou, -1, order[..., None, :].expand(iou.shape))
    keep_sorted = torch.zeros(scores.shape, dtype=torch.bool,
                              device=scores.device)
    for i in range(k):
        overlap = (keep_sorted & (iou[..., i, :] > iou_threshold)).any(-1)
        keep_sorted[..., i] = ~overlap
    keep = torch.zeros_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return keep.to(torch.int32)


def select_instances_from_kernels(
    mask_feats: torch.Tensor,
    kernels: torch.Tensor,
    cell_scores: torch.Tensor,
    num_slots: int = 20,
    score_threshold: float = 0.1,
    mask_threshold: float = 0.5,
    nms: str = "matrix",
    nms_sigma: float = 2.0,
    nms_iou_threshold: float = 0.5,
    pre_top_k: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Instance selection for a batch: mask_feats (N, H, W, E), kernels
    (N, C, E), cell_scores (N, C) logits. The pre_top_k cells by objectness
    apply their kernels (one f32 einsum, rounded to the features' dtype),
    then rescoring, NMS and slot packing. Returns slot masks (N, num_slots,
    H, W) probabilities in the features' dtype and slot scores
    (N, num_slots) f32; empty slots score 0."""
    probs = torch.sigmoid(cell_scores.float())
    obj_scores, top_idx = topk_stable(probs, min(pre_top_k, probs.shape[-1]))
    top_k = torch.gather(
        kernels, 1, top_idx[..., None].expand(-1, -1, kernels.shape[-1]))
    top_logits = torch.einsum("nhwe,nke->nkhw", mask_feats.float(),
                              top_k.float()).to(mask_feats.dtype)
    return _select_from_probs(
        torch.sigmoid(top_logits), obj_scores, num_slots, score_threshold,
        mask_threshold, nms, nms_sigma, nms_iou_threshold)


def select_instances_from_probs(
    mask_probs: torch.Tensor,
    obj_scores: torch.Tensor,
    num_slots: int = 20,
    score_threshold: float = 0.1,
    mask_threshold: float = 0.5,
    nms: str = "matrix",
    nms_sigma: float = 2.0,
    nms_iou_threshold: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Selection for mechanisms that hold each candidate's probability
    mask in the model frame already (the roi mechanism pastes its
    ROI-frame masks to /4 first): mask_probs (N, C, H, W) probabilities,
    obj_scores (N, C) probabilities. Quality rescoring, NMS and slot
    packing; returns the slot contract of
    ``select_instances_from_kernels``."""
    return _select_from_probs(
        mask_probs, obj_scores.float(), num_slots, score_threshold,
        mask_threshold, nms, nms_sigma, nms_iou_threshold)


def _select_from_probs(top_probs, obj_scores, num_slots, score_threshold,
                       mask_threshold, nms, nms_sigma, nms_iou_threshold):
    """Quality rescoring + NMS + slot packing. top_probs (N, K, H, W) in
    the compute dtype, obj_scores (N, K) f32; sums accumulate in f32."""
    top_binary = (top_probs > mask_threshold).to(top_probs.dtype)
    area = top_binary.sum(dim=(-2, -1), dtype=torch.float32)
    quality = (top_probs * top_binary).sum(
        dim=(-2, -1), dtype=torch.float32) / torch.clamp(area, min=_EPS)
    top_scores = obj_scores * quality * (area > 0)
    zero = torch.zeros((), device=top_scores.device)
    top_scores = torch.where(top_scores >= score_threshold, top_scores, zero)

    if nms in ("matrix", "matrix_linear"):
        final = matrix_nms(top_binary, top_scores, sigma=nms_sigma,
                           kind="linear" if nms == "matrix_linear" else "gauss")
    elif nms == "greedy":
        final = greedy_nms(top_binary, top_scores, nms_iou_threshold) * top_scores
    else:
        raise ValueError(f"unknown nms {nms!r}")
    final = torch.where(final >= score_threshold, final, zero)

    n, kk = final.shape
    slot_scores, slot_pos = topk_stable(final, min(num_slots, kk))
    slot_masks = torch.gather(
        top_probs, 1,
        slot_pos[..., None, None].expand(-1, -1, *top_probs.shape[-2:]))
    if kk < num_slots:  # fewer candidates than slots: pad with empties
        pad = num_slots - kk
        slot_scores = torch.cat(
            [slot_scores, slot_scores.new_zeros((n, pad))], dim=1)
        slot_masks = torch.cat(
            [slot_masks, slot_masks.new_zeros((n, pad) + slot_masks.shape[2:])],
            dim=1)
    slot_masks = slot_masks * (slot_scores > 0)[..., None, None].to(slot_masks.dtype)
    return slot_masks, slot_scores
