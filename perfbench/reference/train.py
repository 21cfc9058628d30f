"""Plain PyTorch reference of BASI's training step (roi and kernels
mechanisms).

It takes the benchmark's inputs (the weights, each step's uint8 images,
full-resolution GT masks and their valid flags, and each step's flip
flags) and works out, in float32 from the configuration alone: the ingest
(flip, normalize), the instance statistics and the cell targets (a cell is
positive for the smallest instance whose centre region holds the cell's
centre; the first positive cells by index are kept), the train-mode
forward (BatchNorm on batch statistics, the saliency deep supervision, and
either the ROI mask head at the targets' GT boxes or the kept cells'
dynamic kernels applied to the mask features), the loss (BCE + Dice of the
instance masks, in the ROI frame for roi; focal objectness; for roi 1 - IoU
of the decoded boxes; BCE + Dice saliency), the gradient, the clip by global norm, SGD with momentum and
weight decay on every leaf under the cosine schedule with its linear
warm-up, and the EMA with its ramp.

The flips are the configuration's: each step draws seven uniform vectors
from a CPU generator seeded with ``train.seed`` (flip where the first is
under ``data.hflip_prob``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.basi import Ref, no_tf32, roi_align

EPS = 1e-6


def flips(seed: int, steps: int, n: int, prob: float) -> list[torch.Tensor]:
    """Each step's flip flags (n,) bool from the configuration's seed."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.rand(7, n, generator=gen)[0] < prob for _ in range(steps)]


def lr_at(step: int, t: dict, max_steps: int) -> float:
    """The cosine schedule with its linear warm-up, in float32."""
    f32 = torch.float32
    s = torch.tensor(float(step), dtype=f32)
    frac = (s / max(max_steps, 1)).clamp(0, 1)
    lr = t["lr"] * 0.5 * (1 + torch.cos(torch.tensor(math.pi, dtype=f32)
                                        * frac))
    if t["warmup_steps"] > 0:
        lr = lr * (s / t["warmup_steps"]).clamp(0, 1)
    return float(lr.to(f32))


def instance_stats(masks: torch.Tensor, valid: torch.Tensor) -> dict:
    """(N, M, H, W) 0/1 masks -> per instance (N, M): centre of mass,
    extents between the outermost pixel centres, the box around them (half
    a pixel out, clipped; zero when invalid), area, valid."""
    h, w = masks.shape[-2:]
    m = masks.float()
    ys = (torch.arange(h, device=m.device) + 0.5) / h
    xs = (torch.arange(w, device=m.device) + 0.5) / w
    rows, cols = m.sum(-1), m.sum(-2)
    area = rows.sum(-1)
    cy = (rows * ys).sum(-1) / area.clamp_min(EPS)
    cx = (cols * xs).sum(-1) / area.clamp_min(EPS)
    ymin = torch.where(rows > 0, ys, 2.0).amin(-1)
    ymax = torch.where(rows > 0, ys, -2.0).amax(-1)
    xmin = torch.where(cols > 0, xs, 2.0).amin(-1)
    xmax = torch.where(cols > 0, xs, -2.0).amax(-1)
    ok = (valid > 0) & (area > 0)
    z = torch.zeros_like(cy)
    return {"cy": cy, "cx": cx, "eh": (ymax - ymin).clamp_min(0),
            "ew": (xmax - xmin).clamp_min(0), "area": area, "valid": ok,
            "y0": torch.where(ok, (ymin - 0.5 / h).clamp_min(0), z),
            "x0": torch.where(ok, (xmin - 0.5 / w).clamp_min(0), z),
            "y1": torch.where(ok, (ymax + 0.5 / h).clamp_max(1), z),
            "x1": torch.where(ok, (xmax + 0.5 / w).clamp_max(1), z)}


def targets(masks_u8, valid, flip, grid: int, stride: int, cells: int,
            sigma: float = 0.2) -> dict:
    """The roi targets of a batch (full-resolution masks, before the
    flip): the /4 GT masks (flipped), each cell's positivity, the first
    ``cells`` cells (positives first, by index), their instances' /4 masks
    and GT boxes."""
    st = instance_stats(masks_u8, valid)
    fx = flip[:, None]
    x0, x1 = st["x0"], st["x1"]
    st["cx"] = torch.where(fx, 1 - st["cx"], st["cx"])
    st["x0"] = torch.where(fx, 1 - x1, x0)
    st["x1"] = torch.where(fx, 1 - x0, x1)
    small = F.max_pool2d(masks_u8.float().flatten(0, 1), stride).unflatten(
        0, masks_u8.shape[:2])
    small = torch.where(flip[:, None, None, None], small.flip(-1), small)
    cc = (torch.arange(grid, device=small.device) + 0.5) / grid
    hh = (sigma * st["eh"] * 0.5).clamp_min(0.5 / grid)
    hw = (sigma * st["ew"] * 0.5).clamp_min(0.5 / grid)
    hit = (((cc[:, None] - st["cy"][..., None, None]).abs() <= hh[..., None, None])
           & ((cc[None, :] - st["cx"][..., None, None]).abs() <= hw[..., None, None])
           & st["valid"][..., None, None])  # (N, M, S, S)
    rank = torch.where(hit, st["area"][..., None, None], math.inf)
    winner = rank.argmin(1).flatten(1)  # (N, S*S)
    pos = hit.any(1).flatten(1).float()
    sel = torch.argsort(pos, dim=1, descending=True, stable=True)[:, :cells]
    pos_sel = pos.gather(1, sel)
    win = winner.gather(1, sel)
    rows = torch.arange(small.shape[0], device=small.device)[:, None]
    boxes = torch.stack([st["y0"], st["x0"], st["y1"], st["x1"]], -1)
    return {"small": small, "valid": valid.float(), "pos_all": pos,
            "score_tgt": pos.reshape(-1, 1, grid, grid), "sel": sel,
            "pos": pos_sel, "tgt": small[rows, win] * pos_sel[..., None, None],
            "boxes": boxes.gather(1, win[..., None].expand(-1, -1, 4))
            * pos_sel[..., None]}


def _bce(logits, t):
    return logits.clamp_min(0) - logits * t + torch.log1p(torch.exp(-logits.abs()))


def _dice(logits, t):
    p = torch.sigmoid(logits)
    inter = (p * t).sum((-2, -1))
    return 1 - (2 * inter + EPS) / ((p * p).sum((-2, -1))
                                    + (t * t).sum((-2, -1)) + EPS)


def _box_iou(a, b):
    iy = (torch.minimum(a[..., 2], b[..., 2])
          - torch.maximum(a[..., 0], b[..., 0])).clamp_min(0)
    ix = (torch.minimum(a[..., 3], b[..., 3])
          - torch.maximum(a[..., 1], b[..., 1])).clamp_min(0)
    inter = iy * ix
    area = lambda q: ((q[..., 2] - q[..., 0]).clamp_min(0)  # noqa: E731
                      * (q[..., 3] - q[..., 1]).clamp_min(0))
    return inter / (area(a) + area(b) - inter).clamp_min(EPS)


def _focal(score, t):
    pr = torch.sigmoid(score)
    p_t = pr * t + (1 - pr) * (1 - t)
    a_t = 0.25 * t + 0.75 * (1 - t)
    return (a_t * (1 - p_t) ** 2 * _bce(score, t)).sum() / t.sum().clamp_min(1)


def _saliency(sal, aux, tg):
    union = (tg["small"] * tg["valid"][..., None, None]).amax(1)  # (N, h, w)
    heads = [sal] + list(aux)
    return sum(_bce(q[:, 0], union).mean() + _dice(q[:, 0], union).mean()
               for q in heads) / len(heads)


def _mask_terms(logits, tgt, pos):
    dice = (_dice(logits, tgt) * pos).sum() / pos.sum().clamp_min(EPS)
    wts = pos[..., None, None].expand_as(logits)
    return dice + (_bce(logits, tgt) * wts).sum() / wts.sum().clamp_min(EPS)


def kernels_loss(out, tg, weights: dict) -> torch.Tensor:
    """BCE + Dice of the kept cells' masks against their instances' /4
    masks, focal objectness, BCE + Dice saliency, weighted."""
    sal, aux, score, logits = out
    return (weights["mask"] * _mask_terms(logits, tg["tgt"], tg["pos"])
            + weights["score"] * _focal(score, tg["score_tgt"])
            + weights["saliency"] * _saliency(sal, aux, tg))


def roi_loss(out, tg, weights: dict) -> torch.Tensor:
    """BCE + Dice of the ROI masks, focal objectness, box 1 - IoU, BCE +
    Dice saliency (fused and each level, averaged), weighted."""
    sal, aux, score, cell_boxes, logits = out
    n, p, r, _ = logits.shape
    h, w = tg["tgt"].shape[-2:]
    crops = roi_align(tg["tgt"].reshape(n * p, 1, h, w),
                      tg["boxes"].reshape(n * p, 1, 4), r)
    t_roi = (crops.reshape(n, p, r, r) > 0.5).float()
    pos = tg["pos"]
    s = score.shape[-1]
    pred = cell_boxes.reshape(n, s * s, 4).gather(
        1, tg["sel"][..., None].expand(-1, -1, 4))
    box = ((1 - _box_iou(pred, tg["boxes"])) * pos).sum() / pos.sum().clamp_min(1)
    return (weights["mask"] * _mask_terms(logits, t_roi, pos)
            + weights["score"] * _focal(score, tg["score_tgt"])
            + weights["box"] * box
            + weights["saliency"] * _saliency(sal, aux, tg))


def train_reference(p0: dict, cfg: dict, batches: list, flip_flags: list,
                    max_steps: int, precision: str = "f32") -> dict:
    """Three (or ``len(batches)``) steps from the weights ``p0`` on
    ``batches`` [(images u8 (N, H, W, 3), masks u8 (N, M, H, W), valid
    (N, M))] with ``flip_flags``: {"loss": [per step], "grad": {leaf:
    the first step's gradient as the optimizer gets it}, "params": {leaf:
    after the last step}, "ema": {leaf: after the last step}}."""
    m, t, d = cfg["model"], cfg["train"], cfg["data"]
    leaves = {k: v.detach().clone().float().requires_grad_()
              for k, v in p0.items() if not k.endswith(
                  ("running_mean", "running_var", "num_batches_tracked"))}
    ref = Ref(leaves, m, d["mean"], d["std"], cfg["infer"], precision)
    weights = {"mask": t["mask_loss_weight"], "score": t["score_loss_weight"],
               "box": t["box_loss_weight"], "saliency": t["saliency_loss_weight"]}
    ema = {k: v.detach().clone() for k, v in leaves.items()}
    trace = {k: None for k in leaves}
    out = {"loss": []}
    cells = t["max_pos_cells"] if t["max_pos_cells"] > 0 else 64
    with no_tf32():
        for step, ((img, masks, valid), flip) in enumerate(zip(batches,
                                                               flip_flags)):
            flip = flip.to(img.device)
            x = img.float() / 255.0
            x = torch.where(flip[:, None, None, None], x.flip(2), x)
            x = ((x - ref.mean) / ref.std).permute(0, 3, 1, 2)
            tg = targets(masks, valid, flip, m["grid_size"], 4, cells)
            out.setdefault("num_pos", []).append(
                float(tg["pos_all"].sum()) / img.shape[0])
            if m["instance_mechanism"] == "roi":
                loss = roi_loss(ref.forward_train(x, tg["boxes"]), tg,
                                weights)
            else:
                loss = kernels_loss(ref.forward_train_kernels(x, tg["sel"]),
                                    tg, weights)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            out["loss"].append(float(loss.detach()))
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            if norm >= t["grad_clip_norm"]:
                grads = [g / norm.float() * t["grad_clip_norm"] for g in grads]
            if step == 0:
                out["grad"] = {k: g.detach().clone()
                               for k, g in zip(leaves, grads)}
            lr = lr_at(step, t, max_steps)
            with torch.no_grad():
                for (k, v), g in zip(leaves.items(), grads):
                    dp = g + t["weight_decay"] * v
                    trace[k] = dp if trace[k] is None else (
                        t["momentum"] * trace[k] + dp)
                    v -= lr * trace[k]
                dk = min(t["ema_decay"], (1 + step + 1) / (10 + step + 1))
                for k, v in leaves.items():
                    ema[k].mul_(dk).add_(v.detach(), alpha=1 - dk)
    out["params"] = {k: v.detach() for k, v in leaves.items()}
    out["ema"] = ema
    return out
