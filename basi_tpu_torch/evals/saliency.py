"""Saliency-map metrics (port of ``basi_tpu/evals/saliency.py``): MAE, the
F- and E-measure curves, the structure measure S, the relaxed boundary F
and the weighted F-measure, each per image over an optional ``valid``
content mask.

Every function takes a batch (N, H, W) and reduces over the trailing two
dims; nothing loops over images in Python, so a batch is one set of
launches. The threshold sweeps share one histogram pass; its counts are
sums of 0/1 weights, exact in f32 whatever order ``scatter_add_`` adds them
in. The min pools pad with +inf and the max pools with -inf, as the
reference's ``reduce_window``. The weighted F-measure's exact Euclidean
distance transform is two 1-D min-plus passes, chunked along the axis not
reduced; the ties go to the first minimum (smallest x', then y'), as
``jnp.argmin``'s. Its 7x7 Gaussian is written as f32 multiply-adds over
shifted slices, so no global TF32 or cuDNN setting changes it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from basi_tpu_torch.utils.profiling import span

_EPS = 1e-8
_WF_BIG = 1e12
# Elements of one EDT pass's (images, rows, rows', columns) cost block:
# 1 GiB of f32. A chunk takes as many images of the batch as fit.
_EDT_BLOCK = 2 ** 28
# the weighted F's importance decay, log(0.5) / 5 with f32's two roundings
_DECAY = float(np.float32(np.log(np.float32(0.5))) / np.float32(5.0))


def _sum_hw(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=(-2, -1))


def _binary(target: torch.Tensor) -> torch.Tensor:
    return (target.float() > 0.5).float()


def _weights(pred: torch.Tensor, valid) -> torch.Tensor:
    return torch.ones_like(pred, dtype=torch.float32) if valid is None \
        else valid.float()


def _f_beta(precision, recall, beta2):
    return ((1 + beta2) * precision * recall
            / torch.clamp(beta2 * precision + recall, min=_EPS))


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error between probability maps, over every pixel."""
    return torch.mean(torch.abs(pred.float() - target.float()))


def f_measure(pred: torch.Tensor, target: torch.Tensor, beta2: float = 0.3,
              num_thresholds: int = 255):
    """(max-F, mean-F) of the image-averaged F curve over thresholds
    (k + 0.5)/T, as one broadcast comparison: (T, N, H, W)."""
    p = pred.float()
    t = _binary(target)
    thr = (torch.arange(num_thresholds, dtype=torch.float32,
                        device=p.device) + 0.5) / num_thresholds
    binp = (p[None] >= thr[:, None, None, None]).float()
    tp = _sum_hw(binp * t[None])  # (T, N)
    precision = tp / torch.clamp(_sum_hw(binp), min=_EPS)
    recall = tp / torch.clamp(_sum_hw(t)[None], min=_EPS)
    f_per_thr = _f_beta(precision, recall, beta2).mean(dim=1)
    return f_per_thr.max(), f_per_thr.mean()


def _threshold_hist_counts(pred, target, num_thresholds, valid):
    """One histogram pass for the threshold sweeps: (tp, pp, gt_area,
    n_valid); tp and pp (N, T) count (pred >= k/T & gt) and (pred >= k/T)
    for k = 0..T-1, gt_area and n_valid are (N, 1)."""
    n = pred.shape[0]
    p = pred.float().reshape(n, -1)
    w = _weights(pred, valid).reshape(n, -1)
    t = _binary(target).reshape(n, -1) * w
    # bin b holds p in [b/T, (b+1)/T); pred >= k/T <=> bin >= k
    bins = torch.clamp((p * num_thresholds).to(torch.int64), 0,
                       num_thresholds - 1)
    zeros = torch.zeros((n, num_thresholds), dtype=torch.float32,
                        device=p.device)
    all_h = zeros.scatter_add(1, bins, w)
    pos_h = zeros.scatter_add(1, bins, t)

    def at_least(h):  # (N, T): #(bin >= k)
        return torch.flip(torch.cumsum(torch.flip(h, (1,)), dim=1), (1,))

    return (at_least(pos_h), at_least(all_h), t.sum(1, keepdim=True),
            w.sum(1, keepdim=True))


def f_measure_hist(pred: torch.Tensor, target: torch.Tensor,
                   beta2: float = 0.3, num_thresholds: int = 64,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """Per-image F-beta curve over thresholds k/T, k = 1..T-1: (T-1, N).
    Threshold 0 (every pixel positive) is left out."""
    tp, pp, gt_area, _ = _threshold_hist_counts(pred, target, num_thresholds,
                                                valid)
    precision = tp / torch.clamp(pp, min=_EPS)
    recall = tp / torch.clamp(gt_area, min=_EPS)
    return _f_beta(precision, recall, beta2)[:, 1:].T


def e_measure_hist(pred: torch.Tensor, target: torch.Tensor,
                   num_thresholds: int = 64,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """Per-image enhanced-alignment curve over thresholds k/T, k = 1..T-1:
    (T-1, N). A binarized map's alignment takes four values, one per
    (pred, gt) cell, so the curve comes from the histogram counts. Empty GT
    scores the predicted-background share, full GT the foreground share;
    values are clamped to 1."""
    tp, pp, gt_area, n = _threshold_hist_counts(pred, target, num_thresholds,
                                                valid)
    fp = pp - tp
    fn = gt_area - tp
    tn = n - pp - fn
    mu_p = pp / torch.clamp(n, min=1.0)
    mu_g = gt_area / torch.clamp(n, min=1.0)

    def enhanced(phi_p, phi_g):
        align = (2.0 * phi_p * phi_g
                 / torch.clamp(phi_p ** 2 + phi_g ** 2, min=_EPS))
        return (align + 1.0) ** 2 / 4.0

    total = (tp * enhanced(1.0 - mu_p, 1.0 - mu_g)
             + fp * enhanced(1.0 - mu_p, -mu_g)
             + fn * enhanced(-mu_p, 1.0 - mu_g)
             + tn * enhanced(-mu_p, -mu_g))
    norm = torch.clamp(n - 1.0, min=_EPS)
    e = total / norm
    e = torch.where(gt_area <= 0.0, (n - pp) / norm, e)
    e = torch.where(gt_area >= n, pp / norm, e)
    return torch.clamp(e, max=1.0)[:, 1:].T


def _bcast(x: torch.Tensor) -> torch.Tensor:
    """Per-image (N,) -> (N, 1, 1)."""
    return x[:, None, None]


def _masked_moments(x, w, ddof: int = 0):
    """(mean, var) over the indicator ``w``, per image."""
    n = _sum_hw(w)
    mean = _sum_hw(x * w) / torch.clamp(n, min=_EPS)
    var = (_sum_hw((x - _bcast(mean)) ** 2 * w)
           / torch.clamp(n - float(ddof), min=_EPS))
    return mean, var


def _region_ssim(p, t, w):
    """The S-measure's SSIM of one centroid quadrant (ddof=1 moments)."""
    n = _sum_hw(w)
    safe_n = torch.clamp(n, min=_EPS)
    x = _sum_hw(p * w) / safe_n
    y = _sum_hw(t * w) / safe_n
    nm1 = torch.clamp(n - 1.0, min=_EPS)
    dp, dt = p - _bcast(x), t - _bcast(y)
    sig_x = _sum_hw(dp ** 2 * w) / nm1
    sig_y = _sum_hw(dt ** 2 * w) / nm1
    sig_xy = _sum_hw(dp * dt * w) / nm1
    a = 4.0 * x * y * sig_xy
    b = (x ** 2 + y ** 2) * (sig_x + sig_y)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return torch.where(a != 0.0, a / (b + _EPS),
                       torch.where(b == 0.0, one, zero))


def _s_object_term(p, ind):
    """2 * mean / (mean^2 + 1 + std + eps) of ``p`` over ``ind``."""
    x, var = _masked_moments(p, ind)
    return 2.0 * x / (x ** 2 + 1.0 + torch.sqrt(var) + _EPS)


def s_measure(pred: torch.Tensor, target: torch.Tensor,
              valid: torch.Tensor | None = None,
              alpha: float = 0.5) -> torch.Tensor:
    """Per-image structure measure S = alpha * S_object + (1 - alpha) *
    S_region: (N,) f32. The region term's four quadrants at the GT
    centroid are index masks; ``valid`` restricts the moments, the centroid
    and the quadrant weights to the content region."""
    p = pred.float()
    t = _binary(target)
    w = _weights(pred, valid)
    h, wd = p.shape[-2:]
    n = torch.clamp(_sum_hw(w), min=1.0)
    y = _sum_hw(t * w) / n
    mean_p = _sum_hw(p * w) / n

    fg_ind = t * w
    bg_ind = (1.0 - t) * w
    s_obj = (y * _s_object_term(p * fg_ind, fg_ind)
             + (1.0 - y) * _s_object_term((1.0 - p) * bg_ind, bg_ind))

    nf = torch.clamp(_sum_hw(fg_ind), min=_EPS)
    rows = torch.arange(h, dtype=torch.float32, device=p.device)[:, None]
    cols = torch.arange(wd, dtype=torch.float32, device=p.device)[None, :]
    cy = torch.round(_sum_hw(rows * fg_ind) / nf) + 1.0
    cx = torch.round(_sum_hw(cols * fg_ind) / nf) + 1.0
    top = (rows < _bcast(cy)).float()
    left = (cols < _bcast(cx)).float()
    s_reg = torch.zeros_like(y)
    for q in (top * left, top * (1 - left), (1 - top) * left,
              (1 - top) * (1 - left)):
        qw = q * w
        s_reg = s_reg + _sum_hw(qw) / n * _region_ssim(p, t, qw)

    s = torch.clamp(alpha * s_obj + (1.0 - alpha) * s_reg, min=0.0)
    s = torch.where(y <= 0.0, 1.0 - mean_p, s)
    return torch.where(y >= 1.0, mean_p, s)


def _pool3(x: torch.Tensor, size: int, op: str) -> torch.Tensor:
    """Same-padded (size x size) min or max pool of (N, H, W) f32; the
    padding never wins (-inf for max, +inf for min)."""
    if op == "max":
        return F.max_pool2d(x[:, None], size, stride=1, padding=size // 2)[:, 0]
    return -F.max_pool2d(-x[:, None], size, stride=1, padding=size // 2)[:, 0]


def boundary_f_measure(pred: torch.Tensor, target: torch.Tensor,
                       valid: torch.Tensor | None = None,
                       threshold: float = 0.5, rho: int = 3,
                       beta2: float = 0.3) -> torch.Tensor:
    """Per-image relaxed boundary F at one binarization: (N,) f32.
    Boundaries are foreground minus its 3x3 erosion (outside the image is
    background); a boundary pixel counts when one of the other side lies
    within ``rho``. Both boundaries empty scores 1."""
    p = (pred.float() > threshold).float()
    t = _binary(target)
    if valid is not None:
        w = valid.float()
        p = p * w
        t = t * w
    pb = p * (1.0 - _pool3(p, 3, "min"))
    tb = t * (1.0 - _pool3(t, 3, "min"))
    win = 2 * rho + 1
    tb_near = _pool3(tb, win, "max")
    pb_near = _pool3(pb, win, "max")
    n_pb = _sum_hw(pb)
    n_tb = _sum_hw(tb)
    prec = _sum_hw(pb * tb_near) / torch.clamp(n_pb, min=_EPS)
    rec = _sum_hw(tb * pb_near) / torch.clamp(n_tb, min=_EPS)
    f = _f_beta(prec, rec, beta2)
    return torch.where((n_pb == 0) & (n_tb == 0), torch.ones_like(f), f)


def _edt_payload(fg: torch.Tensor, payload: torch.Tensor,
                 chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact squared EDT to the nearest ``fg`` pixel, carrying ``payload``.

    fg (..., H, W) 0/1 and payload (..., H, W) f32 -> (dist2,
    payload_at_nearest), both (..., H, W) f32. Without any fg pixel dist2
    is about ``_WF_BIG``. Ties: smallest x', then smallest y'. Each pass
    is a broadcast min over one axis, ``chunk`` lines of the other axis
    (and as many images as ``_EDT_BLOCK`` allows) at a time."""
    lead = fg.shape[:-2]
    h, w = fg.shape[-2:]
    fg = fg.reshape(-1, h, w)
    payload = payload.reshape(-1, h, w).float()
    n, dev = fg.shape[0], fg.device
    ii = torch.arange(h, dtype=torch.float32, device=dev)
    d2v = (ii[:, None] - ii[None, :]) ** 2  # (H, H')
    block = torch.where(fg > 0, 0.0, _WF_BIG).float()
    dist1 = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    pay1 = torch.empty_like(dist1)
    wc = min(chunk, w)
    imgs = max(1, _EDT_BLOCK // (h * h * wc))
    for i in range(0, n, imgs):
        for c in range(0, w, wc):
            blk = block[i:i + imgs, :, c:c + wc]  # (n', H', Wc)
            cost = d2v[None, :, :, None] + blk[:, None, :, :]
            d, arg = torch.min(cost, dim=2)  # (n', H, Wc): y' of nearest
            dist1[i:i + imgs, :, c:c + wc] = d
            pay1[i:i + imgs, :, c:c + wc] = torch.gather(
                payload[i:i + imgs, :, c:c + wc], 1, arg)
            del cost
    jj = torch.arange(w, dtype=torch.float32, device=dev)
    d2h = (jj[:, None] - jj[None, :]) ** 2  # (W, W')
    dist2 = torch.empty_like(dist1)
    pay2 = torch.empty_like(dist1)
    hc = min(chunk, h)
    imgs = max(1, _EDT_BLOCK // (hc * w * w))
    for i in range(0, n, imgs):
        for r in range(0, h, hc):
            d1 = dist1[i:i + imgs, r:r + hc]  # (n', Hc, W')
            cost = d2h[None, None] + d1[:, :, None, :]
            d, arg = torch.min(cost, dim=3)  # (n', Hc, W): x' of nearest
            dist2[i:i + imgs, r:r + hc] = d
            pay2[i:i + imgs, r:r + hc] = torch.gather(
                pay1[i:i + imgs, r:r + hc], 2, arg)
            del cost
    return dist2.reshape(*lead, h, w), pay2.reshape(*lead, h, w)


def _gauss7(x: torch.Tensor, sigma: float = 5.0) -> torch.Tensor:
    """7x7 Gaussian of (..., H, W) f32, zero-padded borders (MATLAB's
    ``imfilter`` default), separable: rows first, then columns. The taps
    are f32 multiply-adds over shifted slices, so no TF32 or cuDNN setting
    reaches them."""
    i = torch.arange(7, dtype=torch.float32, device=x.device) - 3.0
    k1 = torch.exp(-(i ** 2) / (2.0 * sigma * sigma))
    k1 = k1 / torch.sqrt(torch.sum(torch.outer(k1, k1)))
    h, w = x.shape[-2:]
    xp = F.pad(x, (0, 0, 3, 3))
    y = k1[0] * xp[..., 0:h, :]
    for d in range(1, 7):
        y = y + k1[d] * xp[..., d:d + h, :]
    yp = F.pad(y, (3, 3))
    out = k1[0] * yp[..., 0:w]
    for d in range(1, 7):
        out = out + k1[d] * yp[..., d:d + w]
    return out


def weighted_f_measure(pred: torch.Tensor, target: torch.Tensor,
                       valid: torch.Tensor | None = None,
                       beta2: float = 1.0) -> torch.Tensor:
    """Per-image weighted F-measure (Margolin, Zelnik-Manor and Tal,
    2014): (N,) f32. Each pixel's error is spread from its nearest GT pixel
    (the EDT's payload), smoothed by the Gaussian and weighted by an
    importance that decays with the distance to the foreground. ``valid``
    masking equals
    evaluating the content crop zero-padded to (H, W). Empty GT scores 1
    when the binarized prediction is empty too, else 0."""
    w = _weights(pred, valid)
    p = torch.clamp(pred.float(), 0.0, 1.0) * w
    t = _binary(target) * w
    e = torch.abs(p - t) * w
    with span("eval.edt"):
        dist2, e_nearest = _edt_payload(t, e)
    et = torch.where(t > 0, e, e_nearest) * w
    ea = _gauss7(et)
    min_e_ea = torch.where((t > 0) & (ea < e), ea, e)
    dst = torch.sqrt(torch.clamp(dist2, max=_WF_BIG))
    b = torch.where(t > 0, 1.0, 2.0 - torch.exp(_DECAY * dst))
    ew = min_e_ea * b
    fg_area = _sum_hw(t)
    miss = _sum_hw(ew * t)
    tpw = fg_area - miss
    fpw = _sum_hw(ew * (1.0 - t) * w)
    recall = 1.0 - miss / torch.clamp(fg_area, min=_EPS)
    prec = tpw / torch.clamp(tpw + fpw, min=_EPS)
    wf = _f_beta(prec, recall, beta2)
    pred_empty = _sum_hw((p > 0.5).float() * w) == 0
    one, zero = torch.ones_like(wf), torch.zeros_like(wf)
    return torch.where(fg_area > 0, wf, torch.where(pred_empty, one, zero))
