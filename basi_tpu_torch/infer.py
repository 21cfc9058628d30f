"""Inference and evaluation runner, kernels mechanism (port of
``basi_tpu/infer.py``).

uint8 NHWC batch -> normalize -> BASINet -> top-k kernel selection, Matrix
NMS and slot packing at /4 -> (on request) the ``upsample_sigmoid`` kernel
to full resolution. ``evaluate`` runs the eval program per batch on the
device (full-resolution matching IoU, the saliency suite on the letterbox
content region, GT areas), or with ``infer.ap_at_original`` the same
metrics after pasting predictions and the saliency map back into each
image's original frame, against native-resolution GT; the host accumulates
mask AP/AR and the saliency means. Weights come from memory: JAX
``params``/``batch_stats`` trees (through ``export_basinet``), a torch
state dict, or a seeded random init. It runs on the card unless
``device`` names another. Settings outside the port raise
``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from collections import deque

import numpy as np
import torch
from torch.profiler import record_function

from basi_tpu_torch.config import Config
from basi_tpu_torch.convert import load_jax_variables
from basi_tpu_torch.data.datasets import iter_epoch, make_dataset
from basi_tpu_torch.data.native_gt import NativeGTCache
from basi_tpu_torch.data.transforms import (
    maybe_unpack_masks,
    pack_masks_host,
    unpack_masks,
)
from basi_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from basi_tpu_torch.evals.ap import APAccumulator, match_batch
from basi_tpu_torch.evals.saliency import (
    boundary_f_measure,
    e_measure_hist,
    f_measure_hist,
    s_measure,
    weighted_f_measure,
)
from basi_tpu_torch.kernels.upsample_sigmoid import upsample_sigmoid
from basi_tpu_torch.models.basi import BASIOutputs, create_model
from basi_tpu_torch.ops.nms import select_instances_from_kernels
from basi_tpu_torch.ops.paste import paste_masks_batch
from basi_tpu_torch.ops.resize import resize_bilinear

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Original-frame eval: canvases are 128-multiples up to this side, and the
# whole val set's packed GT stays on the device up to this many bytes.
MAX_CANVAS = 2048
DEVICE_GT_BYTES = 2 * 1024 ** 3
# what ``evaluate`` fetches of each batch, in this order
_FETCHED = ("scores", "iou", "mae", "f", "e", "s", "bf", "wf", "valid",
            "areas")


def check_infer_config(cfg: Config) -> None:
    """Raise NotImplementedError for inference settings outside the port."""
    icfg = cfg.infer
    if icfg.tta or tuple(icfg.tta_scales or ()):
        raise NotImplementedError("infer.tta / infer.tta_scales not yet ported")
    if icfg.dtype == "int8":
        raise NotImplementedError("infer.dtype='int8' not yet ported")
    if cfg.parallel.num_devices > 1 or cfg.parallel.spatial_shards > 1:
        raise NotImplementedError("multi-device inference not yet ported")
    if icfg.nms not in ("matrix", "matrix_linear", "greedy"):
        raise ValueError(f"unknown infer.nms {icfg.nms!r}")


def _canvas_side(extent: int, size: int) -> int:
    """The canvas bucket of an original extent: a 128-multiple, at least
    the model size, at most ``MAX_CANVAS``."""
    return min(max(size, -(-extent // 128) * 128), MAX_CANVAS)


def _place_packed(dst: np.ndarray, packed: np.ndarray, oh: int) -> None:
    """Copy one image's packed GT into its canvas slot, cropped to it. The
    canvas width is a 128-multiple, so its byte width keeps whole bits."""
    hh = min(oh, dst.shape[-2])
    wb = min(packed.shape[-1], dst.shape[-1])
    dst[:, :hh, :wb] = packed[:, :hh, :wb]


class EvalAccumulator:
    """The host half of ``evaluate``: mask AP/AR over the kept slots and
    the per-image saliency sums, fed one fetched batch at a time."""

    def __init__(self, wf: bool = True):
        self.wf = wf
        self.acc = APAccumulator(thresholds=(0.5, 0.7))
        self.n_img = 0
        self.mae = self.s = self.bf = self.wf_sum = 0.0
        self.f = self.e = None  # (T-1,) sums of per-image curves

    def add_batch(self, num_real: int, scores, iou, mae, f, e, s, bf, wf,
                  valid, areas) -> None:
        """numpy outputs of one batch: scores (N, K), iou (N, K, M), the
        per-image metrics (N,), the curves (T-1, N), GT valid and areas
        (N, M); rows past ``num_real`` (the padded tail) are skipped."""
        for i in range(num_real):
            self.acc.add(scores[i], iou[i], valid[i], gt_areas=areas[i])
        self.n_img += num_real
        self.mae += float(mae[:num_real].sum())
        self.s += float(s[:num_real].sum())
        self.bf += float(bf[:num_real].sum())
        self.wf_sum += float(wf[:num_real].sum())
        fs = f[:, :num_real].sum(axis=1)
        es = e[:, :num_real].sum(axis=1)
        self.f = fs if self.f is None else self.f + fs
        self.e = es if self.e is None else self.e + es

    def metrics(self) -> dict:
        """AP/AR, then the saliency means (dataset-level max-F and max-E:
        per-image curves averaged, then the max), rounded to 4 places."""
        out = self.acc.ap() | self.acc.ar()
        n = self.n_img
        if n:
            out["saliency_mae"] = round(self.mae / n, 4)
            out["saliency_maxF"] = round(float(np.max(self.f / n)), 4)
            out["saliency_maxE"] = round(float(np.max(self.e / n)), 4)
            out["saliency_S"] = round(self.s / n, 4)
            out["saliency_boundaryF"] = round(self.bf / n, 4)
            if self.wf:
                out["saliency_wF"] = round(self.wf_sum / n, 4)
        return out


class Inferencer:
    def __init__(self, cfg: Config, device=DEFAULT_DEVICE, params=None,
                 batch_stats=None, state_dict=None, checkpoint: str = "",
                 seed: int = 0):
        """``params``/``batch_stats``: JAX variable trees (numpy leaves);
        ``state_dict``: torch names (``export_basinet`` output); with
        neither, random weights from ``torch.Generator().manual_seed(seed)``.
        Weights are cast once to the inference dtype (``infer.dtype``, or
        ``model.dtype`` when that is empty)."""
        if checkpoint:
            raise NotImplementedError(
                "checkpoint loading not yet ported; pass params/batch_stats "
                "or a state_dict")
        check_infer_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        name = cfg.infer.dtype or cfg.model.dtype
        if name not in _DTYPES:
            raise ValueError(f"unknown inference dtype {name!r}")
        self.dtype = _DTYPES[name]
        model = create_model(cfg.model, self.device,
                             torch.Generator().manual_seed(seed))
        if params is not None:
            load_jax_variables(model, params, batch_stats or {})
        elif state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.dtype)
        self._mean = torch.tensor(cfg.data.mean, dtype=torch.float32,
                                  device=self.device)
        self._std = torch.tensor(cfg.data.std, dtype=torch.float32,
                                 device=self.device)
        self._gt_cache_obj = None  # (dataset, NativeGTCache or None)
        self._gt_dev_obj = None  # (dataset, (packed GT, canvas) or None)

    @torch.no_grad()
    def set_weights(self, state_dict=None, params=None,
                    batch_stats=None) -> None:
        """Swap in other weights (a torch state dict, or JAX trees) without
        building the model again; they are cast to the inference dtype as
        ``__init__`` casts them (one rounding from the given values)."""
        if params is not None:
            load_jax_variables(self.model, params, batch_stats or {})
        else:
            self.model.load_state_dict(state_dict, strict=True)

    def apply_model(self, images_u8: torch.Tensor) -> BASIOutputs:
        """Normalize a (N, H, W, 3) uint8 batch on the device and run the
        model: ``x/255``, then ``(x - mean)/std`` in f32, then the cast."""
        x = images_u8.to(self.device).float() / 255.0
        x = ((x - self._mean) / self._std).to(self.dtype)
        return self.model(x)

    def _select(self, out: BASIOutputs) -> tuple[torch.Tensor, torch.Tensor]:
        n, s1, s2, e = out.cell_kernels.shape
        icfg = self.cfg.infer
        return select_instances_from_kernels(
            out.mask_feats, out.cell_kernels.reshape(n, s1 * s2, e),
            out.cell_scores.reshape(n, s1 * s2),
            num_slots=self.cfg.model.num_slots,
            score_threshold=icfg.score_threshold,
            mask_threshold=icfg.mask_threshold,
            nms=icfg.nms,
            nms_sigma=icfg.nms_sigma,
            nms_iou_threshold=icfg.nms_iou_threshold,
            pre_top_k=icfg.pre_nms_top_k,
        )

    @torch.inference_mode()
    def predict_batch(self, images_u8
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(N, H, W, 3) uint8 batch (numpy or tensor) -> slot masks
        (N, K, H/4, W/4) probabilities, slot scores (N, K) f32 and saliency
        logits (N, H/4, W/4, 1), all on the device."""
        out = self.apply_model(torch.as_tensor(images_u8))
        masks, scores = self._select(out)
        return masks, scores, out.saliency_logits

    @torch.inference_mode()
    def full_res_masks(self, slot_mask_probs) -> torch.Tensor:
        """Slot-mask probabilities (..., h, w) -> f32 probabilities at the
        model input resolution: back to logits in the probs' dtype, then
        the fused upsample + sigmoid kernel."""
        probs = torch.as_tensor(slot_mask_probs, device=self.device)
        size = self.cfg.model.image_size
        p32 = torch.clamp(probs.float(), 1e-6, 1 - 1e-6)
        logits = (torch.log(p32) - torch.log1p(-p32)).to(probs.dtype)
        return upsample_sigmoid(logits, (size, size))

    # --- evaluation ---------------------------------------------------------

    def _saliency_suite(self, prob, union, region) -> dict:
        """MAE, the F and E curves, S, boundary F and (``infer.wf``)
        weighted F of probability maps (N, H, W) against the GT union,
        over ``region`` (N, H, W) 0/1."""
        with record_function("eval.sod"):
            area = torch.clamp(region.sum(dim=(1, 2)), min=1.0)
            mae = (torch.abs(prob - union) * region).sum(dim=(1, 2)) / area
            s = s_measure(prob, union, valid=region)
            return {
                "mae": mae,
                "f": f_measure_hist(prob, union, valid=region),
                "e": e_measure_hist(prob, union, valid=region),
                "s": s,
                "bf": boundary_f_measure(prob, union, valid=region),
                "wf": (weighted_f_measure(prob, union, valid=region)
                       if self.cfg.infer.wf else torch.zeros_like(s)),
            }

    @staticmethod
    def _region(hw: torch.Tensor, canvas_hw: tuple[int, int]) -> torch.Tensor:
        """(N, ch, cw) f32 indicator of each image's top-left ``hw``."""
        ch, cw = canvas_hw
        rows = torch.arange(ch, device=hw.device)[None, :, None] < hw[:, 0, None, None]
        cols = torch.arange(cw, device=hw.device)[None, None, :] < hw[:, 1, None, None]
        return (rows & cols).float()

    def _eval_batch(self, images_u8, gt_masks, gt_valid, valid_hw):
        """The eval program of one batch on the device: forward, selection,
        full-resolution masks (the ``upsample_sigmoid`` kernel), matching
        IoU against the GT at the model size, the saliency map resized to
        it and scored on the letterbox content region, and the GT areas.
        Returns (outputs by ``_FETCHED`` name, full-resolution masks,
        full-resolution saliency map)."""
        size = self.cfg.model.image_size
        gt_masks = maybe_unpack_masks(gt_masks, size)
        with record_function("eval.forward"):
            out = self.apply_model(images_u8)
        with record_function("eval.selection"):
            masks, scores = self._select(out)
        with record_function("eval.upsample_sigmoid"):
            full = self.full_res_masks(masks)  # (N, K, size, size) f32
        with record_function("eval.iou"):
            iou = match_batch(full, gt_masks, self.cfg.infer.mask_threshold)
            areas = gt_masks.to(torch.int32).sum(dim=(2, 3))
        with record_function("eval.sod"):
            gv = gt_valid.float()
            union = (gt_masks.float() * gv[..., None, None]).amax(dim=1)
            prob = torch.sigmoid(out.saliency_logits.float())  # (N, h, w, 1)
            prob = resize_bilinear(prob, (size, size))[..., 0]
        res = {"scores": scores, "iou": iou, "valid": gt_valid,
               "areas": areas,
               **self._saliency_suite(prob, union,
                                      self._region(valid_hw, (size, size)))}
        return res, full, prob

    def _orig_eval(self, full, sal, valid_hw, orig_hw, gt, gt_valid,
                   canvas_hw, packed: bool) -> dict:
        """Original-frame metrics of one batch: the slot masks and the
        saliency map pasted onto a ``canvas_hw`` canvas (each image's
        original extent at the top left), matched and scored against the
        native GT (bit-packed along W when ``packed``) over that extent.
        The GT areas are native-frame pixels."""
        if packed:
            gt = unpack_masks(gt, canvas_hw[1])
        thr = self.cfg.infer.mask_threshold
        with record_function("eval.paste"):
            pasted = paste_masks_batch(full, valid_hw, canvas_hw, orig_hw)
        with record_function("eval.iou"):
            iou = match_batch(pasted, gt, thr)
            del pasted
            areas = gt.to(torch.int32).sum(dim=(2, 3))
        with record_function("eval.paste"):
            sal_c = paste_masks_batch(sal[:, None], valid_hw, canvas_hw,
                                      orig_hw)[:, 0]
        with record_function("eval.sod"):
            gv = gt_valid.float()
            union = (gt.float() * gv[..., None, None]).amax(dim=1)
        return {"iou": iou, "areas": areas,
                **self._saliency_suite(sal_c, union,
                                       self._region(orig_hw, canvas_hw))}

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device. To a GPU it goes from pinned memory,
        asynchronously: a copy from pageable memory would wait for every
        batch already queued, and the host could not read ahead."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _orig_frame_eval(self, full, sal, batch, dataset) -> dict:
        """``_orig_eval`` of a host batch, its GT from the device-resident
        packed val set, else from the ``NativeGTCache`` assembled per
        batch, else drawn from ``dataset.get_orig_masks``."""
        size = self.cfg.model.image_size
        mh = int(np.max(batch["orig_hw"][:, 0]))
        mw = int(np.max(batch["orig_hw"][:, 1]))
        canvas = (_canvas_side(mh, size), _canvas_side(mw, size))
        if mh > MAX_CANVAS or mw > MAX_CANVAS:
            warnings.warn(f"original image {mh}x{mw} exceeds the "
                          f"{MAX_CANVAS} AP canvas cap; matching will crop")
        args = (self._upload(batch["valid_hw"]), self._upload(batch["orig_hw"]))
        gt_valid = self._upload(batch["valid"])
        cache = self._gt_cache(dataset)
        dev = self._device_gt(dataset, cache)
        if dev is not None:
            gt_dev, canvas = dev
            index = self._upload(batch["index"])
            return self._orig_eval(full, sal, *args, gt_dev[index], gt_valid,
                                   canvas, packed=True)
        n, m = batch["masks"].shape[:2]
        ch, cw = canvas
        if cache is not None:
            gt = np.zeros((n, m, ch, cw // 8), np.uint8)
            for j, gi in enumerate(batch["index"]):
                packed, _, (oh, _) = cache.get_packed(int(gi))
                _place_packed(gt[j], packed, oh)
            return self._orig_eval(full, sal, *args, self._upload(gt),
                                   gt_valid, canvas, packed=True)
        gt = np.zeros((n, m, ch, cw), np.uint8)
        for j, gi in enumerate(batch["index"]):
            masks, _ = dataset.get_orig_masks(int(gi))
            hh, ww = min(masks.shape[1], ch), min(masks.shape[2], cw)
            gt[j, :, :hh, :ww] = masks[:, :hh, :ww]
        return self._orig_eval(full, sal, *args, self._upload(gt), gt_valid,
                               canvas, packed=False)

    def _device_gt(self, dataset, cache):
        """The whole val set's packed GT on the device, on one canvas
        bucket from the cache's native sizes, or None (no disk cache, or
        more than ``DEVICE_GT_BYTES``). Built once per dataset. Padding
        past an image's extent is zero, so the global bucket gives the
        per-batch buckets' metrics."""
        hit = self._gt_dev_obj
        if hit is not None and hit[0] is dataset:
            return hit[1]
        obj = None
        if cache is not None and cache.on_disk:
            size = self.cfg.model.image_size
            hw = cache.native_sizes()
            ch = _canvas_side(int(hw[:, 0].max()), size)
            cw = _canvas_side(int(hw[:, 1].max()), size)
            n, m = len(dataset), cache.get_packed(0)[0].shape[0]
            if n * m * ch * (cw // 8) <= DEVICE_GT_BYTES:
                gt = np.zeros((n, m, ch, cw // 8), np.uint8)
                for i in range(n):
                    packed, _, (oh, _) = cache.get_packed(i)
                    _place_packed(gt[i], packed, oh)
                obj = (torch.from_numpy(gt).to(self.device), (ch, cw))
        self._gt_dev_obj = (dataset, obj)
        return obj

    def _gt_cache(self, dataset):
        """The ``NativeGTCache`` of ``dataset`` (made once per dataset), or
        None when ``infer.native_gt_cache`` is empty; ``auto`` puts it in
        ``<infer.output_dir>/native_gt``."""
        cfg_dir = self.cfg.infer.native_gt_cache
        if not cfg_dir:
            return None
        hit = self._gt_cache_obj
        if hit is not None and hit[0] is dataset:
            return hit[1]
        cache_dir = (os.path.join(self.cfg.infer.output_dir, "native_gt")
                     if cfg_dir == "auto" else cfg_dir)
        cache = NativeGTCache(dataset, cache_dir)
        self._gt_cache_obj = (dataset, cache)
        return cache

    @torch.inference_mode()
    def evaluate(self, dataset=None, max_batches: int = 0,
                 results_path: str = "") -> dict:
        """Mask AP (0.5, 0.7, the COCO mAP ladder), AR@1/10/100 and by
        size, and the saliency means over ``dataset`` (default: the val
        split of ``cfg.data``), with ``infer_ms_per_batch`` and
        ``imgs_per_s`` over the batches after the first (over the whole
        call when no batch was drained before the last was queued) and
        ``num_images``; prints ``[eval] {json}``. Batch b's outputs are
        copied to the host as soon as the device finishes them, while the
        host reads up to ``2 * data.prefetch_depth`` batches ahead."""
        cfg = self.cfg
        if results_path:
            raise NotImplementedError(
                "results_path (the COCO-RLE results export) not yet ported")
        if cfg.infer.save_png:
            raise NotImplementedError("infer.save_png not yet ported")
        if cfg.profile:
            raise NotImplementedError("profile (a trace of evaluate) not yet "
                                      "ported; use torch.profiler around it")
        dataset = dataset or make_dataset(cfg.data, split="val")
        ap_orig = cfg.infer.ap_at_original
        if ap_orig and not hasattr(dataset, "get_orig_masks"):
            raise ValueError(
                f"{type(dataset).__name__} provides no get_orig_masks; "
                f"original-resolution AP needs native-resolution GT")
        acc = EvalAccumulator(wf=cfg.infer.wf)
        cuda = self.device.type == "cuda"
        lag = max(1, int(cfg.data.prefetch_depth) * 2)
        pending: deque = deque()
        n_batches = 0
        t_steady = None

        def drain_one():
            nonlocal n_batches, t_steady
            num_real, host, ready = pending.popleft()
            if ready is not None:
                ready.synchronize()
            acc.add_batch(num_real, *(host[k].numpy() for k in _FETCHED))
            n_batches += 1
            if t_steady is None:  # the first batch pays the set-up
                t_steady = time.perf_counter()

        t0 = time.perf_counter()
        for bi, batch in enumerate(iter_epoch(
                dataset, cfg.infer.batch_size, shuffle=False, seed=0,
                drop_last=False)):
            if max_batches and bi >= max_batches:
                break
            gm = batch["masks"]
            if cfg.data.pack_masks:
                gm = pack_masks_host(gm)
            res, full, sal = self._eval_batch(
                self._upload(batch["image"]), self._upload(gm),
                self._upload(batch["valid"]), self._upload(batch["valid_hw"]))
            if ap_orig:
                res.update(self._orig_frame_eval(full, sal, batch, dataset))
            del full, sal
            host = {k: res[k].to("cpu", non_blocking=cuda) for k in _FETCHED}
            ready = torch.cuda.Event() if cuda else None
            if ready is not None:
                ready.record()
            pending.append((int(batch["num_real"]), host, ready))
            while len(pending) > lag:
                drain_one()
        while pending:
            drain_one()
        t_end = time.perf_counter()

        metrics = acc.metrics()
        if n_batches:
            if n_batches > lag:
                per_batch = (t_end - t_steady) * 1000 / (n_batches - 1)
            else:  # all queued before the first drain: the whole call
                per_batch = (t_end - t0) * 1000 / n_batches
            metrics["infer_ms_per_batch"] = round(per_batch, 2)
            metrics["imgs_per_s"] = round(
                cfg.infer.batch_size / max(per_batch / 1000, 1e-9), 1)
        metrics["num_images"] = acc.n_img
        print("[eval] " + json.dumps(metrics), flush=True)
        return metrics


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy; bf16 (which numpy lacks) widens exactly to f32."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
