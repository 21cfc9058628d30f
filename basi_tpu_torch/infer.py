"""Inference and evaluation runner (port of ``basi_tpu/infer.py``), for
the kernels and roi mechanisms.

uint8 NHWC batch -> normalize -> BASINet -> the mechanism's candidates (the
top-k cells' kernels applied, or the ROI masks pasted onto /4 canvases),
Matrix NMS and slot packing at /4 -> (on request) the ``upsample_sigmoid``
kernel to full resolution. ``evaluate`` runs the eval program per batch on
the device (full-resolution matching IoU, the saliency suite on the
letterbox content region, GT areas), or with ``infer.ap_at_original`` the
same metrics after pasting predictions and the saliency map back into each
image's original frame, against native-resolution GT; the host accumulates
mask AP/AR and the saliency means, and on request writes each image's
predicted instances as a labeled PNG at its original size
(``infer.save_png``), a COCO-format results file (``results_path``) and a
``torch.profiler`` trace (``profile``). ``predict_paths`` runs image files
through the same program: decode and letterbox (``data/native.py``), the
model, the selection, the upsample, the paste back to each original size,
then a PNG per image and the COCO results. Weights come from JAX
``params``/``batch_stats`` trees (through ``export_basinet``), a torch
state dict, a Trainer checkpoint or state dict file, or a seeded random
init. It runs on the card unless ``device`` names another. Settings outside
the port raise ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from collections import deque

import numpy as np
import torch

from basi_tpu_torch.config import Config
from basi_tpu_torch.convert import load_jax_variables
from basi_tpu_torch.data.coco import mask_to_rle
from basi_tpu_torch.data.datasets import (
    iter_epoch,
    letterbox_params,
    make_dataset,
)
from basi_tpu_torch.data.native import get_decoder
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
from basi_tpu_torch.ops.nms import (
    select_instances_from_kernels,
    select_instances_from_probs,
)
from basi_tpu_torch.ops.paste import paste_masks_batch
from basi_tpu_torch.ops.roi import paste_rois
from basi_tpu_torch.ops.resize import resize_bilinear
from basi_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    is_params_export,
    load_params,
)
from basi_tpu_torch.utils.logging import save_mask_pngs
from basi_tpu_torch.utils.profiling import maybe_trace, span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Original-frame eval: canvases are 128-multiples up to this side, and the
# whole val set's packed GT stays on the device up to this many bytes.
MAX_CANVAS = 2048
DEVICE_GT_BYTES = 2 * 1024 ** 3
# Exported masks (PNGs, COCO results): canvases are 512-multiples, as the
# reference's, up to MAX_CANVAS.
EXPORT_BUCKET = 512
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


def _unique_stems(paths) -> list[str]:
    """Each path's file stem, made unique with ``_1``, ``_2``... in order,
    so that inputs from other directories never overwrite each other's
    PNG."""
    names, used = [], set()
    for p in paths:
        base = os.path.splitext(os.path.basename(str(p)))[0]
        name, k = base, 1
        while name in used:
            name, k = f"{base}_{k}", k + 1
        used.add(name)
        names.append(name)
    return names


def _probe_writable(path: str) -> None:
    """Fail before any inference when ``path`` cannot be written: opened
    in append mode, so an existing file keeps its contents and no empty
    result list is left behind."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a"):
        pass


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


def load_checkpoint_weights(path: str) -> dict:
    """The model's state dict from a params export (``export_params``), a
    Trainer checkpoint directory (``CheckpointManager.restore_weights``:
    EMA preferred) or a torch state dict file."""
    if os.path.isdir(path) and is_params_export(path):
        return load_params(path)
    if os.path.isdir(path):
        return CheckpointManager(path).restore_weights()
    if os.path.isfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no checkpoint at {path!r}")


class Inferencer:
    def __init__(self, cfg: Config, device=DEFAULT_DEVICE, params=None,
                 batch_stats=None, state_dict=None, checkpoint: str = "",
                 seed: int = 0):
        """``params``/``batch_stats``: JAX variable trees (numpy leaves);
        ``state_dict``: torch names (``export_basinet`` output);
        ``checkpoint``: a params export (``export_params``), a Trainer
        checkpoint directory (its newest step, the EMA weights when it has
        them) or a torch state dict file (as ``export --torch`` writes
        one); with none of these, random weights from
        ``torch.Generator().manual_seed(seed)``. Weights are
        cast once to the inference dtype (``infer.dtype``, or
        ``model.dtype`` when that is empty)."""
        check_infer_config(cfg)
        if checkpoint and params is None and state_dict is None:
            state_dict = load_checkpoint_weights(checkpoint)
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
        """The slots of a batch: the kernels mechanism applies its top-k
        cells' kernels; the roi mechanism pastes the sigmoid of its ROI
        masks (in the compute dtype) onto /4 canvases and scores them by
        the sigmoid of their proposals' logits. Then the same rescoring,
        NMS and slot packing."""
        icfg = self.cfg.infer
        kw = dict(num_slots=self.cfg.model.num_slots,
                  score_threshold=icfg.score_threshold,
                  mask_threshold=icfg.mask_threshold, nms=icfg.nms,
                  nms_sigma=icfg.nms_sigma,
                  nms_iou_threshold=icfg.nms_iou_threshold)
        if out.roi_mask_logits is not None:
            probs = torch.sigmoid(out.roi_mask_logits.float()).to(self.dtype)
            canvases = paste_rois(probs, out.roi_boxes,
                                  tuple(out.mask_feats.shape[1:3]))
            return select_instances_from_probs(
                canvases, torch.sigmoid(out.roi_scores.float()), **kw)
        n, s1, s2, e = out.cell_kernels.shape
        return select_instances_from_kernels(
            out.mask_feats, out.cell_kernels.reshape(n, s1 * s2, e),
            out.cell_scores.reshape(n, s1 * s2),
            pre_top_k=icfg.pre_nms_top_k, **kw)

    @torch.inference_mode()
    def predict_batch(self, images_u8
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(N, H, W, 3) uint8 batch (numpy or tensor) -> slot masks
        (N, K, H/4, W/4) probabilities, slot scores (N, K) f32 and saliency
        logits (N, H/4, W/4, 1), all on the device."""
        out = self.apply_model(torch.as_tensor(images_u8))
        masks, scores = self._select(out)
        return masks, scores, out.saliency_logits

    def full_res_masks(self, slot_mask_probs) -> torch.Tensor:
        """Slot-mask probabilities (..., h, w) -> f32 probabilities at the
        model input resolution (``full_res_masks``)."""
        return full_res_masks(slot_mask_probs, self.cfg.model.image_size,
                              self.device)

    # --- prediction export ------------------------------------------------

    def _fetch(self, *tensors: torch.Tensor) -> list[np.ndarray]:
        """Host copies of device tensors, through pinned memory on a GPU
        (one wait for all of them)."""
        if self.device.type != "cuda":
            return [t.cpu().numpy() for t in tensors]
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return [h.numpy() for h in host]

    def _paste_batch(self, batch: dict, full: torch.Tensor):
        """Full-resolution slot masks (N, K, size, size) pasted onto each
        image's original frame on the device: a canvas of 512-multiples
        at least the model size, sized to the batch's largest original,
        at most ``MAX_CANVAS`` (warns beyond it: PNGs are cropped there
        and RLE masks zero beyond it). Returns (pasted (N, K, ch, cw) f32
        on the device, ch, cw)."""
        size = self.cfg.model.image_size
        mh = int(np.max(batch["orig_hw"][:, 0]))
        mw = int(np.max(batch["orig_hw"][:, 1]))
        ch = min(max(size, -(-mh // EXPORT_BUCKET) * EXPORT_BUCKET),
                 MAX_CANVAS)
        cw = min(max(size, -(-mw // EXPORT_BUCKET) * EXPORT_BUCKET),
                 MAX_CANVAS)
        if mh > MAX_CANVAS or mw > MAX_CANVAS:
            warnings.warn(
                f"original image {mh}x{mw} exceeds the {MAX_CANVAS} paste "
                f"canvas cap; saved mask PNGs are cropped and exported RLE "
                f"masks are zero-padded beyond the canvas")
        pasted = paste_masks_batch(full, self._upload(batch["valid_hw"]),
                                   (ch, cw), self._upload(batch["orig_hw"]))
        return pasted, ch, cw

    def _export_batch(self, bi: int, batch: dict, full: torch.Tensor,
                      scores: np.ndarray, names=None, out_dir: str = "",
                      pngs: bool = True) -> list[list]:
        """Paste one batch, fetch its masks binarized at 0.5 (all that the
        PNGs and the RLE read), write a PNG per real image (``pngs``), and
        return each real image's kept instances (``_kept_instances``)."""
        pasted, ch, cw = self._paste_batch(batch, full)
        (on,) = self._fetch(pasted > 0.5)
        del pasted
        kept = []
        for i in range(int(batch["num_real"])):
            oh = int(batch["orig_hw"][i][0])
            ow = int(batch["orig_hw"][i][1])
            if pngs:
                save_mask_pngs(
                    out_dir or self.cfg.infer.output_dir,
                    names[i] if names else f"b{bi}_i{i}",
                    on[i][:, :min(oh, ch), :min(ow, cw)], scores[i],
                    self.cfg.infer.score_threshold)
            kept.append(self._kept_instances(
                on[i], scores[i], oh, ow, self.cfg.infer.score_threshold))
        return kept

    @staticmethod
    def _kept_instances(slots: np.ndarray, scores: np.ndarray, oh: int,
                        ow: int, thr: float) -> list[tuple]:
        """The one keep rule of the summaries and the COCO entries: the
        score reaches ``thr`` and is positive, and the pasted mask (> 0.5,
        cropped to the canvas) is not empty. [(slot, score, bool mask)]."""
        kept = []
        ch, cw = slots.shape[-2:]
        for j, s in enumerate(scores):
            if s < thr or s <= 0:
                continue
            m = slots[j, :min(oh, ch), :min(ow, cw)] > 0.5
            if m.any():
                kept.append((j, float(s), m))
        return kept

    @staticmethod
    def _coco_entry(image_id, score: float, m: np.ndarray, oh: int,
                    ow: int) -> dict:
        """One COCO results entry at the original size: the mask zero-padded
        back to (oh, ow) where the canvas cap cropped it."""
        if m.shape != (oh, ow):
            m = np.pad(m, ((0, oh - m.shape[0]), (0, ow - m.shape[1])))
        return {"image_id": image_id, "category_id": 1, "score": score,
                "segmentation": mask_to_rle(m)}

    @torch.inference_mode()
    def predict_paths(self, paths, out_dir: str = "",
                      results_path: str = "") -> list[dict]:
        """Image files (JPEG, PNG) in; per input one labeled-instance PNG at
        its original size under ``out_dir`` (default
        ``infer.output_dir``), named by its stem (made unique), and one
        summary ``{"path", "instances", "scores"}``. ``results_path``:
        also a COCO-format results JSON, one entry per kept instance
        (``category_id`` 1, the score, the compressed RLE at the original
        size; ``image_id`` the stem, as an int where it is all digits),
        its path checked writable before any inference. Batches of
        ``infer.batch_size``; a short last batch is padded with its first
        image, so every batch has one shape."""
        cfg = self.cfg
        size = cfg.model.image_size
        bs = cfg.infer.batch_size
        decoder = get_decoder(cfg.data.decode_backend)
        all_names = _unique_stems(paths)
        results: list[dict] = []
        coco_results: list[dict] = []
        seen_ids: dict = {}
        if results_path:
            _probe_writable(results_path)
        for start in range(0, len(paths), bs):
            chunk = [str(p) for p in paths[start:start + bs]]
            n_real = len(chunk)
            imgs, hws = decoder.decode_letterbox_batch(chunk, size)
            idx = [i if i < n_real else 0 for i in range(bs)]
            orig_hw = hws[idx].astype(np.int32)
            batch = {"orig_hw": orig_hw, "num_real": n_real,
                     "valid_hw": np.array(
                         [letterbox_params(int(h), int(w), size)
                          for h, w in orig_hw], np.int32)}
            masks, scores, _ = self.predict_batch(self._upload(imgs[idx]))
            full = self.full_res_masks(masks)
            (scores_h,) = self._fetch(scores)
            kept_all = self._export_batch(
                start // bs, batch, full, scores_h,
                names=all_names[start:start + bs], out_dir=out_dir)
            for i, kept in enumerate(kept_all):
                results.append({"path": chunk[i], "instances": len(kept),
                                "scores": [s for _, s, _ in kept]})
                if not results_path:
                    continue
                stem = os.path.splitext(os.path.basename(chunk[i]))[0]
                image_id = int(stem) if stem.isdecimal() else stem
                if seen_ids.setdefault(image_id, chunk[i]) != chunk[i]:
                    warnings.warn(
                        f"duplicate COCO image_id {image_id!r}: {chunk[i]!r} "
                        f"and {seen_ids[image_id]!r}: their results merge "
                        f"under one id")
                oh, ow = int(orig_hw[i][0]), int(orig_hw[i][1])
                coco_results.extend(self._coco_entry(image_id, s, m, oh, ow)
                                    for _, s, m in kept)
        if results_path:
            with open(results_path, "w") as f:
                json.dump(coco_results, f)
        return results

    # --- evaluation ---------------------------------------------------------

    def _saliency_suite(self, prob, union, region) -> dict:
        """MAE, the F and E curves, S, boundary F and (``infer.wf``)
        weighted F of probability maps (N, H, W) against the GT union,
        over ``region`` (N, H, W) 0/1."""
        with span("eval.sod"):
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
        with span("eval.forward"):
            out = self.apply_model(images_u8)
        with span("eval.selection"):
            masks, scores = self._select(out)
        with span("eval.upsample_sigmoid"):
            full = self.full_res_masks(masks)  # (N, K, size, size) f32
        with span("eval.iou"):
            iou = match_batch(full, gt_masks, self.cfg.infer.mask_threshold)
            areas = gt_masks.to(torch.int32).sum(dim=(2, 3))
        with span("eval.sod"):
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
        with span("eval.paste"):
            pasted = paste_masks_batch(full, valid_hw, canvas_hw, orig_hw)
        with span("eval.iou"):
            iou = match_batch(pasted, gt, thr)
            del pasted
            areas = gt.to(torch.int32).sum(dim=(2, 3))
        with span("eval.paste"):
            sal_c = paste_masks_batch(sal[:, None], valid_hw, canvas_hw,
                                      orig_hw)[:, 0]
        with span("eval.sod"):
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
        host reads up to ``2 * data.prefetch_depth`` batches ahead.

        ``infer.save_png``: each image's kept instances as a labeled PNG
        at its original size in ``infer.output_dir``
        (``png_ms_per_batch``). ``results_path``: every kept instance as a
        COCO results entry (``dataset.image_id`` ids; ``num_results``).
        The time of both stays out of ``infer_ms_per_batch``. ``profile``:
        a ``torch.profiler`` trace of the loop in ``profile_dir``."""
        cfg = self.cfg
        dataset = dataset or make_dataset(cfg.data, split="val")
        ap_orig = cfg.infer.ap_at_original
        if ap_orig and not hasattr(dataset, "get_orig_masks"):
            raise ValueError(
                f"{type(dataset).__name__} provides no get_orig_masks; "
                f"original-resolution AP needs native-resolution GT")
        save_png = cfg.infer.save_png
        coco_results: list[dict] = []
        if results_path:
            _probe_writable(results_path)
            id_of = getattr(dataset, "image_id", int)
        export = save_png or bool(results_path)
        acc = EvalAccumulator(wf=cfg.infer.wf)
        cuda = self.device.type == "cuda"
        lag = max(1, int(cfg.data.prefetch_depth) * 2)
        pending: deque = deque()
        n_batches = 0
        t_steady = None
        png_ms = png_at_steady = 0.0

        def drain_one():
            nonlocal n_batches, t_steady, png_ms, png_at_steady
            bi, batch, host, full, ready = pending.popleft()
            if ready is not None:
                ready.synchronize()
            num_real = int(batch["num_real"])
            acc.add_batch(num_real, *(host[k].numpy() for k in _FETCHED))
            n_batches += 1
            if export:  # postprocessing I/O, timed apart
                tp = time.perf_counter()
                kept_all = self._export_batch(bi, batch, full,
                                              host["scores"].numpy(),
                                              pngs=save_png)
                for i, kept in enumerate(kept_all if results_path else ()):
                    iid = id_of(int(batch["index"][i]))
                    oh = int(batch["orig_hw"][i][0])
                    ow = int(batch["orig_hw"][i][1])
                    coco_results.extend(self._coco_entry(iid, s, m, oh, ow)
                                        for _, s, m in kept)
                png_ms += (time.perf_counter() - tp) * 1000
            if t_steady is None:  # the first batch pays the set-up
                t_steady = time.perf_counter()
                png_at_steady = png_ms

        with maybe_trace(cfg.profile, cfg.profile_dir):
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
                    self._upload(batch["valid"]),
                    self._upload(batch["valid_hw"]))
                if ap_orig:
                    res.update(self._orig_frame_eval(full, sal, batch,
                                                     dataset))
                del sal
                host = {k: res[k].to("cpu", non_blocking=cuda)
                        for k in _FETCHED}
                ready = torch.cuda.Event() if cuda else None
                if ready is not None:
                    ready.record()
                pending.append((bi, batch, host, full if export else None,
                                ready))
                del full
                while len(pending) > lag:
                    drain_one()
            while pending:
                drain_one()
            t_end = time.perf_counter()

        metrics = acc.metrics()
        if n_batches:
            if n_batches > lag:
                window = n_batches - 1
                spent = (t_end - t_steady) * 1000 - (png_ms - png_at_steady)
                png_spent = png_ms - png_at_steady
            else:  # all queued before the first drain: the whole call
                window = n_batches
                spent = (t_end - t0) * 1000 - png_ms
                png_spent = png_ms
            per_batch = spent / window
            metrics["infer_ms_per_batch"] = round(per_batch, 2)
            metrics["imgs_per_s"] = round(
                cfg.infer.batch_size / max(per_batch / 1000, 1e-9), 1)
            if save_png:
                metrics["png_ms_per_batch"] = round(png_spent / window, 2)
        metrics["num_images"] = acc.n_img
        if results_path:
            with open(results_path, "w") as f:
                json.dump(coco_results, f)
            metrics["num_results"] = len(coco_results)
        print("[eval] " + json.dumps(metrics), flush=True)
        return metrics


@torch.inference_mode()
def full_res_masks(slot_mask_probs, size: int, device) -> torch.Tensor:
    """Slot-mask probabilities (..., h, w) on ``device`` -> f32
    probabilities at ``size`` x ``size``: back to logits in the probs'
    dtype, then the fused upsample + sigmoid kernel."""
    probs = torch.as_tensor(slot_mask_probs, device=device)
    p32 = torch.clamp(probs.float(), 1e-6, 1 - 1e-6)
    logits = (torch.log(p32) - torch.log1p(-p32)).to(probs.dtype)
    return upsample_sigmoid(logits, (size, size))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy; bf16 (which numpy lacks) widens exactly to f32."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
