"""Inference runner, kernels mechanism (port of the serving slice of
``basi_tpu/infer.py``).

uint8 NHWC batch -> normalize -> BASINet -> top-k kernel selection, Matrix
NMS and slot packing at /4 -> (on request) the ``upsample_sigmoid`` kernel
to full resolution. Weights come from memory: JAX ``params``/``batch_stats``
trees (through ``export_basinet``), a torch state dict, or a seeded random
init. It runs on the card unless ``device`` names another. Settings
outside this slice raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from basi_tpu_torch.config import Config
from basi_tpu_torch.convert import load_jax_variables
from basi_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from basi_tpu_torch.kernels.upsample_sigmoid import upsample_sigmoid
from basi_tpu_torch.models.basi import BASIOutputs, create_model
from basi_tpu_torch.ops.nms import select_instances_from_kernels

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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

    def apply_model(self, images_u8: torch.Tensor) -> BASIOutputs:
        """Normalize a (N, H, W, 3) uint8 batch on the device and run the
        model: ``x/255``, then ``(x - mean)/std`` in f32, then the cast."""
        x = images_u8.to(self.device).float() / 255.0
        x = ((x - self._mean) / self._std).to(self.dtype)
        return self.model(x)

    @torch.inference_mode()
    def predict_batch(self, images_u8
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(N, H, W, 3) uint8 batch (numpy or tensor) -> slot masks
        (N, K, H/4, W/4) probabilities, slot scores (N, K) f32 and saliency
        logits (N, H/4, W/4, 1), all on the device."""
        out = self.apply_model(torch.as_tensor(images_u8))
        n, s1, s2, e = out.cell_kernels.shape
        icfg = self.cfg.infer
        masks, scores = select_instances_from_kernels(
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


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy; bf16 (which numpy lacks) widens exactly to f32."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
