"""Ahead-of-time serving artifacts through ``torch.export`` (the port's
counterpart of ``basi_tpu/convert/aot.py``).

A model exports to ONE file: the whole inference program (the ingest
normalize, the backbone, FPN and heads, the instance selection and mask
NMS; for the roi mechanism the proposals, the ROI mask head and the paste
onto /4 canvases before it) as a saved ``torch.export`` program, with the weights pre-cast to
``infer.dtype`` and stored in it. Contract of the exported function (that
of ``Inferencer.predict_batch``):

  images_u8 (N, S, S, 3) uint8  ->  (slot_masks (N, K, S/4, S/4) probs,
                                     scores (N, K) f32,
                                     saliency_logits (N, S/4, S/4, 1))

The program calls the hand-written kernels: while exporting, the model's
integer-factor upsamples are the custom op ``basi::upsample_int``
(``kernels/upsample_int.py``), which launches ``csrc/upsample_int.cu`` on
CUDA and runs its plain version on the CPU. So loading needs ``torch`` and
``basi_tpu_torch.kernels`` (which registers the ops), where the JAX
artifact needs jaxlib alone. The program runs on the device type it was
exported on (``platforms``).

File format (single file, ``.basiaot``):

  b"BASITEP1" | u64le meta_len | meta JSON (utf-8) | torch.export.save bytes

The JSON sidecar carries what a serving fleet needs for routing and pre-
and post-processing (image size, slot count, thresholds, dtype, mechanism,
platform) without loading the program.
"""

from __future__ import annotations

import io
import json
import struct
from dataclasses import dataclass, field
from typing import Any

import torch

from basi_tpu_torch.device import DEFAULT_DEVICE, resolve_device

_MAGIC = b"BASITEP1"
FORMAT = "basi-torch-aot/1"


class _ServingModule(torch.nn.Module):
    """``Inferencer.predict_batch`` as a module, for ``torch.export``."""

    def __init__(self, inf):
        super().__init__()
        self.model = inf.model
        self._inf = inf

    def forward(self, images_u8: torch.Tensor):
        out = self._inf.apply_model(images_u8)
        masks, scores = self._inf._select(out)
        return masks, scores, out.saliency_logits


def export_serving(cfg, *, params=None, batch_stats=None, state_dict=None,
                   checkpoint: str = "", batch_size: int = 0,
                   device=DEFAULT_DEVICE) -> tuple[bytes, dict]:
    """Export the inference program; returns ``(blob, meta)``.

    Weights as for ``Inferencer`` (JAX trees, a state dict, or a
    ``checkpoint``), cast to ``infer.dtype``. ``device``: where the
    program is traced and will run (``cuda`` or ``cpu``). The kernels and
    roi mechanisms export (the roi program holds the top-k proposals and
    the ROI paste); settings the port has no model for (the connected
    mechanism) raise ``NotImplementedError``."""
    from basi_tpu_torch.infer import Inferencer

    inf = Inferencer(cfg, device=device, params=params,
                     batch_stats=batch_stats, state_dict=state_dict,
                     checkpoint=checkpoint)
    n = int(batch_size or cfg.infer.batch_size)
    size = int(cfg.model.image_size)
    example = torch.zeros((n, size, size, 3), dtype=torch.uint8,
                          device=inf.device)
    with torch.no_grad():
        program = torch.export.export(_ServingModule(inf), (example,),
                                      strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    meta = {
        "format": FORMAT,
        "model_size": size,
        "batch_size": n,
        "num_slots": int(cfg.model.num_slots),
        "backbone": cfg.model.backbone,
        "instance_mechanism": cfg.model.instance_mechanism,
        "infer_dtype": cfg.infer.dtype or cfg.model.dtype,
        "score_threshold": float(cfg.infer.score_threshold),
        "mask_threshold": float(cfg.infer.mask_threshold),
        "nms": cfg.infer.nms,
        "platforms": [inf.device.type],
        "torch_version": torch.__version__,
        "input": {"shape": [n, size, size, 3], "dtype": "uint8"},
        "outputs": ["slot_mask_probs", "scores", "saliency_logits"],
    }
    return buf.getvalue(), meta


def save_serving(path: str, cfg, **kwargs) -> dict:
    """``export_serving`` straight to ``path``; returns the meta dict."""
    blob, meta = export_serving(cfg, **kwargs)
    payload = json.dumps(meta).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(payload)))
        f.write(payload)
        f.write(blob)
    return meta


def _read_header(f, path: str) -> dict:
    magic = f.read(len(_MAGIC))
    if magic != _MAGIC:
        raise ValueError(
            f"{path!r} is not a basi torch AOT artifact (bad magic {magic!r})")
    (meta_len,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(meta_len).decode("utf-8"))


def read_meta(path: str) -> dict:
    """Read only the JSON sidecar (no program is loaded)."""
    with open(path, "rb") as f:
        return _read_header(f, path)


@dataclass
class ServingModel:
    """A loaded artifact: ``model(images_u8) -> (masks, scores, sal)``,
    device tensors. Inputs of another shape or dtype raise ValueError."""

    meta: dict
    program: Any  # torch.export.ExportedProgram
    device: torch.device
    _module: Any = field(init=False, repr=False)

    def __post_init__(self):
        self._module = self.program.module()

    def __call__(self, images_u8):
        x = torch.as_tensor(images_u8)
        want = tuple(self.meta["input"]["shape"])
        if tuple(x.shape) != want:
            raise ValueError(f"artifact takes {want} uint8, got "
                             f"{tuple(x.shape)}")
        if x.dtype != torch.uint8:
            raise ValueError(f"artifact takes uint8 pixels, got {x.dtype}")
        with torch.no_grad():
            return tuple(self._module(x.to(self.device)))


def load_serving(path: str, device=DEFAULT_DEVICE) -> ServingModel:
    """Load an artifact to run on ``device`` (the card unless another is
    named; without a GPU a CUDA device raises), which must be of the type
    it was exported for."""
    # registers basi::upsample_int and basi::upsample_sigmoid
    import basi_tpu_torch.kernels.upsample_int  # noqa: F401
    import basi_tpu_torch.kernels.upsample_sigmoid  # noqa: F401

    dev = resolve_device(device)
    with open(path, "rb") as f:
        meta = _read_header(f, path)
        blob = f.read()
    if dev.type not in meta["platforms"]:
        raise ValueError(f"{path!r} was exported for {meta['platforms']}, "
                         f"not {dev.type}")
    program = torch.export.load(io.BytesIO(blob))
    return ServingModel(meta=meta, program=program, device=dev)

