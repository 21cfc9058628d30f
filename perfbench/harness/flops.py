"""Model FLOPs from the configuration's shapes.

The reference runs on the ``meta`` device under PyTorch's FLOP counter:
every convolution and GEMM of a train-mode forward at the cell's batch,
counted from its shapes, and nothing computed. The roi mechanism's crop is
a bilinear sampling in the reference; the program computes it as banded
GEMMs, whose operations are added at their shapes. The count is the same
whatever implements the layers.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference.basi import Ref, param_spec


def forward_flops(cfg: dict, batch: int) -> float:
    """Operations of one train-mode forward at ``batch`` images (``cfg``:
    the plain model, data, infer and train sections): the deep
    supervision, and the ROI mask head at ``train.max_pos_cells`` boxes or
    the kernels applied at as many cells; a step is three times that."""
    m = cfg["model"]
    p = {name: torch.empty(shape, device="meta",
                           dtype=torch.int64 if kind == "count"
                           else torch.float32)
         for name, shape, kind in param_spec(m)}
    size = m["image_size"]
    ref = Ref(p, m, cfg["data"]["mean"], cfg["data"]["std"], cfg["infer"])
    cells = cfg["train"]["max_pos_cells"] or 64
    x = torch.empty(batch, 3, size, size, device="meta")
    roi = m["instance_mechanism"] == "roi"
    with FlopCounterMode(display=False) as counter:
        if roi:
            ref.forward_train(x, torch.empty(batch, cells, 4, device="meta"))
        else:
            ref.forward_train_kernels(x, torch.empty(
                batch, cells, dtype=torch.int64, device="meta"))
    total = float(counter.get_total_flops())
    if roi:
        total += roi_gemm_flops(m, batch, cells)
    return total


def roi_gemm_flops(m: dict, batch: int, k: int) -> float:
    """The roi mechanism's crop (``roi_align``: rows, then columns, of the
    (H/4, W/4, E) mask features for ``k`` boxes at R x R) as GEMMs."""
    h = w = m["image_size"] // 4
    e, r = m["mask_channels"], m["roi_resolution"]
    return float(batch * (2 * k * r * h * w * e + 2 * k * r * r * w * e))
