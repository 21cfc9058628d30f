"""A cell cut to a size the CPU runs in seconds, for the harness's tests:
the cell's own configuration and mix with a one-block trunk at 64^2,
narrow heads and batches of 4, computed in float32. The limits of the
check are the cell's, set from its bfloat16 runs at full size; in float32
the program's sound runs read far below them (1e-5 on the CPU), and the
faults must read above them."""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness.manifest import load_cell, load_driver  # noqa: E402

TINY_MODEL = {"backbone": "resnet_tiny", "image_size": 64, "fpn_channels": 32,
              "mask_channels": 32, "grid_size": 4, "roi_resolution": 8,
              "roi_top_k": 16}


def tiny_cell(workload: str):
    """The manifest's ``workload`` with its sizes cut (module doc)."""
    cell = copy.deepcopy(load_cell(ROOT, workload))
    conf = cell.config[cell.traffic["driver"]]
    conf["overrides"] = list(conf["overrides"]) + [
        f"model.{k}={v}" for k, v in TINY_MODEL.items()] + [
        "data.image_size=64", "infer.pre_nms_top_k=8", "infer.dtype=float32",
        "model.dtype=float32"]
    for k in TINY_MODEL:
        conf["model"].pop(k, None)
    conf["model"].pop("dtype", None)
    cell.traffic.update(overrides=cell.traffic["overrides"][1:]
                        + ["data.batch_size=4"], trace_lead_s=0.2,
                        trace_s=0.5)
    return cell


def run_tiny(workload: str, seed: int, fault=None, seconds: float = 1.5,
             trace: bool = False) -> dict:
    import torch

    torch.set_num_threads(2)
    cell = tiny_cell(workload)
    return load_driver(cell).run(cell, seed, seconds, trace, "cpu",
                                 time.perf_counter(), fault=fault)
