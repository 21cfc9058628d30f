"""Readings that the limits of a ConvNeXt training cell's check are set
from: ``calibrate.py`` for cells whose driver is ``train_convnext``.

    python3 perfbench/calibrate_convnext.py --workload <name> --seeds <n> [<n> ...] [--seconds <s>] [--fault half_batch | --control-only]

``calibrate.py`` draws its weights through ``reference/basi.py``'s
ResNet-only ``param_spec``; this draws them through the cell's own driver
(``drivers/train_convnext.py::make_weights``) and otherwise reads the
same: for each seed, in one process, a run of the cell and the numbers its
check compares, then the control (the reference's checked steps in
float8, judged by the same comparison against its own in float32);
``--control-only`` reads the control alone, ``--fault half_batch`` a
program that leaves half of each batch out. One JSON line per seed. The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _inputs(cell, drv, seed: int, device: str):
    """The run's own draws made again: (plain config, weights, (images,
    masks, valid))."""
    import torch

    from perfbench.harness.config import plain_config, program_config
    from perfbench.harness.inputs import draw_scenes

    cfg = program_config(cell)
    plain = plain_config(cfg)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    weights = drv.make_weights(plain["model"], cell.config["weights"], gen,
                               dev)
    size = plain["model"]["image_size"]
    n = cfg.data.batch_size
    return plain, weights, draw_scenes(cell.traffic["ring"] * n, size,
                                       tuple(cell.traffic["objects"]), gen,
                                       dev, with_masks=True)


def control(cell, seed: int, device: str, drv=None) -> dict:
    """The control's readings on the run's inputs (module doc)."""
    from perfbench.harness.manifest import load_driver
    from perfbench.reference.compare import (
        train_errors,
        train_gaps,
        worst_leaves,
    )

    drv = drv or load_driver(cell)
    plain, weights, (images, masks, valid) = _inputs(cell, drv, seed, device)
    steps = cell.traffic["checked_steps"]
    n = images.shape[0] // cell.traffic["ring"]
    args = (weights, plain, images, masks, valid, n, steps)
    ref = drv.reference_steps(*args)
    low = drv.reference_steps(*args, precision="fp8")
    gaps = train_gaps(low, ref, weights)
    return dict(train_errors(low, gaps, ref), worst=worst_leaves(gaps),
                loss=gaps["loss"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("half_batch",), default=None)
    ap.add_argument("--control-only", action="store_true",
                    help="the control's readings alone, without a run")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.calibrate import half_batch
    from perfbench.harness.manifest import load_cell, load_driver

    cell = load_cell(ROOT, args.workload)
    drv = load_driver(cell)
    for seed in args.seeds:
        if args.control_only:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": control(cell, seed, args.device,
                                                 drv)}), flush=True)
            continue
        facts = drv.run(cell, seed, args.seconds, False, args.device,
                        time.perf_counter(),
                        fault=half_batch if args.fault else None)
        row = {"workload": args.workload, "seed": seed, "fault": args.fault,
               "program": facts["readings"], "e2e": facts["e2e"],
               "check_s": facts["check_s"],
               "memory_peak_bytes": facts["memory_peak_bytes"]}
        if not args.fault:
            row["control"] = control(cell, seed, args.device, drv)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
