"""Readings that the limits of a training cell's check are set from.

    python3 perfbench/calibrate.py --workload <name> --seeds <n> [<n> ...] [--seconds <s>] [--fault half_batch | --control-only]

For each seed, in one process: a run of the cell (its own traffic at its
own sizes, a window of ``--seconds``) and the numbers its check compares;
then the control on the same inputs: the reference's checked steps in
float8 (``reference/basi.py``), put in the program's place and judged by
the same comparison; ``--control-only`` reads the control alone. ``--fault
half_batch`` runs the program with half of each batch left out, the
loss's mean taken over the rest, in place of the control. One JSON line
per seed. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _inputs(cell, seed: int, device: str):
    """The run's own draws made again: (plain config, weights, (images,
    masks, valid))."""
    import torch

    from perfbench.harness.config import plain_config, program_config
    from perfbench.harness.inputs import draw_scenes, make_weights

    cfg = program_config(cell)
    plain = plain_config(cfg)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    weights = make_weights(plain["model"], cell.config["weights"], gen, dev)
    size = plain["model"]["image_size"]
    n = cfg.data.batch_size
    return plain, weights, draw_scenes(cell.traffic["ring"] * n, size,
                                       tuple(cell.traffic["objects"]), gen,
                                       dev, with_masks=True)


def control(cell, seed: int, device: str) -> dict:
    """The control's readings: the reference's checked steps with float8
    operands, judged against its own in float32 as the program's are, on
    the run's inputs."""
    from perfbench.harness.manifest import load_driver
    from perfbench.reference.compare import (
        train_errors,
        train_gaps,
        worst_leaves,
    )

    drv = load_driver(cell)
    plain, weights, (images, masks, valid) = _inputs(cell, seed, device)
    steps = cell.traffic["checked_steps"]
    n = images.shape[0] // cell.traffic["ring"]
    args = (weights, plain, images, masks, valid, n, steps)
    ref = drv.reference_steps(*args)
    low = drv.reference_steps(*args, precision="fp8")
    gaps = train_gaps(low, ref, {k: weights[k] for k in ref["params"]})
    return dict(train_errors(low, gaps, ref), worst=worst_leaves(gaps),
                loss=gaps["loss"])


def half_batch(real, state, batch):
    """The step on the first half of the batch's rows: half of the batch
    left out, the loss's mean taken over the rest."""
    n = batch["image"].shape[0] // 2
    return real(state, {k: v[:n] for k, v in batch.items()})


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
    from perfbench.harness.manifest import load_cell, load_driver

    cell = load_cell(ROOT, args.workload)
    drv = load_driver(cell)
    for seed in args.seeds:
        if args.control_only:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": control(cell, seed, args.device)}),
                  flush=True)
            continue
        facts = drv.run(cell, seed, args.seconds, False, args.device,
                        time.perf_counter(),
                        fault=half_batch if args.fault else None)
        row = {"workload": args.workload, "seed": seed, "fault": args.fault,
               "program": facts["readings"], "e2e": facts["e2e"],
               "check_s": facts["check_s"],
               "memory_peak_bytes": facts["memory_peak_bytes"]}
        if not args.fault:
            row["control"] = control(cell, seed, args.device)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
