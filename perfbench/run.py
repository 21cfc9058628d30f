"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``basi_tpu_torch``)
and a CUDA card. The cell, its configuration, traffic mix, limits and
per-layer metrics are found by name (``harness/manifest.py``). With
``--trace 0`` the line's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled sub-window.
Standard error gives the card's power limit, where set-up went, and, as
its last lines, each number compared with the reference beside its limit;
the result line carries them last, under ``checks``.
Without a card, or with fewer cards than the cell asks for, it prints no
result and exits with 2; if JAX or the JAX package was loaded, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "basi_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``basi_tpu_torch`` is not
    ``basi_tpu``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell, facts: dict, trace: bool, device: dict) -> dict:
    """The contract's result object from a driver's facts."""
    metrics = {}
    if trace:
        from perfbench.harness.manifest import load_reader

        for m in cell.per_layer:
            v = load_reader(cell.root, m["name"])(facts)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(facts["e2e"][m["name"]]),
                                  "unit": m["unit"]}
    line = {"correct": bool(facts["correct"]),
            "attempted": int(facts["attempted"]),
            "failed": int(facts["failed"]),
            "metrics": metrics,
            "device": device}
    if trace:
        from perfbench.harness.trace import breakdown

        t = facts["trace"]
        line["device"] = dict(device, busy_s=t["busy_s"],
                              window_s=t["window_s"])
        line["breakdown"] = breakdown(t)
    line["checks"] = facts["checks"]
    return line


def main(argv=None) -> int:
    args = _args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.harness.manifest import load_cell, load_driver

    cell = load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload}: needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    power = _power_limit()
    print(f"card: {torch.cuda.get_device_name(0)}, power limit {power}",
          file=sys.stderr)
    facts = load_driver(cell).run(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda:0", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(facts["memory_peak_bytes"])}
    line = result_line(cell, facts, bool(args.trace), device)
    print("setup_s " + ", ".join(f"{k} {v:.3f}" for k, v in
                                 facts["setup_parts"]), file=sys.stderr)
    print(f"checked {facts['checked']} steps in {facts['check_s']:.1f} s",
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line, allow_nan=True), flush=True)
    return 0


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


if __name__ == "__main__":
    sys.exit(main())
