"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything else is found from those names under the checkout's root:

- the configuration: the ``file`` of its ``configs`` entry;
- the traffic mix: ``perfbench/traffic/<traffic>.json``, whose ``driver``
  names the generator that reads it, ``perfbench/drivers/<driver>.py``;
- the limits of its correctness check: ``perfbench/limits/<workload>.json``;
- each per-layer metric: ``perfbench/metrics/<name>.py``, whose ``read``
  function takes the run's facts and returns the value or None.

So a later cell, mix or metric is new files and new entries, and no file
that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path


@dataclass
class Cell:
    root: Path
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _applies(entry: dict, workload: str, e2e_names: set) -> bool:
    if "workloads" in entry:
        return workload in entry["workloads"]
    return entry.get("moves", "") in e2e_names


def load_manifest(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of the manifest under ``root`` with its files
    read; raises KeyError for a name the manifest does not hold."""
    root = Path(root)
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in man["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "perfbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    limits_path = root / "perfbench" / "limits" / f"{workload}.json"
    with open(limits_path) as f:
        limits = json.load(f)
    e2e = [m for m in man["end_to_end"] if "workloads" not in m
           or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _applies(m, workload, names)]
    return Cell(root, workload, int(w["chips"]), config, traffic, limits,
                e2e, per_layer)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(cell: Cell):
    """The traffic mix's generator module (``run(cell, ...)``)."""
    name = cell.traffic["driver"]
    return _module(cell.root / "perfbench" / "drivers" / f"{name}.py",
                   f"perfbench_driver_{name}")


def load_reader(root: Path, metric: str):
    """The ``read(facts)`` function of per-layer metric ``metric``."""
    path = Path(root) / "perfbench" / "metrics" / f"{metric}.py"
    return _module(path, "perfbench_metric_" + metric.replace(".", "_")).read
