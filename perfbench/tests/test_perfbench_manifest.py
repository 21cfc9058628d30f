"""The manifest and the files it names; a cell, a mix and a metric added
as files and entries alone."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.harness.manifest import (  # noqa: E402
    load_cell,
    load_driver,
    load_manifest,
    load_reader,
)


def test_every_cell_loads_with_its_files():
    man = load_manifest(ROOT)
    assert len(man["workloads"]) >= 1
    for w in man["workloads"]:
        cell = load_cell(ROOT, w["name"])
        assert cell.chips == 1
        assert cell.traffic["driver"] == "train"
        assert load_driver(cell).run
        assert cell.config["name"] == w["config"]
        assert set(cell.limits) == {"targets_gap", "grad_median", "grad_gap",
                                    "update_gap", "ema_gap"}
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(load_reader(ROOT, m["name"]))
    for c in man["configs"]:
        assert any(w["config"] == c["name"] for w in man["workloads"])


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        load_cell(ROOT, "no_such_cell")


def test_extra_cell_mix_and_metric_from_files(tmp_path):
    """A later PR's cell, traffic mix and per-layer metric: new files and
    new manifest entries, no file that is there edited."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = load_manifest(ROOT)
    mix = json.loads((ROOT / "perfbench/traffic/train_staged_b64.json")
                     .read_text())
    mix.update(overrides=["data.batch_size=64", "model.remat=true"])
    (tmp_path / "perfbench/traffic/train_staged_b64_remat.json").write_text(
        json.dumps(mix))
    (tmp_path / "perfbench/limits/roi_train_b64_remat.json").write_text(
        json.dumps({"loss_gap": 0.5}))
    (tmp_path / "perfbench/metrics/feed_ms.train.py").write_text(
        "def read(facts):\n    return facts.get('feed_ms')\n")
    man["workloads"].append({"name": "roi_train_b64_remat",
                             "config": man["configs"][0]["name"],
                             "traffic": "train_staged_b64_remat", "chips": 1,
                             "why": "a later cell"})
    man["per_layer"].append({"name": "feed_ms.train", "unit": "ms",
                             "better": "lower", "source": "program_span",
                             "layer": "train.loop", "moves": "train_imgs_per_s",
                             "workloads": ["roi_train_b64_remat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = load_cell(tmp_path, "roi_train_b64_remat")
    assert cell.traffic["overrides"][-1] == "model.remat=true"
    assert cell.limits["loss_gap"] == 0.5
    names = [m["name"] for m in cell.per_layer]
    assert "feed_ms.train" in names
    read = load_reader(tmp_path, "feed_ms.train")
    assert read({"feed_ms": 3.5}) == 3.5
    assert read({}) is None
    # the cells that were there do not report the new metric
    old = load_cell(tmp_path, man["workloads"][0]["name"])
    assert "feed_ms.train" not in [m["name"] for m in old.per_layer]
