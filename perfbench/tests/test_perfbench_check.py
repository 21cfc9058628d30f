"""The comparison that decides ``correct``, at a size the CPU runs: sound
runs pass it; a step that leaves its state unchanged, a step on half of
its batch, and the control (the reference in float8 put in the program's
place) fail it. The timed path is the cell's own driver with its check;
only the look for a card is skipped."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from tiny import run_tiny, tiny_cell  # noqa: E402

from perfbench.calibrate import control, half_batch  # noqa: E402

CELLS = ("roi_train_b64", "roi_train_b64_fused")


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    facts = run_tiny(workload, 2 ** 31 + 29)
    assert facts["failed"] == 0 and facts["steps"] > 0
    assert facts["correct"], facts["checks"]


def _unchanged(real, state, batch):
    """A step that returns its state unchanged."""
    return {"loss": torch.zeros(())}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_faults_are_not_correct(workload, fault):
    facts = run_tiny(workload, 2 ** 31 + 31, fault=fault)
    assert not facts["correct"], facts["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(workload):
    """float8 operands in every convolution and GEMM, in both passes (one
    precision below bf16), read above one of the cell's limits, on three
    seeds."""
    cell = tiny_cell(workload)
    for seed in (5, 6, 7):
        got = control(cell, seed, "cpu")
        assert any(got[k] > v for k, v in cell.limits.items()), (seed, got)


def test_traced_run_reads_every_per_layer_metric_it_can():
    from perfbench.harness.manifest import load_reader
    from perfbench.run import ROOT

    facts = run_tiny("roi_train_b64_fused", 3, trace=True, seconds=2.0)
    cell = tiny_cell("roi_train_b64_fused")
    got = {m["name"]: load_reader(ROOT, m["name"])(facts)
           for m in cell.per_layer}
    assert "bn_stats_roofline.train" in got
    assert got["train_step_call_ms.train"] > 0
    assert got["mfu.train"] > 0
    # no device on the CPU: a roofline reads nothing rather than 0
    assert got["upsample_int_roofline.train"] is None
    assert got["bn_stats_roofline.train"] is None
    assert np.isfinite(facts["trace"]["window_s"])
