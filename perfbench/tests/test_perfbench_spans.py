"""The per-layer metrics that read the program's spans and sync counter
(``basi_tpu_torch.utils.profiling.report``): a tiny traced run of each
cell calls every one of them without error; on the CPU, with no CUDA
events to read, each reads None."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from tiny import run_tiny, tiny_cell  # noqa: E402

SPAN_METRICS = ("host_syncs_per_step.train", "ingest_ms.train",
                "targets_ms.train", "forward_ms.train", "loss_ms.train",
                "backward_ms.train", "update_ms.train", "roi_align_ms.train")


@pytest.mark.parametrize("workload", ["roi_train_b64", "roi_train_b64_fused"])
def test_traced_run_calls_every_span_reader(workload):
    from basi_tpu_torch.utils import profiling
    from perfbench.harness.manifest import load_reader
    from perfbench.run import ROOT

    cell = tiny_cell(workload)
    names = {m["name"] for m in cell.per_layer}
    assert set(SPAN_METRICS) <= names
    facts = run_tiny(workload, 5, trace=True, seconds=2.0)
    spans = profiling.report()["spans"]
    # the traced sub-window's steps, each through the six stages
    for stage in ("ingest", "targets", "forward", "loss", "backward",
                  "update"):
        assert spans[f"train.{stage}"]["calls"] == facts["trace_steps"]
    assert spans["roi.align"]["calls"] == 2 * facts["trace_steps"]
    for name in SPAN_METRICS:
        assert load_reader(ROOT, name)(facts) is None, name
    untraced = dict(facts, trace=None)
    assert all(load_reader(ROOT, n)(untraced) is None for n in SPAN_METRICS)
