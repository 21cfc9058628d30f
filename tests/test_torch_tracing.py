"""The port's tracing (``basi_tpu_torch/utils/profiling.py``) on the CPU:
``span`` off and on, its table and the Chrome trace, the table's fresh
start, the sync counter's attribution, the training step's six stages and
``roi.align``, and ``Trainer.train`` under ``profile`` (``basi-torch train
--profile``) with its ``[train]`` records' ``feed_wait_ms``.

The sync counter's notices come from torch's sync debug mode, which only
a CUDA device raises; here the notice is raised as torch words it
(``SYNC_MESSAGE``). The card's own syncs are counted in
``tests/test_torch_gpu.py``.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import json
import os
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from basi_tpu_torch.cli import main
from basi_tpu_torch.config import get_config
from basi_tpu_torch.train import step as TSTEP
from basi_tpu_torch.train.loop import Trainer
from basi_tpu_torch.utils import profiling as P

SETS = [
    "model.backbone=resnet_tiny", "model.image_size=64", "model.grid_size=8",
    "model.fpn_channels=32", "model.mask_channels=32", "data.image_size=64",
    "data.dataset=synthetic", "data.batch_size=4", "data.synthetic_n=16",
    "data.max_instances=4", "infer.batch_size=4", "infer.dtype=float32",
    "model.dtype=float32", "model.instance_mechanism=roi",
    "model.roi_resolution=8", "model.roi_top_k=16", "train.checkpoint_dir=",
]
STAGES = ("train.ingest", "train.targets", "train.forward", "train.loss",
          "train.backward", "train.update")


def _warn_sync():
    warnings.warn(P.SYNC_MESSAGE)


def _line_of(fn, text: str) -> int:
    """The line of ``fn``'s source file that holds ``text``."""
    import inspect

    lines, first = inspect.getsourcelines(fn)
    (i,) = [i for i, s in enumerate(lines) if text in s]
    return first + i


@pytest.fixture()
def table():
    P.reset()
    yield
    P.reset()


def test_span_off_records_nothing_and_opens_no_range(table, monkeypatch):
    def no_range(name):
        raise AssertionError(f"opened a range {name!r}")

    monkeypatch.setattr(P, "record_function", no_range)
    with P.span("train.forward"):
        torch.ones(8).sum()
    assert P.span("x") is P.span("y")  # the one shared no-op
    assert P.report() == {"spans": {}, "syncs": {"count": 0, "by_span": {},
                                                 "by_site": {}}}


def test_nested_spans_land_in_the_table_and_the_chrome_trace(table, tmp_path):
    with P.maybe_trace(True, str(tmp_path)) as path:
        for _ in range(3):
            with P.span("outer.stage"):
                with P.span("inner.stage"):
                    torch.ones(64, 64).sum()
    names = {e.get("name") for e in json.loads(
        open(path).read())["traceEvents"]}
    assert {"outer.stage", "inner.stage"} <= names
    (spans_file,) = tmp_path.glob("spans_*.json")
    assert spans_file.name == "spans_" + path.rsplit("trace_", 1)[1]
    rep = json.loads(spans_file.read_text())
    outer, inner = rep["spans"]["outer.stage"], rep["spans"]["inner.stage"]
    assert outer["calls"] == inner["calls"] == 3
    assert outer["host_s"] >= inner["host_s"] > 0
    assert outer["device_s"] is None  # no CUDA events on the CPU
    assert rep["syncs"]["count"] == 0


def test_a_fresh_traced_stretch_starts_a_fresh_table(table):
    with torch.profiler.profile():
        with P.span("first"):
            pass
    assert set(P.report()["spans"]) == {"first"}
    with P.span("seen.off"):  # the profiler is off here
        pass
    with torch.profiler.profile():
        with P.span("second"):
            pass
        with P.span("second"):
            pass
    assert P.report()["spans"]["second"]["calls"] == 2
    assert set(P.report()["spans"]) == {"second"}
    P.reset()
    assert P.report()["spans"] == {}


def test_a_sync_notice_goes_to_the_innermost_span_and_port_frame(table):
    """Outside the port the site is the innermost frame outside torch;
    inside it, the innermost frame of ``basi_tpu_torch``: here the train
    step's call of its schedule, in ``train.update``. Other warnings pass
    through, and nothing is counted outside spans."""
    cfg = get_config("", SETS)
    trainer = Trainer(cfg, device="cpu")
    batch = next(iter(trainer.feed.epoch(0)))

    def schedule(step):
        _warn_sync()
        return 1e-3

    step = TSTEP.make_train_step(cfg.train, cfg.data, schedule,
                                 trainer.dtype)
    with torch.profiler.profile():
        _warn_sync_line = _line_of(_warn_sync, "warnings.warn")
        with P.span("outer.stage"):
            with P.span("inner.stage"):
                _warn_sync()
            with pytest.warns(UserWarning, match="another notice"):
                warnings.warn("another notice")
        step(trainer.state, batch)
    with pytest.warns(UserWarning, match="synchronizing"):
        _warn_sync()  # outside any span: shown, not counted
    syncs = P.report()["syncs"]
    here = f"tests/test_torch_tracing.py:{_warn_sync_line}"
    at = "basi_tpu_torch/train/step.py:" + str(_line_of(
        TSTEP.make_train_step, "schedule(state.step)"))
    assert syncs == {"count": 2,
                     "by_span": {"inner.stage": 1, "train.update": 1},
                     "by_site": {here: {"inner.stage": 1},
                                 at: {"train.update": 1}}}


def test_spans_of_many_threads_keep_the_table_and_put_the_hook_back(table):
    """More threads than cores open nested spans and raise sync notices
    with a short switch interval: every call and notice is counted once,
    against its own thread's innermost span, and the warnings hook is put
    back when the last span closes."""
    before = warnings.showwarning
    rounds = 40
    threads = [threading.Thread(target=_span_rounds, args=(rounds,))
               for _ in range((os.cpu_count() or 1) + 2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile():
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    n = rounds * len(threads)
    rep = P.report()
    assert rep["spans"]["thread.outer"]["calls"] == n
    assert rep["spans"]["thread.inner"]["calls"] == n
    assert rep["syncs"]["by_span"] == {"thread.inner": n}
    assert warnings.showwarning is before


def _span_rounds(rounds: int):
    for _ in range(rounds):
        with P.span("thread.outer"):
            with P.span("thread.inner"):
                _warn_sync()


def test_a_roi_train_step_records_each_stage_once(table):
    cfg = get_config("", SETS)
    trainer = Trainer(cfg, device="cpu")
    batch = next(iter(trainer.feed.epoch(0)))
    trainer.train_step(trainer.state, batch)  # not traced
    with torch.profiler.profile() as prof:
        trainer.train_step(trainer.state, batch)
    spans = P.report()["spans"]
    assert set(spans) == set(STAGES) | {"roi.align"}
    assert all(spans[s]["calls"] == 1 for s in STAGES)
    assert spans["roi.align"]["calls"] == 2  # the head's crops, the loss's
    ranges = [e for e in prof.events() if e.name in spans]
    assert {e.name for e in ranges} == set(spans)
    # the stages tile the step in order; roi.align lies inside a stage
    stages = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in ranges if e.name in STAGES)
    assert [s[2] for s in stages] == list(STAGES)
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))
    for e in ranges:
        if e.name == "roi.align":
            (owner,) = [s[2] for s in stages if s[0] <= e.time_range.start
                        and e.time_range.end <= s[1]]
            assert owner in ("train.forward", "train.loss")


def test_grad_accum_stages_run_once_a_micro_batch(table):
    cfg = get_config("", SETS + ["train.grad_accum=2"])
    trainer = Trainer(cfg, device="cpu")
    batch = next(iter(trainer.feed.epoch(0)))
    with torch.profiler.profile():
        metrics = trainer.train_step(trainer.state, batch)
    spans = P.report()["spans"]
    assert [spans[s]["calls"] for s in STAGES] == [2, 2, 2, 2, 2, 1]
    assert np.isfinite(float(metrics["loss"]))


def test_train_records_feed_wait_ms():
    cfg = get_config("", SETS + ["train.log_every=1"])
    trainer = Trainer(cfg, device="cpu")
    trainer.train(max_steps=3)
    recs = trainer.records
    assert len(recs) == 3
    assert all(0 <= r["feed_wait_ms"] <= r["step_ms"] for r in recs)


def test_cli_train_profile_writes_the_trace_and_its_report(tmp_path, capsys):
    args = [a for s in SETS + ["train.epochs=1", f"profile_dir={tmp_path}"]
            for a in ("--set", s)]
    assert main(["train", *args, "--device", "cpu", "--profile"]) == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert final["final"]["step"] == 4
    (trace,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert set(STAGES) | {"roi.align", "eval.forward"} <= names
    (spans_file,) = tmp_path.glob("spans_*.json")
    spans = json.loads(spans_file.read_text())["spans"]
    assert all(spans[s]["calls"] == 4 for s in STAGES)
    assert spans["eval.forward"]["calls"] >= 1
