"""The ConvNeXt cell (``convnext_b_roi_train_b64``) on the CPU, cut as
``tiny.py`` cuts the ResNet cells, its trunk the program's one-block
``convnext_test``: the cell, mix, driver and its four metrics load from
files alone; a sound run passes its check, and a step that leaves its
state unchanged, a step on half of its batch and the control fail it; a
traced run reads the four new metrics (None on the CPU, which records no
CUDA events) and the others it can; no JAX anywhere in what it loads."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from tiny import ROOT, tiny_cell  # noqa: E402

from perfbench.calibrate import half_batch  # noqa: E402
from perfbench.harness.manifest import (  # noqa: E402
    load_cell,
    load_driver,
    load_reader,
)

CELL = "convnext_b_roi_train_b64"
NEW_METRICS = ("convnext_dwconv_ms.train", "convnext_norm_ms.train",
               "convnext_mlp_ms.train", "convnext_dwconv_roofline.train")


def convnext_tiny_cell():
    cell = tiny_cell(CELL)
    cell.config[cell.traffic["driver"]]["overrides"].append(
        "model.backbone=convnext_test")
    return cell


def run_tiny(seed: int, fault=None, seconds: float = 1.5, trace=False,
             chunk: int = 2) -> dict:
    """A tiny run, the reference's batch of 4 in chunks of ``chunk``."""
    import time

    torch.set_num_threads(2)
    cell = convnext_tiny_cell()
    drv = load_driver(cell)
    drv.CHUNK = chunk
    return drv.run(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                   fault=fault)


def test_cell_loads_from_files():
    cell = load_cell(ROOT, CELL)
    assert cell.chips == 1
    assert cell.traffic["driver"] == "train_convnext"
    assert cell.config["name"] == "basi_convnext_b_roi"
    assert cell.config["train_convnext"]["model"]["backbone"] == \
        "convnext_base"
    assert set(cell.limits) == {"targets_gap", "grad_median", "grad_gap",
                                "update_gap", "ema_gap"}
    drv = load_driver(cell)
    assert callable(drv.run) and callable(drv.reference_steps)
    names = {m["name"] for m in cell.per_layer}
    assert set(NEW_METRICS) <= names
    assert "mfu.train" in names and "bn_stats_roofline.train" not in names
    for name in names:
        assert callable(load_reader(ROOT, name))
    for old in ("roi_train_b64", "roi_train_b64_fused"):
        got = {m["name"] for m in load_cell(ROOT, old).per_layer}
        assert not got & set(NEW_METRICS)


def test_weights_follow_the_program_state_dict():
    """The driver's weights load into the program's model strictly, the
    layer scale at the configuration's 1e-6."""
    from basi_tpu_torch.models.basi import create_model
    from perfbench.harness.config import plain_config, program_config

    cell = convnext_tiny_cell()
    cfg = program_config(cell)
    w = load_driver(cell).make_weights(
        plain_config(cfg)["model"], cell.config["weights"],
        torch.Generator().manual_seed(1), "cpu")
    model = create_model(cfg.model, "cpu")
    model.load_state_dict(w, strict=True)
    gammas = [v for k, v in w.items() if k.endswith(".gamma")]
    assert gammas and all(bool((g == 1e-6).all()) for g in gammas)


@pytest.mark.parametrize("chunk", [2, 4])
def test_sound_run_is_correct(chunk):
    facts = run_tiny(2 ** 31 + 29, chunk=chunk)
    assert facts["failed"] == 0 and facts["steps"] > 0
    assert facts["correct"], facts["checks"]


def _unchanged(real, state, batch):
    """A step that returns its state unchanged."""
    return {"loss": torch.zeros(())}


@pytest.mark.parametrize("fault", [_unchanged, half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_faults_are_not_correct(fault):
    facts = run_tiny(2 ** 31 + 31, fault=fault)
    assert not facts["correct"], facts["checks"]
    if fault is _unchanged:  # every leaf's gap reads 1, the median's too
        median = facts["checks"]["grad_median"]
        assert median["value"] > median["limit"], facts["checks"]


def test_control_fails_the_limits():
    """float8 operands in every convolution (the depthwise ones too) and
    GEMM, in both passes, read above one of the cell's limits, on three
    seeds."""
    from perfbench.calibrate_convnext import control

    cell = convnext_tiny_cell()
    drv = load_driver(cell)
    for seed in (5, 6, 7):
        got = control(cell, seed, "cpu", drv)
        assert any(got[k] > v for k, v in cell.limits.items()), (seed, got)


def test_traced_run_reads_the_new_metrics():
    from basi_tpu_torch.utils import profiling

    facts = run_tiny(3, trace=True, seconds=2.0)
    spans = profiling.report()["spans"]
    steps = facts["trace_steps"]
    assert spans["convnext.dwconv"]["calls"] == 4 * steps
    assert spans["convnext.mlp"]["calls"] == 4 * steps
    # the stem's, three between stages, four outputs, one a block
    assert spans["convnext.norm"]["calls"] == 12 * steps
    cell = convnext_tiny_cell()
    got = {m["name"]: load_reader(ROOT, m["name"])(facts)
           for m in cell.per_layer}
    assert all(got[n] is None for n in NEW_METRICS)  # no CUDA events here
    assert got["mfu.train"] > 0 and got["train_step_call_ms.train"] > 0
    assert facts["convnext_dwconv_bound_ms_per_step"] > 0
    untraced = dict(facts, trace=None)
    assert all(load_reader(ROOT, n)(untraced) is None for n in NEW_METRICS)


def test_dwconv_bound():
    """ConvNeXt-B's 36 forward depthwise convs at batch 64, 512^2: 1.56e9
    output elements, 98 operations each over 67 TFLOP/s."""
    from perfbench.harness import roofline_convnext as RX

    calls = RX.dwconv_calls(64, 512, (3, 3, 27, 3), (128, 256, 512, 1024))
    assert sum(b for _, b in calls) == 36
    assert RX.dwconv_bound_ms(calls) == pytest.approx(2.2822, abs=5e-4)


def test_flops_count_the_trunk():
    """The driver's count of a forward at ConvNeXt-B's size: the trunk's
    ~80 GMAC an image at 512^2 (15.4 at 224^2 in the paper) under the
    roi model's heads."""
    from perfbench.harness.config import plain_config, program_config

    cell = load_cell(ROOT, CELL)
    plain = plain_config(program_config(cell))
    flops = load_driver(cell).forward_flops(plain, 1)
    assert 200e9 < flops < 260e9


def test_the_run_loads_no_jax():
    """The cell's driver, its reference and calibration, and the program
    imported in a fresh process leave no forbidden module loaded."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench.harness.manifest import load_cell, load_driver\n"
            "from perfbench.run import forbidden_modules\n"
            "cell = load_cell(%r, %r)\n"
            "load_driver(cell)\n"
            "import basi_tpu_torch.train.loop, perfbench.calibrate_convnext\n"
            "import basi_tpu_torch.models.convnext\n"
            "print(forbidden_modules())\n") % (str(ROOT), str(ROOT), CELL)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
