"""The port's benchmark module (``basi_tpu_torch/benchmark.py``) on the
CPU at the tiny size: each mode prints the reference's keys (``metric``,
``value``, ``unit``) with the device it ran on and the kernel launches of
its window, and no TPU baseline (``vs_baseline``); the methodology pin
raises when the window is too small to amortize a single batch; e2e runs
files -> decode -> feed -> forward on a handful of PNGs and divides by the
infer rate it is given; ``run`` keeps ``--set`` to train and e2e, and
e2e's infer rate is the one the same call measures. The numbers here are
CPU numbers and stand for nothing on the card.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import json

import pytest

from basi_tpu_torch import benchmark as B
from basi_tpu_torch.cli import main

TINY = ["model.backbone=resnet_tiny", "model.image_size=64",
        "model.grid_size=8", "model.fpn_channels=32",
        "model.mask_channels=32", "model.num_slots=8", "data.image_size=64",
        "data.max_instances=4", "infer.pre_nms_top_k=16"]
KEYS = {"metric", "value", "unit", "device"}


def test_bench_infer_tiny():
    r = B._bench_infer(batch_size=2, iters=24, extra_overrides=TINY,
                       device="cpu")
    assert KEYS <= set(r) and "vs_baseline" not in r
    assert r["unit"] == "images/sec" and r["value"] > 0
    assert r["device"] == "cpu" and "bfloat16" in r["metric"]
    assert r["launches_per_batch"] == {}  # the CPU runs the plain versions
    json.dumps(r)


def test_bench_infer_pin_raises_when_the_window_shrinks():
    with pytest.raises(RuntimeError, match="methodology violated"):
        B._bench_infer(batch_size=2, iters=1, extra_overrides=TINY,
                       device="cpu")


def test_bench_train_tiny():
    r = B._bench_train(batch_size=2, iters=2,
                       extra_overrides=TINY + ["data.dataset=synthetic"],
                       device="cpu")
    assert KEYS <= set(r) and "vs_baseline" not in r
    assert r["unit"] == "ms/step" and r["value"] > 0
    assert "batch 2" in r["metric"] and "float32" in r["metric"]


def test_bench_e2e_tiny():
    r = B._bench_e2e(n_images=6, batch_size=2, extra_overrides=TINY,
                     infer_rate=50.0, device="cpu")
    assert KEYS <= set(r) and "vs_baseline" not in r
    assert "PNG" in r["metric"] and r["value"] > 0
    assert r["device_infer_imgs_per_s"] == 50.0
    per_core = r["ingest_imgs_per_s_per_core"]
    assert r["cores_to_saturate_device"] >= 1
    assert abs(r["cores_to_saturate_device"] - 50.0 / per_core) <= 1.05
    for k in ("ingest_only_imgs_per_s", "shards_e2e_imgs_per_s",
              "shards_ingest_only_imgs_per_s", "host_only_decode_imgs_per_s",
              "host_only_shards_imgs_per_s"):
        assert r[k] > 0, k
    with pytest.raises(ValueError, match=">= 2 batches"):
        B._bench_e2e(n_images=3, batch_size=2, extra_overrides=TINY,
                     infer_rate=1.0, device="cpu")


def test_run_keeps_set_to_train_and_e2e(monkeypatch, capsys):
    with pytest.raises(SystemExit):
        B.run("infer", ["infer.batch_size=2"], device="cpu")
    seen = {}

    def fake_infer(**kw):
        seen["infer"] = kw
        return {"value": 123.4}

    def fake_e2e(**kw):
        seen["e2e"] = kw
        return {"metric": "m", "value": 1.0, "unit": "u"}

    monkeypatch.setattr(B, "_bench_infer", fake_infer)
    monkeypatch.setattr(B, "_bench_e2e", fake_e2e)
    assert main(["bench", "--mode", "e2e", "--device", "cpu",
                 "--set", "infer.batch_size=4"]) == 0
    assert seen["e2e"]["infer_rate"] == 123.4
    assert seen["infer"]["extra_overrides"] == ["infer.batch_size=4"]
    assert seen["e2e"]["device"] == "cpu"
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        {"metric": "m", "value": 1.0, "unit": "u"}
