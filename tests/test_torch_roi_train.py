"""The roi mechanism's training against the JAX package's, on the CPU at
``tests/test_roi.py``'s tiny configuration (``roi_resolution=8``,
``roi_top_k=16``, 64^2).

``test_torch_train._run_steps`` runs JAX ``make_train_step`` and the
port's step from the same variables on the same batches, the port's
``draw_augment`` replaced by JAX's key tree
(``test_torch_train_settings.jax_draws``). Two steps in float64 on both
sides, held at ``test_torch_train``'s tolerances: loss within 1e-4
relative, each metric (``box_iou`` among them) within 1e-4, every
gradient within 1e-3 of the largest gradient magnitude, params, BN
statistics and EMA within 1e-5. The roi step casts to float32 where the
JAX step does (the box decode, the crop, the IoU), on both sides.

Then each training setting with the mechanism through ``Trainer``, and
the accuracy tool with ``--mechanisms kernels,roi``;
``test_torch_roi_settings.py`` holds the settings of
``train_multiscale_fused`` in float64 against JAX.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import dataclasses
import functools
import json

import numpy as np
import pytest

import test_torch_train as TT
from basi_tpu.config import get_config as jax_get_config
from basi_tpu.infer import Inferencer as JaxInferencer
from basi_tpu_torch.config import get_config
from basi_tpu_torch.convert import to_jax_variables
from basi_tpu_torch.infer import Inferencer
from basi_tpu_torch.tools import bench_accuracy as BA
from basi_tpu_torch.train import step as TSTEP
from basi_tpu_torch.train.loop import Trainer

from test_torch_roi_model import ROI
from test_torch_train_settings import _settings_config, jax_draws


def _roi_settings_config(**changes):
    cfg = _settings_config(**changes)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              **ROI))


def _check_steps(cfg, monkeypatch):
    monkeypatch.setattr(TSTEP, "draw_augment", jax_draws(cfg))
    for out in TT._run_steps(cfg, "float64", monkeypatch):
        jm, tm = out[0], out[3]
        assert "box_iou" in jm and set(tm) == set(jm)
        assert float(jm["num_pos_cells"]) > 0
        TT._assert_step_matches(*out, 1e-3)


def test_roi_train_steps_match_jax(monkeypatch):
    """Two float64 steps of the roi mechanism (hflip 0.5, clipping active,
    cosine, EMA) against JAX's, at the tolerances above."""
    _check_steps(_roi_settings_config(), monkeypatch)


TINY = ["model.backbone=resnet_tiny", "model.fpn_channels=32",
        "model.mask_channels=32", "model.grid_size=8", "model.num_slots=8",
        "model.image_size=64", "data.image_size=64", "data.max_instances=4",
        "data.batch_size=4", "infer.batch_size=4", "infer.pre_nms_top_k=16",
        "infer.native_gt_cache=", "train.checkpoint_dir=", "train.log_every=1",
        "data.dataset=synthetic", "data.synthetic_n=8",
        "data.synthetic_orig_scale=1.0", "model.instance_mechanism=roi",
        "model.roi_resolution=8", "model.roi_top_k=16"]


@pytest.mark.parametrize("setting", [
    ["train.grad_accum=2"], ["train.freeze_bn=true"], ["train.remat=true"],
    ["train.optimizer=adamw"], ["model.bn_impl=fused"],
    ["model.bn_impl=stats"], ["model.param_dtype=bfloat16"],
    ["train.max_pos_cells=0"]], ids=lambda s: s[0])
def test_roi_trains_in_every_setting(setting):
    """The preset ``train_multiscale_fused`` (bf16 compute, the scale
    jitter) with the roi mechanism and each training setting:
    ``Trainer(device="cpu")`` takes two steps with finite losses, the box
    term among the metrics, and the params move. (``max_pos_cells=0``
    keeps 64 cells: the mechanism has no dense path.)"""
    tr = Trainer(get_config("train_multiscale_fused", TINY + setting),
                 device="cpu")
    before = {k: v.detach().float().clone()
              for k, v in tr.state.model.named_parameters()}
    last = tr.train(max_steps=2)
    assert tr.state.step == 2 and np.isfinite(last["loss"])
    assert np.isfinite(last["box_iou"]) and last["num_pos_cells"] > 0
    moved = [k for k, v in tr.state.model.named_parameters()
             if not np.array_equal(v.detach().float().numpy(),
                                   before[k].numpy())]
    assert any(k.startswith("roi_box.") for k in moved)
    assert any(k.startswith("roi_mask.") for k in moved)


BA_TINY = [o for o in TINY if not o.startswith((
    "model.instance_mechanism", "train.checkpoint_dir", "data.dataset",
    "data.synthetic_n", "data.synthetic_orig_scale"))] + [
    "data.synthetic_n=16", "model.dtype=float32", "infer.dtype=float32",
    "train.epochs=1", "train.log_every=4"]


def test_accuracy_tool_trains_kernels_and_roi(tmp_path, monkeypatch, capsys):
    """``bench_accuracy --mechanisms kernels,roi`` (the preset cut to the
    tiny model, one epoch of 16 scenes, the CPU): each mechanism trains
    from the shards into its own checkpoint and is evaluated in the
    original frame; the flagship is the one of the higher mAP; the roi
    record's final eval within 1e-3 of JAX's ``Inferencer.evaluate`` of
    the same checkpoint weights."""
    monkeypatch.setattr(BA, "get_config",
                        lambda preset, ov: get_config(preset, BA_TINY + ov))
    for name in ("run_training", "run_final_eval"):
        monkeypatch.setattr(BA, name, functools.partial(getattr(BA, name),
                                                        device="cpu"))
    out = tmp_path / "acc.json"
    assert BA.main(["--out", str(out), "--mechanisms", "kernels,roi",
                    "--ckpt-root", str(tmp_path)]) == 0
    res = json.loads(out.read_text())
    assert set(res["mAP"]) == {"kernels", "roi"}
    assert res["flagship"] == max(res["mAP"], key=res["mAP"].get)
    rec = res["roi"]
    assert rec["last_train_metrics"]["step"] == 4
    assert "box_iou" in rec["last_train_metrics"]
    assert rec["final_eval"]["num_images"] == 4
    capsys.readouterr()

    ov = BA_TINY + ["model.instance_mechanism=roi",
                    "infer.ap_at_original=true"]
    params, stats = to_jax_variables(Inferencer(
        get_config("bench_accuracy", ov), device="cpu",
        checkpoint=str(tmp_path / "roi")).model)
    want = JaxInferencer(jax_get_config("bench_accuracy", ov), params=params,
                         batch_stats=stats).evaluate()
    got = rec["final_eval"]
    for k in want:
        if k not in ("infer_ms_per_batch", "imgs_per_s"):
            assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
