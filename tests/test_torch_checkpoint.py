"""Checkpoints, resume, the preemption stop, metric records and the
accuracy tool of the port, on the CPU (the cases of
``tests/test_checkpoint.py``, ``test_checkpoint_io.py``,
``test_preemption.py`` and ``test_logging.py``, on the port).

* A run stopped and resumed equals an uninterrupted one bit for bit:
  params, BatchNorm statistics, momentum, EMA, generator and step (the CPU
  is deterministic; on the card ``chip_smoke.py`` phase 8 holds the round
  trip bit-equal and the resumed schedule exact).
* The step directories: one per saved step, moved into place whole;
  retention; a crashed write that ``latest_step`` ignores; ``resume`` auto,
  none, a step, a directory, and a missing path that fails without making
  it; the EMA switched on or off across a resume.
* ``Inferencer(checkpoint=...)``: a Trainer checkpoint (EMA preferred) or a
  state dict file as ``basi export --torch`` writes it.
* ``tools/bench_accuracy.py`` at a tiny size: packing, ``run_training``
  and ``run_final_eval``; the checkpoint's weights through JAX's
  ``Inferencer.evaluate`` in the original frame give the port's metrics
  within 1e-3.
* The tests' Trainers write no ``ckpt/`` into the working directory.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import dataclasses
import json
import os
import pathlib
import signal

import numpy as np
import pytest
import torch

from basi_tpu.config import get_config as jax_get_config
from basi_tpu.convert.torch_export import export_basinet as jax_export_basinet
from basi_tpu.infer import Inferencer as JaxInferencer
from basi_tpu_torch.config import get_config
from basi_tpu_torch.convert import to_jax_variables
from basi_tpu_torch.infer import Inferencer
from basi_tpu_torch.models.basi import create_model
from basi_tpu_torch.tools import bench_accuracy as BA
from basi_tpu_torch.train.loop import Trainer
from basi_tpu_torch.train.state import create_train_state
from basi_tpu_torch.utils.checkpoint import STATE_FILE, CheckpointManager
from basi_tpu_torch.utils.logging import MetricLogger

from helpers import tiny_config
from test_torch_model import jax_variables

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMING = ("infer_ms_per_batch", "imgs_per_s")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny model's steps gain nothing from intra-op threads, and the
    suite runs several workers on one host: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tmp_path, epochs: int = 2, name: str = "ckpt", **train):
    """Tiny model, 16 scenes in batches of 4: 4 steps an epoch; the val
    split (4 images) is one eval batch."""
    cfg = tiny_config(batch_size=4)
    train = {"ema_decay": 0.9, "log_every": 100, "resume": "auto", **train}
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, synthetic_n=16),
        train=dataclasses.replace(
            cfg.train, epochs=epochs, checkpoint_dir=str(tmp_path / name),
            **train))


def _stop_after(trainer: Trainer, n: int, action) -> None:
    """``action`` runs after the ``n``-th step of ``trainer``."""
    orig, calls = trainer.train_step, []

    def wrapped(state, batch):
        out = orig(state, batch)
        calls.append(1)
        if len(calls) == n:
            action()
        return out

    trainer.train_step = wrapped


def _snapshot(tr: Trainer) -> dict:
    s = tr.state
    return {"model": {k: v.clone() for k, v in s.model.state_dict().items()},
            "momentum": [s.optimizer.state[p]["momentum_buffer"].clone()
                         for p in s.model.parameters()],
            "ema": {k: v.clone() for k, v in s.ema.items()},
            "generator": s.generator.get_state(), "step": s.step}


def _assert_states_equal(a: dict, b: dict) -> None:
    assert a["step"] == b["step"]
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for x, y in zip(a["momentum"], b["momentum"]):
        assert torch.equal(x, y)
    for k in a["ema"]:
        assert torch.equal(a["ema"][k], b["ema"][k]), k
    assert torch.equal(a["generator"], b["generator"])


# --- bitwise resume, mid-epoch, no duplicate step -------------------------------

def test_bitwise_resume(tmp_path):
    """Stopped after step 3 (mid-epoch), resumed in a new Trainer: the
    remaining 5 steps give the uninterrupted run's state bit for bit, and
    the same losses at the same steps."""
    full = Trainer(_cfg(tmp_path, name="full"), device="cpu")
    losses = {}
    full.train_step = _recording(full.train_step, full, losses)
    full.train()
    want = _snapshot(full)

    tr = Trainer(_cfg(tmp_path), device="cpu")
    _stop_after(tr, 3, lambda: tr._preempt.set())
    res = tr.train()
    assert res["preempted_at_step"] == 3 and tr.state.step == 3
    resumed = Trainer(_cfg(tmp_path), device="cpu")
    assert resumed.state.step == 3
    got_losses = {}
    resumed.train_step = _recording(resumed.train_step, resumed, got_losses)
    resumed.train()
    assert sorted(got_losses) == [4, 5, 6, 7, 8]
    assert got_losses == {k: losses[k] for k in got_losses}
    _assert_states_equal(_snapshot(resumed), want)
    assert resumed.ckpt.steps() == [3, 4, 8]


def _recording(step_fn, tr, out: dict):
    def wrapped(state, batch):
        metrics = step_fn(state, batch)
        out[tr.state.step] = float(metrics["loss"])
        return metrics
    return wrapped


def test_mid_epoch_resume_skips_trained_batches(tmp_path):
    """A restored step 2 trains the epoch's last 2 batches, never 2 + 4,
    and they are the uninterrupted run's batches 3 and 4."""
    Trainer(_cfg(tmp_path, epochs=1, checkpoint_every_steps=2),
            device="cpu").train()
    t2 = Trainer(_cfg(tmp_path, epochs=1, name="ckpt2", resume="none"),
                 device="cpu")
    CheckpointManager(str(tmp_path / "ckpt")).restore(t2.state, 2)
    assert t2.state.step == 2
    seen = []
    orig = t2.feed.epoch

    def epoch(e, skip=0):
        for b in orig(e, skip):
            seen.append(b)
            yield b

    t2.feed.epoch = epoch
    t2.train()
    assert t2.state.step == 4 and len(seen) == 2
    want = list(orig(0))[2:]
    for a, b in zip(seen, want):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_in_loop_and_epoch_save_no_duplicate_step(tmp_path):
    """``checkpoint_every_steps`` dividing the epoch: the epoch's save
    skips the step the loop saved."""
    tr = Trainer(_cfg(tmp_path, epochs=1, checkpoint_every_steps=4),
                 device="cpu")
    tr.train()
    assert tr.ckpt.steps() == [4]


def test_retention_and_a_crashed_write(tmp_path):
    """``keep_checkpoints`` newest steps stay; a writer's directory that
    was never moved into place, and a step directory without its file,
    are not steps."""
    cfg = _cfg(tmp_path, epochs=1, checkpoint_every_steps=1,
               keep_checkpoints=2)
    tr = Trainer(cfg, device="cpu")
    tr.train()
    root = tmp_path / "ckpt"
    assert sorted(os.listdir(root)) == ["3", "4"]
    (root / ".tmp-9-crash").mkdir()
    (root / ".tmp-9-crash" / STATE_FILE).write_bytes(b"half")
    (root / "7").mkdir()
    mgr = CheckpointManager(str(root))
    assert mgr.latest_step() == 4 and mgr.steps() == [3, 4]
    assert Trainer(cfg, device="cpu").state.step == 4  # resume auto
    with pytest.raises(FileExistsError):
        mgr.save(tr.state)


# --- the manager ------------------------------------------------------------------

def _state(cfg, seed=0):
    model = create_model(cfg.model, "cpu", torch.Generator().manual_seed(seed),
                         train=True)
    return create_train_state(model, cfg.train)


def test_save_load_round_trip_is_bit_equal(tmp_path):
    tr = Trainer(_cfg(tmp_path, epochs=1), device="cpu")
    tr.train(max_steps=2)
    want = _snapshot(tr)
    mgr = CheckpointManager(str(tmp_path / "rt"))
    mgr.save(tr.state)
    raw = mgr.load()
    assert raw["step"] == 2 and set(raw["model"]) == set(want["model"])
    for k, v in want["model"].items():
        assert torch.equal(raw["model"][k], v), k
    fresh = _state(_cfg(tmp_path, epochs=1), seed=5)
    mgr.restore(fresh)
    got = {"model": fresh.model.state_dict(), "step": fresh.step,
           "momentum": [fresh.optimizer.state[p]["momentum_buffer"]
                        for p in fresh.model.parameters()],
           "ema": fresh.ema, "generator": fresh.generator.get_state()}
    _assert_states_equal(got, want)
    assert fresh.optimizer.param_groups[0]["momentum"] == 0.9


def test_maybe_resume_from_path(tmp_path):
    """``resume`` as another directory restores its newest step; ``none``
    returns the state untouched; a step number restores that step."""
    tr = Trainer(_cfg(tmp_path, epochs=1, name="src",
                      checkpoint_every_steps=1), device="cpu")
    tr.train(max_steps=2)
    dst = CheckpointManager(str(tmp_path / "dst"))  # empty
    state = _state(_cfg(tmp_path))
    assert dst.maybe_resume(state, "none") is state and state.step == 0
    dst.maybe_resume(state, str(tmp_path / "src"))
    assert state.step == 2
    for k, v in tr.state.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    src = CheckpointManager(str(tmp_path / "src"))
    assert src.maybe_resume(state, "1").step == 1
    assert not (tmp_path / "dst").exists()


def test_resume_missing_path_fails_fast(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    missing = tmp_path / "nope"
    with pytest.raises(FileNotFoundError):
        mgr.maybe_resume(None, resume=str(missing))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        mgr.restore(None)
    assert not missing.exists() and not (tmp_path / "ckpt").exists()
    with pytest.raises(FileNotFoundError):
        Trainer(_cfg(tmp_path, resume=str(missing)), device="cpu")


@pytest.mark.parametrize("saved_ema,resumed_ema", [(0.9, 0.0), (0.0, 0.9)])
def test_ema_switched_across_a_resume(tmp_path, saved_ema, resumed_ema):
    """EMA on at the save and off now: dropped. Off at the save and on
    now: it starts at the restored params."""
    tr = Trainer(_cfg(tmp_path, epochs=1, ema_decay=saved_ema),
                 device="cpu")
    tr.train(max_steps=1)
    CheckpointManager(str(tmp_path / "ckpt")).save(tr.state)
    back = Trainer(_cfg(tmp_path, epochs=1, ema_decay=resumed_ema),
                   device="cpu")
    assert back.state.step == 1
    if resumed_ema:
        for k, p in back.state.model.named_parameters():
            assert torch.equal(back.state.ema[k], p), k
            assert torch.equal(p, tr.state.model.state_dict()[k]), k
    else:
        assert back.state.ema is None


def test_restore_weights_prefers_the_ema(tmp_path):
    tr = Trainer(_cfg(tmp_path, epochs=1), device="cpu")
    tr.train(max_steps=2)
    CheckpointManager(str(tmp_path / "ckpt")).save(tr.state)
    sd = CheckpointManager(str(tmp_path / "ckpt")).restore_weights()
    want = tr.eval_state_dict()
    assert set(sd) == set(want)
    assert all(torch.equal(sd[k], want[k]) for k in want)
    assert not torch.equal(sd["instance.score.bias"],
                           tr.state.model.instance.score.bias)


def test_async_checkpoint_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        CheckpointManager(str(tmp_path), async_save=True)


# --- Inferencer(checkpoint=...) -------------------------------------------------------

def test_inferencer_loads_both_formats(tmp_path):
    """A Trainer checkpoint directory (EMA weights) and a state dict file
    written as ``basi export --torch`` writes it, from JAX variables."""
    tr = Trainer(_cfg(tmp_path, epochs=1), device="cpu")
    tr.train(max_steps=2)
    CheckpointManager(str(tmp_path / "ckpt")).save(tr.state)
    cfg = _cfg(tmp_path)
    inf = Inferencer(cfg, device="cpu", checkpoint=str(tmp_path / "ckpt"))
    want = tr.eval_state_dict()
    for k, v in inf.model.state_dict().items():
        assert torch.equal(v, want[k].to(v.dtype)), k

    params, stats = jax_variables(cfg, seed=4)
    sd = jax_export_basinet(params, stats, stage_sizes=(1, 1, 1, 1),
                            backbone="resnet_tiny")
    path = tmp_path / "export.pth"
    torch.save({k: torch.from_numpy(np.asarray(v).copy())
                for k, v in sd.items()}, path)
    from_file = Inferencer(cfg, device="cpu", checkpoint=str(path))
    from_jax = Inferencer(cfg, device="cpu", params=params,
                          batch_stats=stats)
    for k, v in from_jax.model.state_dict().items():
        assert torch.equal(from_file.model.state_dict()[k], v), k
    for bad in (tmp_path / "missing", tmp_path / "empty"):
        if bad.name == "empty":
            bad.mkdir()
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            Inferencer(cfg, device="cpu", checkpoint=str(bad))


# --- the preemption stop ----------------------------------------------------------------

def test_graceful_stop_saves_and_resumes(tmp_path):
    cfg = _cfg(tmp_path, epochs=1)  # 4 steps
    tr = Trainer(cfg, device="cpu")
    _stop_after(tr, 3, lambda: tr._preempt.set())
    res = tr.train()
    tr.close()
    assert res["preempted_at_step"] == 3 and res["epoch"] == 0
    assert res["checkpoint_saved"] is True
    tr2 = Trainer(cfg, device="cpu")
    assert tr2.state.step == 3
    res2 = tr2.train()
    assert "preempted_at_step" not in res2
    assert tr2.state.step == tr2.max_steps == 4


def test_sigterm_handler_commits_checkpoint(tmp_path):
    cfg = _cfg(tmp_path)
    tr = Trainer(cfg, device="cpu")
    _stop_after(tr, 2, lambda: os.kill(os.getpid(), signal.SIGTERM))
    prev = signal.getsignal(signal.SIGTERM)
    res = tr.train()
    assert res["preempted_at_step"] == 2
    assert signal.getsignal(signal.SIGTERM) == prev  # put back
    assert CheckpointManager(cfg.train.checkpoint_dir).latest_step() == 2


def test_preempted_state_matches_uninterrupted_prefix(tmp_path):
    """The committed state equals a run stopped at the same step: the stop
    adds no update."""
    tr = Trainer(_cfg(tmp_path), device="cpu")
    _stop_after(tr, 3, lambda: tr._preempt.set())
    tr.train()
    ref = Trainer(_cfg(tmp_path, name="ckpt2"), device="cpu")
    ref.train(max_steps=3)
    _assert_states_equal(_snapshot(tr), _snapshot(ref))
    back = _state(_cfg(tmp_path), seed=7)
    CheckpointManager(str(tmp_path / "ckpt")).restore(back)
    for k, v in ref.state.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k


def test_opt_out_ignores_flag_installs_no_handler(tmp_path):
    cfg = _cfg(tmp_path, epochs=1, save_on_preemption=False)
    tr = Trainer(cfg, device="cpu")
    seen = []
    _stop_after(tr, 1, lambda: seen.append(signal.getsignal(signal.SIGTERM)))
    res = tr.train()
    assert "preempted_at_step" not in res
    assert tr.state.step == tr.max_steps
    assert seen[0] == signal.getsignal(signal.SIGTERM)
    assert not callable(seen[0]) or seen[0] in (
        signal.SIG_DFL, signal.SIG_IGN, signal.default_int_handler)


# --- metric records -------------------------------------------------------------------

def test_jsonl_records(tmp_path):
    path = str(tmp_path / "m.jsonl")
    lg = MetricLogger(path, console=False)
    lg.log({"step": 1, "loss": np.float32(0.5)})
    lg.log({"step": 2, "loss": torch.tensor(0.25), "note": "x",
            "lr": 1.0 / 3.0})
    lg.close()
    lg.close()  # idempotent
    lg.log({"step": 3})  # console only after close
    recs = [json.loads(line) for line in open(path)]
    assert [r["step"] for r in recs] == [1, 2]
    assert recs[1] == {"t": recs[1]["t"], "step": 2, "loss": 0.25,
                       "note": "x", "lr": 0.333333}
    with pytest.raises(NotImplementedError, match="not yet ported"):
        MetricLogger("", tensorboard_dir=str(tmp_path / "tb"))


def test_trainer_writes_metrics_path(tmp_path, capsys):
    """``metrics_path`` gets the ``[train]``, ``[val]`` and ``[preempt]``
    records as JSON lines; the console prints each as ``prefix {json}``."""
    cfg = dataclasses.replace(_cfg(tmp_path, log_every=2),
                              metrics_path=str(tmp_path / "m.jsonl"))
    tr = Trainer(cfg, device="cpu")
    _stop_after(tr, 6, lambda: tr._preempt.set())
    tr.train()
    tr.close()
    recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [r.get("step") for r in recs if "loss" in r] == [2, 4, 6]
    assert [r["epoch"] for r in recs if "mAP" in r] == [0]
    assert recs[-1]["preempted_at_step"] == 6
    out = capsys.readouterr().out
    assert out.count("[train] ") == 3 and out.count("[val] ") == 1
    assert json.loads(out.split("[preempt] ")[1].splitlines()[0]) == {
        "preempted_at_step": 6, "epoch": 1, "checkpoint_saved": True}


# --- the accuracy tool ------------------------------------------------------------------

TINY = ["model.backbone=resnet_tiny", "model.fpn_channels=32",
        "model.mask_channels=32", "model.grid_size=8", "model.num_slots=8",
        "model.image_size=64", "data.image_size=64", "data.max_instances=4",
        "data.synthetic_n=16", "data.batch_size=4", "infer.batch_size=4",
        "model.dtype=float32", "infer.dtype=float32", "infer.pre_nms_top_k=16",
        "infer.native_gt_cache=", "train.epochs=2", "train.log_every=4"]


def test_accuracy_tool_trains_from_shards_and_evaluates_the_checkpoint(
        tmp_path, capsys):
    """``pack_splits``, ``run_training`` (2 epochs from the shards, a
    checkpoint each epoch, the per-epoch eval on the val shards) and
    ``run_final_eval`` (the checkpoint's EMA weights in the original
    frame on the raw val split), the JAX tool's keys; JAX's
    ``Inferencer.evaluate`` on the same weights within 1e-3."""
    train_ov = BA.pack_splits(TINY, str(tmp_path / "shards"))
    assert train_ov[-2:] == ["data.dataset=shards",
                             f"data.root={tmp_path / 'shards'}"]
    for split, n in (("train", 16), ("val", 4)):
        index = json.load(open(tmp_path / "shards" / split / "index.json"))
        assert index["n"] == n and index["image_size"] == 64
    ckpt = str(tmp_path / "kernels")
    rec = BA.run_training(train_ov + ["model.instance_mechanism=kernels"],
                          ckpt, device="cpu")
    assert set(rec) == {"train_wall_s", "last_train_metrics"}
    assert rec["last_train_metrics"]["step"] == 8
    assert "mAP" in rec["last_train_metrics"]
    assert CheckpointManager(ckpt).steps() == [4, 8]
    out = capsys.readouterr().out
    assert out.count("[val] ") == 2

    got = BA.run_final_eval("kernels", ckpt, TINY, device="cpu")
    assert got["num_images"] == 4 and "eval_wall_s" in got
    cfg = get_config("bench_accuracy", TINY + ["infer.ap_at_original=true"])
    assert cfg.data.synthetic_orig_scale == 1.5
    params, stats = to_jax_variables(
        Inferencer(cfg, device="cpu", checkpoint=ckpt).model)
    jcfg = jax_get_config("bench_accuracy",
                          TINY + ["infer.ap_at_original=true"])
    want = JaxInferencer(jcfg, params=params, batch_stats=stats).evaluate()
    keys = [k for k in want if k not in TIMING]
    assert set(keys) <= set(got)
    for k in keys:
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


def test_accuracy_tool_refusals(tmp_path):
    with pytest.raises(SystemExit):
        BA.main([])  # --out is required
    with pytest.raises(SystemExit, match="JAX package's records"):
        BA.main(["--out", str(ROOT / "bench_accuracy.json")])
    for mech, err in (("roi,connected", NotImplementedError),
                      ("connected", NotImplementedError),
                      ("nope", ValueError)):
        with pytest.raises(err):
            BA.main(["--out", str(tmp_path / "r.json"), "--mechanisms", mech,
                     "--ckpt-root", str(tmp_path / "c")])
    assert not (tmp_path / "c").exists()


# --- nothing left behind --------------------------------------------------------------

def test_tests_leave_no_ckpt_directory(tmp_path, monkeypatch):
    """The shared tiny config checkpoints nowhere: a Trainer of it trains
    an epoch in an empty working directory and leaves it empty; and no
    ``ckpt/`` stands in the repo or the working directory of the run."""
    monkeypatch.chdir(tmp_path)
    cfg = tiny_config(batch_size=4)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, synthetic_n=8))
    assert cfg.train.checkpoint_dir == ""
    tr = Trainer(cfg, device="cpu")
    tr.train()
    assert tr.ckpt is None and os.listdir(tmp_path) == []
    monkeypatch.undo()
    for where in {ROOT, pathlib.Path.cwd()}:
        assert not (where / "ckpt").exists(), where
