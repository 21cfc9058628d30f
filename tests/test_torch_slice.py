"""The port's serving slice against the JAX package's, end to end.

The same uint8 batch and the same JAX variables (zero objectness bias,
non-trivial BN stats: ``test_torch_model.jax_variables``) go through the
JAX ``Inferencer`` (``predict_batch`` + ``full_res_masks``) and the port's
``Inferencer`` and ``BatchedPredictor``, in f32 on the tiny config. The
repo's per-pixel budget holds everywhere: slot scores, /4 slot masks and
full-resolution masks agree within 1e-3, and slots come in the same order
wherever neighbouring scores differ by more than 1e-3 (closer scores may
swap: their order is a rounding decision). At least one slot is filled.

The ``BatchedPredictor`` behaviours of ``tests/test_serve.py`` follow, and
a subprocess checks that the port loads neither jax, flax nor the JAX
package.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from basi_tpu.infer import Inferencer as JaxInferencer
from basi_tpu_torch.infer import Inferencer
from basi_tpu_torch.ops import nms as torch_nms
from basi_tpu_torch.serve import BatchedPredictor

from helpers import tiny_config
from test_torch_model import jax_variables

TOL = 1e-3
BATCH = 4


@pytest.fixture(scope="module")
def case():
    cfg = tiny_config(batch_size=BATCH)
    params, stats = jax_variables(cfg)
    images = (np.random.RandomState(2).rand(BATCH, 64, 64, 3) * 255).astype(
        np.uint8)
    jinf = JaxInferencer(cfg, params=params, batch_stats=stats)
    masks, scores, sal = jinf.predict_batch(images)
    full = jinf.full_res_masks(masks)
    want = {"masks": np.asarray(masks, np.float32),
            "scores": np.asarray(scores, np.float32),
            "sal": np.asarray(sal, np.float32),
            "full": np.asarray(full, np.float32)}
    return cfg, params, stats, images, want


def assert_slots_match(got_scores, got_masks, want_scores, want_masks,
                       tol=TOL, mask_tol=None):
    """Per image: scores within ``tol`` slot by slot; each slot's mask
    matches the JAX mask at the same slot within ``mask_tol`` (default
    ``tol``), or, inside a run of scores within ``tol`` of each other, the
    mask of some slot of that run."""
    mask_tol = tol if mask_tol is None else mask_tol
    np.testing.assert_allclose(got_scores, want_scores, atol=tol, rtol=0)
    for i in range(len(want_scores)):
        s = want_scores[i]
        for k in range(len(s)):
            run = [j for j in range(len(s)) if abs(s[j] - s[k]) <= tol]
            if len(run) == 1:
                np.testing.assert_allclose(got_masks[i, k], want_masks[i, k],
                                           atol=mask_tol, rtol=0)
            else:
                assert any(np.abs(got_masks[i, k] - want_masks[i, j]).max()
                           <= mask_tol for j in run), (i, k, run)


def test_inferencer_matches_jax(case):
    cfg, params, stats, images, want = case
    assert (want["scores"] > 0).any(), "no slot filled: selection untested"
    inf = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    masks, scores, sal = inf.predict_batch(images)
    assert masks.shape == want["masks"].shape and masks.dtype == torch.float32
    assert scores.shape == want["scores"].shape
    assert_slots_match(scores.numpy(), masks.numpy(), want["scores"],
                       want["masks"])
    np.testing.assert_allclose(sal.numpy(), want["sal"], atol=TOL, rtol=TOL)
    full = inf.full_res_masks(masks)
    assert full.shape == want["full"].shape and full.dtype == torch.float32
    assert_slots_match(scores.numpy(), full.numpy(), want["scores"],
                       want["full"])


def test_batched_predictor_matches_jax(case):
    cfg, params, stats, images, want = case
    p = BatchedPredictor(cfg, max_wait_ms=200, device="cpu", params=params,
                         batch_stats=stats)
    try:
        out = [None] * BATCH
        threads = [threading.Thread(
            target=lambda i=i: out.__setitem__(i, p.predict(images[i],
                                                            timeout=60)))
            for i in range(BATCH)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(o is not None for o in out)
        assert_slots_match(np.stack([o.scores for o in out]),
                           np.stack([o.masks for o in out]),
                           want["scores"], want["masks"])
        full = p.inf.full_res_masks(np.stack([o.masks for o in out]))
        assert_slots_match(np.stack([o.scores for o in out]), full.numpy(),
                           want["scores"], want["full"])
        many = p.predict_many(np.concatenate([images, images[:1]]))
        assert len(many) == BATCH + 1
        np.testing.assert_allclose(many[-1].scores, want["scores"][0],
                                   atol=TOL, rtol=0)
    finally:
        p.close()


@pytest.mark.parametrize("k,dup", [(12, False), (12, True)])
def test_nms_matches_jax(k, dup):
    """mask IoU, Matrix NMS (gauss, linear) and greedy NMS on random binary
    masks, with exactly tied duplicates in the second case."""
    import jax.numpy as jnp

    from basi_tpu.ops import nms as jax_nms

    rng = np.random.RandomState(k + dup)
    masks = (rng.rand(k, 16, 16) > 0.6).astype(np.float32)
    scores = rng.rand(k).astype(np.float32)
    if dup:
        masks[3], scores[3] = masks[7], scores[7]
    tm, ts = torch.from_numpy(masks), torch.from_numpy(scores)
    jm, js = jnp.asarray(masks), jnp.asarray(scores)
    np.testing.assert_allclose(torch_nms.mask_iou_matrix(tm, tm).numpy(),
                               np.asarray(jax_nms.mask_iou_matrix(jm, jm)),
                               atol=1e-6)
    for kind in ("gauss", "linear"):
        np.testing.assert_allclose(
            torch_nms.matrix_nms(tm, ts, 2.0, kind).numpy(),
            np.asarray(jax_nms.matrix_nms(jm, js, 2.0, kind)), atol=1e-6)
    np.testing.assert_array_equal(
        torch_nms.greedy_nms(tm, ts, 0.3).numpy(),
        np.asarray(jax_nms.greedy_nms(jm, js, 0.3)))
    # leading batch dims: each image as alone
    batched = torch_nms.matrix_nms(torch.stack([tm, tm.flip(0)]),
                                   torch.stack([ts, ts.flip(0)]))
    torch.testing.assert_close(batched[1], torch_nms.matrix_nms(
        tm.flip(0), ts.flip(0)), rtol=0, atol=0)


@pytest.mark.parametrize("nms,slots", [("matrix", 4), ("matrix_linear", 20),
                                       ("greedy", 4)])
def test_select_instances_from_kernels_matches_jax(nms, slots):
    """The batched selection against the vmapped JAX selection, with tied
    kernels so top-k and slot packing must break ties by index; ``slots``
    above the 16 candidates pads with empty slots."""
    import jax
    import jax.numpy as jnp

    from basi_tpu.ops import nms as jax_nms

    rng = np.random.RandomState(5)
    feats = rng.randn(2, 8, 8, 4).astype(np.float32)
    kernels = rng.randn(2, 16, 4).astype(np.float32) * 2
    cells = rng.randn(2, 16).astype(np.float32)
    kernels[:, 9], cells[:, 9] = kernels[:, 2], cells[:, 2]
    kw = dict(num_slots=slots, score_threshold=0.05, nms=nms, pre_top_k=16)
    jm, js = jax.vmap(lambda f, k, s: jax_nms.select_instances_from_kernels(
        f, k, s, **kw))(jnp.asarray(feats), jnp.asarray(kernels),
                        jnp.asarray(cells))
    tm, ts = torch_nms.select_instances_from_kernels(
        torch.from_numpy(feats), torch.from_numpy(kernels),
        torch.from_numpy(cells), **kw)
    assert (np.asarray(js) > 0).any()
    assert tm.shape == (2, slots, 8, 8) and ts.shape == (2, slots)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)


# ---- BatchedPredictor behaviours (tests/test_serve.py) -------------------

@pytest.fixture(scope="module")
def predictor():
    p = BatchedPredictor(tiny_config(batch_size=4), max_wait_ms=20,
                         device="cpu")
    yield p
    p.close()


def _img(rng):
    return (rng.rand(64, 64, 3) * 255).astype(np.uint8)


def test_concurrent_predicts_batch_together(predictor, rng):
    calls = []
    orig = predictor.inf.predict_batch

    def counting(images):
        calls.append(len(images))
        return orig(images)

    predictor.inf.predict_batch = counting
    try:
        out = [None] * 6
        imgs = [_img(rng) for _ in range(6)]
        threads = [threading.Thread(
            target=lambda i=i: out.__setitem__(i, predictor.predict(imgs[i])))
            for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(o is not None for o in out)
        assert all(o.masks.shape == (8, 16, 16) and o.scores.shape == (8,)
                   for o in out)
        assert len(calls) < 6  # requests shared batches
    finally:
        del predictor.inf.predict_batch


@pytest.mark.parametrize("image", [np.zeros((32, 32, 3), np.uint8),
                                   np.zeros((64, 64, 3), np.float32)])
def test_bad_shape_or_dtype_raises(predictor, image):
    with pytest.raises(ValueError):
        predictor.predict(image)


def test_predict_timeout_on_full_queue(rng):
    """With the worker wedged and the queue at max_pending, predict(timeout)
    raises TimeoutError instead of blocking forever."""
    p = BatchedPredictor(tiny_config(batch_size=2), max_wait_ms=1,
                         max_pending=1, device="cpu")
    release, entered = threading.Event(), threading.Event()

    def wedged(images):
        entered.set()
        release.wait(10)
        raise RuntimeError("wedged batch fails")

    errors = []

    def call(**kw):
        try:
            p.predict(_img(rng), **kw)
        except Exception as e:  # noqa: BLE001 - recorded for the assert
            errors.append(e)

    p.inf.predict_batch = wedged
    t1 = threading.Thread(target=call)
    t2 = threading.Thread(target=call, kwargs={"timeout": 8})
    try:
        t1.start()
        assert entered.wait(10)
        t2.start()
        deadline = time.perf_counter() + 5
        while p._q.empty() and time.perf_counter() < deadline:
            time.sleep(0.01)
        with pytest.raises(TimeoutError, match="queue full"):
            p.predict(_img(rng), timeout=0.3)
    finally:
        release.set()
        t1.join(timeout=10)
        t2.join(timeout=10)
        p.close()
    assert not t1.is_alive() and not t2.is_alive()
    assert len(errors) == 2


def test_worker_death_surfaces_to_callers(rng):
    p = BatchedPredictor(tiny_config(batch_size=2), max_wait_ms=1,
                         device="cpu")
    try:
        orig_get = p._q.get

        def boom(*a, **k):
            if "timeout" in k:
                raise RuntimeError("synthetic worker crash")
            return orig_get(*a, **k)

        p._q.get = boom
        p._worker.join(timeout=5)
        assert not p._worker.is_alive()
        del p._q.get
        with pytest.raises(RuntimeError, match="worker died"):
            p.predict(_img(rng), timeout=5)
    finally:
        p.close()


class _BatchAborted(BaseException):
    """Not an ``Exception``: what ``except Exception`` lets through."""


def test_base_exception_in_a_batch_reaches_its_callers(rng):
    """A batch whose ``predict_batch`` raises a ``BaseException`` that is
    not an ``Exception`` fails each of its callers with that exception
    itself (not "worker died" from the dead-worker poll), as
    ``basi_tpu/serve.py`` does; the worker lives on and serves the next
    request."""
    p = BatchedPredictor(tiny_config(batch_size=2), max_wait_ms=200,
                         device="cpu")
    real, aborting = p.inf.predict_batch, threading.Event()
    aborting.set()

    def batch(images):
        if aborting.is_set():
            raise _BatchAborted("batch aborted")
        return real(images)

    p.inf.predict_batch = batch
    results = [None, None]

    def call(i):
        try:
            results[i] = p.predict(_img(rng), timeout=30)
        except BaseException as e:  # noqa: BLE001 - recorded for the assert
            results[i] = e

    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert all(isinstance(r, _BatchAborted) for r in results), results
        assert p._worker.is_alive()
        aborting.clear()
        pred = p.predict(_img(rng), timeout=30)
        assert pred.scores.shape == (8,) and pred.masks.shape == (8, 16, 16)
    finally:
        p.close()


def test_close_fails_waiting_callers(rng):
    """close() with a request still queued fails that caller ('predictor
    closed' or 'worker exited') instead of leaving it blocked."""
    p = BatchedPredictor(tiny_config(batch_size=2), max_wait_ms=1,
                         device="cpu")
    release, entered = threading.Event(), threading.Event()

    def slow(images):
        entered.set()
        release.wait(10)
        raise RuntimeError("batch aborted")

    p.inf.predict_batch = slow
    results = [None, None]

    def call(i):
        try:
            results[i] = p.predict(_img(rng), timeout=10)
        except Exception as e:  # noqa: BLE001 - recorded for the assert
            results[i] = e

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    threads[0].start()
    assert entered.wait(10)
    threads[1].start()  # queued, never claimed
    time.sleep(0.2)
    closer = threading.Thread(target=p.close)
    closer.start()
    time.sleep(0.2)
    release.set()
    closer.join(timeout=10)
    for t in threads:
        t.join(timeout=10)
    assert not closer.is_alive() and not any(t.is_alive() for t in threads)
    assert all(isinstance(r, Exception) for r in results), results
    assert any("closed" in str(r) or "worker exited" in str(r)
               for r in results), results


def test_predict_after_close_raises(rng):
    p = BatchedPredictor(tiny_config(batch_size=2), max_wait_ms=1,
                         device="cpu")
    p.close()
    with pytest.raises(RuntimeError, match="closed"):
        p.predict(_img(rng))


_NO_JAX = """
import sys
import numpy as np
from basi_tpu_torch.config import (Config, DataConfig, InferConfig,
                                   ModelConfig, TrainConfig)
import basi_tpu_torch
cfg = Config(
    model=ModelConfig(backbone="resnet_tiny", fpn_channels=32,
                      mask_channels=32, grid_size=8, num_slots=8,
                      image_size=64, dtype="bfloat16"),
    data=DataConfig(image_size=64, batch_size=2, synthetic_n=4,
                    max_instances=4),
    train=TrainConfig(checkpoint_dir="", ema_decay=0.9),
    infer=InferConfig(batch_size=2, dtype="float32", pre_nms_top_k=16))
inf = basi_tpu_torch.Inferencer(cfg, device="cpu")
masks, scores, _ = inf.predict_batch(np.zeros((2, 64, 64, 3), np.uint8))
full = inf.full_res_masks(masks)
assert tuple(full.shape) == (2, 8, 64, 64), full.shape
import contextlib, io
trainer = basi_tpu_torch.Trainer(cfg, device="cpu")
with contextlib.redirect_stdout(io.StringIO()):  # the [train] record
    rec = trainer.train(max_steps=1)
assert rec["step"] == 1 and np.isfinite(rec["loss"]), rec
params, stats = basi_tpu_torch.to_jax_variables(trainer.state.model)
assert "backbone" in params and "backbone" in stats
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "basi_tpu"))
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
