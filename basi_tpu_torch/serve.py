"""Serving: a thread-safe request batcher (port of ``basi_tpu/serve.py``).

Requests queue on the host; one worker thread packs them into fixed-size
batches (padding the tail), runs ``Inferencer.predict_batch`` on the device
and hands each caller its slots. ``predict_many`` scores a bulk array batch
by batch.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass

import numpy as np

from basi_tpu_torch.config import Config
from basi_tpu_torch.device import DEFAULT_DEVICE
from basi_tpu_torch.infer import Inferencer, to_numpy


@dataclass
class Prediction:
    masks: np.ndarray  # (K, H/4, W/4) probabilities (bf16 widened to f32)
    scores: np.ndarray  # (K,)


class BatchedPredictor:
    """Thread-safe request batcher over an ``Inferencer``."""

    def __init__(self, cfg: Config, checkpoint: str = "",
                 max_wait_ms: float = 5.0, max_pending: int = 256,
                 aot_path: str = "", *, device=DEFAULT_DEVICE, params=None,
                 batch_stats=None, state_dict=None, seed: int = 0):
        """Weights as for ``Inferencer`` (``params``/``batch_stats``,
        ``state_dict`` or a seeded random init) on ``device``."""
        if aot_path:
            raise NotImplementedError("aot_path serving not yet ported")
        self.inf = Inferencer(cfg, device=device, params=params,
                              batch_stats=batch_stats, state_dict=state_dict,
                              checkpoint=checkpoint, seed=seed)
        self.batch = cfg.infer.batch_size
        self.size = cfg.model.image_size
        self.max_wait = max_wait_ms / 1000.0
        # Bounded queue: callers past max_pending block (backpressure). The
        # lock closes the race between predict's stop check + enqueue and
        # close's drain, so no request slips in after the drain.
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def predict(self, image_u8: np.ndarray,
                timeout: float | None = None) -> Prediction:
        """Blocking single-image API; batching happens transparently.

        ``timeout`` (seconds) bounds the whole call, enqueue backpressure
        included, and raises TimeoutError on expiry. A dead worker raises
        RuntimeError instead of hanging the caller."""
        if image_u8.shape != (self.size, self.size, 3):
            raise ValueError(f"expected ({self.size},{self.size},3) uint8")
        if image_u8.dtype != np.uint8:
            raise ValueError(f"expected uint8 pixels, got {image_u8.dtype}")
        deadline = None if timeout is None else time.perf_counter() + timeout
        done = threading.Event()
        slot: list = [None]
        item = (image_u8, slot, done)
        while True:  # enqueue with backpressure
            with self._lock:
                if self._stop.is_set():
                    raise RuntimeError("predictor is closed")
                try:
                    self._q.put_nowait(item)
                    break
                except queue.Full:
                    pass
            if not self._worker.is_alive():
                raise RuntimeError("predictor worker died")
            if deadline is not None and time.perf_counter() >= deadline:
                raise TimeoutError(
                    f"predict: request queue full ({self._q.maxsize} "
                    f"pending) for {timeout}s")
            time.sleep(0.002)
        while not done.wait(0.1):  # await the result, noticing a dead worker
            if not self._worker.is_alive() and not done.is_set():
                raise RuntimeError(
                    "predictor worker died with this request pending")
            if deadline is not None and time.perf_counter() >= deadline:
                raise TimeoutError(f"predict: no result within {timeout}s")
        if isinstance(slot[0], BaseException):
            raise slot[0]
        return slot[0]

    def predict_many(self, images_u8: np.ndarray) -> list[Prediction]:
        """Bulk scoring: (N, H, W, 3) uint8 -> N predictions, one padded
        batch at a time."""
        preds = []
        for start in range(0, len(images_u8), self.batch):
            chunk = images_u8[start:start + self.batch]
            buf = np.zeros((self.batch, self.size, self.size, 3), np.uint8)
            buf[:len(chunk)] = chunk
            masks, scores, _ = self.inf.predict_batch(buf)
            masks, scores = to_numpy(masks), to_numpy(scores)
            preds.extend(Prediction(masks[i], scores[i])
                         for i in range(len(chunk)))
        return preds

    def _loop(self):
        try:
            self._loop_inner()
        finally:
            # The worker is exiting, orderly or by a bug escaping
            # _loop_inner: nothing will serve the queue again, so fail the
            # stragglers instead of hanging their callers.
            self._drain_fail("predictor worker exited")

    def _loop_inner(self):
        while not self._stop.is_set():
            items = []
            try:
                items.append(self._q.get(timeout=0.1))
            except queue.Empty:
                continue
            deadline = time.perf_counter() + self.max_wait
            while len(items) < self.batch:  # fill within the latency budget
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    items.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                # Packing inside the try too: a packing error fails these
                # requests instead of killing the worker.
                buf = np.zeros((self.batch, self.size, self.size, 3), np.uint8)
                for i, (img, _, _) in enumerate(items):
                    buf[i] = img
                masks, scores, _ = self.inf.predict_batch(buf)
                masks, scores = to_numpy(masks), to_numpy(scores)
                for i, (_, slot, done) in enumerate(items):
                    slot[0] = Prediction(masks[i], scores[i])
                    done.set()
            except BaseException as e:  # propagate to the callers
                for _, slot, done in items:
                    slot[0] = e
                    done.set()

    def close(self):
        with self._lock:
            # Under predict's lock: once set, no request enters the queue
            # behind the drain.
            self._stop.set()
        self._worker.join(timeout=2)
        self._drain_fail("predictor closed")

    def _drain_fail(self, reason: str):
        """Fail every queued request; idempotent (the worker's exit and
        close may both drain)."""
        while True:
            try:
                _, slot, done = self._q.get_nowait()
            except queue.Empty:
                break
            slot[0] = RuntimeError(reason)
            done.set()
