"""Training runner, single device (port of ``basi_tpu/train/loop.py``).

``Trainer(cfg, device=...)`` builds the dataset (``data/datasets.py``,
numpy only), the model in train mode from seeded weights, the schedule, the
state and the step; ``train(max_steps=None)`` runs the epochs and logs a
``[train]`` record (step, epoch, lr, step_ms, imgs_per_s and the step's
metrics) every ``train.log_every`` steps and at the last one. After each
epoch it evaluates on the val split (``evaluate``: the EMA weights when
the state has them, with the live BatchNorm running statistics) and logs
a ``[val]`` record.

The host feed runs on a thread: it assembles each batch (``iter_epoch``,
shuffled by ``train.seed + epoch``), bit-packs the masks, copies the arrays
into pinned memory and starts a non-blocking copy to the device on a side
stream, a bounded queue ahead of the step; the step's stream waits for the
copy's event. Settings outside the slice raise
``NotImplementedError`` (``train.state.check_train_config``).
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Iterator

import numpy as np
import torch

from basi_tpu_torch.config import Config
from basi_tpu_torch.data.datasets import iter_epoch, make_dataset
from basi_tpu_torch.data.transforms import pack_masks_host
from basi_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from basi_tpu_torch.infer import Inferencer
from basi_tpu_torch.models.basi import create_model
from basi_tpu_torch.train.state import (
    check_train_config,
    create_train_state,
    make_schedule,
)
from basi_tpu_torch.train.step import compute_dtype, make_train_step

_KEYS = ("image", "masks", "valid")


class HostFeed:
    """Background thread: host batches -> pinned memory -> non-blocking
    copies to ``device``, at most ``depth`` batches ahead."""

    def __init__(self, dataset, batch_size: int, seed: int, device,
                 pack_masks: bool = True, depth: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.device = torch.device(device)
        self.pack_masks = pack_masks
        self.depth = max(1, depth)

    def steps_per_epoch(self) -> int:
        return len(self.dataset) // self.batch_size

    def _to_device(self, hb: dict, stream) -> tuple[dict, object]:
        """(device batch, event its copies complete at, or None)."""
        if self.pack_masks:
            hb = dict(hb, masks=pack_masks_host(hb["masks"]))
        host = {k: torch.from_numpy(np.ascontiguousarray(hb[k])) for k in _KEYS}
        if stream is None:
            return host, None
        with torch.cuda.stream(stream):
            out = {k: t.pin_memory().to(self.device, non_blocking=True)
                   for k, t in host.items()}
            return out, stream.record_event()

    def epoch(self, epoch_idx: int, skip: int = 0) -> Iterator[dict]:
        """The device batches of one epoch (order: ``seed + epoch_idx``),
        from batch ``skip`` on."""
        host = iter_epoch(self.dataset, self.batch_size, shuffle=True,
                          seed=self.seed + epoch_idx, skip=skip)
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                for hb in host:
                    if not put(self._to_device(hb, stream)):
                        return
            except BaseException as e:  # handed to the consumer, re-raised
                put(e)
                return
            put(end)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, ready = item
                if ready is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(ready)
                    for t in batch.values():  # freed memory waits for the step
                        t.record_stream(current)
                yield batch
        finally:
            stop.set()
            worker.join(timeout=30)


class Trainer:
    def __init__(self, cfg: Config, device=DEFAULT_DEVICE):
        """Weights, batch order and flips all follow ``train.seed``; runs
        on the card unless ``device`` names another."""
        check_train_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = compute_dtype(cfg.model)
        self.dataset = make_dataset(cfg.data, split="train")
        self.val_dataset = make_dataset(cfg.data, split="val")
        self._inferencer: Inferencer | None = None
        self.feed = HostFeed(self.dataset, cfg.data.batch_size,
                             cfg.train.seed, self.device,
                             pack_masks=cfg.data.pack_masks,
                             depth=cfg.data.prefetch_depth)
        self.steps_per_epoch = self.feed.steps_per_epoch()
        if self.steps_per_epoch <= 0:
            raise ValueError(
                f"dataset ({len(self.dataset)} samples) yields no full "
                f"batch of {cfg.data.batch_size}")
        self.max_steps = self.steps_per_epoch * cfg.train.epochs
        self.schedule = make_schedule(cfg.train, self.max_steps)
        model = create_model(cfg.model, self.device,
                             torch.Generator().manual_seed(cfg.train.seed),
                             train=True)
        self.state = create_train_state(model, cfg.train)
        self.train_step = make_train_step(cfg.train, cfg.data, self.schedule,
                                          self.dtype)
        self.records: list[dict] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, max_steps: int | None = None) -> dict:
        """Run until the configured epochs end, or ``max_steps`` steps in
        total. Returns the last ``[train]`` record; after a whole epoch,
        updated with that epoch's eval metrics."""
        cfg = self.cfg
        stop_at = self.max_steps if max_steps is None else min(max_steps,
                                                               self.max_steps)
        last: dict = {}
        every = max(1, cfg.train.log_every)
        while self.state.step < stop_at:
            epoch = self.state.step // self.steps_per_epoch
            skip = self.state.step - epoch * self.steps_per_epoch
            self._sync()
            t0, since = time.perf_counter(), 0
            for batch in self.feed.epoch(epoch, skip):
                metrics = self.train_step(self.state, batch)
                since += 1
                step = self.state.step
                if step % every == 0 or step == stop_at:
                    fetched = {k: float(v) for k, v in metrics.items()}
                    self._sync()
                    ms = (time.perf_counter() - t0) * 1000.0 / since
                    last = {"step": step, "epoch": epoch,
                            "lr": self.schedule(step), "step_ms": ms,
                            "imgs_per_s": cfg.data.batch_size * 1000.0 / ms,
                            **fetched}
                    self.records.append(last)
                    print("[train] " + json.dumps(last), flush=True)
                    t0, since = time.perf_counter(), 0
                if max_steps is not None and step >= stop_at:
                    return last
            eval_metrics = self.evaluate()  # after every epoch, as JAX's
            print("[val] " + json.dumps({"epoch": epoch, **eval_metrics}),
                  flush=True)
            last = {**last, **eval_metrics}
        return last

    def eval_state_dict(self, use_ema: bool | None = None) -> dict:
        """The model's state dict with the EMA in the params' places
        (``use_ema``; by default whenever the state has an EMA) and the
        live BatchNorm running statistics."""
        if use_ema is None:
            use_ema = self.state.ema is not None
        sd = {k: v.detach() for k, v in self.state.model.state_dict().items()}
        if use_ema:
            sd.update(self.state.ema)
        return sd

    def evaluate(self, max_batches: int = 0,
                 use_ema: bool | None = None) -> dict:
        """``Inferencer.evaluate`` on the val split with the weights of
        ``eval_state_dict``. One ``Inferencer`` is built on first use and
        takes the new weights on later calls."""
        sd = self.eval_state_dict(use_ema)
        if self._inferencer is None:
            self._inferencer = Inferencer(self.cfg, device=self.device,
                                          state_dict=sd)
        else:
            self._inferencer.set_weights(state_dict=sd)
        return self._inferencer.evaluate(self.val_dataset,
                                         max_batches=max_batches)
