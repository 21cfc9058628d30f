"""Training runner, single device (port of ``basi_tpu/train/loop.py``).

``Trainer(cfg, device=...)`` builds the dataset (``data/datasets.py``,
numpy only), the model in train mode from seeded weights, the schedule, the
state and the step; ``train(max_steps=None)`` runs the epochs and logs a
``[train]`` record (step, epoch, lr, step_ms, imgs_per_s and the step's
metrics) every ``train.log_every`` steps and at the last one. After each
epoch it evaluates on the val split (``evaluate``: the EMA weights when
the state has them, with the live BatchNorm running statistics) and logs
a ``[val]`` record.

The host feed is ``data/pipeline.py``'s ``DeviceFeed`` (shuffled by
``train.seed + epoch``, masks bit-packed): a thread assembles each batch,
copies it into pinned memory and starts non-blocking copies to the device
on a side stream, a bounded queue ahead of the step; the step's stream
waits for the copy's event. Every training setting of the JAX package
runs but two, which raise ``NotImplementedError``
(``train.state.check_train_config``): ``train.steps_per_dispatch > 1`` and
multi-device training.

With ``train.checkpoint_dir`` the whole train state is saved after each
epoch's eval and every ``train.checkpoint_every_steps`` steps, never twice
at one step (``utils/checkpoint.py``), and ``train.resume`` restores it when
the Trainer is built; a restored step resumes mid-epoch, skipping the
batches already trained. While ``train()`` runs on the main thread, SIGTERM
sets a flag (``train.save_on_preemption``; anything may set ``_preempt``)
that stops the loop after the current step: the state is saved at that
step, a ``[preempt]`` record is logged and ``train()`` returns. Records go
through ``utils/logging.MetricLogger`` (console, and JSONL at
``metrics_path``).
"""

from __future__ import annotations

import signal
import threading
import time

import torch

from basi_tpu_torch.config import Config
from basi_tpu_torch.data.datasets import make_dataset
from basi_tpu_torch.data.pipeline import DeviceFeed
from basi_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from basi_tpu_torch.infer import Inferencer
from basi_tpu_torch.models.basi import cast_params, create_model
from basi_tpu_torch.train.state import (
    check_train_config,
    create_train_state,
    make_schedule,
)
from basi_tpu_torch.train.step import (
    compute_dtype,
    make_train_step,
    param_dtype,
)
from basi_tpu_torch.utils.checkpoint import CheckpointManager
from basi_tpu_torch.utils.logging import MetricLogger


class Trainer:
    def __init__(self, cfg: Config, device=DEFAULT_DEVICE):
        """Weights, batch order and augmentation draws all follow
        ``train.seed``; runs
        on the card unless ``device`` names another."""
        check_train_config(cfg)
        self.cfg = cfg
        t = cfg.train
        self.ckpt = (CheckpointManager(t.checkpoint_dir,
                                       keep=t.keep_checkpoints,
                                       async_save=t.async_checkpoint)
                     if t.checkpoint_dir else None)
        self.device = resolve_device(device)
        self.dtype = compute_dtype(cfg.model)
        self.dataset = make_dataset(cfg.data, split="train")
        self.val_dataset = make_dataset(cfg.data, split="val")
        self._inferencer: Inferencer | None = None
        self.feed = DeviceFeed(self.dataset, cfg.data.batch_size,
                               shuffle=True, seed=cfg.train.seed,
                               device=self.device,
                               pack_masks=cfg.data.pack_masks,
                               depth=cfg.data.prefetch_depth)
        self.steps_per_epoch = self.feed.steps_per_epoch()
        if self.steps_per_epoch <= 0:
            raise ValueError(
                f"dataset ({len(self.dataset)} samples) yields no full "
                f"batch of {cfg.data.batch_size}")
        self.max_steps = self.steps_per_epoch * cfg.train.epochs
        self.schedule = make_schedule(cfg.train, self.max_steps)
        model = cast_params(
            create_model(cfg.model, self.device,
                         torch.Generator().manual_seed(cfg.train.seed),
                         train=True),
            param_dtype(cfg.model))
        self.state = create_train_state(model, cfg.train)
        if self.ckpt is not None:
            self.state = self.ckpt.maybe_resume(self.state, t.resume)
        self.train_step = make_train_step(cfg.train, cfg.data, self.schedule,
                                          self.dtype)
        self.records: list[dict] = []
        self.logger = MetricLogger(cfg.metrics_path,
                                   tensorboard_dir=cfg.tensorboard_dir)
        self._preempt = threading.Event()

    def close(self) -> None:
        """Close the metrics file; ``train`` only flushes it, so a Trainer
        can train again. Idempotent."""
        self.logger.close()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, max_steps: int | None = None) -> dict:
        """Run until the configured epochs end, or ``max_steps`` steps in
        total, or a preemption stop. Returns the last ``[train]`` record;
        after a whole epoch, updated with that epoch's eval metrics; after
        a stop, with ``preempted_at_step``, ``epoch`` and
        ``checkpoint_saved``."""
        cfg = self.cfg
        stop_at = self.max_steps if max_steps is None else min(max_steps,
                                                               self.max_steps)
        last: dict = {}
        every = max(1, cfg.train.log_every)
        ckpt_every = cfg.train.checkpoint_every_steps
        last_saved = self.state.step if self.state.step else -1
        restore_handler = self._install_preempt_handler()
        try:
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
                        self.logger.log(last, prefix="[train]")
                        t0, since = time.perf_counter(), 0
                    if self.ckpt is not None and ckpt_every \
                            and step % ckpt_every == 0:
                        self.ckpt.save(self.state)
                        last_saved = step
                    if self._preempt.is_set():
                        return self._handle_preemption(epoch, last_saved, last)
                    if max_steps is not None and step >= stop_at:
                        return last
                eval_metrics = self.evaluate()  # after every epoch, as JAX's
                self.logger.log({"epoch": epoch, **eval_metrics},
                                prefix="[val]")
                if self.ckpt is not None and self.state.step != last_saved:
                    self.ckpt.save(self.state)
                    last_saved = self.state.step
                last = {**last, **eval_metrics}
            return last
        finally:
            restore_handler()
            self.logger.flush()

    def _install_preempt_handler(self):
        """A fresh stop flag, and on the main thread (the only one Python
        lets set a handler) with ``train.save_on_preemption`` a SIGTERM
        handler that sets it. Returns a function that puts the previous
        handler back."""
        self._preempt = threading.Event()
        if (not self.cfg.train.save_on_preemption
                or threading.current_thread() is not threading.main_thread()):
            return lambda: None
        prev = signal.signal(signal.SIGTERM,
                             lambda signum, frame: self._preempt.set())
        return lambda: signal.signal(signal.SIGTERM, prev)

    def _handle_preemption(self, epoch: int, last_saved: int,
                           last: dict) -> dict:
        """Save the state at its step (unless that step is saved), log the
        ``[preempt]`` record and return it over ``last``."""
        step = self.state.step
        if self.ckpt is not None and step != last_saved:
            self.ckpt.save(self.state)
        rec = {"preempted_at_step": step, "epoch": epoch,
               "checkpoint_saved": self.ckpt is not None}
        self.logger.log(rec, prefix="[preempt]")
        return {**last, **rec}

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
