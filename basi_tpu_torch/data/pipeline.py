"""Overlapped host ingest -> device batches (port of
``basi_tpu/data/pipeline.py``).

``DeviceFeed.epoch(i)`` yields the batches of one epoch on the device, in
the dataset's order (``shuffle=False``) or shuffled by ``seed + i``. A
thread assembles each host batch (``iter_epoch``), bit-packs the masks on
request, copies the arrays into pinned memory and starts non-blocking
copies to the device on a side stream, at most ``depth`` batches ahead;
the consumer's stream waits for each batch's copy event, and the batch's
memory is not reused before the consumer's work on it is done. The
``Trainer`` feeds its steps through it and ``benchmark.py`` its e2e pass.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from basi_tpu_torch.data.datasets import iter_epoch
from basi_tpu_torch.data.transforms import pack_masks_host
from basi_tpu_torch.device import DEFAULT_DEVICE, resolve_device


class DeviceFeed:
    """Background thread: host batches -> pinned memory -> non-blocking
    copies to ``device``, at most ``depth`` batches ahead."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, device=DEFAULT_DEVICE, depth: int = 2,
                 drop_last: bool = True, pack_masks: bool = False):
        """Every entry of a batch is uploaded (``num_real`` as a 0-d
        tensor)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.device = resolve_device(device)
        self.depth = max(1, depth)
        self.drop_last = drop_last
        self.pack_masks = pack_masks

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _to_device(self, hb: dict, stream) -> tuple[dict, object]:
        """(device batch, event its copies complete at, or None)."""
        if self.pack_masks and "masks" in hb:
            hb = dict(hb, masks=pack_masks_host(hb["masks"]))
        host = {k: torch.as_tensor(np.asarray(v)) for k, v in hb.items()}
        if stream is None:
            return {k: t.to(self.device) for k, t in host.items()}, None
        with torch.cuda.stream(stream):
            out = {k: t.pin_memory().to(self.device, non_blocking=True)
                   for k, t in host.items()}
            return out, stream.record_event()

    def epoch(self, epoch_idx: int, skip: int = 0) -> Iterator[dict]:
        """The device batches of one epoch (order: the dataset's, or
        shuffled by ``seed + epoch_idx``), from batch ``skip`` on."""
        host = iter_epoch(self.dataset, self.batch_size, self.shuffle,
                          seed=self.seed + epoch_idx,
                          drop_last=self.drop_last, skip=skip)
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
