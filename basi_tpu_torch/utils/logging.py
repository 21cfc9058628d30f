"""Metric records of training (port of ``basi_tpu/utils/logging.py``).

``MetricLogger.log(record, prefix)`` prints ``prefix {json}`` to the
console (the port's form of the ``[train]``, ``[val]`` and ``[preempt]``
lines, which its tools parse) and, with ``metrics_path``, appends the
record with its time since the logger started (``t``) as one JSON line,
flushed per record. Floats are rounded to 6 places and numpy or torch
scalars become Python numbers, as in the JAX package. TensorBoard event
files are not ported: the card's machine has no ``tensorboard``.

``save_mask_pngs`` writes one image's predicted instances as one labeled
8-bit PNG (``data/png.py``), the JAX package's debug dump.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Any

import numpy as np

from basi_tpu_torch.data.png import write_png


class MetricLogger:
    def __init__(self, path: str = "", console: bool = True,
                 tensorboard_dir: str = ""):
        if tensorboard_dir:
            raise NotImplementedError("tensorboard_dir not yet ported")
        self.console = console
        self._fh: IO | None = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, record: dict[str, Any], prefix: str = "") -> None:
        rec = {}
        for k, v in record.items():
            if hasattr(v, "item"):
                v = v.item()
            if isinstance(v, float):
                v = round(v, 6)
            rec[k] = v
        if self._fh:
            line = {"t": round(time.time() - self._t0, 3), **rec}
            self._fh.write(json.dumps(line) + "\n")
            self._fh.flush()
        if self.console:
            print((prefix + " " if prefix else "") + json.dumps(rec),
                  flush=True)

    def flush(self) -> None:
        if self._fh:
            self._fh.flush()

    def close(self) -> None:
        """Idempotent; a ``log`` after it prints to the console only."""
        if self._fh:
            self._fh.close()
            self._fh = None


def save_mask_pngs(out_dir: str, name: str, masks, scores,
                   score_threshold: float = 0.1) -> None:
    """``<out_dir>/<name>.png``: slot i's mask (> 0.5) painted with
    ``(i + 1) * max(1, 255 // K)`` where its score reaches
    ``score_threshold``, later slots over earlier ones, 0 elsewhere."""
    os.makedirs(out_dir, exist_ok=True)
    masks = np.asarray(masks)
    scores = np.asarray(scores)
    combined = np.zeros(masks.shape[-2:], np.uint8)
    step = max(1, 255 // max(1, len(masks)))
    for i, (m, s) in enumerate(zip(masks, scores)):
        if s < score_threshold:
            continue
        combined[m > 0.5] = (i + 1) * step
    write_png(os.path.join(out_dir, f"{name}.png"), combined)
