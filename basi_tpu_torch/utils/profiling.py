"""Tracing (port of ``basi_tpu/utils/profiling.py``).

``maybe_trace(enabled, out_dir)`` wraps a block in a ``torch.profiler``
trace of the host and, where there is one, the CUDA device, and writes it
as a Chrome trace (``chrome://tracing``, Perfetto) to
``<out_dir>/trace_<pid>_<n>.json``, the path it yields (disabled, it
yields None and costs nothing). The
``record_function`` ranges of the eval program (``eval.forward``,
``eval.selection``, ``eval.upsample_sigmoid``, ``eval.iou``,
``eval.paste``, ``eval.sod``, ``eval.edt``) appear in it by name.
"""

from __future__ import annotations

import contextlib
import itertools
import os

import torch
from torch.profiler import ProfilerActivity, profile

_count = itertools.count()


@contextlib.contextmanager
def maybe_trace(enabled: bool, out_dir: str):
    if not enabled:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_{os.getpid()}_{next(_count)}.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
