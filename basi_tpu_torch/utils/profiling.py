"""Tracing (port of ``basi_tpu/utils/profiling.py``).

``maybe_trace(enabled, out_dir)`` wraps a block in a ``torch.profiler``
trace of the host and, where there is one, the CUDA device, and writes it
as a Chrome trace (``chrome://tracing``, Perfetto) to
``<out_dir>/trace_<pid>_<n>.json``, the path it yields, and beside it the
block's ``report()`` as ``spans_<pid>_<n>.json`` (disabled, or inside
another profiler session, it yields None and costs nothing).
``Trainer.train`` and ``Inferencer.evaluate`` run under it with
``profile=true`` (``--profile``).

``span(name)`` (the reference's ``annotate``) marks a stage of the
program. Off, when no ``torch.profiler`` session is active, it checks one
flag and does nothing else. On, under any session (``maybe_trace``, or a
benchmark's profiled window), it opens a ``record_function`` range of that
name, so the stage sits in the trace on the clock of the device activity,
and records into an in-memory table, per name: calls, host seconds, and
device seconds, from a timing CUDA event recorded on the current stream at
entry to one at exit (the stage's stretch of the device's timeline, idle
time inside it included; resolved only when the table is read). Spans
nest. The table holds the latest traced stretch only: recording that
resumes after a span has seen the profiler off starts a fresh table, as
does ``maybe_trace``.

The sync counter: while spans record on a CUDA device, the first
outermost span to open (in any thread) puts torch's sync debug mode on
(``torch.cuda.set_sync_debug_mode("warn")``) and the last to close puts the
previous mode back, so code outside the program's spans is never flagged.
Each synchronization the mode flags (a blocking copy, ``.item()``, a stream
or device synchronize) is counted, not printed: against the innermost span
open in its thread, and against its site, the innermost frame of
``basi_tpu_torch`` on the stack as ``file:line`` (else the innermost frame
outside torch). Autograd replays the warnings of its backward threads on
the thread that called ``backward()``, so the backward's syncs land on
``train.backward``. The mode does not see a non-blocking copy from
pageable host memory; a thread with no span open (the feed's) is not
counted.

``report()`` -> ``{"spans": {name: {"calls", "host_s", "device_s"}},
"syncs": {"count", "by_span": {name: n}, "by_site": {site: {name: n}}}}``
(``device_s`` None where the span recorded no CUDA events); it
synchronizes once to resolve the events. ``reset()`` empties the table.

The spans, by the stage each covers:

- ``train.ingest``: ``train/step.py``'s augmentation draws
  (``draw_augment``) and ``prepare_batch`` (mask unpacking,
  ``normalize_and_flip``, colour and scale jitter, instance statistics,
  the masks at /4), then clearing the params' ``.grad``;
- ``train.targets``: ``assign_targets_roi`` (the roi mechanism);
- ``train.forward``: the train-mode model call;
- ``train.loss``: ``basi_roi_loss`` or ``basi_loss``;
- ``train.backward``: ``loss.backward()``, and under ``train.grad_accum``
  the gradients' accumulation and the metrics' mean;
- ``train.update``: the clip, the learning rate, the optimizer step and
  the EMA;
- ``roi.align``: each ``ops/roi.py::roi_align`` call, nested in a stage
  (the ROI mask head's crops in the forward, the target crops in the
  loss);
- the eval program's (``Inferencer._eval_batch``, ``_orig_eval``):
  ``eval.forward``, ``eval.selection``, ``eval.upsample_sigmoid``,
  ``eval.iou``, ``eval.paste``, ``eval.sod`` and, inside the weighted
  F-measure, ``eval.edt``.

The six ``train.*`` stages tile a step: every operation it queues lies in
exactly one of them.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
import warnings

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

SYNC_MESSAGE = "called a synchronizing CUDA operation"
_THIS = os.path.abspath(__file__)
_PACKAGE = os.path.dirname(os.path.dirname(_THIS))
_ROOT = os.path.dirname(_PACKAGE)
_SKIP = (os.path.dirname(os.path.abspath(torch.__file__)) + os.sep,
         os.path.abspath(warnings.__file__), _THIS)

_count = itertools.count()
_lock = threading.RLock()  # the table, and the spans open across threads
_spans: dict = {}  # name -> [calls, host seconds, [(start, end) events]]
_syncs: dict = {}  # (span, site) -> count
_local = threading.local()  # .names: the thread's open spans, innermost last
_outermost = 0  # the threads' outermost spans open now
_hook = None  # the _SyncHook they share
_stale = False  # a span saw the profiler off since the table last recorded
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking the stage ``name`` (module doc)."""
    global _stale
    if not _autograd_profiler._is_profiler_enabled:
        _stale = True
        return _OFF
    return _Span(name)


def _open_names() -> list:
    names = getattr(_local, "names", None)
    if names is None:
        names = _local.names = []
    return names


class _Span:
    __slots__ = ("name", "range", "start", "t0")

    def __init__(self, name: str):
        self.name = name

    # The events are recorded first on entry and last on exit, so that
    # the span's own work lies inside its stretch of the device's timeline
    # and consecutive stages leave next to no time between them.
    def __enter__(self):
        global _outermost, _hook, _stale
        self.start = None
        if torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        names = _open_names()
        if not names:
            with _lock:
                if not _outermost:
                    if _stale:
                        reset()
                        _stale = False
                    _hook = _SyncHook()
                _outermost += 1
        names.append(self.name)
        self.range = record_function(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _outermost, _hook
        host = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        names = _local.names
        names.pop()
        with _lock:
            if not names:
                _outermost -= 1
                if not _outermost:
                    _hook.close()
                    _hook = None
            entry = _spans.setdefault(self.name, [0, 0.0, []])
            entry[0] += 1
            entry[1] += host
            if self.start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                entry[2].append((self.start, end))
        return False


class _SyncHook:
    """Held while any span records: the warnings hook that counts the
    sync debug mode's notices, and the mode itself on a CUDA device."""

    def __init__(self):
        self.warnings = warnings.catch_warnings()
        self.warnings.__enter__()
        self.forward = warnings.showwarning
        warnings.filterwarnings("always", message=".*" + SYNC_MESSAGE)
        warnings.showwarning = self.show
        self.mode = None
        if torch.cuda.is_initialized():
            self.mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")

    def show(self, message, category, filename, lineno, file=None,
             line=None):
        if SYNC_MESSAGE not in str(message):
            self.forward(message, category, filename, lineno, file, line)
            return
        names = getattr(_local, "names", None)
        if names:  # a thread with no span open (the feed's) is not counted
            key = (names[-1], _site(sys._getframe(1)))
            with _lock:
                _syncs[key] = _syncs.get(key, 0) + 1

    def close(self):
        if self.mode is not None:
            torch.cuda.set_sync_debug_mode(self.mode)
        self.warnings.__exit__(None, None, None)


def _site(frame) -> str:
    """``file:line`` of the innermost frame of the port (``basi_tpu_torch``
    less this module), else of the innermost frame outside torch, the
    ``warnings`` module and this one; paths relative to the repo."""
    found = None
    while frame is not None:
        path = frame.f_code.co_filename
        if not path.startswith(_SKIP):
            if path.startswith(_PACKAGE + os.sep):
                found = (path, frame.f_lineno)
                break
            found = found or (path, frame.f_lineno)
        frame = frame.f_back
    if found is None:
        return "?"
    path, line = found
    if path.startswith(_ROOT + os.sep):
        path = os.path.relpath(path, _ROOT)
    return f"{path}:{line}"


def report() -> dict:
    """The table (module doc); synchronizes once to resolve the events."""
    with _lock:
        table = {k: (v[0], v[1], list(v[2])) for k, v in _spans.items()}
        syncs = dict(_syncs)
    if any(events for _, _, events in table.values()):
        torch.cuda.synchronize()
    spans = {}
    for name, (calls, host, events) in table.items():
        device = (sum(a.elapsed_time(b) for a, b in events) * 1e-3
                  if events else None)
        spans[name] = {"calls": calls, "host_s": host, "device_s": device}
    by_span: dict = {}
    by_site: dict = {}
    for (name, site), n in syncs.items():
        by_span[name] = by_span.get(name, 0) + n
        by_site.setdefault(site, {})[name] = n
    return {"spans": spans,
            "syncs": {"count": sum(syncs.values()), "by_span": by_span,
                      "by_site": by_site}}


def reset() -> None:
    """Empty the table."""
    with _lock:
        _spans.clear()
        _syncs.clear()


@contextlib.contextmanager
def maybe_trace(enabled: bool, out_dir: str):
    # inside another session (``Trainer.train``'s around its evals) the
    # outer trace holds the block: torch.profiler sessions do not nest
    if not enabled or _autograd_profiler._is_profiler_enabled:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    stem = f"{os.getpid()}_{next(_count)}.json"
    path = os.path.join(out_dir, "trace_" + stem)
    reset()
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    with open(os.path.join(out_dir, "spans_" + stem), "w") as f:
        json.dump(report(), f, indent=1, sort_keys=True)
