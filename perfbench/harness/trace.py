"""Reading a ``torch.profiler`` trace of a steady sub-window: device time
by kernel class, launches, the busy share, and the idle gaps named by what
the host was doing when each began."""

from __future__ import annotations

import heapq
import re

# Device kernels by class: the first class one of whose fragments the
# kernel's name holds (lower case). Memory copies and sets come from the
# trace's own names.
KERNEL_CLASSES = [
    ("bn_stats", ("bn_stats",)),
    ("upsample_int_bwd", ("upsample_int_bwd",)),
    ("upsample_int", ("upsample_int",)),
    ("upsample_sigmoid", ("upsample_sigmoid",)),
    ("normalize_flip", ("normalize_flip",)),
    ("batch_norm", ("batch_norm", "bn_fw", "bn_bw")),
    ("conv_gemm", ("conv", "cudnn", "xmma", "gemm", "cutlass", "wgrad",
                   "dgrad", "fprop", "nvjet", "gemv", "nchwtonhwc",
                   "nhwctonchw")),
    ("group_norm", ("group_norm", "groupnorm")),
    ("grid_sample", ("grid_sampler",)),
    ("optimizer", ("foreach", "multi_tensor")),
    ("max_pool", ("max_pool", "maxpool")),
    ("reduce_sort_gather", ("reduce", "sort", "scan", "topk", "gather",
                            "index", "radix")),
    ("copy_cast", ("copy", "cat", "fill")),
    ("elementwise", ("elementwise",)),
]
NO_HOST_OP = "_no_host_operation_"


def kernel_class(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    for cls, frags in KERNEL_CLASSES:
        if any(f in low for f in frags):
            return cls
    return "other"


def clean(name: str) -> str:
    """A name as the result line carries it: letters, digits, ``_``,
    ``.`` and ``-``, at most 64 characters."""
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)[:64]


def _is_device(evt) -> bool:
    from torch.autograd import DeviceType

    if evt.device_type != DeviceType.CUDA:
        return False
    # annotations (record_function ranges, Optimizer.step#...) mirrored on
    # the device's timeline are not device work
    return not (getattr(evt, "is_user_annotation", False) or "#" in evt.name
                or evt.name.startswith("perfbench."))


def summarize(events, window_s: float) -> dict:
    """Summary of the profiler's ``events()`` over a window of ``window_s``
    seconds: ``busy_s`` (the union of device intervals), ``kernels`` (device
    kernel launches, copies and sets left out), ``by_class`` {class:
    [seconds, launches]}, ``idle_gaps`` [[host op, seconds]] (the ten largest sums of idle device
    time by the innermost host operation open when the gap began)."""
    dev, cpu = [], []
    for e in events:
        t0, t1 = float(e.time_range.start), float(e.time_range.end)
        if _is_device(e):
            dev.append((t0, t1, e.name))
        elif e.device_type.name == "CPU" and t1 > t0:
            cpu.append((t0, t1, e.name))
    by_class: dict = {}
    kernels = 0
    for t0, t1, name in dev:
        cls = kernel_class(name)
        s = (t1 - t0) * 1e-6
        c = by_class.setdefault(cls, [0.0, 0])
        c[0] += s
        c[1] += 1
        if cls not in ("memcpy", "memset"):
            kernels += 1
    merged = []
    for t0, t1, _ in sorted(dev):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    busy = sum(t1 - t0 for t0, t1 in merged) * 1e-6
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    return {"busy_s": busy, "window_s": window_s, "kernels": kernels,
            "by_class": by_class, "idle_gaps": _name_gaps(gaps, cpu)}


def _name_gaps(gaps, cpu) -> list:
    """[[host op, seconds]] of the gaps, summed by the innermost CPU
    operation (the latest-started one still open) at each gap's start."""
    cpu.sort()
    sums: dict = {}
    open_ops: list = []  # heap of (end, start, name)
    i = 0
    for g0, g1 in gaps:
        while i < len(cpu) and cpu[i][0] <= g0:
            heapq.heappush(open_ops, (cpu[i][1], cpu[i][0], cpu[i][2]))
            i += 1
        while open_ops and open_ops[0][0] <= g0:
            heapq.heappop(open_ops)
        name = max(open_ops, key=lambda o: o[1])[2] if open_ops else NO_HOST_OP
        name = clean(name)
        sums[name] = sums.get(name, 0.0) + (g1 - g0) * 1e-6
    return sorted(([k, v] for k, v in sums.items()), key=lambda kv: -kv[1])[:10]


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the ten device classes that took
    most time and the ten longest idle-gap sums."""
    ops = sorted(([clean(k), v[0]] for k, v in summary["by_class"].items()),
                 key=lambda kv: -kv[1])[:10]
    return {"device_ops": ops, "idle_gaps": summary["idle_gaps"]}


def class_seconds(summary: dict, cls: str) -> float:
    return summary["by_class"].get(cls, [0.0, 0])[0]

