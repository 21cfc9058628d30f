"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` for Hopper (``sm_90a``), all
started together, and the objects link into one shared library with a plain
C interface, ``build/kernels/<hash>/libbasi_kernels.so`` under the checkout,
loaded with ``ctypes``. The directory name is a hash of
the sources and flags, so an edit rebuilds and an unchanged tree reuses the
library. Nothing here runs at import time: the first kernel launch builds.
A failed build raises; it never returns ``None``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_F3 = ctypes.POINTER(ctypes.c_float)  # 3 host floats
# C entry point -> argtypes; every entry point returns cudaGetLastError().
SIGNATURES = {
    # x, y, n, h, w, c, f, stream
    "basi_upsample_int_bf16": (_P, _P, _I, _I, _I, _I, _I, _P),
    # g, gx, n, h, w, c, f, stream (h, w: the input's, gx's)
    "basi_upsample_int_bwd_bf16": (_P, _P, _I, _I, _I, _I, _I, _P),
    # x, flip, y, n, h, w, inv_std, neg_mean, stream
    "basi_normalize_flip_bf16": (_P, _P, _P, _I, _I, _I, _F3, _F3, _P),
    "basi_normalize_flip_f32": (_P, _P, _P, _I, _I, _I, _F3, _F3, _P),
    # x, y, b, h, w, oh, ow, stream
    "basi_upsample_sigmoid_f32": (_P, _P, _I, _I, _I, _I, _I, _P),
    "basi_upsample_sigmoid_bf16": (_P, _P, _I, _I, _I, _I, _I, _P),
    # x (or g, x), ws, counters, out, scale, bias, mean, inv, rows (= M), c,
    # groups per block, slabs, rows per slab, epilogue, eps, stream
    **{name: (_P,) * 9 + (_I,) * 6 + (ctypes.c_float, _P) for name in (
        "basi_channel_moments_bf16", "basi_channel_moments_f32",
        "basi_channel_dual_sums_bf16", "basi_channel_dual_sums_f32")},
    # dual, f32, blocks (out)
    "basi_bn_stats_blocks_per_sm": (_I, _I, ctypes.POINTER(ctypes.c_int)),
    # x, a, b, y, rows, c, threads along C, row lanes, blocks, vec, stream
    **{name: (_P,) * 4 + (ctypes.c_longlong,) + (_I,) * 5 + (_P,)
       for name in ("basi_bn_apply_bf16", "basi_bn_apply_f32")},
    # g, x, mean, a, a_mg, a_inv_mgxn, dx, then as the apply
    **{name: (_P,) * 7 + (ctypes.c_longlong,) + (_I,) * 5 + (_P,)
       for name in ("basi_bn_input_grad_bf16", "basi_bn_input_grad_f32")},
    # grad, f32, vec, threads, blocks (out)
    "basi_bn_apply_blocks_per_sm": (_I, _I, _I, _I,
                                    ctypes.POINTER(ctypes.c_int)),
    # x (or g), w, b, y (or dx), n, h, w, c, channels a block, blocks,
    # flip, stream
    **{name: (_P,) * 4 + (_I,) * 7 + (_P,)
       for name in ("basi_dwconv7x7_bf16", "basi_dwconv7x7_f32")},
    # g, x, partials, dw, db, n, h, w, c, channels a block, blocks, stream
    **{name: (_P,) * 5 + (_I,) * 6 + (_P,)
       for name in ("basi_dwconv7x7_wgrad_bf16", "basi_dwconv7x7_wgrad_f32")},
    # weight gradient, f32, channels a block, blocks (out)
    "basi_dwconv7x7_blocks_per_sm": (_I, _I, _I,
                                     ctypes.POINTER(ctypes.c_int)),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Filled by the first load: library path, whether it was compiled in this
# process, compile seconds and nvcc's output (registers/spills per kernel).
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load()
        return _lib


def _load() -> ctypes.CDLL:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / "libbasi_kernels.so"
    info = {"path": str(lib_path), "compiled": False, "seconds": 0.0,
            "log": ""}
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = os.getpid()
        t0 = time.perf_counter()
        # One nvcc per source, all running at once; then one link.
        jobs = []
        for src in sources:
            obj = out_dir / f"{src.stem}.{tag}.o"
            cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{out}")
        tmp = out_dir / f"libbasi_kernels.{tag}.tmp.so"
        if not failed:
            cmd = [_nvcc(), "-shared", "-o", str(tmp),
                   *(str(obj) for _, obj, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{logs[-1]}")
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        info.update(compiled=True, seconds=time.perf_counter() - t0,
                    log="".join(logs))
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("\n".join(failed))
        os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or none
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.basi_error_string.argtypes = [ctypes.c_int]
    lib.basi_error_string.restype = ctypes.c_char_p
    build_info.update(info)
    return lib


def stream(device) -> int:
    """The raw handle of the current stream of CUDA ``device``, on which a
    wrapper launches its kernel. ``torch.cuda.current_stream``'s Stream
    object and a ``torch.cuda.device`` context cost microseconds a call;
    this reads the handle only. The kernels launch on the thread's current
    device, so a tensor on another device raises."""
    import torch

    if device.index != torch._C._cuda_getDevice():
        raise ValueError(f"tensor on {device} but the current device is "
                         f"cuda:{torch._C._cuda_getDevice()}: launch under "
                         "torch.cuda.device")
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = library().basi_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
