"""The port's image decoder: JPEG and PNG files to letterboxed uint8 RGB.

The counterpart of the JAX package's ``NativeDecoder``
(``basi_tpu/data/native.py``, ``basi_tpu/data/_native/decode.cc``), which
decodes with libjpeg and libpng and letterboxes with a 16.16 fixed-point
bilinear (or centre-convention nearest) resize into a top-left zero-padded
square. Here:

* PNG goes through ``data/png.py`` (numpy, ``zlib`` and a small C++
  unfilter) with libpng's transforms;
* JPEG goes through libjpeg where its headers exist (``csrc/
  jpeg_libjpeg.cc``: decode.cc's own libjpeg calls, so the same pixels),
  else through the CUDA toolkit's nvJPEG (``csrc/jpeg_nvjpeg.cc``): nvJPEG
  decodes the components and runs the IDCT on the card, and
  ``planes_to_rgb`` then does libjpeg's chroma upsampling and YCbCr -> RGB
  in numpy, so only the IDCT's rounding differs from libjpeg. nvJPEG runs
  on a CUDA stream of the decoding thread's own, so decodes never wait for
  the model's work. Each route is a small C library built with ``g++`` on
  first use (``data/clib.py``); a failed build raises with the compiler's
  output;
* the letterbox is ``letterbox_rgb``, a numpy copy of decode.cc's, equal
  to it byte for byte.

``route()`` names the JPEG route of this machine; ``build_info`` holds the
library's route, path and build time once it is loaded. Files other than
JPEG and PNG raise ``IOError``, as decode.cc refuses them (``.bmp``
included, which the folder dataset lists). There is no PIL anywhere and
no fallback from one route to another: ``get_decoder("pil")`` raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import struct
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from basi_tpu_torch.data import clib, png

ONE = 1 << 16  # the letterbox's 16.16 fixed point

_lock = threading.Lock()
_route: str | None = None
_lib: ctypes.CDLL | None = None
_pool: ThreadPoolExecutor | None = None
_local = threading.local()  # each decode thread's CUDA stream
# Filled when the JPEG library is loaded: route, path, whether it was
# compiled in this process, and the compile seconds.
build_info: dict = {}


def _cuda_home() -> Path:
    if os.environ.get("CUDA_HOME"):
        return Path(os.environ["CUDA_HOME"])
    nvcc = shutil.which("nvcc")
    if nvcc:
        return Path(os.path.realpath(nvcc)).parent.parent
    return Path("/usr/local/cuda")


def _has_header(name: str, *flags: str) -> bool:
    """Whether the C++ compiler finds ``<name>``."""
    if shutil.which("g++") is None:
        return False
    proc = subprocess.run(["g++", *flags, "-E", "-x", "c++", "-"],
                          input=f"#include <{name}>\n", capture_output=True,
                          text=True)
    return proc.returncode == 0


def route() -> str:
    """The JPEG route of this machine: ``libjpeg`` where the compiler finds
    ``jpeglib.h``, else ``nvjpeg`` where the CUDA toolkit has ``nvjpeg.h``;
    raises when it has neither."""
    global _route
    with _lock:
        if _route is None:
            cuda_inc = _cuda_home() / "include"
            if _has_header("jpeglib.h"):
                _route = "libjpeg"
            elif (cuda_inc / "nvjpeg.h").is_file() and _has_header(
                    "nvjpeg.h", f"-I{cuda_inc}"):
                _route = "nvjpeg"
            else:
                raise RuntimeError(
                    "no JPEG decoder on this machine: the port decodes JPEG "
                    "with libjpeg (jpeglib.h) or with the CUDA toolkit's "
                    "nvJPEG (nvjpeg.h), and neither header was found")
        return _route


def library() -> ctypes.CDLL:
    """The loaded JPEG library of this machine's route, built on first
    use (``data/clib.py``); raises with the compiler's output when the
    build fails."""
    global _lib
    which = route()
    with _lock:
        if _lib is not None:
            return _lib
        before, after = (), ("-ljpeg",)
        if which == "nvjpeg":
            cuda = _cuda_home()
            before = (f"-I{cuda / 'include'}",)
            after = (f"-L{cuda / 'lib64'}", f"-Wl,-rpath,{cuda / 'lib64'}",
                     "-lnvjpeg")
        lib, info = clib.load(f"basi_{which}", clib.CSRC / f"jpeg_{which}.cc",
                              before, after)
        _bind(lib, which)
        build_info.update(info, route=which)
        _lib = lib
        return lib


def _bind(lib: ctypes.CDLL, which: str) -> None:
    p, i, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    ip = ctypes.POINTER(ctypes.c_int)
    if which == "libjpeg":
        lib.basi_libjpeg_dims.argtypes = [ctypes.c_char_p, size, ip, ip]
        lib.basi_libjpeg_decode.argtypes = [ctypes.c_char_p, size, p, i, i]
        lib.basi_libjpeg_planes.argtypes = [ctypes.c_char_p, size, p, size,
                                            ip, ip]
        fns = (lib.basi_libjpeg_dims, lib.basi_libjpeg_decode,
               lib.basi_libjpeg_planes)
    else:
        lib.basi_nvjpeg_dims.argtypes = [ctypes.c_char_p, size, ip, ip]
        lib.basi_nvjpeg_decode.argtypes = [ctypes.c_char_p, size, p, i, ip,
                                           p]
        fns = (lib.basi_nvjpeg_dims, lib.basi_nvjpeg_decode)
    for fn in fns:
        fn.restype = ctypes.c_int


def _upsample(plane: np.ndarray, hf: int, vf: int) -> np.ndarray:
    """libjpeg's chroma upsampling of one plane by (hf, vf): the "fancy"
    triangle filters (jdsample.c) for 2x1, 1x2 and 2x2 of planes wider
    than 2, edges repeated; plain repetition otherwise."""
    p = plane.astype(np.int32)
    fancy_h = hf == 2 and p.shape[1] > 2
    if vf == 2 and (hf == 1 or fancy_h):
        above = np.concatenate([p[:1], p[:-1]])
        below = np.concatenate([p[1:], p[-1:]])
        rows = [3 * p + above, 3 * p + below]  # output rows 2r, 2r + 1
        if hf == 1:
            out = [(rows[0] + 1) >> 2, (rows[1] + 2) >> 2]
        else:
            out = []
            for cs in rows:
                left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
                right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
                out.append(np.stack([(3 * cs + left + 8) >> 4,
                                     (3 * cs + right + 7) >> 4], axis=2)
                           .reshape(cs.shape[0], -1))
        return np.stack(out, axis=1).reshape(-1, out[0].shape[1])
    if vf == 1 and fancy_h:
        left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
        right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
        return np.stack([(3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2],
                        axis=2).reshape(p.shape[0], -1)
    return np.repeat(np.repeat(p, vf, axis=0), hf, axis=1)


# libjpeg's YCbCr -> RGB tables (jdcolor.c): 16-bit fixed point
_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (91881 * _X + (1 << 15)) >> 16
_CB_B = (116130 * _X + (1 << 15)) >> 16
_CR_G = -46802 * _X
_CB_G = -22554 * _X + (1 << 15)


def planes_to_rgb(planes: list[np.ndarray], hf: int, vf: int) -> np.ndarray:
    """Decoded JPEG components (Y, or Y Cb Cr at their sampled sizes, uint8;
    the chroma upsampled by ``hf`` x ``vf``) -> (H, W, 3) uint8 RGB as
    libjpeg makes it with its default settings: fancy upsampling, then its
    integer YCbCr -> RGB, clamped."""
    y = planes[0]
    if len(planes) == 1:
        return np.repeat(y[..., None], 3, axis=2)
    if len(planes) != 3 or hf < 1 or vf < 1:
        raise IOError(f"a JPEG of {len(planes)} components, chroma "
                      f"sampling {hf}x{vf}")
    h, w = y.shape
    cb, cr = [_upsample(c, hf, vf)[:h, :w] for c in planes[1:]]
    yy = y.astype(np.int64)
    rgb = np.stack([yy + _CR_R[cr], yy + ((_CB_G[cb] + _CR_G[cr]) >> 16),
                    yy + _CB_B[cb]], axis=2)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _split(buf: np.ndarray, comps: int, dims) -> list[np.ndarray]:
    planes, at = [], 0
    for c in range(comps):
        h, w = dims[2 * c], dims[2 * c + 1]
        planes.append(buf[at:at + h * w].reshape(h, w))
        at += h * w
    return planes


def jpeg_planes(data: bytes) -> tuple[list[np.ndarray], int, int]:
    """libjpeg's decoded components of a JPEG, before upsampling and
    colour conversion, and the chroma's upsampling factors (the libjpeg
    route only: what the nvjpeg route gets from nvJPEG)."""
    lib = library()
    if build_info["route"] != "libjpeg":
        raise RuntimeError("jpeg_planes reads through libjpeg")
    h, w = jpeg_size(data)
    comps, dims = ctypes.c_int(0), (ctypes.c_int * 8)()
    buf = np.empty(h * w * 3 + 64, np.uint8)
    if lib.basi_libjpeg_planes(data, len(data), buf.ctypes.data, buf.size,
                               ctypes.byref(comps), dims) != 0:
        raise IOError("libjpeg failed to decode the JPEG")
    planes = [p.copy() for p in _split(buf, comps.value, list(dims))]
    return planes, dims[6], dims[7]


def _nvjpeg_header(lib: ctypes.CDLL, data: bytes):
    """(components, (h, w) of each and the chroma factors, as a ctypes
    array of 8) of a JPEG, read by nvJPEG."""
    comps, dims = ctypes.c_int(0), (ctypes.c_int * 8)()
    rc = lib.basi_nvjpeg_dims(data, len(data), ctypes.byref(comps), dims)
    if rc != 0 or comps.value not in (1, 3):
        raise IOError(f"JPEG header unreadable or unsupported (nvJPEG "
                      f"status {rc}, {comps.value} components)")
    return comps.value, dims


def jpeg_size(data: bytes) -> tuple[int, int]:
    """(H, W) of a JPEG from its header."""
    lib = library()
    if build_info["route"] == "nvjpeg":
        _, dims = _nvjpeg_header(lib, data)
        return dims[0], dims[1]
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.basi_libjpeg_dims(data, len(data), ctypes.byref(h),
                               ctypes.byref(w))
    if rc != 0 or h.value <= 0 or w.value <= 0:
        raise IOError("JPEG header unreadable (libjpeg)")
    return h.value, w.value


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, on this machine's route."""
    lib = library()
    if build_info["route"] == "libjpeg":
        h, w = jpeg_size(data)
        out = np.empty((h, w, 3), np.uint8)
        if lib.basi_libjpeg_decode(data, len(data), out.ctypes.data, h,
                                   w) != 0:
            raise IOError("libjpeg failed to decode the JPEG")
        return out
    import torch

    if not torch.cuda.is_available():
        raise IOError("the nvjpeg route decodes on a CUDA device; none is "
                      "available")
    comps, dims = _nvjpeg_header(lib, data)
    n = sum(dims[2 * c] * dims[2 * c + 1] for c in range(comps))
    stream = _decode_stream()
    with torch.cuda.stream(stream):
        buf = torch.empty(n, dtype=torch.uint8, device="cuda")
        rc = lib.basi_nvjpeg_decode(data, len(data), buf.data_ptr(), comps,
                                    dims, stream.cuda_stream)
        if rc != 0:
            raise IOError(f"nvjpegDecode failed (status {rc})")
        host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        host.copy_(buf, non_blocking=True)
    stream.synchronize()  # this decode's work only
    return planes_to_rgb(_split(host.numpy(), comps, list(dims)), dims[6],
                         dims[7])


def _decode_stream():
    """The calling thread's CUDA stream for nvJPEG, made on first use.
    PyTorch makes its streams non-blocking, so a decode (on a decode
    thread, while the model's batches run) waits for its own work alone,
    never for the batches queued on the current stream."""
    import torch

    stream = getattr(_local, "stream", None)
    if stream is None:
        stream = _local.stream = torch.cuda.Stream()
    return stream


def decode_rgb(path: str) -> np.ndarray:
    """A JPEG or PNG file -> (H, W, 3) uint8 RGB; anything else raises
    ``IOError``, as decode.cc does (by the file's first bytes)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data[:2] == b"\xff\xd8":
            return decode_jpeg(data)
        if data[:8] == png.SIGNATURE:
            return png.png_rgb(png.decode_png(data))
    except IOError as e:
        raise IOError(f"decode failed for {path}: {e}") from None
    raise IOError(f"decode failed for {path}: neither JPEG nor PNG")


def image_size(path: str) -> tuple[int, int]:
    """(H, W) of a JPEG or PNG file, from its header alone."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        return jpeg_size(data)
    if data[:8] == png.SIGNATURE and data[12:16] == b"IHDR":
        w, h = struct.unpack(">II", data[16:24])
        return h, w
    raise IOError(f"no JPEG or PNG header in {path}")


def _taps(n_src: int, n_dst: int, nearest: bool):
    """decode.cc's taps along one axis: (first, second, 16.16 weight of
    the second), each (n_dst,), in the same double arithmetic."""
    r = n_src / n_dst
    j = np.arange(n_dst, dtype=np.float64)
    if nearest:  # the centre convention, floor((j + 0.5) * r)
        s = np.minimum(float(n_src - 1), np.floor((j + 0.5) * r))
    else:
        s = np.maximum(0.0, (j + 0.5) * r - 0.5)
    lo = np.minimum(s.astype(np.int64), n_src - 1)
    hi = np.minimum(lo + 1, n_src - 1)
    frac = (np.zeros(n_dst, np.int64) if nearest
            else ((s - lo) * ONE).astype(np.int64))
    return lo, hi, frac.astype(np.int32)


def letterbox_rgb(src: np.ndarray, size: int, nearest: bool = False
                  ) -> np.ndarray:
    """(H, W, 3) uint8 -> (size, size, 3) uint8: resized to keep its
    aspect (the long side to ``size``, ``int(x + 0.5)`` rounding), at the
    top left, zeros elsewhere; decode.cc's ``letterbox`` byte for byte
    (each tap pair blended in 16.16, both blends cut to 8.8 before the
    vertical one, rounded half up)."""
    h, w = src.shape[:2]
    scale = size / max(h, w)
    vh = max(1, int(h * scale + 0.5))
    vw = max(1, int(w * scale + 0.5))
    y0, y1, fy = _taps(h, vh, nearest)
    x0, x1, fx = _taps(w, vw, nearest)
    out = np.zeros((size, size, 3), np.uint8)
    r0 = src.take(y0, axis=0)
    if nearest:  # every weight 0: the first tap of each axis
        out[:vh, :vw] = r0.take(x0, axis=1)
        return out
    r1 = src.take(y1, axis=0)
    wx = fx[None, :, None]
    top = (r0.take(x0, axis=1).astype(np.int32) * (ONE - wx)
           + r0.take(x1, axis=1).astype(np.int32) * wx)
    bot = (r1.take(x0, axis=1).astype(np.int32) * (ONE - wx)
           + r1.take(x1, axis=1).astype(np.int32) * wx)
    wy = fy[:, None, None]
    top >>= 8
    top *= (ONE - wy) >> 8
    bot >>= 8
    bot *= wy >> 8
    top += bot
    top += 1 << 15
    top >>= 16
    out[:vh, :vw] = top
    return out


def _decode_pool() -> ThreadPoolExecutor:
    """The process's decode threads (one pool, made on first use)."""
    global _pool
    with _lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=min(os.cpu_count() or 1, 16),
                thread_name_prefix="basi-decode")
        return _pool


class NativeDecoder:
    """``decode_letterbox`` and ``decode_letterbox_batch`` of the JAX
    package's ``NativeDecoder``, with the same results (JPEG on the
    nvjpeg route: within nvJPEG's own rounding)."""

    def decode_letterbox(self, path: str, size: int, nearest: bool = False):
        """(``(size, size, 3)`` uint8, ``(orig_h, orig_w)``)."""
        img = decode_rgb(str(path))
        return letterbox_rgb(img, size, nearest), img.shape[:2]

    def decode_letterbox_batch(self, paths, size: int, nearest: bool = False):
        """Decode many files at once on the process's decode threads
        (``zlib``, the C libraries and numpy's large operations release
        the GIL): (``(n, size, size, 3)`` uint8, ``(n, 2)`` int32 original
        sizes). A file that fails raises ``IOError`` naming it."""
        n = len(paths)
        out = np.zeros((n, size, size, 3), np.uint8)
        hw = np.zeros((n, 2), np.int32)

        def one(i):
            out[i], hw[i] = self.decode_letterbox(paths[i], size, nearest)

        if n == 1:
            one(0)
        else:
            for f in [_decode_pool().submit(one, i) for i in range(n)]:
                f.result()
        return out, hw


def get_decoder(backend: str = "auto") -> NativeDecoder:
    """``auto`` and ``native`` (and ``synthetic``, the setting of
    synthetic data, which decodes nothing) give the port's decoder;
    ``pil`` raises (the port has no PIL), as does any other name."""
    if backend in ("auto", "native", "synthetic"):
        return NativeDecoder()
    if backend == "pil":
        raise ValueError("data.decode_backend='pil': the port has no PIL; "
                         "use 'auto' or 'native'")
    raise ValueError(f"unknown data.decode_backend {backend!r}")
