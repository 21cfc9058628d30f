"""PNG codec in numpy, the standard library's ``zlib`` and a small C++
library for the row filters (``csrc/png_filter.cc``, built with ``g++`` on
first use).

The port imports no PIL, so it reads and writes PNG itself:

* ``read_png(path)`` returns ``(array, mode)``, the array
  ``np.asarray(PIL.Image.open(path))`` gives and PIL's mode name: ``1``
  (bool) for 1-bit grey; ``L`` for grey of 2, 4 or 8 bits (scaled to 0-255
  as PIL scales them); ``I;16`` (uint16) for 16-bit grey; ``P`` for palette
  images of any depth (the raw indices, never the colours; ``tRNS`` does
  not change them); ``LA``, ``RGB`` and ``RGBA`` (16-bit samples keep their
  high byte; 16-bit grey + alpha is ``RGBA``, the grey repeated, as PIL
  reads it). Every filter type and Adam7 interlacing are read.
* ``png_rgb(image)`` gives the (H, W, 3) uint8 RGB that libpng gives with
  the transforms of the JAX package's native decoder: palette to RGB, grey
  expanded to 8 bits and to RGB, 16-bit samples to their high byte, alpha
  dropped (never composited).
* ``write_png(path, arr)`` writes 8-bit ``L`` (2-D), ``RGB`` (H, W, 3), or
  ``P`` when a palette is given, filtered as libpng filters by default.

A bad signature, a CRC error, a truncated file or zlib stream, or a header
the format does not allow raises ``IOError``.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from dataclasses import dataclass

import numpy as np

from basi_tpu_torch.data import clib

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

_lock = threading.Lock()
_lib = None


@dataclass
class PngImage:
    samples: np.ndarray  # (H, W, channels) uint8, or uint16 at depth 16
    color_type: int
    bit_depth: int
    palette: np.ndarray | None  # (entries, 3) uint8


def _chunks(data: bytes):
    """(type, payload) of each chunk up to IEND, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise IOError("not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise IOError("truncated PNG: no IEND chunk")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise IOError(f"truncated PNG in a {ctype!r} chunk")
        body = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + body) != crc:
            raise IOError(f"PNG CRC error in a {ctype!r} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end + 4


def _library():
    """``csrc/png_filter.cc``, built on first use (``data/clib.py``)."""
    global _lib
    with _lock:
        if _lib is None:
            lib, _ = clib.load("basi_png", clib.CSRC / "png_filter.cc")
            for fn in (lib.basi_png_unfilter, lib.basi_png_filter):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t,
                               ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int
              ) -> np.ndarray:
    """The (rows, stride) uint8 scanlines of one (sub-)image from its
    ``rows * (1 + stride)`` filtered bytes."""
    out = np.empty((rows, stride), np.uint8)
    bad = _library().basi_png_unfilter(raw.ctypes.data, rows, stride, bpp,
                                       out.ctypes.data)
    if bad:
        raise IOError(f"bad PNG filter type {raw[(bad - 1) * (stride + 1)]}")
    return out


def _unpack(lines: np.ndarray, width: int, channels: int, depth: int
            ) -> np.ndarray:
    """Scanlines (rows, stride) -> samples (rows, width, channels)."""
    rows = lines.shape[0]
    if depth == 8:
        return lines[:, :width * channels].reshape(rows, width, channels)
    if depth == 16:
        return (lines[:, :width * channels * 2].view(">u2")
                .astype(np.uint16).reshape(rows, width, channels))
    bits = np.unpackbits(lines, axis=1)[:, :width * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    vals = (bits.reshape(rows, width, depth) * weights).sum(
        axis=2, dtype=np.uint8)
    return vals[..., None]


def decode_png(data: bytes) -> PngImage:
    """The samples of a PNG file's bytes, at their own depth."""
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            if len(body) != 13:
                raise IOError("bad PNG IHDR")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise IOError("PNG without IHDR")
    w, h, depth, ctype_, comp, filt, interlace = header
    if (ctype_ not in CHANNELS or depth not in DEPTHS[ctype_] or comp
            or filt or interlace > 1 or w == 0 or h == 0):
        raise IOError(f"unsupported PNG header {header}")
    if ctype_ == 3 and palette is None:
        raise IOError("palette PNG without PLTE")
    d = zlib.decompressobj()
    try:
        raw = d.decompress(b"".join(idat))
    except zlib.error as e:
        raise IOError(f"PNG image data: {e}") from None
    if not d.eof:
        raise IOError("truncated PNG image data")
    ch = CHANNELS[ctype_]
    bpp = max(1, ch * depth // 8)
    dtype = np.uint16 if depth == 16 else np.uint8
    samples = np.zeros((h, w, ch), dtype)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw, pos = np.frombuffer(raw, np.uint8), 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-pw * ch * depth // 8)
        need = ph * (stride + 1)
        if pos + need > len(raw):
            raise IOError("truncated PNG image data")
        lines = _unfilter(raw[pos:pos + need], ph, stride, bpp)
        samples[y0::dy, x0::dx] = _unpack(lines, pw, ch, depth)
        pos += need
    return PngImage(samples, ctype_, depth, palette)


def _read(path) -> PngImage:
    with open(path, "rb") as f:
        return decode_png(f.read())


def pil_view(img: PngImage) -> tuple[np.ndarray, str]:
    """``(np.asarray(Image.open(...)), mode)`` as PIL gives them."""
    s, ct, depth = img.samples, img.color_type, img.bit_depth
    if ct == 3:
        return s[..., 0], "P"
    if ct == 0:
        if depth == 1:
            return s[..., 0].astype(bool), "1"
        if depth == 16:
            return s[..., 0], "I;16"
        return s[..., 0] * np.uint8(255 // ((1 << depth) - 1)), "L"
    if depth == 16:
        s = (s >> 8).astype(np.uint8)
        if ct == 4:  # PIL reads 16-bit grey + alpha as RGBA
            return s[..., [0, 0, 0, 1]], "RGBA"
    return s, {2: "RGB", 4: "LA", 6: "RGBA"}[ct]


def read_png(path) -> tuple[np.ndarray, str]:
    """``(array, mode)``: what ``np.asarray(PIL.Image.open(path))`` and its
    ``mode`` give, for every PNG colour type and depth."""
    return pil_view(_read(path))


def png_rgb(img: PngImage) -> np.ndarray:
    """(H, W, 3) uint8 as libpng gives it with ``png_set_strip_16``,
    ``png_set_palette_to_rgb``, ``png_set_expand_gray_1_2_4_to_8``,
    ``png_set_gray_to_rgb`` and ``png_set_strip_alpha``."""
    s, ct, depth = img.samples, img.color_type, img.bit_depth
    if depth == 16:
        s = (s >> 8).astype(np.uint8)
    elif depth < 8 and ct == 0:
        s = s * np.uint8(255 // ((1 << depth) - 1))
    if ct == 3:
        pal = np.zeros((256, 3), np.uint8)  # indices past PLTE read black
        pal[:len(img.palette)] = img.palette[:256]
        return pal[s[..., 0]]
    if ct in (0, 4):
        return np.repeat(s[..., :1], 3, axis=2)
    return np.ascontiguousarray(s[..., :3])


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def _filter_rows(lines: np.ndarray, bpp: int) -> np.ndarray:
    """(h, stride) uint8 scanlines -> (h, 1 + stride) filtered rows, each
    with the filter type libpng's default heuristic picks for it."""
    lines = np.ascontiguousarray(lines)
    out = np.empty((lines.shape[0], lines.shape[1] + 1), np.uint8)
    if _library().basi_png_filter(lines.ctypes.data, lines.shape[0],
                                  lines.shape[1], bpp, out.ctypes.data):
        raise MemoryError("basi_png_filter: out of memory")
    return out


def write_png(path, arr: np.ndarray, palette: np.ndarray | None = None
              ) -> None:
    """Write 8-bit ``L`` (2-D uint8), ``RGB`` ((H, W, 3) uint8), or ``P``
    (2-D uint8 indices with ``palette`` (entries, 3) uint8), as libpng
    writes them by default: ``L`` and ``RGB`` rows with its adaptive
    filter choice, ``P`` rows unfiltered; zlib level 6."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {arr.dtype}")
    if arr.ndim == 2:
        ctype = 0 if palette is None else 3
    elif arr.ndim == 3 and arr.shape[2] == 3 and palette is None:
        ctype = 2
    else:
        raise ValueError(f"write_png: shape {arr.shape} with "
                         f"palette={palette is not None}")
    h, w = arr.shape[:2]
    lines = arr.reshape(h, -1)
    if ctype == 3:
        raw = np.concatenate([np.zeros((h, 1), np.uint8), lines], axis=1)
    else:
        raw = _filter_rows(lines, 3 if ctype == 2 else 1)
    parts = [SIGNATURE,
             _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))]
    if palette is not None:
        pal = np.ascontiguousarray(palette, np.uint8).reshape(-1, 3)
        if not 1 <= len(pal) <= 256:
            raise ValueError("a PNG palette holds 1 to 256 entries")
        parts.append(_chunk(b"PLTE", pal.tobytes()))
    parts += [_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
              _chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"".join(parts))
