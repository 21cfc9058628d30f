"""The port's file readers against the JAX package's, on the CPU.

* ``data/png.py``: ``read_png`` gives what ``np.asarray(PIL.Image.open)``
  and its mode give, for every colour type and depth a PNG may hold, every
  filter type, with and without Adam7 interlacing (the files are written
  by an encoder here, in numpy, that uses all five filters); ``png_rgb``
  gives what the JAX package's native decoder gives (libpng's
  transforms); a CRC error, a truncated file or an unknown filter type
  raises ``IOError``; ``write_png`` round-trips ``L``, ``RGB`` and ``P``
  through PIL and filters rows as libpng does; a failed build of the
  unfilter raises with the compiler's output.
* ``data/native.py``: ``decode_letterbox`` and ``decode_letterbox_batch``
  byte-equal to the JAX package's ``NativeDecoder`` (JPEG 4:4:4, 4:2:0,
  grey and progressive; PNG modes; up and down; bilinear and nearest).
  Mirrored on purpose: a ``.bmp`` raises ``IOError`` in both (decode.cc
  reads JPEG and PNG only), and palette + ``tRNS`` and RGBA PNGs decode to
  their RGB (alpha dropped, never composited), as the reference's fix
  tested at ``tests/test_data.py:190`` does. ``decode_backend="pil"``
  raises: the port has no PIL and no fallback. The JPEG fixtures of
  ``tests/test_torch_fixtures/`` carry the JAX decoder's decodes and
  digests (37 x 45 and photograph sizes up to 640 x 480). The nvjpeg
  route's own half, ``planes_to_rgb`` (libjpeg's upsampling and colour
  conversion in numpy), is byte-equal to libjpeg on libjpeg's decoded
  components; a failed build raises with the compiler's output.
* ``FolderDataset``: ``get``, ``get_batch``, ``get_orig_masks``,
  ``iter_epoch`` batches, ``image_id`` and the native-GT cache key equal
  to the JAX ones on one folder with every mask layout (labeled ``L``, a
  palette whose colours collide in every channel, a 1-bit labeled PNG,
  per-instance PNGs, none), a ``split`` directory and the
  ``max_instances`` cap; ``pack_dataset`` of it byte-equal to the JAX
  package's pack of the JAX dataset.
* ``Inferencer.predict_paths`` and ``evaluate(results_path=...)`` with
  ``save_png`` and ``profile`` against JAX's on one folder (tiny model,
  f32, the same weights): the same summaries and result entries, PNG
  pixels and RLE masks equal except where a pasted probability lies
  within 1e-3 of 0.5, scores and metrics within 1e-3, and the trace
  written.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import dataclasses
import hashlib
import json
import os
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from basi_tpu.data import datasets as JD
from basi_tpu.data import native_gt as JNG
from basi_tpu.data import shards as JS
from basi_tpu.data.native import NativeDecoder as JaxDecoder
from basi_tpu.data.native import build_native
from basi_tpu.infer import Inferencer as JaxInferencer
from basi_tpu_torch.config import get_config
from basi_tpu_torch.data import clib
from basi_tpu_torch.data import datasets as D
from basi_tpu_torch.data import native as N
from basi_tpu_torch.data import native_gt as NG
from basi_tpu_torch.data import png as P
from basi_tpu_torch.data import shards as S
from basi_tpu_torch.data.coco import rle_decompress, rle_to_mask
from basi_tpu_torch.infer import Inferencer

from helpers import tiny_config
from test_torch_model import jax_variables

TOL = 1e-3
FIXTURES = Path(__file__).resolve().parent / "test_torch_fixtures"
JPEGS = json.loads((FIXTURES / "jpeg.json").read_text())


@pytest.fixture(scope="module")
def jax_decoder():
    path = build_native()
    assert path, "the JAX package's native decoder must build here"
    return JaxDecoder(path)


# --- a PNG encoder for the fixtures (numpy, every filter, Adam7) ------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples -> (h, stride) scanline bytes, big-endian."""
    h, w, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * ch * 2)
    if depth == 8:
        return samples.reshape(h, w * ch).astype(np.uint8)
    bits = ((samples[..., 0][..., None] >> np.arange(depth - 1, -1, -1))
            & 1).astype(np.uint8).reshape(h, w * depth)
    return np.packbits(bits, axis=1)


def _filter_row(ftype: int, row: np.ndarray, prior: np.ndarray,
                bpp: int) -> np.ndarray:
    r = row.astype(np.int32)
    p = prior.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])[:len(r)]
    c = np.concatenate([np.zeros(bpp, np.int32), p[:-bpp]])[:len(r)]
    if ftype == 0:
        pred = np.zeros_like(r)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = p
    elif ftype == 3:
        pred = (a + p) // 2
    else:
        pa, pb, pc = np.abs(p - c), np.abs(a - c), np.abs(a + p - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return ((r - pred) % 256).astype(np.uint8)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode_png(samples: np.ndarray, ctype: int, depth: int,
               interlace: bool = False, palette=None, trns=None,
               seed: int = 0) -> bytes:
    """A PNG of (h, w, ch) samples, each scanline with a filter type drawn
    from ``seed`` (all five appear)."""
    rng = np.random.RandomState(seed)
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    raw = []
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        lines = _pack_rows(sub, depth)
        prior = np.zeros(lines.shape[1], np.uint8)
        for row in lines:
            ftype = int(rng.randint(0, 5))
            raw.append(bytes([ftype]) + _filter_row(ftype, row, prior,
                                                    bpp).tobytes())
            prior = row
    parts = [P.SIGNATURE, _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))]
    if palette is not None:
        parts.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        parts.append(_chunk(b"tRNS", trns))
    data = zlib.compress(b"".join(raw), 9)
    # two IDAT chunks: the reader must join them
    parts += [_chunk(b"IDAT", data[:len(data) // 2]),
              _chunk(b"IDAT", data[len(data) // 2:]), _chunk(b"IEND", b"")]
    return b"".join(parts)


PNG_CASES = [  # (colour type, depth, tRNS)
    (0, 1, None), (0, 2, None), (0, 4, None), (0, 8, None), (0, 16, None),
    (0, 8, b"\x00\x07"), (2, 8, None), (2, 16, None),
    (2, 8, b"\x00\x01\x00\x02\x00\x03"), (3, 1, None), (3, 2, None),
    (3, 4, None), (3, 8, None), (3, 8, b"\x00\x80\xff"), (3, 4, b"\x10"),
    (4, 8, None), (4, 16, None), (6, 8, None), (6, 16, None),
]


def _png_case(ctype, depth, trns, interlace, h=23, w=29, seed=0):
    rng = np.random.RandomState(seed)
    ch = CHANNELS[ctype]
    hi = (1 << depth) - 1
    samples = rng.randint(0, hi + 1, (h, w, ch)).astype(
        np.uint16 if depth == 16 else np.uint8)
    samples[h // 3:h // 2] = samples[h // 3, 0]  # flat rows filter to zeros
    palette = None
    if ctype == 3:
        palette = rng.randint(0, 256, (min(hi + 1, 256), 3))
        palette[-1] = palette[0]  # two ids of one colour
    return encode_png(samples, ctype, depth, interlace, palette, trns,
                      seed=seed + depth)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth,trns", PNG_CASES)
def test_read_png_matches_pil(tmp_path, jax_decoder, ctype, depth, trns,
                              interlace):
    """``read_png`` against PIL 12.1 (array, dtype, mode) and ``png_rgb``
    plus the identity letterbox against the JAX package's decoder."""
    path = tmp_path / "x.png"
    path.write_bytes(_png_case(ctype, depth, trns, interlace))
    with Image.open(path) as im:
        want, want_mode = np.asarray(im), im.mode
    got, mode = P.read_png(path)
    assert (mode, got.dtype, got.shape) == (want_mode, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)
    ref, hw = jax_decoder.decode_letterbox(str(path), 29)
    rgb = P.png_rgb(P.decode_png(path.read_bytes()))
    np.testing.assert_array_equal(rgb, ref[:23, :29])
    lb, hw2 = N.NativeDecoder().decode_letterbox(str(path), 29)
    np.testing.assert_array_equal(lb, ref)
    assert tuple(hw2) == tuple(hw) == (23, 29)


def test_tiny_interlaced_pngs_with_empty_passes(tmp_path):
    """1 x 1 to 3 x 5 interlaced images leave some Adam7 passes empty."""
    for h, w in ((1, 1), (1, 5), (3, 2), (3, 5)):
        path = tmp_path / f"t{h}{w}.png"
        path.write_bytes(_png_case(2, 8, None, True, h=h, w=w))
        with Image.open(path) as im:
            np.testing.assert_array_equal(P.read_png(path)[0], np.asarray(im))


def test_read_png_raises_on_a_damaged_file(tmp_path):
    good = _png_case(2, 8, None, False)
    bad_crc = bytearray(good)
    bad_crc[40] ^= 0xFF  # inside IHDR's or IDAT's body: its CRC fails
    raw = bytearray(zlib.decompress(
        b"".join(b for t, b in P._chunks(good) if t == b"IDAT")))
    raw[5 * (1 + 29 * 3)] = 7  # row 5 names filter type 7
    bad_filter = good[:33] + _chunk(b"IDAT", zlib.compress(bytes(raw))) \
        + _chunk(b"IEND", b"")
    cases = {"crc": bytes(bad_crc), "truncated": good[:len(good) // 2],
             "no_iend": good[:-12], "signature": b"\x89PNX" + good[4:],
             "filter": bad_filter}
    for name, data in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        with pytest.raises(IOError):
            P.read_png(path)
    # a stream cut inside the zlib data, with its chunk's CRC correct
    idat = zlib.compress(np.zeros(23 * 88, np.uint8).tobytes())[:20]
    head = good[:33]
    path = tmp_path / "cut.png"
    path.write_bytes(head + _chunk(b"IDAT", idat) + _chunk(b"IEND", b""))
    with pytest.raises(IOError):
        P.read_png(path)


def test_write_png_round_trips(tmp_path):
    rng = np.random.RandomState(3)
    lum = rng.randint(0, 256, (17, 31)).astype(np.uint8)
    rgb = rng.randint(0, 256, (9, 14, 3)).astype(np.uint8)
    pal = rng.randint(0, 256, (5, 3)).astype(np.uint8)
    idx = rng.randint(0, 5, (12, 10)).astype(np.uint8)
    for name, arr, palette, mode in (("l", lum, None, "L"),
                                     ("rgb", rgb, None, "RGB"),
                                     ("p", idx, pal, "P")):
        path = tmp_path / f"{name}.png"
        P.write_png(path, arr, palette=palette)
        with Image.open(path) as im:
            assert im.mode == mode
            np.testing.assert_array_equal(np.asarray(im), arr)
            if palette is not None:
                np.testing.assert_array_equal(
                    np.asarray(im.getpalette()[:15], np.uint8).reshape(5, 3),
                    pal)
        got, got_mode = P.read_png(path)
        assert got_mode == mode
        np.testing.assert_array_equal(got, arr)
    with pytest.raises(ValueError):
        P.write_png(tmp_path / "f.png", lum.astype(np.float32))


def _filter_types(data: bytes, h: int, stride: int) -> np.ndarray:
    idat = b"".join(body for ctype, body in P._chunks(data) if ctype == b"IDAT")
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, stride + 1)[:, 0]


def test_write_png_filters_rows_as_libpng(tmp_path):
    """``L`` and ``RGB`` rows take the filter libpng's default heuristic
    picks (the first of the five whose bytes, read as signed, have the
    least absolute sum), so a photograph's rows use several filter types;
    ``P`` rows are unfiltered, as libpng leaves palette images."""
    photo = P.read_png(FIXTURES / JPEGS["photo_420"]["reference"])[0][:96]
    for arr, bpp in ((photo, 3), (photo[..., 1].copy(), 1)):
        path = tmp_path / f"f{bpp}.png"
        P.write_png(path, arr)
        h = arr.shape[0]
        lines = arr.reshape(h, -1)
        types = _filter_types(path.read_bytes(), h, lines.shape[1])
        prior = np.zeros(lines.shape[1], np.uint8)
        for y in range(h):
            cost = [np.abs(_filter_row(f, lines[y], prior, bpp)
                           .view(np.int8).astype(np.int64)).sum()
                    for f in range(5)]
            assert types[y] == int(np.argmin(cost)), y
            prior = lines[y]
        assert len(set(types.tolist())) >= 3, types
        np.testing.assert_array_equal(P.read_png(path)[0], arr)
    idx = (photo[..., 0] // 64).astype(np.uint8)
    P.write_png(tmp_path / "p.png", idx, palette=np.eye(4, 3, dtype=np.uint8))
    assert not _filter_types((tmp_path / "p.png").read_bytes(), *idx.shape).any()


def test_failed_png_build_raises_with_the_compiler_output(tmp_path,
                                                          monkeypatch):
    """The PNG row filters are built on first use; a source that does not
    compile raises with g++'s error when a PNG is read."""
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "png_filter.cc").write_text("int broken(;\n")
    monkeypatch.setattr(clib, "CSRC", bad)
    monkeypatch.setattr(clib, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(P, "_lib", None)
    path = tmp_path / "x.png"
    path.write_bytes(_png_case(2, 8, None, False))
    with pytest.raises(RuntimeError, match="failed") as err:
        P.read_png(path)
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").rglob("*.so"))


# --- the decoder --------------------------------------------------------------

def _jpeg_files(tmp_path) -> list[str]:
    return [str(FIXTURES / fx["file"]) for fx in JPEGS.values()]


def test_jpeg_fixtures_are_the_jax_decoders_decodes(tmp_path, jax_decoder):
    """The fixtures' digests and reference decodes are what the JAX
    package's decoder gives for their files; the port's route here gives
    the same, and the letterboxes of each reference decode give the
    letterbox digests."""
    for name, fx in JPEGS.items():
        path = str(FIXTURES / fx["file"])
        h, w = fx["shape"]
        raw = jax_decoder.decode_letterbox(path, max(h, w))[0][:h, :w]
        assert hashlib.sha256(raw.tobytes()).hexdigest() == fx["sha256"]
        ref, mode = P.read_png(FIXTURES / fx["reference"])
        assert mode == "RGB"
        np.testing.assert_array_equal(ref, raw)
        np.testing.assert_array_equal(N.decode_rgb(path), raw)
        for size in (64, 512):
            digest = fx[f"sha256_lb{size}"]
            lb = jax_decoder.decode_letterbox(path, size)[0]
            assert hashlib.sha256(lb.tobytes()).hexdigest() == digest
            assert hashlib.sha256(
                N.letterbox_rgb(raw, size).tobytes()).hexdigest() == digest


@pytest.mark.parametrize("sub", [0, 1, 2], ids=["444", "422", "420"])
def test_planes_to_rgb_is_libjpegs_upsampling_and_colour(sub):
    """The nvjpeg route's second half, ``planes_to_rgb`` (libjpeg's fancy
    upsampling and YCbCr -> RGB in numpy), on libjpeg's own decoded
    components: byte-equal to libjpeg's RGB, on sizes from 1 x 1 (the
    planes' edges) to 33 x 64, baseline and progressive."""
    import io

    rng = np.random.RandomState(sub)
    for h in (1, 2, 3, 8, 17, 33):
        for w in (1, 2, 3, 5, 16, 17, 64):
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for progressive in (False, True):
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, "JPEG", quality=80,
                                          subsampling=sub,
                                          progressive=progressive)
                data = buf.getvalue()
                planes, hf, vf = N.jpeg_planes(data)
                assert (hf, vf) == ((1, 1), (2, 1), (2, 2))[sub]
                np.testing.assert_array_equal(
                    N.planes_to_rgb(planes, hf, vf), N.decode_jpeg(data),
                    err_msg=f"{h}x{w} progressive={progressive}")
    grey = io.BytesIO()
    Image.fromarray(img[..., 0]).save(grey, "JPEG", quality=80)
    planes, hf, vf = N.jpeg_planes(grey.getvalue())
    assert len(planes) == 1
    np.testing.assert_array_equal(N.planes_to_rgb(planes, hf, vf),
                                  N.decode_jpeg(grey.getvalue()))


def test_planes_to_rgb_reads_rgb_coded_jpegs():
    """A JPEG libjpeg reads as RGB-coded (Pillow's ``keep_rgb``: an Adobe
    marker with transform 0) takes no YCbCr conversion on the nvjpeg
    route's second half: ``jpeg_is_rgb`` finds it, and ``planes_to_rgb``
    of libjpeg's components is libjpeg's RGB, byte for byte. The other
    fixtures are YCbCr (or grey)."""
    import io

    rng = np.random.RandomState(3)
    for h, w in ((1, 1), (8, 17), (33, 64)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=85, subsampling=0,
                                  keep_rgb=True)
        data = buf.getvalue()
        assert N.jpeg_is_rgb(data)
        planes, hf, vf = N.jpeg_planes(data)
        np.testing.assert_array_equal(
            N.planes_to_rgb(planes, hf, vf, rgb=True), N.decode_jpeg(data))
        assert not np.array_equal(N.planes_to_rgb(planes, hf, vf),
                                  N.decode_jpeg(data))
    for name, fx in JPEGS.items():
        data = (FIXTURES / fx["file"]).read_bytes()
        assert N.jpeg_is_rgb(data) == (name == "rgb"), name


def _image_files(tmp_path) -> list[str]:
    """JPEGs of every kind, PNGs of several modes, sizes up and down."""
    rng = np.random.RandomState(5)
    paths = _jpeg_files(tmp_path)
    yy, xx = np.mgrid[0:61, 0:97]
    smooth = np.stack([xx * 2, yy * 4, (xx + yy) % 256], -1).astype(np.uint8)
    for q, sub, name in ((90, 0, "a"), (75, 2, "b"), (80, 1, "c")):
        p = tmp_path / f"{name}.jpg"
        Image.fromarray(smooth).save(p, quality=q, subsampling=sub)
        paths.append(str(p))
    p = tmp_path / "prog.jpg"
    Image.fromarray(smooth[:40, :33]).save(p, quality=70, progressive=True)
    paths.append(str(p))
    for ctype, depth, trns in ((2, 8, None), (0, 8, None), (3, 4, b"\x20"),
                               (6, 8, None), (0, 16, None)):
        p = tmp_path / f"png_{ctype}_{depth}.png"
        p.write_bytes(_png_case(ctype, depth, trns, False, h=41, w=18,
                                seed=depth))
        paths.append(str(p))
    p = tmp_path / "big.png"
    Image.fromarray(rng.randint(0, 256, (150, 201, 3)).astype(np.uint8)).save(p)
    paths.append(str(p))
    return paths


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("size", [16, 45, 64, 128])
def test_decoder_matches_jax(tmp_path, jax_decoder, size, nearest):
    """Every file one by one and through the batch API, byte-equal."""
    paths = _image_files(tmp_path)
    port = N.get_decoder("auto")
    for p in paths:
        want, whw = jax_decoder.decode_letterbox(p, size, nearest)
        got, ghw = port.decode_letterbox(p, size, nearest)
        np.testing.assert_array_equal(got, want, err_msg=p)
        assert tuple(ghw) == tuple(whw)
        assert N.image_size(p) == tuple(whw)
    want, whw = jax_decoder.decode_letterbox_batch(paths, size, nearest)
    got, ghw = port.decode_letterbox_batch(paths, size, nearest)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ghw, whw)


def test_decoder_refuses_what_the_reference_refuses(tmp_path, jax_decoder):
    """``.bmp`` (listed by the folder dataset, unread by decode.cc), a
    corrupt JPEG, and a missing file raise ``IOError`` in both."""
    rng = np.random.RandomState(0)
    bmp = tmp_path / "x.bmp"
    Image.fromarray(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)).save(bmp)
    corrupt = tmp_path / "c.jpg"
    corrupt.write_bytes(b"\xff\xd8\xff\xe0" + bytes(40))
    for p in (bmp, corrupt, tmp_path / "missing.png"):
        with pytest.raises(IOError):
            jax_decoder.decode_letterbox(str(p), 32)
        with pytest.raises(IOError):
            N.NativeDecoder().decode_letterbox(str(p), 32)
        with pytest.raises(IOError):
            N.NativeDecoder().decode_letterbox_batch([str(p)] * 2, 32)


def test_decode_backend_pil_raises():
    with pytest.raises(ValueError, match="no PIL"):
        N.get_decoder("pil")
    with pytest.raises(ValueError, match="unknown"):
        N.get_decoder("opencv")
    for name in ("auto", "native", "synthetic"):
        assert isinstance(N.get_decoder(name), N.NativeDecoder)
    cfg = tiny_config(batch_size=2)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, decode_backend="pil"))
    with pytest.raises(ValueError, match="no PIL"):
        Inferencer(cfg, device="cpu").predict_paths([])


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s error; nothing is
    loaded."""
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / f"jpeg_{N.route()}.cc").write_text("int broken(;\n")
    monkeypatch.setattr(clib, "CSRC", bad)
    monkeypatch.setattr(clib, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(N, "_lib", None)
    with pytest.raises(RuntimeError, match="failed") as err:
        N.library()
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").rglob("*.so"))


# --- FolderDataset --------------------------------------------------------------

def _scene_masks(rng, h, w, k):
    yy, xx = np.mgrid[0:h, 0:w]
    lab = np.zeros((h, w), np.uint8)
    for i in range(k):
        cy, cx = rng.randint(h // 5, 4 * h // 5), rng.randint(w // 5, 4 * w // 5)
        r = rng.randint(3, max(4, min(h, w) // 4))
        lab[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = i + 1
    return lab


def make_folder(root, n=10, seed=0, split=""):
    """Images (JPEG and PNG, non-square) and every mask layout."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, split) if split else root
    os.makedirs(os.path.join(base, "images"))
    os.makedirs(os.path.join(base, "masks"))
    for i in range(n):
        h, w = int(rng.randint(30, 90)), int(rng.randint(30, 90))
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        stem = f"{i:03d}" if i % 3 else f"img_{i}"
        if i % 2:
            Image.fromarray(img).save(os.path.join(base, "images",
                                                   stem + ".jpg"), quality=90)
        else:
            P.write_png(os.path.join(base, "images", stem + ".png"), img)
        lab = _scene_masks(rng, h, w, int(rng.randint(1, 6)))
        mask = os.path.join(base, "masks", stem + ".png")
        kind = i % 5
        if kind == 0:
            P.write_png(mask, lab)
        elif kind == 1:  # palette colours that collide in every channel
            pal = np.full((8, 3), 128, np.uint8)
            pal[0] = 0
            P.write_png(mask, lab, palette=pal)
        elif kind == 2:  # 1-bit labeled: bool ids
            Image.fromarray(lab > 0).save(mask)
        elif kind == 3:  # per-instance PNGs (RGB and L)
            d = os.path.join(base, "masks", stem)
            os.makedirs(d)
            for v in range(1, int(lab.max()) + 1):
                m = ((lab == v) * 255).astype(np.uint8)
                if v % 2:
                    m = np.repeat(m[..., None], 3, axis=2)
                P.write_png(os.path.join(d, f"{v:02d}.png"), m)
        # kind 4: no masks
    return root


def _assert_samples_equal(a, b):
    for f in ("image", "masks", "valid", "orig_hw", "valid_hw"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.name == b.name


@pytest.mark.parametrize("split", ["", "val"])
def test_folder_dataset_matches_jax(tmp_path, split):
    root = make_folder(str(tmp_path / "f"), split=split)
    got = D.FolderDataset(root, image_size=48, max_instances=3, split=split)
    want = JD.FolderDataset(root, image_size=48, max_instances=3, split=split,
                            decode_backend="native")
    assert got.names == want.names and len(got) == 10
    for i in range(len(got)):
        _assert_samples_equal(got.get(i), want.get(i))
        assert got.image_id(i) == want.image_id(i)
        gm, gv = got.get_orig_masks(i)
        wm, wv = want.get_orig_masks(i)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gv, wv)
    idx = [7, 0, 3, 3, 9]
    for a, b in zip(got.get_batch(idx), want.get_batch(idx)):
        _assert_samples_equal(a, b)
    for a, b in zip(got.get_batch(idx), [got.get(i) for i in idx]):
        _assert_samples_equal(a, b)
    for kw in (dict(batch_size=4, shuffle=True, seed=2),
               dict(batch_size=3, shuffle=False, seed=0, drop_last=False)):
        for x, y in zip(D.iter_epoch(got, **kw), JD.iter_epoch(want, **kw)):
            for k in y:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert NG.dataset_cache_key(got) == JNG.dataset_cache_key(want)


def test_folder_labeled_ids_survive_the_palette(tmp_path):
    """A palette whose colours are all one grey keeps each id apart; a
    1-bit labeled PNG gives one instance (bool ids, as the reference)."""
    root = make_folder(str(tmp_path / "f"))
    ds = D.FolderDataset(root, image_size=64, max_instances=8)
    pal_i = next(i for i, n in enumerate(ds.names) if n.startswith("001"))
    lab = P.read_png(os.path.join(root, "masks", "001.png"))[0]
    masks, valid = ds.get_orig_masks(pal_i)
    assert valid.sum() == len(np.unique(lab)) - 1 > 1
    bool_i = next(i for i, n in enumerate(ds.names) if n.startswith("002"))
    assert P.read_png(os.path.join(root, "masks", "002.png"))[1] == "1"
    assert ds.get_orig_masks(bool_i)[1].sum() == 1


def test_make_dataset_builds_the_file_datasets(tmp_path):
    root = make_folder(str(tmp_path / "f"), split="train")
    for name in ("ilso", "soc", "folder"):
        cfg = get_config("", [f"data.dataset={name}", f"data.root={root}",
                              "data.image_size=32", "model.image_size=32",
                              "data.max_instances=3"])
        ds = D.make_dataset(cfg.data, split="train")
        assert type(ds).__name__ == "FolderDataset" and len(ds) == 10
    with pytest.raises(FileNotFoundError):
        D.make_dataset(get_config("", ["data.dataset=folder",
                                       f"data.root={tmp_path}/none"]).data)
    cfg = get_config("", ["data.dataset=folder", f"data.root={root}",
                          "data.decode_backend=pil"])
    with pytest.raises(ValueError, match="no PIL"):
        D.make_dataset(cfg.data, split="train")


def test_pack_dataset_of_a_folder_matches_jax(tmp_path):
    """The port's shards of its FolderDataset, byte for byte the JAX
    package's shards of the JAX FolderDataset."""
    root = make_folder(str(tmp_path / "f"))
    got = D.FolderDataset(root, image_size=40, max_instances=3)
    want = JD.FolderDataset(root, image_size=40, max_instances=3,
                            decode_backend="native")
    S.pack_dataset(got, str(tmp_path / "port"), shard_size=4, batch_size=3,
                   log=None)
    JS.pack_dataset(want, str(tmp_path / "jax"), shard_size=4, batch_size=3,
                    log=None)
    a = sorted(os.listdir(tmp_path / "port"))
    assert a == sorted(os.listdir(tmp_path / "jax")) and len(a) > 2
    for f in a:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f


def test_native_gt_cache_of_a_folder(tmp_path):
    """The cache serves the folder's native GT packed; editing a mask
    file makes a new key."""
    root = make_folder(str(tmp_path / "f"), n=5)
    ds = D.FolderDataset(root, image_size=32, max_instances=4)
    cache = NG.NativeGTCache(ds, str(tmp_path / "gt"))
    assert cache.on_disk
    for i in range(len(ds)):
        packed, valid, (oh, ow) = cache.get_packed(i)
        masks, want_valid = ds.get_orig_masks(i)
        np.testing.assert_array_equal(
            np.unpackbits(packed, axis=-1)[..., :ow], masks)
        np.testing.assert_array_equal(valid, want_valid)
    key = NG.dataset_cache_key(ds)
    mask = os.path.join(root, "masks", "img_0.png")
    os.utime(mask, (1, 1))
    assert NG.dataset_cache_key(ds) != key


# --- predict_paths and evaluate's outputs against JAX ---------------------------

def _tiny_cfg(root, out, save_png=False, orig=False, profile=False):
    """The tiny model on a folder, one config for both packages."""
    cfg = tiny_config(batch_size=4)
    return dataclasses.replace(
        cfg, profile=profile, profile_dir=os.path.join(out, "trace"),
        data=dataclasses.replace(cfg.data, dataset="folder", root=root,
                                 split=""),
        infer=dataclasses.replace(cfg.infer, score_threshold=0.05,
                                  output_dir=out, save_png=save_png,
                                  ap_at_original=orig))


def _near_half(prob_a: np.ndarray, prob_b: np.ndarray) -> np.ndarray:
    return (np.abs(prob_a - 0.5) <= TOL) | (np.abs(prob_b - 0.5) <= TOL)


def _assert_pngs_close(dir_a, dir_b, names):
    """Equal label PNGs, except that a pixel may differ only where a slot
    of either side lies within 1e-3 of 0.5 (checked by the callers on
    the pasted probabilities): here at most 0.5% of a PNG's pixels."""
    for n in names:
        a = P.read_png(os.path.join(dir_a, n + ".png"))[0]
        b = P.read_png(os.path.join(dir_b, n + ".png"))[0]
        assert a.shape == b.shape, n
        assert (a != b).mean() <= 0.005, (n, (a != b).sum())


def _assert_results_close(got: list, want: list, probs: dict):
    """The same entries in the same order: ids, categories and sizes
    equal, scores within 1e-3, masks equal outside ``probs``' near-0.5
    pixels of that image."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["image_id"] == w["image_id"]
        assert g["category_id"] == w["category_id"] == 1
        assert abs(g["score"] - w["score"]) <= TOL
        assert g["segmentation"]["size"] == w["segmentation"]["size"]
        h, wd = g["segmentation"]["size"]
        mg = rle_to_mask(rle_decompress(g["segmentation"]["counts"]), h, wd)
        mw = rle_to_mask(rle_decompress(w["segmentation"]["counts"]), h, wd)
        if g["image_id"] in probs:
            assert not (mg != mw)[~probs[g["image_id"]]].any()
        else:
            assert (mg != mw).mean() <= 0.005


@pytest.fixture(scope="module")
def folder_and_weights(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pred")
    root = make_folder(str(tmp / "f"), n=6, seed=4)
    cfg = _tiny_cfg(root, str(tmp / "out"))
    params, stats = jax_variables(cfg, seed=2)
    return tmp, root, params, stats


def test_predict_paths_matches_jax(folder_and_weights):
    tmp, root, params, stats = folder_and_weights
    img_dir = os.path.join(root, "images")
    paths = [os.path.join(img_dir, f) for f in sorted(os.listdir(img_dir))]
    dup = tmp / "dup"  # the same stem in another directory: <stem>_1
    dup.mkdir(exist_ok=True)
    (dup / os.path.basename(paths[1])).write_bytes(
        open(paths[1], "rb").read())
    paths.append(str(dup / os.path.basename(paths[1])))
    cfg = _tiny_cfg(root, str(tmp / "port"))
    port = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    jax_inf = JaxInferencer(cfg, params=params, batch_stats=stats)
    with pytest.warns(UserWarning, match="duplicate COCO image_id"):
        got = port.predict_paths(paths, out_dir=str(tmp / "port"),
                                 results_path=str(tmp / "port.json"))
    with pytest.warns(UserWarning, match="duplicate COCO image_id"):
        want = jax_inf.predict_paths(paths, out_dir=str(tmp / "jax"),
                                     results_path=str(tmp / "jax.json"))
    assert [g["path"] for g in got] == [w["path"] for w in want] == paths
    for g, w in zip(got, want):
        assert g["instances"] == w["instances"]
        np.testing.assert_allclose(g["scores"], w["scores"], atol=TOL)
    names = sorted(f[:-4] for f in os.listdir(tmp / "jax"))
    assert names == sorted(f[:-4] for f in os.listdir(tmp / "port")
                           if f.endswith(".png"))
    stems = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    assert len(names) == 7 and f"{stems[1]}_1" in names
    stems[-1] += "_1"
    for p, n in zip(paths, stems):  # each PNG at its image's original size
        assert P.read_png(tmp / "port" / f"{n}.png")[0].shape == \
            N.image_size(p)
    _assert_pngs_close(tmp / "port", tmp / "jax", names)
    _assert_results_close(json.loads((tmp / "port.json").read_text()),
                          json.loads((tmp / "jax.json").read_text()), {})


def test_predict_paths_pastes_as_jax_does(folder_and_weights):
    """The pasted probabilities of one padded batch within 1e-3 of JAX's
    (the port fetches them binarized at 0.5: PNG and RLE pixels may only
    differ where these lie within 1e-3 of 0.5)."""
    tmp, root, params, stats = folder_and_weights
    img_dir = os.path.join(root, "images")
    paths = [os.path.join(img_dir, f) for f in sorted(os.listdir(img_dir))][:3]
    cfg = _tiny_cfg(root, str(tmp / "o"))
    port = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    jax_inf = JaxInferencer(cfg, params=params, batch_stats=stats)
    imgs, hws = N.NativeDecoder().decode_letterbox_batch(paths, 64)
    idx = [0, 1, 2, 0]
    batch = {"orig_hw": hws[idx], "num_real": 3, "valid_hw": np.array(
        [D.letterbox_params(int(h), int(w), 64) for h, w in hws[idx]],
        np.int32)}
    masks, scores, _ = port.predict_batch(imgs[idx])
    got, ch, cw = port._paste_batch(batch, port.full_res_masks(masks))
    jm, js, _ = jax_inf._run(jax_inf.params, jax_inf.batch_stats, imgs[idx])
    want, wch, wcw = jax_inf._paste_batch(batch, jax_inf._full_fn(jm))
    assert (ch, cw) == (wch, wcw) == (512, 512)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=TOL)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    assert (got.numpy()[3] == got.numpy()[0]).all()  # the padded row


def test_predict_paths_refuses_an_unwritable_results_path(folder_and_weights):
    """The results path is probed before any inference, in append mode: a
    file already there keeps its bytes."""
    tmp, root, params, stats = folder_and_weights
    cfg = _tiny_cfg(root, str(tmp / "o2"))
    port = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    blocker = tmp / "blocker"
    blocker.write_text("keep")
    with pytest.raises(OSError):
        port.predict_paths(["/nonexistent.png"],
                           results_path=str(blocker / "r.json"))
    assert blocker.read_text() == "keep"


def test_evaluate_outputs_match_jax(folder_and_weights):
    """``evaluate`` with ``results_path``, ``save_png`` and ``profile`` on
    the folder, in the original frame, against JAX's."""
    tmp, root, params, stats = folder_and_weights
    cfg = _tiny_cfg(root, str(tmp / "ep"), save_png=True, orig=True,
                    profile=True)
    port = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    got = port.evaluate(results_path=str(tmp / "ep.json"))
    jcfg = _tiny_cfg(root, str(tmp / "ej"), save_png=True, orig=True)
    jax_inf = JaxInferencer(jcfg, params=params, batch_stats=stats)
    want = jax_inf.evaluate(results_path=str(tmp / "ej.json"))
    assert set(got) == set(want) and got["num_images"] == 6
    assert got["num_results"] == want["num_results"] > 0
    for k, v in want.items():
        if k not in ("infer_ms_per_batch", "imgs_per_s", "png_ms_per_batch"):
            assert abs(got[k] - v) <= TOL, (k, got[k], v)
    names = sorted(f[:-4] for f in os.listdir(tmp / "ej")
                   if f.endswith(".png"))
    assert names == [f"b{b}_i{i}" for b in range(2) for i in range(4)][:6]
    _assert_pngs_close(tmp / "ep", tmp / "ej", names)
    _assert_results_close(json.loads((tmp / "ep.json").read_text()),
                          json.loads((tmp / "ej.json").read_text()), {})
    traces = list((tmp / "ep" / "trace").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "eval.forward" for e in events)
