"""Write the JPEG fixtures of the port's tests and of ``chip_smoke.py``.

The port has no JPEG encoder, so its checks of the JPEG route read files
made here, with Pillow, and the JAX package's ``NativeDecoder`` decodes of
them (libjpeg). Four small 37 x 45 images (a gradient, a disc and two
rectangles: baseline 4:4:4, baseline 4:2:0, greyscale and progressive
4:2:0) and three at the sizes of COCO and ILSO photographs (smooth
shading, sharp coloured shapes and sensor-like noise: 640 x 480 baseline
4:2:0, 640 x 427 progressive 4:2:0 and 612 x 612 baseline 4:4:4).
``jpeg.json`` holds, for each file, its shape, the sha256 of the JAX
decoder's decode at its own size (``sha256``), of its letterboxes to 64
and 512 (``sha256_lb64``, ``sha256_lb512``), and names a PNG of the
decode itself (``reference``), against which a route whose pixels are not
libjpeg's is measured. ``tests/test_torch_files.py`` decodes the files
again with the JAX package and checks all of it.

Run from the repository root, where Pillow and the JAX package's native
decoder build: ``python tests/test_torch_fixtures/make_jpeg_fixtures.py``.
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))

from basi_tpu.data.native import NativeDecoder, build_native  # noqa: E402
from basi_tpu_torch.data.png import write_png  # noqa: E402


def small() -> np.ndarray:
    yy, xx = np.mgrid[0:37, 0:45]
    img = np.stack([xx * 5, yy * 6, 255 - xx * 4], -1).astype(np.float64)
    img[(yy - 18) ** 2 + (xx - 22) ** 2 <= 100] = (250, 40, 30)
    img[4:12, 30:42] = (20, 200, 60)
    img[26:34, 3:16] = (240, 230, 20)
    return img.clip(0, 255).astype(np.uint8)


def photo(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([70 + 110 * yy, 110 + 70 * yy, 190 - 110 * yy], -1)
    for _ in range(12):  # smooth shading and texture
        f = rng.uniform(1, 40)
        a = rng.uniform(0, 2 * np.pi)
        wave = np.sin(2 * np.pi * f * (xx * np.cos(a) + yy * np.sin(a))
                      + rng.uniform(0, 2 * np.pi))
        img += wave[..., None] * rng.uniform(-12, 12, 3)
    for _ in range(8):  # objects with sharp colour edges
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(10, h / 4), rng.uniform(10, w / 4)
        inside = ((np.mgrid[0:h, 0:w][0] - cy) / ry) ** 2 + (
            (np.mgrid[0:h, 0:w][1] - cx) / rx) ** 2 <= 1
        img[inside] = img[inside] * 0.3 + rng.uniform(0, 255, 3) * 0.7
    img += rng.randn(h, w, 3) * 3  # sensor noise
    return img.clip(0, 255).astype(np.uint8)


FIXTURES = [  # name, image, Pillow's save options
    ("444", small, dict(quality=90, subsampling=0)),
    ("420", small, dict(quality=85, subsampling=2)),
    ("grey", lambda: small()[..., 1], dict(quality=85)),
    ("progressive", small, dict(quality=85, subsampling=2, progressive=True)),
    ("photo_420", lambda: photo(480, 640, 1), dict(quality=90, subsampling=2)),
    ("photo_progressive", lambda: photo(427, 640, 2),
     dict(quality=85, subsampling=2, progressive=True)),
    ("photo_444", lambda: photo(612, 612, 3), dict(quality=92, subsampling=0)),
]


def main() -> None:
    dec = NativeDecoder(build_native())
    manifest = {}
    for name, make, opts in FIXTURES:
        path = HERE / f"{name}.jpg"
        Image.fromarray(make()).save(path, "JPEG", **opts)
        with Image.open(path) as im:
            w, h = im.size
        ref = dec.decode_letterbox(str(path), max(h, w))[0][:h, :w]
        write_png(HERE / f"{name}.ref.png", ref)
        manifest[name] = {
            "file": path.name, "shape": [h, w], "options": opts,
            "sha256": hashlib.sha256(ref.tobytes()).hexdigest(),
            "reference": f"{name}.ref.png",
            **{f"sha256_lb{s}": hashlib.sha256(
                dec.decode_letterbox(str(path), s)[0].tobytes()).hexdigest()
               for s in (64, 512)}}
    (HERE / "jpeg.json").write_text(json.dumps(manifest, indent=1) + "\n")


if __name__ == "__main__":
    main()
