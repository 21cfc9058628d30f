"""COCO-format instance segmentation (port of ``basi_tpu/data/coco.py``).

The RLE codec of the COCO spec (column-major runs; the compressed string
form: 5 data bits a byte, offset 48, sign-extended, delta-coded from the
third count on), equal to the JAX package's character for character; the
polygon fill (``polygons_to_mask``), a scan-line fill in Python and numpy
that draws what Pillow's ``ImageDraw.polygon(..., outline=1, fill=1)``
draws, which the JAX package calls (the port has no PIL); and ``CocoDataset``, which feeds a
COCO annotation file through the same ``Sample`` contract as the folder
datasets.

``CocoDataset``: annotations sort by area, largest first, and the first
``max_instances`` whose masks are not empty are kept (a degenerate
annotation never evicts a real one); ``iscrowd`` regions are skipped
unless ``include_crowd``. GT is built at the original size (so
``get_orig_masks`` serves the original-frame eval) and letterboxed with
centre-convention nearest sampling. ``image_id`` gives the annotation
file's own ids.

Layout: ``root/annotations/instances_<split>[year].json`` (or
``ann_file``), images in the first of ``root/<split>``,
``root/<year split>`` (from the annotation file's name),
``root/images`` and ``root`` that holds an annotated image.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from basi_tpu_torch.data.datasets import Sample, letterbox_params, nearest_rows


def rle_decompress(s: str | bytes) -> list[int]:
    """COCO compressed RLE string -> run counts."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: list[int] = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_to_mask(counts: list[int], h: int, w: int) -> np.ndarray:
    """Run counts (alternating 0- and 1-runs, column-major) -> (h, w) u8;
    counts that do not cover the mask raise ``ValueError``."""
    total = int(np.sum(counts, dtype=np.int64)) if len(counts) else 0
    if total != h * w:
        raise ValueError(f"RLE covers {total} px, mask is {h}x{w}={h * w}")
    vals = np.arange(len(counts)) % 2
    flat = np.repeat(vals.astype(np.uint8), counts)
    return np.ascontiguousarray(flat.reshape(w, h).T)


def mask_to_counts(mask: np.ndarray) -> list[int]:
    """(h, w) binary mask -> run counts, column-major, starting with the
    (possibly empty) 0-run: the inverse of ``rle_to_mask``."""
    flat = (np.asarray(mask) > 0).astype(np.uint8).T.reshape(-1)
    if flat.size == 0:
        return [0]
    edges = np.flatnonzero(np.diff(flat)) + 1
    counts = np.diff(np.concatenate(([0], edges, [flat.size]))).tolist()
    if flat[0] == 1:
        counts.insert(0, 0)
    return counts


def rle_compress(counts: list[int]) -> str:
    """Run counts -> COCO compressed RLE string (the inverse of
    ``rle_decompress``)."""
    s = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(c + 48)
    return s.decode("ascii")


def mask_to_rle(mask: np.ndarray) -> dict:
    """(h, w) binary mask -> ``{"size": [h, w], "counts": str}``, the
    segmentation pycocotools' ``loadRes`` reads."""
    h, w = np.asarray(mask).shape
    return {"size": [int(h), int(w)],
            "counts": rle_compress(mask_to_counts(mask))}


# --- the polygon fill -------------------------------------------------------
#
# A copy of Pillow 12.1's ``polygon_generic`` (libImaging/Draw.c) for one
# ring drawn with ``fill``, in its float32 arithmetic. The edges: a run of
# horizontal segments in one direction merges into one edge; horizontal
# edges are drawn as spans. Every row from the top vertex to the bottom one
# (clamped to [0, h]) takes the crossing ``(y - y0) * dx + x0`` of each
# edge spanning it, in edge order; an edge's last row counts its crossing
# twice unless that row is the ring's last. At an edge's top vertex (or its
# bottom one on the last row), when an earlier edge of nonzero slope has a
# vertex on the same row whose crossing rounds to the same pixel and spans
# the adjacent row (the next; the previous on the last row), the first such
# edge is the corner's partner: where both edges' crossings of the adjacent
# row lie more than 1 px to one side, the vertex crossing moves to 1 px
# past the nearer of them, rounded (so thin corners stay connected). The
# sorted crossings pair up into spans from ROUND_UP of the first to
# ROUND_DOWN of the second.

_HALF = np.float32(0.5)


def _roundf(v) -> float:
    """C's ``roundf``: half away from zero."""
    v = float(v)
    return math.floor(v + 0.5) if v >= 0 else -math.floor(-v + 0.5)


def _round_up(x: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_UP of float32 values (the sum in float32 at or above
    zero, in double below, as its C does)."""
    pos = np.floor(x + _HALF).astype(np.int64)
    neg = -np.floor(np.abs(x.astype(np.float64)) + 0.5).astype(np.int64)
    return np.where(x >= 0, pos, neg)


def _round_down(x: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_DOWN of float32 values."""
    pos = np.ceil(x - _HALF).astype(np.int64)
    neg = -np.ceil(np.abs(x.astype(np.float64)) - 0.5).astype(np.int64)
    return np.where(x >= 0, pos, neg)


def _edges(pts: list[tuple[int, int]]) -> np.ndarray:
    """(E, 6) int64 rows ``xmin, xmax, ymin, ymax, x0, y0`` of a ring's
    edges, as Pillow builds them (collinear horizontal runs merged)."""
    edges: list[list[int]] = []

    def add(x0: int, y0: int, x1: int, y1: int) -> None:
        edges.append([min(x0, x1), max(x0, x1), min(y0, y1), max(y0, y1),
                      x0, y0, x1, y1])

    for i in range(len(pts) - 1):
        (x0, y0), (x1, y1) = pts[i], pts[i + 1]
        if y0 == y1 and i != 0 and y0 == pts[i - 1][1]:
            if x1 > x0 > pts[i - 1][0]:
                edges[-1][1] = x1
                continue
            if x1 < x0 < pts[i - 1][0]:
                edges[-1][0] = x1
                continue
        add(x0, y0, x1, y1)
    if pts[-1] != pts[0]:
        add(*pts[-1], *pts[0])
    return np.array(edges, np.int64).reshape(-1, 8)


def _fill_polygon(out: np.ndarray, pts: list[tuple[int, int]]) -> None:
    """Fill one ring of integer vertices into ``out`` as Pillow does."""
    h, w = out.shape
    e = _edges(pts)
    ylo = max(min(h - 1, int(e[:, 2].min())), 0)
    yhi = min(max(0, int(e[:, 3].max())), h)
    rows, starts, ends = [], [], []
    flat = e[:, 2] == e[:, 3]
    for xmin, xmax, y in e[flat][:, [0, 1, 2]]:
        rows.append(np.array([y]))
        starts.append(np.array([xmin]))
        ends.append(np.array([xmax]))
    t = e[~flat]
    tymin, tymax, tx0, ty0 = t[:, 2], t[:, 3], t[:, 4], t[:, 5]
    dx = (t[:, 6] - t[:, 4]).astype(np.float32) / (
        t[:, 7] - t[:, 5]).astype(np.float32)

    def cross(i, y):
        return np.float32(y - ty0[i]) * dx[i] + np.float32(tx0[i])

    # every crossing, in edge order within a row; each edge's last row
    # counted twice unless it is the ring's last
    lo, hi = np.maximum(tymin, ylo), np.minimum(tymax, yhi)
    n = np.maximum(hi - lo + 1, 0)
    idx = np.repeat(np.arange(len(t)), n)
    y = np.repeat(lo, n) + (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n))
    x = (y - ty0[idx]).astype(np.float32) * dx[idx] + tx0[idx].astype(
        np.float32)
    # the corners: a vertex row of a sloped edge, its partner the first
    # earlier edge with a vertex on that row (nonzero slope, a crossing in
    # the same pixel, spanning the adjacent row)
    vertex = (dx != 0)[idx] & ((y == tymin[idx])
                               | ((y == tymax[idx]) & (y >= yhi)))
    at_row: dict[int, list[int]] = {}
    for k in np.nonzero(dx != 0)[0]:
        for r in {int(tymin[k]), int(tymax[k])}:
            at_row.setdefault(r, []).append(int(k))
    one = np.float32(1.0)
    for pos in np.nonzero(vertex)[0]:
        i, yy, xv = int(idx[pos]), int(y[pos]), x[pos]
        adj = yy - 1 if yy == tymax[i] else yy + 1
        for k in at_row.get(yy, ()):
            if k >= i:
                break
            if (_roundf(xv) != _roundf(cross(k, yy))
                    or not tymin[k] <= adj <= tymax[k]):
                continue
            a, b = cross(i, adj), cross(k, adj)
            if xv > a + one and xv > b + one:
                x[pos] = np.float32(_roundf(max(a, b)) + 1)
            elif a - one > xv and b - one > xv:
                x[pos] = np.float32(_roundf(min(a, b)) - 1)
            break
    twice = (y == tymax[idx]) & (y < yhi)
    y = np.concatenate([y, y[twice]])
    x = np.concatenate([x, x[twice]])
    order = np.lexsort((x, y))
    y, x = y[order], x[order]
    first = np.searchsorted(y, y)  # each row's first crossing
    rank = np.arange(len(y)) - first
    last = np.searchsorted(y, y, side="right") - 1
    pair = (rank % 2 == 0) & (np.arange(len(y)) < last)
    rows.append(y[pair])
    starts.append(_round_up(x[pair]))
    ends.append(_round_down(x[np.nonzero(pair)[0] + 1]))
    r, s, f = (np.concatenate(v) for v in (rows, starts, ends))
    # Pillow's hline8: rows outside the image and spans past either side
    # draw nothing; the rest are clipped to it
    keep = (r >= 0) & (r < h) & (s < w) & (f >= 0)
    r, s, f = r[keep], np.maximum(s[keep], 0), np.minimum(f[keep], w - 1)
    keep = s <= f
    r, s, f = r[keep], s[keep], f[keep]
    if len(r):
        diff = np.zeros((h, w + 1), np.int32)
        np.add.at(diff, (r, s), 1)
        np.add.at(diff, (r, f + 1), -1)
        out |= (np.cumsum(diff[:, :w], axis=1) > 0).astype(np.uint8)


def polygons_to_mask(polys: list[list[float]], h: int, w: int) -> np.ndarray:
    """Union of filled polygons (COCO ``[x0, y0, x1, y1, ...]`` rings) ->
    (h, w) u8, byte-equal to Pillow's ``ImageDraw.polygon(ring,
    outline=1, fill=1)``, which the JAX package draws with (the outline,
    the fill's own colour, is not drawn again; vertices cut to ints toward
    zero, as Pillow's C does); rings of fewer than 3 points are skipped."""
    out = np.zeros((h, w), np.uint8)
    for poly in polys:
        if len(poly) >= 6:
            pts = [(int(poly[i]), int(poly[i + 1]))
                   for i in range(0, len(poly) - 1, 2)]
            _fill_polygon(out, pts)
    return out


def segmentation_to_mask(seg, h: int, w: int) -> np.ndarray:
    """Any COCO ``segmentation`` value (polygons, RLE counts or a
    compressed RLE string) -> (h, w) u8 binary mask."""
    if isinstance(seg, dict):
        counts = seg["counts"]
        if isinstance(counts, (str, bytes)):
            counts = rle_decompress(counts)
        sh, sw = seg.get("size", (h, w))
        if (sh, sw) != (h, w):
            raise ValueError(f"RLE size {(sh, sw)} != image size {(h, w)}")
        return rle_to_mask(list(counts), h, w)
    return polygons_to_mask(seg, h, w)


def letterbox_masks_nearest(masks: np.ndarray, size: int) -> np.ndarray:
    """(M, oh, ow) -> (M, size, size), centre-convention nearest."""
    m, oh, ow = masks.shape
    vh, vw = letterbox_params(oh, ow, size)
    out = np.zeros((m, size, size), np.uint8)
    out[:, :vh, :vw] = masks[:, nearest_rows(oh, vh)[:, None],
                             nearest_rows(ow, vw)[None, :]]
    return out


class CocoDataset:
    """A COCO annotation file behind the ``Sample`` contract."""

    def __init__(self, root: str, image_size: int = 512,
                 max_instances: int = 8, split: str = "val",
                 decode_backend: str = "auto", ann_file: str = "",
                 include_crowd: bool = False):
        from basi_tpu_torch.data.native import get_decoder

        self.root = root
        self.size = image_size
        self.max_instances = max_instances
        self.include_crowd = include_crowd
        ann = ann_file or self._find_annotations(root, split)
        self.ann_path = ann  # part of the native-GT cache key
        with open(ann) as f:
            doc = json.load(f)

        by_image: dict[int, list[dict]] = {}
        for a in doc.get("annotations", []):
            if a.get("iscrowd", 0) and not include_crowd:
                continue
            if not a.get("segmentation"):
                continue
            by_image.setdefault(a["image_id"], []).append(a)

        # the image directory: the first candidate holding an annotated
        # image (an empty root/<split> must not shadow the real one)
        ann_suffix = os.path.splitext(os.path.basename(ann))[0]
        ann_suffix = ann_suffix.removeprefix("instances_")
        probe_names = {im["file_name"] for im in doc.get("images", [])
                       if im["id"] in by_image}
        cands = []
        for c in (split, ann_suffix, "images", ""):
            d = os.path.join(root, c) if c else root
            if os.path.isdir(d) and d not in cands:
                cands.append(d)

        def has_any(d: str) -> bool:
            try:
                return any(n in probe_names for n in os.listdir(d))
            except OSError:
                return False

        self.img_dir = next((d for d in cands if has_any(d)),
                            cands[0] if cands else root)
        # images on disk with instances, by file name (a stable order)
        self.images = sorted(
            (im for im in doc.get("images", [])
             if im["id"] in by_image
             and os.path.isfile(os.path.join(self.img_dir, im["file_name"]))),
            key=lambda im: im["file_name"])
        self.anns = by_image
        if by_image and not probe_names:
            raise ValueError(
                f"annotations reference {len(by_image)} image_ids but none "
                f"appear in the JSON's 'images' list ({ann!r} is "
                f"inconsistent)")
        if by_image and probe_names and not self.images:
            raise FileNotFoundError(
                f"annotations reference {len(by_image)} images but none "
                f"were found under any of {cands or [root]} "
                f"(root={root!r}, split={split!r})")
        self.decoder = get_decoder(decode_backend)

    @staticmethod
    def _find_annotations(root: str, split: str) -> str:
        """``root/annotations/instances_<split>[digits].json``, the first
        by name (anchored: ``val`` never picks ``minival``)."""
        ann_dir = os.path.join(root, "annotations")
        if os.path.isdir(ann_dir):
            def matches(f: str) -> bool:
                if not (f.startswith("instances_") and f.endswith(".json")):
                    return False
                stem = f[len("instances_"):-len(".json")]
                rest = stem[len(split):]
                return stem.startswith(split) and (not rest or rest.isdigit())
            cands = sorted(f for f in os.listdir(ann_dir) if matches(f))
            if cands:
                return os.path.join(ann_dir, cands[0])
        raise FileNotFoundError(
            f"no COCO annotations for split {split!r} under {ann_dir} "
            f"(set data.ann_file explicitly)")

    def __len__(self) -> int:
        return len(self.images)

    def _orig_masks(self, im: dict) -> tuple[np.ndarray, np.ndarray]:
        oh, ow = int(im["height"]), int(im["width"])
        anns = sorted(self.anns[im["id"]],
                      key=lambda a: -float(a.get("area", 0.0)))
        masks = np.zeros((self.max_instances, oh, ow), np.uint8)
        valid = np.zeros((self.max_instances,), np.uint8)
        count = 0
        for a in anns:  # empty masks are dropped before the cap
            if count == self.max_instances:
                break
            m = segmentation_to_mask(a["segmentation"], oh, ow)
            if not m.any():
                continue
            masks[count] = m
            valid[count] = 1
            count += 1
        return masks, valid

    def image_id(self, i: int) -> int:
        """The annotation file's own id of image ``i``."""
        return int(self.images[i]["id"])

    def _sample(self, im: dict, img: np.ndarray, hw) -> Sample:
        oh, ow = int(hw[0]), int(hw[1])
        if (oh, ow) != (int(im["height"]), int(im["width"])):
            raise ValueError(
                f"{im['file_name']}: file is {oh}x{ow} but the annotation "
                f"says {im['height']}x{im['width']}")
        masks_o, valid = self._orig_masks(im)
        return Sample(
            img, letterbox_masks_nearest(masks_o, self.size), valid,
            np.array([oh, ow], np.int32),
            np.array(letterbox_params(oh, ow, self.size), np.int32),
            name=os.path.splitext(im["file_name"])[0])

    def get(self, i: int) -> Sample:
        im = self.images[i]
        img, hw = self.decoder.decode_letterbox(
            os.path.join(self.img_dir, im["file_name"]), self.size)
        return self._sample(im, img, hw)

    def get_batch(self, indices) -> list[Sample]:
        """``get`` of each index; the images in one call of the decoder's
        thread pool."""
        ims = [self.images[int(i)] for i in indices]
        imgs, hws = self.decoder.decode_letterbox_batch(
            [os.path.join(self.img_dir, im["file_name"]) for im in ims],
            self.size)
        return [self._sample(im, imgs[si], hws[si])
                for si, im in enumerate(ims)]

    def get_orig_masks(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Native-resolution GT: (masks (M, oh, ow) u8, valid (M,) u8)."""
        return self._orig_masks(self.images[i])
