"""The port's COCO module against the JAX package's, on the CPU.

* The RLE codec (``rle_decompress``, ``rle_to_mask``, ``mask_to_counts``,
  ``rle_compress``, ``mask_to_rle``) on seeded random masks: counts and
  strings equal to JAX's, character for character.
* ``polygons_to_mask`` byte-equal to Pillow 12.1's
  ``ImageDraw.polygon(..., outline=1, fill=1)`` (what the JAX package
  calls) on 300 seeded polygons of six kinds (convex, concave,
  self-intersecting, sub-pixel, partly outside the image, degenerate), on
  multi-ring segmentations, on rings where edges meet at one vertex on one
  row, and on 200 seeded rings of 30 to 100 vertices at 480 x 640.
* The cases of ``tests/test_coco.py`` on the port's ``CocoDataset``, each
  also held equal to the JAX ``CocoDataset`` (samples, native GT, ids,
  image directory, errors), and the native-GT cache key equal to JAX's.
* ``evaluate(results_path=...)`` on a COCO tree exports the annotation
  file's own image ids and original-size RLE masks.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import json
import os

import numpy as np
import pytest
from PIL import Image, ImageDraw

from basi_tpu.data import coco as JC
from basi_tpu.data import native_gt as JNG
from basi_tpu_torch.data import coco as C
from basi_tpu_torch.data import datasets as D
from basi_tpu_torch.data import native_gt as NG

import test_coco


# --- RLE ----------------------------------------------------------------------

def _random_masks(seed: int, n: int = 30):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        h, w = rng.randint(1, 50, size=2)
        yield (rng.rand(h, w) > rng.rand()).astype(np.uint8)
    yield np.zeros((3, 4), np.uint8)
    yield np.ones((5, 2), np.uint8)
    yield np.eye(6, dtype=np.uint8)


def test_rle_codec_matches_jax():
    for m in _random_masks(11):
        counts = C.mask_to_counts(m)
        assert counts == JC.mask_to_counts(m)
        s = C.rle_compress(counts)
        assert s == JC.rle_compress(counts)
        assert C.mask_to_rle(m) == JC.mask_to_rle(m)
        assert C.rle_decompress(s) == JC.rle_decompress(s) == counts
        assert C.rle_decompress(s.encode()) == counts
        got = C.rle_to_mask(counts, *m.shape)
        np.testing.assert_array_equal(got, JC.rle_to_mask(counts, *m.shape))
        np.testing.assert_array_equal(got, m)


def test_rle_matches_the_test_twins():
    """The naive encoders of ``tests/test_coco.py``."""
    for m in _random_masks(12, n=10):
        counts = test_coco._mask_to_counts(m)
        assert C.mask_to_counts(m) == counts
        assert C.rle_compress(counts) == test_coco._compress(counts)
        np.testing.assert_array_equal(C.rle_to_mask(counts, *m.shape), m)


def test_rle_to_mask_refuses_a_wrong_size():
    with pytest.raises(ValueError, match="covers"):
        C.rle_to_mask([3, 4], 3, 3)
    with pytest.raises(ValueError, match="size"):
        C.segmentation_to_mask({"size": [2, 2], "counts": [4]}, 4, 4)
    m = C.segmentation_to_mask({"size": [4, 4], "counts": [3, 1, 12]}, 4, 4)
    assert m.sum() == 1 and m[3, 0] == 1


# --- the polygon fill -----------------------------------------------------------

def _pil_fill(polys, h, w):
    im = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(im)
    for poly in polys:
        if len(poly) >= 6:
            draw.polygon([(poly[i], poly[i + 1])
                          for i in range(0, len(poly) - 1, 2)],
                         outline=1, fill=1)
    return np.asarray(im, np.uint8)


def _polygon(kind: str, rng, h: int, w: int) -> list[float]:
    k = rng.randint(3, 10)
    if kind == "convex":
        ang = np.sort(rng.rand(k)) * 2 * np.pi
        r = (0.2 + 0.3 * rng.rand()) * min(h, w)
        pts = np.stack([w / 2 + r * np.cos(ang), h / 2 + r * np.sin(ang)], 1)
    elif kind == "concave":
        ang = np.sort(rng.rand(k + 3)) * 2 * np.pi
        r = (0.1 + 0.4 * rng.rand(k + 3)) * min(h, w)
        pts = np.stack([w / 2 + r * np.cos(ang), h / 2 + r * np.sin(ang)], 1)
    elif kind == "self_intersecting":
        pts = rng.rand(k + 2, 2) * [w, h]
    elif kind == "sub_pixel":
        pts = rng.rand(k, 2) * 2.5 + rng.rand(2) * [w - 3, h - 3]
    elif kind == "outside":
        pts = rng.rand(k, 2) * [w * 1.8, h * 1.8] - [w * 0.4, h * 0.4]
    else:  # degenerate: collinear, repeated, or a spike out and back
        x0, y0 = rng.rand(2) * [w, h]
        dx, dy = rng.randn(2) * 6
        choice = rng.randint(3)
        if choice == 0:
            pts = np.array([[x0 + t * dx, y0 + t * dy] for t in range(k)])
        elif choice == 1:
            pts = np.array([[x0, y0]] * 2 + [[x0 + dx, y0 + dy]] * 2)
        else:
            pts = np.array([[x0, y0], [x0 + dx, y0 + dy], [x0, y0],
                            [x0 - dy, y0 + dx]])
    return [float(v) for v in pts.reshape(-1)]


KINDS = ["convex", "concave", "self_intersecting", "sub_pixel", "outside",
         "degenerate"]


@pytest.mark.parametrize("kind", KINDS)
def test_polygon_fill_matches_pillow(kind):
    """50 polygons of each kind on canvases of 5 to 60 px."""
    rng = np.random.RandomState(KINDS.index(kind))
    for n in range(50):
        h, w = rng.randint(5, 61, size=2)
        poly = _polygon(kind, rng, h, w)
        want = _pil_fill([poly], h, w)
        got = C.polygons_to_mask([poly], h, w)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{n}: {poly}")


def test_multi_ring_segmentations_match_pillow_and_jax():
    rng = np.random.RandomState(9)
    for _ in range(20):
        h, w = rng.randint(8, 50, size=2)
        polys = [_polygon(KINDS[rng.randint(6)], rng, h, w)
                 for _ in range(rng.randint(1, 4))]
        polys.append([1.0, 2.0, 3.0, 4.0])  # under 3 points: skipped
        want = _pil_fill(polys, h, w)
        np.testing.assert_array_equal(C.polygons_to_mask(polys, h, w), want)
        np.testing.assert_array_equal(C.segmentation_to_mask(polys, h, w),
                                      JC.segmentation_to_mask(polys, h, w))
    sq = C.polygons_to_mask([[2, 2, 6, 2, 6, 6, 2, 6]], 10, 10)
    np.testing.assert_array_equal(
        sq, JC.polygons_to_mask([[2, 2, 6, 2, 6, 6, 2, 6]], 10, 10))
    assert sq[2:7, 2:7].all() and sq.sum() == 25


# Rings where edges meet at one vertex on one row: a vertex crossing that
# float32 puts a hair off its pixel (4.9999924), spikes out and back,
# several corners on one row, rings crossing the top and bottom edges
CORNER_CASES = [
    ([89, 205, 5, 166, 37, 176], 480, 640),
    ([78, 149, 24, 130, 37, 133], 480, 640),
    ([579, 66, 580, 63, 584, 64, 580, 63, 580, 62, 598, 62, 598, 70],
     480, 640),
    ([5, 6, 3, 7, 5, 6, 7, -4, 11, -2, 6, 3], 9, 8),
    ([8, 4, 7, 3, 14, 13, 20, 11, 19, 13, -1, 8, 19, 13, 4, -2, 10, 3],
     14, 26),
    ([13, 16, 27, 13, 6, 1, 1, 4, 4, 4, 12, -1, 28, 8, 13, 16, 0, 12, 5,
      12], 18, 28),
    ([2, 11, 12, 8, 10, 7, 4, 8, 10, 7, 0, 6, 7, 12, 2, 10, 9, 10, -1, 14,
      11, 16], 15, 13),
    ([1, 5, 4, 4, -1, -2, -1, 10, 0, 10, 4, 4], 9, 9),
]


@pytest.mark.parametrize("case", range(len(CORNER_CASES)))
def test_polygon_fill_corners_match_pillow(case):
    poly, h, w = CORNER_CASES[case]
    poly = [float(v) for v in poly]
    np.testing.assert_array_equal(C.polygons_to_mask([poly], h, w),
                                  _pil_fill([poly], h, w))


def _coco_ring(kind: str, rng, h: int, w: int) -> list[float]:
    """A ring as COCO annotators draw them: 30 to 100 vertices around an
    object (``blob``: angle-sorted, radius jittered) or along a traced
    outline (``trace``: steps of a few pixels that often fall on one row,
    turn back, or repeat a vertex), partly outside the image at times."""
    k = rng.randint(30, 101)
    if kind == "blob":
        c = rng.rand(2) * [w, h]
        ang = np.sort(rng.rand(k)) * 2 * np.pi
        r = rng.uniform(10, 300) * rng.uniform(0.5, 1.0, k)
        pts = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)
    else:
        steps = rng.randint(-4, 5, size=(k, 2)) * rng.rand(k, 1).round()
        pts = rng.rand(2) * [w, h] + np.cumsum(steps + rng.rand(k, 2), 0)
    pts = np.clip(pts, [-20, -20], [w + 20, h + 20])
    return [float(v) for v in pts.reshape(-1)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["blob", "trace"])
def test_polygon_fill_matches_pillow_at_coco_scale(kind, seed):
    """50 rings of 30 to 100 vertices on a 480 x 640 canvas, each alone
    and all 50 as one multi-ring segmentation."""
    rng = np.random.RandomState(100 + 2 * seed + (kind == "trace"))
    rings = [_coco_ring(kind, rng, 480, 640) for _ in range(50)]
    for n, ring in enumerate(rings):
        np.testing.assert_array_equal(C.polygons_to_mask([ring], 480, 640),
                                      _pil_fill([ring], 480, 640),
                                      err_msg=f"{n}: {ring}")
    np.testing.assert_array_equal(C.polygons_to_mask(rings, 480, 640),
                                  _pil_fill(rings, 480, 640))


# --- CocoDataset ------------------------------------------------------------------

def _assert_samples_equal(a, b):
    for f in ("image", "masks", "valid", "orig_hw", "valid_hw"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.name == b.name


def _both(root, **kw):
    return (C.CocoDataset(root, **kw),
            JC.CocoDataset(root, decode_backend="native", **kw))


def _assert_datasets_equal(got, want):
    assert len(got) == len(want)
    assert got.img_dir == want.img_dir
    for i in range(len(got)):
        _assert_samples_equal(got.get(i), want.get(i))
        assert got.image_id(i) == want.image_id(i)
        for x, y in zip(got.get_orig_masks(i), want.get_orig_masks(i)):
            np.testing.assert_array_equal(x, y)
    idx = list(range(len(got)))[::-1]
    for a, b in zip(got.get_batch(idx), want.get_batch(idx)):
        _assert_samples_equal(a, b)
    assert NG.dataset_cache_key(got) == JNG.dataset_cache_key(want)


@pytest.mark.parametrize("include_crowd", [False, True])
def test_coco_dataset_matches_jax(tmp_path, include_crowd):
    """``tests/test_coco.py``'s tree (polygon, RLE counts, a compressed
    crowd RLE, a non-square image) on both packages."""
    root = str(tmp_path / "coco")
    os.makedirs(root)
    test_coco._write_coco_tree(root)
    got, want = _both(root, image_size=64, max_instances=4, split="val",
                      include_crowd=include_crowd)
    _assert_datasets_equal(got, want)
    s = got.get(0)
    np.testing.assert_array_equal(
        s.valid, [1, 1, 1, 0] if include_crowd else [1, 1, 0, 0])
    np.testing.assert_array_equal(s.orig_hw, [40, 64])
    assert got.get_orig_masks(0)[0][1].sum() == 9


def test_coco_via_make_dataset_and_the_ann_file(tmp_path):
    root = str(tmp_path / "coco")
    os.makedirs(root)
    test_coco._write_coco_tree(root)
    from basi_tpu_torch.config import get_config

    cfg = get_config("", ["data.dataset=coco", f"data.root={root}",
                          "data.image_size=64", "model.image_size=64",
                          "data.max_instances=4"])
    ds = D.make_dataset(cfg.data, split="val")
    assert type(ds).__name__ == "CocoDataset" and len(ds) == 2
    batches = list(D.iter_epoch(ds, 2, shuffle=False, seed=0))
    assert batches[0]["image"].shape == (2, 64, 64, 3)
    # an explicit annotation file, under another name
    ann = os.path.join(root, "annotations", "instances_val.json")
    os.rename(ann, os.path.join(root, "mine.json"))
    cfg = get_config("", ["data.dataset=coco", f"data.root={root}",
                          f"data.ann_file={root}/mine.json",
                          "data.image_size=64", "model.image_size=64",
                          "data.max_instances=4"])
    got = D.make_dataset(cfg.data, split="val")
    want = JC.CocoDataset(root, image_size=64, max_instances=4, split="val",
                          decode_backend="native",
                          ann_file=f"{root}/mine.json")
    _assert_datasets_equal(got, want)


def _write_layout(root, img_dir, ann_name, doc, seed=0, hw=(32, 32)):
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    if img_dir:
        os.makedirs(os.path.join(root, img_dir), exist_ok=True)
        rng = np.random.RandomState(seed)
        Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8)).save(
            os.path.join(root, img_dir, "im1.jpg"), quality=95)
    with open(os.path.join(root, "annotations", ann_name), "w") as f:
        json.dump(doc, f)


def _doc(segs, hw=(32, 32), areas=None):
    return {"images": [{"id": 1, "file_name": "im1.jpg", "height": hw[0],
                        "width": hw[1]}],
            "annotations": [{"id": i + 1, "image_id": 1, "iscrowd": 0,
                             "area": (areas or [64.0] * len(segs))[i],
                             "segmentation": s} for i, s in enumerate(segs)]}


def test_coco_year_layout_and_anchored_annotation_names(tmp_path):
    root = str(tmp_path / "coco17")
    _write_layout(root, "val2017", "instances_val2017.json",
                  _doc([[[4, 4, 20, 4, 20, 12, 4, 12]]]))
    with open(os.path.join(root, "annotations",
                           "instances_minival.json"), "w") as f:
        json.dump({"images": [], "annotations": []}, f)
    got, want = _both(root, image_size=32, max_instances=2, split="val")
    _assert_datasets_equal(got, want)
    assert got.ann_path.endswith("instances_val2017.json")
    assert got.get(0).valid.sum() == 1


def test_coco_empty_split_dir_does_not_shadow_the_year_dir(tmp_path):
    root = str(tmp_path / "coco17b")
    os.makedirs(os.path.join(root, "val"))
    _write_layout(root, "val2017", "instances_val2017.json",
                  _doc([[[2, 2, 12, 2, 12, 8, 2, 8]]], hw=(24, 24)), seed=2,
                  hw=(24, 24))
    got, want = _both(root, image_size=32, max_instances=2, split="val")
    _assert_datasets_equal(got, want)
    assert got.img_dir.endswith("val2017")


def test_coco_degenerate_annotation_does_not_evict_a_real_one(tmp_path):
    root = str(tmp_path / "coco_degen")
    _write_layout(root, "val", "instances_val.json", _doc(
        [[[1, 1, 2, 2]], [[2, 2, 14, 2, 14, 14, 2, 14]],
         [[18, 18, 28, 18, 28, 28, 18, 28]],
         [[5, 5, 9, 9, 13, 13]]],  # collinear: an outline, not empty
        areas=[1e9, 100.0, 50.0, 1e8]), seed=1)
    got, want = _both(root, image_size=32, max_instances=2, split="val")
    _assert_datasets_equal(got, want)
    masks, valid = got.get_orig_masks(0)
    assert valid.sum() == 2 and masks[0].sum() > 0 and masks[1].sum() > 0


@pytest.mark.parametrize("case", ["missing", "wrong_dir", "inconsistent"])
def test_coco_refusals_match_jax(tmp_path, case):
    root = str(tmp_path / case)
    if case == "missing":
        os.makedirs(os.path.join(root, "annotations"))
        err, match = FileNotFoundError, "ann"
    elif case == "wrong_dir":
        doc = _doc([[[1, 1, 5, 1, 5, 5, 1, 5]]], hw=(8, 8))
        doc["images"][0]["file_name"] = "nope.jpg"
        _write_layout(root, "", "instances_val.json", doc)
        err, match = FileNotFoundError, "none"
    else:
        doc = _doc([[[1, 1, 5, 1, 5, 5, 1, 5]]], hw=(8, 8))
        doc["annotations"][0]["image_id"] = 99
        _write_layout(root, "", "instances_val.json", doc)
        err, match = ValueError, "inconsistent"
    with pytest.raises(err, match=match):
        C.CocoDataset(root, image_size=32, split="val")
    with pytest.raises(err, match=match):
        JC.CocoDataset(root, image_size=32, split="val")


def test_coco_size_mismatch_raises(tmp_path):
    """An image whose file size is not the annotation's raises, as JAX's."""
    root = str(tmp_path / "coco_size")
    _write_layout(root, "val", "instances_val.json",
                  _doc([[[2, 2, 12, 2, 12, 8, 2, 8]]], hw=(24, 30)))
    got, want = _both(root, image_size=32, split="val")
    for ds in (got, want):
        with pytest.raises(ValueError, match="annotation says"):
            ds.get(0)
        with pytest.raises(ValueError, match="annotation says"):
            ds.get_batch([0])


def test_eval_results_export_uses_true_coco_ids(tmp_path):
    """``evaluate(results_path=...)`` on a COCO tree: the annotation file's
    own ids, RLE masks at each image's original size, non-empty."""
    import dataclasses

    from basi_tpu_torch.infer import Inferencer
    from helpers import tiny_config

    root = str(tmp_path / "coco")
    os.makedirs(root)
    test_coco._write_coco_tree(root)
    cfg = tiny_config(batch_size=2)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, dataset="coco", root=root,
                                      split="val"),
        infer=dataclasses.replace(cfg.infer, score_threshold=0.0))
    res = tmp_path / "r.json"
    metrics = Inferencer(cfg, device="cpu", seed=1).evaluate(
        results_path=str(res))
    entries = json.loads(res.read_text())
    assert metrics["num_results"] == len(entries) > 0
    sizes = {1: [40, 64], 2: [32, 32]}
    assert {e["image_id"] for e in entries} <= set(sizes)
    for e in entries:
        assert e["segmentation"]["size"] == sizes[e["image_id"]]
        m = C.rle_to_mask(C.rle_decompress(e["segmentation"]["counts"]),
                          *e["segmentation"]["size"])
        assert m.any()
