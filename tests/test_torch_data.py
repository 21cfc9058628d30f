"""The port's data path without PIL, held against Pillow and the JAX package.

* ``basi_tpu_torch.data.letterbox.resize_bilinear_u8`` equals Pillow's
  ``Image.resize(..., BILINEAR)`` byte for byte (``assert_array_equal``,
  no tolerance: a weight rounded the other way, or no uint8 clip between
  the passes, moves a few percent of pixels by 1): on the first 16 train
  and val scenes of ``bench_accuracy`` at their letterbox sizes, on edge
  shapes, and on a hypothesis sweep of shapes up and down.
* ``basi_tpu_torch.data.shards`` (every case of ``tests/test_shards.py``
  but the CLI one, on the port): lossless round trip, ``get_batch``,
  ``iter_epoch`` over shards equal to over the source, geometry and
  truncation checks, no ``get_orig_masks``, ``make_dataset``'s shards
  branch; and the two packages' ``pack_dataset`` write byte-identical
  files, each package reading the other's.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from basi_tpu.data import datasets as jax_datasets
from basi_tpu.data import shards as jax_shards
from basi_tpu_torch.config import get_config
from basi_tpu_torch.data import datasets as D
from basi_tpu_torch.data.letterbox import resize_bilinear_u8
from basi_tpu_torch.data.shards import ShardDataset, pack_dataset

from test_torch_port import _assert_samples_equal


def _pil(img: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))


# --- the letterbox ------------------------------------------------------------

@pytest.mark.parametrize("split", ["train", "val"])
def test_letterbox_matches_pil_on_bench_accuracy_scenes(split):
    """The scenes ``bench_accuracy`` letterboxes (scale 1.5: originals up
    to 768 on a side, down to 512 on the longer one)."""
    cfg = get_config("bench_accuracy")
    ds = D.make_dataset(cfg.data, split=split)
    assert ds.orig_max_scale == 1.5
    for i in range(16):
        oh, ow = ds._dims(i)
        img, _, _ = ds._scene(i, oh, ow)
        vh, vw = D.letterbox_params(oh, ow, ds.size)
        assert max(vh, vw) == 512 and (oh, ow) != (vh, vw)
        np.testing.assert_array_equal(resize_bilinear_u8(img, vh, vw),
                                      _pil(img, vh, vw), err_msg=f"{i}")


@pytest.mark.parametrize("hw,out", [
    ((1, 1), (5, 3)), ((7, 1), (1, 9)), ((3, 500), (2, 211)),
    ((768, 513), (512, 342)), ((100, 100), (371, 29)), ((64, 48), (64, 17)),
])
def test_letterbox_matches_pil_at_edge_shapes(hw, out):
    rng = np.random.RandomState(sum(hw) + sum(out))
    for shape in (hw + (3,), hw):  # RGB and one channel
        img = rng.randint(0, 256, size=shape).astype(np.uint8)
        np.testing.assert_array_equal(resize_bilinear_u8(img, *out),
                                      _pil(img, *out))


@settings(max_examples=80, deadline=None, derandomize=True, database=None)
@given(h=st.integers(1, 300), w=st.integers(1, 300),
       oh=st.integers(1, 300), ow=st.integers(1, 300),
       seed=st.integers(0, 2 ** 31 - 1))
def test_letterbox_matches_pil_on_a_sweep(h, w, oh, ow, seed):
    img = np.random.RandomState(seed).randint(
        0, 256, size=(h, w, 3)).astype(np.uint8)
    np.testing.assert_array_equal(resize_bilinear_u8(img, oh, ow),
                                  _pil(img, oh, ow))


def test_letterbox_refuses_other_inputs():
    with pytest.raises(ValueError, match="uint8"):
        resize_bilinear_u8(np.zeros((4, 4, 3), np.float32), 2, 2)
    with pytest.raises(ValueError, match="positive"):
        resize_bilinear_u8(np.zeros((4, 4, 3), np.uint8), 0, 2)


# --- shards -------------------------------------------------------------------

def _source(n=10, size=64, m=4, orig_max_scale=1.6, port=True):
    mod = D if port else jax_datasets
    return mod.SyntheticDataset(n=n, image_size=size, max_instances=m, seed=3,
                                orig_max_scale=orig_max_scale)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """The same scenes packed by both packages (3 shards of up to 4)."""
    root = tmp_path_factory.mktemp("shards")
    out, jax_out = str(root / "port"), str(root / "jax")
    pack_dataset(_source(), out, shard_size=4, batch_size=3, log=None)
    jax_shards.pack_dataset(_source(port=False), jax_out, shard_size=4,
                            batch_size=3, log=None)
    return _source(), out, jax_out


def test_roundtrip_lossless(packed):
    src, out, _ = packed
    ds = ShardDataset(out)
    assert len(ds) == len(src)
    assert len(json.load(open(os.path.join(out, "index.json")))["shards"]) == 3
    for i in range(len(src)):
        _assert_samples_equal(ds.get(i), src.get(i))
        assert ds.image_id(i) == src.image_id(i)


def test_packages_write_identical_shards_and_read_each_other(packed):
    src, out, jax_out = packed
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(jax_out))
    assert names == ["index.json", "shard-00000.bin", "shard-00001.bin",
                     "shard-00002.bin"]
    for name in names:
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(jax_out, name), "rb") as b:
            assert a.read() == b.read(), name
    port_reads_jax = ShardDataset(jax_out)
    jax_reads_port = jax_shards.ShardDataset(out)
    for i in range(len(src)):
        _assert_samples_equal(port_reads_jax.get(i), src.get(i))
        _assert_samples_equal(jax_reads_port.get(i), src.get(i))


def test_get_batch_matches_get(packed):
    _, out, _ = packed
    ds = ShardDataset(out)
    idx = [7, 0, 3, 7]  # out of order, repeated, across shard boundaries
    for got, i in zip(ds.get_batch(idx), idx):
        _assert_samples_equal(got, ds.get(i))


def test_iter_epoch_over_shards_equals_over_the_source(packed):
    src, out, _ = packed
    ds = ShardDataset(out)
    for kw in (dict(batch_size=4, shuffle=True, seed=5),
               dict(batch_size=3, shuffle=True, seed=6, skip=1),
               dict(batch_size=4, shuffle=False, seed=0, drop_last=False)):
        a = list(D.iter_epoch(src, **kw))
        b = list(D.iter_epoch(ds, **kw))
        assert len(a) == len(b) > 0
        for ba, bb in zip(a, b):
            assert set(ba) == set(bb)
            for k in ba:
                np.testing.assert_array_equal(ba[k], bb[k], err_msg=k)


def test_geometry_validation(packed):
    _, out, _ = packed
    with pytest.raises(ValueError, match="image_size"):
        ShardDataset(out, image_size=128)
    with pytest.raises(ValueError, match="max_instances"):
        ShardDataset(out, max_instances=8)
    ShardDataset(out, image_size=64, max_instances=4)


def test_truncation_detected(packed, tmp_path):
    _, out, _ = packed
    bad = tmp_path / "bad"
    shutil.copytree(out, bad)
    shard = bad / "shard-00001.bin"
    shard.write_bytes(shard.read_bytes()[:-1])
    ds = ShardDataset(str(bad))
    ds.get(0)  # shard 0 untouched
    with pytest.raises(ValueError, match="truncated"):
        ds.get(5)


def test_not_a_shard_dir(tmp_path):
    with pytest.raises(FileNotFoundError, match="basi pack"):
        ShardDataset(str(tmp_path))
    (tmp_path / "index.json").write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="unsupported shard format"):
        ShardDataset(str(tmp_path))


def test_orig_masks_refuses(packed):
    _, out, _ = packed
    with pytest.raises(ValueError, match="ap_at_original"):
        ShardDataset(out).get_orig_masks(0)


def test_make_dataset_wiring(packed, tmp_path):
    _, out, _ = packed
    cfg = get_config("", ["data.dataset=shards", f"data.root={out}",
                          "data.image_size=64", "model.image_size=64",
                          "data.max_instances=4"])
    ds = D.make_dataset(cfg.data, split="train")  # no split dir: the root
    assert isinstance(ds, ShardDataset) and len(ds) == 10
    os.symlink(out, tmp_path / "val")  # a split directory wins
    dcfg = dataclasses.replace(cfg.data, root=str(tmp_path))
    assert len(D.make_dataset(dcfg, split="val")) == 10
    with pytest.raises(FileNotFoundError):
        D.make_dataset(dcfg, split="train")
