"""Disk cache of native-resolution GT for original-frame eval (port of
``basi_tpu/data/native_gt.py``; numpy only).

Original-frame eval matches pasted predictions against each val image's
GT at its original size. ``SyntheticDataset.get_orig_masks`` draws the
scene again for that; this cache does it once per dataset, bit-packs the
masks along W (``np.packbits``, as ``data.pack_masks``) into one
uncompressed ``.npz`` named by the dataset's identity, and then serves
``get_packed(i)`` from it. Packing is lossless for binary masks.

Two faults of the reference are fixed here: the file is written to a
temporary name unique to the writer and moved into place with
``os.replace``, so two processes may build the same cache at once; and the
key holds ``SyntheticDataset.SCENE_VERSION``, so GT drawn by an older scene
generator is never served. A folder dataset's key holds its mask files'
paths and modification times, a COCO dataset's its annotation file's path
and time and the assembly settings: the JAX package's keys, so an edited
mask or annotation file builds a new cache.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np


def dataset_cache_key(dataset) -> str | None:
    """Identity of a dataset's native GT, or None when it has none (then
    the cache keeps its entries in memory only)."""
    # by MRO name, so subclasses share their base's key
    names = [c.__name__ for c in type(dataset).__mro__]
    if "SyntheticDataset" in names:
        return json.dumps(["SyntheticDataset", dataset.SCENE_VERSION,
                           dataset.n, dataset.size, dataset.max_instances,
                           dataset.seed, dataset.orig_max_scale])
    if "CocoDataset" in names:
        ann = dataset.ann_path
        return json.dumps(["CocoDataset", dataset.size,
                           dataset.max_instances, dataset.include_crowd,
                           ann, _mtime(ann), len(dataset)])
    if "FolderDataset" in names:
        sig = [(p, _mtime(p)) for name in dataset.names
               for p in dataset._mask_jobs(os.path.splitext(name)[0])[1]]
        return json.dumps(["FolderDataset", dataset.size,
                           dataset.max_instances, sig])
    return None


def _mtime(path: str) -> float:
    """A file's modification time, -1 where it cannot be read."""
    try:
        return os.path.getmtime(path) if path else -1.0
    except OSError:
        return -1.0


def _write_atomic(path: str, write) -> None:
    """``write(file)`` into a temporary file beside ``path``, unique to
    this writer, then move it over ``path``."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class NativeGTCache:
    """Per-image bit-packed native GT, built once and read lazily.

    File: ``<dir>/native_gt_<sha1(key)[:16]>.npz`` (uncompressed, so
    ``np.load`` reads entries on demand) with ``m<i>`` (M, H, ceil(W/8))
    u8 and ``v<i>`` (M,) u8 per image and ``hw`` (n, 2) i32 native sizes,
    and a ``.json`` sidecar holding the whole key."""

    def __init__(self, dataset, cache_dir: str):
        self.dataset = dataset
        key = dataset_cache_key(dataset)
        self._npz = None
        self._mem: dict[int, tuple] = {}
        if key is None or not cache_dir:
            self.path = ""
            return
        digest = hashlib.sha1(key.encode()).hexdigest()[:16]
        os.makedirs(cache_dir, exist_ok=True)
        self.path = os.path.join(cache_dir, f"native_gt_{digest}.npz")
        meta = self.path + ".json"
        if os.path.isfile(self.path) and os.path.isfile(meta):
            with open(meta) as f:
                if f.read() == key:
                    self._npz = np.load(self.path)
                    return
        self._build(key)

    def _build(self, key: str) -> None:
        n = len(self.dataset)
        arrays: dict[str, np.ndarray] = {}
        hw = np.zeros((n, 2), np.int32)
        for i in range(n):
            masks, valid = self.dataset.get_orig_masks(i)
            hw[i] = masks.shape[1], masks.shape[2]
            arrays[f"m{i}"] = np.packbits(masks > 0, axis=-1)
            arrays[f"v{i}"] = np.asarray(valid, np.uint8)
        arrays["hw"] = hw
        _write_atomic(self.path, lambda f: np.savez(f, **arrays))
        _write_atomic(self.path + ".json", lambda f: f.write(key.encode()))
        self._npz = np.load(self.path)

    @property
    def on_disk(self) -> bool:
        """Whether the GT is served from the ``.npz`` (else it is drawn per
        image and kept in memory)."""
        return self._npz is not None

    def native_sizes(self) -> np.ndarray:
        """(n, 2) i32 native (H, W) of every image; ``on_disk`` only."""
        return self._npz["hw"]

    def get_packed(self, i: int):
        """(packed (M, H, ceil(W/8)) u8, valid (M,) u8, (oh, ow))."""
        if self._npz is not None:
            hw = self._npz["hw"][i]
            return (self._npz[f"m{i}"], self._npz[f"v{i}"],
                    (int(hw[0]), int(hw[1])))
        hit = self._mem.get(i)
        if hit is None:
            masks, valid = self.dataset.get_orig_masks(i)
            hit = (np.packbits(masks > 0, axis=-1),
                   np.asarray(valid, np.uint8),
                   (masks.shape[1], masks.shape[2]))
            self._mem[i] = hit
        return hit
