"""Packed shards: decode or draw a dataset once, then train from fixed-size
records at memcpy speed (the port's copy of ``basi_tpu/data/shards.py``,
numpy only).

Format ``basi-shard-v1``, the JAX package's byte for byte, so that shards
packed by either package read in the other: ``index.json`` holds the
geometry (image_size S, max_instances M), the record count, each sample's
name and image id, and the shard file list; every record is
``S*S*3 + M*S*S/8 + M + 16`` bytes (the letterboxed uint8 image, the masks
``np.packbits``-ed over the flattened (M, S, S) block, valid, then
``orig_hw`` and ``valid_hw`` as little-endian int32), so offsets are
computed, not stored.
"""

from __future__ import annotations

import json
import os

import numpy as np

from basi_tpu_torch.data.datasets import Sample

FORMAT = "basi-shard-v1"


def _record_size(size: int, m: int) -> int:
    if (m * size * size) % 8:
        raise ValueError(f"M*S*S = {m}*{size}*{size} is not a whole number "
                         "of bytes")
    return size * size * 3 + (m * size * size) // 8 + m + 16


def pack_dataset(dataset, out_dir: str, shard_size: int = 1024,
                 batch_size: int = 32, log=print) -> dict:
    """Write ``dataset`` (``get``/``get_batch`` and ``__len__``) as packed
    shards under ``out_dir``; ``index.json`` is written last, to a
    temporary name moved into place. Returns the index."""
    n = len(dataset)
    if n == 0:
        raise ValueError("refusing to pack an empty dataset")
    probe = dataset.get(0)
    size = int(probe.image.shape[0])
    m = int(probe.masks.shape[0])
    rec = _record_size(size, m)
    os.makedirs(out_dir, exist_ok=True)

    names: list[str] = []
    image_ids: list = []
    shards: list[str] = []
    written = 0
    fh = None
    try:
        for start in range(0, n, batch_size):
            idx = np.arange(start, min(start + batch_size, n))
            if hasattr(dataset, "get_batch"):
                samples = dataset.get_batch(idx)
            else:
                samples = [dataset.get(int(i)) for i in idx]
            for i, s in zip(idx, samples):
                if written % shard_size == 0:
                    if fh is not None:
                        fh.close()
                    fname = f"shard-{len(shards):05d}.bin"
                    shards.append(fname)
                    fh = open(os.path.join(out_dir, fname), "wb")
                if s.image.shape != (size, size, 3) or s.masks.shape[0] != m:
                    raise ValueError(
                        f"sample {i}: shape {s.image.shape}/{s.masks.shape} "
                        f"does not match probe ({size}, {size}, 3)/({m}, ...)")
                fh.write(np.ascontiguousarray(s.image, np.uint8).tobytes())
                # 0/1 by the dataset contract; binarized so that unpackbits
                # is the exact inverse
                fh.write(np.packbits(
                    (np.asarray(s.masks) > 0).astype(np.uint8)).tobytes())
                fh.write(np.asarray(s.valid, np.uint8).tobytes())
                fh.write(np.asarray(s.orig_hw, "<i4").tobytes())
                fh.write(np.asarray(s.valid_hw, "<i4").tobytes())
                names.append(s.name)
                image_ids.append(
                    dataset.image_id(int(i)) if hasattr(dataset, "image_id")
                    else int(i))
                written += 1
            if log and (start // batch_size) % 16 == 0:
                log(f"pack: {written}/{n}")
    finally:
        if fh is not None:
            fh.close()

    index = {
        "format": FORMAT,
        "image_size": size,
        "max_instances": m,
        "n": written,
        "shard_size": shard_size,
        "record_size": rec,
        "shards": shards,
        "names": names,
        "image_ids": image_ids,
    }
    tmp = os.path.join(out_dir, "index.json.tmp")
    with open(tmp, "w") as f:
        json.dump(index, f)
    os.replace(tmp, os.path.join(out_dir, "index.json"))
    if log:
        log(f"pack: {written} records, {len(shards)} shard(s), "
            f"{rec} B/record -> {out_dir}")
    return index


class ShardDataset:
    """mmap reader of ``pack_dataset`` output: ``get``, ``get_batch``,
    ``image_id`` and ``__len__`` as the other datasets. Each ``get`` copies
    its record's fields out of the map, so what the feed pins is never a
    page-cache-backed view. Native-resolution GT is not stored, so
    ``get_orig_masks`` refuses: an original-frame eval needs the source
    dataset."""

    def __init__(self, root: str, image_size: int | None = None,
                 max_instances: int | None = None):
        path = os.path.join(root, "index.json")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{root!r} is not a shard dir (no index.json — build one "
                f"with `basi pack` or data.shards.pack_dataset)")
        with open(path) as f:
            self.index = json.load(f)
        if self.index.get("format") != FORMAT:
            raise ValueError(
                f"unsupported shard format {self.index.get('format')!r} "
                f"(want {FORMAT})")
        self.root = root
        self.size = int(self.index["image_size"])
        self.m = int(self.index["max_instances"])
        # a silent mismatch would train at the wrong resolution
        if image_size is not None and image_size != self.size:
            raise ValueError(
                f"shards were packed at image_size={self.size}, config "
                f"wants {image_size}: re-pack or fix data.image_size")
        if max_instances is not None and max_instances != self.m:
            raise ValueError(
                f"shards were packed with max_instances={self.m}, config "
                f"wants {max_instances}: re-pack or fix data.max_instances")
        self.n = int(self.index["n"])
        self.shard_size = int(self.index["shard_size"])
        self.rec = _record_size(self.size, self.m)
        if self.index.get("record_size", self.rec) != self.rec:
            raise ValueError("index record_size disagrees with geometry")
        self._maps: list[np.memmap | None] = [None] * len(self.index["shards"])
        s, m = self.size, self.m  # byte offsets of a record's fields
        self._o_masks = s * s * 3
        self._o_valid = self._o_masks + (m * s * s) // 8
        self._o_ohw = self._o_valid + m
        self._o_vhw = self._o_ohw + 8

    def __len__(self) -> int:
        return self.n

    def image_id(self, i: int):
        return self.index["image_ids"][i]

    def _mmap(self, shard: int) -> np.memmap:
        mp = self._maps[shard]
        if mp is None:
            fname = os.path.join(self.root, self.index["shards"][shard])
            n_here = min(self.shard_size, self.n - shard * self.shard_size)
            expect = n_here * self.rec
            actual = os.path.getsize(fname)
            if actual != expect:
                raise ValueError(
                    f"shard {fname} is {actual} B, index implies {expect} B "
                    f"— truncated or stale index")
            mp = self._maps[shard] = np.memmap(fname, np.uint8, "r")
        return mp

    def _record(self, i: int) -> np.ndarray:
        if not 0 <= i < self.n:
            raise IndexError(i)
        shard, off = divmod(i, self.shard_size)
        return self._mmap(shard)[off * self.rec:(off + 1) * self.rec]

    def get(self, i: int) -> Sample:
        raw = self._record(int(i))
        s, m = self.size, self.m
        image = np.array(raw[:self._o_masks]).reshape(s, s, 3)
        masks = np.unpackbits(
            np.array(raw[self._o_masks:self._o_valid])).reshape(m, s, s)
        valid = np.array(raw[self._o_valid:self._o_ohw])
        orig_hw = np.frombuffer(raw[self._o_ohw:self._o_vhw].tobytes(),
                                "<i4").astype(np.int32)
        valid_hw = np.frombuffer(raw[self._o_vhw:self.rec].tobytes(),
                                 "<i4").astype(np.int32)
        return Sample(image, masks, valid, orig_hw, valid_hw,
                      name=self.index["names"][int(i)])

    def get_batch(self, indices) -> list[Sample]:
        return [self.get(int(i)) for i in indices]

    def get_orig_masks(self, i: int):
        raise ValueError(
            "shard datasets store letterboxed GT only; "
            "infer.ap_at_original needs native-resolution masks — point "
            "data.root/data.dataset at the source dataset for that run")
