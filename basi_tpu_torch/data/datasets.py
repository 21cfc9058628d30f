"""Synthetic scenes and host batch assembly (the port's copy of the part of
``basi_tpu/data/datasets.py`` that training uses).

``SyntheticDataset`` draws the same procedural blob scenes as the JAX
package for the same (seed, index), ``iter_epoch`` assembles the same
batches in the same shuffled order, and ``make_dataset`` builds the
synthetic set from a ``DataConfig``; the on-disk datasets (ILSO/SOC
folders, COCO, shards) raise ``NotImplementedError``. numpy only; PIL is
imported only to letterbox non-square scenes (``synthetic_orig_scale > 1``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class Sample:
    image: np.ndarray  # (H, W, 3) uint8, letterboxed to model size
    masks: np.ndarray  # (M, H, W) uint8 0/1, letterboxed, padded to M slots
    valid: np.ndarray  # (M,) uint8
    orig_hw: np.ndarray  # (2,) int32 original image size
    valid_hw: np.ndarray  # (2,) int32 content size inside the letterbox
    name: str = ""


def letterbox_params(orig_h: int, orig_w: int, size: int) -> tuple[int, int]:
    """Content size after aspect-preserving resize into a size x size box,
    rounding half away from zero (``int(x + 0.5)``)."""
    scale = size / max(orig_h, orig_w)
    return (max(1, int(orig_h * scale + 0.5)),
            max(1, int(orig_w * scale + 0.5)))


class SyntheticDataset:
    """Procedural blob scenes with per-instance masks, deterministic per
    (seed, index). ``orig_max_scale > 1``: each scene is drawn at a
    non-square original size up to that multiple of ``image_size`` and
    letterboxed down (bilinear image, centre-convention nearest masks,
    top-left zero pad)."""

    # Version of the scene generator (``_dims``, ``_scene``): part of the
    # native-GT cache key, so raise it whenever the scenes change.
    SCENE_VERSION = 1

    def __init__(self, n: int = 256, image_size: int = 512,
                 max_instances: int = 8, seed: int = 0,
                 orig_max_scale: float = 1.0):
        self.n = n
        self.size = image_size
        self.max_instances = max_instances
        self.seed = seed
        self.orig_max_scale = orig_max_scale

    def __len__(self) -> int:
        return self.n

    def _dims(self, i: int) -> tuple[int, int]:
        if self.orig_max_scale <= 1.0:
            return self.size, self.size
        # its own RNG stream, so the scene draws do not depend on it
        rng = np.random.RandomState((self.seed * 7919 + i * 31 + 7) % (2 ** 31))
        r1, r2 = rng.rand(2)
        oh = int(self.size * (1.0 + r1 * (self.orig_max_scale - 1.0)))
        ow = int(self.size * (1.0 + r2 * (self.orig_max_scale - 1.0)))
        if oh == ow:
            ow += 1  # always non-square in this mode
        return oh, ow

    def _scene(self, i: int, oh: int, ow: int):
        """(image (oh, ow, 3) u8, masks (M, oh, ow) u8, valid (M,) u8)."""
        rng = np.random.RandomState((self.seed * 1_000_003 + i) % (2 ** 31))
        img = (rng.rand(oh, ow, 3) * 60 + 40).astype(np.uint8)  # noisy bg
        k = rng.randint(1, self.max_instances + 1)
        masks = np.zeros((self.max_instances, oh, ow), np.uint8)
        yy, xx = np.mgrid[0:oh, 0:ow]
        for m in range(k):
            cy = rng.randint(oh // 8, 7 * oh // 8)
            cx = rng.randint(ow // 8, 7 * ow // 8)
            ry = rng.randint(oh // 16, oh // 5)
            rx = rng.randint(ow // 16, ow // 5)
            ang = rng.rand() * np.pi
            ca, sa = np.cos(ang), np.sin(ang)
            u = (xx - cx) * ca + (yy - cy) * sa
            v = -(xx - cx) * sa + (yy - cy) * ca
            ell = (u / rx) ** 2 + (v / ry) ** 2 <= 1.0
            for prev in range(m):  # later instances occlude earlier ones
                masks[prev][ell] = 0
            masks[m] = ell.astype(np.uint8)
            color = rng.randint(100, 255, size=3)
            img[ell] = (0.7 * color + 0.3 * img[ell]).astype(np.uint8)
        valid = np.array(
            [1 if masks[m].sum() > 16 else 0
             for m in range(self.max_instances)], np.uint8)
        return img, masks, valid

    def image_id(self, i: int):
        return int(i)

    def get(self, i: int) -> Sample:
        s = self.size
        oh, ow = self._dims(i)
        img, masks, valid = self._scene(i, oh, ow)
        if (oh, ow) == (s, s):
            hw = np.array([s, s], np.int32)
            return Sample(img, masks, valid, hw, hw, name=f"synthetic_{i}")
        from PIL import Image

        vh, vw = letterbox_params(oh, ow, s)
        img_lb = np.zeros((s, s, 3), np.uint8)
        img_lb[:vh, :vw] = np.asarray(
            Image.fromarray(img).resize((vw, vh), Image.BILINEAR))
        ys = np.minimum(((np.arange(vh) + 0.5) * (oh / vh)).astype(np.int64),
                        oh - 1)
        xs = np.minimum(((np.arange(vw) + 0.5) * (ow / vw)).astype(np.int64),
                        ow - 1)
        masks_lb = np.zeros((self.max_instances, s, s), np.uint8)
        masks_lb[:, :vh, :vw] = masks[:, ys[:, None], xs[None, :]]
        return Sample(
            img_lb, masks_lb, valid,
            np.array([oh, ow], np.int32), np.array([vh, vw], np.int32),
            name=f"synthetic_{i}")

    def get_orig_masks(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Native-resolution GT: (masks (M, oh, ow) u8, valid (M,) u8)."""
        oh, ow = self._dims(i)
        _, masks, valid = self._scene(i, oh, ow)
        return masks, valid


def make_dataset(cfg_data, split: str | None = None):
    """The synthetic dataset of ``cfg_data`` (train: ``synthetic_n`` scenes,
    seed 0; other splits: a quarter of that, seed 1)."""
    split = cfg_data.split if split is None else split
    if cfg_data.dataset == "synthetic":
        n = cfg_data.synthetic_n if split == "train" \
            else max(cfg_data.synthetic_n // 4, 1)
        return SyntheticDataset(
            n=n, image_size=cfg_data.image_size,
            max_instances=cfg_data.max_instances,
            seed=0 if split == "train" else 1,
            orig_max_scale=cfg_data.synthetic_orig_scale,
        )
    if cfg_data.dataset in ("ilso", "soc", "folder", "coco", "shards"):
        raise NotImplementedError(
            f"data.dataset={cfg_data.dataset!r} not yet ported")
    raise ValueError(f"unknown dataset {cfg_data.dataset!r}")


def iter_epoch(dataset, batch_size: int, shuffle: bool, seed: int,
               drop_last: bool = True,
               skip: int = 0,
               rows: np.ndarray | None = None) -> Iterator[dict[str, np.ndarray]]:
    """Host batches of one epoch, shuffled by ``seed``.

    ``drop_last=False`` pads the tail batch by tiling its samples;
    ``num_real`` counts the genuine ones. ``skip`` drops the first
    ``skip`` batches without drawing them (mid-epoch resume). ``rows``
    keeps only those positions of each batch (one host's share)."""
    idx = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    end = len(idx) - (len(idx) % batch_size if drop_last else 0)
    for start in range(skip * batch_size, end, batch_size):
        chunk = idx[start:start + batch_size]
        num_real = len(chunk)
        if num_real < batch_size:
            chunk = np.resize(chunk, batch_size)  # tiles, handles any ratio
        if rows is not None:
            chunk = chunk[rows]
        if hasattr(dataset, "get_batch"):
            samples = dataset.get_batch(chunk)
        else:
            samples = [dataset.get(int(i)) for i in chunk]
        yield {
            "image": np.stack([s.image for s in samples]),
            "masks": np.stack([s.masks for s in samples]),
            "valid": np.stack([s.valid for s in samples]),
            "orig_hw": np.stack([s.orig_hw for s in samples]),
            "valid_hw": np.stack([s.valid_hw for s in samples]),
            "num_real": np.int32(num_real),
            "index": chunk.astype(np.int64),
        }
