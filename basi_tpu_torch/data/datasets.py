"""Datasets and host batch assembly (port of ``basi_tpu/data/datasets.py``).

``SyntheticDataset`` draws the same procedural blob scenes as the JAX
package for the same (seed, index); ``FolderDataset`` reads ILSO/SOC-style
folders of images and instance masks; ``iter_epoch`` assembles the same
batches in the same shuffled order; ``make_dataset`` builds the synthetic
set, a folder (``ilso``, ``soc``, ``folder``), COCO (``data/coco.py``) or
the packed shards of ``data/shards.py`` from a ``DataConfig``. numpy only:
non-square scenes (``synthetic_orig_scale > 1``) are letterboxed by
``data/letterbox.py``, byte for byte as the JAX package's PIL resize;
files are decoded by ``data/native.py`` and mask PNGs read by
``data/png.py``, byte for byte as the JAX package's decoder and PIL.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from basi_tpu_torch.data.letterbox import resize_bilinear_u8
from basi_tpu_torch.data.png import read_png


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


def nearest_rows(n_src: int, n_dst: int) -> np.ndarray:
    """The centre-convention nearest source index of each of ``n_dst``
    outputs, ``floor((j + 0.5) * n_src / n_dst)``."""
    return np.minimum(((np.arange(n_dst) + 0.5) * (n_src / n_dst))
                      .astype(np.int64), n_src - 1)


def read_label_png(path: str) -> np.ndarray:
    """A labeled mask PNG's raw per-pixel ids: modes ``P``, ``L``, ``I``
    and ``I;16`` as stored (palette indices, never colours: two ids whose
    colours share a channel would merge), any other mode's channel 0 (a
    1-bit PNG gives bool ids)."""
    arr, mode = read_png(path)
    if mode not in ("P", "L", "I", "I;16") and arr.ndim == 3:
        arr = arr[..., 0]
    return arr


def decode_label_letterbox(path: str, size: int) -> np.ndarray:
    """A labeled mask PNG's raw ids (``read_label_png``), letterboxed to
    (size, size) with centre-convention nearest sampling."""
    arr = read_label_png(path)
    h, w = arr.shape[:2]
    vh, vw = letterbox_params(h, w, size)
    out = np.zeros((size, size), arr.dtype)
    out[:vh, :vw] = arr[nearest_rows(h, vh)[:, None],
                        nearest_rows(w, vw)[None, :]]
    return out


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
        vh, vw = letterbox_params(oh, ow, s)
        img_lb = np.zeros((s, s, 3), np.uint8)
        img_lb[:vh, :vw] = resize_bilinear_u8(img, vh, vw)
        masks_lb = np.zeros((self.max_instances, s, s), np.uint8)
        masks_lb[:, :vh, :vw] = masks[:, nearest_rows(oh, vh)[:, None],
                                      nearest_rows(ow, vw)[None, :]]
        return Sample(
            img_lb, masks_lb, valid,
            np.array([oh, ow], np.int32), np.array([vh, vw], np.int32),
            name=f"synthetic_{i}")

    def get_orig_masks(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Native-resolution GT: (masks (M, oh, ow) u8, valid (M,) u8)."""
        oh, ow = self._dims(i)
        _, masks, valid = self._scene(i, oh, ow)
        return masks, valid


class FolderDataset:
    """ILSO/SOC-style folder dataset: images and instance masks on disk.

    root[/<split>]/
      images/*.jpg|jpeg|png|bmp
      masks/<stem>.png            (labeled: pixel value k > 0 = instance k) OR
      masks/<stem>/*.png          (one binary PNG per instance, > 127 is on)

    An image without either has no instances. ``split`` picks
    ``root/<split>`` when it has an ``images`` directory. Images decode
    through ``data/native.py`` (``.bmp`` raises there, as in the JAX
    package); labeled masks keep their raw ids (``read_label_png``)."""

    IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(self, root: str, image_size: int = 512,
                 max_instances: int = 8, split: str = "",
                 decode_backend: str = "auto"):
        from basi_tpu_torch.data.native import get_decoder

        self.root = root
        self.size = image_size
        self.max_instances = max_instances
        img_dir = os.path.join(root, "images")
        if split and os.path.isdir(os.path.join(root, split, "images")):
            img_dir = os.path.join(root, split, "images")
            root = os.path.join(root, split)
        self.img_dir = img_dir
        self.mask_dir = os.path.join(root, "masks")
        if not os.path.isdir(img_dir):
            raise FileNotFoundError(f"no images dir under {root}")
        self.names = sorted(f for f in os.listdir(img_dir)
                            if f.lower().endswith(self.IMG_EXTS))
        self.decoder = get_decoder(decode_backend)

    def __len__(self) -> int:
        return len(self.names)

    def image_id(self, i: int):
        """COCO-results image id: an all-digit stem parses to an int,
        anything else stays a string."""
        stem = os.path.splitext(self.names[i])[0]
        return int(stem) if stem.isdecimal() else stem

    def _mask_jobs(self, stem: str) -> tuple[str, list[str]]:
        """(kind, mask file paths) of one image; kind is ``labeled``,
        ``per`` or ``none``."""
        labeled = os.path.join(self.mask_dir, stem + ".png")
        per_dir = os.path.join(self.mask_dir, stem)
        if os.path.isfile(labeled):
            return "labeled", [labeled]
        if os.path.isdir(per_dir):
            return "per", [os.path.join(per_dir, f) for f in
                           sorted(os.listdir(per_dir))[:self.max_instances]]
        return "none", []

    def _assemble(self, kind: str, decoded: list[np.ndarray], hw):
        """(masks (M, *hw) u8, valid (M,) u8) of the 2-D mask arrays of one
        image: a labeled image's nonzero ids in ascending order, or each
        per-instance mask above 127, capped at ``max_instances``."""
        masks = np.zeros((self.max_instances, *hw), np.uint8)
        count = 0
        if kind == "labeled":
            lab = decoded[0]
            for v in [v for v in np.unique(lab) if v > 0][:self.max_instances]:
                masks[count] = lab == v
                count += 1
        elif kind == "per":
            for m in decoded[:self.max_instances]:
                masks[count] = m > 127
                count += 1
        valid = np.zeros((self.max_instances,), np.uint8)
        valid[:count] = 1
        return masks, valid

    def _sample(self, img, hw, stem: str, kind: str, decoded) -> Sample:
        oh, ow = int(hw[0]), int(hw[1])
        masks, valid = self._assemble(kind, decoded, (self.size, self.size))
        return Sample(img, masks, valid, np.array([oh, ow], np.int32),
                      np.array(letterbox_params(oh, ow, self.size), np.int32),
                      name=stem)

    def get(self, i: int) -> Sample:
        name = self.names[i]
        stem = os.path.splitext(name)[0]
        img, hw = self.decoder.decode_letterbox(
            os.path.join(self.img_dir, name), self.size)
        kind, paths = self._mask_jobs(stem)
        if kind == "labeled":
            decoded = [decode_label_letterbox(paths[0], self.size)]
        else:
            decoded = [self.decoder.decode_letterbox(p, self.size,
                                                     nearest=True)[0][..., 0]
                       for p in paths]
        return self._sample(img, hw, stem, kind, decoded)

    def get_batch(self, indices) -> list[Sample]:
        """``get`` of each index, equal to it: the images in one call of
        the decoder's thread pool, the per-instance masks in a second;
        labeled masks through ``decode_label_letterbox``."""
        names = [self.names[int(i)] for i in indices]
        stems = [os.path.splitext(n)[0] for n in names]
        imgs, hws = self.decoder.decode_letterbox_batch(
            [os.path.join(self.img_dir, n) for n in names], self.size)
        jobs = [self._mask_jobs(s) for s in stems]
        flat = [p for kind, ps in jobs if kind == "per" for p in ps]
        per = self.decoder.decode_letterbox_batch(
            flat, self.size, nearest=True)[0][..., 0] if flat else None
        out, cursor = [], 0
        for si, (kind, ps) in enumerate(jobs):
            if kind == "labeled":
                decoded = [decode_label_letterbox(ps[0], self.size)]
            else:
                decoded = list(per[cursor:cursor + len(ps)]) if ps else []
                cursor += len(ps)
            out.append(self._sample(imgs[si], hws[si], stems[si], kind,
                                    decoded))
        return out

    def get_orig_masks(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Native-resolution GT: (masks (M, oh, ow) u8, valid (M,) u8), the
        mask files read unresized (``read_png``), the rules of ``get``;
        an image without masks gives zeros at its own size."""
        from basi_tpu_torch.data.native import image_size

        stem = os.path.splitext(self.names[i])[0]
        kind, paths = self._mask_jobs(stem)
        if kind == "labeled":
            decoded = [read_label_png(paths[0])]
        else:
            decoded = []
            for p in paths:
                a = read_png(p)[0]
                decoded.append(a[..., 0] if a.ndim == 3 else a)
        if not decoded:
            hw = image_size(os.path.join(self.img_dir, self.names[i]))
        else:
            hw = decoded[0].shape[:2]
        return self._assemble(kind, decoded, hw)


def make_dataset(cfg_data, split: str | None = None):
    """The dataset of ``cfg_data``: synthetic (train: ``synthetic_n``
    scenes, seed 0; other splits: a quarter of that, seed 1); a folder
    (``ilso``, ``soc``, ``folder``: ``data.root``, default
    ``data/<name>``); COCO (``data.root``, default ``data/coco``, and
    ``data.ann_file``); or shards under ``data.root`` (``root/<split>``
    where that directory exists)."""
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
    if cfg_data.dataset == "shards":
        from basi_tpu_torch.data.shards import ShardDataset

        root = cfg_data.root
        if split and os.path.isdir(os.path.join(root, split)):
            root = os.path.join(root, split)
        return ShardDataset(root, image_size=cfg_data.image_size,
                            max_instances=cfg_data.max_instances)
    if cfg_data.dataset in ("ilso", "soc", "folder"):
        root = cfg_data.root or os.path.join("data", cfg_data.dataset)
        return FolderDataset(
            root, image_size=cfg_data.image_size,
            max_instances=cfg_data.max_instances, split=split,
            decode_backend=cfg_data.decode_backend)
    if cfg_data.dataset == "coco":
        from basi_tpu_torch.data.coco import CocoDataset

        root = cfg_data.root or os.path.join("data", "coco")
        return CocoDataset(
            root, image_size=cfg_data.image_size,
            max_instances=cfg_data.max_instances, split=split,
            decode_backend=cfg_data.decode_backend,
            ann_file=cfg_data.ann_file)
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
