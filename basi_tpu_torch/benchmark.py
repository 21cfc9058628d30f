"""Benchmark driver: prints ONE JSON line with the metric (port of
``basi_tpu/benchmark.py``).

  python -m basi_tpu_torch.cli bench --mode infer   # serving rate
  python -m basi_tpu_torch.cli bench --mode train   # train step ms
  python -m basi_tpu_torch.cli bench --mode e2e     # files -> forward

Each line has ``metric``, ``value``, ``unit``, the ``device`` it ran on
and the kernel launches per batch or step of its timed window. The
numbers are the port's own on the device named; no baseline is divided in.

Timing on the card: the ``iters`` distinct batches are uploaded first,
then ``predict_batch`` (or the train step) runs ``iters`` times back to
back with no host sync inside the window; a device scalar accumulates the
outputs and is read once at the end. The best of 4 windows (infer) or 3
(train) is kept. Infer keeps the reference's methodology pin: one
synchronous single batch must take at most 10% of the timed window, else
the window is too small to amortize the per-call overhead and
``RuntimeError`` is raised.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from basi_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from basi_tpu_torch.kernels import launch_counters


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def _counted(fn, per: int):
    """Run ``fn()`` and return (its result, the kernel launches it made
    divided by ``per``, kernels that launched only)."""
    before = {k: f.launches for k, f in launch_counters().items()}
    out = fn()
    after = {k: f.launches for k, f in launch_counters().items()}
    return out, {k: (after[k] - before[k]) / per for k in after
                 if after[k] != before[k]}


def infer_setup(batch_size: int = 8, iters: int = 256,
                extra_overrides: list | None = None,
                device=DEFAULT_DEVICE):
    """(cfg, Inferencer, the ``iters`` distinct uint8 batches on the
    device) of the infer benchmark: ``val_v4-8_ap`` at ``batch_size`` on
    synthetic data, seeded random weights."""
    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.infer import Inferencer

    cfg = get_config(
        "val_v4-8_ap",
        [f"infer.batch_size={batch_size}", "data.dataset=synthetic",
         *(extra_overrides or [])])
    inf = Inferencer(cfg, device=device)
    size = cfg.model.image_size
    rng = np.random.RandomState(0)
    raw = (rng.rand(iters, cfg.infer.batch_size, size, size, 3)
           * 255).astype(np.uint8)
    return cfg, inf, torch.from_numpy(raw).to(inf.device)


def infer_window(inf, batches: torch.Tensor) -> torch.Tensor:
    """``predict_batch`` on each batch back to back; a device scalar sums
    the slot masks and scores (read it to wait for the window)."""
    acc = torch.zeros((), dtype=torch.float32, device=inf.device)
    for b in batches:
        masks, scores, _ = inf.predict_batch(b)
        acc += masks.sum(dtype=torch.float32) + scores.sum()
    return acc


def _bench_infer(batch_size: int = 8, iters: int = 256,
                 extra_overrides: list | None = None,
                 device=DEFAULT_DEVICE) -> dict:
    """``extra_overrides`` is for experimentation from Python; the CLI
    keeps the infer config pinned (see ``run``)."""
    cfg, inf, batches = infer_setup(batch_size, iters, extra_overrides,
                                    device)
    dev = inf.device
    float(infer_window(inf, batches[:2]))  # warm up
    dts = []
    for _ in range(4):
        _sync(dev)
        t0 = time.perf_counter()
        float(infer_window(inf, batches))
        dts.append(time.perf_counter() - t0)
    dt = min(dts)
    _, launches = _counted(lambda: float(infer_window(inf, batches)), iters)

    # Methodology pin: one synchronous single batch must be at most 10% of
    # the window, so that the window amortizes the per-call overhead.
    singles = []
    for _ in range(3):
        _sync(dev)
        t0 = time.perf_counter()
        _, s0, _ = inf.predict_batch(batches[0])
        float(s0.sum())
        singles.append(time.perf_counter() - t0)
    t_single = min(singles)
    if t_single > 0.10 * dt:
        raise RuntimeError(
            f"bench methodology violated: a single synchronous batch takes "
            f"{t_single * 1e3:.1f} ms, {t_single / dt:.1%} of the "
            f"{iters}-batch window ({dt * 1e3:.1f} ms): the window no "
            f"longer amortizes the per-call overhead (iters too small?)")

    bs = cfg.infer.batch_size
    size = cfg.model.image_size
    rate = bs * iters / dt
    return {
        "metric": (f"{size}x{size} images/sec (infer, {cfg.infer.dtype}, "
                   f"batch {bs}, fwd+NMS)"),
        "value": round(rate, 1),
        "unit": "images/sec",
        "device": _device_name(dev),
        "ms_per_batch": round(dt / iters * 1e3, 3),
        "single_batch_ms": round(t_single * 1e3, 3),
        "launches_per_batch": launches,
    }


def _bench_train(batch_size: int = 16, iters: int = 24,
                 extra_overrides: list | None = None,
                 device=DEFAULT_DEVICE) -> dict:
    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.data.transforms import pack_masks_host
    from basi_tpu_torch.models.basi import create_model
    from basi_tpu_torch.train.state import (
        check_train_config,
        create_train_state,
        make_schedule,
    )
    from basi_tpu_torch.train.step import compute_dtype, make_train_step

    # The function default is a BASE override so --set can change it; the
    # final values are read back from cfg.
    cfg = get_config("train_ilso_1ep", [f"data.batch_size={batch_size}",
                                        *(extra_overrides or [])])
    check_train_config(cfg)
    dev = resolve_device(device)
    bs = cfg.data.batch_size
    size = cfg.model.image_size
    m = cfg.data.max_instances
    model = create_model(cfg.model, dev,
                         torch.Generator().manual_seed(cfg.train.seed),
                         train=True)
    state = create_train_state(model, cfg.train)
    step = make_train_step(cfg.train, cfg.data, make_schedule(cfg.train, 1000),
                           compute_dtype(cfg.model))

    # Distinct batches, as the Trainer feeds them (masks bit-packed when
    # data.pack_masks), uploaded before the clock starts.
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(iters):
        gt = (rng.rand(bs, m, size, size) > 0.8).astype(np.uint8)
        if cfg.data.pack_masks:
            gt = pack_masks_host(gt)
        batches.append({
            "image": torch.from_numpy(
                (rng.rand(bs, size, size, 3) * 255).astype(np.uint8)).to(dev),
            "masks": torch.from_numpy(gt).to(dev),
            "valid": torch.ones((bs, m), dtype=torch.uint8, device=dev)})

    def window():
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for b in batches:
            acc += step(state, b)["loss"].float()
        return float(acc)

    float(step(state, batches[0])["loss"])  # warm up
    dts = []
    for _ in range(3):
        _sync(dev)
        t0 = time.perf_counter()
        window()
        dts.append(time.perf_counter() - t0)
    dt = min(dts)
    _, launches = _counted(window, iters)
    return {
        "metric": (f"train step ms (batch {bs}, {size}x{size}, "
                   f"{cfg.model.dtype}, bn_impl {cfg.model.bn_impl})"),
        "value": round(dt / iters * 1e3, 2),
        "unit": "ms/step",
        "device": _device_name(dev),
        "imgs_per_s": round(bs * iters / dt, 1),
        "launches_per_step": launches,
    }


def _write_scenes(img_dir: str, n_images: int, side: int) -> None:
    """Photo-like scenes (smooth background and boxes, not noise: decode
    cost depends on content) as PNGs with libpng's filters."""
    from concurrent.futures import ThreadPoolExecutor

    from basi_tpu_torch.data.png import write_png

    rng = np.random.RandomState(0)
    gy = np.linspace(0, 120, side, dtype=np.float32)[:, None]
    gx = np.linspace(0, 100, side, dtype=np.float32)[None, :]
    base = (gy + gx)[..., None] + np.array([40.0, 60.0, 80.0])
    scenes = []
    for _ in range(n_images):
        arr = base.copy()
        for _ in range(6):
            y0, x0 = rng.randint(0, int(side * 0.78), 2)
            h, w = rng.randint(max(2, side // 13), max(3, side // 5), 2)
            arr[y0:y0 + h, x0:x0 + w] = rng.randint(0, 255, 3)
        scenes.append(arr.clip(0, 255).astype(np.uint8))
    # zlib and numpy release the GIL
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        jobs = [pool.submit(write_png, os.path.join(img_dir, f"im{i:05d}.png"),
                            a) for i, a in enumerate(scenes)]
        for job in jobs:
            job.result()


def _bench_e2e(n_images: int = 400, batch_size: int = 8,
               extra_overrides: list | None = None, *,
               infer_rate: float, device=DEFAULT_DEVICE) -> dict:
    """Ingest-included throughput: PNG files on disk -> decode and
    letterbox (``data/native.py``, a thread pool) -> ``DeviceFeed`` ->
    forward + selection; and the ingest rate alone (files to device, no
    forward), through the files and through a ``pack_dataset`` shard
    cache, and host-only rates of both. ``infer_rate``: the device rate
    (``_bench_infer``) the ingest rate per core is held against."""
    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.data.datasets import FolderDataset, iter_epoch
    from basi_tpu_torch.data.pipeline import DeviceFeed
    from basi_tpu_torch.data.shards import ShardDataset, pack_dataset
    from basi_tpu_torch.infer import Inferencer

    cfg = get_config("val_v4-8_ap", [f"infer.batch_size={batch_size}"]
                     + list(extra_overrides or []))
    batch_size = cfg.infer.batch_size
    if n_images // batch_size < 2:
        raise ValueError(
            f"e2e bench needs >= 2 batches to time (the first is set-up): "
            f"infer.batch_size={batch_size} vs {n_images} images")
    inf = Inferencer(cfg, device=device)
    dev = inf.device
    tmp = tempfile.mkdtemp(prefix="basi_e2e_")
    try:
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        os.makedirs(os.path.join(tmp, "masks"))
        _write_scenes(img_dir, n_images, cfg.model.image_size)
        ds = FolderDataset(tmp, image_size=cfg.model.image_size,
                           max_instances=cfg.data.max_instances,
                           decode_backend="native")

        def paced(dataset):
            """(e2e imgs/s, ingest-only imgs/s) through a DeviceFeed; the
            first batch (set-up, first decodes) is off the clock."""
            feed = DeviceFeed(dataset, batch_size, shuffle=False, seed=0,
                              device=dev, depth=4, drop_last=True,
                              pack_masks=cfg.data.pack_masks)
            n_imgs, t0 = 0, None
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            for bi, batch in enumerate(feed.epoch(0)):
                _, scores, _ = inf.predict_batch(batch["image"])
                acc += scores.sum()
                if bi == 0:
                    float(acc)
                    t0 = time.perf_counter()
                else:
                    n_imgs += batch_size
            float(acc)
            e2e = n_imgs / (time.perf_counter() - t0)

            n_imgs, t0 = 0, None
            for bi, batch in enumerate(feed.epoch(1)):
                if bi == 0:
                    t0 = time.perf_counter()
                else:
                    n_imgs += batch_size
            _sync(dev)  # the last (asynchronous) upload
            return e2e, n_imgs / (time.perf_counter() - t0)

        e2e_rate, ingest_rate = paced(ds)
        # The same passes through a shard cache (decode paid once, off the
        # clock).
        shard_dir = os.path.join(tmp, "shards")
        pack_dataset(ds, shard_dir, shard_size=1024, batch_size=batch_size,
                     log=None)
        sds = ShardDataset(shard_dir)
        shard_e2e, shard_ingest = paced(sds)

        def host_rate(dataset):
            """Host batch assembly alone, no upload."""
            n = 0
            t0 = time.perf_counter()
            for b in iter_epoch(dataset, batch_size, shuffle=False, seed=0):
                n += b["image"].shape[0]
            return n / (time.perf_counter() - t0)

        host_decode = host_rate(ds)
        host_rate(sds)  # warm the page cache
        host_shards = host_rate(sds)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    ncores = os.cpu_count() or 1
    per_core = ingest_rate / ncores
    size = cfg.model.image_size
    return {
        "metric": (f"{size}x{size} images/sec, PNG files->decode->feed->"
                   f"forward (e2e)"),
        "value": round(e2e_rate, 1),
        "unit": "images/sec",
        "device": _device_name(dev),
        "ingest_only_imgs_per_s": round(ingest_rate, 1),
        "host_cores": ncores,
        "ingest_imgs_per_s_per_core": round(per_core, 1),
        "device_infer_imgs_per_s": infer_rate,
        "cores_to_saturate_device": int(np.ceil(infer_rate / per_core)),
        "shards_e2e_imgs_per_s": round(shard_e2e, 1),
        "shards_ingest_only_imgs_per_s": round(shard_ingest, 1),
        "host_only_decode_imgs_per_s": round(host_decode, 1),
        "host_only_shards_imgs_per_s": round(host_shards, 1),
    }


def run(mode: str = "infer", overrides: list | None = None,
        device=DEFAULT_DEVICE) -> int:
    """Print the JSON line of ``mode``. ``--set`` overrides apply to
    ``train`` and ``e2e`` only (the infer config is pinned); ``e2e`` first
    measures the infer rate of its own configuration."""
    if overrides and mode == "infer":
        raise SystemExit("--set is supported for --mode train/e2e only "
                         "(the infer config is pinned)")
    if mode == "infer":
        result = _bench_infer(device=device)
    elif mode == "train":
        result = _bench_train(extra_overrides=overrides, device=device)
    elif mode == "e2e":
        rate = _bench_infer(extra_overrides=overrides, device=device)["value"]
        result = _bench_e2e(extra_overrides=overrides, infer_rate=rate,
                            device=device)
    else:
        raise ValueError(f"unknown bench mode {mode!r}")
    print(json.dumps(result), flush=True)
    return 0

