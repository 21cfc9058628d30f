"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions, then builds the CUDA kernels from ``basi_tpu_torch/csrc``
   (``nvcc`` for sm_90a, into ``build/kernels/``).
2. Holds each kernel against its plain PyTorch version on the card at every
   shape the serving path gives it, with times (CUDA events, after warm-up):
   ``upsample_int`` within 1 bf16 ulp, ``upsample_sigmoid`` within 1e-5.
3. Drives the serving path at full width: preset ``val_v4-8_ap`` (ResNet-50,
   512^2, bf16, batch 8) with seeded random weights, objectness bias 0 and
   non-trivial BN stats. A ``BatchedPredictor`` answers 16 concurrent
   requests (two batches), then ``full_res_masks`` runs on each answer. The
   outputs must be finite with filled slots, and the launch counters must
   show 9 ``upsample_int`` launches per forward and one ``upsample_sigmoid``
   launch per ``full_res_masks`` call. Prints ``predict_batch`` imgs/s.
4. f32 check: the same weights through the port on the card (TF32 off) and
   on the CPU agree within 1e-3 on the model outputs (batch 1).

Any failure raises and exits non-zero; so does a machine without CUDA. The
line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SEED = 0
REQUESTS = 16
WARMUP, ITERS = 3, 20


def _time_ms(fn, iters=ITERS) -> float:
    """Mean device time of ``fn()`` per call, CUDA events after warm-up."""
    for _ in range(WARMUP):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bf16_ulp_ok(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Every value within 1 bf16 ulp (8 significant bits) of ``want``."""
    want = want.double()
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    return bool(((got.double() - want).abs() <= ulp).all())


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def check_kernels(dev, gen):
    """Phase 2: kernel vs plain version at the serving path's shapes."""
    from basi_tpu_torch.kernels.upsample_int import (
        upsample_int,
        upsample_int_reference,
    )
    from basi_tpu_torch.kernels.upsample_sigmoid import (
        upsample_sigmoid,
        upsample_sigmoid_reference,
    )

    # (input NHWC, factor): FPN top-down x3, saliency tower x3, mask
    # features x3, at batch 8 and 512^2.
    shapes = [((8, 16, 16, 256), 2), ((8, 32, 32, 256), 2),
              ((8, 64, 64, 256), 2), ((8, 64, 64, 64), 2),
              ((8, 32, 32, 64), 4), ((8, 16, 16, 64), 8),
              ((8, 64, 64, 128), 2), ((8, 32, 32, 128), 4),
              ((8, 16, 16, 128), 8)]
    ui = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
    for shape, f in shapes:
        x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        got, want = upsample_int(x, f), upsample_int_reference(x, f)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        _require(_bf16_ulp_ok(got, want),
                 f"upsample_int {shape} x{f}: beyond 1 bf16 ulp (max {err})")
        ms = _time_ms(lambda: upsample_int(x, f))
        plain = _time_ms(lambda: upsample_int_reference(x, f))
        print(f"upsample_int {shape} x{f}: max_abs_err {err:.3e} "
              f"(<= 1 bf16 ulp), kernel {ms:.4f} ms, plain {plain:.4f} ms")
        ui["ms"] += ms
        ui["plain_ms"] += plain
        ui["max_abs_err"] = max(ui["max_abs_err"], err)

    # The serving path hands it bf16 slot masks; f32 input is checked too.
    logits = torch.randn((8, 20, 128, 128), generator=gen) * 4
    us = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        x = logits.to(dev, dtype)
        got = upsample_sigmoid(x, (512, 512))
        want = upsample_sigmoid_reference(x, (512, 512))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        _require(got.dtype == torch.float32 and err <= 1e-5,
                 f"upsample_sigmoid {dtype}: max_abs_err {err} > 1e-5")
        ms = _time_ms(lambda: upsample_sigmoid(x, (512, 512)))
        plain = _time_ms(lambda: upsample_sigmoid_reference(x, (512, 512)))
        print(f"upsample_sigmoid (8, 20, 128, 128) {dtype} -> 512^2 f32: "
              f"max_abs_err {err:.3e} (<= 1e-5), kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms")
        us.update(ms=ms, plain_ms=plain,
                  max_abs_err=max(err, us["max_abs_err"]))
    return ui, us


def smoke_weights(cfg, gen):
    """Seeded f32 state dict with the objectness bias at 0 (the focal-prior
    init fills no slot) and non-trivial BN running stats."""
    from basi_tpu_torch.models.basi import create_model

    model = create_model(cfg.model, "cpu", gen)
    with torch.no_grad():
        model.instance.score.bias.zero_()
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(
                    torch.randn(m.running_mean.shape, generator=gen) * 0.1)
                m.running_var.copy_(
                    torch.rand(m.running_var.shape, generator=gen) + 0.5)
    return model.state_dict()


def run_slice(cfg, sd, dev, gen):
    """Phase 3: the BatchedPredictor at full width; returns launch counts."""
    from basi_tpu_torch.kernels.upsample_int import upsample_int
    from basi_tpu_torch.kernels.upsample_sigmoid import upsample_sigmoid
    from basi_tpu_torch.serve import BatchedPredictor

    size, k = cfg.model.image_size, cfg.model.num_slots
    images = torch.randint(0, 256, (REQUESTS, size, size, 3), generator=gen,
                           dtype=torch.uint8).numpy()
    p = BatchedPredictor(cfg, max_wait_ms=5000, device=dev, state_dict=sd)
    try:
        forwards = []
        run = p.inf.predict_batch

        def counted(batch):
            forwards.append(len(batch))
            return run(batch)

        p.inf.predict_batch = counted
        preds = [None] * REQUESTS

        def ask(i):
            preds[i] = p.predict(images[i], timeout=600)

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(REQUESTS)]
        upsample_int.launches = upsample_sigmoid.launches = 0
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        fulls = [p.inf.full_res_masks(
            torch.from_numpy(pr.masks).to(dev, p.inf.dtype)) for pr in preds]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"upsample_int": upsample_int.launches,
                    "upsample_sigmoid": upsample_sigmoid.launches}
        del p.inf.predict_batch

        _require(all(pr is not None for pr in preds), "a request got no answer")
        print(f"served {REQUESTS} requests in {len(forwards)} batches "
              f"{forwards} in {wall:.3f} s (first-call set-up included); "
              f"launches {launches}")
        _require(forwards == [cfg.infer.batch_size] * 2,
                 f"expected two full batches, got {forwards}")
        _require(launches["upsample_int"] == 9 * len(forwards),
                 f"upsample_int launched {launches['upsample_int']} times, "
                 f"expected 9 per forward x {len(forwards)}")
        _require(launches["upsample_sigmoid"] == len(fulls),
                 f"upsample_sigmoid launched {launches['upsample_sigmoid']} "
                 f"times for {len(fulls)} full_res_masks calls")
        filled = 0
        for pr, full in zip(preds, fulls):
            _require(pr.masks.shape == (k, size // 4, size // 4)
                     and pr.scores.shape == (k,), "slot shapes")
            _require(np.isfinite(pr.masks).all() and np.isfinite(pr.scores).all(),
                     "non-finite slots")
            _require(tuple(full.shape) == (k, size, size)
                     and full.dtype == torch.float32, "full-res shape")
            _require(bool(torch.isfinite(full).all())
                     and 0.0 <= float(full.min()) <= float(full.max()) <= 1.0,
                     "full-res masks not finite probabilities")
            filled += int((pr.scores > 0).sum())
        _require(all((pr.scores > 0).any() for pr in preds),
                 "an image filled no slot")
        print(f"slots filled: {filled} of {REQUESTS * k}; "
              f"score max {max(float(pr.scores.max()) for pr in preds):.4f}")

        batch = torch.from_numpy(images[:cfg.infer.batch_size]).to(dev)
        ms = _time_ms(lambda: p.inf.predict_batch(batch), iters=10)
        print(f"predict_batch (fwd + selection, bf16, batch "
              f"{cfg.infer.batch_size}, {size}^2): {ms:.3f} ms/batch = "
              f"{cfg.infer.batch_size * 1000.0 / ms:.1f} imgs/s")
    finally:
        p.close()
    return launches


def check_f32(cfg, sd, dev, gen):
    """Phase 4: f32 port on the card vs the port on the CPU, batch 1."""
    import dataclasses

    from basi_tpu_torch.infer import Inferencer

    cfg32 = dataclasses.replace(
        cfg, infer=dataclasses.replace(cfg.infer, dtype="float32", batch_size=1))
    size = cfg.model.image_size
    image = torch.randint(0, 256, (1, size, size, 3), generator=gen,
                          dtype=torch.uint8)
    outs = []
    for device in (dev, "cpu"):
        inf = Inferencer(cfg32, device=device, state_dict=sd)
        with torch.inference_mode():
            out = inf.apply_model(image)
        outs.append({k: getattr(out, k).float().cpu() for k in
                     ("saliency_logits", "cell_scores", "mask_feats")})
    for k in outs[0]:
        err = float((outs[0][k] - outs[1][k]).abs().max())
        print(f"f32 card vs cpu {k}: max_abs_err {err:.3e}")
        torch.testing.assert_close(outs[0][k], outs[1][k], atol=1e-3, rtol=1e-3)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from basi_tpu.config import get_config
    from basi_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    print(f"kernels: {info['path']} ({'built' if info['compiled'] else 'cached'}"
          f" in {time.perf_counter() - t0:.2f} s, nvcc {info['seconds']:.2f} s)")

    gen = torch.Generator().manual_seed(SEED)
    ui, us = check_kernels(dev, gen)

    cfg = get_config("val_v4-8_ap", ["data.dataset=synthetic"])
    sd = smoke_weights(cfg, gen)
    launches = run_slice(cfg, sd, dev, gen)
    check_f32(cfg, sd, dev, gen)

    rows = [("upsample_int", "basi_tpu_torch/csrc/upsample_int.cu",
             "basi_tpu/ops/pallas/upsample_int.py:65", ui),
            ("upsample_sigmoid", "basi_tpu_torch/csrc/upsample_sigmoid.cu",
             "basi_tpu/ops/pallas/upsample_sigmoid.py:42", us)]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, src, rep, r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
