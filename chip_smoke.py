"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions, then builds the CUDA kernels from ``basi_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once, for sm_90a, into
   ``build/kernels/``).
2. Holds each kernel against its plain PyTorch version on the card at every
   shape the serving and training paths give it, with times (CUDA events,
   after warm-up): ``upsample_int`` within 1 bf16 ulp and its backward
   within 1 bf16 ulp plus 2^-20 of the largest value (cancelling f32 sums),
   ``upsample_sigmoid`` within 1e-5, ``normalize_and_flip`` bit-exact (bf16
   and f32 out, mixed flip flags), and ``torch.autograd.grad`` through
   ``resize_bilinear`` on the kernel route against the plain route.
3. Drives the serving path at full width: preset ``val_v4-8_ap`` (ResNet-50,
   512^2, bf16, batch 8) with seeded random weights, objectness bias 0 and
   non-trivial BN stats. A ``BatchedPredictor`` answers 16 concurrent
   requests (two batches), then ``full_res_masks`` runs on each answer. The
   outputs must be finite with filled slots, and the launch counters must
   show 9 ``upsample_int`` launches per forward and one ``upsample_sigmoid``
   launch per ``full_res_masks`` call. Prints ``predict_batch`` imgs/s.
4. f32 check: the same weights through the port on the card (TF32 off) and
   on the CPU agree within 1e-3 on the model outputs (batch 1).
5. Drives the training path at full width: preset ``bench_accuracy`` with
   ``data.synthetic_orig_scale=1.0`` (ResNet-50, 512^2, bf16 compute with
   f32 params, batch 16, SGD + cosine + EMA), seeded weights.
   ``Trainer.train`` runs 10 steps; every step must launch
   ``normalize_and_flip`` once and ``upsample_int`` forward and backward 9
   times each, the loss and metrics must be finite, and params, EMA and BN
   running statistics must move. Then 20 steps on one repeated batch with
   ``train.warmup_steps=0`` must bring the loss down; the steady steps are
   timed (CUDA events) and give imgs/s.
6. f32 step, card vs CPU: one train step of the tiny config (TF32 off) from
   the same weights and batch; loss and every gradient agree within 1e-3.

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


def _bf16_sum_ok(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Within 1 bf16 ulp of ``want``, or within 2^-20 of its largest
    magnitude: an adjoint sums up to 4f^2 f32 terms, and where they cancel
    the rounding of the f32 sums (which another summation order places
    elsewhere) is larger than an ulp of the small result."""
    want = want.double()
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    slack = 2.0 ** -20 * float(want.abs().max())
    return bool(((got.double() - want).abs() <= ulp + slack).all())


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


# (input NHWC, factor) of the nine bf16 resizes of a training forward at
# batch 16 and 512^2: FPN x3, saliency towers x3, mask features x3.
TRAIN_RESIZES = [((16, 16, 16, 256), 2), ((16, 32, 32, 256), 2),
                 ((16, 64, 64, 256), 2), ((16, 64, 64, 64), 2),
                 ((16, 32, 32, 64), 4), ((16, 16, 16, 64), 8),
                 ((16, 64, 64, 128), 2), ((16, 32, 32, 128), 4),
                 ((16, 16, 16, 128), 8)]


def check_training_kernels(dev, gen):
    """Phase 2, training path: the upsample_int backward at the nine
    training shapes, gradients through resize_bilinear (kernel route vs
    plain route), normalize_and_flip at (16, 512, 512, 3)."""
    from basi_tpu_torch.kernels.normalize_aug import (
        normalize_and_flip,
        normalize_and_flip_reference,
    )
    from basi_tpu_torch.kernels.upsample_int import (
        upsample_int_backward,
        upsample_int_backward_reference,
    )
    from basi_tpu_torch.ops.resize import _resize_einsum, resize_bilinear

    ub = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
    for (n, h, w, c), f in TRAIN_RESIZES:
        g = torch.randn((n, f * h, f * w, c), generator=gen).to(dev, torch.bfloat16)
        got = upsample_int_backward(g, f)
        want = upsample_int_backward_reference(g, f)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        _require(_bf16_sum_ok(got, want),
                 f"upsample_int_bwd {(n, h, w, c)} x{f}: beyond 1 bf16 ulp "
                 f"+ 2^-20 of the largest (max {err})")
        ms = _time_ms(lambda: upsample_int_backward(g, f))
        plain = _time_ms(lambda: upsample_int_backward_reference(g, f))
        print(f"upsample_int_bwd {(n, h, w, c)} x{f}: max_abs_err {err:.3e} "
              f"(<= 1 bf16 ulp + 2^-20 max), kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms")
        ub["ms"] += ms
        ub["plain_ms"] += plain
        ub["max_abs_err"] = max(ub["max_abs_err"], err)

        # autograd through the public resize: kernel route vs plain route
        x = torch.randn((n, h, w, c), generator=gen).to(dev, torch.bfloat16)
        x.requires_grad_()
        y = resize_bilinear(x, (f * h, f * w))
        (gx,) = torch.autograd.grad(y, x, g)
        y_ref = _resize_einsum(x, (f * h, f * w), False)
        (gx_ref,) = torch.autograd.grad(y_ref, x, g)
        _require(_bf16_ulp_ok(y.detach(), y_ref.detach())
                 and _bf16_sum_ok(gx, gx_ref),
                 f"resize_bilinear autograd {(n, h, w, c)} x{f}: kernel route "
                 "beyond 1 bf16 ulp (+ 2^-20 max for the gradient) of the "
                 "plain route")

    nf = {"max_abs_err": 0.0}
    imgs = torch.randint(0, 256, (16, 512, 512, 3), generator=gen,
                         dtype=torch.uint8).to(dev)
    flip = (torch.arange(16) % 3 == 0).to(dev, torch.int32)  # mixed flags
    for dtype in (torch.float32, torch.bfloat16):
        got = normalize_and_flip(imgs, flip, out_dtype=dtype)
        want = normalize_and_flip_reference(imgs, flip, out_dtype=dtype)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        _require(got.dtype == dtype and torch.equal(got, want),
                 f"normalize_and_flip {dtype}: not bit-exact (max {err})")
        ms = _time_ms(lambda: normalize_and_flip(imgs, flip, out_dtype=dtype))
        plain = _time_ms(lambda: normalize_and_flip_reference(
            imgs, flip, out_dtype=dtype))
        print(f"normalize_and_flip (16, 512, 512, 3) u8 -> {dtype}, mixed "
              f"flags: max_abs_err {err:.3e} (bit-exact), kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms")
        # the path's dtype (bf16) gives the recorded times
        nf.update(ms=ms, plain_ms=plain, max_abs_err=max(err, nf["max_abs_err"]))
    return ub, nf


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


TRAIN_STEPS, REPEAT_STEPS, TIMED_FROM = 10, 20, 5


def _kernel_counts() -> dict:
    from basi_tpu_torch.kernels.normalize_aug import normalize_and_flip
    from basi_tpu_torch.kernels.upsample_int import (
        upsample_int,
        upsample_int_backward,
    )

    return {"normalize_and_flip": normalize_and_flip.launches,
            "upsample_int": upsample_int.launches,
            "upsample_int_bwd": upsample_int_backward.launches}


def _zero_kernel_counts() -> None:
    from basi_tpu_torch.kernels.normalize_aug import normalize_and_flip
    from basi_tpu_torch.kernels.upsample_int import (
        upsample_int,
        upsample_int_backward,
    )

    normalize_and_flip.launches = 0
    upsample_int.launches = upsample_int_backward.launches = 0


def run_training(dev) -> dict:
    """Phase 5: the Trainer at full width; returns the launch counts of its
    10 steps."""
    from basi_tpu.config import get_config
    from basi_tpu_torch.train.loop import Trainer

    over = ["data.synthetic_orig_scale=1.0", "train.log_every=1"]
    cfg = get_config("bench_accuracy", over)
    trainer = Trainer(cfg, device=dev)
    model = trainer.state.model
    params0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    ema0 = {k: v.clone() for k, v in trainer.state.ema.items()}
    stats0 = {k: b.clone() for k, b in model.named_buffers()
              if k.endswith(("running_mean", "running_var"))}
    _zero_kernel_counts()
    t0 = time.perf_counter()
    trainer.train(max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    print(f"trained {TRAIN_STEPS} steps of bench_accuracy ({cfg.model.backbone}, "
          f"{cfg.model.image_size}^2, {cfg.model.dtype}, batch "
          f"{cfg.data.batch_size}) in {wall:.2f} s, host feed and first-call "
          f"set-up included; launches {launches}")
    _require(launches == {"normalize_and_flip": TRAIN_STEPS,
                          "upsample_int": 9 * TRAIN_STEPS,
                          "upsample_int_bwd": 9 * TRAIN_STEPS},
             f"expected 1 normalize_and_flip and 9 upsample_int forward and "
             f"backward launches per step over {TRAIN_STEPS} steps, got "
             f"{launches}")
    recs = trainer.records
    _require(len(recs) == TRAIN_STEPS, f"{len(recs)} [train] records")
    for r in recs:
        _require(all(np.isfinite(v) for v in r.values()),
                 f"non-finite [train] record {r}")
    print(f"losses {[round(r['loss'], 4) for r in recs]}; lr at step "
          f"{TRAIN_STEPS} {recs[-1]['lr']:.3e}")

    def moved(before, after):
        return sum(not torch.equal(before[k], after[k]) for k in before)

    n_p = moved(params0, dict(model.named_parameters()))
    n_e = moved(ema0, trainer.state.ema)
    n_s = moved(stats0, dict(model.named_buffers()))
    print(f"moved: {n_p}/{len(params0)} params, {n_e}/{len(ema0)} EMA "
          f"tensors, {n_s}/{len(stats0)} BN running statistics")
    _require(n_p == len(params0) and n_e == len(ema0) and n_s == len(stats0),
             "a param, EMA tensor or BN statistic did not move")
    del trainer, model, params0, ema0, stats0
    torch.cuda.empty_cache()

    # One repeated batch, no warmup: the loss must fall; the steady steps
    # are timed.
    cfg = get_config("bench_accuracy", over + ["train.warmup_steps=0"])
    trainer = Trainer(cfg, device=dev)
    batch = next(iter(trainer.feed.epoch(0)))
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    losses = []
    for i in range(REPEAT_STEPS):
        if i == TIMED_FROM:
            start.record()
        losses.append(trainer.train_step(trainer.state, batch)["loss"])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (REPEAT_STEPS - TIMED_FROM)
    losses = [float(v) for v in losses]
    print(f"repeated batch, {REPEAT_STEPS} steps, losses "
          f"{[round(v, 4) for v in losses]}")
    _require(all(np.isfinite(losses)) and min(losses[-5:]) < losses[0],
             "the loss did not fall over the repeated-batch steps")
    print(f"train step ({cfg.model.dtype}, batch {cfg.data.batch_size}, "
          f"{cfg.model.image_size}^2, steps "
          f"{TIMED_FROM + 1}-{REPEAT_STEPS}): {ms:.3f} ms/step = "
          f"{cfg.data.batch_size * 1000.0 / ms:.1f} imgs/s; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    del trainer, batch
    torch.cuda.empty_cache()
    return launches


def check_f32_step(dev):
    """Phase 6: one f32 train step of the tiny config on the card and on the
    CPU from the same weights and batch: loss and gradients within 1e-3."""
    from basi_tpu.config import (
        Config,
        DataConfig,
        InferConfig,
        ModelConfig,
        TrainConfig,
    )
    from basi_tpu_torch.models.basi import create_model
    from basi_tpu_torch.train.state import create_train_state, make_schedule
    from basi_tpu_torch.train.step import make_train_step

    cfg = Config(
        model=ModelConfig(backbone="resnet_tiny", fpn_channels=32,
                          mask_channels=32, grid_size=8, image_size=64),
        data=DataConfig(image_size=64, max_instances=4, hflip_prob=1.0),
        train=TrainConfig(grad_clip_norm=0.0, checkpoint_dir=""),
        infer=InferConfig(dtype="float32"))
    rng = np.random.RandomState(SEED)
    n, size, m = 4, 64, 4
    yy, xx = np.mgrid[0:size, 0:size]
    masks = np.zeros((n, m, size, size), np.uint8)
    for i in range(n):
        for j in range(m):
            cy, cx = rng.randint(8, size - 8, size=2)
            r = rng.randint(4, size // 4)
            masks[i, j] = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    host = {"image": torch.from_numpy((rng.rand(n, size, size, 3) * 255).astype(
                np.uint8)),
            "masks": torch.from_numpy(masks),
            "valid": torch.ones((n, m), dtype=torch.uint8)}
    out = []
    for device in (dev, "cpu"):
        model = create_model(cfg.model, device,
                             torch.Generator().manual_seed(SEED), train=True)
        state = create_train_state(model, cfg.train)
        step = make_train_step(cfg.train, cfg.data, make_schedule(cfg.train, 10),
                               torch.float32)
        metrics = step(state, {k: v.to(device) for k, v in host.items()})
        out.append((float(metrics["loss"]),
                    {k: p.grad.cpu() for k, p in model.named_parameters()}))
    (loss_d, g_d), (loss_c, g_c) = out
    err = max(float((g_d[k] - g_c[k]).abs().max()) for k in g_c)
    gmax = max(float(g.abs().max()) for g in g_c.values())
    print(f"f32 train step card vs cpu: loss {loss_d:.6f} vs {loss_c:.6f}; "
          f"max gradient difference {err:.3e} (largest gradient {gmax:.3e})")
    _require(abs(loss_d - loss_c) <= 1e-3 * max(1.0, abs(loss_c)),
             "f32 step: loss beyond 1e-3")
    for k in g_c:
        torch.testing.assert_close(g_d[k], g_c[k], atol=1e-3, rtol=1e-3,
                                   msg=lambda m, k=k: f"f32 step grad {k}: {m}")


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

    ub, nf = check_training_kernels(dev, gen)

    cfg = get_config("val_v4-8_ap", ["data.dataset=synthetic"])
    sd = smoke_weights(cfg, gen)
    serve_launches = run_slice(cfg, sd, dev, gen)
    check_f32(cfg, sd, dev, gen)
    del sd
    train_launches = run_training(dev)
    check_f32_step(dev)

    # launches: each kernel's count over the path it serves, read right
    # after that path's run (upsample_int: the training path)
    rows = [("upsample_int", "basi_tpu_torch/csrc/upsample_int.cu",
             "basi_tpu/ops/pallas/upsample_int.py:65", ui,
             train_launches["upsample_int"]),
            ("upsample_int_bwd", "basi_tpu_torch/csrc/upsample_int_bwd.cu",
             "basi_tpu/ops/pallas/upsample_int.py:264", ub,
             train_launches["upsample_int_bwd"]),
            ("upsample_sigmoid", "basi_tpu_torch/csrc/upsample_sigmoid.cu",
             "basi_tpu/ops/pallas/upsample_sigmoid.py:42", us,
             serve_launches["upsample_sigmoid"]),
            ("normalize_and_flip", "basi_tpu_torch/csrc/normalize_aug.cu",
             "basi_tpu/ops/pallas/normalize_aug.py:47", nf,
             train_launches["normalize_and_flip"])]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": n, "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, src, rep, r, n in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
