"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions, then builds the CUDA kernels from ``basi_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once, for sm_90a, into
   ``build/kernels/``).
2. Holds each kernel against its plain PyTorch version on the card at every
   shape the serving and training paths give it, with times (CUDA events,
   after warm-up, and the kernels' device time, queued behind a spinning
   kernel so that no host time counts), all cold: each input rotates
   through copies larger than twice the L2 cache, and the plain version
   and the library call read the same copies:
   ``upsample_int`` within 1 bf16 ulp (at batch 8, timed, and at the
   eval batch of 16) and its backward
   within 1 bf16 ulp plus 2^-20 of the largest value (cancelling f32 sums),
   each bit for bit over two launches, ``upsample_sigmoid`` within 1e-5 and
   bit for bit over two launches (bf16 and f32 in, per served answer and
   per eval batch of 8 and of 16), ``normalize_and_flip`` bit-exact (bf16
   and f32 out,
   mixed flip flags), each of these two beside its bound and its output's
   write floor (``y.zero_()`` of the same size, device time), and
   ``torch.autograd.grad`` through ``resize_bilinear`` on the kernel
   route against the plain route.
   ``channel_moments`` and ``channel_dual_sums`` at the 12 (H*W, C) of
   ResNet-50's 53 BatchNorms at 512^2, batch 16, bf16, and at two shapes in
   f32: per channel within ``1e-5 * sum |term|`` of the plain version (f32
   sums of up to a million terms in another order), and two launches bit
   for bit equal; then the same kernels with the BatchNorm's per-channel
   math in their last block (``channel_means``, ``bn_forward_terms``,
   ``bn_backward_terms``) against that math in plain PyTorch on the
   kernels' own sums, each term within 1e-5 of its largest magnitude, and
   y and dx of the module's elementwise passes on them within 1 bf16 ulp
   (dx plus 2^-20 of its largest: its terms cancel). Their inputs rotate
   through copies larger than the L2 cache, so each call reads from device
   memory as the step's would. Last, the BatchNorm's elementwise passes
   (``bn_apply``, ``bn_input_gradient``) at the 12 shapes at batch 64, on
   the epilogues' terms: bit for bit equal to their plain versions and
   over two launches, timed cold beside the plain version, their bound (4
   and 6 bytes an element), ``torch.batch_norm_elemt`` /
   ``torch.batch_norm_backward_elemt`` and the host's time to enqueue one
   call (``check_bn_apply_kernels``).
3. Drives the serving path at full width: preset ``val_v4-8_ap`` (ResNet-50,
   512^2, bf16, batch 8) with seeded random weights, objectness bias 0 and
   non-trivial BN stats. A ``BatchedPredictor`` answers 16 concurrent
   requests (two batches), then ``full_res_masks`` runs on each answer. The
   outputs must be finite with filled slots, and the launch counters must
   show 9 ``upsample_int`` launches per forward and one ``upsample_sigmoid``
   launch per ``full_res_masks`` call. Prints ``predict_batch`` imgs/s. The
   same weights with ``model.bn_impl=fused`` give bit-equal outputs and
   launch no BatchNorm kernel (eval mode).
4. f32 check: the same weights through the port on the card (TF32 off) and
   on the CPU agree within 1e-3 on the model outputs (batch 1).
5. Drives the training path at full width: preset ``bench_accuracy`` as
   written (non-square scenes letterboxed by the port's numpy resize;
   ResNet-50, 512^2, bf16 compute with
   f32 params, batch 16, SGD + cosine + EMA), seeded weights, once for each
   ``model.bn_impl``: ``Trainer.train`` runs 4 steps of ``xla``, 4 of
   ``fused`` and 2 of ``stats``. Every step must launch
   ``normalize_and_flip`` once and ``upsample_int`` forward and backward 9
   times each, and per step 53 ``channel_moments``, 53
   ``channel_dual_sums``, 53 ``bn_apply`` and 53 ``bn_input_gradient``
   (fused), 53 ``channel_moments`` alone (stats), none (xla); the loss
   and metrics must be finite, and params, EMA and BN running statistics
   must move. ``Trainer`` and ``BatchedPredictor`` (phase 3) are called
   without a device: their default is the card. Then one repeated batch
   per setting (``train.warmup_steps=0``, ``train.lr=0.0025``, 28 steps)
   must bring the loss down (every loss of the second half below the
   first; ``repeated_batch_learns``); one more ``xla`` step counts the
   upsample_int backward calls that receive a cotangent that is not
   NHWC-contiguous and times their copies (``strided_cotangents``). The
   step's speed and its breakdown are ``perfbench/``'s to measure
   (``python3 perfbench/run.py --trace 1``). Last, the model at batch 4
   takes one forward and backward of the same batch in f32 on the card
   (TF32 off) in each setting and in float64 on the CPU: each f32 loss
   within 2e-5 relative of the float64 one, each f32 gradient within 5e-2
   of it in norm (f32 gradients of the early trunk layers are good to 1-2%
   at full width).
6. f32 step, card vs CPU: one train step of the tiny config (TF32 off) from
   the same weights and batch, for ``bn_impl`` xla and fused; loss and
   every gradient agree within 1e-3.
7. Evaluation: ``Inferencer.evaluate`` of ``bench_accuracy`` at full width
   in the original frame (``infer.ap_at_original=true``; the preset's
   non-square originals, so the paste is not the identity), 32 val images
   in 2 batches of 16, bf16, seeded weights; with the disk native-GT cache
   built beforehand in a temporary directory (the val set's packed GT on
   the device), once with ``infer.wf`` off and once on, then on without
   the cache. Each run:
   every metric finite, 32 images, 9 ``upsample_int`` and 1
   ``upsample_sigmoid`` launch per batch and nothing else; without the
   cache the same metrics. Prints the metrics, ``infer_ms_per_batch``,
   ``imgs_per_s`` and the wall clock per batch, then one batch traced by
   ``torch.profiler``: device ms by eval class (forward, selection,
   ``upsample_sigmoid``, IoU, paste, the SOD suite, the EDT) and the busy
   share. Then one f32 batch of 4 evaluated on the card and on the CPU
   (saliency means within 1e-4, AP/AR equal, full-resolution masks within
   1e-4, pixels binarized apart only that close to the threshold, every
   IoU of both frames within 1e-5 plus its slot's pixels binarized apart
   over its union, AP at IoU 0.02-0.2 equal and not 0);
   the paste (1e-6) and the SOD suite (1e-5) card against CPU at
   non-square extents on a 768 x 896 canvas; and a full-width ``Trainer``
   (no device given) whose ``train()`` runs its one epoch to the end and
   prints a ``[val]`` record of 8 images equal to ``Inferencer.evaluate``
   on the state's EMA weights.

8. The accuracy recipe's path (``basi_tpu_torch.tools.bench_accuracy``)
   at full width, in a temporary directory removed afterwards, the preset
   as written (scale 1.5): 64 train and 16 val scenes packed into shards
   (``pack_splits``), each record byte-equal to its synthetic sample, and
   the host feed's ms per batch from each; ``Trainer.train`` from the
   shards, 2 epochs of 4 steps with a checkpoint each epoch (8
   ``normalize_and_flip``, 9 ``upsample_int`` and 9 backward launches a
   step, 9 ``upsample_int`` and 1 ``upsample_sigmoid`` an eval batch); a
   second run stopped by the preemption flag after step 6, whose saved
   state loads back bit-equal (every tensor, step, generator), resumed by
   a new Trainer to step 8: the same batches, lr and generator state at
   steps 7 and 8 as the uninterrupted run, the last loss within 1e-3
   relative (cuDNN's weight gradients need not repeat bit for bit); then
   ``Inferencer(checkpoint=)`` equal to the Trainer's eval on the val
   shards, and ``run_final_eval`` (the 16 raw val images in the original
   frame, the paste not the identity) equal to the same EMA weights as a
   state dict. The f32 card-vs-CPU eval at non-square originals is phase
   7's, which runs the preset's scale now.
9. Image files (in a temporary directory removed afterwards), from the
   JPEG fixtures of ``tests/test_torch_fixtures/`` (made with Pillow, with
   the JAX package's decodes of them: 37 x 45 baseline 4:4:4, 4:2:0,
   4:2:2, grey, RGB-coded (an Adobe marker, transform 0) and progressive;
   photographs at 640 x 480 baseline 4:2:0, 640 x 427
   progressive 4:2:0 and 612 x 612 baseline 4:4:4) and PNGs written with
   ``write_png`` (rows filtered as libpng filters them by default). The
   decoder (``data/native.py``) prints its JPEG route and build; every
   JPEG fixture decodes to the JAX package's digest on the libjpeg route,
   within ``NVJPEG_MAX_ABS`` (3) levels a value and ``NVJPEG_MEAN_ABS``
   (0.1) on average on the nvjpeg route (nvJPEG's IDCT; libjpeg's
   upsampling and colour conversion in numpy), and the letterboxes of each reference
   decode to 64 and 512 give the reference's digests; every PNG reads
   back exactly; decode + letterbox imgs/s one by one and batched, for
   the PNG scenes, the photographs as JPEG and the same photographs as
   PNG. ``predict_paths`` at ``val_v4-8_ap`` (bf16, batch 8) on 16 PNG
   scenes from 300 x 200 to 1100 x 700, the three photographs and the
   grey JPEG (20 files: the last batch of 8 is padded) with a results
   file and PNGs: 9 ``upsample_int`` and 1 ``upsample_sigmoid`` a batch,
   every PNG at its image's size, one RLE entry per kept slot equal to
   that slot's pasted mask > 0.5, and the wall clock of a second call.
   The same in f32 on 4 files on the card and on the CPU: scores and
   pasted probabilities within 1e-3, RLE masks equal but where a
   probability lies within 1e-3 of 0.5. ``evaluate`` of
   ``bench_accuracy`` (batch 16, the original frame, the native-GT cache
   built first) on an ILSO-style folder of 32 scenes (scale 1.5) with
   labeled mask PNGs, every fourth a palette PNG whose colours are all
   one grey: in f32 on the card and on the CPU over the first 16 scenes,
   AP/AR equal and saliency means within 1e-4, and one batch of 4 held as
   phase 7 holds its own
   (masks, IoUs, AP at low IoU equal and not 0); then bf16 with 9
   ``upsample_int`` and 1 ``upsample_sigmoid`` a batch, beside phase 7's
   imgs/s, and the same on 32 photographs as JPEG files and as PNG
   files (the same pixels and masks), with ``FolderDataset.get_batch``
   timed for 16 images of each folder.
10. The entry points, at ``val_v4-8_ap`` full width, on phase 9's seeded
   weights written through ``python -m basi_tpu_torch.cli export --out``
   (each command a process of its own on the card): ``bench --mode
   infer``, ``--mode train`` (the preset's f32, and bf16) and ``--mode
   e2e`` at the reference's defaults, each JSON line printed with its
   launches per batch or step (9 ``upsample_int``; 1
   ``normalize_and_flip``; 9 + 9 + 1 in bf16), and a ``torch.profiler``
   window of the infer benchmark (device ms per batch, busy share); the
   HTTP server (``make_server`` on an ephemeral port) answering 64 POSTs
   of phase 9's PNG scenes and the JPEG photographs from 16 client
   threads of a process of their own: every answer 200, 9
   ``upsample_int`` a batch and 1 ``upsample_sigmoid`` a request, each
   label map and score list equal to ``predict_batch`` +
   ``full_res_masks`` of the same canvas on the card; latency
   p50/p90/p99, requests/s and the mean batch fill; ``/healthz`` 200, a
   bad body 400, a closed service 503; ``export --aot`` on the card, then
   ``load_serving`` in a fresh process: its outputs equal the live
   ``predict_batch`` bit for bit and a batch launches 9 ``upsample_int``
   kernels (profiler count and counter); ``serve --aot`` answering one
   request; ``predict`` and ``infer`` through the command line giving
   phase 9's PNGs, COCO results and folder metrics.
11. The rest of training, on preset ``train_multiscale_fused`` at full
   width (ResNet-50, FPN 256, bf16 on f32 masters, batch 16, 512², the
   scale jitter; ``data.dataset=synthetic``, 96 scenes): ``Trainer.train``
   on the default device takes 4 steps, each launching 1
   ``normalize_and_flip``, 9 ``upsample_int`` and 9 backward
   (``per_step_launches``), with finite losses and every param and BN
   statistic moved; then the epoch's other 2 steps and its eval (24 val
   images: 9 ``upsample_int`` and 1 ``upsample_sigmoid`` a batch) ending
   in a ``[val]`` record; ``basi-torch train --preset
   train_multiscale_fused`` as a process of its own (one epoch of 2 steps
   and its eval). Then each setting alone on the preset (``SETTINGS``:
   colour jitter 0.2,0.2,0.2; ``grad_accum=2``; ``freeze_bn`` under
   ``xla`` and ``fused``; AdamW; remat under ``xla`` and ``fused``; the
   dense loss; ``basnet_hybrid``; bf16 params) and the preset plain,
   first and last: 2 warm-up steps on one batch, then 5 steps timed by
   CUDA events with their launches (a micro-batch's; none of the BN
   kernels under a frozen trunk; ``channel_moments`` twice a BatchNorm
   under remat, its recompute) and the peak of
   ``torch.cuda.max_memory_allocated``, which remat must lower against
   the plain step; the plain step's device ms over every kernel and
   torch's profiler table (``_profile``). Last, one f32 step of the tiny
   config per setting on the card against the CPU, the same weights,
   batch and draws (``check_f32_step``; micro-batches of 4 images).

12. The roi mechanism (``model.instance_mechanism=roi``; seeded roi
   weights, objectness and ROI mask logits spread away from their ties,
   ``roi_smoke_weights``), each path driven with the counters set to 0
   just before it and read just after: serving at ``val_v4-8_ap``
   (ResNet-50, FPN 256, bf16, batch 8, 512^2, ``roi_top_k`` 64, R 28) on
   the default device, ``predict_batch`` + ``full_res_masks`` launching 9
   ``upsample_int`` and 1 ``upsample_sigmoid``, finite slots, ms per batch
   (CUDA events) and a profiled batch (``_profile``), the roi AOT
   artifact bit-equal to ``predict_batch``; f32 on the card (TF32 off)
   against the CPU at batch 2: proposals within 1e-5, the same slots,
   scores and masks within 1e-3 away from the pixels whose centre lies
   within 1e-5 of a box edge (``_edge_pixels``); ``bench_accuracy`` with
   roi under ``model.bn_impl`` xla and fused (``Trainer.train``, 2 steps
   with ``per_step_launches``'s launches, finite records, every param
   moved); ``evaluate``
   of ``bench_accuracy`` with roi in the original frame over 32 val
   images (9 ``upsample_int`` and 1 ``upsample_sigmoid`` a batch). Every
   kernel of the roi path must have launched on it.

13. The ConvNeXt-B trunk under the roi head (``run_convnext``): one
   serving batch of 8 at ``val_v4-8_ap`` (``predict_batch``: 9
   ``upsample_int``, finite slots) and two ``Trainer`` steps of
   ``bench_accuracy`` with AdamW (finite losses, every parameter moved,
   the peak memory).

Any failure raises and exits non-zero; so does a machine without CUDA or
a directory without the package. The line before the last is the
kernels' JSON record, ``{"kernels": [...]}``, one entry for each of the eight
kernels with ``name``, ``route`` ("cuda"), ``source`` (its ``.cu`` file),
``replaces`` (the TPU kernel's file:line), ``launches`` (on its path:
``upsample_int``, its backward and ``normalize_and_flip`` over the 4
``xla`` training steps, ``upsample_sigmoid`` over the serving run, the BN
kernels over the 4 ``fused`` steps), ``roi_launches`` (the same
kernel's counts on phase 12's roi paths, by path: ``serving``, the
``xla`` and ``fused`` training steps, ``eval``; paths that launched it
none are left out), ``max_abs_err`` (against its plain
version) and, per forward or step (nine ``upsample_int`` calls of a
serving forward, nine backward calls and one ``normalize_and_flip`` of a
training step, one ``upsample_sigmoid`` call, 53 calls of each BN
kernel: ``bn_stats``'s at batch 16, the elementwise passes' at 64),
``ms`` and ``plain_ms`` (CUDA events), ``device_ms`` (the kernels run
back to back, no host time), ``bound_ms`` and
``bound_by`` (compulsory bytes over 3.35 TB/s or f32 operations over 67
TFLOP/s, the larger, from this run's inputs) and ``library_ms`` (the one
PyTorch call that computes the same function: ``F.interpolate``, its
backward ``upsample_bilinear2d_backward``, ``torch.batch_norm_stats``,
``torch.batch_norm_backward_reduce``, ``torch.batch_norm_elemt``,
``torch.batch_norm_backward_elemt``; null where there is none). The last
line is ``{"ok": true, "device": {...}}``.
"""

import itertools
import json
import math
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
REQUESTS = 16
WARMUP, ITERS = 3, 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
L2_BYTES = 50e6


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


def _time_cold_ms(fn, args_list, iters=ITERS) -> float:
    """``_time_ms`` of ``fn(*args)`` cycling through ``args_list``, copies
    whose total exceeds the L2 cache: each call reads device memory."""
    args = itertools.cycle(args_list)
    return _time_ms(lambda: fn(*next(args)), iters)


def _device_ms(fn, args_list=((),), iters=ITERS) -> float:
    """Device ms per call of ``fn(*args)`` cycling through ``args_list``:
    CUDA events around ``iters`` calls queued behind a kernel that spins
    ~10 ms, so that the device runs them back to back and no host time
    between calls counts (``torch.profiler`` dropped kernels of some of
    many short traces on the card)."""
    args = itertools.cycle(args_list)
    for _ in range(WARMUP):
        fn(*next(args))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # cycles
    start.record()
    for _ in range(iters):
        fn(*next(args))
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _copies(base: torch.Tensor) -> list:
    """``base`` and clones of it, more than twice the L2 cache in all: a
    call that cycles through them reads device memory, as on the path,
    where other kernels have evicted its input."""
    n = max(2, math.ceil(2 * L2_BYTES / (base.numel() * base.element_size())))
    return [base] + [base.clone() for _ in range(n - 1)]


def _enqueue_us(fn, calls: int = 200) -> float:
    """Host microseconds to enqueue one call of ``fn()``: the host clock
    over ``calls`` calls, the device's work not waited for."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms, what bounds it): compulsory bytes over the memory rate or
    f32 operations over the f32 rate, the larger."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(tb, tf), "bytes" if tb >= tf else "operations"


def _bf16_ulp(want: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp (8 significant bits) at each value of f64 ``want``,
    2^(floor(log2 |want|) - 7), built from its exponent bits: ``2.0 ** e``
    in f64 on the card can come out one f64 ulp below the power of two."""
    _, e = torch.frexp(want.abs().clamp_min(2.0 ** -126))
    return ((e.to(torch.int64) + (1023 - 8)) << 52).view(torch.float64)


def _bf16_ulp_ok(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Every value within 1 bf16 ulp (8 significant bits) of ``want``."""
    want = want.double()
    return bool(((got.double() - want).abs() <= _bf16_ulp(want)).all())


def _bf16_sum_ok(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Within 1 bf16 ulp of ``want``, or within 2^-20 of its largest
    magnitude: an adjoint sums up to 4f^2 f32 terms, and where they cancel
    the rounding of the f32 sums (which another summation order places
    elsewhere) is larger than an ulp of the small result."""
    want = want.double()
    slack = 2.0 ** -20 * float(want.abs().max())
    return bool(((got.double() - want).abs() <= _bf16_ulp(want) + slack).all())


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW view of an NHWC-contiguous tensor (channels_last)."""
    return x.permute(0, 3, 1, 2)


def _check_upsample_int(x, f: int) -> float:
    """``upsample_int`` of bf16 ``x`` within 1 bf16 ulp of its plain
    version and bit for bit equal over two launches; its largest
    difference."""
    from basi_tpu_torch.kernels.upsample_int import (
        upsample_int,
        upsample_int_reference,
    )

    got, again = upsample_int(x, f), upsample_int(x, f)
    want = upsample_int_reference(x, f)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    what = f"upsample_int {tuple(x.shape)} x{f}"
    _require(_bf16_ulp_ok(got, want), f"{what}: beyond 1 bf16 ulp (max {err})")
    _require(torch.equal(got, again), f"{what}: two launches differ")
    return err


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
    ui = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
          "max_abs_err": 0.0, "bytes": 0.0, "flops": 0.0}
    for shape, f in shapes:
        xs = _copies(torch.randn(shape, generator=gen).to(dev, torch.bfloat16))
        x, args = xs[0], [(x, f) for x in xs]
        err = _check_upsample_int(x, f)
        n_out = x.numel() * f * f
        ms = _time_cold_ms(upsample_int, args)
        dev_ms = _device_ms(upsample_int, args)
        plain = _time_cold_ms(upsample_int_reference, args)
        lib = _time_cold_ms(lambda x, f: F.interpolate(
            _nchw(x), scale_factor=f, mode="bilinear", align_corners=False),
            args)
        print(f"upsample_int {shape} x{f}, cold: max_abs_err {err:.3e} "
              f"(<= 1 bf16 ulp), kernel {ms:.4f} ms ({dev_ms:.4f} device), "
              f"plain {plain:.4f} ms, F.interpolate {lib:.4f} ms")
        del xs, args
        ui["ms"] += ms
        ui["device_ms"] += dev_ms
        ui["plain_ms"] += plain
        ui["library_ms"] += lib
        ui["max_abs_err"] = max(ui["max_abs_err"], err)
        ui["bytes"] += 2 * (x.numel() + n_out)
        ui["flops"] += 7 * n_out  # 4 taps: 4 mul + 3 add per output
    # the forward of an eval (and training) batch of 16: checked, not timed
    for shape, f in TRAIN_RESIZES:
        x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        err = _check_upsample_int(x, f)
        ui["max_abs_err"] = max(ui["max_abs_err"], err)
    print("upsample_int at the nine shapes of a batch of 16: within 1 bf16 "
          "ulp, repeats bit for bit")

    # Per served answer (20 slots) and per eval batch (8 x 20 at the
    # default infer.batch_size, 16 x 20 under bench_accuracy); the serving
    # path hands it bf16 slot masks, and f32 input is checked too.
    us = {"max_abs_err": 0.0, "library_ms": None}
    for shape in SIGMOID_SHAPES:
        logits = torch.randn(shape, generator=gen) * 4
        out = torch.empty(shape[:-2] + (512, 512), device=dev)
        floor = _device_ms(out.zero_)
        del out
        for dtype in (torch.float32, torch.bfloat16):
            xs = _copies(logits.to(dev, dtype))
            x, args = xs[0], [(x, (512, 512)) for x in xs]
            got = upsample_sigmoid(x, (512, 512))
            again = upsample_sigmoid(x, (512, 512))
            want = upsample_sigmoid_reference(x, (512, 512))
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            _require(got.dtype == torch.float32 and err <= 1e-5,
                     f"upsample_sigmoid {shape} {dtype}: max_abs_err {err} "
                     "> 1e-5")
            _require(torch.equal(got, again),
                     f"upsample_sigmoid {shape} {dtype}: two launches differ")
            ms = _time_cold_ms(upsample_sigmoid, args)
            dev_ms = _device_ms(upsample_sigmoid, args)
            plain = _time_cold_ms(upsample_sigmoid_reference, args)
            nbytes = x.numel() * x.element_size() + 4 * got.numel()
            flops = 12 * got.numel()  # 7 for the taps, ~5 the sigmoid
            bound, _ = _bound(nbytes, flops)
            del xs, args, got, again, want
            print(f"upsample_sigmoid {shape} {dtype} -> 512^2 f32, cold: "
                  f"max_abs_err {err:.3e} (<= 1e-5, repeats bit for bit), "
                  f"kernel {ms:.4f} ms ({dev_ms:.4f} device), plain "
                  f"{plain:.4f} ms, bound {bound:.4f} ms "
                  f"({100 * bound / dev_ms:.0f}% on the device), write "
                  f"floor {floor:.4f} ms (y.zero_(), device)")
            us["max_abs_err"] = max(err, us["max_abs_err"])
            if shape == SIGMOID_RECORDED:  # in bf16 (last) it is recorded
                us.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                          bytes=nbytes, flops=flops)
    return ui, us


# (input NHWC, factor) of the nine bf16 resizes of a training or eval
# forward at batch 16 and 512^2: FPN x3, saliency towers x3, mask
# features x3.
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

    ub = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
          "max_abs_err": 0.0, "bytes": 0.0, "flops": 0.0}
    for (n, h, w, c), f in TRAIN_RESIZES:
        gs = _copies(torch.randn((n, f * h, f * w, c), generator=gen).to(
            dev, torch.bfloat16))
        g, args = gs[0], [(g, f) for g in gs]
        got, again = upsample_int_backward(g, f), upsample_int_backward(g, f)
        want = upsample_int_backward_reference(g, f)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        _require(_bf16_sum_ok(got, want),
                 f"upsample_int_bwd {(n, h, w, c)} x{f}: beyond 1 bf16 ulp "
                 f"+ 2^-20 of the largest (max {err})")
        _require(torch.equal(got, again),
                 f"upsample_int_bwd {(n, h, w, c)} x{f}: two launches differ")
        ms = _time_cold_ms(upsample_int_backward, args)
        dev_ms = _device_ms(upsample_int_backward, args)
        plain = _time_cold_ms(upsample_int_backward_reference, args)
        lib = _time_cold_ms(
            lambda g, f: torch.ops.aten.upsample_bilinear2d_backward(
                _nchw(g), [f * h, f * w], [n, c, h, w], False), args)
        print(f"upsample_int_bwd {(n, h, w, c)} x{f}, cold: max_abs_err "
              f"{err:.3e} (<= 1 bf16 ulp + 2^-20 max, repeats bit for bit), "
              f"kernel {ms:.4f} ms ({dev_ms:.4f} device), plain {plain:.4f} "
              f"ms, upsample_bilinear2d_backward {lib:.4f} ms")
        del gs, args
        ub["ms"] += ms
        ub["device_ms"] += dev_ms
        ub["plain_ms"] += plain
        ub["library_ms"] += lib
        ub["max_abs_err"] = max(ub["max_abs_err"], err)
        ub["bytes"] += 2 * (g.numel() + got.numel())
        ub["flops"] += 8 * g.numel()  # each cotangent feeds 4 taps

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
                 f"plain route (forward max diff "
                 f"{float((y - y_ref).abs().max())}, gradient "
                 f"{float((gx.float() - gx_ref.float()).abs().max())} of "
                 f"largest {float(gx_ref.float().abs().max())})")

    nf = {"max_abs_err": 0.0, "library_ms": None}
    imgs_all = _copies(torch.randint(0, 256, (16, 512, 512, 3), generator=gen,
                                     dtype=torch.uint8).to(dev))
    imgs = imgs_all[0]
    flip = (torch.arange(16) % 3 == 0).to(dev, torch.int32)  # mixed flags
    for dtype in (torch.float32, torch.bfloat16):
        got = normalize_and_flip(imgs, flip, out_dtype=dtype)
        want = normalize_and_flip_reference(imgs, flip, out_dtype=dtype)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        _require(got.dtype == dtype and torch.equal(got, want),
                 f"normalize_and_flip {dtype}: not bit-exact (max {err})")
        args = [(im, flip, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225),
                 dtype) for im in imgs_all]
        ms = _time_cold_ms(normalize_and_flip, args)
        dev_ms = _device_ms(normalize_and_flip, args)
        plain = _time_cold_ms(normalize_and_flip_reference, args)
        print(f"normalize_and_flip (16, 512, 512, 3) u8 -> {dtype}, mixed "
              f"flags, cold: max_abs_err {err:.3e} (bit-exact), kernel "
              f"{ms:.4f} ms ({dev_ms:.4f} device), plain {plain:.4f} ms")
        nbytes = imgs.numel() + got.numel() * got.element_size()
        bound, _ = _bound(nbytes, 3 * got.numel())
        out = torch.empty_like(got)
        floor = _device_ms(out.zero_)
        del out
        print(f"normalize_and_flip u8 -> {dtype}: bound {bound:.4f} ms "
              f"({100 * bound / dev_ms:.0f}% on the device), write floor "
              f"{floor:.4f} ms (y.zero_(), device)")
        # the path's dtype (bf16, last) gives the recorded times
        nf.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                  max_abs_err=max(err, nf["max_abs_err"]), bytes=nbytes,
                  flops=3 * got.numel())
    return ub, nf


# (H*W, C) of ResNet-50's 53 BatchNorms at 512^2 and how many layers have
# each: the stem; layer1 (3 blocks); layer2 (4); layer3 (6); layer4 (3).
BN_SHAPES = [((65536, 64), 1), ((16384, 64), 6), ((16384, 256), 4),
             ((16384, 128), 1), ((4096, 128), 7), ((4096, 512), 5),
             ((4096, 256), 1), ((1024, 256), 11), ((1024, 1024), 7),
             ((1024, 512), 1), ((256, 512), 5), ((256, 2048), 4)]
BN_BATCH = 16
BN_F32_SHAPES = [(16384, 64), (256, 2048)]


def _activations(gen, dev, hw: int, c: int, dtype, loc: float = 0.0):
    """Copies of one (16, H, W, C) NHWC input, more than the L2 cache
    holds."""
    side = math.isqrt(hw)
    return _copies((torch.randn((BN_BATCH, side, side, c), generator=gen) * 2
                    + loc).to(dev, dtype))


def _sums_ok(got, want, absum) -> bool:
    """Per channel within 1e-5 of the sum of the terms' magnitudes."""
    return all(bool(((g.double() - w.double()).abs()
                     <= 1e-5 * a.double()).all())
               for g, w, a in zip(got, want, absum))


def _bn_stats_library(g, x, zero, one):
    """(sum g, sum g*x) in one PyTorch call: the BatchNorm backward's
    reduction with mean 0 and invstd 1."""
    return torch.batch_norm_backward_reduce(
        _nchw(g), _nchw(x), zero, one, None, True, False, False)[:2]


def _terms_err(got, want) -> float:
    """The largest difference of a term from its plain counterpart, over
    the largest magnitude of that term's plain row."""
    return max(float((g.double() - w.double()).abs().max())
               / max(float(w.double().abs().max()), 1e-30)
               for g, w in zip(got, want))


# BN entry points: the two sums, then the epilogues (means and BN forward
# on the channel_moments kernel, BN backward on channel_dual_sums)
BN_ENTRIES = ("channel_moments", "channel_dual_sums", "channel_means",
              "bn_forward_terms", "bn_backward_terms")


def check_bn_kernels(dev, gen):
    """Phase 2, fused BatchNorm: channel_moments and channel_dual_sums at
    the 12 BN shapes of a ResNet-50 step (bf16) and two in f32, the sums and
    the three BN epilogues; returns the per-step records (53 calls each)
    of the two sums, with the epilogues' totals printed."""
    from basi_tpu_torch.kernels import bn_apply as A
    from basi_tpu_torch.kernels import bn_stats as B

    recs = {k: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                "library_ms": 0.0, "max_abs_err": 0.0, "bytes": 0.0,
                "flops": 0.0} for k in BN_ENTRIES}
    cases = [((hw, c), n, torch.bfloat16) for (hw, c), n in BN_SHAPES]
    cases += [(s, 0, torch.float32) for s in BN_F32_SHAPES]
    for (hw, c), layers, dtype in cases:
        xs = _activations(gen, dev, hw, c, dtype, loc=0.5)
        gs = _activations(gen, dev, hw, c, dtype)
        zero = torch.zeros(c, device=dev)
        one = torch.ones(c, device=dev)
        scale = torch.linspace(0.5, 1.5, c, device=dev)
        bias = torch.linspace(-1.0, 1.0, c, device=dev)
        m = BN_BATCH * hw
        xf, gf = xs[0].float(), gs[0].float()
        nbytes = xs[0].numel() * xs[0].element_size()
        sums = {
            "channel_moments": (
                B.channel_moments, B.channel_moments_reference,
                [(x,) for x in xs],
                lambda x: torch.batch_norm_stats(_nchw(x), 1e-5),
                [(x,) for x in xs],
                (xf.abs().sum((0, 1, 2)), (xf * xf).sum((0, 1, 2))),
                nbytes + 8 * c),
            "channel_dual_sums": (
                B.channel_dual_sums, B.channel_dual_sums_reference,
                list(zip(gs, xs)), _bn_stats_library,
                [(g, x, zero, one) for g, x in zip(gs, xs)],
                (gf.abs().sum((0, 1, 2)), (gf * xf).abs().sum((0, 1, 2))),
                2 * nbytes + 8 * c)}
        del xf, gf
        flops = 3 * xs[0].numel()  # add; multiply, add
        got_sums = {}
        for name, (fn, plain_fn, args, lib_fn, lib_args, absum,
                   io_bytes) in sums.items():
            got, again = fn(*args[0]), fn(*args[0])
            want = plain_fn(*args[0])
            torch.cuda.synchronize()
            got_sums[name] = got
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            what = f"{name} ({BN_BATCH}x{hw}, {c}) {dtype}"
            _require(_sums_ok(got, want, absum),
                     f"{what}: beyond 1e-5 * sum|term| (max diff {err})")
            _require(all(torch.equal(a, b) for a, b in zip(got, again)),
                     f"{what}: two launches differ")
            if name == "channel_dual_sums":
                _require(_sums_ok(lib_fn(*lib_args[0]), want, absum),
                         f"{what}: batch_norm_backward_reduce does not give "
                         "(sum g, sum g*x)")
            ms = _time_cold_ms(fn, args)
            dev_ms = _device_ms(fn, args)
            plain = _time_cold_ms(plain_fn, args)
            lib = _time_cold_ms(lib_fn, lib_args)
            bound, _ = _bound(io_bytes, flops)
            print(f"{what}: max_abs_err {err:.3e} (<= 1e-5 sum|term|, "
                  f"repeats bit for bit), kernel {ms:.4f} ms ({dev_ms:.4f} "
                  f"device), plain {plain:.4f} ms, "
                  f"library {lib:.4f} ms, bound {bound:.4f} ms")
            r = recs[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if layers:  # one step: each layer of this shape calls once
                for k, v in (("ms", ms), ("device_ms", dev_ms),
                             ("plain_ms", plain), ("library_ms", lib),
                             ("bytes", io_bytes), ("flops", flops)):
                    r[k] += layers * v

        # the epilogues, against the plain math on the kernel's own sums
        (sx, sx2), (sg, sgx) = (got_sums["channel_moments"],
                                got_sums["channel_dual_sums"])
        want_fwd = B.bn_forward_math(sx / m, sx2 / m, scale, bias, 1e-5)
        mean, inv = want_fwd[0], want_fwd[2]
        terms = {
            "channel_means": (B.channel_means, B.channel_means_reference,
                              [(x,) for x in xs], (sx / m, sx2 / m),
                              nbytes + 8 * c),
            "bn_forward_terms": (
                B.bn_forward_terms, B.bn_forward_terms_reference,
                [(x, scale, bias, 1e-5) for x in xs], want_fwd,
                nbytes + 28 * c),
            "bn_backward_terms": (
                B.bn_backward_terms, B.bn_backward_terms_reference,
                [(g, x, scale, mean, inv) for g, x in zip(gs, xs)],
                B.bn_backward_math(sg, sgx, m, scale, mean, inv),
                2 * nbytes + 32 * c)}
        got_terms, line = {}, []
        for name, (fn, plain_fn, args, want, io_bytes) in terms.items():
            got, again = fn(*args[0]), fn(*args[0])
            torch.cuda.synchronize()
            got_terms[name] = got
            err = _terms_err(got, want)
            what = f"{name} ({BN_BATCH}x{hw}, {c}) {dtype}"
            _require(err <= 1e-5, f"{what}: a term beyond 1e-5 of its largest "
                     f"magnitude ({err:.3e})")
            _require(all(torch.equal(a, b) for a, b in zip(got, again)),
                     f"{what}: two launches differ")
            ms = _time_cold_ms(fn, args)
            dev_ms = _device_ms(fn, args)
            plain = _time_cold_ms(plain_fn, args)
            line.append(f"{name} {ms:.4f} ms ({dev_ms:.4f} device, plain "
                        f"{plain:.4f}, terms within {err:.1e})")
            r = recs[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if layers:
                for k, v in (("ms", ms), ("device_ms", dev_ms),
                             ("plain_ms", plain), ("bytes", io_bytes),
                             ("flops", flops)):
                    r[k] += layers * v
        # the module's elementwise kernels on them, against the plain
        # passes on the plain terms
        xn, gn = _nchw(xs[0]), _nchw(gs[0])
        fwd, bwd = got_terms["bn_forward_terms"], got_terms["bn_backward_terms"]
        want_bwd = terms["bn_backward_terms"][3]
        _require(_bf16_ulp_ok(A.bn_apply(xn, *fwd[3:]),
                              A.bn_apply_reference(xn, *want_fwd[3:])),
                 f"({BN_BATCH}x{hw}, {c}) {dtype}: y beyond 1 bf16 ulp")
        _require(_bf16_sum_ok(
            A.bn_input_gradient(gn, xn, mean, *bwd[2:]),
            A.bn_input_gradient_reference(gn, xn, mean, *want_bwd[2:])),
            f"({BN_BATCH}x{hw}, {c}) {dtype}: dx beyond 1 bf16 ulp + "
            "2^-20 of the largest")
        print(f"epilogues ({BN_BATCH}x{hw}, {c}) {dtype}: {'; '.join(line)}; "
              "y within 1 bf16 ulp, dx within 1 bf16 ulp + 2^-20 max, "
              "repeat bit for bit")
        del xs, gs, sums, terms, got_terms, fwd, bwd, xn, gn
        torch.cuda.empty_cache()
    for name, r in recs.items():
        lib = (f", library {r['library_ms']:.4f} ms" if name in got_sums
               else "")
        print(f"{name}, one step's 53 calls (bf16): kernel {r['ms']:.4f} ms "
              f"({r['device_ms']:.4f} device), plain {r['plain_ms']:.4f} ms"
              f"{lib}, bound {_bound(r['bytes'], r['flops'])[0]:.4f} ms "
              f"({r['bytes'] / 1e9:.3f} GB)")
    for name, lib in (("channel_moments", "torch.batch_norm_stats"),
                      ("channel_dual_sums", "torch.batch_norm_backward_reduce")):
        r = recs[name]
        print(f"{name} against {lib}, 53 calls by events: {r['ms']:.4f} "
              f"against {r['library_ms']:.4f} ms "
              f"({'faster' if r['ms'] < r['library_ms'] else 'not faster'})")
    return recs["channel_moments"], recs["channel_dual_sums"]


# the batch of the elementwise passes' step: the benchmark's (64)
BN_APPLY_BATCH = 64


def check_bn_apply_kernels(dev, gen):
    """Phase 2, the fused BatchNorm's elementwise passes: ``bn_apply`` and
    ``bn_input_gradient`` at the 12 BN shapes of a ResNet-50 step at batch
    64 (bf16), on the terms of the ``bn_stats`` epilogues: bit for bit
    equal to their plain versions and over two launches; then each timed
    cold (CUDA events and device time), beside the plain version, the
    bound (4 and 6 bytes an element over 3.35 TB/s) and the library's
    ``torch.batch_norm_elemt`` / ``torch.batch_norm_backward_elemt`` (a
    yardstick; the port never calls them). Returns the per-step records
    (53 calls each)."""
    from basi_tpu_torch.kernels import bn_apply as A
    from basi_tpu_torch.kernels import bn_stats as B

    recs = {k: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                "library_ms": 0.0, "max_abs_err": 0.0, "bytes": 0.0,
                "flops": 0.0} for k in ("bn_apply", "bn_input_gradient")}
    dgen = torch.Generator(device=dev).manual_seed(SEED)
    for (hw, c), layers in BN_SHAPES:
        side = math.isqrt(hw)
        shape = (BN_APPLY_BATCH, side, side, c)
        x = torch.randn(shape, generator=dgen, device=dev).mul_(2).add_(0.5)
        g = torch.randn(shape, generator=dgen, device=dev)
        xs = [_nchw(t) for t in _copies(x.to(torch.bfloat16))]
        gs = [_nchw(t) for t in _copies(g.to(torch.bfloat16))]
        del x, g
        scale = torch.linspace(0.5, 1.5, c, device=dev)
        bias = torch.linspace(-1.0, 1.0, c, device=dev)
        mean, _, inv, a, b = B.bn_forward_terms(
            xs[0].permute(0, 2, 3, 1), scale, bias, 1e-5)
        _, sg, _, a_mg, k = B.bn_backward_terms(
            gs[0].permute(0, 2, 3, 1), xs[0].permute(0, 2, 3, 1), scale,
            mean, inv)
        sgxmu = B.channel_dual_sums(gs[0].permute(0, 2, 3, 1),
                                    xs[0].permute(0, 2, 3, 1))[1] - mean * sg
        count = torch.full((1,), xs[0].numel() // c, dtype=torch.int32,
                           device=dev)
        n = xs[0].numel()
        cases = {
            # the library: (x - mean) * inv * scale + bias, the same y
            "bn_apply": (A.bn_apply, A.bn_apply_reference,
                         [(x, a, b) for x in xs], torch.batch_norm_elemt,
                         [(x, scale, bias, mean, inv, 1e-5) for x in xs],
                         4 * n + 8 * c, 2 * n),
            "bn_input_gradient": (
                A.bn_input_gradient, A.bn_input_gradient_reference,
                [(g, x, mean, a, a_mg, k) for g, x in zip(gs, xs)],
                torch.batch_norm_backward_elemt,
                [(g, x, mean, inv, scale, sg, sgxmu, count)
                 for g, x in zip(gs, xs)],
                6 * n + 16 * c, 5 * n)}
        line = []
        for name, (fn, plain_fn, args, lib_fn, lib_args, io_bytes,
                   flops) in cases.items():
            got, again = fn(*args[0]), fn(*args[0])
            want = plain_fn(*args[0])
            torch.cuda.synchronize()
            what = f"{name} ({BN_APPLY_BATCH}x{hw}, {c}) bf16"
            err = float((got.float() - want.float()).abs().max())
            _require(torch.equal(got, want), f"{what}: not bit for bit "
                     f"equal to the plain version (max diff {err})")
            _require(torch.equal(got, again), f"{what}: two launches differ")
            del got, again, want
            ms = _time_cold_ms(fn, args)
            dev_ms = _device_ms(fn, args)
            plain = _time_cold_ms(plain_fn, args)
            try:
                lib = _time_cold_ms(lib_fn, lib_args)
            except (RuntimeError, TypeError) as e:
                print(f"{what}: library call refused ({e})")
                lib = float("nan")
            bound, _ = _bound(io_bytes, flops)
            line.append(f"{name} {ms:.4f} ms ({dev_ms:.4f} device, "
                        f"{100 * bound / dev_ms:.0f}% of the bound "
                        f"{bound:.4f}), plain {plain:.4f}, library "
                        f"{lib:.4f}, host enqueue "
                        f"{_enqueue_us(lambda: fn(*args[0])):.1f} us (plain "
                        f"{_enqueue_us(lambda: plain_fn(*args[0]), 20):.1f})")
            r = recs[name]
            for key, v in (("ms", ms), ("device_ms", dev_ms),
                           ("plain_ms", plain), ("library_ms", lib),
                           ("bytes", io_bytes), ("flops", flops)):
                r[key] += layers * v
        print(f"({BN_APPLY_BATCH}x{hw}, {c}) bf16, {layers} layers, equal "
              f"to the plain passes bit for bit: {'; '.join(line)}")
        del xs, gs, cases
        torch.cuda.empty_cache()
    for name, r in recs.items():
        bound = _bound(r["bytes"], r["flops"])[0]
        print(f"{name}, one step's 53 calls at batch {BN_APPLY_BATCH} "
              f"(bf16), cold: kernel {r['ms']:.4f} ms ({r['device_ms']:.4f} "
              f"device, {100 * bound / r['device_ms']:.1f}% of the bound), "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
              f"ms, bound {bound:.4f} ms ({r['bytes'] / 1e9:.3f} GB)")
        if math.isnan(r["library_ms"]):
            r["library_ms"] = None
    return recs["bn_apply"], recs["bn_input_gradient"]


# (N, C, H, W) of ConvNeXt-B's depthwise convs at the cell's batch and
# 512^2, and the blocks of each (3, 3, 27, 3: 36 calls a forward)
DWCONV_SHAPES = [((64, 128, 128, 128), 3), ((64, 256, 64, 64), 3),
                 ((64, 512, 32, 32), 27), ((64, 1024, 16, 16), 3)]


def dwconv_tolerance(truth: torch.Tensor, absum: torch.Tensor,
                     depth: int) -> torch.Tensor:
    """What a kernel of ``kernels/dwconv.py`` may differ from the exact
    (f64) result ``truth`` of its bf16 inputs: one bf16 ulp of it (the one
    rounding, and a binade crossed) plus ``depth`` f32 roundings of the sum
    of the terms' magnitudes ``absum``, f32 sums at most ``depth`` terms
    deep."""
    return _bf16_ulp(truth) + depth * 2.0 ** -24 * absum


def dwconv_truth(x, w, b, g):
    """(y, dx, dw, db) of the depthwise conv in f64 from bf16 ``x``, ``w``,
    ``b`` and the cotangent ``g``, and the same of the terms' magnitudes."""
    from basi_tpu_torch.kernels import dwconv as D

    def parts(x, w, b, g):
        y = D.dwconv_forward_reference(x, w, b)
        dx = D.dwconv_input_grad_reference(g, w)
        dw, db = D.dwconv_weight_grad_reference(g, x)
        return y, dx, dw, db

    x, w, b, g = (t.double() for t in (x, w, b, g))
    return (parts(x, w, b, g),
            parts(x.abs(), w.abs(), b.abs(), g.abs()))


def check_dwconv_kernels(dev, gen):
    """Phase 2, ConvNeXt-B's depthwise 7x7 convolution (``kernels/
    dwconv.py``): at the four stage shapes of the cell (batch 64, bf16)
    the forward, the input gradient and the weight and bias gradients
    against the f64 result of the same bf16 inputs within
    ``dwconv_tolerance``, and two launches bit for bit equal; then each
    timed cold (CUDA events and device time) beside the plain version,
    which on the card is the library's call (``F.conv2d`` with
    ``groups=C``; ``torch.ops.aten.convolution_backward`` for the
    gradients), and the bound: 4 bytes and 98 f32 operations an element
    for each of the three (the forward reads x and writes y, the input
    gradient reads g and writes dx, the weight gradient reads g and x).
    Returns the per-step records (36 calls of each)."""
    from basi_tpu_torch.kernels import dwconv as D

    names = ("dwconv_forward", "dwconv_input_grad", "dwconv_weight_grad")
    recs = {k: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                "library_ms": 0.0, "max_abs_err": 0.0, "bytes": 0.0,
                "flops": 0.0} for k in names}
    dgen = torch.Generator(device=dev).manual_seed(SEED)
    for (n, c, h, w), blocks in DWCONV_SHAPES:
        def act():
            return torch.randn((n, h, w, c), generator=dgen, device=dev
                               ).to(torch.bfloat16).permute(0, 3, 1, 2)

        x, g = act(), act()
        wt = (torch.randn((c, 1, 7, 7), generator=dgen, device=dev)
              / 7).to(torch.bfloat16)
        b = torch.randn((c,), generator=dgen, device=dev).to(torch.bfloat16)
        what = f"dwconv ({n}, {c}, {h}, {w}) bf16"
        got = (D.dwconv_forward(x, wt, b), D.dwconv_input_grad(g, wt),
               *D.dwconv_weight_grad(g, x))
        again = (D.dwconv_forward(x, wt, b), D.dwconv_input_grad(g, wt),
                 *D.dwconv_weight_grad(g, x))
        (truth, absum) = dwconv_truth(x, wt, b, g)
        depth = D.weight_grad_depth(x.shape, *D.launch_plan(True, x))
        errs = []
        for name, a, a2, t, s, dep in zip(
                ("y", "dx", "dw", "db"), got, again, truth, absum,
                (50, 50, depth, depth)):
            _require(torch.equal(a, a2), f"{what}: {name} of two launches "
                     "differ")
            err = (a.double() - t).abs()
            _require(bool((err <= dwconv_tolerance(t, s, dep)).all()),
                     f"{what}: {name} beyond its tolerance (max diff "
                     f"{float(err.max())})")
            errs.append(float(err.max()))
        del got, again, truth, absum
        for name, e in zip(names, (errs[0], errs[1], max(errs[2:]))):
            recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], e)
        xs, gs = _copies(x), _copies(g)
        elems = n * c * h * w

        def library(mask):
            return lambda g, x: torch.ops.aten.convolution_backward(
                g, x, wt, [c], [1, 1], [3, 3], [1, 1], False, [0, 0], c, mask)

        cases = {
            "dwconv_forward": (
                lambda g, x: D.dwconv_forward(x, wt, b),
                lambda g, x: F.conv2d(x, wt, b, padding=3, groups=c)),
            "dwconv_input_grad": (lambda g, x: D.dwconv_input_grad(g, wt),
                                  library([True, False, False])),
            "dwconv_weight_grad": (D.dwconv_weight_grad,
                                   library([False, True, True]))}
        line = []
        for name, (fn, lib_fn) in cases.items():
            args = list(zip(gs, xs))
            ms = _time_cold_ms(fn, args)
            dev_ms = _device_ms(fn, args)
            lib = _time_cold_ms(lib_fn, args)
            io_bytes, flops = 4 * elems + 100 * c, 98 * elems
            bound, _ = _bound(io_bytes, flops)
            line.append(f"{name} {ms:.4f} ms ({dev_ms:.4f} device, "
                        f"{100 * bound / dev_ms:.0f}% of the bound "
                        f"{bound:.4f}), library (the plain version) "
                        f"{lib:.4f}")
            r = recs[name]
            for key, v in (("ms", ms), ("device_ms", dev_ms),
                           ("plain_ms", lib), ("library_ms", lib),
                           ("bytes", io_bytes), ("flops", flops)):
                r[key] += blocks * v
        print(f"{what}, {blocks} blocks, within the tolerance of the f64 "
              f"result (max diff y, dx, dw, db {errs}): {'; '.join(line)}")
        del x, g, xs, gs, cases
        torch.cuda.empty_cache()
    for name, r in recs.items():
        bound = _bound(r["bytes"], r["flops"])[0]
        print(f"{name}, one step's 36 calls at batch 64 (bf16), cold: "
              f"kernel {r['ms']:.4f} ms ({r['device_ms']:.4f} device, "
              f"{100 * bound / r['device_ms']:.1f}% of the bound), library "
              f"(the plain version) {r['library_ms']:.4f} ms, bound "
              f"{bound:.4f} ms ({r['bytes'] / 1e9:.3f} GB)")
    return tuple(recs[k] for k in names)


# (masks, h, w) of upsample_sigmoid's calls on the path, to 512^2: the
# slots of one served answer, of an eval batch at the default
# infer.batch_size (8) and of one under bench_accuracy (16); the times of
# the batch of 8 go into the kernels line
SIGMOID_SHAPES = [(20, 128, 128), (8, 20, 128, 128), (16, 20, 128, 128)]
SIGMOID_RECORDED = (8, 20, 128, 128)

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


def _counters() -> dict:
    """Each kernel wrapper of the port, by name (each carries ``launches``)."""
    from basi_tpu_torch.kernels import launch_counters

    return launch_counters()


def _zero_kernel_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _kernel_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def run_slice(cfg, sd, dev, gen):
    """Phase 3: the BatchedPredictor at full width; returns launch counts."""
    from basi_tpu_torch.serve import BatchedPredictor

    size, k = cfg.model.image_size, cfg.model.num_slots
    images = torch.randint(0, 256, (REQUESTS, size, size, 3), generator=gen,
                           dtype=torch.uint8).numpy()
    # the default device: the entry point's own choice of the card
    p = BatchedPredictor(cfg, max_wait_ms=5000, state_dict=sd)
    try:
        _require(p.inf.device == dev, f"BatchedPredictor ran on {p.inf.device}")
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
        _zero_kernel_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        fulls = [p.inf.full_res_masks(
            torch.from_numpy(pr.masks).to(dev, p.inf.dtype)) for pr in preds]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _kernel_counts()
        del p.inf.predict_batch

        _require(all(pr is not None for pr in preds), "a request got no answer")
        print(f"served {REQUESTS} requests in {len(forwards)} batches "
              f"{forwards} in {wall:.3f} s (first-call set-up included); "
              f"launches {launches}")
        _require(forwards == [cfg.infer.batch_size] * 2,
                 f"expected two full batches, got {forwards}")
        _require(launches == dict(_zero_counts(),
                                  upsample_int=9 * len(forwards),
                                  upsample_sigmoid=len(fulls)),
                 f"expected 9 upsample_int launches per forward x "
                 f"{len(forwards)} and one upsample_sigmoid per "
                 f"full_res_masks call ({len(fulls)}), nothing else; got "
                 f"{launches}")
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
        check_serving_bn_impl(cfg, sd, dev, p.inf, batch)
    finally:
        p.close()
    return launches


def _zero_counts() -> dict:
    return {name: 0 for name in _counters()}


def check_serving_bn_impl(cfg, sd, dev, xla_inf, batch) -> None:
    """Phase 3: serving with ``model.bn_impl=fused`` is the same program in
    eval mode: bit-equal outputs, no BatchNorm kernel launched."""
    import dataclasses

    from basi_tpu_torch.infer import Inferencer

    fcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, bn_impl="fused"))
    inf = Inferencer(fcfg, device=dev, state_dict=sd)
    _zero_kernel_counts()
    with torch.inference_mode():
        got, want = inf.apply_model(batch), xla_inf.apply_model(batch)
    torch.cuda.synchronize()
    n = _kernel_counts()
    _require(n["channel_moments"] == n["channel_dual_sums"] == n["bn_apply"]
             == n["bn_input_gradient"] == 0,
             f"eval mode launched a BatchNorm kernel: {n}")
    _require(all(torch.equal(getattr(got, k), getattr(want, k)) for k in
                 ("saliency_logits", "cell_scores", "cell_kernels",
                  "mask_feats")),
             "serving with bn_impl=fused differs from xla")
    print("serving with model.bn_impl=fused: outputs bit-equal to xla, no "
          "BatchNorm kernel launched")


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


TRAIN_OVERRIDES = ["train.log_every=1"]
# steps of Trainer.train per model.bn_impl, and the launches of each step
PATH_STEPS = {"xla": 4, "fused": 4, "stats": 2}
BN_LAYERS = 53
PER_STEP = {
    impl: {"upsample_int": 9, "upsample_int_bwd": 9, "upsample_sigmoid": 0,
           "normalize_and_flip": 1,
           "channel_moments": BN_LAYERS if impl != "xla" else 0,
           "channel_dual_sums": BN_LAYERS if impl == "fused" else 0,
           "bn_apply": BN_LAYERS if impl == "fused" else 0,
           "bn_input_gradient": BN_LAYERS if impl == "fused" else 0}
    for impl in PATH_STEPS}
# The repeated batch's step size, a quarter of the preset's peak: at the
# peak with no warmup one repeated batch spikes in every bn_impl, in f32 as
# in bf16, at times back above its first loss.
REPEATED_LR = 0.0025
REPEATED_STEPS = 28


def run_training(dev, bn_impl: str) -> dict:
    """Phase 5: ``Trainer.train`` at full width with ``model.bn_impl``;
    returns the launch counts of its steps."""
    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.train.loop import Trainer

    steps = PATH_STEPS[bn_impl]
    cfg = get_config("bench_accuracy",
                     TRAIN_OVERRIDES + [f"model.bn_impl={bn_impl}"])
    trainer = Trainer(cfg)  # the default device, the card
    _require(trainer.device == dev, f"Trainer ran on {trainer.device}")
    model = trainer.state.model
    params0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    ema0 = {k: v.clone() for k, v in trainer.state.ema.items()}
    stats0 = {k: b.clone() for k, b in model.named_buffers()
              if k.endswith(("running_mean", "running_var"))}
    _zero_kernel_counts()
    t0 = time.perf_counter()
    trainer.train(max_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    print(f"trained {steps} steps of bench_accuracy, model.bn_impl={bn_impl} "
          f"({cfg.model.backbone}, {cfg.model.image_size}^2, "
          f"{cfg.model.dtype}, batch {cfg.data.batch_size}) in {wall:.2f} s, "
          f"host feed and first-call set-up included; launches {launches}")
    want = {k: n * steps for k, n in PER_STEP[bn_impl].items()}
    _require(launches == want,
             f"bn_impl={bn_impl}: expected {PER_STEP[bn_impl]} launches per "
             f"step over {steps} steps, got {launches}")
    recs = trainer.records
    _require(len(recs) == steps, f"{len(recs)} [train] records")
    for r in recs:
        _require(all(np.isfinite(v) for v in r.values()),
                 f"non-finite [train] record {r}")
    print(f"losses {[round(r['loss'], 4) for r in recs]}; lr at step "
          f"{steps} {recs[-1]['lr']:.3e}")

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
    return launches


def repeated_batch_learns(dev) -> None:
    """Phase 5: one repeated batch per ``model.bn_impl``, ``REPEATED_STEPS``
    steps at ``REPEATED_LR`` with no warmup, then one more ``xla`` step in
    ``strided_cotangents``; every loss of the second half must lie below
    the first."""
    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.train.loop import Trainer

    for impl in PATH_STEPS:
        cfg = get_config("bench_accuracy", TRAIN_OVERRIDES + [
            f"model.bn_impl={impl}", "train.warmup_steps=0",
            f"train.lr={REPEATED_LR}"])
        trainer = Trainer(cfg, device=dev)
        feed = trainer.feed.epoch(0)
        batch = next(feed)
        feed.close()  # stops the feed thread: nothing runs beside the steps
        losses = [trainer.train_step(trainer.state, batch)["loss"]
                  for _ in range(REPEATED_STEPS)]
        if impl == "xla":
            strided_cotangents(dev, trainer, batch, losses)
        losses = [float(v) for v in losses]
        print(f"repeated batch, bn_impl={impl}, {len(losses)} steps, losses "
              f"{[round(v, 4) for v in losses]}")
        _require(all(np.isfinite(losses))
                 and max(losses[len(losses) // 2:]) < losses[0],
                 f"bn_impl={impl}: the loss did not fall over the "
                 "repeated-batch steps")
        del trainer, batch
        torch.cuda.empty_cache()


# batch of the f32 check: the CPU's float64 reference fits at full width
F32_BATCH = 4


def check_bn_impls_agree(dev) -> None:
    """Phase 5, f32 against float64: the full-width model at batch
    ``F32_BATCH``, the same weights, batch and flips; one forward and
    backward in f32 on the card (TF32 off) in each ``model.bn_impl``, and in
    float64 on the CPU (``xla``). Each f32 loss lies within 2e-5 relative of
    the float64 one, and each f32 gradient (all params as one vector) within
    5e-2 of it in norm. The bound is loose because the early trunk layers'
    f32 gradients are good to only 1-2% at full width, in every setting
    (rounding amplified by the step, as in the tiny model); a wrong BN
    backward misses by the gradient's own size."""
    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.train.loop import Trainer
    from basi_tpu_torch.train.step import draw_augment, loss_and_grads

    def grads(impl, device, dtype):
        cfg = get_config("bench_accuracy", TRAIN_OVERRIDES + [
            f"model.bn_impl={impl}", "model.dtype=float32",
            f"data.batch_size={F32_BATCH}"])
        trainer = Trainer(cfg, device=device)
        feed = trainer.feed.epoch(0)
        batch = next(feed)
        feed.close()
        draws = draw_augment(trainer.state, F32_BATCH, cfg.data)
        model = trainer.state.model.to(dtype)
        loss, _ = loss_and_grads(trainer.state, batch, draws, cfg.train,
                                 cfg.data, dtype)
        g = torch.cat([p.grad.detach().double().flatten().cpu()
                       for p in model.parameters()])
        del trainer, model, batch
        torch.cuda.empty_cache()
        return float(loss.detach()), g

    t0 = time.perf_counter()
    ref_loss, ref = grads("xla", "cpu", torch.float64)
    print(f"float64 on the CPU, bn_impl=xla, batch {F32_BATCH}: loss "
          f"{ref_loss:.8f} ({time.perf_counter() - t0:.1f} s)")
    for impl in PATH_STEPS:
        loss, g = grads(impl, dev, torch.float32)
        rel_loss = abs(loss - ref_loss) / abs(ref_loss)
        rel_g = float((g - ref).norm() / ref.norm())
        worst = float((g - ref).abs().max() / ref.abs().max())
        print(f"f32 on the card, bn_impl={impl}: loss {loss:.8f} "
              f"({rel_loss:.1e} relative to float64's); gradient "
              f"{rel_g:.2e} off in norm, largest difference {worst:.2e} "
              f"of the largest gradient")
        _require(rel_loss <= 2e-5 and rel_g <= 5e-2,
                 f"bn_impl={impl}: f32 step far from the float64 one")


def _profile(fn, label: str) -> None:
    """``torch.profiler`` over 3 calls of ``fn``: the device ms a call over
    every device kernel (the device's copies of the ``record_function``
    ranges are not kernels), and torch's own table of the events by
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reps = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    launches = sum(e.count for e in kernels) // reps
    print(f"profile {label}, {reps} calls: device {ms:.3f} ms/call in "
          f"{launches} kernels/call")
    print(events.table(sort_by="self_device_time_total", row_limit=15))


def strided_cotangents(dev, trainer, batch, losses) -> None:
    """Phase 5: how many of one step's upsample_int backward calls receive
    a cotangent that is not NHWC-contiguous, which the wrapper copies
    before its kernel reads it, and the device time of those copies."""
    from basi_tpu_torch.kernels import upsample_int as U

    real, seen = U._UpsampleInt.backward, []

    def recording(ctx, g):
        seen.append((tuple(g.shape), g.stride(), g.is_contiguous()))
        return real(ctx, g)

    U._UpsampleInt.backward = staticmethod(recording)
    try:
        losses.append(trainer.train_step(trainer.state, batch)["loss"])
    finally:
        U._UpsampleInt.backward = staticmethod(real)
    _require(len(seen) == PER_STEP["xla"]["upsample_int_bwd"],
             f"{len(seen)} upsample_int backward calls in a step")
    strided = [(shape, stride) for shape, stride, contig in seen if not contig]
    copy_ms = 0.0
    for shape, stride in strided:
        t = torch.empty_strided(shape, stride, dtype=torch.bfloat16, device=dev)
        copy_ms += _time_ms(t.contiguous)
    print(f"cotangents: {len(strided)} of a step's {len(seen)} upsample_int "
          f"backward calls get one that is not NHWC-contiguous "
          f"{[s for s, _ in strided]}; copying them takes {copy_ms:.4f} ms "
          "(CUDA events, warm)")


def per_step_launches(cfg, bns: int = BN_LAYERS) -> dict:
    """The kernel launches of one train step of ``cfg`` (``bns`` trunk
    BatchNorms): per micro-batch one ``normalize_and_flip``, and in bf16
    nine ``upsample_int`` and nine backward; under ``bn_impl`` fused or
    stats one ``channel_moments`` a BatchNorm (two under remat: the
    recompute), and under fused one ``channel_dual_sums``, one
    ``bn_apply`` (two under remat) and one ``bn_input_gradient``; none of
    these when the trunk is frozen."""
    t, impl = cfg.train, cfg.model.bn_impl
    ups = 9 if cfg.model.dtype == "bfloat16" else 0
    bn = 0 if t.freeze_bn or impl == "xla" else bns
    fused = bn if impl == "fused" else 0
    return {k: v * t.grad_accum for k, v in {
        "upsample_int": ups, "upsample_int_bwd": ups, "upsample_sigmoid": 0,
        "normalize_and_flip": 1,
        "channel_moments": bn * (2 if t.remat else 1),
        "channel_dual_sums": fused,
        "bn_apply": fused * (2 if t.remat else 1),
        "bn_input_gradient": fused}.items()}


def check_f32_step(dev, bn_impl: str, overrides=(), label: str = ""):
    """Phase 6 (and 11, with a setting's ``overrides``): one f32 train step
    of the tiny config on the card and on the CPU from the same weights,
    batch and draws (the state's CPU generator), micro-batches of 4
    images; the card's launches as ``per_step_launches`` counts them.
    Phase 6: loss within 1e-3 and every gradient within 1e-3 (atol and
    rtol). Phase 11: the same step in float64 on the CPU as the
    reference; the loss within 1e-4 relative of the CPU's f32 loss, and
    the card's f32 gradients no further from the reference than twice
    the CPU's f32 gradients are, by the largest difference and in norm
    (plus 1e-6 of the reference's). Zoomed-out scenes leave constant
    regions in which the tiny trunk's BatchNorms see nearly constant
    channels and amplify rounding: there the card's and the CPU's f32
    gradients part by up to 5e-2 of an element (measured), each as far
    from float64 as the other."""
    from basi_tpu_torch.config import (
        Config,
        DataConfig,
        InferConfig,
        ModelConfig,
        TrainConfig,
        apply_overrides,
    )
    from basi_tpu_torch.models.basi import cast_params, create_model
    from basi_tpu_torch.models.layers import BatchNorm2d
    from basi_tpu_torch.train.state import create_train_state, make_schedule
    from basi_tpu_torch.train.step import make_train_step, param_dtype

    cfg = Config(
        model=ModelConfig(backbone="resnet_tiny", fpn_channels=32,
                          mask_channels=32, grid_size=8, image_size=64,
                          bn_impl=bn_impl),
        data=DataConfig(image_size=64, max_instances=4, hflip_prob=1.0),
        train=TrainConfig(grad_clip_norm=0.0, checkpoint_dir=""),
        infer=InferConfig(dtype="float32"))
    cfg = apply_overrides(cfg, list(overrides))
    rng = np.random.RandomState(SEED)
    n, size, m = 4 * cfg.train.grad_accum, 64, 4
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
    runs = [(dev, torch.float32), ("cpu", torch.float32)]
    if overrides:
        runs.append(("cpu", torch.float64))
    out = []
    for device, dtype in runs:
        model = cast_params(
            create_model(cfg.model, device,
                         torch.Generator().manual_seed(SEED), train=True),
            param_dtype(cfg.model))
        if dtype == torch.float64:
            model = model.to(dtype)
        state = create_train_state(model, cfg.train)
        step = make_train_step(cfg.train, cfg.data, make_schedule(cfg.train, 10),
                               dtype)
        _zero_kernel_counts()
        metrics = step(state, {k: v.to(device) for k, v in host.items()})
        counts = _kernel_counts()
        out.append((float(metrics["loss"]),
                    {k: p.grad.double().cpu()
                     for k, p in model.named_parameters()}, counts))
    (loss_d, g_d, n_d), (loss_c, g_c, _) = out[:2]
    bns = sum(isinstance(m, BatchNorm2d) for m in model.modules())
    label = label or f"bn_impl={bn_impl}"
    _require(n_d == per_step_launches(cfg, bns),
             f"f32 step {label}: launches {n_d}, expected "
             f"{per_step_launches(cfg, bns)}")
    err = max(float((g_d[k] - g_c[k]).abs().max()) for k in g_c)
    gmax = max(float(g.abs().max()) for g in g_c.values())
    print(f"f32 train step {label} card vs cpu: loss {loss_d:.6f} "
          f"vs {loss_c:.6f}; max gradient difference {err:.3e} (largest "
          f"gradient {gmax:.3e}); card launches {n_d}")
    if not overrides:
        _require(abs(loss_d - loss_c) <= 1e-3 * max(1.0, abs(loss_c)),
                 f"f32 step {label}: loss beyond 1e-3")
        for k in g_c:
            torch.testing.assert_close(
                g_d[k].float(), g_c[k].float(), atol=1e-3, rtol=1e-3,
                msg=lambda m, k=k: f"f32 step {label} grad {k}: {m}")
        return
    ref = out[2][1]

    def apart(g):
        flat = torch.cat([(g[k] - ref[k]).flatten() for k in ref])
        return float(flat.abs().max()), float(flat.norm())

    rmax = max(float(r.abs().max()) for r in ref.values())
    rnorm = float(torch.cat([r.flatten() for r in ref.values()]).norm())
    (dm, dn), (cm, cn) = apart(g_d), apart(g_c)
    print(f"  from float64 (loss {out[2][0]:.6f}): card {dm:.3e} at most, "
          f"{dn:.3e} in norm; cpu {cm:.3e}, {cn:.3e} (largest {rmax:.3e}, "
          f"norm {rnorm:.3e})")
    _require(abs(loss_d - loss_c) <= 1e-4 * abs(loss_c),
             f"f32 step {label}: loss beyond 1e-4")
    _require(dm <= 2 * cm + 1e-6 * rmax and dn <= 2 * cn + 1e-6 * rnorm,
             f"f32 step {label}: the card's gradients lie further from "
             "float64 than twice the CPU's")


# Phase 7: evaluation at full width, the preset's non-square originals
# (scale 1.5, letterboxed by the port's numpy resize).
EVAL_OVERRIDES = ["data.synthetic_n=128", "infer.ap_at_original=true"]
EVAL_IMAGES = 32  # the val split of synthetic_n=128
TIMING_KEYS = ("infer_ms_per_batch", "imgs_per_s")
# torch.profiler ranges of the eval program, by class; the EDT (the
# weighted F's distance transform) is a range inside the SOD suite's
EVAL_CLASSES = [("forward", "eval.forward"), ("selection", "eval.selection"),
                ("upsample_sigmoid", "eval.upsample_sigmoid"),
                ("IoU", "eval.iou"), ("paste", "eval.paste"),
                ("SOD suite (EDT aside)", "eval.sod"), ("EDT", "eval.edt")]


def _metrics_only(m: dict) -> dict:
    return {k: v for k, v in m.items() if k not in TIMING_KEYS}


def run_eval(dev, gen) -> dict:
    """Phase 7: ``Inferencer.evaluate`` of ``bench_accuracy`` at full width
    in the original frame (``EVAL_OVERRIDES``), 32 val images in 2 batches
    of 16, bf16, with the disk native-GT cache built beforehand
    (device-resident GT), once with ``infer.wf`` off and once on, then on
    without the cache (GT drawn per batch): every metric finite, 32 images, 9 ``upsample_int`` and 1
    ``upsample_sigmoid`` launches per batch, nothing else, and the same
    metrics without the cache. Then one batch under ``torch.profiler``.
    Returns the seeded weights it evaluated and its rate with the cache
    and ``wf`` on (phase 9 sets the folder's beside it)."""
    import shutil
    import tempfile

    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.data.datasets import make_dataset
    from basi_tpu_torch.data.native_gt import NativeGTCache
    from basi_tpu_torch.infer import Inferencer

    gt_dir = tempfile.mkdtemp(prefix="basi_native_gt_")
    try:
        results, walls, sd = {}, {}, None
        cfg = get_config("bench_accuracy", EVAL_OVERRIDES)
        t0 = time.perf_counter()
        NativeGTCache(make_dataset(cfg.data, split="val"), gt_dir)
        print(f"native-GT cache of the {EVAL_IMAGES} val images built in "
              f"{time.perf_counter() - t0:.2f} s")
        # wf off first: it also pays the first eval's set-up
        for wf, cache in (("false", gt_dir), ("true", gt_dir), ("true", "")):
            cfg = get_config("bench_accuracy", EVAL_OVERRIDES + [
                f"infer.wf={wf}", f"infer.native_gt_cache={cache}"])
            if sd is None:
                sd = smoke_weights(cfg, gen)
            inf = Inferencer(cfg, state_dict=sd)  # the default device
            _require(inf.device == dev, f"Inferencer ran on {inf.device}")
            ds = make_dataset(cfg.data, split="val")
            _zero_kernel_counts()
            t0 = time.perf_counter()
            m = inf.evaluate(ds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _kernel_counts()
            n_b = EVAL_IMAGES // cfg.infer.batch_size
            print(f"evaluate, bench_accuracy original frame, wf={wf}, "
                  f"native_gt_cache={'on' if cache else 'off'}: "
                  f"{m['num_images']} images in {n_b} batches of "
                  f"{cfg.infer.batch_size} ({cfg.model.dtype}) in "
                  f"{wall:.3f} s = {1000 * wall / n_b:.1f} ms/batch "
                  f"({EVAL_IMAGES / wall:.1f} imgs/s, host feed and first-"
                  f"batch set-up included); infer_ms_per_batch "
                  f"{m['infer_ms_per_batch']}, imgs_per_s {m['imgs_per_s']}; "
                  f"launches per batch "
                  f"{ {k: v / n_b for k, v in launches.items() if v} }")
            print(f"  metrics {json.dumps(_metrics_only(m))}")
            _require(m["num_images"] == EVAL_IMAGES,
                     f"evaluate saw {m['num_images']} images")
            _require(all(np.isfinite(v) for v in m.values()),
                     "a non-finite eval metric")
            _require(("saliency_wF" in m) == (wf == "true"),
                     "saliency_wF present iff infer.wf")
            _require(launches == dict(_zero_counts(), upsample_int=9 * n_b,
                                      upsample_sigmoid=n_b),
                     f"expected 9 upsample_int and 1 upsample_sigmoid launch "
                     f"per eval batch x {n_b}, nothing else; got {launches}")
            results[(wf, bool(cache))] = (inf, ds, m)
            walls[(wf, bool(cache))] = wall
        _require(_metrics_only(results[("true", False)][2])
                 == _metrics_only(results[("true", True)][2]),
                 "evaluate without the native-GT cache gave other metrics")
        print("evaluate without the native-GT cache: the same metrics")
        inf, ds, m = results[("true", True)]
        rate = (f"{EVAL_IMAGES / walls[('true', True)]:.1f} imgs/s by the "
                f"wall clock, imgs_per_s {m['imgs_per_s']}")
        profile_eval_batch(inf, ds)
        del results, inf
    finally:
        shutil.rmtree(gt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return sd, rate


def profile_eval_batch(inf, ds) -> None:
    """Phase 7: one eval batch (the first val batch, assembled on the host
    beforehand) from upload to the fetched outputs, timed with the host
    clock, then traced: device ms by eval class (``torch.profiler``
    ranges) and the device's busy share of the batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from basi_tpu_torch.data.datasets import iter_epoch
    from basi_tpu_torch.data.transforms import pack_masks_host

    bs = inf.cfg.infer.batch_size
    batch = next(iter_epoch(ds, bs, shuffle=False, seed=0, drop_last=False))
    host = [batch["image"], pack_masks_host(batch["masks"]), batch["valid"],
            batch["valid_hw"]]

    def one():
        res, full, sal = inf._eval_batch(*(inf._upload(a) for a in host))
        res.update(inf._orig_frame_eval(full, sal, batch, ds))
        del full, sal
        return {k: v.cpu() for k, v in res.items()}

    with torch.inference_mode():
        one()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            one()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            wall_prof = (time.perf_counter() - t0) * 1e3
    # Each kernel goes to the innermost eval range whose span on the
    # device (the range's GPU annotation) holds its start: one stream, so
    # the spans nest as the ranges do.
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.name.startswith("eval.")]
    by_range: dict = {}
    for e in events:
        if e.is_user_annotation:
            continue
        t = e.time_range.start
        inside = [sp for sp in spans if sp[0] <= t < sp[1]]
        key = (min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside
               else "outside the ranges")
        by_range[key] = by_range.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    wall, device = min(walls), sum(by_range.values())
    print(f"one eval batch ({bs} images, original frame, wf on; upload to "
          f"fetched outputs): {' '.join(f'{w:.2f}' for w in walls)} ms "
          f"(profiler off), {wall_prof:.2f} ms traced; device {device:.3f} ms "
          f"(busy {100 * device / wall:.1f}% of {wall:.2f} ms), by class:")
    names = dict((key, name) for name, key in EVAL_CLASSES)
    for key, ms in sorted(by_range.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {names.get(key, key)}")
    _require(device > 0, "the profiler saw no device time in an eval batch")


def _iou_bound(p_d, p_c, gt_areas):
    """Per (image, slot, GT) bound on the IoU gap between masks binarized
    on two devices, ``p_d`` and ``p_c`` (N, K, H, W) bool, against GT of
    ``gt_areas`` (N, M) pixels: each of a slot's d pixels that binarize
    apart moves its IoU by at most 1 / union, and no union on the way
    from one mask to the other (pixels added first) is below the larger of
    the GT's area and the smaller mask's area; plus 1e-5 for the f32
    division. Returns (bound (N, K, M), d (N, K))."""
    d = (p_d != p_c).sum(dim=(-2, -1)).double()
    small = torch.minimum(p_d.sum(dim=(-2, -1)), p_c.sum(dim=(-2, -1)))
    union = torch.maximum(gt_areas.double()[:, None, :],
                          small.double()[:, :, None]).clamp(min=1.0)
    return d[:, :, None] / union + 1e-5, d


def check_eval_f32(dev, sd, overrides=None, label: str = "f32 eval"
                   ) -> None:
    """Phase 7 (and phase 9 on a folder, ``overrides`` naming it), card
    against CPU in f32: one batch of 4 through
    ``evaluate(max_batches=1)`` on each: saliency means within 1e-4, AP/AR
    equal. The batch's full-resolution masks agree within 1e-4, and pixels
    binarize apart only within that difference of ``mask_threshold`` (in
    the letterbox and, pasted, in the original frame). Every IoU of both
    frames is within 1e-5 plus its slot's own count of pixels binarized
    apart over the pair's union (``_iou_bound``). The random weights reach
    no COCO threshold (AP and AR read 0 on both), so AP at IoU 0.02-0.2 is
    also taken of both devices' IoU matrices and must be equal and not 0."""
    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.data.datasets import iter_epoch, make_dataset
    from basi_tpu_torch.data.transforms import pack_masks_host
    from basi_tpu_torch.evals.ap import APAccumulator
    from basi_tpu_torch.infer import Inferencer, _canvas_side
    from basi_tpu_torch.ops.paste import paste_masks_batch

    cfg = get_config("bench_accuracy", (overrides or EVAL_OVERRIDES) + [
        "infer.batch_size=4", "model.dtype=float32", "infer.dtype=float32",
        "infer.native_gt_cache="])
    thr, size = cfg.infer.mask_threshold, cfg.model.image_size
    ds = make_dataset(cfg.data, split="val")
    batch = next(iter_epoch(ds, 4, shuffle=False, seed=0, drop_last=False))
    host = [batch["image"], pack_masks_host(batch["masks"]), batch["valid"],
            batch["valid_hw"]]
    canvas = tuple(_canvas_side(int(batch["orig_hw"][:, a].max()), size)
                   for a in (0, 1))
    out = []
    for device in (dev, "cpu"):
        inf = Inferencer(cfg, device=device, state_dict=sd)
        m = inf.evaluate(ds, max_batches=1)
        with torch.inference_mode():
            res, full, sal = inf._eval_batch(*(inf._upload(a) for a in host))
            orig = inf._orig_frame_eval(full, sal, batch, ds)
            pasted = paste_masks_batch(full, inf._upload(batch["valid_hw"]),
                                       canvas, inf._upload(batch["orig_hw"]))
        out.append({"m": m, "scores": res["scores"].cpu(),
                    "iou": [res["iou"].cpu(), orig["iou"].cpu()],
                    "areas": [res["areas"].cpu(), orig["areas"].cpu()],
                    "probs": [full.cpu(), pasted.cpu()]})
        del inf, res, full, sal, orig, pasted
    card, cpu = out
    m_d, m_c = card["m"], cpu["m"]
    sal_err = max(abs(m_d[k] - m_c[k]) for k in m_c if k.startswith("saliency"))
    full_err = float((card["probs"][0] - cpu["probs"][0]).abs().max())
    _require(set(m_d) == set(m_c) and m_d["num_images"] == 4,
             "card and CPU give other metric keys")
    _require(sal_err <= 1e-4, f"{label}: a saliency metric beyond 1e-4")
    _require(all(m_d[k] == m_c[k] for k in m_c if k[:2] in ("AP", "AR", "mA")),
             f"{label}: AP/AR differ between card and CPU")
    _require(full_err <= 1e-4,
             f"{label}: full-resolution masks beyond 1e-4")
    valid = batch["valid"]
    for f, frame in enumerate(("letterbox", "original frame")):
        p_d, p_c = card["probs"][f], cpu["probs"][f]
        err = float((p_d - p_c).abs().max())
        apart = (p_d > thr) != (p_c > thr)
        near = bool(((p_c[apart] - thr).abs() <= err).all())
        bound, d = _iou_bound(p_d > thr, p_c > thr, cpu["areas"][f])
        gap = (card["iou"][f].double() - cpu["iou"][f].double()).abs()
        aps = []
        for side in (card, cpu):
            acc = APAccumulator(thresholds=(0.02, 0.05, 0.1, 0.2))
            for i in range(4):
                acc.add(side["scores"][i].numpy(), side["iou"][f][i].numpy(),
                        valid[i], gt_areas=side["areas"][f][i].numpy())
            aps.append(acc.ap())
        print(f"{label} card vs cpu, {frame} (1 batch of 4): masks max diff "
              f"{err:.2e}, {int(apart.sum())} pixels in {int((d > 0).sum())} "
              f"of {d.numel()} slots binarize apart (all within it of the "
              f"threshold: {near}); IoU max diff {float(gap.max()):.2e}, "
              f"largest share of its bound {float((gap / bound).max()):.3f}, "
              f"over slots binarized alike "
              f"{float((gap * (d == 0)[..., None]).max()):.2e} "
              f"(largest IoU {float(cpu['iou'][f].max()):.4f}); AP at low "
              f"IoU, card {aps[0]}")
        _require(near, f"{label}, {frame}: pixels binarized apart away from "
                 "the threshold")
        _require(bool((gap <= bound).all()),
                 f"{label}, {frame}: an IoU beyond 1e-5 plus its slot's "
                 "pixels binarized apart over its union")
        _require(aps[0] == aps[1], f"{label}, {frame}: AP at low IoU "
                 f"differs, card {aps[0]} cpu {aps[1]}")
        _require(any(v > 0 for v in aps[0].values()),
                 f"{label}, {frame}: AP at low IoU is 0, checks nothing")
    print(f"{label} card vs cpu: saliency max diff {sal_err:.2e}; card "
          f"{json.dumps(_metrics_only(m_d))}")


def check_paste_sod(dev, gen) -> None:
    """Phase 7: the paste and the SOD suite on the card against the CPU at
    non-square extents, made directly: 4 images of 20 slots at 512^2, each
    with its own valid and original extent, onto a 768 x 896 canvas;
    the paste within 1e-6 and every metric within 1e-5."""
    from basi_tpu_torch.evals import saliency as SAL
    from basi_tpu_torch.ops.paste import paste_masks_batch

    canvas = (768, 896)
    masks = torch.rand((4, 20, 512, 512), generator=gen)
    sal = torch.rand((4, 1, 512, 512), generator=gen)
    valid_hw = torch.tensor([[512, 366], [341, 512], [512, 452], [337, 512]],
                            dtype=torch.int32)
    orig_hw = torch.tensor([[700, 501], [480, 721], [768, 678], [591, 896]],
                           dtype=torch.int32)
    rng = np.random.RandomState(SEED)
    yy, xx = np.mgrid[0:canvas[0], 0:canvas[1]]
    union = np.zeros((4,) + canvas, np.float32)
    for i, (oh, ow) in enumerate(orig_hw.tolist()):
        for _ in range(3):
            cy, cx = rng.randint(oh // 8, 7 * oh // 8), rng.randint(ow // 8, 7 * ow // 8)
            ry, rx = rng.randint(oh // 16, oh // 5), rng.randint(ow // 16, ow // 5)
            union[i][((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = 1.0
    union = torch.from_numpy(union)
    region = ((torch.arange(canvas[0])[None, :, None] < orig_hw[:, 0, None, None])
              & (torch.arange(canvas[1])[None, None, :] < orig_hw[:, 1, None, None])
              ).float()
    outs = []
    for device in (dev, torch.device("cpu")):
        with torch.inference_mode():
            args = (valid_hw.to(device), canvas, orig_hw.to(device))
            pasted = paste_masks_batch(masks.to(device), *args)
            prob = paste_masks_batch(sal.to(device), *args)[:, 0]
            u, r = union.to(device), region.to(device)
            metrics = {name: getattr(SAL, name)(prob, u, valid=r).cpu()
                       for name in ("f_measure_hist", "e_measure_hist",
                                    "s_measure", "boundary_f_measure",
                                    "weighted_f_measure")}
        outs.append((pasted.cpu(), metrics))
        del pasted, prob
    (p_d, m_d), (p_c, m_c) = outs
    paste_err = float((p_d - p_c).abs().max())
    errs = {k: float((m_d[k] - m_c[k]).abs().max()) for k in m_c}
    print(f"paste (4, 20, 512^2) -> {canvas} card vs cpu: max_abs_err "
          f"{paste_err:.2e}; SOD suite max_abs_err "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} }; weighted F "
          f"{[round(float(v), 4) for v in m_c['weighted_f_measure']]}")
    _require(paste_err <= 1e-6, "paste: card vs CPU beyond 1e-6")
    _require(max(errs.values()) <= 1e-5, "SOD suite: card vs CPU beyond 1e-5")


def check_trainer_eval(dev) -> None:
    """Phase 7: a full-width ``Trainer`` (no device given) runs its one
    epoch (2 steps of 16) to the end, evaluates 8 val images and prints
    ``[val]``; its metrics equal ``Inferencer.evaluate`` of the state's
    EMA weights."""
    import contextlib
    import io

    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.infer import Inferencer
    from basi_tpu_torch.train.loop import Trainer

    cfg = get_config("bench_accuracy", ["data.synthetic_n=32",
                                        "train.epochs=1"])
    trainer = Trainer(cfg)
    _require(trainer.device == dev, f"Trainer ran on {trainer.device}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        last = trainer.train()
    wall = time.perf_counter() - t0
    sys.stdout.write(buf.getvalue())
    val = [json.loads(line[len("[val] "):])
           for line in buf.getvalue().splitlines() if line.startswith("[val] ")]
    print(f"Trainer.train() with no max_steps: {trainer.state.step} steps "
          f"and the epoch's eval in {wall:.2f} s")
    _require(trainer.state.step == 2 and len(val) == 1
             and val[0]["num_images"] == 8 and val[0]["epoch"] == 0,
             f"expected 2 steps and one [val] record of 8 images, got "
             f"{trainer.state.step} steps and {val}")
    want = _metrics_only(Inferencer(cfg, state_dict=trainer.eval_state_dict())
                         .evaluate(trainer.val_dataset))
    _require({k: last[k] for k in want} == want,
             f"the Trainer's eval {last} differs from Inferencer.evaluate "
             f"on the EMA weights {want}")
    print("the Trainer's per-epoch eval equals Inferencer.evaluate on the "
          "EMA weights")
    del trainer
    torch.cuda.empty_cache()


# Phase 8: the accuracy recipe's path, cut to size: 64 train and 16 val
# scenes of the preset as written (scale 1.5), 2 epochs of 4 steps.
RECIPE_OVERRIDES = ["data.synthetic_n=64", "train.epochs=2",
                    "train.log_every=1", "infer.native_gt_cache="]
RECIPE_STEPS, PREEMPT_AT = 8, 6
# The resumed run's last loss against the uninterrupted run's: cuDNN's
# weight-gradient algorithms need not repeat bit for bit, so two runs may
# part by float rounding; a wrong resume (another batch, lr or momentum)
# misses by far more.
RESUME_LOSS_RTOL = 1e-3


def _digest(batch: dict) -> str:
    import hashlib

    h = hashlib.sha1()
    for k in sorted(batch):
        h.update(batch[k].cpu().numpy().tobytes())
    return h.hexdigest()


def _traced_trainer(cfg, log: dict, stop_at: int = 0):
    """A Trainer (the default device) whose steps record, by the step they
    make: the batch's digest, the lr, the generator's state before the
    step and the loss; after step ``stop_at`` the preemption flag is set."""
    from basi_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg)
    step_fn = trainer.train_step

    def traced(state, batch):
        before = (_digest(batch), trainer.schedule(state.step),
                  state.generator.get_state())
        metrics = step_fn(state, batch)
        log[state.step] = before + (float(metrics["loss"]),)
        if state.step == stop_at:
            trainer._preempt.set()
        return metrics

    trainer.train_step = traced
    return trainer


def _feed_ms(dataset, batch_size: int, batches: int) -> float:
    """Host ms per batch of the feed's work: assembly and mask packing."""
    from basi_tpu_torch.data.datasets import iter_epoch
    from basi_tpu_torch.data.transforms import pack_masks_host

    t0 = time.perf_counter()
    n = 0
    for hb in iter_epoch(dataset, batch_size, shuffle=True, seed=0):
        pack_masks_host(hb["masks"])
        n += 1
        if n == batches:
            break
    return 1000.0 * (time.perf_counter() - t0) / n


def check_recipe(dev) -> dict:
    """Phase 8: the ``bench_accuracy`` recipe's path at full width, in a
    temporary directory: pack the train and val splits into shards, each
    record byte-equal to the synthetic sample; an uninterrupted run of
    ``RECIPE_STEPS`` steps from the shards with a checkpoint each epoch
    (counts zeroed before it, read after); a run stopped by the
    preemption flag after step ``PREEMPT_AT``, its saved state bit-equal
    to the live one; a new Trainer that resumes it to the end, its steps'
    batches, lr and generator state exactly the uninterrupted run's and
    its last loss within ``RESUME_LOSS_RTOL``; ``Inferencer(checkpoint=)``
    equal to the Trainer's eval on the val shards and, in the original
    frame on the raw val split (``run_final_eval``), equal to the same EMA
    weights given as a state dict. Returns the uninterrupted run's kernel
    launches."""
    import os
    import shutil
    import tempfile

    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.data.datasets import make_dataset
    from basi_tpu_torch.data.shards import ShardDataset
    from basi_tpu_torch.infer import Inferencer
    from basi_tpu_torch.tools.bench_accuracy import pack_splits, run_final_eval
    from basi_tpu_torch.utils.checkpoint import CheckpointManager

    root = tempfile.mkdtemp(prefix="basi_recipe_")
    try:
        cfg0 = get_config("bench_accuracy", RECIPE_OVERRIDES)
        _require(cfg0.data.synthetic_orig_scale == 1.5,
                 "the preset's scale is not 1.5")
        shard_root = os.path.join(root, "shards")
        t0 = time.perf_counter()
        train_ov = pack_splits(RECIPE_OVERRIDES, shard_root)
        pack_s = time.perf_counter() - t0
        for split in ("train", "val"):
            src = make_dataset(cfg0.data, split=split)
            packed = ShardDataset(os.path.join(shard_root, split))
            _require(len(packed) == len(src), f"{split}: {len(packed)} records")
            for i in range(len(src)):
                a, b = src.get(i), packed.get(i)
                _require(a.name == b.name and all(
                    np.array_equal(getattr(a, f), getattr(b, f))
                    for f in ("image", "masks", "valid", "orig_hw",
                              "valid_hw")), f"{split} record {i} differs")
        bs = cfg0.data.batch_size
        feed = {name: _feed_ms(ds, bs, 4) for name, ds in (
            ("synthetic", make_dataset(cfg0.data, split="train")),
            ("shards", ShardDataset(os.path.join(shard_root, "train"))))}
        print(f"packed 64 train and 16 val scenes of bench_accuracy (scale "
              f"1.5) in {pack_s:.2f} s; every record byte-equal to its "
              f"synthetic sample; host feed per batch of {bs} (assembly and "
              f"mask packing): synthetic {feed['synthetic']:.1f} ms, shards "
              f"{feed['shards']:.1f} ms")

        def cfg(name):
            return get_config("bench_accuracy", train_ov + [
                f"train.checkpoint_dir={os.path.join(root, name)}"])

        full: dict = {}
        trainer = _traced_trainer(cfg("full"), full)
        _require(trainer.device == dev, f"Trainer ran on {trainer.device}")
        _zero_kernel_counts()
        t0 = time.perf_counter()
        last = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _kernel_counts()
        n_eval = 2  # one val batch of 16 per epoch
        want = dict(_zero_counts(),
                    upsample_int=9 * (RECIPE_STEPS + n_eval),
                    upsample_int_bwd=9 * RECIPE_STEPS,
                    normalize_and_flip=RECIPE_STEPS,
                    upsample_sigmoid=n_eval)
        print(f"recipe from shards: {RECIPE_STEPS} steps and {n_eval} evals "
              f"in {wall:.2f} s; launches {launches}")
        _require(launches == want, f"expected launches {want}")
        ckpt_full = os.path.join(root, "full")
        _require(CheckpointManager(ckpt_full).steps() == [4, 8],
                 "expected checkpoints at the two epochs' ends")
        val_metrics = _metrics_only(trainer.evaluate())
        _require(all(val_metrics[k] == last[k] for k in val_metrics),
                 "the Trainer's eval moved between calls")
        ema_sd = {k: v.detach().cpu() for k, v in
                  trainer.eval_state_dict().items()}
        val_ds = trainer.val_dataset
        del trainer
        torch.cuda.empty_cache()

        part: dict = {}
        trainer = _traced_trainer(cfg("resumed"), part, stop_at=PREEMPT_AT)
        res = trainer.train()
        _require(res.get("preempted_at_step") == PREEMPT_AT
                 and res.get("checkpoint_saved") is True,
                 f"preemption: {res}")
        mgr = CheckpointManager(os.path.join(root, "resumed"))
        _require(mgr.steps() == [4, PREEMPT_AT], f"steps {mgr.steps()}")
        raw, st = mgr.load(), trainer.state
        live = {f"model.{k}": v for k, v in st.model.state_dict().items()}
        live.update({f"ema.{k}": v for k, v in st.ema.items()})
        saved = {f"model.{k}": v for k, v in raw["model"].items()}
        saved.update({f"ema.{k}": v for k, v in raw["ema"].items()})
        for i, p in enumerate(st.model.parameters()):
            live[f"momentum.{i}"] = st.optimizer.state[p]["momentum_buffer"]
            saved[f"momentum.{i}"] = raw["optimizer"]["state"][i][
                "momentum_buffer"]
        _require(set(live) == set(saved), "saved tensors differ in keys")
        bad = [k for k in live if not torch.equal(live[k].cpu(), saved[k])]
        _require(not bad and raw["step"] == st.step == PREEMPT_AT
                 and torch.equal(raw["generator"], st.generator.get_state()),
                 f"save -> load not bit-equal: {bad[:5]}")
        print(f"preempted after step {PREEMPT_AT}: {len(live)} saved "
              f"tensors bit-equal to the live state, step and generator "
              f"equal")
        del trainer, st, raw, live, saved
        torch.cuda.empty_cache()

        trainer = _traced_trainer(cfg("resumed"), part)
        _require(trainer.state.step == PREEMPT_AT,
                 f"resumed at step {trainer.state.step}")
        trainer.train()
        _require(trainer.state.step == RECIPE_STEPS, "resume did not finish")
        for s in range(PREEMPT_AT + 1, RECIPE_STEPS + 1):
            (da, lra, ga, _), (db, lrb, gb, _) = full[s], part[s]
            _require(da == db and lra == lrb and torch.equal(ga, gb),
                     f"resumed step {s}: another batch, lr or generator")
        la, lb = full[RECIPE_STEPS][3], part[RECIPE_STEPS][3]
        same = all(full[s][3] == part[s][3] for s in full)
        print(f"resumed at step {PREEMPT_AT} to {RECIPE_STEPS}: batches, lr "
              f"and generator state exactly the uninterrupted run's; last "
              f"loss {lb:.8f} against {la:.8f} (every loss bit-equal: "
              f"{same})")
        _require(abs(la - lb) <= RESUME_LOSS_RTOL * abs(la),
                 f"resumed loss beyond {RESUME_LOSS_RTOL} relative")
        del trainer
        torch.cuda.empty_cache()

        inf = Inferencer(cfg("full"), checkpoint=ckpt_full)
        got = _metrics_only(inf.evaluate(val_ds))
        _require(got == val_metrics, f"Inferencer(checkpoint=) {got} != the "
                 f"Trainer's eval {val_metrics}")
        del inf
        orig = run_final_eval("kernels", ckpt_full, RECIPE_OVERRIDES,
                              device=dev)
        ocfg = get_config("bench_accuracy", RECIPE_OVERRIDES + [
            "infer.ap_at_original=true"])
        want_orig = Inferencer(ocfg, state_dict=ema_sd).evaluate(
            make_dataset(ocfg.data, split="val"))
        orig, want_orig = _metrics_only(orig), _metrics_only(want_orig)
        orig.pop("eval_wall_s")
        _require(orig == want_orig and orig["num_images"] == 16
                 and all(np.isfinite(v) for v in orig.values()),
                 f"original-frame eval of the checkpoint {orig} != the EMA "
                 f"weights' {want_orig}")
        print(f"Inferencer(checkpoint=) equals the Trainer's eval on the val "
              f"shards, and in the original frame on 16 raw val images "
              f"equals the EMA weights given as a state dict: "
              f"{json.dumps(orig)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


# --- phase 9: image files -------------------------------------------------------

FIXTURES = Path(__file__).resolve().parent / "tests" / "test_torch_fixtures"
# 16 PNG scenes from 300 x 200 to 1100 x 700 (H x W; the largest batch's
# paste canvas is 1536 x 1024), then the three photographs and the grey
# 37 x 45 JPEG: 20 files, so the last batch of 8 is padded
FILE_PNG_HW = [(300 + 800 * i // 15, 200 + 500 * i // 15) for i in range(16)]
FILE_PHOTOS = ("photo_420", "photo_progressive", "photo_444")
FILE_EVAL_IMAGES = 32
# batches of 16 of the f32 folder evaluate held card against CPU (the
# CPU's f32 ResNet-50 takes ~35 s a batch)
F32_FOLDER_BATCHES = 1
# nvJPEG's IDCT against libjpeg's on the JPEG fixtures, as
# tests/test_torch_gpu.py holds it: a component 1 level apart moves R by up
# to 1 + 1.402 and B by up to 1 + 1.772 levels, so 3 at most
NVJPEG_MAX_ABS = 3
NVJPEG_MEAN_ABS = 0.1


def jpeg_fixtures() -> dict:
    """``jpeg.json`` of the JPEG fixtures, each entry with its file's
    ``bytes`` and the JAX decoder's decode (``ref``) added."""
    from basi_tpu_torch.data.png import read_png

    fixtures = json.loads((FIXTURES / "jpeg.json").read_text())
    for fx in fixtures.values():
        fx["bytes"] = (FIXTURES / fx["file"]).read_bytes()
        fx["ref"] = read_png(FIXTURES / fx["reference"])[0]
    return fixtures


def _labels(rng, h: int, w: int) -> np.ndarray:
    """A labeled mask of 2 to 6 ellipses, ids 1, 2, ... (later ones on
    top)."""
    yy, xx = np.mgrid[0:h, 0:w]
    lab = np.zeros((h, w), np.uint8)
    for i in range(rng.randint(2, 7)):
        cy, cx = rng.uniform(0.15, 0.85) * h, rng.uniform(0.15, 0.85) * w
        ry, rx = rng.uniform(0.05, 0.25) * h, rng.uniform(0.05, 0.25) * w
        lab[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = i + 1
    return lab


def write_file_fixtures(root: str, jpegs: dict) -> tuple[list, dict]:
    """The predict folder (``FILE_PNG_HW`` PNG scenes, the photographs and
    the grey JPEG) and three ILSO-style folders of ``FILE_EVAL_IMAGES``
    images with labeled mask PNGs: ``scenes`` (``bench_accuracy``'s, scale
    1.5, every fourth mask a palette PNG whose colours are all one grey:
    the ids survive only as indices), and ``photos_jpeg`` and
    ``photos_png``, the photographs in turn as JPEG files and as PNGs of
    their reference decodes, with the same masks. Returns (predict paths,
    folder roots by name)."""
    import os

    from basi_tpu_torch.data.datasets import SyntheticDataset
    from basi_tpu_torch.data.png import write_png

    pred = os.path.join(root, "predict")
    os.makedirs(pred)
    scenes = SyntheticDataset(n=64, image_size=512, max_instances=8, seed=5)
    paths = [os.path.join(pred, f"{i:06d}.png") for i in range(len(FILE_PNG_HW))]
    for name in FILE_PHOTOS + ("grey",):
        paths.append(os.path.join(pred, f"jpeg_{name}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(jpegs[name]["bytes"])
    roots = {k: os.path.join(root, k)
             for k in ("scenes", "photos_jpeg", "photos_png")}
    for r in roots.values():
        for sub in ("images", "masks"):
            os.makedirs(os.path.join(r, sub))
    ds = SyntheticDataset(n=FILE_EVAL_IMAGES, image_size=512,
                          max_instances=8, seed=1, orig_max_scale=1.5)
    grey = np.full((9, 3), 128, np.uint8)
    grey[0] = 0
    rng = np.random.RandomState(SEED)
    labels = [_labels(rng, *jpegs[FILE_PHOTOS[i % len(FILE_PHOTOS)]]["shape"])
              for i in range(FILE_EVAL_IMAGES)]

    def predict_scene(i):
        write_png(paths[i], scenes._scene(i, *FILE_PNG_HW[i])[0])

    def eval_image(i):
        img, masks, _ = ds._scene(i, *ds._dims(i))
        lab = (masks * np.arange(1, 9, dtype=np.uint8)[:, None, None]).max(0)
        d = roots["scenes"]
        write_png(os.path.join(d, "images", f"{i:04d}.png"), img)
        write_png(os.path.join(d, "masks", f"{i:04d}.png"), lab,
                  palette=grey if i % 4 == 0 else None)
        fx = jpegs[FILE_PHOTOS[i % len(FILE_PHOTOS)]]
        with open(os.path.join(roots["photos_jpeg"], "images",
                               f"{i:04d}.jpg"), "wb") as f:
            f.write(fx["bytes"])
        write_png(os.path.join(roots["photos_png"], "images", f"{i:04d}.png"),
                  fx["ref"])
        for k in ("photos_jpeg", "photos_png"):
            write_png(os.path.join(roots[k], "masks", f"{i:04d}.png"),
                      labels[i])

    # zlib and numpy's large operations release the GIL
    with ThreadPoolExecutor(8) as pool:
        jobs = [pool.submit(predict_scene, i) for i in range(len(FILE_PNG_HW))]
        jobs += [pool.submit(eval_image, i) for i in range(FILE_EVAL_IMAGES)]
        for job in jobs:
            job.result()
    return paths, roots


def _decode_rates(dec, paths: list) -> tuple[float, float]:
    """(one by one, batched) decode + letterbox to 512 imgs/s of
    ``paths``, each the best of 3 rounds (the host is shared)."""
    dec.decode_letterbox_batch(paths, 512)  # warm: the thread pool
    single, batch = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        for p in paths:
            dec.decode_letterbox(p, 512)
        single.append(len(paths) / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        dec.decode_letterbox_batch(paths, 512)
        batch.append(len(paths) / (time.perf_counter() - t0))
    return max(single), max(batch)


def check_decoder(paths: list, jpegs: dict, roots: dict) -> dict:
    """Phase 9: the decoder's build, every JPEG fixture against the JAX
    package's decode (digests on the libjpeg route, ``NVJPEG_MAX_ABS`` /
    ``NVJPEG_MEAN_ABS`` on the nvjpeg route), the letterboxes to 64 and
    512 of each reference decode bit for bit, every PNG scene read back
    exactly; then decode + letterbox imgs/s one by one and through the
    batch API, at 512, for the PNG scenes, the photographs as JPEG and
    the same photographs as PNG."""
    import hashlib
    import os

    from basi_tpu_torch.data import native as N
    from basi_tpu_torch.data.datasets import SyntheticDataset
    from basi_tpu_torch.data.png import read_png

    t0 = time.perf_counter()
    route = N.route()
    N.library()
    info = N.build_info
    print(f"decoder: JPEG route {route}, {info['path']} ("
          f"{'built' if info['compiled'] else 'cached'} in "
          f"{time.perf_counter() - t0:.2f} s, g++ {info['seconds']:.2f} s)")
    errs = {}
    for name, fx in jpegs.items():
        got, ref = N.decode_jpeg(fx["bytes"]), fx["ref"]
        _require(got.shape == ref.shape == (*fx["shape"], 3),
                 f"JPEG {name}: shape {got.shape}")
        diff = np.abs(got.astype(np.int32) - ref)
        errs[name] = (int(diff.max()), float(diff.mean()),
                      float((diff > 1).mean()))
        if route == "libjpeg":
            _require(hashlib.sha256(got.tobytes()).hexdigest() == fx["sha256"],
                     f"JPEG {name}: not the reference decode")
        else:
            _require(diff.max() <= NVJPEG_MAX_ABS
                     and diff.mean() <= NVJPEG_MEAN_ABS,
                     f"JPEG {name}: nvJPEG {errs[name][:2]} beyond "
                     f"({NVJPEG_MAX_ABS}, {NVJPEG_MEAN_ABS})")
        for size in (64, 512):
            lb = N.letterbox_rgb(ref, size)
            _require(hashlib.sha256(lb.tobytes()).hexdigest()
                     == fx[f"sha256_lb{size}"],
                     f"JPEG {name}: the letterbox to {size} is not the "
                     f"reference's")
    print(f"JPEG fixtures against the JAX decoder's decodes (max and mean "
          f"abs diff, share of values more than 1 apart): {errs}")
    scenes = SyntheticDataset(n=64, image_size=512, max_instances=8, seed=5)
    for i, (h, w) in enumerate(FILE_PNG_HW):
        img, _, _ = scenes._scene(i, h, w)
        got, mode = read_png(paths[i])
        _require(mode == "RGB" and np.array_equal(got, img),
                 f"PNG {paths[i]} does not read back")
        _require(np.array_equal(N.decode_rgb(paths[i]), img),
                 f"the decoder misreads {paths[i]}")
    dec = N.NativeDecoder()
    rates = {}
    for key, what, files in (
            ("png_scenes", "16 PNG scenes 300x200-1100x700", paths[:16]),
            ("jpeg_photos", "32 JPEG photographs 640x480/640x427/612x612",
             roots["photos_jpeg"]),
            ("png_photos", "the same 32 photographs as PNG",
             roots["photos_png"])):
        if isinstance(files, str):
            d = os.path.join(files, "images")
            files = [os.path.join(d, f) for f in sorted(os.listdir(d))]
        rates[key] = _decode_rates(dec, files)
        print(f"decode + letterbox to 512, {what}: "
              f"{rates[key][0]:.1f} imgs/s one by one, {rates[key][1]:.1f} "
              f"through the batch API (best of 3)")
    return {"route": route, "errs": errs, "rates": rates}


def _capture_exports(inf) -> list:
    """Wrap ``inf._export_batch`` to keep each batch's slot scores and
    pasted masks > 0.5 (host copies) for the checks."""
    kept = []
    export = inf._export_batch

    def wrapped(bi, batch, full, scores, **kw):
        pasted, _, _ = inf._paste_batch(batch, full)
        kept.append(((pasted > 0.5).cpu().numpy(), scores.copy()))
        del pasted
        return export(bi, batch, full, scores, **kw)

    inf._export_batch = wrapped
    return kept


def _image_id(path: str):
    """``predict_paths``'s COCO id of a file: its stem, an int if all
    digits."""
    import os

    stem = os.path.splitext(os.path.basename(path))[0]
    return int(stem) if stem.isdecimal() else stem


def _entries_by_image(res_path: str, paths: list) -> list:
    with open(res_path) as f:
        entries = json.load(f)
    return [[e for e in entries if e["image_id"] == _image_id(p)]
            for p in paths]


def run_predict_paths(dev, cfg, sd, paths: list, root: str) -> dict:
    """Phase 9: ``predict_paths`` at full width (bf16, batch 8) on the 20
    files with a results file and PNGs: 9 ``upsample_int`` and 1
    ``upsample_sigmoid`` launches a batch and nothing else; every PNG at
    its image's original size; one RLE entry per kept slot (score at the
    threshold, pasted mask not empty), in slot order, each decoding to
    that slot's pasted mask > 0.5 with its score. Then the wall clock of
    a second call."""
    import os

    from basi_tpu_torch.data.coco import rle_decompress, rle_to_mask
    from basi_tpu_torch.data.native import image_size
    from basi_tpu_torch.data.png import read_png
    from basi_tpu_torch.infer import Inferencer

    inf = Inferencer(cfg, state_dict=sd)  # the default device
    _require(inf.device == dev, f"Inferencer ran on {inf.device}")
    bs = cfg.infer.batch_size
    n_b = -(-len(paths) // bs)
    out_dir = os.path.join(root, "pngs")
    res_path = os.path.join(root, "results.json")
    captured = _capture_exports(inf)
    _zero_kernel_counts()
    t0 = time.perf_counter()
    summary = inf.predict_paths(paths, out_dir=out_dir, results_path=res_path)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = _kernel_counts()
    print(f"predict_paths, val_v4-8_ap ({cfg.infer.dtype or cfg.model.dtype}"
          f", batch {bs}): {len(paths)} files in {n_b} batches in "
          f"{first:.3f} s (first call, set-up and the checks' extra paste "
          f"included); launches {launches}")
    _require(launches == dict(_zero_counts(), upsample_int=9 * n_b,
                              upsample_sigmoid=n_b),
             f"expected 9 upsample_int and 1 upsample_sigmoid launch per "
             f"batch x {n_b}, nothing else; got {launches}")
    thr = cfg.infer.score_threshold
    n_kept = 0
    for i, (p, s, got) in enumerate(zip(paths, summary,
                                        _entries_by_image(res_path, paths))):
        oh, ow = image_size(p)
        stem = os.path.splitext(os.path.basename(p))[0]
        png, _ = read_png(os.path.join(out_dir, stem + ".png"))
        _require(png.shape == (oh, ow), f"{stem}.png is {png.shape}, the "
                 f"image {oh}x{ow}")
        on, scores = captured[i // bs][0][i % bs], captured[i // bs][1][i % bs]
        kept = [j for j, sc in enumerate(scores)
                if sc >= thr and sc > 0 and on[j, :oh, :ow].any()]
        _require(len(got) == s["instances"] == len(kept),
                 f"{stem}: {len(got)} entries, {s['instances']} instances, "
                 f"{len(kept)} kept slots")
        for e, j in zip(got, kept):
            _require(e["segmentation"]["size"] == [oh, ow],
                     f"{stem}: an RLE of size {e['segmentation']['size']}")
            m = rle_to_mask(rle_decompress(e["segmentation"]["counts"]),
                            oh, ow)
            _require(np.array_equal(m, on[j, :oh, :ow])
                     and e["score"] == float(scores[j]),
                     f"{stem}: entry of slot {j} is not its pasted mask")
        n_kept += len(kept)
    _require(n_kept > 0, "predict_paths kept no instance: checks nothing")
    del inf._export_batch
    t0 = time.perf_counter()
    inf.predict_paths(paths, out_dir=out_dir, results_path=res_path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"  {n_kept} kept instances, each RLE entry its slot's pasted "
          f"mask, every PNG at its image's size; second call {wall:.3f} s "
          f"= {len(paths) / wall:.2f} imgs/s by the wall clock (decode, "
          f"forward, paste to canvases up to 1536x1024, PNG and RLE "
          f"encode)")
    del inf
    torch.cuda.empty_cache()
    return {"imgs_per_s": len(paths) / wall, "first_s": first}


def check_predict_f32(dev, sd, paths: list, root: str) -> None:
    """Phase 9, card against CPU in f32 on 4 files (one batch): the same
    kept slots and scores within 1e-3, the pasted probabilities within
    1e-3, and every RLE mask equal but at pixels where a slot's pasted
    probability lies within 1e-3 of 0.5 on either side."""
    import os

    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.data.coco import rle_decompress, rle_to_mask
    from basi_tpu_torch.data.datasets import letterbox_params
    from basi_tpu_torch.data.native import NativeDecoder
    from basi_tpu_torch.infer import Inferencer

    cfg = get_config("val_v4-8_ap", ["data.dataset=synthetic",
                                     "infer.batch_size=4",
                                     "infer.dtype=float32"])
    four = [paths[0], paths[7], paths[16], paths[-1]]  # PNG x 2, photo, grey
    imgs, hws = NativeDecoder().decode_letterbox_batch(four, 512)
    batch = {"orig_hw": hws, "num_real": 4, "valid_hw": np.array(
        [letterbox_params(int(h), int(w), 512) for h, w in hws], np.int32)}
    sides = []
    for device in (dev, "cpu"):
        inf = Inferencer(cfg, device=device, state_dict=sd)
        res_path = os.path.join(root, f"f32_{device}.json")
        summary = inf.predict_paths(four, out_dir=os.path.join(
            root, f"f32_{device}"), results_path=res_path)
        with torch.inference_mode():
            masks, _, _ = inf.predict_batch(imgs)
            pasted, _, _ = inf._paste_batch(batch, inf.full_res_masks(masks))
        sides.append((summary, _entries_by_image(res_path, four),
                      pasted.cpu().numpy()))
        del inf, masks, pasted
    (s_d, e_d, p_d), (s_c, e_c, p_c) = sides
    err = float(np.abs(p_d - p_c).max())
    near = ((np.abs(p_d - 0.5) <= 1e-3) | (np.abs(p_c - 0.5) <= 1e-3)).any(1)
    _require([s["instances"] for s in s_d] == [s["instances"] for s in s_c],
             "f32 predict_paths: other instance counts on the card")
    score_err = max([abs(a - b) for x, y in zip(s_d, s_c)
                     for a, b in zip(x["scores"], y["scores"])] + [0.0])
    _require(score_err <= 1e-3, f"f32 predict_paths: scores {score_err}")
    _require(err <= 1e-3, f"f32 pasted probabilities differ by {err}")
    apart = n = 0
    for i in range(4):
        for a, b in zip(e_d[i], e_c[i]):
            h, w = a["segmentation"]["size"]
            ma = rle_to_mask(rle_decompress(a["segmentation"]["counts"]), h, w)
            mb = rle_to_mask(rle_decompress(b["segmentation"]["counts"]), h, w)
            diff = ma != mb
            apart += int(diff.sum())
            n += 1
            _require(not (diff & ~near[i][:h, :w]).any(),
                     "f32: an RLE pixel apart away from 0.5")
    _require(n > 0, "f32 predict_paths kept no instance: checks nothing")
    print(f"f32 predict_paths card vs cpu (4 files): pasted probabilities max "
          f"diff {err:.2e}, scores {score_err:.2e}, {n} entries, {apart} RLE "
          f"pixels apart (each within 1e-3 of 0.5)")


def _folder_overrides(root: str, gt_dir: str) -> list:
    return ["data.dataset=folder", f"data.root={root}",
            "infer.ap_at_original=true", f"infer.native_gt_cache={gt_dir}"]


def _time_folder_eval(dev, sd, root: str, gt_dir: str) -> dict:
    """bf16 ``evaluate`` of ``bench_accuracy`` on one folder, after a warm
    call and ``FolderDataset.get_batch`` of 16 images timed (3 rounds):
    every metric finite, ``FILE_EVAL_IMAGES`` images, 9 ``upsample_int``
    and 1 ``upsample_sigmoid`` launches a batch and nothing else."""
    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.data.datasets import make_dataset
    from basi_tpu_torch.data.native_gt import NativeGTCache
    from basi_tpu_torch.infer import Inferencer

    cfg = get_config("bench_accuracy", _folder_overrides(root, gt_dir))
    ds = make_dataset(cfg.data, split="val")
    _require(type(ds).__name__ == "FolderDataset"
             and len(ds) == FILE_EVAL_IMAGES, f"the folder dataset {root}")
    t0 = time.perf_counter()
    cache = NativeGTCache(ds, gt_dir)
    _require(cache.on_disk, "the folder's native-GT cache is not on disk")
    gt_s = time.perf_counter() - t0
    ds.get_batch(range(16))  # warm
    t0 = time.perf_counter()
    for _ in range(3):
        ds.get_batch(range(16, 32))
    get_ms = 1000 * (time.perf_counter() - t0) / 3
    inf = Inferencer(cfg, state_dict=sd)
    n_b = FILE_EVAL_IMAGES // cfg.infer.batch_size
    inf.evaluate(make_dataset(cfg.data, split="val"))  # warm
    _zero_kernel_counts()
    t0 = time.perf_counter()
    m = inf.evaluate(make_dataset(cfg.data, split="val"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    _require(launches == dict(_zero_counts(), upsample_int=9 * n_b,
                              upsample_sigmoid=n_b),
             f"folder evaluate: expected 9 upsample_int and 1 "
             f"upsample_sigmoid per batch x {n_b}; got {launches}")
    _require(m["num_images"] == FILE_EVAL_IMAGES
             and all(np.isfinite(v) for v in m.values()),
             "folder evaluate: non-finite metrics")
    del inf
    torch.cuda.empty_cache()
    return {"gt_s": gt_s, "get_batch_ms": get_ms, "wall_s": wall,
            "imgs_per_s": FILE_EVAL_IMAGES / wall, "metrics": m,
            "launches": launches}


def run_folder_eval(dev, sd, roots: dict, synthetic_rate) -> dict:
    """Phase 9: ``evaluate`` of ``bench_accuracy`` on the folders (batch
    16, the original frame, the native-GT cache built first). On the
    scenes, f32 on the card and on the CPU over ``F32_FOLDER_BATCHES``
    batches (AP/AR equal, saliency means within 1e-4, phase 7's rule) and
    one batch of
    4 held as phase 7 holds its own (``check_eval_f32``); then bf16 on
    each folder (``_time_folder_eval``), the photographs as JPEG beside
    the same photographs as PNG."""
    import shutil
    import tempfile

    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.data.datasets import make_dataset
    from basi_tpu_torch.infer import Inferencer

    gt_dirs = {k: tempfile.mkdtemp(prefix=f"basi_{k}_gt_") for k in roots}
    try:
        out = {k: _time_folder_eval(dev, sd, roots[k], gt_dirs[k])
               for k in roots}
        f32 = _folder_overrides(roots["scenes"], gt_dirs["scenes"]) + [
            "model.dtype=float32", "infer.dtype=float32"]
        ms = {}
        for device in (dev, "cpu"):
            fcfg = get_config("bench_accuracy", f32)
            t0 = time.perf_counter()
            ms[device if device == "cpu" else "card"] = Inferencer(
                fcfg, device=device, state_dict=sd).evaluate(
                make_dataset(fcfg.data, split="val"),
                max_batches=F32_FOLDER_BATCHES)
            print(f"  f32 folder evaluate on {device} in "
                  f"{time.perf_counter() - t0:.1f} s")
        a, b = _metrics_only(ms["card"]), _metrics_only(ms["cpu"])
        sal_err = max(abs(a[k] - b[k]) for k in b if k.startswith("saliency"))
        _require(set(a) == set(b) and a["num_images"]
                 == F32_FOLDER_BATCHES * fcfg.infer.batch_size,
                 "f32 folder evaluate: other metric keys on the card")
        _require(all(a[k] == b[k] for k in b if k[:2] in ("AP", "AR", "mA")),
                 "f32 folder evaluate: AP/AR differ between card and CPU")
        _require(sal_err <= 1e-4, f"f32 folder evaluate: a saliency metric "
                 f"{sal_err} beyond 1e-4")
        print(f"f32 folder evaluate card vs cpu ({a['num_images']} scenes): "
              f"AP/AR equal, saliency max diff {sal_err:.2e}; card "
              f"{json.dumps(a)}")
        check_eval_f32(dev, sd, _folder_overrides(roots["scenes"], ""),
                       "f32 folder eval")
        for k, what in (("scenes", "32 PNG scenes (scale 1.5)"),
                        ("photos_jpeg", "32 JPEG photographs"),
                        ("photos_png", "the same 32 photographs as PNG")):
            r = out[k]
            print(f"folder evaluate, bench_accuracy original frame (bf16, "
                  f"batch 16, native-GT cache built in {r['gt_s']:.2f} s), "
                  f"{what}: {r['wall_s']:.3f} s = {r['imgs_per_s']:.1f} "
                  f"imgs/s by the wall clock; infer_ms_per_batch "
                  f"{r['metrics']['infer_ms_per_batch']}, imgs_per_s "
                  f"{r['metrics']['imgs_per_s']}; get_batch of 16 "
                  f"{r['get_batch_ms']:.1f} ms; launches {r['launches']}")
        print(f"  (phase 7's synthetic scenes: {synthetic_rate} imgs/s); "
              f"scenes' metrics {json.dumps(_metrics_only(out['scenes']['metrics']))}")
    finally:
        for d in gt_dirs.values():
            shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def check_files(dev, gen, synthetic_rate, root: str) -> dict:
    """Phase 9: the decoder, ``predict_paths`` and folder ``evaluate``, in
    ``root``. Returns what phase 10 holds its command line against: the
    weights, the predict paths and outputs, the folders and the scenes'
    bf16 metrics."""
    from basi_tpu_torch.config import get_config

    jpegs = jpeg_fixtures()
    paths, roots = write_file_fixtures(root, jpegs)
    dec = check_decoder(paths, jpegs, roots)
    cfg = get_config("val_v4-8_ap", ["data.dataset=synthetic"])
    sd = smoke_weights(cfg, gen)
    pred = run_predict_paths(dev, cfg, sd, paths, root)
    check_predict_f32(dev, sd, paths, root)
    ev = run_folder_eval(dev, sd, roots, synthetic_rate)
    rates = {k: [round(v, 1) for v in r] for k, r in dec["rates"].items()}
    print(f"phase 9 summary ({dec['route']}): decode + letterbox imgs/s "
          f"[one by one, batched] {json.dumps(rates)}; get_batch of 16 "
          f"ms {json.dumps({k: round(r['get_batch_ms'], 1) for k, r in ev.items()})}; "
          f"predict_paths {pred['imgs_per_s']:.2f} imgs/s; folder "
          f"evaluate imgs/s by the wall clock "
          f"{json.dumps({k: round(r['imgs_per_s'], 1) for k, r in ev.items()})}")
    return {"sd": sd, "paths": paths, "roots": roots, "jpegs": jpegs,
            "scenes_metrics": ev["scenes"]["metrics"]}


# --- phase 10: the entry points ---------------------------------------------------

ROOT = Path(__file__).resolve().parent
SERVE_REQUESTS, SERVE_CLIENTS = 64, 16
BENCH_PROFILED_BATCHES = 32


def _cli(*args: str, timeout: float = 900) -> str:
    """``python -m basi_tpu_torch.cli *args`` from the checkout, on the
    default device (the card); its standard output. A non-zero exit
    prints the end of both streams and raises; a process past
    ``timeout`` is killed."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "basi_tpu_torch.cli", *args],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode:
        print(r.stdout[-3000:])
        print(r.stderr[-6000:], file=sys.stderr)
        raise RuntimeError(f"cli {' '.join(args[:3])} exited {r.returncode}")
    print(f"  cli {' '.join(args[:3])} ...: {time.perf_counter() - t0:.1f} s")
    return r.stdout


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _sets(overrides: list) -> list:
    return [a for o in overrides for a in ("--set", o)]


def profile_infer_window(dev) -> None:
    """Phase 10: ``torch.profiler`` over one ``bench --mode infer`` window
    of ``BENCH_PROFILED_BATCHES`` batches (the benchmark's own setup):
    device ms per batch and the device's busy share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from basi_tpu_torch import benchmark

    _, inf, batches = benchmark.infer_setup(iters=BENCH_PROFILED_BATCHES,
                                            device=dev)
    float(benchmark.infer_window(inf, batches))  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(benchmark.infer_window(inf, batches))
        wall = (time.perf_counter() - t0) * 1e3
    device_ms = sum(evt.self_device_time_total for evt in prof.key_averages()
                    if evt.device_type == DeviceType.CUDA
                    and not evt.is_user_annotation) / 1e3
    n = BENCH_PROFILED_BATCHES
    print(f"bench infer window, profiled ({n} batches of 8): host "
          f"{wall / n:.3f} ms/batch with the profiler on, device "
          f"{device_ms / n:.3f} ms/batch: busy {100 * device_ms / wall:.1f}%")
    del inf, batches
    torch.cuda.empty_cache()


def run_cli_bench(dev) -> dict:
    """Phase 10: ``bench --mode infer``, ``--mode train`` (the preset's
    f32, and bf16), ``--mode e2e`` through the command line at the
    reference's defaults; each prints its JSON line, whose launches per
    batch or step must be the path's kernels."""
    runs = {
        "infer": (["--mode", "infer"], {"upsample_int": 9.0}),
        "train_f32": (["--mode", "train"], {"normalize_and_flip": 1.0}),
        "train_bf16": (["--mode", "train", "--set", "model.dtype=bfloat16"],
                       {"upsample_int": 9.0, "upsample_int_bwd": 9.0,
                        "normalize_and_flip": 1.0}),
        "e2e": (["--mode", "e2e"], None),
    }
    out = {}
    for name, (args, launches) in runs.items():
        line = _last_json(_cli("bench", *args, timeout=900))
        print(f"bench {name}: {json.dumps(line)}")
        _require({"metric", "value", "unit"} <= set(line)
                 and "vs_baseline" not in line and line["value"] > 0,
                 f"bench {name}: {line}")
        _require(line["device"] == torch.cuda.get_device_name(0),
                 f"bench {name} ran on {line['device']}")
        if launches is not None:
            got = line.get("launches_per_batch", line.get("launches_per_step"))
            _require(got == launches, f"bench {name}: launches {got}, "
                     f"expected {launches}")
        out[name] = line
    _require(out["e2e"]["device_infer_imgs_per_s"] > 0, "e2e infer rate")
    profile_infer_window(dev)
    return out


def _post(url: str, data: bytes, timeout: float = 120):
    """(status, JSON body, seconds) of one POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "image/png"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0


def _served_label(out: dict) -> np.ndarray:
    import base64

    from basi_tpu_torch.data.png import decode_png, pil_view

    return pil_view(decode_png(base64.b64decode(out["label_png_b64"])))[0]


def _direct_answer(inf, data: bytes) -> tuple[np.ndarray, list]:
    """What ``Inferencer.predict_batch`` + ``full_res_masks`` give for an
    upload's canvas on the card: (label map of the content, scores)."""
    from basi_tpu_torch.data.datasets import letterbox_params
    from basi_tpu_torch.data.letterbox import resize_bilinear_u8
    from basi_tpu_torch.infer import to_numpy
    from basi_tpu_torch.server import decode_upload, label_map

    cfg = inf.cfg
    size = cfg.model.image_size
    img = decode_upload(data)
    vh, vw = letterbox_params(*img.shape[:2], size)
    batch = np.zeros((cfg.infer.batch_size, size, size, 3), np.uint8)
    batch[0, :vh, :vw] = resize_bilinear_u8(img, vh, vw)
    masks, scores, _ = inf.predict_batch(batch)
    full = to_numpy(inf.full_res_masks(masks[:1]))[0]
    s = to_numpy(scores)[0]
    lab, order = label_map(full, s, cfg.infer.score_threshold,
                           cfg.infer.mask_threshold)
    return lab[:vh, :vw], [round(float(s[i]), 4) for i in order]


# the load generator, a process of its own (its threads do not share the
# server's interpreter lock): POSTs each file named on stdin (JSON: url,
# files, clients) from that many threads and prints, per request, its
# status, body and seconds
_CLIENT = """
import json, sys, time, urllib.error, urllib.request
from concurrent.futures import ThreadPoolExecutor
job = json.load(sys.stdin)
bodies = [open(f, "rb").read() for f in job["files"]]

def post(data):
    req = urllib.request.Request(job["url"], data=data, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, body = e.code, json.loads(e.read())
    return code, body, time.perf_counter() - t0

with ThreadPoolExecutor(job["clients"]) as pool:
    t0 = time.perf_counter()
    out = list(pool.map(post, bodies))
    wall = time.perf_counter() - t0
json.dump({"answers": out, "wall": wall}, sys.stdout)
"""


def _load(url: str, files: list, clients: int) -> tuple[list, float]:
    """(answers, wall seconds) of ``_CLIENT`` posting ``files``."""
    r = subprocess.run([sys.executable, "-c", _CLIENT], cwd=ROOT,
                       input=json.dumps({"url": url, "files": files,
                                         "clients": clients}),
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        print(r.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"the load generator exited {r.returncode}")
    out = json.loads(r.stdout)
    return out["answers"], out["wall"]


def run_server(dev, cfg, params_dir: str, uploads: list) -> dict:
    """Phase 10: ``make_server`` on an ephemeral port over the params
    export (the default device); a load generator in a process of its own
    sends 16 warm-up requests, then ``SERVE_REQUESTS`` POSTs from
    ``SERVE_CLIENTS`` client threads, counted: every answer 200, 9
    ``upsample_int`` per batch and one ``upsample_sigmoid`` per request,
    each label map and score list equal to ``Inferencer.predict_batch`` +
    ``full_res_masks`` of the same canvas on the card; ``/healthz`` 200, a
    bad body 400, a closed service 503. ``uploads``: image file paths.
    Prints latency p50/p90/p99, requests/s and the mean batch fill."""
    from basi_tpu_torch.infer import Inferencer
    from basi_tpu_torch.server import _serve_in_thread

    base, httpd, service = _serve_in_thread(cfg, checkpoint=params_dir,
                                            predict_timeout=300)
    inf = None
    try:
        p = service.predictor
        _require(p.inf.device == dev, f"the server ran on {p.inf.device}")
        code, body, _ = _get(base + "/healthz")
        _require(code == 200 and body["status"] == "ok", f"healthz {code}")
        fills = []
        run = p.inf.predict_batch

        def counted(batch):
            fills.append(1)
            return run(batch)

        p.inf.predict_batch = counted
        files = [uploads[i % len(uploads)] for i in range(SERVE_REQUESTS)]
        warm, _ = _load(base + "/predict", files[:16], SERVE_CLIENTS)
        _require(all(c == 200 for c, _, _ in warm), "warm-up requests")
        fills.clear()
        _zero_kernel_counts()
        answers, wall = _load(base + "/predict", files, SERVE_CLIENTS)
        torch.cuda.synchronize()
        launches = _kernel_counts()
        n_b = len(fills)
        codes = [c for c, _, _ in answers]
        _require(codes == [200] * SERVE_REQUESTS, f"answers {codes}")
        _require(launches == dict(_zero_counts(), upsample_int=9 * n_b,
                                  upsample_sigmoid=SERVE_REQUESTS),
                 f"expected 9 upsample_int per batch x {n_b} and one "
                 f"upsample_sigmoid per request; got {launches}")
        lat = np.array([t for _, _, t in answers]) * 1e3
        p50, p90, p99 = np.percentile(lat, [50, 90, 99])
        print(f"served {SERVE_REQUESTS} requests from {SERVE_CLIENTS} "
              f"client threads (a process of their own) in {wall:.3f} s = "
              f"{SERVE_REQUESTS / wall:.1f} requests/s; latency ms p50 "
              f"{p50:.1f} p90 {p90:.1f} p99 {p99:.1f} (max {lat.max():.1f}); "
              f"{n_b} batches, mean fill {SERVE_REQUESTS / n_b:.2f} of "
              f"{p.batch}; launches {launches}")
        inf = Inferencer(cfg, checkpoint=params_dir)
        _require(inf.device == dev, f"Inferencer ran on {inf.device}")
        direct = {}
        for path, (_, body, _) in zip(files, answers):
            if path not in direct:
                with open(path, "rb") as f:
                    direct[path] = _direct_answer(inf, f.read())
            lab, scores = direct[path]
            got = _served_label(body)
            _require(body["scores"] == scores, f"{path}: served scores "
                     f"{body['scores'][:4]} vs direct {scores[:4]}")
            _require(np.array_equal(got, lab), f"{path}: "
                     f"{int((got != lab).sum())} label pixels differ from "
                     f"predict_batch + full_res_masks")
        kept = sum(len(d[1]) for d in direct.values())
        _require(kept > 0, "the served answers kept no instance")
        print(f"  every label map and score list equal to predict_batch + "
              f"full_res_masks on the card ({len(direct)} distinct "
              f"uploads, {kept} kept instances)")
        p.inf.predict_batch = run
        code, body, _ = _post(base + "/predict", b"not an image")
        _require(code == 400, f"a bad body gave {code}")
        service.predictor.close()
        with open(uploads[0], "rb") as f:
            code, _, _ = _post(base + "/predict", f.read())
        hz, _, _ = _get(base + "/healthz")
        _require(code == 503 and hz == 503, f"closed service: {code}, {hz}")
        print("  /healthz 200, a bad body 400, a closed service 503 (and "
              "/healthz 503)")
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    del inf
    torch.cuda.empty_cache()
    return {"p50_ms": p50, "p90_ms": p90, "p99_ms": p99,
            "requests_per_s": SERVE_REQUESTS / wall,
            "fill": SERVE_REQUESTS / n_b}


def _get(url: str):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read()), 0.0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), 0.0


# run in a fresh process: load the artifact, one warm call, then one
# batch under torch.profiler (kernels named upsample_int) and the wrapper's
# launch count; the outputs go to a file
_AOT_CHILD = """
import json, sys
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from basi_tpu_torch.aot import load_serving
from basi_tpu_torch.kernels.upsample_int import upsample_int
model = load_serving(sys.argv[1])
x = torch.from_numpy(np.load(sys.argv[2]))
model(x)
torch.cuda.synchronize()
upsample_int.launches = 0
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    out = model(x)
    torch.cuda.synchronize()
n = sum(e.count for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and "upsample_int" in e.key)
torch.save([t.cpu() for t in out], sys.argv[3])
print(json.dumps({"profiler_upsample_int": n,
                  "launches": upsample_int.launches,
                  "device": str(out[0].device)}))
"""


def run_aot(dev, cfg, params_dir: str, root: str, payload: bytes) -> None:
    """Phase 10: ``export --aot`` of the params export on the card, then
    ``load_serving`` in a fresh process: its outputs on a batch equal the
    live ``predict_batch`` bit for bit, and a batch launches 9
    ``upsample_int`` kernels (profiler count and the wrapper's); then
    ``serve --aot`` answers one request."""
    import os
    import socket

    from basi_tpu_torch.infer import Inferencer

    path = os.path.join(root, "model.basiaot")
    t0 = time.perf_counter()
    meta = _last_json(_cli("export", "--preset", "val_v4-8_ap",
                           *_sets(["data.dataset=synthetic"]),
                           "--checkpoint", params_dir, "--aot", path))
    print(f"export --aot on the card: {meta} in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{os.path.getsize(path) / 1e6:.1f} MB")
    size = cfg.model.image_size
    x = np.random.RandomState(SEED).randint(
        0, 256, (cfg.infer.batch_size, size, size, 3)).astype(np.uint8)
    np.save(os.path.join(root, "aot_batch.npy"), x)
    out_file = os.path.join(root, "aot_out.pt")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _AOT_CHILD, path,
                        os.path.join(root, "aot_batch.npy"), out_file],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    if r.returncode:
        print(r.stderr[-6000:], file=sys.stderr)
        raise RuntimeError(f"load_serving in a fresh process exited "
                           f"{r.returncode}")
    child = _last_json(r.stdout)
    print(f"load_serving in a fresh process: {child} "
          f"({time.perf_counter() - t0:.1f} s)")
    _require(child["profiler_upsample_int"] == 9 and child["launches"] == 9
             and child["device"].startswith("cuda"),
             f"the artifact's batch launched {child}, expected 9 "
             f"upsample_int kernels on the card")
    got = torch.load(out_file, weights_only=True)
    inf = Inferencer(cfg, checkpoint=params_dir)
    want = [t.cpu() for t in inf.predict_batch(x)]
    for name, g, w in zip(("masks", "scores", "saliency"), got, want):
        diff = float((g.float() - w.float()).abs().max())
        _require(g.dtype == w.dtype and g.shape == w.shape
                 and torch.equal(g, w),
                 f"artifact {name} differs from predict_batch: max abs "
                 f"diff {diff}")
    print("  the artifact's masks, scores and saliency equal the live "
          "predict_batch bit for bit")
    del inf
    torch.cuda.empty_cache()

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "basi_tpu_torch.cli", "serve", "--aot", path,
         "--port", str(port)], cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.perf_counter() + 300
        while True:
            try:
                if _get(base + "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            _require(proc.poll() is None and time.perf_counter() < deadline,
                     "serve --aot did not come up")
            time.sleep(0.5)
        code, body, dt = _post(base + "/predict", payload)
        _require(code == 200 and body["model_size"] == size,
                 f"serve --aot answered {code}")
        print(f"serve --aot answered one request: 200, {len(body['scores'])} "
              f"instances, {dt * 1e3:.1f} ms")
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def check_cli_files(params_dir: str, root: str, phase9: dict) -> None:
    """Phase 10: ``predict`` and ``infer`` through the command line on
    phase 9's files, with phase 9's weights: the same PNGs and COCO
    results as its ``predict_paths``, the same metrics as its bf16 folder
    ``evaluate`` of the scenes."""
    import os

    from basi_tpu_torch.data.png import read_png

    out_dir = os.path.join(root, "cli_pngs")
    res = os.path.join(root, "cli_results.json")
    summary = _last_json(_cli(
        "predict", "--preset", "val_v4-8_ap",
        *_sets(["data.dataset=synthetic"]), "--checkpoint", params_dir,
        "--images", *phase9["paths"], "--out", out_dir, "--results", res))
    _require(summary["images"] == len(phase9["paths"]), "predict count")
    for p in phase9["paths"]:
        stem = os.path.splitext(os.path.basename(p))[0] + ".png"
        a, _ = read_png(os.path.join(out_dir, stem))
        b, _ = read_png(os.path.join(root, "pngs", stem))
        _require(np.array_equal(a, b), f"cli predict: {stem} differs")
    with open(res) as f, open(os.path.join(root, "results.json")) as g:
        _require(json.load(f) == json.load(g),
                 "cli predict: the COCO results differ")
    gt = phase9["scenes_metrics"]
    m = _last_json(_cli(
        "infer", "--preset", "bench_accuracy",
        *_sets(_folder_overrides(phase9["roots"]["scenes"], "")),
        "--checkpoint", params_dir))
    a, b = _metrics_only(m), _metrics_only(gt)
    _require(a == b, f"cli infer: {a} vs phase 9's {b}")
    print(f"cli predict ({len(phase9['paths'])} files) and infer (32 "
          f"scenes) equal phase 9's PNGs, results and metrics")


def check_entry_points(dev, phase9: dict, root: str) -> None:
    """Phase 10: the entry points at ``val_v4-8_ap``, full width, on
    phase 9's seeded weights written through ``export --out``."""
    import os

    from basi_tpu_torch.config import get_config

    pth = os.path.join(root, "weights.pth")
    torch.save(phase9["sd"], pth)
    params_dir = os.path.join(root, "params")
    _cli("export", "--preset", "val_v4-8_ap", "--checkpoint", pth,
         "--out", params_dir)
    cfg = get_config("val_v4-8_ap", ["data.dataset=synthetic"])
    bench = run_cli_bench(dev)
    uploads = list(phase9["paths"][:16])
    for k, fx in phase9["jpegs"].items():  # the photographs, RGB, 4:2:2
        if k.startswith("photo") or k in ("rgb", "422"):
            uploads.append(os.path.join(root, f"upload_{k}.jpg"))
            with open(uploads[-1], "wb") as f:
                f.write(fx["bytes"])
    served = run_server(dev, cfg, params_dir, uploads)
    with open(uploads[0], "rb") as f:
        run_aot(dev, cfg, params_dir, root, f.read())
    check_cli_files(params_dir, root, phase9)
    print(f"phase 10 summary: bench infer {bench['infer']['value']} "
          f"imgs/s, train {bench['train_f32']['value']} ms/step (f32), "
          f"{bench['train_bf16']['value']} (bf16), e2e "
          f"{bench['e2e']['value']} imgs/s; serve "
          f"{served['requests_per_s']:.1f} requests/s, p50/p90/p99 "
          f"{served['p50_ms']:.1f}/{served['p90_ms']:.1f}/"
          f"{served['p99_ms']:.1f} ms, fill {served['fill']:.2f}")


# --- phase 11: the rest of training -------------------------------------------

# train_multiscale_fused at full width on the synthetic scenes (the ILSO
# images are not in the repository): 96 train scenes, 6 steps an epoch,
# 24 val images (3 eval batches of infer.batch_size 8)
MULTISCALE = ["data.dataset=synthetic", "data.synthetic_n=96",
              "train.checkpoint_dir=", "train.log_every=1"]
MULTISCALE_STEPS = 4  # counted steps; the epoch's other 2 end in its eval
# each setting alone on top of the preset
SETTINGS = {
    "color_jitter": ["data.color_jitter=0.2,0.2,0.2"],
    "grad_accum": ["train.grad_accum=2"],
    "freeze_bn_xla": ["train.freeze_bn=true"],
    "freeze_bn_fused": ["train.freeze_bn=true", "model.bn_impl=fused"],
    "adamw": ["train.optimizer=adamw"],
    "remat": ["train.remat=true"],
    "remat_fused": ["train.remat=true", "model.bn_impl=fused"],
    "dense_loss": ["train.max_pos_cells=0"],
    "basnet_hybrid": ["train.loss=basnet_hybrid"],
    "bf16_params": ["model.param_dtype=bfloat16"],
}
SETTING_WARMUP, SETTING_STEPS = 2, 5


def _moved(before: dict, after: dict) -> int:
    return sum(not torch.equal(before[k], after[k]) for k in before)


def run_multiscale(dev) -> dict:
    """Phase 11: ``Trainer.train`` of ``train_multiscale_fused`` at full
    width on the default device: ``MULTISCALE_STEPS`` steps with their
    launches, then the rest of the epoch and its eval (``[val]``); returns
    the counted steps' launches."""
    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.train.loop import Trainer

    cfg = get_config("train_multiscale_fused", MULTISCALE)
    trainer = Trainer(cfg)
    _require(trainer.device == dev, f"Trainer ran on {trainer.device}")
    model = trainer.state.model
    params0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    stats0 = {k: b.clone() for k, b in model.named_buffers()
              if k.endswith(("running_mean", "running_var"))}
    _zero_kernel_counts()
    t0 = time.perf_counter()
    trainer.train(max_steps=MULTISCALE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    want = {k: n * MULTISCALE_STEPS for k, n in per_step_launches(cfg).items()}
    print(f"trained {MULTISCALE_STEPS} steps of train_multiscale_fused "
          f"({cfg.model.backbone}, FPN {cfg.model.fpn_channels}, "
          f"{cfg.model.image_size}^2, {cfg.model.dtype} on "
          f"{cfg.model.param_dtype} params, batch {cfg.data.batch_size}, "
          f"scale jitter {cfg.data.scale_range}) in {wall:.2f} s, first-call "
          f"set-up included; launches {launches}")
    _require(launches == want, f"multiscale: expected {want}, got {launches}")
    recs = trainer.records
    _require(len(recs) == MULTISCALE_STEPS and all(
        np.isfinite(v) for r in recs for v in r.values()),
        f"multiscale [train] records {recs}")
    print(f"losses {[round(r['loss'], 4) for r in recs]}, step_ms "
          f"{[round(r['step_ms'], 1) for r in recs]}")
    n_p = _moved(params0, dict(model.named_parameters()))
    n_s = _moved(stats0, dict(model.named_buffers()))
    _require(n_p == len(params0) and n_s == len(stats0),
             f"multiscale: {n_p}/{len(params0)} params and {n_s}/"
             f"{len(stats0)} BN statistics moved")
    left = trainer.steps_per_epoch - MULTISCALE_STEPS
    n_val = len(trainer.val_dataset)
    batches = -(-n_val // cfg.infer.batch_size)
    _zero_kernel_counts()
    last = trainer.train()
    torch.cuda.synchronize()
    got = _kernel_counts()
    want = {k: n * left for k, n in per_step_launches(cfg).items()}
    want["upsample_int"] += 9 * batches
    want["upsample_sigmoid"] = batches
    print(f"the epoch's other {left} steps and its eval ({n_val} val images, "
          f"{batches} batches): launches {got}; [val] saliency_S "
          f"{last.get('saliency_S')}, mAP {last.get('mAP')}, "
          f"{last.get('num_images')} images")
    _require(got == want, f"multiscale epoch end: expected {want}, got {got}")
    _require(last.get("num_images") == n_val and np.isfinite(
        last["saliency_S"]), f"multiscale eval: {last}")
    del trainer, model, params0, stats0
    torch.cuda.empty_cache()
    return launches


def run_cli_train() -> None:
    """Phase 11: ``basi-torch train --preset train_multiscale_fused`` as a
    process of its own (the command line's entry point): one epoch of 2
    steps and its eval, a finite loss and the eval's metrics in its
    ``final`` record."""
    out = _cli("train", "--preset", "train_multiscale_fused", *_sets([
        "data.dataset=synthetic", "data.synthetic_n=32",
        "train.checkpoint_dir=", "train.log_every=1"]))
    final = _last_json(out)["final"]
    print(f"  cli train final: loss {final['loss']:.4f}, step {final['step']}"
          f", [val] saliency_S {final.get('saliency_S')}")
    _require(final["step"] == 2 and np.isfinite(final["loss"])
             and final.get("num_images") == 8, f"cli train: {final}")


def time_settings(dev) -> dict:
    """Phase 11: each of ``SETTINGS`` alone on the preset at full width, and
    the preset plain (first and last), on one repeated batch:
    ``SETTING_WARMUP`` steps, then ``SETTING_STEPS`` timed by CUDA events
    with the launches counted and the peak of ``max_memory_allocated``;
    the losses finite, the launches ``per_step_launches``'s, remat's peak
    below the plain step's; the first plain run's steps profiled
    (``_profile``). Returns {setting: (ms, peak GiB)}."""
    import gc

    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.train.loop import Trainer

    runs = [("plain", [])] + list(SETTINGS.items()) + [("plain again", [])]
    out = {}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for name, ov in runs:
        cfg = get_config("train_multiscale_fused", MULTISCALE + ov)
        trainer = Trainer(cfg, device=dev)
        feed = trainer.feed.epoch(0)
        batch = next(feed)
        feed.close()
        losses = [trainer.train_step(trainer.state, batch)["loss"]
                  for _ in range(SETTING_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_kernel_counts()
        start.record()
        for _ in range(SETTING_STEPS):
            losses.append(trainer.train_step(trainer.state, batch)["loss"])
        end.record()
        torch.cuda.synchronize()
        launches = _kernel_counts()
        ms = start.elapsed_time(end) / SETTING_STEPS
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        losses = [float(v) for v in losses]
        want = {k: n * SETTING_STEPS
                for k, n in per_step_launches(cfg).items()}
        print(f"setting {name}: {ms:.3f} ms/step ({SETTING_STEPS} steps, "
              f"CUDA events), peak {peak:.3f} GiB allocated, losses "
              f"{[round(v, 4) for v in losses]}, launches per step "
              f"{ {k: v // SETTING_STEPS for k, v in launches.items() if v} }")
        _require(all(np.isfinite(losses)), f"setting {name}: a loss is not "
                 "finite")
        _require(launches == want, f"setting {name}: expected {want}, got "
                 f"{launches}")
        out[name] = (ms, peak)
        if name == "plain":
            _profile(lambda: trainer.train_step(trainer.state, batch),
                     "xla, train_multiscale_fused, plain steps")
        del trainer, batch
        gc.collect()
        torch.cuda.empty_cache()
    _require(out["remat"][1] < out["plain"][1]
             and out["remat_fused"][1] < out["plain"][1],
             f"remat did not lower the peak: {out}")
    return out


def time_scale_jitter(dev, gen) -> None:
    """Phase 11: ``random_augment`` alone at the preset's shapes (16 bf16
    images and 8 f32 masks each at 512^2), CUDA events, warm, beside its
    bound: 2 axes x 16 images x 2 * 512^3 * (3 + 8) f32 operations over
    67 TFLOP/s (the bytes, about 0.3 GB, take a tenth of that)."""
    from basi_tpu_torch.data.transforms import random_augment

    n, m, hw = 16, 8, 512
    imgs = torch.randn((n, hw, hw, 3), generator=gen).to(dev, torch.bfloat16)
    masks = (torch.rand((n, m, hw, hw), generator=gen) > 0.7).float().to(dev)
    draws = [(torch.rand(n, generator=gen) * 0.5 + 0.75).to(dev),
             torch.rand(n, generator=gen).to(dev),
             torch.rand(n, generator=gen).to(dev)]
    ms = _time_ms(lambda: random_augment(imgs, masks, *draws))
    flops = 2 * n * 2 * hw ** 3 * (3 + m)
    nbytes = 2 * (imgs.numel() * 2 + masks.numel() * 4)
    bound, by = _bound(nbytes, flops)
    print(f"scale jitter (random_augment, {n} x {hw}^2, 3 bf16 channels and "
          f"{m} f32 masks): {ms:.3f} ms (CUDA events, warm); bound "
          f"{bound:.3f} ms by {by} ({flops / 1e9:.1f} GFLOP true f32)")


def check_settings_f32(dev) -> None:
    """Phase 11: one f32 step of the tiny config on the card against the
    CPU for the preset's multiscale and each setting on top of it
    (``check_f32_step``)."""
    base = ["data.multiscale=true", "data.hflip_prob=0.5"]
    check_f32_step(dev, "xla", base, "multiscale")
    for name, ov in SETTINGS.items():
        check_f32_step(dev, "xla", base + ov, f"multiscale + {name}")


# Phase 12: the roi mechanism
ROI = ["model.instance_mechanism=roi"]
ROI_SERVE_F32_BATCH = 2  # the CPU's f32 forward at full width
ROI_TRAIN = ["data.synthetic_n=64"]  # 48 train scenes
ROI_TRAIN_STEPS = 2
ROI_EVAL = ["data.synthetic_n=128", "infer.ap_at_original=true"]  # 32 val
ROI_EDGE = 1e-5


def roi_smoke_weights(cfg, gen):
    """Seeded f32 state dict of a roi model: objectness bias 0 and its
    kernel 10 times wider, the ROI mask head's ``out`` kernel 300 times
    wider (scores and mask probabilities spread away from their ties, so
    card and CPU rank and binarize alike), non-trivial BN statistics."""
    from basi_tpu_torch.models.basi import create_model

    model = create_model(cfg.model, "cpu", gen)
    with torch.no_grad():
        model.roi_box.score.bias.zero_()
        model.roi_box.score.weight.mul_(10.0)
        model.roi_mask.out.weight.mul_(300.0)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(
                    torch.randn(m.running_mean.shape, generator=gen) * 0.1)
                m.running_var.copy_(
                    torch.rand(m.running_var.shape, generator=gen) + 0.5)
    return model.state_dict()


def _edge_pixels(boxes: torch.Tensor, hw) -> torch.Tensor:
    """(N, h, w) True where a pixel's row or column centre lies within
    ``ROI_EDGE`` of an edge of one of the image's boxes (N, K, 4): where
    the paste's inside test may differ between boxes one ulp apart."""
    h, w = hw
    py = (torch.arange(h, dtype=torch.float64) + 0.5) / h
    px = (torch.arange(w, dtype=torch.float64) + 0.5) / w
    b = boxes.double().cpu()
    rows = ((py - b[..., 0:1]).abs() <= ROI_EDGE) | (
        (py - b[..., 2:3]).abs() <= ROI_EDGE)
    cols = ((px - b[..., 1:2]).abs() <= ROI_EDGE) | (
        (px - b[..., 3:4]).abs() <= ROI_EDGE)
    return rows.any(1)[:, :, None] | cols.any(1)[:, None, :]


def run_roi_serving(dev, gen) -> dict:
    """Phase 12: ``predict_batch`` + ``full_res_masks`` at ``val_v4-8_ap``
    with the roi mechanism (ResNet-50, FPN 256, bf16, batch 8, 512^2,
    ``roi_top_k`` 64, R 28) on the default device: 9 ``upsample_int`` and
    1 ``upsample_sigmoid`` launch and nothing else, finite slots, some
    filled; ms per batch (CUDA events) and a profiled batch; the
    AOT artifact equal to ``predict_batch`` bit for bit. Returns the
    counted launches."""
    import os
    import tempfile

    from basi_tpu_torch.aot import load_serving, save_serving
    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.infer import Inferencer

    cfg = get_config("val_v4-8_ap", ["data.dataset=synthetic"] + ROI)
    sd = roi_smoke_weights(cfg, gen)
    inf = Inferencer(cfg, state_dict=sd)
    _require(inf.device == dev, f"Inferencer ran on {inf.device}")
    n, size, k = cfg.infer.batch_size, cfg.model.image_size, \
        cfg.model.num_slots
    images = torch.randint(0, 256, (n, size, size, 3), generator=gen,
                           dtype=torch.uint8)
    batch = images.to(dev)
    inf.predict_batch(batch)  # first-call set-up
    torch.cuda.synchronize()
    _zero_kernel_counts()
    masks, scores, sal = inf.predict_batch(batch)
    full = inf.full_res_masks(masks)
    torch.cuda.synchronize()
    launches = _kernel_counts()
    print(f"roi serving (val_v4-8_ap, {cfg.model.backbone}, "
          f"{str(inf.dtype)[6:]}, batch {n}, {size}^2, roi_top_k "
          f"{cfg.model.roi_top_k}, R {cfg.model.roi_resolution}): launches "
          f"{ {a: b for a, b in launches.items() if b} }")
    _require(launches == dict(_zero_counts(), upsample_int=9,
                              upsample_sigmoid=1),
             f"roi serving: expected 9 upsample_int and 1 upsample_sigmoid "
             f"launch, nothing else; got {launches}")
    _require(tuple(masks.shape) == (n, k, size // 4, size // 4)
             and tuple(full.shape) == (n, k, size, size), "roi slot shapes")
    _require(bool(torch.isfinite(masks.float()).all())
             and bool(torch.isfinite(scores).all())
             and bool(torch.isfinite(full).all()), "non-finite roi slots")
    filled = int((scores > 0).sum())
    _require(all(bool((scores[i] > 0).any()) for i in range(n)),
             "an image filled no roi slot")
    ms = _time_ms(lambda: inf.predict_batch(batch), iters=10)
    print(f"roi predict_batch: {ms:.3f} ms/batch = {n * 1000.0 / ms:.1f} "
          f"imgs/s (CUDA events, 10 batches); slots filled {filled} of "
          f"{n * k}")
    _profile(lambda: inf.predict_batch(batch), "roi predict_batch")

    root = tempfile.mkdtemp(prefix="basi_roi_aot_")
    try:
        path = os.path.join(root, "roi.basiaot")
        t0 = time.perf_counter()
        meta = save_serving(path, cfg, state_dict=sd)
        art = load_serving(path)
        got = art(images)
        want = inf.predict_batch(batch)
        _require(meta["instance_mechanism"] == "roi" and all(
            g.dtype == w.dtype and torch.equal(g, w)
            for g, w in zip(got, want)),
            "the roi AOT artifact differs from predict_batch")
        print(f"roi AOT artifact: exported and loaded in "
              f"{time.perf_counter() - t0:.1f} s, equal to predict_batch bit "
              f"for bit")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del inf
    torch.cuda.empty_cache()
    check_roi_f32(cfg, sd, dev, images[:ROI_SERVE_F32_BATCH])
    return launches


def check_roi_f32(cfg, sd, dev, images) -> None:
    """Phase 12: the roi serving model in f32 on the card (TF32 off) and
    on the CPU, the same weights and images: proposed boxes within 1e-5
    and in the same order, the same slots in the same order with scores
    within 1e-3, /4 and full-resolution masks within 1e-3 away from the
    pixels at a box edge (``_edge_pixels``, few)."""
    import dataclasses

    from basi_tpu_torch.infer import Inferencer

    cfg32 = dataclasses.replace(cfg, infer=dataclasses.replace(
        cfg.infer, dtype="float32", batch_size=len(images)))
    res = []
    for device in (dev, "cpu"):
        inf = Inferencer(cfg32, device=device, state_dict=sd)
        with torch.inference_mode():
            out = inf.apply_model(images)
            masks, scores = inf._select(out)
            full = inf.full_res_masks(masks)
        res.append([t.float().cpu() for t in (out.roi_boxes, out.roi_scores,
                                              scores, masks, full)])
        del inf
    (bc, oc, sc, mc, fc), (bh, oh, sh, mh, fh) = res
    box_err = float((bc - bh).abs().max())
    _require(box_err <= 1e-5, f"roi boxes card vs cpu {box_err}")
    _require(float((oc - oh).abs().max()) <= 1e-3, "roi proposal scores")
    _require(torch.equal(sc > 0, sh > 0), "roi slots filled differently")
    score_err = float((sc - sh).abs().max())
    edge = _edge_pixels(bh, mh.shape[-2:])
    keep = ~edge[:, None]
    near = edge.clone()
    for dim in (1, 2):
        near |= edge.roll(1, dim) | edge.roll(-1, dim)
    keep_full = ~near.repeat_interleave(4, 1).repeat_interleave(4, 2)[:, None]
    mask_err = float(((mc - mh).abs() * keep).max())
    full_err = float(((fc - fh).abs() * keep_full).max())
    print(f"roi f32 card vs cpu (batch {len(images)}): boxes {box_err:.3e}, "
          f"slot scores {score_err:.3e}, /4 masks {mask_err:.3e}, full-res "
          f"{full_err:.3e}; {int(edge.sum())} /4 pixels at a box edge left "
          f"out; slots filled {int((sh > 0).sum())}")
    _require(score_err <= 1e-3 and mask_err <= 1e-3 and full_err <= 1e-3,
             "roi f32 card vs cpu beyond 1e-3")
    _require(float(edge.float().mean()) < 0.05, "too many edge pixels")


def run_roi_training(dev) -> dict:
    """Phase 12: ``bench_accuracy`` with the roi mechanism at full width
    (bf16 on f32 masters, batch 16, 512^2), once under ``model.bn_impl``
    xla and once under fused: ``Trainer.train`` on the default device
    takes ``ROI_TRAIN_STEPS`` steps with their launches
    (``per_step_launches``: the mechanism adds no kernel), finite losses
    with the box term, every param moved. Returns {bn_impl: launches}."""
    import gc

    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.train.loop import Trainer

    out = {}
    for impl in ("xla", "fused"):
        cfg = get_config("bench_accuracy", TRAIN_OVERRIDES + ROI + ROI_TRAIN
                         + [f"model.bn_impl={impl}"])
        trainer = Trainer(cfg)
        _require(trainer.device == dev, f"Trainer ran on {trainer.device}")
        model = trainer.state.model
        params0 = {k: p.detach().clone() for k, p in model.named_parameters()}
        _zero_kernel_counts()
        t0 = time.perf_counter()
        trainer.train(max_steps=ROI_TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _kernel_counts()
        want = {a: b * ROI_TRAIN_STEPS
                for a, b in per_step_launches(cfg).items()}
        recs = trainer.records
        print(f"roi training, bench_accuracy, bn_impl={impl}: "
              f"{ROI_TRAIN_STEPS} steps in {wall:.2f} s (host feed and "
              f"first-call set-up included); launches {launches}; losses "
              f"{[round(r['loss'], 4) for r in recs]}, box_iou "
              f"{[round(r['box_iou'], 4) for r in recs]}")
        _require(launches == want, f"roi bn_impl={impl}: expected {want}, "
                 f"got {launches}")
        _require(len(recs) == ROI_TRAIN_STEPS and all(
            np.isfinite(v) for r in recs for v in r.values()),
            f"roi [train] records {recs}")
        n_p = _moved(params0, dict(model.named_parameters()))
        _require(n_p == len(params0),
                 f"roi: {n_p}/{len(params0)} params moved")
        out[impl] = launches
        del trainer, model, params0
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_roi_eval(dev, gen) -> dict:
    """Phase 12: ``evaluate`` of ``bench_accuracy`` with the roi mechanism
    in the original frame (bf16, batch 16, the preset's non-square
    originals; 32 val images in 2 batches) on the default device, seeded
    roi weights: every metric finite, 32 images, 9 ``upsample_int`` and 1
    ``upsample_sigmoid`` launch a batch and nothing else. Returns the
    launches."""
    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.data.datasets import make_dataset
    from basi_tpu_torch.infer import Inferencer

    cfg = get_config("bench_accuracy", ROI + ROI_EVAL)
    inf = Inferencer(cfg, state_dict=roi_smoke_weights(cfg, gen))
    _require(inf.device == dev, f"Inferencer ran on {inf.device}")
    ds = make_dataset(cfg.data, split="val")
    n_b = -(-len(ds) // cfg.infer.batch_size)
    _zero_kernel_counts()
    t0 = time.perf_counter()
    m = inf.evaluate(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    print(f"roi evaluate, bench_accuracy original frame: {m['num_images']} "
          f"images in {n_b} batches in {wall:.3f} s ({len(ds) / wall:.1f} "
          f"imgs/s by the wall clock, drawing scenes included); "
          f"infer_ms_per_batch {m['infer_ms_per_batch']}; launches "
          f"{ {a: b for a, b in launches.items() if b} }")
    print(f"  metrics {json.dumps(_metrics_only(m))}")
    _require(m["num_images"] == len(ds) and all(
        np.isfinite(v) for v in m.values()), f"roi evaluate: {m}")
    _require(launches == dict(_zero_counts(), upsample_int=9 * n_b,
                              upsample_sigmoid=n_b),
             f"roi evaluate: expected 9 upsample_int and 1 upsample_sigmoid "
             f"a batch x {n_b}; got {launches}")
    del inf
    torch.cuda.empty_cache()
    return launches


CONVNEXT = ["model.backbone=convnext_base", "train.optimizer=adamw",
            "train.lr=0.0001", "train.weight_decay=0.05"]


def run_convnext(dev, gen) -> dict:
    """Phase 13: the ConvNeXt-B trunk under the roi head on the default
    device. Serving: ``predict_batch`` of one batch of 8 at
    ``val_v4-8_ap`` (bf16, 512^2), 9 ``upsample_int`` launches and no
    other kernel, finite slots; ms a batch by CUDA events.
    Training: ``Trainer.train`` of ``bench_accuracy`` with AdamW (bf16 on
    f32 masters, batch 16), two steps with finite losses and every
    parameter moved (the first step's lr is 0 under the warm-up), the
    step's ms and the peak of ``max_memory_allocated``."""
    import gc

    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.infer import Inferencer
    from basi_tpu_torch.train.loop import Trainer

    cfg = get_config("val_v4-8_ap", ["data.dataset=synthetic"] + ROI
                     + CONVNEXT)
    inf = Inferencer(cfg)
    _require(inf.device == dev, f"Inferencer ran on {inf.device}")
    n, size = cfg.infer.batch_size, cfg.model.image_size
    batch = torch.randint(0, 256, (n, size, size, 3), generator=gen,
                          dtype=torch.uint8).to(dev)
    inf.predict_batch(batch)  # first-call set-up
    torch.cuda.synchronize()
    _zero_kernel_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    masks, scores, sal = inf.predict_batch(batch)
    end.record()
    torch.cuda.synchronize()
    launches = _kernel_counts()
    print(f"convnext_base roi serving (bf16, batch {n}, {size}^2): "
          f"{start.elapsed_time(end):.3f} ms a batch; launches "
          f"{ {a: b for a, b in launches.items() if b} }")
    _require(launches == dict(_zero_counts(), upsample_int=9,
                              dwconv_forward=36),
             f"convnext serving launches {launches}")
    _require(bool(torch.isfinite(scores.float()).all())
             and bool(torch.isfinite(masks.float()).all()),
             "convnext serving: non-finite slots")
    del inf, batch, masks, scores, sal
    cfg = get_config("bench_accuracy", TRAIN_OVERRIDES + ROI + ROI_TRAIN
                     + CONVNEXT)
    trainer = Trainer(cfg)
    _require(trainer.device == dev, f"Trainer ran on {trainer.device}")
    model = trainer.state.model
    params0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_kernel_counts()
    t0 = time.perf_counter()
    trainer.train(max_steps=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    recs = trainer.records
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"convnext_base roi training (bf16, AdamW, batch "
          f"{cfg.data.batch_size}): 2 steps in {wall:.2f} s (first-call "
          f"set-up included); losses {[round(r['loss'], 4) for r in recs]}; "
          f"peak {peak:.3f} GiB allocated")
    _require(len(recs) == 2 and all(np.isfinite(v) for r in recs
                                    for v in r.values()),
             f"convnext [train] records {recs}")
    # the 36 depthwise convs a step: a forward, an input gradient and a
    # weight gradient (two kernels) each, on the port's kernels alone
    _require({k: v for k, v in launches.items() if k.startswith("dwconv")}
             == {"dwconv_forward": 72, "dwconv_input_grad": 72,
                 "dwconv_weight_grad": 144},
             f"convnext training launches {launches}")
    n_p = _moved(params0, dict(model.named_parameters()))
    _require(n_p == len(params0), f"convnext: {n_p}/{len(params0)} params "
             "moved")
    del trainer, model, params0
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from basi_tpu_torch.config import get_config
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
    cm, cds = check_bn_kernels(dev, gen)
    ba, big = check_bn_apply_kernels(dev, gen)
    dwf, dwi, dww = check_dwconv_kernels(dev, gen)

    cfg = get_config("val_v4-8_ap", ["data.dataset=synthetic"])
    sd = smoke_weights(cfg, gen)
    serve_launches = run_slice(cfg, sd, dev, gen)
    check_f32(cfg, sd, dev, gen)
    del sd
    train_launches = {impl: run_training(dev, impl) for impl in PATH_STEPS}
    repeated_batch_learns(dev)
    check_bn_impls_agree(dev)
    for impl in ("xla", "fused"):
        check_f32_step(dev, impl)
    t0 = time.perf_counter()
    eval_sd, eval_rate = run_eval(dev, gen)
    check_eval_f32(dev, eval_sd)
    del eval_sd
    check_paste_sod(dev, gen)
    check_trainer_eval(dev)
    print(f"phase 7 (evaluation) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_recipe(dev)
    print(f"phase 8 (the accuracy recipe's path) took "
          f"{time.perf_counter() - t0:.1f} s")
    root = tempfile.mkdtemp(prefix="basi_files_")
    try:
        t0 = time.perf_counter()
        phase9 = check_files(dev, gen, eval_rate, root)
        print(f"phase 9 (image files) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        check_entry_points(dev, phase9, root)
        print(f"phase 10 (the entry points) took "
              f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    run_multiscale(dev)
    run_cli_train()
    time_settings(dev)
    time_scale_jitter(dev, gen)
    check_settings_f32(dev)
    print(f"phase 11 (the rest of training) took "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    roi_launches = {"serving": run_roi_serving(dev, gen)}
    roi_launches.update(run_roi_training(dev))
    roi_launches["eval"] = run_roi_eval(dev, gen)
    print(f"phase 12 (the roi mechanism) took "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dw_launches = run_convnext(dev, gen)
    print(f"phase 13 (the ConvNeXt trunk) took "
          f"{time.perf_counter() - t0:.1f} s")
    # every kernel of the roi path launched on it
    for name, path in (("upsample_int", "serving"),
                       ("upsample_sigmoid", "serving"),
                       ("upsample_int_bwd", "xla"),
                       ("normalize_and_flip", "xla"),
                       ("channel_moments", "fused"),
                       ("channel_dual_sums", "fused"),
                       ("bn_apply", "fused"),
                       ("bn_input_gradient", "fused")):
        _require(roi_launches[path][name] > 0,
                 f"roi {path}: {name} never launched")

    # launches: each kernel's count over the path it serves, read right
    # after that path's run (upsample_int: the xla training path; the BN
    # kernels: the fused one)
    rows = [("upsample_int", "basi_tpu_torch/csrc/upsample_int.cu",
             "basi_tpu/ops/pallas/upsample_int.py:65", ui,
             train_launches["xla"]["upsample_int"]),
            ("upsample_int_bwd", "basi_tpu_torch/csrc/upsample_int_bwd.cu",
             "basi_tpu/ops/pallas/upsample_int.py:264", ub,
             train_launches["xla"]["upsample_int_bwd"]),
            ("upsample_sigmoid", "basi_tpu_torch/csrc/upsample_sigmoid.cu",
             "basi_tpu/ops/pallas/upsample_sigmoid.py:42", us,
             serve_launches["upsample_sigmoid"]),
            ("normalize_and_flip", "basi_tpu_torch/csrc/normalize_aug.cu",
             "basi_tpu/ops/pallas/normalize_aug.py:47", nf,
             train_launches["xla"]["normalize_and_flip"]),
            ("channel_moments", "basi_tpu_torch/csrc/bn_stats.cu",
             "basi_tpu/ops/pallas/bn_stats.py:71", cm,
             train_launches["fused"]["channel_moments"]),
            ("channel_dual_sums", "basi_tpu_torch/csrc/bn_stats.cu",
             "basi_tpu/ops/pallas/bn_stats.py:113", cds,
             train_launches["fused"]["channel_dual_sums"]),
            ("bn_apply", "basi_tpu_torch/csrc/bn_apply.cu",
             "basi_tpu/models/norm.py:76 (XLA-fused; no Pallas kernel)", ba,
             train_launches["fused"]["bn_apply"]),
            ("bn_input_gradient", "basi_tpu_torch/csrc/bn_apply.cu",
             "basi_tpu/models/norm.py:102 (XLA-fused; no Pallas kernel)", big,
             train_launches["fused"]["bn_input_gradient"])]
    # ConvNeXt's depthwise conv: no TPU kernel (the JAX package has no
    # ConvNeXt); its launches are phase 13's two training steps
    rows += [(name, "basi_tpu_torch/csrc/dwconv.cu",
              "none: cuDNN's depthwise conv behind F.conv2d(groups=C)", r,
              dw_launches[name])
             for name, r in (("dwconv_forward", dwf),
                             ("dwconv_input_grad", dwi),
                             ("dwconv_weight_grad", dww))]
    kernels = []
    for name, src, rep, r, n in rows:
        bound, by = _bound(r["bytes"], r["flops"])
        roi = {path: launches[name] for path, launches in
               roi_launches.items() if launches[name]}
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": n, "roi_launches": roi,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "device_ms": r["device_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": bound,
                        "bound_by": by, "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
