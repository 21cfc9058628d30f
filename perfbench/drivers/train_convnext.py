"""The training generator for a ConvNeXt trunk under the roi head, trained
with AdamW: ``Trainer.train_step`` on batches staged on the device.

It follows ``drivers/train.py``'s contract and reads a traffic mix of the
same keys (``overrides``, ``ring``, ``objects``, ``checked_steps``,
``warmup_steps``, ``trace_lead_s``, ``trace_s``); set-up, the window and
the facts it returns are that driver's. What differs follows from the
model and the optimizer:

- the weights are drawn from ``reference/convnext.py``'s ``param_spec``
  (the trunk's Linears N(0, 1/in), its LayerNorms the identity, the layer
  scale ``gamma`` at its published 1e-6 unless the configuration's
  ``constant_suffix`` states it), and there are no BatchNorm buffers;
- the first gradient is read from AdamW's first moment after the first
  step, ``exp_avg / (1 - b1)``;
- the check repeats the checked steps with ``reference/convnext.py``'s
  ``train_reference`` (AdamW, the batch in chunks);
- ``flops_per_step`` is three times that reference's train-mode forward
  under PyTorch's FLOP counter on ``meta`` (plus the roi crop's banded
  GEMMs, ``harness/flops.py``), so the count is the same whatever
  implements the layers; ``convnext_dwconv_bound_ms_per_step`` is the
  frozen bound of the forward's depthwise convs
  (``harness/roofline_convnext.py``).
"""

from __future__ import annotations

import gc
import math
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.drivers.train import _profiler, _sync
from perfbench.harness import roofline, roofline_convnext, trace as T
from perfbench.harness.config import plain_config, program_config
from perfbench.harness.flops import roi_gemm_flops
from perfbench.harness.inputs import draw_scenes, pack_masks
from perfbench.reference.basi import FOCAL_PRIOR_BIAS
from perfbench.reference.compare import train_errors, train_gaps, worst_leaves
from perfbench.reference.convnext import (
    ADAM_BETAS,
    CONVNEXT,
    LAYER_SCALE_INIT,
    ConvNeXtRef,
    init_std,
    param_spec,
    train_reference,
)
from perfbench.reference.train import flips

CHUNK = 16  # images a chunk of the float32 reference's batch


def make_weights(model: dict, spec_cfg: dict, gen: torch.Generator,
                 device) -> dict:
    """A float32 state dict for the model section ``model``: convolutions
    N(0, 1/fan_in), Linears N(0, 1/in), prediction convolutions N(0,
    0.01^2), norms the identity, the layer scale ``LAYER_SCALE_INIT``, the
    objectness bias the focal prior; ``constant_suffix`` of ``spec_cfg``
    (the configuration's weights section) sets every tensor whose name
    ends so."""
    spec = param_spec(model)
    const = {n: float(v) for suffix, v in
             spec_cfg.get("constant_suffix", {}).items()
             for n, _, _ in spec if n.endswith(suffix)}
    drawn = {n for n, _, k in spec
             if k in ("conv", "linear", "pred", "score") and n not in const}
    normal = torch.randn(sum(math.prod(s) for n, s, _ in spec if n in drawn),
                         generator=gen, device=device)
    fill = {"one": 1.0, "zero": 0.0, "prior": FOCAL_PRIOR_BIAS,
            "gamma": LAYER_SCALE_INIT}
    out, i = {}, 0
    for name, shape, kind in spec:
        if name in const:
            out[name] = torch.full(shape, const[name], device=device)
        elif name in drawn:
            size = math.prod(shape)
            out[name] = normal[i:i + size].view(shape) * init_std(shape, kind)
            i += size
        else:
            out[name] = torch.full(shape, fill[kind], device=device)
    return out


def forward_flops(cfg: dict, batch: int) -> float:
    """Operations of one train-mode forward at ``batch`` images:
    ``reference/convnext.py``'s network on ``meta`` under the FLOP counter
    (every convolution, the depthwise ones included, and every GEMM, at
    the ROI mask head's ``train.max_pos_cells`` boxes), plus the roi
    crop's GEMMs; a step is three times that."""
    m = cfg["model"]
    p = {name: torch.empty(shape, device="meta")
         for name, shape, _ in param_spec(m)}
    size = m["image_size"]
    ref = ConvNeXtRef(p, m, cfg["data"]["mean"], cfg["data"]["std"],
                      cfg["infer"])
    cells = cfg["train"]["max_pos_cells"] or 64
    x = torch.empty(batch, 3, size, size, device="meta")
    with FlopCounterMode(display=False) as counter:
        ref.forward_train(x, torch.empty(batch, cells, 4, device="meta"))
    return float(counter.get_total_flops()) + roi_gemm_flops(m, batch, cells)


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, fault=None) -> dict:
    """One run of the cell (``drivers/train.py::run``'s, with the module
    doc's differences). ``fault`` (tests): a function ``(step, state,
    batch) -> metrics`` called in the place of the Trainer's step."""
    from basi_tpu_torch.train.loop import Trainer

    parts = [("imports", time.perf_counter() - t_start)]

    def mark(name):
        _sync(dev)
        parts.append((name, time.perf_counter() - t_start
                      - sum(v for _, v in parts)))

    traffic = cell.traffic
    cfg = program_config(cell)
    plain = plain_config(cfg)
    if plain["model"]["backbone"] not in CONVNEXT:
        raise ValueError(f"{cell.name}: the ConvNeXt driver runs a ConvNeXt "
                         f"trunk, not {plain['model']['backbone']!r}")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    mark("config_and_device")
    weights = make_weights(plain["model"], cell.config["weights"], gen, dev)
    mark("weights")
    n = cfg.data.batch_size
    size = plain["model"]["image_size"]
    ring = traffic["ring"]
    images, masks, valid = draw_scenes(ring * n, size,
                                       tuple(traffic["objects"]), gen, dev,
                                       with_masks=True)
    if masks.shape[1] != cfg.data.max_instances:
        raise ValueError("the mix's most objects must equal "
                         "data.max_instances")
    staged = [{"image": images[i * n:(i + 1) * n],
               "masks": pack_masks(masks[i * n:(i + 1) * n]),
               "valid": valid[i * n:(i + 1) * n]} for i in range(ring)]
    mark("scenes")
    trainer = Trainer(cfg, device=dev)
    state = trainer.state
    with torch.no_grad():
        state.model.load_state_dict(weights, strict=True)
        for k, v in state.ema.items():
            v.copy_(weights[k])
    real = trainer.train_step
    mark("trainer")

    def step(batch):
        if fault is not None:
            return fault(real, state, batch)
        return real(state, batch)

    checked = traffic["checked_steps"]
    named = dict(state.model.named_parameters())
    losses, num_pos, grad1 = [], [], None
    for i in range(checked):
        m = step(staged[i % ring])
        losses.append(m["loss"].detach().clone())
        num_pos.append(m.get("num_pos_cells", torch.full((), float("nan")))
                       .detach().clone())
        if i == 0:  # the first gradient as AdamW holds it
            opt = state.optimizer.state
            grad1 = {k: (opt[p]["exp_avg"] / (1 - ADAM_BETAS[0])).clone()
                     if p in opt else torch.zeros_like(p)
                     for k, p in named.items()}
    prog = {"loss": [float(v) for v in losses],
            "num_pos": [float(v) for v in num_pos], "grad": grad1,
            "params": {k: p.detach().clone() for k, p in named.items()},
            "ema": {k: v.clone() for k, v in state.ema.items()}}
    mark("checked_steps")
    for i in range(traffic["warmup_steps"]):
        step(staged[(checked + i) % ring])
    mark("warmup_steps")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    prof = None
    lead = min(traffic["trace_lead_s"], 0.2 * seconds)
    length = min(traffic["trace_s"], 0.6 * seconds)
    k = checked + traffic["warmup_steps"]
    calls, call_s, traced = 0, [], 0
    t_open = time.perf_counter()
    t_close = t_open + seconds
    t_prof = None
    while True:
        now = time.perf_counter()
        if now >= t_close:
            break
        if trace and prof is None and now >= t_open + lead:
            _sync(dev)  # the sub-window opens on an idle device
            prof = _profiler(dev)
            prof.start()
            t_prof = time.perf_counter()
        elif t_prof is not None and now >= t_open + lead + length:
            _sync(dev)
            prof_window = time.perf_counter() - t_prof
            prof.stop()
            t_prof = None
        if t_prof is not None:
            traced += 1
            with torch.profiler.record_function("perfbench.train_step"):
                step(staged[k % ring])
        else:
            step(staged[k % ring])
        call_s.append(time.perf_counter() - now)
        k += 1
        calls += 1
    _sync(dev)
    elapsed = time.perf_counter() - t_open
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if t_prof is not None:  # the window closed first: close the trace
        prof_window = time.perf_counter() - t_prof
        prof.stop()
    facts = {"kind": "train", "batch": n, "seconds": elapsed, "steps": calls,
             "attempted": calls, "failed": 0, "setup_parts": parts,
             "train_step_call_s": call_s,
             "memory_peak_bytes": int(peak),
             "e2e": {"setup_s": setup_s,
                     "train_imgs_per_s": calls * n / elapsed}}
    if prof is not None:
        facts["trace"] = T.summarize(prof.events(), prof_window)
        facts["trace_steps"] = traced
        facts["flops_per_step"] = 3 * forward_flops(plain, n)
        calls9 = roofline.upsample_int_calls(n, size,
                                             plain["model"]["fpn_channels"])
        facts["upsample_int_bound_ms_per_step"] = \
            roofline.upsample_int_bound_ms(calls9)
        facts["upsample_int_bwd_bound_ms_per_step"] = \
            roofline.upsample_int_bwd_bound_ms(calls9)
        facts["convnext_dwconv_bound_ms_per_step"] = \
            roofline_convnext.dwconv_bound_ms(roofline_convnext.dwconv_calls(
                n, size, *CONVNEXT[plain["model"]["backbone"]]))
    del trainer, state, named, real, staged, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    facts["checks"], facts["readings"] = check(
        prog, weights, plain, images[:checked * n], masks[:checked * n],
        valid[:checked * n], n, cell.limits)
    facts["check_s"] = time.perf_counter() - t_check
    facts["checked"] = checked
    facts["correct"] = all(c["value"] <= c["limit"]
                           for c in facts["checks"].values())
    return facts


def reference_steps(weights, plain, images, masks, valid, n, steps,
                    precision="f32", chunk: int | None = None) -> dict:
    """The reference's first ``steps`` steps on the run's inputs, the batch
    in chunks of ``chunk`` images (``CHUNK`` unless given)."""
    batches = [(images[i * n:(i + 1) * n], masks[i * n:(i + 1) * n],
                valid[i * n:(i + 1) * n]) for i in range(steps)]
    d, t = plain["data"], plain["train"]
    max_steps = d["synthetic_n"] // n * t["epochs"]
    return train_reference(weights, plain, batches,
                           flips(t["seed"], steps, n, d["hflip_prob"]),
                           max_steps, precision, chunk or CHUNK)


def check(prog, weights, plain, images, masks, valid, n, limits):
    """The checked steps against the reference's: the numbers of
    ``compare.train_errors`` beside their limits, and the readings (with
    the worst leaves of each kind)."""
    steps = len(prog["loss"])
    ref = reference_steps(weights, plain, images, masks, valid, n, steps)
    gaps = train_gaps(prog, ref, weights)
    got = train_errors(prog, gaps, ref)
    readings = dict(got, worst=worst_leaves(gaps), loss=gaps["loss"])
    return ({k: {"value": got[k], "limit": v} for k, v in limits.items()},
            readings)
