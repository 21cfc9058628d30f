"""The training generator: ``Trainer.train_step`` on batches staged on the
device.

It reads a traffic mix of these keys: ``overrides`` (``data.batch_size``,
and any model setting the cell runs with, such as ``model.bn_impl``),
``ring`` (distinct batches drawn from the seed and staged on the device in
set-up, as the feed ships them: uint8 images, bit-packed masks, valid
flags), ``objects`` (the least and most salient objects in a scene; the
masks are their visible parts), ``checked_steps`` (the first steps, which
the reference follows), ``warmup_steps`` (further steps before the window)
and ``trace_lead_s`` and ``trace_s`` (the profiled sub-window of a traced
run).

Set-up builds one ``Trainer``, loads the seeded weights into its model and
EMA, and drives its own ``train_step`` through the checked steps on the
ring's first batches (all rows differ) and the warm-up steps; the window
then calls the same ``train_step`` on the ring in turn until ``seconds``
have passed, and ends with a device synchronize. The images trained in it
over its length is the rate.
"""

from __future__ import annotations

import gc
import time

import torch

from perfbench.harness import roofline, trace as T
from perfbench.harness.config import plain_config, program_config
from perfbench.harness.flops import forward_flops
from perfbench.harness.inputs import draw_scenes, make_weights, pack_masks
from perfbench.reference.compare import train_errors, train_gaps, worst_leaves
from perfbench.reference.train import flips, train_reference

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, fault=None) -> dict:
    """One run of a training cell (module doc). ``fault`` (tests): a
    function ``(step, state, batch) -> metrics`` called in the place of the
    Trainer's step."""
    from basi_tpu_torch.train.loop import Trainer

    parts = [("imports", time.perf_counter() - t_start)]

    def mark(name):
        _sync(dev)
        parts.append((name, time.perf_counter() - t_start
                      - sum(v for _, v in parts)))

    traffic = cell.traffic
    cfg = program_config(cell)
    plain = plain_config(cfg)
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
        if i == 0:  # the first gradient as SGD got it: trace - wd * p0
            wd = plain["train"]["weight_decay"]
            opt = state.optimizer.state
            grad1 = {k: (opt[p]["momentum_buffer"] - wd * weights[k]).clone()
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
        facts["bn_stats_bound_ms_per_step"] = (
            roofline.channel_moments_bound_ms(n, size)
            + roofline.channel_dual_sums_bound_ms(n, size))
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


def _profiler(dev):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def reference_steps(weights, plain, images, masks, valid, n, steps,
                    precision="f32") -> dict:
    """The reference's first ``steps`` steps on the run's inputs."""
    batches = [(images[i * n:(i + 1) * n], masks[i * n:(i + 1) * n],
                valid[i * n:(i + 1) * n]) for i in range(steps)]
    d, t = plain["data"], plain["train"]
    max_steps = d["synthetic_n"] // n * t["epochs"]
    return train_reference(weights, plain, batches,
                           flips(t["seed"], steps, n, d["hflip_prob"]),
                           max_steps, precision)


def check(prog, weights, plain, images, masks, valid, n, limits):
    """The checked steps against the reference's (``reference/train.py``):
    the numbers of ``compare.train_errors`` beside their limits, and the
    readings (with the worst leaves of each kind)."""
    steps = len(prog["loss"])
    ref = reference_steps(weights, plain, images, masks, valid, n, steps)
    p0 = {k: v for k, v in weights.items() if not k.endswith(BUFFERS)}
    gaps = train_gaps(prog, ref, p0)
    got = train_errors(prog, gaps, ref)
    readings = dict(got, worst=worst_leaves(gaps), loss=gaps["loss"])
    return ({k: {"value": got[k], "limit": v} for k, v in limits.items()},
            readings)
