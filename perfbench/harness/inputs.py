"""Inputs made from the seed: the model's weights and the training scenes.

Both are drawn on the run's device from one ``torch.Generator`` in a few
large calls, so set-up stays short and the same seed gives the same inputs
on the same kind of card.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.basi import FOCAL_PRIOR_BIAS, init_std, param_spec


def make_weights(model: dict, spec_cfg: dict, gen: torch.Generator,
                 device) -> dict:
    """A float32 state dict for the model section ``model`` of a
    configuration: convolutions N(0, 1/fan_in), prediction convolutions
    N(0, 0.01^2), norms the identity, BatchNorm running statistics 0 and
    1, the objectness bias the focal prior; ``constant_suffix`` of
    ``spec_cfg`` (the weights section of a configuration file) sets every
    tensor whose name ends so."""
    spec = param_spec(model)
    const = {n: float(v) for suffix, v in
             spec_cfg.get("constant_suffix", {}).items()
             for n, _, _ in spec if n.endswith(suffix)}
    drawn = {n for n, _, k in spec
             if k in ("conv", "pred", "score") and n not in const}
    normal = torch.randn(sum(math.prod(s) for n, s, _ in spec if n in drawn),
                         generator=gen, device=device)
    out, i = {}, 0
    for name, shape, kind in spec:
        if name in const:
            out[name] = torch.full(shape, const[name], device=device)
        elif name in drawn:
            size = math.prod(shape)
            out[name] = normal[i:i + size].view(shape) * init_std(shape, kind)
            i += size
        elif kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
        else:
            value = {"one": 1.0, "zero": 0.0, "prior": FOCAL_PRIOR_BIAS}[kind]
            out[name] = torch.full(shape, value, device=device)
    return out


def draw_scenes(n: int, size: int, objects: tuple[int, int],
                gen: torch.Generator, device, chunk: int = 16,
                with_masks: bool = False):
    """``n`` uint8 scenes (n, size, size, 3): a background of a random
    colour with a random linear gradient and pixel noise, and between
    ``objects[0]`` and ``objects[1]`` filled ellipses of random centre,
    radii and colour painted over it in turn (the salient objects). With
    ``with_masks`` also each object's visible mask (n, objects[1], size,
    size) uint8 0/1 and its valid flag (n, objects[1]) uint8 (the object
    exists and shows)."""
    lo, hi = objects
    k = hi
    count = torch.randint(lo, hi + 1, (n,), generator=gen, device=device)
    base = torch.rand(n, 3, generator=gen, device=device) * 255
    slope = (torch.rand(n, 2, 3, generator=gen, device=device) - 0.5) * 120
    centre = torch.rand(n, k, 2, generator=gen, device=device) * 0.8 + 0.1
    radii = torch.rand(n, k, 2, generator=gen, device=device) * 0.25 + 0.05
    colour = torch.rand(n, k, 3, generator=gen, device=device) * 255
    out = torch.empty(n, size, size, 3, dtype=torch.uint8, device=device)
    masks = (torch.empty(n, k, size, size, dtype=torch.uint8, device=device)
             if with_masks else None)
    t = (torch.arange(size, device=device, dtype=torch.float32) + 0.5) / size
    yy, xx = t[:, None], t[None, :]
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        img = (base[a:b, None, None, :]
               + yy[None, :, :, None] * slope[a:b, None, None, 0]
               + xx[None, :, :, None] * slope[a:b, None, None, 1])
        img = img + (torch.rand(img.shape, generator=gen, device=device)
                     - 0.5) * 16
        covered = torch.zeros(b - a, size, size, dtype=torch.bool,
                              device=device)
        inside = []
        for o in range(k):
            dy = (yy[None] - centre[a:b, o, 0, None, None]) / radii[a:b, o, 0,
                                                                    None, None]
            dx = (xx[None] - centre[a:b, o, 1, None, None]) / radii[a:b, o, 1,
                                                                    None, None]
            ins = (dy * dy + dx * dx <= 1.0) & (o < count[a:b, None, None])
            img = torch.where(ins[..., None], colour[a:b, o, None, None, :],
                              img)
            inside.append(ins)
        out[a:b] = img.clamp(0, 255).round().to(torch.uint8)
        if with_masks:
            for o in reversed(range(k)):  # later objects hide earlier ones
                masks[a:b, o] = (inside[o] & ~covered).to(torch.uint8)
                covered |= inside[o]
    if not with_masks:
        return out
    valid = (masks.flatten(2).amax(2) > 0).to(torch.uint8)
    return out, masks, valid


def pack_masks(masks: torch.Tensor) -> torch.Tensor:
    """0/1 masks (..., H, W) -> bit-packed along W (..., H, W/8) uint8, the
    most significant bit first (``numpy.packbits``' order): the form the
    program's feed ships."""
    *lead, h, w = masks.shape
    bits = masks.reshape(*lead, h, w // 8, 8).to(torch.uint8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=masks.device)
    return (bits * weights).sum(-1, dtype=torch.uint8)
