"""Plain PyTorch reference of BASI with a ConvNeXt trunk under the roi
head, and its training step with AdamW.

The trunk (Liu et al., arXiv 2201.03545; the detection backbone of
facebookresearch/ConvNeXt): a 4x4 stride-4 conv and a channels-first
LayerNorm, then four stages of blocks ``x + gamma * Linear2(GELU(Linear1(
LN(dwconv7x7(x)))))`` (depthwise 7x7 with padding 3 and bias, LN over
channels with eps 1e-6, Linears C -> 4C -> C with bias, exact GELU), a
channels-first LayerNorm and a 2x2 stride-2 conv between stages, and a
channels-first LayerNorm on each stage's output (C2..C5). No stochastic
depth. Everything after the trunk is ``reference/basi.py``'s, the FPN's
laterals at the trunk's widths. Written with ``torch.nn.functional``
alone, in float32 (TF32 off, ``no_tf32``); parameter names are the
program's state-dict names. ``"fp8"`` is ``Ref``'s control: every operand
of every convolution (the depthwise ones too) and GEMM (the Linears)
rounded to float8 e4m3 forward and every gradient reaching one to e5m2.

The training step is ``reference/train.py``'s (ingest, roi targets, loss,
clip, schedule, EMA) with AdamW in the place of SGD, as
``torch.optim.AdamW`` computes it: b1 0.9, b2 0.999, eps 1e-8 outside the
square root, the decay ``lr * weight_decay * p`` taken first, on every
leaf. There is no BatchNorm in the model, so a batch is run in chunks of
``chunk`` images to fit float32 on the card: the loss's batch-wide
normalizers (positive cells, positive targets, images, pixels) come from
the whole batch's targets first, each chunk's loss is its share of the
batch's, and the gradients are summed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.basi import Ref, _RoundGrad, no_tf32, roi_align
from perfbench.reference.basi import init_std as basi_init_std
from perfbench.reference.basi import param_spec as heads_spec
from perfbench.reference.train import (
    EPS,
    _bce,
    _box_iou,
    _dice,
    lr_at,
    targets,
)

# (depths, widths) by backbone name: ConvNeXt-B, and the program's one-block
# cut for the CPU tests
CONVNEXT = {"convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
            "convnext_test": ((1, 1, 1, 1), (16, 32, 64, 128))}
LN_EPS = 1e-6
LAYER_SCALE_INIT = 1e-6
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


# --- parameters -----------------------------------------------------------

def trunk_spec(depths, dims) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of the trunk's tensors. Kinds as
    ``reference/basi.py``'s, and ``linear`` (a Linear's weight, N(0,
    1/in)) and ``gamma`` (the layer scale)."""
    spec: list = []

    def conv(name, cin, cout, k, groups=1):
        spec.extend([(f"{name}.weight", (cout, cin // groups, k, k), "conv"),
                     (f"{name}.bias", (cout,), "zero")])

    def ln(name, c):
        spec.extend([(f"{name}.weight", (c,), "one"),
                     (f"{name}.bias", (c,), "zero")])

    def linear(name, cin, cout):
        spec.extend([(f"{name}.weight", (cout, cin), "linear"),
                     (f"{name}.bias", (cout,), "zero")])

    pre = "backbone"
    for i, (n, d) in enumerate(zip(depths, dims)):
        if i == 0:
            conv(f"{pre}.downsample_layers.0.0", 3, d, 4)
            ln(f"{pre}.downsample_layers.0.1", d)
        else:
            ln(f"{pre}.downsample_layers.{i}.0", dims[i - 1])
            conv(f"{pre}.downsample_layers.{i}.1", dims[i - 1], d, 2)
        for j in range(n):
            b = f"{pre}.stages.{i}.{j}"
            conv(f"{b}.dwconv", d, d, 7, groups=d)
            ln(f"{b}.norm", d)
            linear(f"{b}.pwconv1", d, 4 * d)
            linear(f"{b}.pwconv2", 4 * d, d)
            spec.append((f"{b}.gamma", (d,), "gamma"))
    for i, d in enumerate(dims):
        ln(f"{pre}.norm{i}", d)
    return spec


def param_spec(m: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the model's state dict for
    the model section ``m``: the ConvNeXt trunk of ``m["backbone"]``, then
    ``reference/basi.py``'s FPN and heads with the laterals at the trunk's
    widths."""
    depths, dims = CONVNEXT[m["backbone"]]
    fpn = m["fpn_channels"]
    out = trunk_spec(depths, dims)
    for name, shape, kind in heads_spec(dict(m, backbone="resnet_tiny")):
        if name.startswith("backbone."):
            continue
        if name.startswith("fpn.lateral") and name.endswith(".weight"):
            shape = (fpn, dims[int(name[len("fpn.lateral")])], 1, 1)
        out.append((name, shape, kind))
    return out


def init_std(shape: tuple, kind: str) -> float:
    """The standard deviation of a normal-drawn tensor (``linear``: over
    the Linear's inputs; else ``reference/basi.py``'s)."""
    if kind == "linear":
        return shape[1] ** -0.5
    return basi_init_std(shape, kind)


# --- the network ----------------------------------------------------------

class ConvNeXtRef(Ref):
    """``Ref`` with the ConvNeXt trunk (module doc)."""

    def conv_any(self, x, name, stride=1, padding=0, groups=1):
        w = self.p[f"{name}.weight"]
        b = self.p[f"{name}.bias"]
        if not self.low:
            return F.conv2d(x, w, b, stride, padding, 1, groups)
        y = F.conv2d(self._round(x), self._round(w), b, stride, padding, 1,
                     groups)
        return _RoundGrad.apply(y, self.low_grad)

    def ln(self, x, name):
        """LayerNorm over the last dimension."""
        return F.layer_norm(x, (x.shape[-1],), self.p[f"{name}.weight"],
                            self.p[f"{name}.bias"], LN_EPS)

    def ln2d(self, x, name):
        """Channels-first LayerNorm of an NCHW tensor."""
        return self.ln(x.permute(0, 2, 3, 1), name).permute(0, 3, 1, 2)

    def linear(self, x, name):
        return (self.gemm("nhwc,dc->nhwd", x, self.p[f"{name}.weight"])
                + self.p[f"{name}.bias"])

    def block(self, x, pre):
        y = self.conv_any(x, f"{pre}.dwconv", 1, 3, x.shape[1])
        y = self.ln(y.permute(0, 2, 3, 1), f"{pre}.norm")
        y = self.linear(F.gelu(self.linear(y, f"{pre}.pwconv1")),
                        f"{pre}.pwconv2")
        return x + (y * self.p[f"{pre}.gamma"]).permute(0, 3, 1, 2)

    def trunk(self, x):
        depths, _ = CONVNEXT[self.m["backbone"]]
        feats = []
        for i, n in enumerate(depths):
            d = f"backbone.downsample_layers.{i}"
            if i == 0:
                x = self.ln2d(self.conv_any(x, f"{d}.0", 4), f"{d}.1")
            else:
                x = self.conv_any(self.ln2d(x, f"{d}.0"), f"{d}.1", 2)
            for j in range(n):
                x = self.block(x, f"backbone.stages.{i}.{j}")
            feats.append(self.ln2d(x, f"backbone.norm{i}"))
        return feats


# --- the training step ----------------------------------------------------

def loss_norms(tg: dict, r: int) -> dict:
    """The roi loss's batch-wide normalizers from the whole batch's
    targets (``reference/train.py::roi_loss``'s denominators)."""
    pos = tg["pos"].sum()
    n, _, h, w = tg["small"].shape
    return {"score": tg["score_tgt"].sum().clamp_min(1),
            "pos_eps": pos.clamp_min(EPS), "pos_1": pos.clamp_min(1),
            "mask_px": (pos * r * r).clamp_min(EPS), "images": n,
            "pixels": n * h * w}


def roi_loss_part(out, tg: dict, weights: dict, norms: dict) -> torch.Tensor:
    """A chunk's share of ``reference/train.py::roi_loss`` of the whole
    batch: the same terms on the chunk's rows (``tg`` sliced to them) over
    the batch's ``norms``; the shares of a batch's chunks sum to its
    loss."""
    sal, aux, score, cell_boxes, logits = out
    n, p, r, _ = logits.shape
    h, w = tg["tgt"].shape[-2:]
    crops = roi_align(tg["tgt"].reshape(n * p, 1, h, w),
                      tg["boxes"].reshape(n * p, 1, 4), r)
    t_roi = (crops.reshape(n, p, r, r) > 0.5).float()
    pos = tg["pos"]
    s = score.shape[-1]
    pred = cell_boxes.reshape(n, s * s, 4).gather(
        1, tg["sel"][..., None].expand(-1, -1, 4))
    box = ((1 - _box_iou(pred, tg["boxes"])) * pos).sum() / norms["pos_1"]
    mask = ((_dice(logits, t_roi) * pos).sum() / norms["pos_eps"]
            + (_bce(logits, t_roi) * pos[..., None, None]).sum()
            / norms["mask_px"])
    t = tg["score_tgt"]
    pr = torch.sigmoid(score)
    p_t = pr * t + (1 - pr) * (1 - t)
    a_t = 0.25 * t + 0.75 * (1 - t)
    focal = (a_t * (1 - p_t) ** 2 * _bce(score, t)).sum() / norms["score"]
    union = (tg["small"] * tg["valid"][..., None, None]).amax(1)
    heads = [sal] + list(aux)
    sal_loss = sum(_bce(q[:, 0], union).sum() / norms["pixels"]
                   + _dice(q[:, 0], union).sum() / norms["images"]
                   for q in heads) / len(heads)
    return (weights["mask"] * mask + weights["score"] * focal
            + weights["box"] * box + weights["saliency"] * sal_loss)


def adamw_(p, g, m, v, step: int, lr: float, wd: float) -> None:
    """One ``torch.optim.AdamW`` update of the leaf ``p`` with gradient
    ``g`` and moments ``m``, ``v`` (in place; ``step`` counts from 1)."""
    b1, b2 = ADAM_BETAS
    p.mul_(1 - lr * wd)
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    denom = (v.sqrt() / math.sqrt(1 - b2 ** step)).add_(ADAM_EPS)
    p.addcdiv_(m, denom, value=-lr / (1 - b1 ** step))


def train_reference(p0: dict, cfg: dict, batches: list, flip_flags: list,
                    max_steps: int, precision: str = "f32",
                    chunk: int = 16) -> dict:
    """``reference/train.py::train_reference`` for the roi mechanism on
    the ConvNeXt model with AdamW (module doc): {"loss", "num_pos": [per
    step], "grad": {leaf: the first step's clipped gradient}, "params",
    "ema": {leaf: after the last step}}."""
    m, t, d = cfg["model"], cfg["train"], cfg["data"]
    if m["instance_mechanism"] != "roi" or t["optimizer"] != "adamw":
        raise ValueError("the ConvNeXt reference trains the roi mechanism "
                         "with AdamW")
    leaves = {k: v.detach().clone().float().requires_grad_()
              for k, v in p0.items()}
    ref = ConvNeXtRef(leaves, m, d["mean"], d["std"], cfg["infer"],
                      precision)
    weights = {"mask": t["mask_loss_weight"], "score": t["score_loss_weight"],
               "box": t["box_loss_weight"], "saliency": t["saliency_loss_weight"]}
    ema = {k: v.detach().clone() for k, v in leaves.items()}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
               for k, v in leaves.items()}
    out = {"loss": [], "num_pos": []}
    cells = t["max_pos_cells"] if t["max_pos_cells"] > 0 else 64
    r = m["roi_resolution"]
    with no_tf32():
        for step, ((img, masks, valid), flip) in enumerate(zip(batches,
                                                               flip_flags)):
            flip = flip.to(img.device)
            n = img.shape[0]
            tg = targets(masks, valid, flip, m["grid_size"], 4, cells)
            out["num_pos"].append(float(tg["pos_all"].sum()) / n)
            norms = loss_norms(tg, r)
            grads, loss_sum = None, 0.0
            for a in range(0, n, chunk):
                rows = slice(a, min(n, a + chunk))
                x = img[rows].float() / 255.0
                x = torch.where(flip[rows, None, None, None], x.flip(2), x)
                x = ((x - ref.mean) / ref.std).permute(0, 3, 1, 2)
                part = {k: v[rows] for k, v in tg.items()}
                loss = roi_loss_part(ref.forward_train(x, part["boxes"]),
                                     part, weights, norms)
                g = torch.autograd.grad(loss, list(leaves.values()))
                grads = list(g) if grads is None else [
                    u + v for u, v in zip(grads, g)]
                loss_sum += float(loss.detach())
            out["loss"].append(loss_sum)
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            if norm >= t["grad_clip_norm"]:
                grads = [g / norm.float() * t["grad_clip_norm"] for g in grads]
            if step == 0:
                out["grad"] = {k: g.detach().clone()
                               for k, g in zip(leaves, grads)}
            lr = lr_at(step, t, max_steps)
            with torch.no_grad():
                for (k, v), g in zip(leaves.items(), grads):
                    adamw_(v, g, *moments[k], step + 1, lr,
                           t["weight_decay"])
                dk = min(t["ema_decay"], (1 + step + 1) / (10 + step + 1))
                for k, v in leaves.items():
                    ema[k].mul_(dk).add_(v.detach(), alpha=1 - dk)
    out["params"] = {k: v.detach() for k, v in leaves.items()}
    out["ema"] = ema
    return out
