"""Plain PyTorch reference of the BASI network in train mode: ResNet
trunk, FPN, saliency heads, mask features, the grid head, and the roi or
kernels instance head.

It follows the model as the configuration states it, written out with
``torch.nn.functional`` alone (no module of the measured program, no
kernel, no cache): convolutions, batch norm on the batch's statistics,
group norm, bilinear resizes (half-pixel centres). ROI crops are
``grid_sample`` with border clamping, the same bilinear sampling the
program writes as banded matmuls. Parameter names are the program's
state-dict names, so the benchmark makes one set of tensors from the seed
and hands the same to both sides.

``precision``: ``"f32"`` computes in float32 (TF32 is switched off by the
caller, ``no_tf32``); ``"fp8"`` is the control, one precision below the
configuration's bfloat16, as FP8 training runs it (the hybrid format of
arXiv 2209.05433): every operand of every convolution and GEMM rounded to
float8 e4m3 in the forward and every gradient reaching one to e5m2, each
with a per-tensor scale.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

STAGES = {"resnet50": (3, 4, 6, 3), "resnet_tiny": (1, 1, 1, 1)}
GN_GROUPS = 32
EPS_NORM = 1e-5
PRED_STD = 0.01
FOCAL_PRIOR_BIAS = -4.595
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}
BOX_SCALE = 0.05 / math.log(2.0)  # distances: softplus(raw) * 0.05 / softplus(0)


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions in float32, not TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# --- parameters -----------------------------------------------------------

def param_spec(m: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the model's state dict, for
    the model section ``m`` of a configuration file. Kinds: ``conv`` (the
    weight of a convolution, N(0, 1/fan_in)), ``pred`` (a prediction
    convolution, N(0, 0.01^2)), ``score`` (an objectness convolution),
    ``zero``, ``one``, ``prior`` (the objectness bias), ``count``
    (BatchNorm's int64 ``num_batches_tracked``)."""
    spec: list = []

    def conv(name, cin, cout, k, bias=True, kind="conv"):
        spec.append((f"{name}.weight", (cout, cin, k, k), kind))
        if bias:
            spec.append((f"{name}.bias", (cout,),
                         "prior" if kind == "score" else "zero"))

    def bn(name, c):
        spec.extend([(f"{name}.weight", (c,), "one"),
                     (f"{name}.bias", (c,), "zero"),
                     (f"{name}.running_mean", (c,), "zero"),
                     (f"{name}.running_var", (c,), "one"),
                     (f"{name}.num_batches_tracked", (), "count")])

    def gn(name, c):
        spec.extend([(f"{name}.weight", (c,), "one"),
                     (f"{name}.bias", (c,), "zero")])

    conv("backbone.conv1", 3, 64, 7, bias=False)
    bn("backbone.bn1", 64)
    cin = 64
    for li, blocks in enumerate(STAGES[m["backbone"]]):
        planes = 64 * 2 ** li
        for bi in range(blocks):
            pre = f"backbone.layer{li + 1}.{bi}"
            conv(f"{pre}.conv1", cin, planes, 1, bias=False)
            bn(f"{pre}.bn1", planes)
            conv(f"{pre}.conv2", planes, planes, 3, bias=False)
            bn(f"{pre}.bn2", planes)
            conv(f"{pre}.conv3", planes, planes * 4, 1, bias=False)
            bn(f"{pre}.bn3", planes * 4)
            if bi == 0:
                conv(f"{pre}.downsample.0", cin, planes * 4, 1, bias=False)
                bn(f"{pre}.downsample.1", planes * 4)
            cin = planes * 4
    fpn = m["fpn_channels"]
    for i, c in enumerate((256, 512, 1024, 2048)):
        conv(f"fpn.lateral{i}", c, fpn, 1)
        conv(f"fpn.smooth{i}", fpn, fpn, 3)
    for i in range(4):
        conv(f"saliency.tower{i}", fpn, 64, 3)
        conv(f"saliency.out{i}", 64, 1, 1, kind="pred")
    conv("saliency.fuse", 64 * 4, 1, 1, kind="pred")
    emb = m["mask_channels"]
    for i in range(4):
        conv(f"maskfeat.level{i}", fpn + (2 if i == 3 else 0), 128, 3)
        gn(f"maskfeat.gn{i}", 128)
    conv("maskfeat.embed", 128, emb, 1)
    head = "roi_box" if m["instance_mechanism"] == "roi" else "instance"
    for i in range(3):
        conv(f"{head}.tower{i}", (fpn + 2) if i == 0 else 128, 128, 3)
        gn(f"{head}.gn{i}", 128)
    conv(f"{head}.score", 128, 1, 3, kind="score")
    if head == "roi_box":
        conv("roi_box.box", 128, 4, 3, kind="pred")
        for i in range(2):
            conv(f"roi_mask.tower{i}", emb, emb, 3)
            gn(f"roi_mask.gn{i}", emb)
        conv("roi_mask.out", emb, 1, 1, kind="pred")
    else:
        conv("instance.kernel", 128, emb, 3, kind="pred")
    return spec


def init_std(shape: tuple, kind: str) -> float:
    """The standard deviation of a normal-drawn tensor."""
    if kind == "conv":
        return (shape[1] * shape[2] * shape[3]) ** -0.5
    return PRED_STD  # "pred", "score"


def fp8(t: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``t`` rounded to a float8 ``dtype`` with one scale for the tensor
    (its largest magnitude maps to the format's largest), back in
    float32."""
    s = t.abs().amax().clamp_min(1e-30) / FP8_MAX[dtype]
    return (t / s).to(dtype).to(torch.float32) * s


def fp8_grad(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e5m2, the gradients' format."""
    return fp8(t, torch.float8_e5m2)


class Ref:
    """The reference in train mode over the leaves ``p`` (float32 tensors)
    for the model section ``m`` and the data and infer sections of a
    configuration. Under ``"fp8"`` every operand of every convolution and
    GEMM is rounded, in both passes: the forward's inputs
    and weights (which the backward reuses) and the gradient that reaches
    the product's output."""

    def __init__(self, p: dict, m: dict, mean, std, infer: dict,
                 precision: str = "f32"):
        rounding = {"f32": (None, None), "fp8": (fp8, fp8_grad)}
        if precision not in rounding:
            raise ValueError(f"precision {precision!r} (f32 | fp8)")
        self.p, self.m, self.infer = p, m, infer
        self.low, self.low_grad = rounding[precision]
        dev = next(iter(p.values())).device
        self.mean = torch.tensor(mean, dtype=torch.float32, device=dev)
        self.std = torch.tensor(std, dtype=torch.float32, device=dev)

    # layers
    def conv(self, x, name, stride=1):
        w = self.p[f"{name}.weight"]
        b = self.p.get(f"{name}.bias")
        if not self.low:
            return F.conv2d(x, w, b, stride, w.shape[-1] // 2)
        y = F.conv2d(self._round(x), self._round(w), b, stride,
                     w.shape[-1] // 2)
        return _RoundGrad.apply(y, self.low_grad)

    def gemm(self, eq, a, b):
        if not self.low:
            return torch.einsum(eq, a, b)
        y = torch.einsum(eq, self._round(a), self._round(b))
        return _RoundGrad.apply(y, self.low_grad)

    def _round(self, t):
        """The rounded value forward, the gradient straight through."""
        return t + (self.low(t.detach()) - t).detach()

    def bn(self, x, name):
        return F.batch_norm(x, None, None, self.p[f"{name}.weight"],
                            self.p[f"{name}.bias"], True, 0.0, EPS_NORM)

    def gn(self, x, name):
        return F.group_norm(x, GN_GROUPS, self.p[f"{name}.weight"],
                            self.p[f"{name}.bias"], EPS_NORM)

    @staticmethod
    def resize(x, hw):
        return F.interpolate(x, size=tuple(hw), mode="bilinear",
                             align_corners=False)

    @staticmethod
    def with_coords(x):
        n, _, h, w = x.shape
        ys = torch.linspace(-1.0, 1.0, h, device=x.device)
        xs = torch.linspace(-1.0, 1.0, w, device=x.device)
        c = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)])
        return torch.cat([x, c[None].expand(n, 2, h, w)], dim=1)

    # the network
    def trunk(self, x):
        x = F.relu(self.bn(self.conv(x, "backbone.conv1", 2), "backbone.bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for li, blocks in enumerate(STAGES[self.m["backbone"]]):
            for bi in range(blocks):
                pre = f"backbone.layer{li + 1}.{bi}"
                s = 2 if (bi == 0 and li > 0) else 1
                idt = x
                if f"{pre}.downsample.0.weight" in self.p:
                    idt = self.bn(self.conv(x, f"{pre}.downsample.0", s),
                                  f"{pre}.downsample.1")
                y = F.relu(self.bn(self.conv(x, f"{pre}.conv1"), f"{pre}.bn1"))
                y = F.relu(self.bn(self.conv(y, f"{pre}.conv2", s),
                                   f"{pre}.bn2"))
                y = self.bn(self.conv(y, f"{pre}.conv3"), f"{pre}.bn3")
                x = F.relu(y + idt)
            feats.append(x)
        return feats

    def fpn(self, feats):
        lats = [self.conv(f, f"fpn.lateral{i}") for i, f in enumerate(feats)]
        outs = [None] * 4
        prev = outs[3] = lats[3]
        for i in (2, 1, 0):
            prev = lats[i] + self.resize(prev, lats[i].shape[-2:])
            outs[i] = prev
        return [self.conv(o, f"fpn.smooth{i}") for i, o in enumerate(outs)]

    def mask_features(self, pyr):
        hw = pyr[0].shape[-2:]
        acc = 0
        for i, q in enumerate(pyr):
            if i == 3:
                q = self.with_coords(q)
            f = F.relu(self.gn(self.conv(q, f"maskfeat.level{i}"),
                               f"maskfeat.gn{i}"))
            acc = acc + self.resize(f, hw)
        return self.conv(acc, "maskfeat.embed")

    def grid_head(self, feat, prefix, second):
        s = self.m["grid_size"]
        x = self.resize(self.with_coords(feat), (s, s))
        for i in range(3):
            x = F.relu(self.gn(self.conv(x, f"{prefix}.tower{i}"),
                               f"{prefix}.gn{i}"))
        return self.conv(x, f"{prefix}.score"), self.conv(x, f"{prefix}.{second}")

    def _shared(self, x):
        """The trunk, FPN, saliency (fused and per level) and the mask
        features."""
        pyr = self.fpn(self.trunk(x))
        hw = pyr[0].shape[-2:]
        feats, aux = [], []
        for i, q in enumerate(pyr):
            f = F.relu(self.conv(q, f"saliency.tower{i}"))
            aux.append(self.resize(self.conv(f, f"saliency.out{i}"), hw))
            feats.append(self.resize(f, hw))
        sal = self.conv(torch.cat(feats, 1), "saliency.fuse")
        return pyr, sal, aux, self.mask_features(pyr)

    def forward_train(self, x, boxes):
        """Normalized images (N, 3, H, W) and GT boxes (N, P, 4) -> (fused
        saliency, aux saliency list, cell score logits (N, 1, S, S), cell
        boxes (N, S, S, 4), ROI mask logits (N, P, R, R))."""
        pyr, sal, aux, mf = self._shared(x)
        score, raw = self.grid_head(pyr[1], "roi_box", "box")
        n, p = boxes.shape[:2]
        r = self.m["roi_resolution"]
        z = roi_align(mf, boxes.detach(), r).reshape(n * p, -1, r, r)
        for i in range(2):
            z = F.relu(self.gn(self.conv(z, f"roi_mask.tower{i}"),
                               f"roi_mask.gn{i}"))
        logits = self.conv(z, "roi_mask.out").reshape(n, p, r, r)
        return sal, aux, score, decode_boxes(raw), logits

    def forward_train_kernels(self, x, sel):
        """Normalized images and the kept cells (N, P) -> (fused saliency,
        aux saliency list, cell score logits (N, 1, S, S), the kept cells'
        mask logits (N, P, H/4, W/4): their kernels applied to the mask
        features)."""
        pyr, sal, aux, mf = self._shared(x)
        score, kern = self.grid_head(pyr[1], "instance", "kernel")
        n, e = kern.shape[:2]
        kern = kern.reshape(n, e, -1).transpose(1, 2)
        kern = torch.gather(kern, 1, sel[..., None].expand(-1, -1, e))
        return sal, aux, score, self.gemm("nehw,npe->nphw", mf, kern)


class _RoundGrad(torch.autograd.Function):
    """The identity forward; the gradient rounded by ``fn`` on its way
    back."""

    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def decode_boxes(raw: torch.Tensor) -> torch.Tensor:
    """(N, 4, S, S) distance logits (left, top, right, bottom) -> (N, S, S,
    4) boxes (y0, x0, y1, x1) around the cell centres, clipped to [0, 1]."""
    s = raw.shape[-1]
    c = (torch.arange(s, device=raw.device, dtype=torch.float32) + 0.5) / s
    cy, cx = c[:, None], c[None, :]
    left, top, right, bottom = F.softplus(raw).mul(BOX_SCALE).unbind(1)
    return torch.stack([(cy - top).clamp(0, 1), (cx - left).clamp(0, 1),
                        (cy + bottom).clamp(0, 1), (cx + right).clamp(0, 1)],
                       dim=-1)


def _grid(coord: torch.Tensor, size: int) -> torch.Tensor:
    """Pixel coordinate (half-pixel centres) -> grid_sample's [-1, 1]."""
    return (2.0 * coord + 1.0) / size - 1.0


def roi_align(feats: torch.Tensor, boxes: torch.Tensor, r: int) -> torch.Tensor:
    """Bilinear R x R crops: feats (N, E, H, W), boxes (N, K, 4) normalized
    (y0, x0, y1, x1) -> (N, K, E, R, R). Bin i samples ``(c0 + (i + .5) /
    R * (c1 - c0)) * size - 0.5``, clamped to the grid."""
    n, e, h, w = feats.shape
    k = boxes.shape[1]
    t = (torch.arange(r, device=feats.device, dtype=torch.float32) + 0.5) / r
    y0, x0, y1, x1 = boxes.unbind(-1)
    sy = (y0[..., None] + t * (y1 - y0)[..., None]) * h - 0.5  # (N, K, R)
    sx = (x0[..., None] + t * (x1 - x0)[..., None]) * w - 0.5
    gy = _grid(sy, h)[:, :, :, None].expand(n, k, r, r)
    gx = _grid(sx, w)[:, :, None, :].expand(n, k, r, r)
    grid = torch.stack([gx, gy], -1).reshape(n, k * r, r, 2)
    out = F.grid_sample(feats, grid, mode="bilinear", padding_mode="border",
                        align_corners=False)  # (N, E, K*R, R)
    return out.reshape(n, e, k, r, r).transpose(1, 2)
