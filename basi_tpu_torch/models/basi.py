"""BASINet (port of ``basi_tpu/models/basi.py``).

backbone -> FPN -> {saliency, unified mask features, an instance head}. The
instance head is the mechanism's (``model.instance_mechanism``): the
kernels mechanism's cell grid of objectness scores and dynamic mask
kernels, or the roi mechanism's cell grid of objectness scores and boxes
(``RoiBoxHead``) with a mask head over ROI crops of the mask features
(``RoiMaskHead``). At inference the roi model proposes: the top
``min(roi_top_k, S*S)`` cells by objectness (a stable sort: ties keep the
lower cell first, as ``jax.lax.top_k``) give the boxes the mask head crops;
in training it predicts at the boxes it is given (``roi_boxes``, the
assigned GT boxes). Takes an NHWC float image and returns NHWC outputs, as
the JAX model does; inside, tensors are NCHW in ``channels_last`` memory so
the NHWC views are free. ``forward(image, train=...)``: eval runs BN on
running statistics; train runs it on batch statistics, updates the running
ones (flax's rule) and adds the saliency deep-supervision outputs.
Activations take the image's dtype while the params may stay f32 (the JAX
package's mixed precision, ``models/layers.py``). Serving and the default
train loss make no candidate-mask tensor: selection applies only the top-k
kernels (``ops.nms.select_instances_from_kernels``) and the loss only the
positive cells' kernels; ``with_candidates`` adds the (N, S*S, H/4, W/4)
candidates for the dense loss (``train.max_pos_cells=0``).

The trunk is chosen by ``model.backbone``: a ResNet (``models/resnet.py``)
or a ConvNeXt (``models/convnext.py``, the port's own: the JAX package has
none), each handing C2..C5 to the FPN at its own widths. A ConvNeXt trunk
has no BatchNorm (``refuse_batchnorm_setting``): it refuses ``model.bn_impl``
fused or stats, and ``train.freeze_bn`` is refused with it.

Two train settings act on the trunk alone, as the JAX model's
``bn_frozen`` and ``remat``: ``frozen_bn`` runs it in eval mode (running
statistics, which never move; the BN scales and biases still train), and
``remat`` wraps it in ``torch.utils.checkpoint`` so its activations are
recomputed in the backward, under ``layers.no_running_update``: the
recompute moves no running statistic a second time (under ``bn_impl``
fused or stats it does launch the forward's ``channel_moments`` again).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from basi_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from basi_tpu_torch.models.convnext import (
    CONVNEXT,
    LAYER_SCALE_INIT,
    Block,
    ConvNeXtTrunk,
)
from basi_tpu_torch.models.fpn import FPN
from basi_tpu_torch.models.layers import no_running_update
from basi_tpu_torch.models.heads import (
    InstanceKernelHead,
    MaskFeatureHead,
    RoiBoxHead,
    RoiMaskHead,
    SaliencyHead,
)
from basi_tpu_torch.models.resnet import BLOCK_KIND, STAGE_SIZES, ResNetTrunk
from basi_tpu_torch.ops.nms import topk_stable
from basi_tpu_torch.ops.roi import decode_cell_boxes

# Prediction convs start near zero, as the JAX heads initialise them; the
# objectness bias starts at the focal prior -log((1 - pi) / pi), pi = 0.01.
_PRED_CONVS = ("saliency.fuse", "instance.score", "instance.kernel",
               "roi_box.score", "roi_box.box", "roi_mask.out")
_SCORE_CONVS = ("instance.score", "roi_box.score")
_PRED_STD = 0.01
_FOCAL_PRIOR_BIAS = -4.595


def refuse_batchnorm_setting(backbone: str, setting: str) -> None:
    """Raise ValueError for ``setting``, one that acts on BatchNorms
    (``model.bn_impl`` fused or stats, ``train.freeze_bn``), on a trunk
    without them."""
    if backbone in CONVNEXT:
        raise ValueError(f"{setting} acts on BatchNorms, and the {backbone} "
                         f"trunk has none")


class BASIOutputs(NamedTuple):
    """Raw model outputs (logits), NHWC views."""

    saliency_logits: torch.Tensor  # (N, H/4, W/4, 1) fused saliency
    cell_scores: torch.Tensor  # (N, S, S, 1) objectness logits
    cell_kernels: torch.Tensor | None  # (N, S, S, E) dynamic mask kernels
    mask_feats: torch.Tensor  # (N, H/4, W/4, E) unified mask features
    # per-level deep supervision (N, H/4, W/4, 1), train mode only
    saliency_aux: tuple[torch.Tensor, ...] = ()
    # (N, S*S, H/4, W/4) candidate masks, with_candidates only
    mask_logits: torch.Tensor | None = None
    # the roi mechanism's (None otherwise)
    cell_boxes: torch.Tensor | None = None  # (N, S, S, 4) f32 y0, x0, y1, x1
    roi_boxes: torch.Tensor | None = None  # (N, K, 4) top-k boxes (inference)
    roi_scores: torch.Tensor | None = None  # (N, K) f32 logits (inference)
    roi_mask_logits: torch.Tensor | None = None  # (N, K, R, R) ROI frame


class BASINet(nn.Module):
    def __init__(self, backbone: str = "resnet50", fpn_channels: int = 256,
                 mask_channels: int = 64, grid_size: int = 16,
                 bn_impl: str = "xla", instance_mechanism: str = "kernels",
                 roi_resolution: int = 28, roi_top_k: int = 64):
        super().__init__()
        if backbone.startswith("vgg"):
            raise NotImplementedError(f"backbone {backbone!r} not yet ported")
        self.backbone_name = backbone
        if bn_impl != "xla":
            refuse_batchnorm_setting(backbone, f"model.bn_impl={bn_impl!r}")
        if backbone in CONVNEXT:
            self.stage_sizes, dims = CONVNEXT[backbone]
            self.backbone = ConvNeXtTrunk(self.stage_sizes, dims)
        elif backbone in STAGE_SIZES:
            self.stage_sizes = STAGE_SIZES[backbone]
            self.backbone = ResNetTrunk(self.stage_sizes,
                                        BLOCK_KIND.get(backbone, "bottleneck"),
                                        bn_impl)
        else:
            raise ValueError(f"unknown backbone {backbone!r}")
        self.fpn = FPN(self.backbone.out_channels, fpn_channels)
        self.saliency = SaliencyHead(fpn_channels, 64, 4)
        self.maskfeat = MaskFeatureHead(fpn_channels, 128, mask_channels, 4)
        self.instance_mechanism = instance_mechanism
        self.grid_size = grid_size
        self.roi_top_k = roi_top_k
        if instance_mechanism == "roi":
            self.roi_box = RoiBoxHead(fpn_channels, 128, grid_size, 3)
            self.roi_mask = RoiMaskHead(mask_channels, mask_channels,
                                        roi_resolution, 2)
        else:
            self.instance = InstanceKernelHead(fpn_channels, 128,
                                               mask_channels, grid_size, 3)

    def forward(self, image: torch.Tensor, train: bool | None = None, *,
                frozen_bn: bool = False, remat: bool = False,
                with_candidates: bool = False,
                roi_boxes: torch.Tensor | None = None) -> BASIOutputs:
        """image: (N, H, W, 3) normalized, in the compute dtype. ``train``
        defaults to the module's mode (``create_model(..., train=True)``);
        ``frozen_bn`` and ``remat`` act on the trunk (module doc).
        ``roi_boxes`` (roi mechanism, training): (N, P, 4) normalized
        boxes at which the ROI mask head predicts; without them the model
        takes its own top-k proposals. ``with_candidates`` reads only for
        the kernels mechanism."""
        train = self.training if train is None else train
        x = image.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        trunk_train = train and not frozen_bn
        if remat and torch.is_grad_enabled():
            feats = checkpoint(
                self.backbone, x, trunk_train, use_reentrant=False,
                preserve_rng_state=False,  # the trunk draws nothing
                context_fn=lambda: (contextlib.nullcontext(),
                                    no_running_update(self.backbone)))
        else:
            feats = self.backbone(x, trunk_train)
        pyramid = self.fpn(list(feats))
        sal, aux = self.saliency(pyramid, with_aux=train)
        mask_feats = self.maskfeat(pyramid)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        if self.instance_mechanism == "roi":
            return self._roi_outputs(
                nhwc(sal), nhwc(mask_feats), tuple(nhwc(a) for a in aux),
                *(nhwc(t) for t in self.roi_box(pyramid[1])), roi_boxes)
        scores, kernels = self.instance(pyramid[1])  # P3, stride 8
        out = BASIOutputs(nhwc(sal), nhwc(scores), nhwc(kernels),
                          nhwc(mask_feats), tuple(nhwc(a) for a in aux))
        if with_candidates:
            out = out._replace(mask_logits=candidate_masks(
                out.mask_feats, out.cell_kernels))
        return out

    def _roi_outputs(self, sal, mask_feats, aux, cell_scores, box_raw,
                     roi_boxes) -> BASIOutputs:
        """The roi mechanism's outputs from the box head's NHWC logits:
        decoded cell boxes, the proposals (top-k cells by objectness,
        their boxes and f32 logits) unless ``roi_boxes`` is given, and the
        mask head's logits at the boxes."""
        cell_boxes = decode_cell_boxes(box_raw, self.grid_size)
        top_boxes = top_scores = None
        if roi_boxes is None:
            n = cell_scores.shape[0]
            ss = self.grid_size * self.grid_size
            top_scores, top_idx = topk_stable(
                cell_scores.reshape(n, ss).float(), min(self.roi_top_k, ss))
            roi_boxes = top_boxes = torch.gather(
                cell_boxes.reshape(n, ss, 4), 1,
                top_idx[..., None].expand(-1, -1, 4))
        return BASIOutputs(
            sal, cell_scores, None, mask_feats, aux,
            cell_boxes=cell_boxes, roi_boxes=top_boxes, roi_scores=top_scores,
            roi_mask_logits=self.roi_mask(mask_feats, roi_boxes))


def candidate_masks(mask_feats: torch.Tensor,
                    kernels: torch.Tensor) -> torch.Tensor:
    """Every cell's dynamic kernel applied to the mask features: (N, H, W,
    E) and (N, S, S, E) -> (N, S*S, H, W) logits, products summed in f32
    and rounded to the features' dtype (the JAX package's
    ``heads.candidate_masks``)."""
    n, s1, s2, e = kernels.shape
    k = kernels.reshape(n, s1 * s2, e)
    return torch.einsum("nhwe,nke->nkhw", mask_feats.float(),
                        k.float()).to(mask_feats.dtype)


def check_model_config(mcfg) -> None:
    """Raise NotImplementedError for model settings outside the port."""
    if mcfg.instance_mechanism not in ("kernels", "roi"):
        raise NotImplementedError(
            f"model.instance_mechanism={mcfg.instance_mechanism!r} not yet ported")
    if mcfg.refine:
        raise NotImplementedError("model.refine not yet ported")


def create_model(mcfg, device=DEFAULT_DEVICE,
                 generator: torch.Generator | None = None,
                 train: bool = False) -> BASINet:
    """BASINet for a ``config.ModelConfig`` on ``device`` (the card unless
    another is named), f32, ``channels_last``, BatchNorms of
    ``model.bn_impl``, with random weights from ``generator`` (seed 0 when
    omitted), in eval mode (serving) or, with ``train``, in train mode with
    f32 master params for ``train.step`` (``cast_params`` for others);
    load real weights with
    ``convert.load_jax_variables`` or ``load_state_dict``."""
    check_model_config(mcfg)
    with torch.device("meta"):  # no throwaway default init
        model = BASINet(mcfg.backbone, mcfg.fpn_channels, mcfg.mask_channels,
                        mcfg.grid_size, mcfg.bn_impl, mcfg.instance_mechanism,
                        mcfg.roi_resolution, mcfg.roi_top_k)
    model = model.to_empty(device=resolve_device(device))
    init_weights(model, generator or torch.Generator().manual_seed(0))
    return model.to(memory_format=torch.channels_last).train(train)


@torch.no_grad()
def cast_params(model: BASINet, dtype: torch.dtype) -> BASINet:
    """Hold every parameter in ``dtype`` (``model.param_dtype``); buffers,
    the BN running statistics among them, stay f32, as flax keeps its
    ``batch_stats``. In place; returns the model."""
    for p in model.parameters():
        p.data = p.data.to(dtype)
    return model


@torch.no_grad()
def init_weights(model: BASINet, generator: torch.Generator) -> None:
    """Fill every parameter and buffer from ``generator`` (a CPU
    generator: the same seed gives the same weights on every device).
    Convs and Linears: N(0, 1/fan_in), zero bias; prediction convs N(0,
    0.01^2); norms identity; BN running stats (0, 1); ConvNeXt's layer
    scale ``LAYER_SCALE_INIT``."""
    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            pred = name in _PRED_CONVS or name.startswith("saliency.out")
            normal(m.weight, _PRED_STD if pred else m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                m.bias.fill_(_FOCAL_PRIOR_BIAS if name in _SCORE_CONVS else 0.0)
        elif isinstance(m, nn.Linear):
            normal(m.weight, m.in_features ** -0.5)
            m.bias.fill_(0.0)
        elif isinstance(m, Block):
            m.gamma.fill_(LAYER_SCALE_INIT)
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
