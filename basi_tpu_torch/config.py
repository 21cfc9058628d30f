"""Config tree, presets and overrides (the port's copy of ``basi_tpu/config.py``).

The same frozen dataclasses, fields, defaults, presets, ``apply_overrides``
and ``get_config`` as the JAX package, so a preset name and a list of
``key.path=value`` overrides mean the same run on both sides (a test holds
``dataclasses.asdict`` of every preset equal). Fields whose setting is not
ported raise ``NotImplementedError`` where the port reads them, not here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    backbone: str = "resnet50"  # resnet18/34/50/101/152 | vgg16 | vgg19
    fpn_channels: int = 256
    mask_channels: int = 64  # unified mask-feature embedding dim E
    grid_size: int = 16  # SxS instance cell grid
    num_slots: int = 20  # fixed instance capacity K after NMS
    image_size: int = 512  # square input resolution
    saliency_levels: int = 4  # deep-supervision outputs P2..P5
    # conv7 | s2d | conv7p8: the same function of the same (7, 7, 3, 64)
    # parameter; the port runs conv7 for all three.
    stem_mode: str = "conv7"
    # Trunk BatchNorm: "xla" = the framework's batch norm; "fused" =
    # FusedBatchNorm (channel_moments forward, channel_dual_sums in a
    # hand-written backward); "stats" = channel_moments forward only.
    bn_impl: str = "xla"  # xla | fused | stats
    instance_mechanism: str = "kernels"  # kernels | connected | roi
    roi_resolution: int = 28  # roi mechanism: ROI-frame mask size R
    roi_top_k: int = 64  # roi mechanism: proposals kept at inference
    refine: bool = False  # residual refinement module on the saliency map
    dtype: str = "float32"  # compute dtype: float32 | bfloat16
    param_dtype: str = "float32"


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"  # synthetic | ilso | soc | folder | coco | shards
    root: str = ""
    split: str = "train"
    ann_file: str = ""  # COCO only: explicit annotation JSON
    batch_size: int = 16
    image_size: int = 512
    max_instances: int = 8  # GT instance slots per image (padded)
    mean: tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: tuple[float, float, float] = (0.229, 0.224, 0.225)
    hflip_prob: float = 0.5
    scale_range: tuple[float, float] = (0.75, 1.25)
    # brightness/contrast/saturation jitter strengths; (0, 0, 0) = off
    color_jitter: tuple[float, float, float] = (0.0, 0.0, 0.0)
    multiscale: bool = False
    pack_masks: bool = True  # ship GT masks bit-packed along W
    synthetic_n: int = 256  # synthetic train-split size (val = n // 4)
    # synthetic only: non-square originals up to this multiple of
    # image_size, letterboxed down (1.0 = square scenes at model size)
    synthetic_orig_scale: float = 1.0
    prefetch_depth: int = 2  # batches the host feed runs ahead
    decode_backend: str = "auto"  # auto | native | pil | synthetic


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 1
    steps_per_epoch: int = 32  # used when dataset is synthetic
    optimizer: str = "sgd"  # sgd | adamw
    lr: float = 1e-2
    momentum: float = 0.9
    weight_decay: float = 5e-4
    schedule: str = "poly"  # poly | cosine | constant
    poly_power: float = 0.9  # lr * (1 - iter/max_iter)^0.9
    warmup_steps: int = 0
    loss: str = "bce_dice"  # bce_dice | basnet_hybrid
    score_loss_weight: float = 1.0
    mask_loss_weight: float = 3.0
    saliency_loss_weight: float = 1.0
    box_loss_weight: float = 1.0  # roi mechanism
    # the mask loss applies only the top-P positive cells' kernels
    max_pos_cells: int = 64
    grad_clip_norm: float = 10.0  # 0 disables
    flatten_optimizer: bool = False
    freeze_bn: bool = False
    # EMA of the params (0 = off), d_t = min(ema_decay, (1+t)/(10+t))
    ema_decay: float = 0.0
    seed: int = 0
    checkpoint_dir: str = "./ckpt"
    checkpoint_every_steps: int = 0  # 0 -> per epoch
    async_checkpoint: bool = False
    save_on_preemption: bool = True
    stop_poll_steps: int = 16
    keep_checkpoints: int = 3
    resume: str = "auto"  # auto | none | <path>
    remat: bool = False
    grad_accum: int = 1
    steps_per_dispatch: int = 1
    log_every: int = 10


@dataclass(frozen=True)
class ParallelConfig:
    data_axis: str = "data"
    num_devices: int = 0  # 0 -> all available
    spatial_axis: str = ""  # optional H-dim sharding axis name ("" = off)
    spatial_shards: int = 1


@dataclass(frozen=True)
class InferConfig:
    batch_size: int = 8
    score_threshold: float = 0.1
    mask_threshold: float = 0.5
    nms: str = "matrix"  # matrix (gauss decay) | matrix_linear | greedy
    nms_sigma: float = 2.0
    nms_iou_threshold: float = 0.5
    pre_nms_top_k: int = 64
    output_dir: str = "./out"
    save_png: bool = False
    ap_at_original: bool = False  # evaluate at original image resolution
    native_gt_cache: str = "auto"
    dtype: str = "bfloat16"  # bfloat16 | float32 | int8
    connected_split: str = "edt"  # none | erode | edt
    connected_erode: int = 2
    wf: bool = True  # weighted F-measure on the eval path
    tta: str = ""  # "" | "hflip"
    tta_scales: tuple = ()


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    infer: InferConfig = field(default_factory=InferConfig)
    profile: bool = False
    profile_dir: str = "./profile"
    metrics_path: str = ""  # "" -> stdout only; else JSONL file
    tensorboard_dir: str = ""  # "" -> off; else TB event files (scalars)


def _replace_path(cfg: Any, dotted: str, value: str) -> Any:
    """Immutable update of ``cfg`` at a dotted path with a parsed value."""
    head, _, rest = dotted.partition(".")
    if not hasattr(cfg, head):
        raise KeyError(f"no config field {head!r} on {type(cfg).__name__}")
    cur = getattr(cfg, head)
    if rest:
        new = _replace_path(cur, rest, value)
    else:
        new = _parse_like(cur, value)
    return dataclasses.replace(cfg, **{head: new})


def _parse_like(template: Any, value: str) -> Any:
    if isinstance(template, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(template, int):
        return int(value)
    if isinstance(template, float):
        return float(value)
    if isinstance(template, tuple):
        parts = [p for p in value.replace("(", "").replace(")", "").split(",") if p]
        elem = template[0] if template else 0.0
        return tuple(_parse_like(elem, p.strip()) for p in parts)
    return value


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply ``key.path=value`` overrides to a Config."""
    for ov in overrides:
        key, _, val = ov.partition("=")
        if not _ or not key:
            raise ValueError(f"override must be key.path=value, got {ov!r}")
        cfg = _replace_path(cfg, key.strip(), val.strip())
    return cfg


# ---------------------------------------------------------------------------
# Presets (the same six as the JAX package).
# ---------------------------------------------------------------------------

def _preset_pr1_cpu_infer() -> Config:
    """Single 512x512 image inference."""
    return Config(
        data=DataConfig(batch_size=1, dataset="synthetic"),
        infer=InferConfig(batch_size=1, dtype="float32"),
    )


def _preset_val_ap() -> Config:
    """Batch-8 inference over the ILSO/SOC val split (the serving path)."""
    return Config(
        model=ModelConfig(stem_mode="s2d"),
        data=DataConfig(batch_size=8, dataset="ilso", split="val"),
        infer=InferConfig(batch_size=8),
    )


def _preset_train_ilso_1ep() -> Config:
    """Full train loop: batch 16, 1 epoch ILSO, BCE/Dice."""
    return Config(
        data=DataConfig(batch_size=16, dataset="ilso"),
        train=TrainConfig(epochs=1, loss="bce_dice"),
    )


def _preset_train_multiscale_fused() -> Config:
    """Multi-scale training, bf16 compute with f32 master weights."""
    return Config(
        model=ModelConfig(dtype="bfloat16"),
        data=DataConfig(batch_size=16, dataset="ilso", multiscale=True),
        train=TrainConfig(epochs=1),
    )


def _preset_train_v4_32_dp() -> Config:
    """Data-parallel training, 30 epochs."""
    return Config(
        model=ModelConfig(dtype="bfloat16"),
        data=DataConfig(batch_size=16, dataset="ilso"),
        train=TrainConfig(epochs=30),
        parallel=ParallelConfig(num_devices=0),
    )


def _preset_bench_accuracy() -> Config:
    """Converged-accuracy recipe: 1,024 procedural scenes with non-square
    originals, 24 epochs, SGD + cosine + EMA, bf16 batch 16."""
    return Config(
        model=ModelConfig(dtype="bfloat16"),
        data=DataConfig(batch_size=16, dataset="synthetic",
                        synthetic_n=1024, synthetic_orig_scale=1.5),
        train=TrainConfig(
            epochs=24, optimizer="sgd", lr=0.01, schedule="cosine",
            warmup_steps=100, ema_decay=0.999, loss="bce_dice",
            checkpoint_dir="", log_every=64,
        ),
        infer=InferConfig(batch_size=16),
    )


PRESETS = {
    "pr1_cpu_infer": _preset_pr1_cpu_infer,
    "val_v4-8_ap": _preset_val_ap,
    "train_ilso_1ep": _preset_train_ilso_1ep,
    "train_multiscale_fused": _preset_train_multiscale_fused,
    "train_v4-32_dp": _preset_train_v4_32_dp,
    "bench_accuracy": _preset_bench_accuracy,
}


def get_config(preset: str = "", overrides: list[str] | None = None) -> Config:
    cfg = PRESETS[preset]() if preset else Config()
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    if cfg.model.image_size != cfg.data.image_size:
        # The letterbox target and the model resolution are separate knobs
        # but must agree.
        raise ValueError(
            f"model.image_size ({cfg.model.image_size}) != data.image_size "
            f"({cfg.data.image_size}): override both together "
            "(--set model.image_size=N --set data.image_size=N)")
    return cfg
