"""Weight bridge between JAX BASINet variables and the port's BASINet.

JAX -> port: ``export_basinet`` maps the flax ``params``/``batch_stats``
trees to torch names and layouts (conv HWIO -> OIHW, norm scale/bias ->
weight/bias, BN mean/var -> running_mean/running_var, a zero
``num_batches_tracked``); the state dict then loads with ``strict=True``,
so a missing or extra key raises. A checkpoint of the roi mechanism holds
``roi_box`` and ``roi_mask`` heads where the kernels mechanism's holds
``instance``, and maps to the port's heads of those names (the JAX
package's ``export_basinet`` refuses it; this one is the port's own).
``load_jax_train_state`` starts training
from such variables as the JAX package's ``create_train_state`` does: empty
momentum, EMA at the params.

Port -> JAX: ``to_jax_variables`` maps back with ``import_basinet`` (the
exact inverse: transposes only), for the params and batch_stats or for any
tensors named like the params (gradients, the EMA), which take the same
mapping.

Both mappings are numpy only and are the port's own copies of the JAX
package's ``convert/torch_export.py`` and ``convert/full_import.py`` for
ResNet trunks and the kernels mechanism's heads of ``models.basi.BASINet``
(tests hold them bitwise equal), grown here by the roi heads; VGG trunks
and the refinement module are not ported.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


# --- JAX trees -> torch state dict -----------------------------------------

def _conv_t(w) -> np.ndarray:
    """flax conv kernel (kH, kW, I, O) -> torch (O, I, kH, kW)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _put_conv(out: dict, tname: str, entry: dict) -> None:
    out[f"{tname}.weight"] = _conv_t(entry["kernel"])
    if "bias" in entry:
        out[f"{tname}.bias"] = np.asarray(entry["bias"])


def _put_norm(out: dict, tname: str, entry: dict, stats: dict | None = None):
    out[f"{tname}.weight"] = np.asarray(entry["scale"])
    out[f"{tname}.bias"] = np.asarray(entry["bias"])
    if stats is not None:  # BatchNorm (GroupNorm has no running stats)
        out[f"{tname}.running_mean"] = np.asarray(stats["mean"])
        out[f"{tname}.running_var"] = np.asarray(stats["var"])
        out[f"{tname}.num_batches_tracked"] = np.asarray(0, np.int64)


# Head depths of ``models.basi.BASINet``: FPN, saliency and mask-feature
# levels.
FPN_LEVELS, SALIENCY_LEVELS, MASKFEAT_LEVELS = 4, 4, 4
# each mechanism's instance heads: name -> (tower convs, prediction convs)
INSTANCE_HEADS = {"kernels": {"instance": (3, ("score", "kernel"))},
                  "roi": {"roi_box": (3, ("score", "box")),
                          "roi_mask": (2, ("out",))}}


def _check_backbone(backbone: str) -> None:
    if backbone.startswith("vgg"):
        raise NotImplementedError(f"backbone {backbone!r} not yet ported")


def _check_no_refine(has_refine: bool) -> None:
    if has_refine:
        raise NotImplementedError("the refinement module (model.refine) is "
                                  "not yet ported")


def export_resnet_backbone(params: dict, stats: dict,
                           stage_sizes=(3, 4, 6, 3)) -> dict:
    """ResNet params/batch_stats trees -> torchvision-style entries (no
    ``backbone.`` prefix). Bottleneck blocks have convs a/b/c, BasicBlocks
    a/b."""
    out: dict = {}
    _put_conv(out, "conv1", params["stem"]["conv"])
    _put_norm(out, "bn1", params["stem"]["bn"], stats["stem"]["bn"])
    sub = {"a": "1", "b": "2", "c": "3"}
    if "c" not in params["layer1_0"]:
        sub = {"a": "1", "b": "2"}
    for stage, blocks in enumerate(stage_sizes, start=1):
        for b in range(blocks):
            mod = f"layer{stage}_{b}"
            base = f"layer{stage}.{b}"
            for ours, k in sub.items():
                _put_conv(out, f"{base}.conv{k}", params[mod][ours]["conv"])
                _put_norm(out, f"{base}.bn{k}", params[mod][ours]["bn"],
                          stats[mod][ours]["bn"])
            if "proj" in params[mod]:
                _put_conv(out, f"{base}.downsample.0",
                          params[mod]["proj"]["conv"])
                _put_norm(out, f"{base}.downsample.1",
                          params[mod]["proj"]["bn"],
                          stats[mod]["proj"]["bn"])
    return out


def export_basinet(params: dict, batch_stats: dict,
                   stage_sizes=(3, 4, 6, 3),
                   backbone: str = "resnet50") -> dict:
    """Full BASINet variables -> torch state dict (numpy arrays), the exact
    inverse of ``import_basinet``. The instance heads are the kernels
    mechanism's ``instance`` or the roi mechanism's ``roi_box`` and
    ``roi_mask``; a tree with neither raises ValueError."""
    heads = ["maskfeat"] + list(INSTANCE_HEADS[_mechanism(params)])
    _check_backbone(backbone)
    _check_no_refine("refine" in params)
    out: dict = {}
    bb = export_resnet_backbone(params["backbone"], batch_stats["backbone"],
                                stage_sizes)
    out.update({f"backbone.{k}": v for k, v in bb.items()})
    for name, entry in params["fpn"].items():  # lateral{i} / smooth{i}
        _put_conv(out, f"fpn.{name}", entry)
    for name, entry in params["saliency"].items():  # tower{i} / out{i} / fuse
        _put_conv(out, f"saliency.{name}", entry)
    for head in heads:  # level|tower{i} / gn{i} / ...
        for name, entry in params[head].items():
            if name.startswith("gn"):
                _put_norm(out, f"{head}.{name}", entry)
            else:
                _put_conv(out, f"{head}.{name}", entry)
    return out


def _mechanism(params) -> str:
    """The instance mechanism whose heads a params tree (or a set of head
    names) holds."""
    for mech, heads in INSTANCE_HEADS.items():
        if all(h in params for h in heads):
            return mech
    raise ValueError("the checkpoint holds no instance head: neither the "
                     "kernels mechanism's 'instance' nor the roi "
                     "mechanism's 'roi_box' and 'roi_mask'")


# --- torch state dict -> JAX trees -----------------------------------------

def _conv(w: np.ndarray) -> np.ndarray:
    """torch conv weight (O, I, kH, kW) -> flax (kH, kW, I, O)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _set(tree: dict, path: list[str], value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _import_convbn(sd: Mapping[str, np.ndarray], conv: str, bn: str,
                   params: dict, stats: dict, path: list[str]) -> None:
    _set(params, path + ["conv", "kernel"], _conv(sd[conv + ".weight"]))
    _set(params, path + ["bn", "scale"], sd[bn + ".weight"])
    _set(params, path + ["bn", "bias"], sd[bn + ".bias"])
    _set(stats, path + ["bn", "mean"], sd[bn + ".running_mean"])
    _set(stats, path + ["bn", "var"], sd[bn + ".running_var"])


def import_resnet_backbone(state_dict: Mapping[str, np.ndarray],
                           stage_sizes=(3, 4, 6, 3)) -> tuple[dict, dict]:
    """torchvision-style ResNet entries (no ``backbone.`` prefix) ->
    (params, batch_stats) trees of the JAX trunk."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    params: dict = {}
    stats: dict = {}
    _import_convbn(sd, "conv1", "bn1", params, stats, ["stem"])
    if "layer1.0.conv3.weight" in sd:  # Bottleneck; BasicBlock has no conv3
        sub = {"conv1": "a", "conv2": "b", "conv3": "c"}
    else:
        sub = {"conv1": "a", "conv2": "b"}
    for stage, blocks in enumerate(stage_sizes, start=1):
        for b in range(blocks):
            base = f"layer{stage}.{b}"
            mod = f"layer{stage}_{b}"
            for tconv, ours in sub.items():
                _import_convbn(sd, f"{base}.{tconv}",
                               f"{base}.{tconv.replace('conv', 'bn')}",
                               params, stats, [mod, ours])
            if f"{base}.downsample.0.weight" in sd:
                _import_convbn(sd, f"{base}.downsample.0",
                               f"{base}.downsample.1", params, stats,
                               [mod, "proj"])
    return params, stats


def _conv_entry(sd, tname):
    out = {"kernel": _conv(sd[f"{tname}.weight"])}
    if f"{tname}.bias" in sd:
        out["bias"] = sd[f"{tname}.bias"]
    return out


def _gn_entry(sd, tname):
    return {"scale": sd[f"{tname}.weight"], "bias": sd[f"{tname}.bias"]}


def import_basinet(state_dict: Mapping[str, np.ndarray],
                   stage_sizes=(3, 4, 6, 3), backbone: str = "resnet50"
                   ) -> tuple[dict, dict]:
    """torch BASINet state dict (numpy arrays) -> (params, batch_stats) of
    the JAX BASINet."""
    _check_backbone(backbone)
    _check_no_refine(any(k.startswith("refine.") for k in state_dict))
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    bb_params, bb_stats = import_resnet_backbone(
        {k[len("backbone."):]: v for k, v in sd.items()
         if k.startswith("backbone.")}, stage_sizes)
    params: dict = {"backbone": bb_params}
    stats: dict = {"backbone": bb_stats} if bb_stats else {}
    params["fpn"] = {}
    for i in range(FPN_LEVELS):
        params["fpn"][f"lateral{i}"] = _conv_entry(sd, f"fpn.lateral{i}")
        params["fpn"][f"smooth{i}"] = _conv_entry(sd, f"fpn.smooth{i}")
    sal = {}
    for i in range(SALIENCY_LEVELS):
        sal[f"tower{i}"] = _conv_entry(sd, f"saliency.tower{i}")
        sal[f"out{i}"] = _conv_entry(sd, f"saliency.out{i}")
    sal["fuse"] = _conv_entry(sd, "saliency.fuse")
    params["saliency"] = sal
    mf = {}
    for i in range(MASKFEAT_LEVELS):
        mf[f"level{i}"] = _conv_entry(sd, f"maskfeat.level{i}")
        mf[f"gn{i}"] = _gn_entry(sd, f"maskfeat.gn{i}")
    mf["embed"] = _conv_entry(sd, "maskfeat.embed")
    params["maskfeat"] = mf
    mech = _mechanism({k.split(".")[0] for k in sd})
    for head, (depth, preds) in INSTANCE_HEADS[mech].items():
        entry = {}
        for i in range(depth):
            entry[f"tower{i}"] = _conv_entry(sd, f"{head}.tower{i}")
            entry[f"gn{i}"] = _gn_entry(sd, f"{head}.gn{i}")
        for name in preds:
            entry[name] = _conv_entry(sd, f"{head}.{name}")
        params[head] = entry
    return params, stats


# --- the port's models --------------------------------------------------------

def load_jax_variables(model: torch.nn.Module, params: dict,
                       batch_stats: dict) -> None:
    """Load JAX ``params``/``batch_stats`` (numpy or array leaves) into
    ``model`` (a ``models.basi.BASINet``)."""
    sd = export_basinet(params, batch_stats, stage_sizes=model.stage_sizes,
                        backbone=model.backbone_name)
    model.load_state_dict({k: torch.from_numpy(_host(v)) for k, v in sd.items()},
                          strict=True)


def load_jax_train_state(model: torch.nn.Module, cfg_train, params: dict,
                         batch_stats: dict):
    """``load_jax_variables``, then a fresh ``TrainState`` around the model
    (momentum empty, EMA at the loaded params, step 0)."""
    from basi_tpu_torch.train.state import create_train_state

    load_jax_variables(model, params, batch_stats)
    return create_train_state(model, cfg_train)


def to_jax_variables(model: torch.nn.Module,
                     tensors: dict[str, torch.Tensor] | None = None
                     ) -> tuple[dict, dict]:
    """The model's (params, batch_stats) as JAX trees of numpy arrays.
    ``tensors``: parameter-named tensors (``named_parameters`` keys, e.g.
    gradients or the EMA) that take the params' places; the returned
    params tree then holds them."""
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    for k, v in (tensors or {}).items():
        if k not in sd:
            raise KeyError(f"{k!r} is not a parameter of the model")
        sd[k] = v.detach()
    # numpy has no bf16: widen it exactly; other dtypes stay as they are
    sd = {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
          for k, v in sd.items()}
    return import_basinet(sd, stage_sizes=model.stage_sizes,
                          backbone=model.backbone_name)


def _host(v) -> np.ndarray:
    a = np.asarray(v)
    # bf16 leaves (ml_dtypes) have no torch.from_numpy path: widen exactly.
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
