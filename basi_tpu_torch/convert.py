"""Weight bridge between JAX BASINet variables and the port's BASINet.

JAX -> port: ``export_basinet`` (the JAX package's jax-free exporter) maps
the flax ``params``/``batch_stats`` trees to torch names and layouts; the
state dict then loads with ``strict=True``, so a missing or extra key
raises. A checkpoint of the roi mechanism has no ``instance`` head and is
refused by the exporter. ``load_jax_train_state`` starts training from such
variables as the JAX package's ``create_train_state`` does: empty momentum,
EMA at the params.

Port -> JAX: ``to_jax_variables`` goes back through
``basi_tpu.convert.full_import.import_basinet`` (numpy only), for the
params and batch_stats or for any tensors named like the params (gradients,
the EMA), which take the same mapping.
"""

from __future__ import annotations

import numpy as np
import torch

from basi_tpu.convert.torch_export import export_basinet


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
    from basi_tpu.convert.full_import import import_basinet

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
