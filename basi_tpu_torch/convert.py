"""Weight bridge: JAX BASINet variables -> the port's BASINet.

``export_basinet`` (the JAX package's jax-free exporter) maps the flax
``params``/``batch_stats`` trees to torch names and layouts; the state dict
then loads with ``strict=True``, so a missing or extra key raises. A
checkpoint of the roi mechanism has no ``instance`` head and is refused by
the exporter.
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


def _host(v) -> np.ndarray:
    a = np.asarray(v)
    # bf16 leaves (ml_dtypes) have no torch.from_numpy path: widen exactly.
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
