"""basi_tpu_torch: the PyTorch/CUDA port of basi_tpu for NVIDIA Hopper.

The JAX package ``basi_tpu`` stays the reference. This package imports
``torch`` and never ``jax``; of ``basi_tpu`` it uses only the jax-free
``basi_tpu.config`` and ``basi_tpu.convert.torch_export``. Exports are lazy,
so ``import basi_tpu_torch`` loads nothing heavy.
"""

_EXPORTS = {
    "Inferencer": "basi_tpu_torch.infer",
    "BatchedPredictor": "basi_tpu_torch.serve",
    "Prediction": "basi_tpu_torch.serve",
    "BASINet": "basi_tpu_torch.models.basi",
    "create_model": "basi_tpu_torch.models.basi",
    "load_jax_variables": "basi_tpu_torch.convert",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(name)


__all__ = list(_EXPORTS)
