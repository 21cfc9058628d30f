"""basi_tpu_torch: the PyTorch/CUDA port of basi_tpu for NVIDIA Hopper.

The JAX package ``basi_tpu`` stays the reference. This package imports
``torch`` and never ``jax``; of ``basi_tpu`` it uses only the jax-free
``basi_tpu.config``, ``basi_tpu.convert.torch_export`` and
``basi_tpu.convert.full_import``, and the numpy-only
``basi_tpu.data.datasets``. Exports are lazy, so ``import basi_tpu_torch``
loads nothing heavy.
"""

_EXPORTS = {
    "Inferencer": "basi_tpu_torch.infer",
    "BatchedPredictor": "basi_tpu_torch.serve",
    "Prediction": "basi_tpu_torch.serve",
    "BASINet": "basi_tpu_torch.models.basi",
    "create_model": "basi_tpu_torch.models.basi",
    "load_jax_variables": "basi_tpu_torch.convert",
    "load_jax_train_state": "basi_tpu_torch.convert",
    "to_jax_variables": "basi_tpu_torch.convert",
    "Trainer": "basi_tpu_torch.train.loop",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(name)


__all__ = list(_EXPORTS)
