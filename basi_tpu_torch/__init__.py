"""basi_tpu_torch: the PyTorch/CUDA port of basi_tpu for NVIDIA Hopper.

The JAX package ``basi_tpu`` stays the reference. This package imports
``torch`` and numpy, never ``jax`` or ``flax``, and nothing of ``basi_tpu``:
it keeps its own copies of the config tree (``config``), the weight
mappings (``convert``) and the synthetic dataset (``data.datasets``). The
entry points run on the card unless a caller names another device
(``device="cpu"``). Exports are lazy, so ``import basi_tpu_torch`` loads
nothing heavy.
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
