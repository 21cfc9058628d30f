"""Where the port's entry points run.

``Inferencer``, ``BatchedPredictor``, ``Trainer`` and ``create_model`` run on
the card unless the caller names another device (``device="cpu"``). A CUDA
device that is not there raises: the port never moves to the CPU on its own.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device(device)``, a CUDA device with its index (``"cuda"`` is
    the current device, as ``torch.cuda.set_device`` and the feed thread
    need it); raises RuntimeError for a CUDA device when no CUDA device is
    available."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r}: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
