"""Torch's share of the CPU for the port's tests (``tests/test_torch_*.py``
import this module first).

Under ``pytest -n W`` every worker's torch would start one intra-op
thread per core, on top of XLA's own pools, so W workers run W times as
many threads as there are cores and wait on each other. This pins each
process's intra-op threads to its share, ``cpu_count // W`` (at least
one); a run without xdist keeps every core.
"""

import contextlib
import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)
torch.set_num_threads(THREADS)


@contextlib.contextmanager
def all_cores():
    """Torch's intra-op threads on every core inside, as a run without
    xdist has them: for a test whose f32 result depends on the order in
    which a one-thread convolution sums (``test_torch_train.
    test_f32_train_step_matches_jax``)."""
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        yield
    finally:
        torch.set_num_threads(THREADS)
