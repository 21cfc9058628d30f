"""Print the bf16 - f32 loss gap of the port and of the JAX package term
by term, and each loss term of both on JAX's own bf16 outputs.

    python tests/torch_bf16_loss_terms.py

1. One train step of the tiny model (``xla``, ``_run_steps``' batch of
   ``tests/test_torch_bf16.py``) in bf16 and in f32, each framework
   against itself: the gap of every metric.
2. On three batches, JAX's bf16 train-mode outputs fed to both losses:
   the relative difference of each term, beside JAX's own bf16 - f32 gap.
Runs on the CPU (JAX and torch both), a minute or two.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import conftest  # noqa: E402,F401  (JAX on the CPU, as the tests run it)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import test_torch_bf16 as T  # noqa: E402
from basi_tpu.models.basi import create_model as jax_create_model  # noqa: E402
from basi_tpu.ops.resize import maxpool_hw as jax_maxpool  # noqa: E402
from basi_tpu.train.loss import basi_loss as jax_basi_loss  # noqa: E402
from basi_tpu.train.targets import instance_stats as jax_stats  # noqa: E402
from basi_tpu_torch.models.basi import BASIOutputs  # noqa: E402
from basi_tpu_torch.ops.resize import maxpool_hw  # noqa: E402
from basi_tpu_torch.train.loss import basi_loss  # noqa: E402
from basi_tpu_torch.train.targets import instance_stats  # noqa: E402
from helpers import tiny_batch, tiny_config  # noqa: E402
from test_torch_model import jax_variables  # noqa: E402
from test_torch_train import _run_steps  # noqa: E402


def step_gaps() -> None:
    out = {}
    for dtype in ("bfloat16", "float32"):
        with pytest.MonkeyPatch.context() as mp:
            for jm, _, _, tm, _, _ in _run_steps(
                    T._step_config("xla"), dtype, mp, n_steps=1,
                    param_dtype="float32"):
                out[dtype] = ({k: float(v) for k, v in jm.items()},
                              {k: float(v) for k, v in tm.items()})
    (jb, tb), (jf, tf) = out["bfloat16"], out["float32"]
    print("one step, bf16 - f32:  term  JAX  port")
    for k in jf:
        print(f"  {k:14s} {jb[k] - jf[k]:11.3e} {tb[k] - tf[k]:11.3e}")


def losses(out, b, cfg, bf16: bool) -> tuple[dict, dict]:
    masks, valid = jnp.asarray(b["masks"]), jnp.asarray(b["valid"])
    _, want = jax_basi_loss(
        out, jax_maxpool(masks, 4, 4).astype(jnp.float32), valid,
        gt_stats=jax.vmap(jax_stats)(masks, valid),
        max_pos_cells=cfg.train.max_pos_cells)
    dtype = torch.bfloat16 if bf16 else torch.float32

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dtype)

    tout = BASIOutputs(t(out.saliency_logits), t(out.cell_scores),
                       t(out.cell_kernels), t(out.mask_feats),
                       tuple(t(a) for a in out.saliency_aux))
    tm, tv = torch.from_numpy(b["masks"]), torch.from_numpy(b["valid"])
    _, got = basi_loss(tout, maxpool_hw(tm, 4, 4).float(), tv,
                       gt_stats=instance_stats(tm, tv),
                       max_pos_cells=cfg.train.max_pos_cells)
    return ({k: float(v) for k, v in want.items()},
            {k: float(v) for k, v in got.items()})


def same_outputs() -> None:
    cfg = tiny_config(batch_size=4)
    params, stats = jax_variables(cfg)
    for seed in (7, 8, 9):
        b = tiny_batch(np.random.RandomState(seed), n=4)
        x = (b["image"].astype(np.float32) / 255.0
             - np.asarray(cfg.data.mean, np.float32)) / np.asarray(
            cfg.data.std, np.float32)
        res = {}
        for dt in ("float32", "bfloat16"):
            model = jax_create_model(cfg.model).clone(dtype=jnp.dtype(dt))
            out, _ = model.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x, jnp.dtype(dt)), train=True,
                                 with_candidates=False,
                                 mutable=["batch_stats"])
            res[dt] = losses(out, b, cfg, dt == "bfloat16")
        (j16, t16), (j32, _) = res["bfloat16"], res["float32"]
        print(f"batch seed {seed}, JAX's bf16 outputs:  term  port vs JAX "
              f"(relative)  JAX bf16 - f32")
        for k in j16:
            rel = abs(t16[k] - j16[k]) / max(abs(j16[k]), 1e-12)
            print(f"  {k:14s} {rel:9.2e} {j16[k] - j32[k]:11.3e}")


if __name__ == "__main__":
    step_gaps()
    same_outputs()
