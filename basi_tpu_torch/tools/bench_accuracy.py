"""Converged-accuracy run of the port (port of ``tools/bench_accuracy.py``,
kernels mechanism).

    python -m basi_tpu_torch.tools.bench_accuracy --out PATH \\
        [--epochs N] [--synthetic-n N] [--seed S] [--ckpt-root DIR]

Runs the ``bench_accuracy`` preset (1,024 synthetic scenes with non-square
originals, 24 epochs, SGD + cosine + EMA, bf16 batch 16) as the JAX tool
does: packs the train and val splits into shards under
``<ckpt-root>/shards`` (once), trains from them with a checkpoint each
epoch and the per-epoch eval on the val shards, then loads the checkpoint
(EMA weights preferred) and evaluates at the original resolution on the
raw synthetic val split. Writes the JAX tool's JSON keys to ``--out``. The
roi and connected mechanisms are not ported and raise. ``--out`` is
required and may not name one of the repo's ``bench_accuracy*.json``,
which are the JAX package's records. Runs on the card.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import numbers
import os
import pathlib
import time

from basi_tpu_torch.config import get_config
from basi_tpu_torch.data.datasets import make_dataset
from basi_tpu_torch.data.shards import pack_dataset
from basi_tpu_torch.device import DEFAULT_DEVICE
from basi_tpu_torch.infer import Inferencer
from basi_tpu_torch.train.loop import Trainer

PORTED = ("kernels",)
NOT_PORTED = ("roi", "connected")
REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


def pack_splits(overrides: list[str], shard_root: str) -> list[str]:
    """Pack the train and val splits of ``bench_accuracy`` with
    ``overrides`` into ``shard_root/<split>``, each unless a finished one
    (with its ``index.json``) is there. Returns the overrides that train
    from them."""
    cfg = get_config("bench_accuracy", overrides)
    for split in ("train", "val"):
        out_dir = os.path.join(shard_root, split)
        if not os.path.isfile(os.path.join(out_dir, "index.json")):
            print(f"[bench_accuracy] packing {split} shards ...", flush=True)
            pack_dataset(make_dataset(cfg.data, split=split), out_dir,
                         batch_size=cfg.data.batch_size)
    return overrides + ["data.dataset=shards", f"data.root={shard_root}"]


def run_training(preset_overrides: list[str], ckpt_dir: str,
                 device=DEFAULT_DEVICE) -> dict:
    cfg = get_config("bench_accuracy",
                     preset_overrides + [f"train.checkpoint_dir={ckpt_dir}"])
    t0 = time.perf_counter()
    tr = Trainer(cfg, device=device)
    metrics = tr.train()
    tr.close()
    return {"train_wall_s": round(time.perf_counter() - t0, 1),
            "last_train_metrics": {k: float(v) for k, v in metrics.items()
                                   if isinstance(v, numbers.Number)
                                   and not isinstance(v, bool)}}


def run_final_eval(mechanism: str, ckpt_dir: str,
                   overrides: list[str] | None = None,
                   device=DEFAULT_DEVICE) -> dict:
    """Original-resolution eval, the full suite, of the checkpoint's
    weights (EMA preferred, as the Trainer's eval) on the raw val split."""
    cfg = get_config("bench_accuracy", (overrides or []) + [
        f"model.instance_mechanism={mechanism}", "infer.ap_at_original=true"])
    inf = Inferencer(cfg, device=device, checkpoint=ckpt_dir)
    ds = make_dataset(cfg.data, split="val")
    t0 = time.perf_counter()
    metrics = inf.evaluate(ds)
    metrics["eval_wall_s"] = round(time.perf_counter() - t0, 1)
    return metrics


def _check_out(path: str) -> None:
    p = pathlib.Path(path).resolve()
    if p.parent == REPO_ROOT and fnmatch.fnmatch(p.name, "bench_accuracy*.json"):
        raise SystemExit(f"--out {path}: the repo's bench_accuracy*.json are "
                         "the JAX package's records; write elsewhere")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True,
                    help="JSON result path (not a bench_accuracy*.json of "
                         "the repo)")
    ap.add_argument("--ckpt-root", default="./ckpt_bench_accuracy")
    ap.add_argument("--epochs", type=int, default=0,
                    help="override the preset's epochs (smoke runs)")
    ap.add_argument("--synthetic-n", type=int, default=0)
    ap.add_argument("--skip-train", action="store_true",
                    help="reuse existing checkpoints, eval only")
    ap.add_argument("--seed", type=int, default=0,
                    help="train.seed (init, batch order, flips)")
    ap.add_argument("--mechanisms", default="kernels",
                    help="comma list of mechanisms; only kernels is ported")
    ap.add_argument("--eval-overrides", default="",
                    help="comma list of extra dotted overrides applied to "
                         "the final evals only")
    args = ap.parse_args(argv)
    _check_out(args.out)

    overrides = []
    if args.epochs:
        overrides.append(f"train.epochs={args.epochs}")
    if args.synthetic_n:
        overrides.append(f"data.synthetic_n={args.synthetic_n}")
    if args.seed:
        overrides.append(f"train.seed={args.seed}")
    eval_overrides = [o for o in args.eval_overrides.split(",") if o]
    mechs = [m for m in args.mechanisms.split(",") if m]
    for m in mechs:
        if m in NOT_PORTED:
            raise NotImplementedError(f"mechanism {m!r} not yet ported")
        if m not in PORTED:
            raise ValueError(f"unknown mechanism {m!r}")

    # Training streams from shards; the final eval draws the raw val
    # split, whose native GT the original frame needs.
    train_overrides = pack_splits(
        overrides, os.path.join(args.ckpt_root, "shards"))
    results: dict = {"recipe": "bench_accuracy", "overrides": overrides,
                     "seed": args.seed, "eval_overrides": eval_overrides}
    for mech in mechs:
        ckpt = os.path.join(args.ckpt_root, mech)
        rec: dict = {}
        if not args.skip_train:
            print(f"[bench_accuracy] training {mech} ...", flush=True)
            rec.update(run_training(
                train_overrides + [f"model.instance_mechanism={mech}"], ckpt))
        print(f"[bench_accuracy] final eval {mech} ...", flush=True)
        rec["final_eval"] = run_final_eval(mech, ckpt,
                                           overrides + eval_overrides)
        results[mech] = rec
    by_map = {m: results[m]["final_eval"].get("mAP", 0.0) for m in mechs}
    results["flagship"] = max(by_map, key=by_map.get)
    results["mAP"] = by_map
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"flagship": results["flagship"], "mAP": by_map}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
