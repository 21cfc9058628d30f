"""Command line of the port (port of ``basi_tpu/cli.py``):

  python -m basi_tpu_torch.cli train   --preset train_ilso_1ep [--set k=v ...]
  python -m basi_tpu_torch.cli infer   --preset val_v4-8_ap --checkpoint DIR
  python -m basi_tpu_torch.cli eval    (alias of infer)
  python -m basi_tpu_torch.cli predict --images DIR --checkpoint DIR
  python -m basi_tpu_torch.cli export  --checkpoint DIR --out DIR
                                       | --torch F.pth | --aot F.basiaot
  python -m basi_tpu_torch.cli import  --torch F.pth --out DIR
  python -m basi_tpu_torch.cli serve   --checkpoint DIR | --aot F.basiaot
  python -m basi_tpu_torch.cli bench   --mode infer|train|e2e
  python -m basi_tpu_torch.cli pack    --out DIR

(installed: ``basi-torch``). Every subcommand runs on the card unless
``--device`` names another (``--device cpu``); without a GPU the default
raises. ``--set`` takes dotted-path config overrides
(``--set data.batch_size=8``). A checkpoint is a params export
(``export --out``), a Trainer checkpoint directory or a torch state dict
file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from basi_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--preset", default="", help="named config preset")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY.PATH=VALUE", help="config override")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--metrics", default="", help="JSONL metrics output path")
    _add_device(p)


def _add_device(p: argparse.ArgumentParser):
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default: the card)")


def _build_cfg(args):
    import dataclasses

    from basi_tpu_torch.config import get_config

    cfg = get_config(args.preset, args.overrides)
    if args.profile:
        cfg = dataclasses.replace(cfg, profile=True)
    if args.metrics:
        cfg = dataclasses.replace(cfg, metrics_path=args.metrics)
    return cfg


def cmd_train(args) -> int:
    from basi_tpu_torch.train.loop import Trainer

    cfg = _build_cfg(args)
    trainer = Trainer(cfg, device=args.device)
    try:
        metrics = trainer.train()
    finally:
        trainer.close()
    print(json.dumps({"final": metrics}))
    return 0


def cmd_infer(args) -> int:
    from basi_tpu_torch.infer import Inferencer
    from basi_tpu_torch.utils.logging import MetricLogger

    cfg = _build_cfg(args)
    inf = Inferencer(cfg, device=args.device, checkpoint=args.checkpoint)
    metrics = inf.evaluate(max_batches=args.max_batches,
                           results_path=args.results)
    if cfg.metrics_path:
        logger = MetricLogger(cfg.metrics_path, console=False)
        logger.log(metrics, prefix="[eval]")
        logger.close()
    print(json.dumps(metrics))
    return 0


def cmd_predict(args) -> int:
    """GT-free prediction: image files or directories in, one
    labeled-instance mask PNG per image out."""
    from basi_tpu_torch.data.datasets import FolderDataset
    from basi_tpu_torch.infer import Inferencer

    cfg = _build_cfg(args)
    paths: list[str] = []
    for p in args.images:
        if os.path.isdir(p):
            paths.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.lower().endswith(FolderDataset.IMG_EXTS)))
        elif os.path.isfile(p):
            paths.append(p)
        else:
            raise FileNotFoundError(f"no such image or directory: {p}")
    if not paths:
        raise SystemExit(f"no images found under {args.images}")
    inf = Inferencer(cfg, device=args.device, checkpoint=args.checkpoint)
    out_dir = args.out or cfg.infer.output_dir
    results = inf.predict_paths(paths, out_dir=out_dir,
                                results_path=args.results)
    print(json.dumps({"images": len(results), "out": out_dir,
                      "results": results}))
    return 0


def cmd_export(args) -> int:
    """A checkpoint -> a params export (``--out``), a reference-key torch
    state dict (``--torch``; the port's own state dict), or a
    ``torch.export`` serving artifact (``--aot``, ``aot.py``)."""
    import dataclasses

    cfg = _build_cfg(args)
    if args.aot:
        # The artifact IS the serving program: it bakes the weights in at
        # infer.dtype (the deployment precision), unlike the exports below
        # which keep f32 masters.
        if not args.checkpoint:
            raise SystemExit("export --aot requires --checkpoint (the "
                             "artifact bakes the weights in; exporting "
                             "random init would be silent)")
        from basi_tpu_torch.aot import save_serving

        plats = [p for p in args.platforms.split(",") if p]
        if len(plats) > 1 or (plats and plats[0] not in ("cuda", "cpu")):
            raise SystemExit(f"--platforms names one device of the export, "
                             f"cuda or cpu; got {args.platforms!r}")
        meta = save_serving(
            args.aot, cfg, checkpoint=args.checkpoint,
            batch_size=args.aot_batch,
            device=plats[0] if plats else args.device)
        print(json.dumps({"exported_aot": args.aot, **{
            k: meta[k] for k in ("batch_size", "model_size", "platforms",
                                 "infer_dtype", "instance_mechanism")}}))
        return 0
    if not args.torch and not args.out:
        raise SystemExit("export needs --out (params), --torch (.pth) "
                         "or --aot (.basiaot)")
    # f32 masters: the Inferencer casts its weights to infer.dtype, which
    # would bake a precision-degraded export.
    cfg = dataclasses.replace(
        cfg, infer=dataclasses.replace(cfg.infer, dtype="float32"))
    from basi_tpu_torch.infer import Inferencer

    inf = Inferencer(cfg, device=args.device, checkpoint=args.checkpoint)
    sd = {k: v.detach().cpu() for k, v in inf.model.state_dict().items()}
    if args.torch:
        import torch

        torch.save(sd, args.torch)
        print(json.dumps({"exported_torch": args.torch, "tensors": len(sd)}))
        return 0
    from basi_tpu_torch.utils.checkpoint import export_params

    export_params(args.out, sd)
    print(json.dumps({"exported": args.out}))
    return 0


def cmd_import(args) -> int:
    """torch ``.pth`` -> params export. ``--what full``: a whole
    reference-key BASINet state dict (``convert.import_basinet``);
    ``--what backbone``: a torchvision-style ResNet state dict
    (``convert.import_resnet_backbone``) onto a fresh init."""
    import numpy as np
    import torch

    from basi_tpu_torch import convert
    from basi_tpu_torch.models.basi import create_model
    from basi_tpu_torch.models.resnet import STAGE_SIZES
    from basi_tpu_torch.utils.checkpoint import export_params

    cfg = _build_cfg(args)
    backbone = cfg.model.backbone
    if args.what == "full" and cfg.model.instance_mechanism == "roi":
        raise ValueError(
            "full import unsupported for model.instance_mechanism='roi' "
            "(reference checkpoints carry kernel-mechanism heads); import "
            "with --what backbone instead")
    if backbone.startswith("convnext"):
        raise ValueError(convert.no_jax_counterpart(backbone))
    if backbone.startswith("vgg"):
        raise NotImplementedError(f"backbone {backbone!r} not yet ported")
    if backbone not in STAGE_SIZES:
        # before the torch file is read: the converters map ResNet trunks
        raise ValueError(
            f"{args.what} import unsupported for backbone {backbone!r} "
            f"(ResNet family state_dicts only)")
    sd = _load_torch_state_dict(args.torch)
    stage_sizes = STAGE_SIZES[backbone]
    model = create_model(cfg.model, args.device)  # fresh init, seed 0
    if args.what == "full":
        if cfg.model.refine and not any(k.startswith("refine.") for k in sd):
            raise ValueError(
                "model.refine=true but the torch checkpoint has no "
                "refine.* keys: import with model.refine=false or use a "
                "refine-trained checkpoint")
        params, stats = convert.import_basinet(sd, stage_sizes,
                                               backbone=backbone)
        got = convert.export_basinet(params, stats, stage_sizes, backbone)
    else:
        bb_params, bb_stats = convert.import_resnet_backbone(sd, stage_sizes)
        got = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
        got.update({f"backbone.{k}": v for k, v in
                    convert.export_resnet_backbone(
                        bb_params, bb_stats, stage_sizes).items()})
    _check_against_template(model, got)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in got.items()}, strict=True)
    export_params(args.out, {k: v.cpu()
                             for k, v in model.state_dict().items()})
    print(json.dumps({"imported": args.torch, "exported": args.out,
                      "what": args.what}))
    return 0


def _load_torch_state_dict(path: str) -> dict:
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
            for k, v in sd.items()}


def _check_against_template(model, state_dict: dict) -> None:
    """Fail with a readable diff when the converted state dict does not
    match the model (a silent mismatch would surface only as AP drift)."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(getattr(v, "shape", ())) for k, v in state_dict.items()}
    if got == want:
        return
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    wrong = sorted(k for k in set(got) & set(want) if got[k] != want[k])
    raise ValueError(
        f"converted weights do not match the model: missing={missing[:8]} "
        f"extra={extra[:8]} shape-mismatch="
        f"{[(k, got[k], want[k]) for k in wrong[:8]]}")


def cmd_serve(args) -> int:
    """HTTP serving endpoint over the batched predictor (server.py)."""
    from basi_tpu_torch.server import serve_forever

    cfg = _build_cfg(args)
    return serve_forever(cfg, checkpoint=args.checkpoint, host=args.host,
                         port=args.port, aot_path=args.aot,
                         device=args.device)


def cmd_bench(args) -> int:
    from basi_tpu_torch.benchmark import run

    return run(mode=args.mode, overrides=args.overrides, device=args.device)


def cmd_pack(args) -> int:
    """Decode the configured dataset once into a packed shard cache
    (``data/shards.py``); later runs read it with ``--set
    data.dataset=shards data.root=<out>``."""
    from basi_tpu_torch.data.datasets import make_dataset
    from basi_tpu_torch.data.shards import pack_dataset
    from basi_tpu_torch.utils.tools import Tools

    cfg = _build_cfg(args)
    ds = make_dataset(cfg.data, split=args.split or cfg.data.split)
    pack_dataset(ds, args.out, shard_size=args.shard_size,
                 batch_size=cfg.data.batch_size, log=Tools.print)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="basi-torch", description=__doc__,
                                     formatter_class=argparse.
                                     RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train", help="train a BASI model")
    _add_common(p_train)
    p_train.set_defaults(fn=cmd_train)

    for name in ("infer", "eval"):
        p_inf = sub.add_parser(name, help="run inference / eval AP")
        _add_common(p_inf)
        p_inf.add_argument("--checkpoint", default="",
                           help="params export, Trainer checkpoint or .pth")
        p_inf.add_argument("--max-batches", type=int, default=0)
        p_inf.add_argument("--results", default="",
                           help="also write a COCO-format results JSON")
        p_inf.set_defaults(fn=cmd_infer)

    p_pred = sub.add_parser(
        "predict", help="images in, instance-mask PNGs out (no labels)")
    _add_common(p_pred)
    p_pred.add_argument("--images", nargs="+", required=True,
                        help="image files and/or directories")
    # Required: random weights would write plausible garbage PNGs.
    p_pred.add_argument("--checkpoint", required=True,
                        help="params export, Trainer checkpoint or .pth")
    p_pred.add_argument("--out", default="", help="PNG output dir")
    p_pred.add_argument("--results", default="",
                        help="also write a COCO-format results JSON "
                             "(compressed-RLE segmentations at original "
                             "resolution)")
    p_pred.set_defaults(fn=cmd_predict)

    p_exp = sub.add_parser(
        "export", help="checkpoint -> params export, .pth or AOT artifact")
    _add_common(p_exp)
    p_exp.add_argument("--checkpoint", required=True)
    p_exp.add_argument("--out", default="", help="params export dir")
    p_exp.add_argument("--torch", default="",
                       help="write a reference-key torch state_dict .pth")
    p_exp.add_argument("--aot", default="",
                       help="write a torch.export serving artifact "
                            "(.basiaot): the inference program and its "
                            "weights")
    p_exp.add_argument("--aot-batch", type=int, default=0,
                       help="serving batch size baked into the AOT program "
                            "(default: infer.batch_size)")
    p_exp.add_argument("--platforms", default="",
                       help="the device of the AOT export, cuda or cpu "
                            "(default: --device)")
    p_exp.set_defaults(fn=cmd_export)

    p_imp = sub.add_parser("import", help="torch .pth -> params export")
    _add_common(p_imp)
    p_imp.add_argument("--torch", required=True, help="torch .pth path")
    p_imp.add_argument("--out", required=True, help="params export dir")
    p_imp.add_argument("--what", default="full",
                       choices=["full", "backbone"])
    p_imp.set_defaults(fn=cmd_import)

    p_srv = sub.add_parser("serve", help="HTTP serving endpoint")
    _add_common(p_srv)
    p_srv.add_argument("--checkpoint", default="",
                       help="params export, Trainer checkpoint or .pth")
    p_srv.add_argument("--aot", default="",
                       help="serve an `export --aot` artifact instead of a "
                            "checkpoint")
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--port", type=int, default=8000)
    p_srv.set_defaults(fn=cmd_serve)

    p_bench = sub.add_parser("bench", help="run the benchmark")
    p_bench.add_argument("--mode", default="infer",
                         choices=["infer", "train", "e2e"])
    p_bench.add_argument("--set", dest="overrides", action="append",
                         default=[], metavar="KEY.PATH=VALUE",
                         help="config override (train/e2e modes)")
    _add_device(p_bench)
    p_bench.set_defaults(fn=cmd_bench)

    p_pack = sub.add_parser(
        "pack", help="decode the configured dataset once into a packed "
                     "shard cache (then: --set data.dataset=shards "
                     "data.root=<out>)")
    _add_common(p_pack)
    p_pack.add_argument("--out", required=True, help="output shard dir")
    p_pack.add_argument("--split", default="",
                        help="dataset split to pack (default: config's)")
    p_pack.add_argument("--shard-size", type=int, default=1024,
                        help="records per shard file")
    p_pack.set_defaults(fn=cmd_pack)

    args = parser.parse_args(argv)
    resolve_device(args.device)  # no GPU and no --device cpu: raise here
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
