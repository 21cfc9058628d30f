"""The port stands alone: its own copies of the JAX package's jax-free
modules give what the originals give, it imports nothing of JAX, and its
entry points run on the card unless asked for the CPU.

* ``basi_tpu_torch.config``: ``dataclasses.asdict`` of every preset, with
  and without overrides, equal to ``basi_tpu.config``'s.
* ``basi_tpu_torch.convert``: ``export_basinet`` and ``import_basinet``
  give the same keys and bitwise-equal arrays as the JAX package's, on the
  tiny model's JAX variables and on ResNet-50 shapes; what the port has no
  model for (VGG trunks, the roi head, the refinement module) is refused.
* ``basi_tpu_torch.data.datasets``: the same samples for the same seed and
  index, and the same batches in the same order from ``iter_epoch``.
* An AST scan: no module of the port and not ``chip_smoke.py`` imports
  ``basi_tpu``, ``jax``, ``flax`` or ``PIL``.
"""

import ast
import dataclasses
import os
import pathlib

import numpy as np
import pytest
import torch

from basi_tpu import config as jax_config
from basi_tpu.convert.full_import import import_basinet as jax_import_basinet
from basi_tpu.convert.torch_export import export_basinet as jax_export_basinet
from basi_tpu.data import datasets as jax_datasets
from basi_tpu.data import shards as jax_shards
from basi_tpu_torch import config as C
from basi_tpu_torch import convert
from basi_tpu_torch.data import datasets as D
from basi_tpu_torch import benchmark, cli
from basi_tpu_torch.aot import load_serving
from basi_tpu_torch.data.pipeline import DeviceFeed
from basi_tpu_torch.infer import Inferencer
from basi_tpu_torch.models.basi import create_model
from basi_tpu_torch.serve import BatchedPredictor
from basi_tpu_torch.server import make_server
from basi_tpu_torch.train.loop import Trainer

from helpers import tiny_config
from test_torch_model import jax_variables

ROOT = pathlib.Path(__file__).resolve().parents[1]

# --- config -------------------------------------------------------------------

OVERRIDES = [
    [],
    ["model.bn_impl=fused", "data.batch_size=4", "train.lr=0.05"],
    ["data.color_jitter=0.2,0.2,0.2", "model.refine=true",
     "infer.tta_scales=0.75,1.25", "data.synthetic_orig_scale=1.0"],
]


@pytest.mark.parametrize("overrides", OVERRIDES)
@pytest.mark.parametrize("preset", ["", *jax_config.PRESETS])
def test_config_matches_jax(preset, overrides):
    assert set(C.PRESETS) == set(jax_config.PRESETS)
    got = C.get_config(preset, overrides)
    want = jax_config.get_config(preset, overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got).__name__ == type(want).__name__


def test_config_rejects_what_jax_rejects():
    for mod in (C, jax_config):
        with pytest.raises(ValueError, match="image_size"):
            mod.get_config("", ["model.image_size=64"])
        with pytest.raises(KeyError):
            mod.get_config("", ["model.nope=1"])
        with pytest.raises(ValueError, match="key.path=value"):
            mod.apply_overrides(mod.Config(), ["model.bn_impl"])


# --- weight mappings ------------------------------------------------------------

def assert_trees_bitwise(got, want, path=""):
    """Same structure (dicts, or the (params, batch_stats) pair), same
    dtypes and shapes, equal values."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_bitwise(g, w, f"{path}[{i}]")
        return
    assert isinstance(got, dict) == isinstance(want, dict), path
    if not isinstance(want, dict):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
        return
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        assert_trees_bitwise(got[k], want[k], f"{path}/{k}")


def test_export_and_import_match_jax_tiny():
    cfg = tiny_config()
    params, stats = jax_variables(cfg)
    kw = dict(stage_sizes=(1, 1, 1, 1), backbone="resnet_tiny")
    got = convert.export_basinet(params, stats, **kw)
    want = jax_export_basinet(params, stats, **kw)
    assert_trees_bitwise(got, want)
    assert_trees_bitwise(convert.import_basinet(got, **kw),
                         jax_import_basinet(want, **kw))
    assert_trees_bitwise(convert.import_basinet(got, **kw), (params, stats))


def test_export_and_import_match_jax_resnet50():
    """ResNet-50 and the default heads: a seeded torch state dict through
    both importers, then both trees back through both exporters."""
    cfg = C.get_config("bench_accuracy")
    model = create_model(cfg.model, "cpu", torch.Generator().manual_seed(1))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    kw = dict(stage_sizes=(3, 4, 6, 3), backbone="resnet50")
    params, stats = convert.import_basinet(sd, **kw)
    assert_trees_bitwise((params, stats), jax_import_basinet(sd, **kw))
    back = convert.export_basinet(params, stats, **kw)
    assert_trees_bitwise(back, jax_export_basinet(params, stats, **kw))
    assert_trees_bitwise(back, sd)


def _refine_subtree(rng):
    """A refinement module's entries (conv, norm and out), as the JAX
    package's BASINet holds them with ``model.refine``."""
    return {
        "in": {"kernel": rng.randn(3, 3, 1, 8).astype(np.float32),
               "bias": rng.randn(8).astype(np.float32)},
        "gn_in": {"scale": rng.rand(8).astype(np.float32),
                  "bias": rng.randn(8).astype(np.float32)},
        "out": {"kernel": rng.randn(3, 3, 8, 1).astype(np.float32),
                "bias": rng.randn(1).astype(np.float32)}}


@pytest.mark.parametrize("what", ["vgg", "roi", "refine"])
def test_unported_checkpoints_refused(what):
    params, stats = jax_variables(tiny_config())
    kw = dict(stage_sizes=(1, 1, 1, 1), backbone="resnet_tiny")
    if what == "vgg":
        with pytest.raises(NotImplementedError, match="not yet ported"):
            convert.export_basinet(params, stats, backbone="vgg16")
        with pytest.raises(NotImplementedError, match="not yet ported"):
            convert.import_basinet({}, backbone="vgg16")
    elif what == "roi":
        roi = {k: v for k, v in params.items() if k != "instance"}
        with pytest.raises(ValueError, match="instance"):
            convert.export_basinet(roi, stats)
    else:
        with_refine = dict(params, refine=_refine_subtree(
            np.random.RandomState(3)))
        with pytest.raises(NotImplementedError, match="not yet ported"):
            convert.export_basinet(with_refine, stats, **kw)
        sd = jax_export_basinet(with_refine, stats, **kw)
        assert any(k.startswith("refine.") for k in sd)
        with pytest.raises(NotImplementedError, match="not yet ported"):
            convert.import_basinet(sd, **kw)


# --- datasets -------------------------------------------------------------------

def _assert_samples_equal(a, b):
    for f in ("image", "masks", "valid", "orig_hw", "valid_hw"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.name == b.name


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1.0), (0, 1.5)])
def test_synthetic_samples_match_jax(seed, scale):
    """Square scenes and letterboxed non-square ones (the port's numpy
    letterbox against JAX's PIL), at 64 and at ``bench_accuracy``'s 512
    with its 8 instance slots."""
    for size, n, m in ((64, 6, 4), (512, 3, 8)):
        kw = dict(n=n, image_size=size, max_instances=m, seed=seed,
                  orig_max_scale=scale)
        got = D.SyntheticDataset(**kw)
        want = jax_datasets.SyntheticDataset(**kw)
        assert len(got) == len(want)
        for i in range(len(want)):
            _assert_samples_equal(got.get(i), want.get(i))
            for x, y in zip(got.get_orig_masks(i), want.get_orig_masks(i)):
                np.testing.assert_array_equal(x, y)
    for hw in ((480, 640), (767, 383), (1, 1000)):
        assert D.letterbox_params(*hw, 512) == jax_datasets.letterbox_params(
            *hw, 512)


@pytest.mark.parametrize("split", ["train", "val"])
def test_make_dataset_and_iter_epoch_match_jax(split):
    """The same batch order and contents: shuffled, skipping a batch, with a
    padded tail, and a subset of rows."""
    cfg = C.get_config("", ["data.synthetic_n=48", "data.image_size=32",
                            "model.image_size=32", "data.max_instances=3"])
    got = D.make_dataset(cfg.data, split=split)
    want = jax_datasets.make_dataset(cfg.data, split=split)
    assert (len(got), got.seed) == (len(want), want.seed)
    for kw in (dict(batch_size=4, shuffle=True, seed=5),
               dict(batch_size=4, shuffle=True, seed=6, skip=1),
               dict(batch_size=5, shuffle=False, seed=0, drop_last=False),
               dict(batch_size=4, shuffle=True, seed=7,
                    rows=np.array([1, 3]))):
        a = list(D.iter_epoch(got, **kw))
        b = list(jax_datasets.iter_epoch(want, **kw))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert set(x) == set(y)
            for k in y:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_on_disk_datasets_not_ported(tmp_path):
    """Every on-disk dataset builds from its files: the ILSO/SOC folders
    and COCO (each sample equal to the JAX package's), and shards (JAX's
    packing)."""
    import test_coco
    from basi_tpu.data.coco import CocoDataset as JaxCoco
    from test_torch_files import make_folder

    root = make_folder(str(tmp_path / "folder"), n=4, split="val")
    coco = str(tmp_path / "coco")
    os.makedirs(coco)
    test_coco._write_coco_tree(coco)
    for name, where in (("ilso", root), ("soc", root), ("folder", root),
                        ("coco", coco)):
        cfg = C.get_config("", [f"data.dataset={name}", f"data.root={where}",
                                "data.image_size=32", "model.image_size=32",
                                "data.max_instances=3"])
        ds = D.make_dataset(cfg.data, split="val")
        if name == "coco":
            want = JaxCoco(coco, image_size=32, max_instances=3, split="val",
                           decode_backend="native")
        else:
            want = jax_datasets.FolderDataset(root, image_size=32,
                                              max_instances=3, split="val",
                                              decode_backend="native")
        assert len(ds) == len(want) > 0
        _assert_samples_equal(ds.get(1), want.get(1))
    src = jax_datasets.SyntheticDataset(n=4, image_size=32, max_instances=3)
    jax_shards.pack_dataset(src, str(tmp_path / "train"), log=None)
    cfg = C.get_config("", ["data.dataset=shards", f"data.root={tmp_path}",
                            "data.image_size=32", "model.image_size=32",
                            "data.max_instances=3"])
    ds = D.make_dataset(cfg.data, split="train")
    assert type(ds).__name__ == "ShardDataset" and len(ds) == 4
    _assert_samples_equal(ds.get(2), src.get(2))
    with pytest.raises(ValueError):
        D.make_dataset(C.get_config("", ["data.dataset=nope"]).data)


# --- no JAX in the port -----------------------------------------------------------

# the card's machine has no PIL either
FORBIDDEN = ("basi_tpu", "jax", "flax", "PIL")


def _imports(path: pathlib.Path) -> list[str]:
    """Every module an import statement of ``path`` names, at any depth."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_sources_import_no_jax():
    files = sorted((ROOT / "basi_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for part in ("evals/__init__.py", "evals/ap.py", "evals/saliency.py",
                 "data/native_gt.py", "ops/paste.py", "data/letterbox.py",
                 "data/shards.py", "utils/logging.py", "utils/checkpoint.py",
                 "tools/bench_accuracy.py", "data/png.py", "data/native.py",
                 "data/coco.py", "data/clib.py",
                 "utils/profiling.py", "cli.py", "server.py",
                 "benchmark.py", "aot.py", "data/pipeline.py",
                 "utils/tools.py"):
        assert ROOT / "basi_tpu_torch" / part in files, part
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_csrc_sources_are_package_data():
    """Every file under ``basi_tpu_torch/csrc/`` matches a package-data
    glob of ``basi_tpu_torch``: an installed port builds its kernels and
    its PNG and JPEG libraries from them on first use."""
    import fnmatch
    import tomllib

    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    globs = data["basi_tpu_torch"]
    files = sorted(p.relative_to(ROOT / "basi_tpu_torch").as_posix()
                   for p in (ROOT / "basi_tpu_torch" / "csrc").rglob("*")
                   if p.is_file())
    assert any(f.endswith(".cc") for f in files)
    assert any(f.endswith(".cu") for f in files)
    missed = [f for f in files
              if not any(fnmatch.fnmatch(f, g) for g in globs)]
    assert not missed, missed


def test_import_scan_sees_nested_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("def f():\n    from basi_tpu.config import get_config\n"
                   "    import jax.numpy as jnp\n")
    assert [m.split(".")[0] for m in _imports(src)] == ["basi_tpu", "jax"]


# --- the card by default ----------------------------------------------------------

ENTRY_POINTS = {
    "create_model": lambda cfg: create_model(cfg.model),
    "Inferencer": lambda cfg: Inferencer(cfg),
    "BatchedPredictor": lambda cfg: BatchedPredictor(cfg).close(),
    "Trainer": lambda cfg: Trainer(cfg),
    "DeviceFeed": lambda cfg: DeviceFeed(D.SyntheticDataset(n=4), 2),
    "make_server": lambda cfg: make_server(cfg, port=0),
    "load_serving": lambda cfg: load_serving("no-such.basiaot"),
    "bench infer": lambda cfg: benchmark._bench_infer(iters=1),
    "cli infer": lambda cfg: cli.main(["infer"]),
    "cli serve": lambda cfg: cli.main(["serve", "--port", "0"]),
    "cli pack": lambda cfg: cli.main(["pack", "--out", "no-such-dir"]),
    "cli bench": lambda cfg: cli.main(["bench", "--mode", "train"]),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry):
    """Without a CUDA device, a call that names no device raises: it never
    runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    cfg = tiny_config(batch_size=2)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, synthetic_n=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry](cfg)
