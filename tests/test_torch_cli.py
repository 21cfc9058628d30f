"""The port's command line (``basi_tpu_torch/cli.py``) against the JAX
package's (``basi_tpu/cli.py``), on the CPU at the tiny size of
``tests/test_cli.py``.

Both read the same seeded weights: JAX variables (objectness bias 0,
perturbed BN statistics) as an orbax params export for the JAX CLI, and
as the reference-key ``.pth`` that the JAX CLI's ``export --torch``
writes for the port (``--device cpu``).

* ``infer``: the metrics agree within 1e-3 (timing keys aside), the
  budget of ``tests/test_torch_eval.py``.
* ``predict``: the same labeled PNGs at each image's original size, the
  same COCO results (images, masks) with scores within 1e-4.
* ``export --torch`` of JAX -> port ``import`` -> port ``export
  --torch``: every tensor bit for bit; ``export --out`` keeps f32 under
  the default bf16 ``infer.dtype`` and loads back.
* ``train`` then ``infer`` through the port's CLI; ``import --what
  backbone`` onto a fresh init; ``pack`` writes the JAX CLI's shards byte
  for byte.
* The reference's error cases: a bad override, an unknown preset, a
  missing path, predict without a checkpoint, a shape mismatch on import,
  an unknown backbone, and colliding stems.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import json

import numpy as np
import pytest
import torch
from PIL import Image

from basi_tpu import config as jax_config
from basi_tpu.cli import main as jax_main
from basi_tpu.utils.checkpoint import export_params as jax_export_params
from basi_tpu_torch.cli import main
from basi_tpu_torch.config import get_config
from basi_tpu_torch.data.coco import rle_decompress, rle_to_mask
from basi_tpu_torch.models.basi import create_model
from basi_tpu_torch.utils.checkpoint import load_params

from test_torch_model import jax_variables

SETS = [
    "model.backbone=resnet_tiny", "model.image_size=64", "model.grid_size=8",
    "model.fpn_channels=32", "model.mask_channels=32", "data.image_size=64",
    "data.dataset=synthetic", "data.batch_size=4", "data.synthetic_n=16",
    "data.max_instances=4", "infer.batch_size=4", "infer.dtype=float32",
    "parallel.num_devices=1",
]
TINY = [a for s in SETS for a in ("--set", s)]
CPU = ["--device", "cpu"]
TIMING = ("infer_ms_per_batch", "imgs_per_s")
IMAGE_HW = [(48, 64), (64, 64), (80, 56)]


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(orbax params export, the JAX CLI's ``export --torch`` of it)."""
    root = tmp_path_factory.mktemp("cli_weights")
    params, stats = jax_variables(jax_config.get_config("", SETS))
    jax_export_params(str(root / "orbax"), params, stats)
    assert jax_main(["export", *TINY, "--checkpoint", str(root / "orbax"),
                     "--torch", str(root / "ref.pth")]) == 0
    return root / "orbax", root / "ref.pth"


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_images")
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate(IMAGE_HW):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            d / f"photo{i}.png")
    # a COCO-style all-digit name
    Image.fromarray((rng.rand(40, 48, 3) * 255).astype(np.uint8)).save(
        d / "000000000042.png")
    return d


def test_infer_matches_jax_cli(weights, capsys):
    orbax, pth = weights
    assert jax_main(["infer", *TINY, "--checkpoint", str(orbax),
                     "--max-batches", "1"]) == 0
    want = _last_json(capsys)
    assert main(["infer", *TINY, *CPU, "--checkpoint", str(pth),
                 "--max-batches", "1"]) == 0
    got = _last_json(capsys)
    keys = set(want) - set(TIMING)
    assert keys <= set(got) and "AP@0.5" in keys and "saliency_mae" in keys
    for k in sorted(keys):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    assert got["num_images"] == want["num_images"] == 4


def test_predict_matches_jax_cli(weights, images, tmp_path, capsys):
    orbax, pth = weights
    outs = {}
    for name, run, ckpt, extra in (("jax", jax_main, orbax, []),
                                   ("port", main, pth, CPU)):
        out = tmp_path / name
        assert run(["predict", *TINY, *extra,
                    "--set", "infer.score_threshold=0.0",
                    "--images", str(images), "--out", str(out / "pngs"),
                    "--results", str(out / "results.json"),
                    "--checkpoint", str(ckpt)]) == 0
        summary = _last_json(capsys)
        outs[name] = (out, summary,
                      json.loads((out / "results.json").read_text()))
    (jdir, jsum, jres), (pdir, psum, pres) = outs["jax"], outs["port"]
    assert psum["images"] == jsum["images"] == 4
    for stem in ("photo0", "photo1", "photo2", "000000000042"):
        want = np.asarray(Image.open(jdir / "pngs" / f"{stem}.png"))
        got = np.asarray(Image.open(pdir / "pngs" / f"{stem}.png"))
        np.testing.assert_array_equal(got, want, err_msg=stem)
    assert [r["instances"] for r in psum["results"]] == \
        [r["instances"] for r in jsum["results"]]
    assert len(pres) == len(jres) > 0
    assert {e["image_id"] for e in pres} >= {42}
    for g, w in zip(pres, jres):
        assert g["image_id"] == w["image_id"]
        assert abs(g["score"] - w["score"]) <= 1e-4
        assert g["segmentation"]["size"] == w["segmentation"]["size"]
        h, wd = g["segmentation"]["size"]
        np.testing.assert_array_equal(
            rle_to_mask(rle_decompress(g["segmentation"]["counts"]), h, wd),
            rle_to_mask(rle_decompress(w["segmentation"]["counts"]), h, wd))
    for i, (h, w) in enumerate(IMAGE_HW):  # pasted back to original size
        assert Image.open(pdir / "pngs" / f"photo{i}.png").size == (w, h)


def test_torch_export_import_roundtrip_bitwise(weights, tmp_path, capsys):
    _, pth = weights
    assert main(["import", *TINY, *CPU, "--torch", str(pth),
                 "--out", str(tmp_path / "imported")]) == 0
    assert _last_json(capsys)["what"] == "full"
    assert main(["export", *TINY, *CPU, "--checkpoint",
                 str(tmp_path / "imported"),
                 "--torch", str(tmp_path / "back.pth")]) == 0
    want = torch.load(pth, weights_only=True)
    got = torch.load(tmp_path / "back.pth", weights_only=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_export_keeps_float32(weights, tmp_path, capsys):
    """No infer.dtype override: the bfloat16 default must not reach the
    export."""
    _, pth = weights
    args = [a for s in SETS if s != "infer.dtype=float32"
            for a in ("--set", s)]
    assert main(["export", *args, *CPU, "--checkpoint", str(pth),
                 "--out", str(tmp_path / "exported")]) == 0
    sd = load_params(str(tmp_path / "exported"))
    want = torch.load(pth, weights_only=True)
    assert all(v.dtype == torch.float32 for v in sd.values()
               if v.is_floating_point())
    assert all(torch.equal(sd[k], want[k]) for k in want)
    assert main(["infer", *args, *CPU, "--checkpoint",
                 str(tmp_path / "exported"), "--max-batches", "1"]) == 0


def test_train_then_infer(tmp_path, capsys):
    rc = main(["train", *TINY, *CPU,
               "--set", f"train.checkpoint_dir={tmp_path}/ckpt",
               "--set", "train.epochs=1",
               "--metrics", f"{tmp_path}/m.jsonl"])
    assert rc == 0
    final = _last_json(capsys)["final"]
    assert np.isfinite(final["loss"]) and final["step"] == 4
    lines = (tmp_path / "m.jsonl").read_text().strip().splitlines()
    assert any('"loss"' in line for line in lines)
    assert main(["infer", *TINY, *CPU, "--checkpoint", f"{tmp_path}/ckpt",
                 "--max-batches", "1"]) == 0
    metrics = _last_json(capsys)
    assert "AP@0.5" in metrics and metrics["num_images"] == 4


def test_import_backbone_onto_fresh_init(tmp_path, capsys):
    """``--what backbone``: a torchvision-style trunk lands in the
    backbone, the heads keep the fresh init."""
    cfg = get_config("", SETS)
    donor = create_model(cfg.model, "cpu", torch.Generator().manual_seed(7))
    trunk = {k[len("backbone."):]: v for k, v in donor.state_dict().items()
             if k.startswith("backbone.")}
    torch.save(trunk, tmp_path / "trunk.pth")
    assert main(["import", *TINY, *CPU, "--what", "backbone",
                 "--torch", str(tmp_path / "trunk.pth"),
                 "--out", str(tmp_path / "out")]) == 0
    sd = load_params(str(tmp_path / "out"))
    fresh = create_model(cfg.model, "cpu").state_dict()
    for k, v in sd.items():
        want = donor.state_dict()[k] if k.startswith("backbone.") \
            and "num_batches" not in k else fresh[k]
        assert torch.equal(v, want), k


# --- the reference's error cases -------------------------------------------


def test_bad_override():
    with pytest.raises(KeyError):
        main(["train", *CPU, "--set", "nope.nope=1"])


def test_unknown_preset():
    with pytest.raises(KeyError):
        main(["train", *CPU, "--preset", "definitely-not-a-preset"])


def test_predict_missing_path():
    with pytest.raises(FileNotFoundError):
        main(["predict", *TINY, *CPU, "--images", "/definitely/not/here",
              "--checkpoint", "/unused"])


def test_predict_requires_checkpoint(tmp_path):
    with pytest.raises(SystemExit):
        main(["predict", *TINY, *CPU, "--images", str(tmp_path)])


def test_import_shape_mismatch_fails(tmp_path):
    other = get_config("", SETS + ["model.grid_size=4",
                                   "model.mask_channels=16"])
    torch.save(create_model(other.model, "cpu").state_dict(),
               tmp_path / "ref.pth")
    with pytest.raises(ValueError, match="do not match the model"):
        main(["import", *TINY, *CPU, "--torch", str(tmp_path / "ref.pth"),
              "--out", str(tmp_path / "imported")])


def test_import_rejects_unknown_backbone(tmp_path):
    with pytest.raises(ValueError, match="full import unsupported"):
        main(["import", *TINY, *CPU, "--set", "model.backbone=densenet",
              "--torch", f"{tmp_path}/nonexistent.pth",
              "--out", f"{tmp_path}/imported"])
    with pytest.raises(NotImplementedError, match="vgg16"):
        main(["import", *TINY, *CPU, "--set", "model.backbone=vgg16",
              "--torch", f"{tmp_path}/nonexistent.pth",
              "--out", f"{tmp_path}/imported"])


def test_predict_dedupes_colliding_stems(weights, tmp_path, capsys):
    _, pth = weights
    rng = np.random.RandomState(1)
    d1, d2 = tmp_path / "a", tmp_path / "b"
    d1.mkdir()
    d2.mkdir()
    Image.fromarray((rng.rand(40, 48, 3) * 255).astype(np.uint8)).save(
        d1 / "photo.png")
    Image.fromarray((rng.rand(56, 40, 3) * 255).astype(np.uint8)).save(
        d2 / "photo.png")
    out_dir = tmp_path / "preds"
    assert main(["predict", *TINY, *CPU, "--set", "infer.score_threshold=0.0",
                 "--images", str(d1), str(d2), "--out", str(out_dir),
                 "--checkpoint", str(pth)]) == 0
    assert Image.open(out_dir / "photo.png").size == (48, 40)
    assert Image.open(out_dir / "photo_1.png").size == (40, 56)


def test_pack_matches_jax_cli(tmp_path):
    """``pack`` of the synthetic train split: the same shard files, byte
    for byte, as the JAX CLI's."""
    args = TINY + ["--set", "data.synthetic_n=8"]
    assert jax_main(["pack", *args, "--out", str(tmp_path / "jax"),
                     "--split", "train", "--shard-size", "3"]) == 0
    assert main(["pack", *args, *CPU, "--out", str(tmp_path / "port"),
                 "--split", "train", "--shard-size", "3"]) == 0
    want = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == want
    assert len(want) >= 3
    for name in want:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
