"""AOT serving artifacts of the port (``basi_tpu_torch/aot.py``): the cases
of ``tests/test_aot.py`` and ``tests/test_serve_aot.py``, on the CPU.

* The artifact's outputs equal the live ``Inferencer.predict_batch`` bit
  for bit (the same aten ops in the same order), in f32 and in bf16; the
  sidecar reads back without loading the program; a wrong shape or dtype
  and a bad magic are refused; ``batch_size`` overrides the batch.
* The bf16 program holds the model's nine integer-factor upsamples as the
  custom op ``basi::upsample_int`` (the kernel on the card, the plain
  version here), and exporting leaves the eager path as it was: the same
  outputs and launch counters after an export as before it.
* ``BatchedPredictor(aot_path=...)`` and the HTTP service over an
  artifact give the live path's answers; ``export --aot`` through the CLI.
* The connected mechanism is not ported: exporting it raises.

The JAX artifact needs jaxlib alone; the port's needs ``torch`` and
``basi_tpu_torch.kernels`` (its custom ops), a deliberate divergence.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import base64
import dataclasses
import json
import urllib.request

import numpy as np
import pytest
import torch

from basi_tpu_torch.aot import (
    export_serving,
    load_serving,
    read_meta,
    save_serving,
)
from basi_tpu_torch.cli import main
from basi_tpu_torch.data.png import decode_png, encode_png, pil_view
from basi_tpu_torch.infer import Inferencer, to_numpy
from basi_tpu_torch.kernels import upsample_int as U
from basi_tpu_torch.serve import BatchedPredictor
from basi_tpu_torch.server import PredictService, _serve_in_thread

from helpers import tiny_batch, tiny_config
from test_torch_model import jax_variables


def _cfg(batch_size: int, dtype: str = "float32"):
    cfg = tiny_config(batch_size=batch_size)
    return dataclasses.replace(
        cfg, infer=dataclasses.replace(cfg.infer, dtype=dtype))


@pytest.fixture(scope="module")
def weights():
    return jax_variables(tiny_config())


@pytest.fixture(scope="module")
def artifact(weights, tmp_path_factory):
    cfg = _cfg(4)
    path = str(tmp_path_factory.mktemp("aot") / "model.basiaot")
    params, stats = weights
    meta = save_serving(path, cfg, params=params, batch_stats=stats,
                        device="cpu")
    inf = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    return cfg, path, meta, inf


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_roundtrip_matches_live_inferencer(artifact, rng):
    _, path, _, inf = artifact
    model = load_serving(path, "cpu")
    images = tiny_batch(rng, n=4, size=64)["image"]
    _equal(model(images), inf.predict_batch(images))


def test_bf16_roundtrip_and_custom_op(weights, tmp_path, rng):
    """bf16: the nine upsamples are ``basi::upsample_int`` in the program,
    the outputs equal the live path's, and the export changed neither the
    eager outputs nor any launch counter."""
    cfg = _cfg(2, "bfloat16")
    params, stats = weights
    inf = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    images = tiny_batch(rng, n=2, size=64)["image"]
    before = inf.predict_batch(images)
    counts = (U.upsample_int.launches, U.upsample_int_backward.launches)
    path = str(tmp_path / "bf16.basiaot")
    save_serving(path, cfg, params=params, batch_stats=stats, device="cpu")
    assert (U.upsample_int.launches,
            U.upsample_int_backward.launches) == counts
    _equal(inf.predict_batch(images), before)
    model = load_serving(path, "cpu")
    ops = [n for n in model.program.graph.nodes
           if n.target is torch.ops.basi.upsample_int.default]
    assert len(ops) == 9
    _equal(model(images), before)


def test_meta_sidecar(artifact):
    cfg, path, meta, _ = artifact
    disk = read_meta(path)
    assert disk == meta
    assert disk["model_size"] == cfg.model.image_size
    assert disk["batch_size"] == 4
    assert disk["input"] == {"shape": [4, 64, 64, 3], "dtype": "uint8"}
    assert disk["instance_mechanism"] == "kernels"
    assert disk["platforms"] == ["cpu"]
    assert disk["infer_dtype"] == "float32"
    assert disk["torch_version"] == torch.__version__


def test_wrong_shape_rejected(artifact):
    _, path, _, _ = artifact
    model = load_serving(path, "cpu")
    with pytest.raises(ValueError):
        model(np.zeros((2, 64, 64, 3), np.uint8))  # wrong batch
    with pytest.raises(ValueError):
        model(np.zeros((4, 64, 64, 3), np.float32))  # wrong dtype


def test_bad_magic_rejected(tmp_path):
    p = tmp_path / "junk.basiaot"
    p.write_bytes(b"NOTANART" + b"\x00" * 64)
    with pytest.raises(ValueError, match="bad magic"):
        load_serving(str(p), "cpu")
    with pytest.raises(ValueError, match="bad magic"):
        read_meta(str(p))


def test_batch_size_override(weights, rng):
    import io

    cfg = _cfg(4)
    params, stats = weights
    blob, meta = export_serving(cfg, params=params, batch_stats=stats,
                                batch_size=2, device="cpu")
    assert meta["batch_size"] == 2 and meta["input"]["shape"][0] == 2
    program = torch.export.load(io.BytesIO(blob))
    images = torch.from_numpy(tiny_batch(rng, n=2, size=64)["image"])
    masks, scores, _ = program.module()(images)
    assert masks.shape[0] == 2
    assert scores.shape == (2, cfg.model.num_slots)


def test_connected_mechanism_refused():
    cfg = _cfg(2)
    ccfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model,
                                       instance_mechanism="connected"))
    with pytest.raises(NotImplementedError, match="connected"):
        export_serving(ccfg, device="cpu")


# --- serving over an artifact ------------------------------------------------


@pytest.fixture(scope="module")
def served(weights, tmp_path_factory):
    cfg = _cfg(2)
    path = str(tmp_path_factory.mktemp("aot_serve") / "m.basiaot")
    params, stats = weights
    save_serving(path, cfg, params=params, batch_stats=stats, device="cpu")
    inf = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    return cfg, path, inf


def test_predict_matches_live_path(served, rng):
    cfg, path, inf = served
    p = BatchedPredictor(cfg, max_wait_ms=1, aot_path=path, device="cpu")
    try:
        assert p.batch == 2 and p.size == 64
        img = tiny_batch(rng, n=1, size=64)["image"][0]
        pred = p.predict(img, timeout=60)
        batch = np.zeros((2, 64, 64, 3), np.uint8)
        batch[0] = img
        m_ref, s_ref, _ = (to_numpy(t) for t in inf.predict_batch(batch))
        np.testing.assert_array_equal(pred.scores, s_ref[0])
        np.testing.assert_array_equal(pred.masks, m_ref[0])
    finally:
        p.close()


def test_predict_many_and_full_res(served, rng):
    cfg, path, inf = served
    p = BatchedPredictor(cfg, max_wait_ms=1, aot_path=path, device="cpu")
    try:
        imgs = tiny_batch(rng, n=5, size=64)["image"][:5]
        preds = p.predict_many(imgs)
        assert len(preds) == 5
        full = to_numpy(p.inf.full_res_masks(preds[0].masks[None]))[0]
        assert full.shape == (cfg.model.num_slots, 64, 64)
        np.testing.assert_array_equal(
            full, to_numpy(inf.full_res_masks(preds[0].masks[None]))[0])
    finally:
        p.close()


def test_http_service_over_aot(served, rng):
    cfg, path, inf = served
    img = tiny_batch(rng, n=1, size=64)["image"][0]
    svc = PredictService(cfg, aot_path=path, predict_timeout=60,
                         device="cpu")
    try:
        assert svc.size == 64
        out = svc.predict_image_bytes(encode_png(img))
    finally:
        svc.close()
    live = PredictService(cfg, predict_timeout=60, device="cpu",
                          state_dict=inf.model.state_dict())
    try:
        assert live.predict_image_bytes(encode_png(img)) == out
    finally:
        live.close()
    base, httpd, service = _serve_in_thread(cfg, aot_path=path, device="cpu")
    try:
        req = urllib.request.Request(base + "/predict", data=encode_png(img),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            got = json.loads(r.read())
        assert got == out
        lab, _ = pil_view(decode_png(base64.b64decode(got["label_png_b64"])))
        assert lab.shape == tuple(got["valid_hw"])
    finally:
        httpd.shutdown()
        service.close()


def test_cli_export_aot(weights, tmp_path, capsys, rng):
    from basi_tpu_torch.utils.checkpoint import export_params

    cfg = _cfg(2)
    params, stats = weights
    inf = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    export_params(str(tmp_path / "params"), inf.model.state_dict())
    sets = ["model.backbone=resnet_tiny", "model.image_size=64",
            "model.grid_size=8", "model.fpn_channels=32",
            "model.mask_channels=32", "model.num_slots=8",
            "data.image_size=64", "infer.dtype=float32",
            "infer.pre_nms_top_k=16", "infer.batch_size=4"]
    args = [a for s in sets for a in ("--set", s)]
    with pytest.raises(SystemExit, match="requires --checkpoint"):
        main(["export", *args, "--device", "cpu", "--checkpoint", "",
              "--aot", str(tmp_path / "x.basiaot")])
    assert main(["export", *args, "--device", "cpu",
                 "--checkpoint", str(tmp_path / "params"),
                 "--aot", str(tmp_path / "m.basiaot"), "--aot-batch", "2",
                 "--platforms", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["batch_size"] == 2 and out["platforms"] == ["cpu"]
    images = tiny_batch(rng, n=2, size=64)["image"]
    _equal(load_serving(str(tmp_path / "m.basiaot"), "cpu")(images),
           inf.predict_batch(images))
