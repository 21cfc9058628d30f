"""The port's HTTP server (``basi_tpu_torch/server.py``) against the JAX
package's (``basi_tpu/server.py``), on the CPU at the tiny size.

Bytes in: ``PredictService.predict_image_bytes`` of both, on the same
seeded weights (an orbax export for JAX, the JAX variables for the port),
for PNGs of every mode PIL reads them as (``1``, ``L``, ``LA``, ``P``
with and without ``tRNS``, ``RGB``, ``RGBA``, ``I;16``), non-square, and
for the committed JPEG fixtures (4:2:0, 4:4:4, 4:2:2, grey, progressive,
RGB-coded and the photographs). The port decodes without PIL: its
``pil_rgb`` against Pillow 12.1's ``convert("RGB")`` on each mode, byte
for byte. Then the answers:
scores within 1e-4 in the same order, ``valid_hw``, ``orig_hw`` and the
model size equal, and the label maps equal except at pixels where a slot's
full-resolution probability lies within 1e-4 of ``mask_threshold`` (f32
sums of the two frameworks round apart by far less than that).

A deliberate divergence: a 4-component (CMYK) JPEG, which PIL converts
and the port's decoders refuse, is a 400 on the port.

Then the HTTP tests of ``tests/test_server.py`` on the port: healthz,
a round trip, 400 for a bad or empty body, 404, 503 for a closed
predictor, 504 for a timeout; 16 concurrent requests, all answered; and
the label map's overlap rule.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import base64
import io
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from basi_tpu.server import PredictService as JaxPredictService
from basi_tpu.utils.checkpoint import export_params as jax_export_params
from basi_tpu_torch.data import png as P
from basi_tpu_torch.data.datasets import letterbox_params
from basi_tpu_torch.data.letterbox import resize_bilinear_u8
from basi_tpu_torch.infer import Inferencer, to_numpy
from basi_tpu_torch.server import (
    PredictService,
    _serve_in_thread,
    decode_upload,
    pil_rgb,
)

from helpers import tiny_config
from test_torch_model import jax_variables

FIXTURES = Path(__file__).resolve().parent / "test_torch_fixtures"
JPEGS = json.loads((FIXTURES / "jpeg.json").read_text())
BAND = 1e-4  # scores, and the label maps' threshold band


def _png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _png_inputs() -> dict:
    """PNG bytes of every mode PIL reads, 48 x 64 and 80 x 56."""
    rng = np.random.RandomState(0)
    out = {}
    for h, w in ((48, 64), (80, 56)):
        yy, xx = np.mgrid[0:h, 0:w]
        rgb = np.stack([xx * 4, yy * 3, (xx * yy) % 256], -1) \
            + rng.randint(0, 40, (h, w, 3))
        rgb = rgb.clip(0, 255).astype(np.uint8)
        grey = rgb[..., 1]
        alpha = rng.randint(0, 256, (h, w)).astype(np.uint8)
        pal = Image.fromarray(rgb).quantize(colors=24)
        out[f"1_{h}"] = _png(Image.fromarray(grey > 128))
        out[f"L_{h}"] = _png(Image.fromarray(grey))
        out[f"LA_{h}"] = _png(Image.fromarray(np.stack([grey, alpha], -1),
                                              "LA"))
        out[f"P_{h}"] = _png(pal)
        out[f"P_trns_{h}"] = _png(pal, transparency=3)
        out[f"RGB_{h}"] = _png(Image.fromarray(rgb))
        out[f"RGBA_{h}"] = _png(Image.fromarray(
            np.concatenate([rgb, alpha[..., None]], -1), "RGBA"))
        wide = (grey.astype(np.uint16) * 3 + rng.randint(0, 200, (h, w))
                ).astype(np.uint16)
        out[f"I16_{h}"] = _png(Image.fromarray(wide))  # I;16
    return out


PNGS = _png_inputs()


def test_pil_rgb_is_pillows_convert():
    for name, data in PNGS.items():
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im.convert("RGB"))
            mode = im.mode
        img = P.decode_png(data)
        assert P.pil_view(img)[1] == mode, name
        np.testing.assert_array_equal(pil_rgb(img), want, err_msg=name)
        np.testing.assert_array_equal(decode_upload(data), want,
                                      err_msg=name)
    modes = {Image.open(io.BytesIO(d)).mode for d in PNGS.values()}
    assert modes == {"1", "L", "LA", "P", "RGB", "RGBA", "I;16"}


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    cfg = tiny_config(batch_size=2)
    params, stats = jax_variables(cfg)
    orbax = str(tmp_path_factory.mktemp("server_weights") / "orbax")
    jax_export_params(orbax, params, stats)
    jax_svc = JaxPredictService(cfg, checkpoint=orbax, predict_timeout=120)
    svc = PredictService(cfg, predict_timeout=120, device="cpu",
                         params=params, batch_stats=stats)
    inf = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    yield cfg, jax_svc, svc, inf
    jax_svc.close()
    svc.close()


def _label(out: dict) -> np.ndarray:
    data = base64.b64decode(out["label_png_b64"])
    arr, mode = P.pil_view(P.decode_png(data))
    assert mode == "L"
    return arr


def _probs(inf, data: bytes) -> np.ndarray:
    """The port's full-resolution slot probabilities of an upload."""
    img = decode_upload(data)
    size = inf.cfg.model.image_size
    vh, vw = letterbox_params(*img.shape[:2], size)
    batch = np.zeros((inf.cfg.infer.batch_size, size, size, 3), np.uint8)
    batch[0, :vh, :vw] = resize_bilinear_u8(img, vh, vw)
    masks, _, _ = inf.predict_batch(batch)
    return to_numpy(inf.full_res_masks(masks[:1]))[0][:, :vh, :vw]


INPUTS = {**{f"png_{k}": v for k, v in PNGS.items()},
          **{f"jpeg_{k}": (FIXTURES / fx["file"]).read_bytes()
             for k, fx in JPEGS.items()}}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_predict_image_bytes_matches_jax(services, name):
    cfg, jax_svc, svc, inf = services
    data = INPUTS[name]
    want = jax_svc.predict_image_bytes(data)
    got = svc.predict_image_bytes(data)
    for k in ("valid_hw", "orig_hw", "model_size"):
        assert got[k] == want[k], k
    assert len(got["scores"]) == len(want["scores"]) > 0
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=BAND)
    lab, lab_want = _label(got), _label(want)
    assert lab.shape == tuple(got["valid_hw"])
    apart = lab != lab_want
    if apart.any():
        near = (np.abs(_probs(inf, data) - cfg.infer.mask_threshold)
                <= BAND).any(axis=0)
        assert near[apart].all(), f"{int((apart & ~near).sum())} pixels"


def test_four_component_jpeg_is_400_on_the_port(services):
    """PIL converts a CMYK JPEG; the port's decoders refuse it (a
    deliberate divergence): ValueError, which the handler maps to 400."""
    _, jax_svc, svc, _ = services
    buf = io.BytesIO()
    Image.new("CMYK", (40, 30), (10, 200, 30, 0)).save(buf, "JPEG")
    assert jax_svc.predict_image_bytes(buf.getvalue())["orig_hw"] == [30, 40]
    with pytest.raises(ValueError, match="undecodable"):
        svc.predict_image_bytes(buf.getvalue())


# --- HTTP, as tests/test_server.py ------------------------------------------


@pytest.fixture(scope="module")
def server():
    base, httpd, service = _serve_in_thread(tiny_config(batch_size=2),
                                            device="cpu")
    yield base, service
    httpd.shutdown()
    service.close()


def _post(url, data, ctype="image/png"):
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_healthz(server):
    base, _ = server
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        payload = json.loads(r.read())
    assert r.status == 200
    assert payload["status"] == "ok"
    assert payload["model_size"] == 64 and payload["batch_size"] == 2


def test_predict_roundtrip(server, rng):
    base, _ = server
    img = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
    status, out = _post(base + "/predict", P.encode_png(img))
    assert status == 200
    assert out["orig_hw"] == [48, 64]
    assert out["model_size"] == 64
    vh, vw = out["valid_hw"]
    assert vw == 64 and 0 < vh <= 64
    lab = _label(out)
    assert lab.shape == (vh, vw) and lab.dtype == np.uint8
    scores = out["scores"]
    assert scores == sorted(scores, reverse=True)
    assert int(lab.max()) <= len(scores)


def test_predict_bad_body_is_400(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/predict", b"this is not an image")
    assert ei.value.code == 400
    assert "undecodable" in json.loads(ei.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/predict", P.encode_png(np.zeros((4, 4), np.uint8))[:30])
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/predict", b"")
    assert ei.value.code == 400


def test_unknown_route_is_404(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(base + "/nope", timeout=30)
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/nope", b"x")
    assert ei.value.code == 404


def test_concurrent_requests_all_answered(server, rng):
    base, _ = server
    imgs = [P.encode_png((rng.rand(40 + 4 * i, 64, 3) * 255).astype(np.uint8))
            for i in range(16)]
    codes = [None] * len(imgs)

    def ask(i):
        codes[i] = _post(base + "/predict", imgs[i])[0]

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert codes == [200] * 16


def test_closed_predictor_maps_to_503(rng):
    cfg = tiny_config(batch_size=2)
    base, httpd, service = _serve_in_thread(cfg, device="cpu")
    try:
        service.predictor.close()
        img = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/predict", P.encode_png(img))
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as ei2:
            urllib.request.urlopen(base + "/healthz", timeout=30)
        assert ei2.value.code == 503
    finally:
        httpd.shutdown()
        service.close()


def test_timeout_maps_to_504(rng):
    cfg = tiny_config(batch_size=2)
    base, httpd, service = _serve_in_thread(cfg, device="cpu",
                                            predict_timeout=1e-3)
    gate = threading.Event()
    run = service.predictor.inf.predict_batch

    def slow(batch):
        gate.wait(30)
        return run(batch)

    service.predictor.inf.predict_batch = slow
    try:
        img = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/predict", P.encode_png(img))
        assert ei.value.code == 504
    finally:
        gate.set()
        httpd.shutdown()
        service.close()


def test_label_map_prefers_higher_scores(services, monkeypatch):
    """Overlaps go to the higher-score instance (the reference's walk in
    descending score, the earlier instance painted last); slots below the
    score threshold are left out."""
    from basi_tpu_torch.serve import Prediction

    cfg, _, svc, _ = services
    k, q = cfg.model.num_slots, cfg.model.image_size // 4
    masks = np.full((k, q, q), 1e-3, np.float32)
    masks[0, :, :q // 2] = 0.999  # left half, score 0.3
    masks[1, :q // 2] = 0.999  # top half, score 0.9
    masks[2] = 0.999  # everything, below the score threshold
    scores = np.zeros(k, np.float32)
    scores[:3] = (0.3, 0.9, cfg.infer.score_threshold / 2)
    monkeypatch.setattr(svc.predictor, "predict",
                        lambda canvas, timeout=None: Prediction(masks, scores))
    out = svc.predict_image_bytes(PNGS["RGB_80"])
    assert out["scores"] == [0.9, 0.3]
    lab = _label(out)
    vh, vw = out["valid_hw"]
    s = cfg.model.image_size
    assert (lab[:s // 2 - 2] == 1).all()  # top: the 0.9 slot
    assert (lab[s // 2 + 2:, :s // 2 - 2] == 2).all()  # bottom left
    assert (lab[s // 2 + 2:, s // 2 + 2:vw] == 0).all()
