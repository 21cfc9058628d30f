"""HTTP serving endpoint (stdlib only) over ``BatchedPredictor`` (port of
``basi_tpu/server.py``).

One thread per connection (``ThreadingHTTPServer``); cross-request
batching is the predictor's worker's:

  POST /predict   body = JPEG/PNG bytes -> JSON:
                  {"scores": [...], "label_png_b64": ..., "valid_hw":
                   [vh, vw], "orig_hw": [oh, ow], "model_size": S}
                  The label PNG is a (vh, vw) uint8 map at MODEL
                  resolution (0 = background, k = instance k, by
                  descending score); clients scale it to orig_hw.
  GET  /healthz   {"status": "ok", ...} | 503 when the predictor died

Failure mapping: an undecodable or empty body -> 400, an unknown route ->
404, a closed or dead predictor -> 503, a timeout -> 504.

The port has no PIL. An upload decodes as the reference's
``Image.open(...).convert("RGB")`` does: PNG through ``data/png.py``, with
PIL's conversion of each mode to RGB (``pil_rgb``); JPEG through
``data/native.py`` (libjpeg, or nvJPEG on the card). The letterbox resize
is ``data/letterbox.py``'s copy of Pillow's bilinear, byte for byte. A
file PIL reads and the port does not (a 4-component JPEG, any other
format) is a 400.
"""

from __future__ import annotations

import base64
import contextlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from basi_tpu_torch.config import Config
from basi_tpu_torch.data import native, png
from basi_tpu_torch.data.datasets import letterbox_params
from basi_tpu_torch.data.letterbox import resize_bilinear_u8
from basi_tpu_torch.device import DEFAULT_DEVICE
from basi_tpu_torch.infer import to_numpy
from basi_tpu_torch.serve import BatchedPredictor


def pil_rgb(img: png.PngImage) -> np.ndarray:
    """(H, W, 3) uint8: what PIL's ``Image.open(...).convert("RGB")``
    gives for the PNG, per the mode PIL reads it as (``png.pil_view``):
    ``1`` to 0/255, ``L``/``LA`` grey repeated (alpha dropped), ``P``
    through the palette (indices past it black, ``tRNS`` ignored),
    ``RGBA`` alpha dropped, ``I;16`` clipped to 255."""
    arr, mode = png.pil_view(img)
    if mode == "P":
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(img.palette)] = img.palette[:256]
        return pal[arr]
    if mode == "1":
        grey = arr.astype(np.uint8) * np.uint8(255)
    elif mode == "I;16":
        grey = np.minimum(arr, 255).astype(np.uint8)
    elif mode in ("L", "LA"):
        grey = arr if mode == "L" else arr[..., 0]
    else:  # RGB, RGBA
        return np.ascontiguousarray(arr[..., :3])
    return np.repeat(grey[..., None], 3, axis=2)


def label_map(full: np.ndarray, scores: np.ndarray, score_threshold: float,
              mask_threshold: float) -> tuple[np.ndarray, np.ndarray]:
    """(uint8 label map, the kept slots by descending score) of
    full-resolution slot probabilities (K, S, S): slot ``order[r]`` is
    label r + 1 where its probability passes ``mask_threshold``; the
    walk is in descending score, so earlier (higher-score) instances win
    overlaps."""
    order = np.argsort(-scores)
    order = order[scores[order] >= score_threshold]
    lab = np.zeros(full.shape[1:], np.uint8)
    for rank in range(len(order) - 1, -1, -1):
        lab[full[order[rank]] > mask_threshold] = rank + 1
    return lab, order


def decode_upload(data: bytes) -> np.ndarray:
    """JPEG or PNG bytes -> (H, W, 3) uint8 RGB; ValueError otherwise."""
    try:
        if data[:2] == b"\xff\xd8":
            return native.decode_jpeg(data)
        if data[:8] == png.SIGNATURE:
            return pil_rgb(png.decode_png(data))
    except Exception as e:  # any failure of a decoder on outside bytes
        raise ValueError(f"undecodable image: {e}") from e
    raise ValueError("undecodable image: neither JPEG nor PNG")


class PredictService:
    """Decode -> letterbox -> batched predict -> full-res label map."""

    def __init__(self, cfg: Config, checkpoint: str = "",
                 predict_timeout: float = 30.0, aot_path: str = "", *,
                 device=DEFAULT_DEVICE, params=None, batch_stats=None,
                 state_dict=None):
        """Weights as for ``BatchedPredictor``; runs on ``device`` (the
        card unless another is named)."""
        self.cfg = cfg
        self.predictor = BatchedPredictor(
            cfg, checkpoint=checkpoint, aot_path=aot_path, device=device,
            params=params, batch_stats=batch_stats, state_dict=state_dict)
        # an artifact carries its own model size and thresholds
        self.size = self.predictor.size
        self.predict_timeout = predict_timeout
        meta = getattr(self.predictor.inf, "meta", None)
        self.score_threshold = (float(meta["score_threshold"]) if meta
                                else cfg.infer.score_threshold)
        self.mask_threshold = (float(meta["mask_threshold"]) if meta
                               else cfg.infer.mask_threshold)

    def close(self):
        self.predictor.close()

    @property
    def alive(self) -> bool:
        return (self.predictor._worker.is_alive()
                and not self.predictor._stop.is_set())

    def _on_device(self):
        """CUDA work of a handler thread runs on the predictor's card (a
        new thread's current device is device 0)."""
        dev = self.predictor.inf.device
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def predict_image_bytes(self, data: bytes) -> dict:
        with self._on_device():
            return self._predict(data)

    def _predict(self, data: bytes) -> dict:
        img = decode_upload(data)
        oh, ow = img.shape[:2]
        vh, vw = letterbox_params(oh, ow, self.size)
        canvas = np.zeros((self.size, self.size, 3), np.uint8)
        canvas[:vh, :vw] = resize_bilinear_u8(img, vh, vw)
        pred = self.predictor.predict(canvas, timeout=self.predict_timeout)

        # Slot-mask probs (K, S/4, S/4), back in the program's dtype (bf16
        # widens to f32 exactly) -> full resolution through the fused
        # kernel eval uses; label map = best instance above threshold.
        inf = self.predictor.inf
        probs = torch.from_numpy(pred.masks[None]).to(inf.device, inf.dtype)
        full = to_numpy(inf.full_res_masks(probs))[0]
        scores = np.asarray(pred.scores, np.float32)
        lab, order = label_map(full, scores, self.score_threshold,
                               self.mask_threshold)
        return {
            "scores": [round(float(scores[i]), 4) for i in order],
            "label_png_b64": base64.b64encode(
                png.encode_png(lab[:vh, :vw])).decode(),
            "valid_hw": [vh, vw],
            "orig_hw": [oh, ow],
            "model_size": self.size,
        }


class _Handler(BaseHTTPRequestHandler):
    service: PredictService  # injected via make_server's subclass

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send_json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.split("?")[0] == "/healthz":
            if self.service.alive:
                self._send_json(200, {
                    "status": "ok",
                    "batch_size": self.service.predictor.batch,
                    "model_size": self.service.size,
                })
            else:
                self._send_json(503, {"status": "predictor dead"})
            return
        self._send_json(404, {"error": f"no route {self.path!r}"})

    def do_POST(self):
        if self.path.split("?")[0] != "/predict":
            self._send_json(404, {"error": f"no route {self.path!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = 0
        if length <= 0:
            self._send_json(400, {"error": "empty body"})
            return
        data = self.rfile.read(length)
        try:
            result = self.service.predict_image_bytes(data)
        except ValueError as e:
            self._send_json(400, {"error": str(e)})
            return
        except TimeoutError as e:
            self._send_json(504, {"error": str(e)})
            return
        except RuntimeError as e:  # predictor closed / worker died
            self._send_json(503, {"error": str(e)})
            return
        self._send_json(200, result)


def make_server(cfg: Config, checkpoint: str = "",
                host: str = "127.0.0.1", port: int = 8000,
                predict_timeout: float = 30.0, aot_path: str = "", *,
                device=DEFAULT_DEVICE, **weights):
    """Build (httpd, service). The caller runs ``httpd.serve_forever()``
    and on shutdown calls ``httpd.shutdown(); service.close()``.
    ``port=0`` binds an ephemeral port (read it from
    ``httpd.server_address``). ``aot_path`` serves an ``export --aot``
    artifact instead of a checkpoint; ``weights`` (``params`` and
    ``batch_stats``, or ``state_dict``) as for ``BatchedPredictor``."""
    service = PredictService(cfg, checkpoint=checkpoint,
                             predict_timeout=predict_timeout,
                             aot_path=aot_path, device=device, **weights)
    handler = type("BoundHandler", (_Handler,), {"service": service})
    try:
        httpd = ThreadingHTTPServer((host, port), handler)
    except BaseException:
        service.close()
        raise
    return httpd, service


def serve_forever(cfg: Config, checkpoint: str = "",
                  host: str = "127.0.0.1", port: int = 8000,
                  aot_path: str = "", device=DEFAULT_DEVICE) -> int:
    httpd, service = make_server(cfg, checkpoint, host, port,
                                 aot_path=aot_path, device=device)
    print(json.dumps({"serving": f"http://{host}:{httpd.server_address[1]}",
                      "endpoints": ["/predict", "/healthz"]}), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()
    return 0


def _serve_in_thread(cfg: Config, checkpoint: str = "",
                     host: str = "127.0.0.1", port: int = 0, **kwargs):
    """Server on an ephemeral port in a daemon thread (tests, smoke runs).
    Returns (base_url, httpd, service); ``kwargs`` go to
    ``make_server``."""
    httpd, service = make_server(cfg, checkpoint, host, port, **kwargs)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return (f"http://{host}:{httpd.server_address[1]}", httpd, service)
