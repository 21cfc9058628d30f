"""The roi mechanism's model and serving against the JAX package's, on the
CPU at ``tests/test_roi.py``'s tiny configuration (``roi_resolution=8``,
``roi_top_k=16``, 64^2; the tiny trunk, FPN 32, grid 8, 8 slots).

The JAX roi model's init variables (``roi_variables``: objectness bias 0,
the score and ROI mask prediction convs drawn 10 and 300 times wider, so
that objectness and mask probabilities spread away from their ties, and
perturbed BN statistics) load into the port through its own weight
mapping. Tolerances, each stated again where it is asserted:

* the forward, f32: decoded and proposed boxes within 1e-6, in the same
  order (each image's 16th and 17th objectness lie further apart than
  1e-4 on this batch); every other output within 1e-3;
* ``Inferencer.predict_batch``/``full_res_masks``/``evaluate``, f32: the
  same slots in the same order, scores and masks within 1e-3, metrics
  within 1e-3. Boxes agree to an ulp, not bit for bit (XLA's softplus
  rounds otherwise), so a canvas pixel whose centre lies within 1e-5 of a
  box edge may be inside on one side only: such pixels are left out of
  the mask comparison, and there are few of them;
* bf16 (``infer.dtype=bfloat16``): the model's outputs within
  ``test_torch_model``'s bf16 bound (4% of the largest magnitude at most,
  2% on average), the ROI mask head's at JAX's own proposals (bf16
  objectness ties at the top-k boundary fall apart between the two
  frameworks, so the proposal sets may differ); the port's selection on
  JAX's own bf16 outputs gives JAX's slots (filled alike, scores within
  1e-2, masks within one bf16 ulp near 1);
* ``BatchedPredictor`` and the AOT artifact equal ``predict_batch`` bit
  for bit; the command line's ``infer`` and ``predict`` run the mechanism
  and give JAX's CLI metrics within 1e-3.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basi_tpu.config import get_config as jax_get_config
from basi_tpu.infer import Inferencer as JaxInferencer
from basi_tpu.models.basi import create_model as jax_create_model
from basi_tpu.models.basi import init_model
from basi_tpu.train import targets as jax_targets
from basi_tpu_torch.aot import load_serving, save_serving
from basi_tpu_torch.convert import load_jax_variables, to_jax_variables
from basi_tpu_torch.infer import Inferencer
from basi_tpu_torch.models.basi import BASIOutputs, create_model

from helpers import tiny_batch, tiny_config
from test_torch_slice import assert_slots_match

TOL = 1e-3
BATCH = 4
EDGE = 1e-5
ROI = dict(instance_mechanism="roi", roi_resolution=8, roi_top_k=16)


def roi_config(batch_size: int = BATCH, **infer):
    cfg = tiny_config(batch_size=batch_size)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **ROI),
        infer=dataclasses.replace(cfg.infer, **infer))


def roi_variables(cfg, seed: int = 0, spread: bool = True):
    """The JAX roi model's init variables as numpy trees, BN running
    statistics drawn from a numpy seed; with ``spread``, objectness bias 0
    and its kernel 10 times wider, the ROI mask head's ``out`` kernel 300
    times wider (logits of a few units: probabilities away from the 0.5
    threshold)."""
    params, stats = init_model(jax_create_model(cfg.model),
                               cfg.model.image_size)
    params = jax.tree.map(np.array, params)
    stats = jax.tree.map(np.array, stats)
    if spread:
        params["roi_box"]["score"]["bias"][...] = 0.0
        params["roi_box"]["score"]["kernel"] *= 10.0
        params["roi_mask"]["out"]["kernel"] *= 300.0
    rng = np.random.RandomState(seed)

    def perturb(tree):
        for v in tree.values():
            if "mean" in v:
                v["mean"][...] = rng.randn(*v["mean"].shape) * 0.1
                v["var"][...] = rng.rand(*v["var"].shape) + 0.5
            else:
                perturb(v)

    perturb(stats)
    return params, stats


def edge_pixels(boxes: np.ndarray, hw, eps: float = EDGE) -> np.ndarray:
    """(N, h, w) True at the canvas pixels whose row or column centre lies
    within ``eps`` of an edge of one of the image's boxes (N, K, 4): where
    the paste's inside test may differ between two sides whose boxes part
    by less than ``eps``."""
    h, w = hw
    py = (np.arange(h) + 0.5) / h
    px = (np.arange(w) + 0.5) / w
    rows = (np.abs(py[None, None] - boxes[..., 0:1]) <= eps) | (
        np.abs(py[None, None] - boxes[..., 2:3]) <= eps)
    cols = (np.abs(px[None, None] - boxes[..., 1:2]) <= eps) | (
        np.abs(px[None, None] - boxes[..., 3:4]) <= eps)
    return rows.any(1)[:, :, None] | cols.any(1)[:, None, :]


def _images(n: int = BATCH, seed: int = 2) -> np.ndarray:
    return (np.random.RandomState(seed).rand(n, 64, 64, 3) * 255).astype(
        np.uint8)


def _normalized(cfg, images):
    x = images.astype(np.float32) / 255.0
    return (x - np.asarray(cfg.data.mean, np.float32)) / np.asarray(
        cfg.data.std, np.float32)


@pytest.fixture(scope="module")
def variables():
    """``roi_variables`` of the tiny roi model, built once for the file
    (the tests that read them do not write them)."""
    return roi_variables(roi_config())


@pytest.fixture(scope="module")
def case(variables):
    cfg = roi_config()
    params, stats = variables
    images = _images()
    jinf = JaxInferencer(cfg, params=params, batch_stats=stats)
    masks, scores, sal = jinf.predict_batch(images)
    want = {"masks": np.asarray(masks, np.float32),
            "scores": np.asarray(scores, np.float32),
            "sal": np.asarray(sal, np.float32),
            "full": np.asarray(jinf.full_res_masks(masks), np.float32)}
    out = jax_create_model(cfg.model).apply(
        {"params": params, "batch_stats": stats},
        jnp.asarray(_normalized(cfg, images)))
    return cfg, params, stats, images, want, out


OUTPUTS = ("saliency_logits", "cell_scores", "mask_feats", "cell_boxes",
           "roi_boxes", "roi_scores", "roi_mask_logits")


def test_roi_forward_matches_jax(case):
    """Boxes within 1e-6 and the proposals in JAX's order, every other
    output within 1e-3; no kernels head, no candidates."""
    cfg, params, stats, images, _, want = case
    model = create_model(cfg.model, "cpu")
    assert not hasattr(model, "instance")
    load_jax_variables(model, params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(_normalized(cfg, images)))
    assert got.cell_kernels is None and got.mask_logits is None
    ranked = -np.sort(-np.asarray(want.cell_scores).reshape(BATCH, -1), 1)
    assert (ranked[:, 15] - ranked[:, 16]).min() > 1e-4  # no top-k near-tie
    for k in OUTPUTS:
        g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert g.shape == w.shape, k
        tol = 1e-6 if k.endswith("boxes") else TOL
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=k)
    assert got.roi_mask_logits.shape == (BATCH, 16, 8, 8)
    assert got.roi_scores.dtype == torch.float32


def test_roi_train_forward_matches_jax():
    """Train mode at the assigned GT boxes (``roi_boxes=``), the init's
    prediction convs as they are: the ROI mask logits, the other outputs
    and the new BN running statistics within 1e-4 (``test_torch_train``'s
    bound for the train-mode forward); no proposals."""
    cfg = roi_config()
    params, stats = roi_variables(cfg, spread=False)
    b = tiny_batch(np.random.RandomState(3), n=3)
    sel = jax.vmap(lambda m, v: jax_targets.assign_targets_roi(
        m, v, grid_size=8, mask_hw=(16, 16), max_pos_cells=16))(
            jnp.asarray(b["masks"]), jnp.asarray(b["valid"]))[5]
    x = _normalized(cfg, b["image"])
    want, mutated = jax_create_model(cfg.model).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
        roi_boxes=sel, mutable=["batch_stats"])
    model = create_model(cfg.model, "cpu", train=True)
    load_jax_variables(model, params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(x),
                    roi_boxes=torch.from_numpy(np.array(sel)))
    assert got.roi_boxes is None and got.roi_scores is None
    for k in ("saliency_logits", "cell_scores", "cell_boxes",
              "roi_mask_logits"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-4,
                                   rtol=0, err_msg=k)
    assert len(got.saliency_aux) == len(want.saliency_aux) == 4
    s = to_jax_variables(model)[1]
    for g, w in zip(jax.tree.leaves(s),
                    jax.tree.leaves(mutated["batch_stats"])):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0)


def test_roi_inferencer_matches_jax(case):
    """``predict_batch`` and ``full_res_masks``: the same slots in the same
    order, scores within 1e-3, /4 and full-resolution masks within 1e-3
    away from the pixels at a box edge (few of them)."""
    cfg, params, stats, images, want, out = case
    assert (want["scores"] > 0).sum() >= BATCH, "too few slots filled"
    inf = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    masks, scores, sal = inf.predict_batch(images)
    assert masks.shape == want["masks"].shape and masks.dtype == torch.float32
    np.testing.assert_array_equal(scores.numpy() > 0, want["scores"] > 0)
    np.testing.assert_allclose(sal.numpy(), want["sal"], atol=TOL, rtol=TOL)
    edge = edge_pixels(np.asarray(out.roi_boxes), (16, 16))
    assert edge.mean() < 0.05, edge.mean()
    keep = ~edge[:, None]
    assert_slots_match(scores.numpy(), masks.numpy() * keep, want["scores"],
                       want["masks"] * keep)
    full = inf.full_res_masks(masks)
    assert full.shape == want["full"].shape and full.dtype == torch.float32
    # an edge pixel at /4 reaches the full-resolution pixels that blend it
    near = np.kron(edge | np.roll(edge, 1, 1) | np.roll(edge, -1, 1)
                   | np.roll(edge, 1, 2) | np.roll(edge, -1, 2),
                   np.ones((4, 4), bool))
    keep = ~near[:, None]
    assert_slots_match(scores.numpy(), full.numpy() * keep, want["scores"],
                       want["full"] * keep)


def test_roi_batched_predictor_equals_predict_batch(case):
    """``BatchedPredictor`` (what ``serve`` runs) answers each image of a
    roi batch with ``predict_batch``'s slots of that image, bit for
    bit."""
    from basi_tpu_torch.serve import BatchedPredictor

    cfg, params, stats, images, _, _ = case
    p = BatchedPredictor(cfg, max_wait_ms=200, device="cpu", params=params,
                         batch_stats=stats)
    try:
        got = p.predict_many(images)
        masks, scores, _ = p.inf.predict_batch(images)
    finally:
        p.close()
    assert len(got) == BATCH
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.scores, scores[i].numpy())
        np.testing.assert_array_equal(g.masks, masks[i].numpy())


@pytest.mark.parametrize("orig", [False, True], ids=["letterbox", "original"])
def test_roi_evaluate_matches_jax(orig, variables):
    """``evaluate`` on the val split (10 images, 3 batches of 4) in the
    letterbox or the original frame (scale 1.5): every metric within 1e-3
    of JAX's ``Inferencer.evaluate``, the image count equal."""
    cfg = roi_config(ap_at_original=orig)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, synthetic_n=40, synthetic_orig_scale=1.5 if orig else 1.0))
    params, stats = variables
    want = JaxInferencer(cfg, params=params, batch_stats=stats).evaluate()
    got = Inferencer(cfg, device="cpu", params=params,
                     batch_stats=stats).evaluate()
    assert got["num_images"] == want["num_images"] == 10
    assert set(got) == set(want) and np.isfinite(list(got.values())).all()
    for k in want:
        if k not in ("infer_ms_per_batch", "imgs_per_s"):
            assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])


def test_roi_bf16_model_matches_jax(variables):
    """The roi model in bf16 (weights cast, as ``Inferencer`` casts them)
    against JAX's: every output within 4% of its largest magnitude at most
    and 2% on average; the ROI mask logits at JAX's proposals."""
    cfg = roi_config(dtype="bfloat16")
    params, stats = variables
    x = _normalized(cfg, _images())
    cast = lambda t: jax.tree.map(  # noqa: E731
        lambda v: jnp.asarray(v, jnp.bfloat16), t)
    want = jax_create_model(cfg.model).clone(dtype=jnp.bfloat16).apply(
        {"params": cast(params), "batch_stats": cast(stats)},
        jnp.asarray(x, jnp.bfloat16))
    model = create_model(cfg.model, "cpu")
    load_jax_variables(model, params, stats)
    model = model.to(torch.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        out = model(xb)
        at_jax = model(xb, roi_boxes=torch.from_numpy(
            np.asarray(want.roi_boxes, np.float32)))
    got = {k: getattr(out, k) for k in ("saliency_logits", "cell_scores",
                                        "mask_feats", "cell_boxes")}
    got["roi_mask_logits"] = at_jax.roi_mask_logits
    for k, g in got.items():
        w = np.asarray(getattr(want, k), np.float32)
        diff = np.abs(g.float().numpy() - w)
        scale = np.abs(w).max()
        assert diff.max() <= 0.04 * scale, (k, diff.max(), scale)
        assert diff.mean() <= 0.02 * scale, (k, diff.mean(), scale)
    assert out.roi_mask_logits.dtype == torch.bfloat16


def test_roi_bf16_selection_on_jax_outputs_matches_jax(variables):
    """bf16 (``infer.dtype=bfloat16``): the port's roi selection on JAX's
    own bf16 model outputs gives JAX's bf16 slots: filled alike, scores
    within 1e-2, masks within one bf16 ulp of a probability near 1 (the
    paste's f32 products run in another order)."""
    cfg = roi_config(dtype="bfloat16")
    params, stats = variables
    images = _images()
    jinf = JaxInferencer(cfg, params=params, batch_stats=stats)
    wm, ws, _ = jinf.predict_batch(images)
    wm, ws = np.asarray(wm, np.float32), np.asarray(ws, np.float32)
    assert (ws > 0).sum() >= BATCH
    out = jax_create_model(cfg.model).clone(dtype=jnp.bfloat16).apply(
        {"params": jinf.params, "batch_stats": jinf.batch_stats},
        jnp.asarray(_normalized(cfg, images), jnp.bfloat16))

    def t(k, dtype):
        return torch.from_numpy(np.asarray(getattr(out, k), np.float32)).to(
            dtype)

    inf = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    assert inf.dtype == torch.bfloat16
    masks, scores = inf._select(BASIOutputs(
        t("saliency_logits", torch.bfloat16), t("cell_scores", torch.bfloat16),
        None, t("mask_feats", torch.bfloat16),
        roi_boxes=t("roi_boxes", torch.float32),
        roi_scores=t("roi_scores", torch.float32),
        roi_mask_logits=t("roi_mask_logits", torch.bfloat16)))
    assert masks.dtype == torch.bfloat16
    np.testing.assert_array_equal(scores.numpy() > 0, ws > 0)
    assert_slots_match(scores.numpy(), masks.float().numpy(), ws, wm,
                       tol=1e-2, mask_tol=2.0 ** -8)


def test_roi_aot_artifact_equals_predict_batch(case, tmp_path):
    """A roi model exports (the top-k proposals and the paste included)
    and the loaded artifact's outputs equal ``predict_batch`` bit for
    bit; its sidecar names the mechanism."""
    cfg, params, stats, images, _, _ = case
    inf = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    path = str(tmp_path / "roi.basiaot")
    meta = save_serving(path, cfg, state_dict=inf.model.state_dict(),
                        device="cpu")
    assert meta["instance_mechanism"] == "roi"
    art = load_serving(path, device="cpu")
    want = inf.predict_batch(images)
    got = art(images)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert (want[1] > 0).any()


SETS = ["model.backbone=resnet_tiny", "model.image_size=64",
        "model.grid_size=8", "model.fpn_channels=32", "model.mask_channels=32",
        "model.instance_mechanism=roi", "model.roi_resolution=8",
        "model.roi_top_k=16", "data.image_size=64", "data.dataset=synthetic",
        "data.batch_size=4", "data.synthetic_n=16", "data.max_instances=4",
        "infer.batch_size=4", "infer.dtype=float32", "parallel.num_devices=1"]


def test_roi_cli_infer_and_predict(tmp_path, capsys):
    """``basi-torch infer`` and ``predict`` with
    ``--set model.instance_mechanism=roi`` on a roi checkpoint: ``infer``'s
    metrics within 1e-3 of the JAX CLI's on the same weights, ``predict``
    writes a PNG per image and a results file of the kept slots."""
    from PIL import Image

    from basi_tpu.cli import main as jax_main
    from basi_tpu.utils.checkpoint import export_params as jax_export_params
    from basi_tpu_torch.cli import main
    from basi_tpu_torch.utils.checkpoint import export_params

    tiny = [a for s in SETS for a in ("--set", s)]
    params, stats = roi_variables(jax_get_config("", SETS))
    jax_export_params(str(tmp_path / "orbax"), params, stats)
    model = create_model(roi_config().model, "cpu")
    load_jax_variables(model, params, stats)
    export_params(str(tmp_path / "port"), model.state_dict())

    def last_json():
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    assert jax_main(["infer", *tiny, "--checkpoint", str(tmp_path / "orbax"),
                     "--max-batches", "1"]) == 0
    want = last_json()
    assert main(["infer", *tiny, "--device", "cpu", "--checkpoint",
                 str(tmp_path / "port"), "--max-batches", "1"]) == 0
    got = last_json()
    assert got["num_images"] == want["num_images"] == 4
    for k in set(want) - {"infer_ms_per_batch", "imgs_per_s"}:
        assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])

    imgs = tmp_path / "images"
    imgs.mkdir()
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate([(48, 64), (80, 56)]):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            imgs / f"photo{i}.png")
    out = tmp_path / "pred"
    assert main(["predict", *tiny, "--device", "cpu", "--checkpoint",
                 str(tmp_path / "port"), "--images", str(imgs), "--out",
                 str(out / "pngs"), "--results",
                 str(out / "results.json")]) == 0
    assert last_json()["images"] == 2
    for i, (h, w) in enumerate([(48, 64), (80, 56)]):
        assert np.asarray(Image.open(out / "pngs" / f"photo{i}.png")).shape \
            == (h, w)
    res = json.loads((out / "results.json").read_text())
    assert res and all(r["score"] > 0 for r in res)
