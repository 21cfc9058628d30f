"""The port's evaluation against the JAX package's, on the CPU.

Module by module, on inputs drawn with numpy from a seed: the paste
(``ops/paste.py``, 1e-6: the same f32 arithmetic, the source coordinate
with the reference's single rounding), the IoU matching (1e-6; its sums
are exact), ``APAccumulator`` (the same float64 host code: equal, and the
golden cases of ``tests/test_ap_golden.py``), every saliency metric with
and without a content mask (1e-5), the exact EDT (distances and carried
payloads equal, ties included, and equal to a brute-force oracle) and the
native-GT cache (the same packed arrays as the JAX cache). The port fixes
two faults of the reference's cache, and the tests here hold it to that:
two writers racing into one directory both succeed (each writes its own
temporary file), and a new scene-generator version builds a new cache.

Then the slice whole: ``Inferencer.evaluate`` on the tiny config in f32
with JAX's weights, letterbox frame and original frame (non-square scenes,
``synthetic_orig_scale=1.5``), against JAX ``Inferencer.evaluate`` on the
same val split: the same metric keys, saliency means and AP/AR within
1e-3, and each batch's IoU matrices within 1e-3 wherever the two sides
binarize a mask alike (a pixel within 1e-3 of ``mask_threshold`` may
binarize apart, and only there may an IoU differ by more). JAX's own
per-batch outputs fed to the port's accumulation give JAX's metrics
exactly. The ``Trainer`` runs its epoch to the end and evaluates.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

import test_ap_golden
from basi_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from basi_tpu.data.datasets import iter_epoch as jax_iter_epoch
from basi_tpu.data.datasets import make_dataset as jax_make_dataset
from basi_tpu.data.native_gt import NativeGTCache as JaxNativeGTCache
from basi_tpu.data.transforms import pack_masks_host as jax_pack
from basi_tpu.evals import ap as jax_ap
from basi_tpu.evals import saliency as jax_sal
from basi_tpu.infer import Inferencer as JaxInferencer
from basi_tpu.ops import paste as jax_paste
from basi_tpu_torch.convert import to_jax_variables
from basi_tpu_torch.data import native_gt as NG
from basi_tpu_torch.data.datasets import SyntheticDataset, make_dataset
from basi_tpu_torch.evals import ap as AP
from basi_tpu_torch.evals import saliency as SAL
from basi_tpu_torch.infer import EvalAccumulator, Inferencer
from basi_tpu_torch.ops import paste as P
from basi_tpu_torch.train.loop import Trainer

from helpers import tiny_config
from test_torch_model import jax_variables

TOL = 1e-3  # the slice whole: metrics and IoUs
TIMING = ("infer_ms_per_batch", "imgs_per_s")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x)


# --- paste ------------------------------------------------------------------

@pytest.mark.parametrize("hw,canvas", [((64, 64), (128, 128)),
                                       ((64, 64), (128, 256)),
                                       ((96, 96), (256, 384))])
def test_paste_matches_jax(hw, canvas):
    """Non-square valid and original extents, one per image; 1e-6."""
    rng = np.random.RandomState(0)
    h, w = hw
    masks = rng.rand(3, 5, h, w).astype(np.float32)
    valid = np.array([[h, w - 7], [h * 2 // 3, w], [h - 5, w // 2 + 1]],
                     np.int32)
    orig = np.array([[canvas[0] - 3, canvas[1] - 50],
                     [canvas[0] // 2 + 1, canvas[1] - 1],
                     [canvas[0] - 40, canvas[1] // 3]], np.int32)
    want = _np(jax_paste.paste_masks_batch(masks, valid, canvas, orig))
    got = P.paste_masks_batch(_t(masks), _t(valid), canvas, _t(orig))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert (got.numpy()[2, :, canvas[0] - 40:] == 0).all()  # outside: 0
    one = P.paste_masks(_t(masks[1]), _t(valid[1]), canvas, _t(orig[1]))
    np.testing.assert_array_equal(one.numpy(), got.numpy()[1])
    single = P.paste_mask(_t(masks[0, 2]), _t(valid[0]), canvas, _t(orig[0]))
    np.testing.assert_array_equal(single.numpy(), got.numpy()[0, 2])


def test_paste_clamps_taps_to_the_valid_region():
    """A constant mask over the content stays constant up to the border
    rows: the padding's predictions never blend in."""
    m = np.zeros((1, 1, 64, 64), np.float32)
    m[..., :40, :50] = 0.5
    m[..., 40:, :] = m[..., :, 50:] = 1.0  # the letterbox padding
    out = P.paste_masks_batch(_t(m), _t([[40, 50]]), (128, 128),
                              _t([[100, 125]])).numpy()
    np.testing.assert_array_equal(out[0, 0, :100, :125], 0.5)
    assert (out[0, 0, 100:] == 0).all() and (out[0, 0, :, 125:] == 0).all()


# --- AP ---------------------------------------------------------------------

def test_match_matches_jax():
    rng = np.random.RandomState(1)
    pred = rng.rand(2, 6, 32, 40).astype(np.float32)
    gt = (rng.rand(2, 3, 32, 40) < 0.3).astype(np.uint8)
    want = _np(jax_ap.match_batch(pred, gt))
    got = AP.match_batch(_t(pred), _t(gt)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(AP.match_image(_t(pred[1]), _t(gt[1])).numpy(),
                               _np(jax_ap.match_image(pred[1], gt[1])),
                               atol=1e-6, rtol=0)


def test_ap_accumulator_matches_jax():
    """The same stream of (scores, IoU, valid, areas): equal AP and AR.
    Scores repeat and some are 0; areas span the three size bins."""
    rng = np.random.RandomState(2)
    ours, theirs = AP.APAccumulator(), jax_ap.APAccumulator()
    for _ in range(40):
        k, m = rng.randint(1, 21), rng.randint(1, 9)
        scores = np.round(rng.rand(k), 1) * (rng.rand(k) > 0.2)
        iou = rng.rand(k, m) ** 2
        valid = (rng.rand(m) > 0.2).astype(np.uint8)
        areas = rng.choice([100, 2000, 20000], m) * rng.rand(m)
        for acc in (ours, theirs):
            acc.add(scores, iou, valid, gt_areas=areas)
    assert ours.ap() == theirs.ap()
    assert ours.ar() == theirs.ar()
    assert ours.ap()["mAP"] > 0


@pytest.mark.parametrize("name", sorted(
    n for n in dir(test_ap_golden) if n.startswith("test_")))
def test_ap_golden_cases_hold_for_the_port(name, monkeypatch):
    """Each golden case of ``tests/test_ap_golden.py`` on the port's class."""
    monkeypatch.setattr(test_ap_golden, "APAccumulator", AP.APAccumulator)
    getattr(test_ap_golden, name)()


# --- saliency ---------------------------------------------------------------

def _scenes(seed, n=3, h=48, w=64, empty=True):
    """Soft predictions around blob GT; the last image's GT is empty."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    gt = np.zeros((n, h, w), np.float32)
    for i in range(n):
        for _ in range(2):
            cy, cx = rng.randint(5, h - 5), rng.randint(5, w - 5)
            r = rng.randint(3, min(h, w) // 4)
            gt[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1.0
    if empty:
        gt[-1] = 0.0
    pred = np.clip(gt * 0.7 + rng.rand(n, h, w) * 0.4, 0, 1).astype(np.float32)
    valid = np.zeros((n, h, w), np.float32)
    valid[:, :h - 8, :w - 9] = 1.0
    return pred, gt, valid


SOD = ["f_measure_hist", "e_measure_hist", "s_measure", "boundary_f_measure",
       "weighted_f_measure"]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", SOD)
def test_saliency_metrics_match_jax(name, masked):
    """Per image, with and without the content mask: 1e-5."""
    pred, gt, valid = _scenes(3)
    v = valid if masked else None
    want = _np(getattr(jax_sal, name)(pred, gt, valid=v))
    got = getattr(SAL, name)(_t(pred), _t(gt),
                             valid=None if v is None else _t(v))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_mae_and_broadcast_f_measure_match_jax():
    pred, gt, _ = _scenes(4)
    assert abs(float(SAL.mae(_t(pred), _t(gt)))
               - float(jax_sal.mae(pred, gt))) <= 1e-6
    got = SAL.f_measure(_t(pred), _t(gt))
    want = jax_sal.f_measure(pred, gt)
    np.testing.assert_allclose([float(x) for x in got],
                               [float(x) for x in want], atol=1e-6, rtol=0)


def _edt_oracle(fg, payload):
    """Brute force: the nearest fg pixel by squared distance, ties to the
    smallest x', then the smallest y' (the two-pass order)."""
    h, w = fg.shape
    ys, xs = np.nonzero(fg)
    yy, xx = np.mgrid[0:h, 0:w]
    d2 = (yy[..., None] - ys) ** 2 + (xx[..., None] - xs) ** 2
    best = np.lexsort((np.broadcast_to(ys, d2.shape),
                       np.broadcast_to(xs, d2.shape), d2), axis=-1)[..., 0]
    return (np.take_along_axis(d2, best[..., None], -1)[..., 0],
            payload[ys[best], xs[best]])


@pytest.mark.parametrize("case", ["sparse", "grid", "symmetric"])
def test_edt_matches_jax_and_brute_force_with_ties(case):
    """Distances exact and the carried payloads equal, on images whose
    pixels have many equidistant nearest seeds."""
    rng = np.random.RandomState(5)
    h, w = 20, 28
    fg = np.zeros((h, w), np.float32)
    if case == "sparse":
        fg[rng.rand(h, w) < 0.05] = 1.0
        fg[3, 7] = 1.0
    elif case == "grid":  # every other cell: ties everywhere between
        fg[::4, ::4] = 1.0
    else:  # mirror pairs about the centre lines
        for y, x in [(2, 3), (5, 10), (9, 6)]:
            fg[y, x] = fg[h - 1 - y, x] = fg[y, w - 1 - x] = 1.0
            fg[h - 1 - y, w - 1 - x] = 1.0
    pay = rng.rand(h, w).astype(np.float32)
    jd, jp = (_np(x) for x in jax_sal._edt_payload(fg, pay, chunk=8))
    td, tp = (x.numpy() for x in SAL._edt_payload(_t(fg), _t(pay), chunk=8))
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tp, jp)
    od, op = _edt_oracle(fg, pay)
    np.testing.assert_array_equal(td.astype(np.int64), od)
    np.testing.assert_array_equal(tp, op)
    # a batch, chunked over images and lines, equals image by image
    both = SAL._edt_payload(_t(np.stack([fg, fg[::-1].copy()])),
                            _t(np.stack([pay, pay])), chunk=5)
    np.testing.assert_array_equal(both[0][0].numpy(), td)
    np.testing.assert_array_equal(both[1][0].numpy(), tp)


def test_gauss7_matches_jax():
    x = np.random.RandomState(6).rand(2, 30, 40).astype(np.float32)
    want = np.stack([_np(jax_sal._gauss7(x[i])) for i in range(2)])
    np.testing.assert_allclose(SAL._gauss7(_t(x)).numpy(), want, atol=1e-6,
                               rtol=0)


def test_pools_pad_with_infinities():
    """A min pool of an all-ones map stays 1 at the border (zero padding
    would erode it); a max pool of an all-(-1) map stays -1."""
    ones = torch.ones(1, 6, 7)
    assert torch.equal(SAL._pool3(ones, 3, "min"), ones)
    assert torch.equal(SAL._pool3(-ones, 7, "max"), -ones)


# --- the native-GT cache ----------------------------------------------------

def test_native_gt_cache_matches_jax(tmp_path):
    kw = dict(n=5, image_size=64, max_instances=4, seed=3, orig_max_scale=1.5)
    ours = NG.NativeGTCache(SyntheticDataset(**kw), str(tmp_path / "t"))
    theirs = JaxNativeGTCache(JaxSynthetic(**kw), str(tmp_path / "j"))
    assert os.path.isfile(ours.path)
    for i in range(5):
        (pm, pv, phw), (jm, jv, jhw) = ours.get_packed(i), theirs.get_packed(i)
        assert phw == jhw
        np.testing.assert_array_equal(pm, jm)
        np.testing.assert_array_equal(pv, jv)
    again = NG.NativeGTCache(SyntheticDataset(**kw), str(tmp_path / "t"))
    assert ours.on_disk and again.on_disk and again.path == ours.path
    np.testing.assert_array_equal(
        again.native_sizes(), [theirs.get_packed(i)[2] for i in range(5)])


def test_native_gt_cache_writers_race_and_both_succeed(tmp_path, monkeypatch):
    """The reference wrote a fixed temporary name, so of two writers the
    second one's move found its file gone. Here both write, then both move
    at once (a barrier holds each before ``os.replace``): both succeed and
    serve the same GT."""
    ds = SyntheticDataset(n=3, image_size=64, max_instances=4, seed=7,
                          orig_max_scale=1.5)
    barrier = threading.Barrier(2, timeout=60)
    real = os.replace

    def replace(src, dst):
        if dst.endswith(".npz"):
            barrier.wait()
        return real(src, dst)

    monkeypatch.setattr(os, "replace", replace)
    out, errors = [None, None], []

    def build(j):
        try:
            out[j] = NG.NativeGTCache(ds, str(tmp_path))
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(j,)) for j in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for i in range(3):
        np.testing.assert_array_equal(out[0].get_packed(i)[0],
                                      out[1].get_packed(i)[0])
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(out[0].path),
                                            os.path.basename(out[0].path)
                                            + ".json"]


def test_native_gt_cache_rebuilds_for_a_new_scene_version(tmp_path):
    """The key holds ``SyntheticDataset.SCENE_VERSION``: scenes drawn by a
    changed generator are never served from the old file."""
    kw = dict(n=2, image_size=64, max_instances=4, seed=1, orig_max_scale=1.0)
    old = NG.NativeGTCache(SyntheticDataset(**kw), str(tmp_path))

    class Changed(SyntheticDataset):
        SCENE_VERSION = SyntheticDataset.SCENE_VERSION + 1

        def get_orig_masks(self, i):
            masks, valid = super().get_orig_masks(i)
            return 1 - masks, valid

    new = NG.NativeGTCache(Changed(**kw), str(tmp_path))
    assert new.path != old.path
    assert NG.dataset_cache_key(Changed(**kw)) != NG.dataset_cache_key(
        SyntheticDataset(**kw))
    masks, _ = Changed(**kw).get_orig_masks(0)
    np.testing.assert_array_equal(new.get_packed(0)[0],
                                  np.packbits(masks > 0, axis=-1))


def test_native_gt_cache_without_a_key_stays_in_memory(tmp_path):
    class Anon:
        def __len__(self):
            return 1

        def get_orig_masks(self, i):
            m = np.zeros((2, 16, 24), np.uint8)
            m[0, :8, :12] = 1
            return m, np.array([1, 0], np.uint8)

    cache = NG.NativeGTCache(Anon(), str(tmp_path / "never"))
    assert NG.dataset_cache_key(Anon()) is None and cache.path == ""
    assert not cache.on_disk
    assert cache.get_packed(0)[2] == (16, 24)
    assert not (tmp_path / "never").exists()


# --- the slice whole --------------------------------------------------------

def _eval_cfg(orig: bool, n: int = 40, cache: str = ""):
    cfg = tiny_config(batch_size=4)
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, synthetic_n=n,
                                 synthetic_orig_scale=1.5 if orig else 1.0),
        infer=dataclasses.replace(cfg.infer, ap_at_original=orig,
                                  native_gt_cache=cache))


def assert_metrics_close(got: dict, want: dict, tol: float = TOL):
    """The same keys; the image count equal, every other metric within
    ``tol`` (timings aside)."""
    assert set(got) == set(want), set(got) ^ set(want)
    assert got["num_images"] == want["num_images"]
    for k in want:
        if k not in TIMING:
            assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def assert_iou_close(got, want, full_got, full_want, thr, tol=TOL):
    """IoUs within ``tol``, except where the masks binarize apart; masks
    binarize apart only at pixels within ``tol`` of the threshold."""
    np.testing.assert_allclose(full_got, full_want, atol=tol, rtol=0)
    apart = (full_got > thr) != (full_want > thr)
    assert (np.abs(full_want[apart] - thr) <= tol).all()
    slot_apart = apart.any(axis=(-2, -1))  # (N, K)
    ok = (np.abs(got - want) <= tol) | slot_apart[..., None]
    assert ok.all(), np.abs(got - want).max()


@pytest.fixture(scope="module", params=[False, True], ids=["letterbox",
                                                           "original"])
def evals(request):
    """Both sides' ``evaluate`` on the tiny config's val split (10 images,
    3 batches of 4, the last padded), and the per-batch outputs of each."""
    orig = request.param
    cfg = _eval_cfg(orig)
    params, stats = jax_variables(cfg)
    jinf = JaxInferencer(cfg, params=params, batch_stats=stats)
    inf = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    want = jinf.evaluate()
    got = inf.evaluate()
    jds = jax_make_dataset(cfg.data, split="val")
    tds = make_dataset(cfg.data, split="val")
    batches = []
    for batch in jax_iter_epoch(jds, 4, shuffle=False, seed=0,
                                drop_last=False):
        gm = jax_pack(batch["masks"])
        j = jinf._eval_batch(jinf.params, jinf.batch_stats, batch["image"],
                             gm, batch["valid"], batch["valid_hw"])
        (masks, scores, iou, mae, f, e, s, bf, wf, gv, full, sal, areas) = j
        jout = {"scores": scores, "iou": iou, "mae": mae, "f": f, "e": e,
                "s": s, "bf": bf, "wf": wf, "valid": gv, "areas": areas}
        if not orig:  # JAX ships the full-resolution masks only for this
            full = jinf.full_res_masks(masks)
        if orig:
            (jout["iou"], jout["mae"], jout["f"], jout["e"], jout["s"],
             jout["bf"], jout["wf"], jout["areas"]) = jinf._orig_frame_eval(
                full, sal, batch, jds)
        with torch.inference_mode():
            tres, tfull, tsal = inf._eval_batch(
                _t(batch["image"]), _t(gm), _t(batch["valid"]),
                _t(batch["valid_hw"]))
            if orig:
                tres.update(inf._orig_frame_eval(tfull, tsal, batch, tds))
        batches.append((int(batch["num_real"]),
                        {k: _np(v) for k, v in jout.items()},
                        {k: v.numpy() for k, v in tres.items()},
                        _np(full), tfull.numpy()))
    return cfg, got, want, batches


def test_evaluate_matches_jax(evals):
    cfg, got, want, _ = evals
    assert got["num_images"] == 10
    assert "saliency_wF" in got and np.isfinite(list(got.values())).all()
    assert_metrics_close(got, want)


def test_eval_batches_match_jax(evals):
    """Batch by batch: the matching IoUs, the per-image saliency metrics
    and curves, and the GT areas."""
    cfg, _, _, batches = evals
    thr = cfg.infer.mask_threshold
    filled = 0
    for _, jout, tout, jfull, tfull in batches:
        np.testing.assert_allclose(tout["scores"], jout["scores"], atol=TOL,
                                   rtol=0)
        filled += int((jout["scores"] > 0).sum())
        assert_iou_close(tout["iou"], jout["iou"], tfull, jfull, thr)
        assert (jout["iou"] > 0).any()
        for k in ("mae", "f", "e", "s", "bf", "wf"):
            np.testing.assert_allclose(tout[k], jout[k], atol=TOL, rtol=0,
                                       err_msg=k)
        np.testing.assert_array_equal(tout["areas"], jout["areas"])
        np.testing.assert_array_equal(tout["valid"], jout["valid"])
    assert filled > 0


def test_jax_batches_through_the_port_accumulation_give_jax_metrics(evals):
    cfg, _, want, batches = evals
    acc = EvalAccumulator(wf=cfg.infer.wf)
    for num_real, jout, *_ in batches:
        acc.add_batch(num_real, *(jout[k] for k in (
            "scores", "iou", "mae", "f", "e", "s", "bf", "wf", "valid",
            "areas")))
    got = dict(acc.metrics(), num_images=acc.n_img)
    assert got == {k: v for k, v in want.items() if k not in TIMING}


def test_original_frame_gt_paths_agree(tmp_path):
    """Device-resident packed GT, the per-batch packed assembly and the
    raw regeneration give the same metrics."""
    cfg = _eval_cfg(True, n=24, cache=str(tmp_path))
    params, stats = jax_variables(cfg)
    inf = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    on_device = inf.evaluate()
    assert inf._gt_dev_obj[1] is not None
    inf._gt_dev_obj = (inf._gt_dev_obj[0], None)  # force the per-batch path
    per_batch = inf.evaluate(dataset=inf._gt_dev_obj[0])
    raw_cfg = _eval_cfg(True, n=24, cache="")
    raw = Inferencer(raw_cfg, device="cpu", params=params,
                     batch_stats=stats).evaluate()
    strip = [{k: v for k, v in m.items() if k not in TIMING}
             for m in (on_device, per_batch, raw)]
    assert strip[0] == strip[1] == strip[2]


def test_evaluate_max_batches_and_wf_off():
    cfg = _eval_cfg(False)
    cfg = dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer,
                                                             wf=False))
    m = Inferencer(cfg, device="cpu").evaluate(max_batches=1)
    assert m["num_images"] == 4 and "saliency_wF" not in m
    assert m["infer_ms_per_batch"] > 0


@pytest.mark.parametrize("depth,ms,rate", [(1, 500.0, 8.0),
                                           (2, 666.67, 6.0)])
def test_evaluate_rate_window(monkeypatch, depth, ms, rate):
    """The rate of 3 batches of 4, on a clock that reads 0 at the start,
    1 at the first drain and 2 at the end. With a lag of 2 batches
    (``prefetch_depth`` 1) the first batch drains while the third is
    queued, and the rate is over the window after it: 1 s for 2 batches.
    With a lag of 4 every batch is queued before the first drain, so that
    window would hold no feed; the rate is the whole call, 2 s for 3."""
    import types

    from basi_tpu_torch import infer as infer_mod

    ticks = iter(range(3))
    monkeypatch.setattr(infer_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks))))
    cfg = _eval_cfg(False, n=40)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, prefetch_depth=depth))
    m = Inferencer(cfg, device="cpu").evaluate()
    assert m["num_images"] == 10
    assert (m["infer_ms_per_batch"], m["imgs_per_s"]) == (ms, rate)


@pytest.mark.parametrize("what", ["results_path", "save_png", "profile"])
def test_unported_eval_outputs_raise(what, tmp_path):
    """The three outputs ``evaluate`` refused before the port read files
    now work: the COCO results file (``num_results`` entries), one PNG per
    image in ``infer.output_dir`` (``png_ms_per_batch``), and a Chrome
    trace in ``profile_dir``; the metrics stay those of a plain run."""
    cfg = _eval_cfg(False, n=12)
    kwargs = {}
    if what == "results_path":
        kwargs["results_path"] = str(tmp_path / "sub" / "results.json")
    elif what == "save_png":
        cfg = dataclasses.replace(cfg, infer=dataclasses.replace(
            cfg.infer, save_png=True, output_dir=str(tmp_path)))
    else:
        cfg = dataclasses.replace(cfg, profile=True,
                                  profile_dir=str(tmp_path / "trace"))
    plain = Inferencer(_eval_cfg(False, n=12), device="cpu",
                       seed=1).evaluate()
    m = Inferencer(cfg, device="cpu", seed=1).evaluate(**kwargs)
    assert m["num_images"] == 3
    extra = {"results_path": {"num_results"}, "save_png": {"png_ms_per_batch"},
             "profile": set()}[what]
    assert set(m) == set(plain) | extra
    for k in plain:
        if k not in TIMING:
            assert m[k] == plain[k], k
    if what == "results_path":
        entries = json.loads((tmp_path / "sub" / "results.json").read_text())
        assert len(entries) == m["num_results"]
        assert {e["image_id"] for e in entries} <= {0, 1, 2}
    elif what == "save_png":
        assert sorted(p.name for p in tmp_path.glob("*.png")) == [
            "b0_i0.png", "b0_i1.png", "b0_i2.png"]
    else:
        (trace,) = (tmp_path / "trace").glob("trace_*.json")
        names = {e.get("name") for e in json.loads(trace.read_text())[
            "traceEvents"]}
        assert {"eval.forward", "eval.selection"} <= names


def test_set_weights_equals_a_fresh_inferencer():
    """bf16 inference: the swapped weights round as ``__init__`` rounds."""
    cfg = tiny_config(batch_size=2)
    cfg = dataclasses.replace(cfg, infer=dataclasses.replace(
        cfg.infer, dtype="bfloat16"))
    params, stats = jax_variables(cfg, seed=3)
    fresh = Inferencer(cfg, device="cpu", params=params, batch_stats=stats)
    swapped = Inferencer(cfg, device="cpu", seed=5)
    swapped.set_weights(params=params, batch_stats=stats)
    a, b = fresh.model.state_dict(), swapped.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert fresh.model.instance.score.weight.dtype == torch.bfloat16
    again = Inferencer(cfg, device="cpu", seed=5)
    again.set_weights(state_dict={k: v.float() for k, v in a.items()})
    assert all(torch.equal(a[k], again.model.state_dict()[k]) for k in a)


# --- the trainer ------------------------------------------------------------

def test_trainer_epoch_ends_in_eval_equal_to_inferencer_and_jax(capsys):
    """``train()`` with no ``max_steps`` runs its epoch, evaluates the EMA
    weights and returns the metrics; they equal ``Inferencer.evaluate`` on
    the same weights, and JAX's on them within the slice's tolerances."""
    cfg = tiny_config(batch_size=4)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, synthetic_n=16),
        train=dataclasses.replace(cfg.train, ema_decay=0.9, epochs=1))
    tr = Trainer(cfg, device="cpu")
    last = tr.train()
    assert tr.state.step == 4 and last["step"] == 4
    assert last["num_images"] == 4 and np.isfinite(last["loss"])
    out = capsys.readouterr().out
    assert out.count("[val] ") == 1 and '"epoch": 0' in out.split("[val] ")[1]
    sd = tr.eval_state_dict()
    assert all(torch.equal(sd[k], v) for k, v in tr.state.ema.items())
    want = Inferencer(cfg, device="cpu", state_dict=sd).evaluate(
        tr.val_dataset)
    strip = [{k: v for k, v in m.items() if k not in TIMING}
             for m in (tr._inferencer.evaluate(tr.val_dataset), want)]
    assert strip[0] == strip[1]
    assert {k: last[k] for k in strip[1]} == strip[1]
    params, stats = to_jax_variables(tr.state.model, tr.state.ema)
    jm = JaxInferencer(cfg, params=params, batch_stats=stats).evaluate()
    assert_metrics_close(want, jm)
