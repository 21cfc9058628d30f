"""The port's ConvNeXt trunk (``models/convnext.py``) on the CPU, against
the benchmark's plain float32 reference (``perfbench/reference/
convnext.py``), which imports nothing of the port. The JAX package has no
ConvNeXt, so no test here compares with it.

Tolerances, all float32 on both sides, where only the order of the sums
differs:

* the trunk's four outputs within 2e-5 of each output's largest magnitude,
  and every parameter's gradient (of a fixed random projection of the
  outputs) within 1e-4 of that leaf's largest: LayerNorm's statistics and
  the Linears' dot products sum 16 to 4096 terms in another order, so
  each output carries a few ulps, and a gradient sums them again over the
  batch's pixels;
* three ``Trainer`` steps (AdamW, clip active, EMA) against the
  reference's: each loss within 1e-5 relative; the first clipped gradient
  read from AdamW's first moment (``exp_avg / 0.1``, one more rounding)
  within 1e-4 in norm of the larger of the leaf's norm and the median
  leaf's (2.3e-6 read); the parameters and the EMA after the third step
  within 2e-3 in norm of their change (2.3e-4 read): Adam's update
  ``lr * m / (sqrt(v) + eps)`` turns a few-ulp gradient difference into
  up to a few percent of the step in the elements whose ``|g|`` is near
  ``eps``. The biases right before a GroupNorm have a zero gradient, which
  both sides compute as rounding noise: their updates are noise too, and
  only their gradients are compared (as the benchmark's check leaves out
  leaves under a thousandth of the median leaf's gradient);
* the ResNet path against ``perfbench/reference/basi.py``: the same
  state-dict names, and the train-mode outputs within 1e-4 of each
  output's largest (BatchNorm on batch statistics in both).

Also: ``train.remat`` bit for bit against the plain step; ``bn_impl``
fused or stats and ``freeze_bn`` refused for a trunk without BatchNorm; the JAX mappings refused; a checkpoint round trip bit
for bit; ``Trainer.train``, ``evaluate``, ``BatchedPredictor`` and the
``basi-torch`` commands at the test cut ``convnext_test``.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import dataclasses
import json
import math
import statistics
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from basi_tpu_torch.cli import main as cli_main
from basi_tpu_torch.config import get_config
from basi_tpu_torch.convert import load_jax_variables, to_jax_variables
from basi_tpu_torch.models.basi import create_model
from basi_tpu_torch.models.convnext import CONVNEXT, ConvNeXtTrunk
from basi_tpu_torch.serve import BatchedPredictor
from basi_tpu_torch.train.loop import Trainer
from basi_tpu_torch.utils.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.harness.inputs import draw_scenes, pack_masks  # noqa: E402
from perfbench.reference import basi as RB  # noqa: E402
from perfbench.reference import convnext as RC  # noqa: E402
from perfbench.reference.train import flips  # noqa: E402

SETS = ["model.backbone=convnext_test", "model.instance_mechanism=roi",
        "model.image_size=64", "data.image_size=64", "model.fpn_channels=32",
        "model.mask_channels=32", "model.grid_size=4", "model.num_slots=8",
        "model.roi_resolution=8", "model.roi_top_k=16", "data.batch_size=4",
        "data.max_instances=4", "data.dataset=synthetic",
        "data.synthetic_n=8", "infer.batch_size=4", "infer.dtype=float32",
        "infer.pre_nms_top_k=8", "infer.native_gt_cache=",
        "train.checkpoint_dir=", "train.optimizer=adamw",
        "train.log_every=1", "train.epochs=1"]


def _cfg(*more):
    return get_config("bench_accuracy", SETS + list(more))


def _seeded(spec, seed: int) -> dict:
    """Float32 tensors for ``spec`` (``(name, shape, kind)``): normal
    draws where the reference draws, the norms' weights and the layer
    scale spread about their init, so that no term of the block is
    trivial."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, kind in spec:
        z = torch.randn(shape, generator=gen)
        if kind in ("conv", "linear", "pred", "score"):
            out[name] = z * RC.init_std(shape, kind)
        elif kind == "one":
            out[name] = 1 + 0.2 * z
        elif kind == "gamma":
            out[name] = 0.5 * z
        elif kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64)
        else:
            out[name] = 0.1 * z + (RB.FOCAL_PRIOR_BIAS if kind == "prior"
                                   else 0.0)
    return out


def _close(got, want, tol, what):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * max(scale, 1e-30), (what, err, scale)


@pytest.mark.parametrize("depths,dims", [
    ((2, 1, 2, 1), (16, 32, 64, 128)),
    ((1, 1, 1, 1), CONVNEXT["convnext_base"][1])],
    ids=["small", "published_widths"])
def test_trunk_matches_reference(depths, dims, monkeypatch):
    monkeypatch.setitem(RC.CONVNEXT, "under_test", (depths, dims))
    spec = RC.trunk_spec(depths, dims)
    p = _seeded(spec, 3)
    trunk = ConvNeXtTrunk(depths, dims).to(memory_format=torch.channels_last)
    trunk.load_state_dict({k[len("backbone."):]: v for k, v in p.items()},
                          strict=True)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    got = trunk(x.contiguous(memory_format=torch.channels_last))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    ref = RC.ConvNeXtRef(leaves, {"backbone": "under_test"}, (0, 0, 0),
                         (1, 1, 1), {})
    with RB.no_tf32():
        want = ref.trunk(x)
    assert [t.shape[1] for t in got] == list(dims)
    gen = torch.Generator().manual_seed(5)
    proj = [torch.randn(t.shape, generator=gen) for t in want]
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.is_contiguous(memory_format=torch.channels_last)
        _close(a.detach(), b.detach(), 2e-5, f"C{i + 2}")
    sum((a * w).sum() for a, w in zip(got, proj)).backward()
    sum((b * w).sum() for b, w in zip(want, proj)).backward()
    named = dict(trunk.named_parameters())
    for k, leaf in leaves.items():
        _close(named[k[len("backbone."):]].grad, leaf.grad, 1e-4, k)


def _batches(n: int, steps: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    images, masks, valid = draw_scenes(n * steps, 64, (1, 4), gen, "cpu",
                                       with_masks=True)
    return images, masks, valid


def test_train_steps_match_reference():
    """Three steps of ``Trainer.train_step`` (AdamW, clip, cosine, EMA)
    against the reference's, its batch in chunks of two."""
    cfg = _cfg("train.grad_clip_norm=0.5", "train.warmup_steps=0",
               "train.lr=0.001", "train.ema_decay=0.9", "model.dtype=float32")
    n, steps = 4, 3
    trainer = Trainer(cfg, device="cpu")
    state = trainer.state
    plain = {s: json.loads(json.dumps(dataclasses.asdict(getattr(cfg, s))))
             for s in ("model", "data", "infer", "train")}
    p0 = _seeded(RC.param_spec(plain["model"]), 11)
    state.model.load_state_dict(p0, strict=True)
    for k, v in state.ema.items():
        v.copy_(p0[k])
    images, masks, valid = _batches(n, steps, 12)
    named = dict(state.model.named_parameters())
    losses = []
    for i in range(steps):
        rows = slice(i * n, (i + 1) * n)
        m = trainer.train_step(state, {"image": images[rows],
                                       "masks": pack_masks(masks[rows]),
                                       "valid": valid[rows]})
        losses.append(float(m["loss"]))
        if i == 0:
            grad = {k: state.optimizer.state[p]["exp_avg"] / 0.1
                    for k, p in named.items()}
    ref = RC.train_reference(
        p0, plain, [(images[i * n:(i + 1) * n], masks[i * n:(i + 1) * n],
                     valid[i * n:(i + 1) * n]) for i in range(steps)],
        flips(0, steps, n, 0.5), trainer.max_steps, chunk=2)
    norm = math.sqrt(sum(float(g.double().square().sum())
                         for g in ref["grad"].values()))
    assert norm == pytest.approx(0.5, rel=1e-5)  # the clip acted
    for a, b in zip(losses, ref["loss"]):
        assert abs(a - b) <= 1e-5 * abs(b), (losses, ref["loss"])
    norms = {k: float(g.norm()) for k, g in ref["grad"].items()}
    med = statistics.median(norms.values())
    for k, p in named.items():
        gap = float((grad[k] - ref["grad"][k]).norm())
        assert gap <= 1e-4 * max(norms[k], med), (k, gap, norms[k], med)
        if norms[k] < 1e-3 * med:  # a bias under a GroupNorm: noise alone
            continue
        for got, want in ((p.detach(), ref["params"][k]),
                          (state.ema[k], ref["ema"][k])):
            gap = float((got - want).norm())
            assert gap <= 2e-3 * float((want - p0[k]).norm()), (k, gap)

def test_remat_matches_the_plain_step():
    """``train.remat`` recomputes the ConvNeXt trunk in the backward: two
    steps give the plain steps' losses and parameters bit for bit (the
    same float32 operations, run again)."""
    got = []
    for remat in ("false", "true"):
        tr = Trainer(_cfg("model.dtype=float32", f"train.remat={remat}",
                          "train.warmup_steps=0"), device="cpu")
        tr.train(max_steps=2)
        got.append(([r["loss"] for r in tr.records],
                    {k: v.clone() for k, v in
                     tr.state.model.state_dict().items()}))
    assert got[0][0] == got[1][0]
    assert all(torch.equal(v, got[1][1][k]) for k, v in got[0][1].items())


def test_chunked_loss_sums_to_the_batch_loss():
    """The reference's chunk shares of the roi loss sum to
    ``reference/train.py::roi_loss`` of the whole batch."""
    from perfbench.reference.train import roi_loss, targets

    cfg = _cfg("model.dtype=float32")
    m = dataclasses.asdict(cfg.model)
    p = _seeded(RC.param_spec(m), 21)
    ref = RC.ConvNeXtRef(p, m, cfg.data.mean, cfg.data.std, {})
    images, masks, valid = _batches(4, 1, 22)
    x = (images.float() / 255 - ref.mean) / ref.std
    tg = targets(masks, valid, torch.tensor([True, False, True, False]), 4, 4,
                 64)
    weights = {"mask": 3.0, "score": 1.0, "box": 1.0, "saliency": 1.0}
    with torch.no_grad(), RB.no_tf32():
        x = x.permute(0, 3, 1, 2)
        whole = roi_loss(ref.forward_train(x, tg["boxes"]), tg, weights)
        norms = RC.loss_norms(tg, 8)
        parts = [RC.roi_loss_part(
            ref.forward_train(x[a:a + 2], tg["boxes"][a:a + 2]),
            {k: v[a:a + 2] for k, v in tg.items()}, weights, norms)
            for a in (0, 2)]
    assert float(sum(parts)) == pytest.approx(float(whole), rel=1e-6)


@pytest.mark.parametrize("setting", ["model.bn_impl=fused",
                                     "model.bn_impl=stats",
                                     "train.freeze_bn=true"])
def test_batch_norm_settings_refused(setting):
    cfg = _cfg(setting)
    with pytest.raises(ValueError, match="BatchNorm"):
        Trainer(cfg, device="cpu")
    if setting.startswith("model."):
        with pytest.raises(ValueError, match="BatchNorm"):
            create_model(cfg.model, "cpu")


def test_no_jax_counterpart(tmp_path):
    cfg = _cfg()
    model = create_model(cfg.model, "cpu")
    for call in (lambda: load_jax_variables(model, {}, {}),
                 lambda: to_jax_variables(model)):
        with pytest.raises(ValueError, match="no JAX counterpart"):
            call()
    torch.save(model.state_dict(), tmp_path / "m.pth")
    sets = [a for s in SETS if s != "model.instance_mechanism=roi"
            for a in ("--set", s)]
    with pytest.raises(ValueError, match="no JAX counterpart"):
        cli_main(["import", *sets, "--device", "cpu", "--torch",
                  str(tmp_path / "m.pth"), "--out", str(tmp_path / "o")])


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    cfg = _cfg()
    tr = Trainer(cfg, device="cpu")
    tr.train(max_steps=2)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(tr.state)
    fresh = Trainer(_cfg("train.seed=5"), device="cpu")
    mgr.restore(fresh.state)
    assert fresh.state.step == 2
    want = tr.state.model.state_dict()
    got = fresh.state.model.state_dict()
    assert set(got) == set(want) and not list(fresh.state.model.buffers())
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(fresh.state.ema[k], v)
               for k, v in tr.state.ema.items())
    for a, b in zip(fresh.state.model.parameters(),
                    tr.state.model.parameters()):
        sa, sb = fresh.state.optimizer.state[a], tr.state.optimizer.state[b]
        assert all(torch.equal(sa[k], sb[k]) for k in ("exp_avg",
                                                        "exp_avg_sq"))


def test_normal_path(tmp_path, capsys):
    """``Trainer.train`` through its epoch's eval, ``evaluate``,
    ``BatchedPredictor`` and the ``basi-torch`` train and infer commands,
    with the ConvNeXt trunk and the roi head."""
    tr = Trainer(_cfg(), device="cpu")
    rec = tr.train()
    assert rec["step"] == 2 and np.isfinite(rec["loss"])
    assert "AP@0.5" in rec
    sd = tr.eval_state_dict()
    pred = BatchedPredictor(_cfg(), device="cpu", state_dict=sd)
    try:
        images = draw_scenes(5, 64, (1, 3), torch.Generator().manual_seed(3),
                             "cpu").numpy()
        out = pred.predict_many(images)
        assert len(out) == 5
    finally:
        pred.close()
    sets = [a for s in SETS if s != "train.checkpoint_dir="
            for a in ("--set", s)]
    assert cli_main(["train", *sets, "--device", "cpu", "--set",
                     f"train.checkpoint_dir={tmp_path}/ckpt"]) == 0
    assert cli_main(["eval", *sets, "--device", "cpu", "--checkpoint",
                     f"{tmp_path}/ckpt", "--max-batches", "1"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["num_images"] == 2  # the val split: synthetic_n // 4


def test_resnet_path_matches_its_reference():
    """The ResNet trunk's model: the reference's state-dict names, no
    ConvNeXt module, and the train-mode outputs of
    ``perfbench/reference/basi.py``."""
    cfg = get_config("bench_accuracy", [
        s.replace("convnext_test", "resnet_tiny") for s in SETS
        if not s.startswith("train.optimizer")] + ["model.dtype=float32"])
    model = create_model(cfg.model, "cpu", torch.Generator().manual_seed(1),
                         train=True)
    m = dataclasses.asdict(cfg.model)
    spec = RB.param_spec(m)
    assert list(model.state_dict()) == [n for n, _, _ in spec]
    assert not any(isinstance(mod, (torch.nn.Linear, torch.nn.LayerNorm))
                   for mod in model.modules())
    p = _seeded(spec, 2)
    model.load_state_dict(p, strict=True)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 64, 64, 3, generator=gen)
    boxes = torch.tensor([[[0.1, 0.2, 0.6, 0.7], [0.3, 0.1, 0.9, 0.5]]] * 2)
    out = model(x, train=True, roi_boxes=boxes)
    ref = RB.Ref({k: v for k, v in p.items() if "num_batches" not in k}, m,
                 (0, 0, 0), (1, 1, 1), {})
    with torch.no_grad(), RB.no_tf32():
        sal, aux, score, cell_boxes, logits = ref.forward_train(
            x.permute(0, 3, 1, 2), boxes)
    got = [out.saliency_logits[..., 0], out.cell_scores[..., 0],
           out.cell_boxes, out.roi_mask_logits]
    for a, b, what in zip(got, [sal[:, 0], score[:, 0], cell_boxes, logits],
                          ("saliency", "scores", "boxes", "roi masks")):
        _close(a.detach(), b, 1e-4, what)
