"""The port's BASINet against the JAX BASINet, same weights, same input.

JAX ``init_model`` variables (tiny config: resnet_tiny, FPN 32, mask 32,
grid 8, 64^2) get a zero objectness bias and non-trivial BN running stats,
then go through ``load_jax_variables`` (``export_basinet`` +
``load_state_dict(strict=True)``). Tolerances:

* f32: ``atol=rtol=1e-3`` on every output, the repo's per-pixel budget
  (``tests/test_full_convert.py``); measured differences are ~5e-6.
* bf16 (weights and activations, as ``infer.dtype=bfloat16`` runs): each
  output's max abs difference within 4% of its largest magnitude and mean
  abs difference within 2%. bf16 keeps 8 significant bits (0.4%) and the
  two frameworks round at different places (BN and GroupNorm internals,
  conv accumulation); measured on this tiny model: max 1.0-2.7%, mean
  0.2-0.9% of the largest magnitude.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basi_tpu.config import get_config
from basi_tpu.convert.torch_export import export_basinet
from basi_tpu.models.basi import create_model as jax_create_model
from basi_tpu.models.basi import init_model
from basi_tpu_torch.convert import load_jax_variables
from basi_tpu_torch.infer import Inferencer
from basi_tpu_torch.models.basi import create_model
from basi_tpu_torch.serve import BatchedPredictor

from helpers import tiny_config

OUTPUTS = ("saliency_logits", "cell_scores", "cell_kernels", "mask_feats")


def jax_variables(cfg, seed: int = 0):
    """JAX init variables as numpy trees, with the objectness bias at 0
    (the focal-prior init fills no slot) and BN running stats drawn from a
    numpy seed."""
    params, stats = init_model(jax_create_model(cfg.model),
                               cfg.model.image_size)
    params = jax.tree.map(np.array, params)
    stats = jax.tree.map(np.array, stats)
    params["instance"]["score"]["bias"][...] = 0.0
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


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config()
    params, stats = jax_variables(cfg)
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    return cfg, params, stats, x


def _jax_outputs(cfg, params, stats, x, dtype):
    model = jax_create_model(cfg.model).clone(dtype=dtype)
    cast = lambda t: jax.tree.map(lambda v: jnp.asarray(v, dtype), t)  # noqa: E731
    out = model.apply({"params": cast(params), "batch_stats": cast(stats)},
                      jnp.asarray(x, dtype), False, with_candidates=False)
    return {k: np.asarray(getattr(out, k), np.float32) for k in OUTPUTS}


def test_f32_model_matches_jax(setup):
    cfg, params, stats, x = setup
    want = _jax_outputs(cfg, params, stats, x, jnp.float32)
    model = create_model(cfg.model, "cpu")
    load_jax_variables(model, params, stats)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for k in OUTPUTS:
        got = getattr(out, k)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want[k], atol=1e-3, rtol=1e-3,
                                   err_msg=k)


def test_bf16_model_matches_jax(setup):
    cfg, params, stats, x = setup
    want = _jax_outputs(cfg, params, stats, x, jnp.bfloat16)
    model = create_model(cfg.model, "cpu")
    load_jax_variables(model, params, stats)
    model = model.to(torch.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        out = model(xb)
    for k in OUTPUTS:
        got = getattr(out, k)
        assert got.dtype == torch.bfloat16
        diff = np.abs(got.float().numpy() - want[k])
        scale = np.abs(want[k]).max()
        assert diff.max() <= 0.04 * scale, (k, diff.max(), scale)
        assert diff.mean() <= 0.02 * scale, (k, diff.mean(), scale)


def test_state_dict_loads_strict_with_no_missing_or_unexpected_keys(setup):
    cfg, params, stats, _ = setup
    model = create_model(cfg.model, "cpu")
    sd = export_basinet(params, stats, stage_sizes=model.stage_sizes)
    res = model.load_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
        strict=False)
    assert not res.missing_keys and not res.unexpected_keys, res
    assert set(sd) == set(model.state_dict())


def test_channels_last_outputs_are_free_nhwc_views(setup):
    cfg, _, _, x = setup
    model = create_model(cfg.model, "cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for k in OUTPUTS:
        assert getattr(out, k).is_contiguous(), k


def test_random_init_is_seeded_and_device_independent(setup):
    cfg = setup[0]
    a = create_model(cfg.model, "cpu", generator=torch.Generator().manual_seed(3))
    b = create_model(cfg.model, "cpu", generator=torch.Generator().manual_seed(3))
    c = create_model(cfg.model, "cpu", generator=torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["backbone.conv1.weight"],
                           sc["backbone.conv1.weight"])
    assert float(sa["instance.score.bias"][0]) == pytest.approx(-4.595)


def test_roi_checkpoint_is_refused(setup):
    """A tree with no instance head is refused; a roi checkpoint (its
    ``roi_box`` and ``roi_mask`` heads) is refused by a kernels model and
    loads into a roi model."""
    cfg, params, stats, _ = setup
    no_head = {k: v for k, v in params.items() if k != "instance"}
    with pytest.raises(ValueError, match="instance"):
        load_jax_variables(create_model(cfg.model, "cpu"), no_head, stats)
    rcfg = dataclasses.replace(cfg.model, instance_mechanism="roi",
                               roi_resolution=8, roi_top_k=16)
    roi_params, roi_stats = init_model(jax_create_model(rcfg), 64)
    roi_params = jax.tree.map(np.array, roi_params)
    with pytest.raises(RuntimeError, match="roi_box"):
        load_jax_variables(create_model(cfg.model, "cpu"), roi_params,
                           jax.tree.map(np.array, roi_stats))
    load_jax_variables(create_model(rcfg, "cpu"), roi_params,
                       jax.tree.map(np.array, roi_stats))


@pytest.mark.parametrize("overrides", [
    ["model.instance_mechanism=roi", "infer.tta=hflip"],
    ["model.instance_mechanism=connected"],
    ["model.refine=true"],
    ["model.backbone=vgg16"],
    ["infer.tta=hflip"],
    ["infer.tta_scales=0.75"],
    ["infer.dtype=int8"],
    ["parallel.num_devices=2"],
])
def test_unported_settings_raise_not_implemented(overrides):
    cfg = get_config("val_v4-8_ap", overrides)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        Inferencer(cfg, device="cpu")


@pytest.mark.parametrize("kwargs", [{"aot_path": "x"}, {"checkpoint": "x"}])
def test_unported_predictor_sources_raise_not_implemented(kwargs, tmp_path,
                                                          monkeypatch):
    """Both predictor sources are ported now (checkpoints, and artifacts
    through ``aot.load_serving``): one that is not there raises
    ``FileNotFoundError``."""
    monkeypatch.chdir(tmp_path)
    match = "no checkpoint" if "checkpoint" in kwargs else "x"
    with pytest.raises(FileNotFoundError, match=match):
        BatchedPredictor(tiny_config(), device="cpu", **kwargs)
