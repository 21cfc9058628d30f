"""The port's fused BatchNorm against the JAX package's, on the CPU.

On the CPU ``channel_moments`` and ``channel_dual_sums`` run their plain
versions; these are held against the JAX ``*_reference`` functions and
against the Pallas kernels in interpret mode (as ``tests/test_fused_bn.py``
runs them), including a shape whose rows do not block (the JAX kernel then
takes its reference). ``FusedBatchNorm`` (modes ``full`` and ``stats``) is
held against the JAX ``FusedBatchNorm`` on the same numpy inputs, NHWC on
the JAX side and NCHW in ``channels_last`` memory on the port's. Tolerances:

* the sums: ``rtol=5e-5, atol=1e-4`` (f32 sums of up to 512 terms in
  another order);
* the train forward and the running statistics after one update: 2e-5
  (running mean ``atol=1e-6``);
* the gradients of x, scale and bias through ``sum(tanh(y) * w)``:
  ``rtol=3e-4, atol=3e-5``;
* eval mode: bitwise equal to ``bn_impl="xla"``; ``gradcheck`` in float64;
* the BatchNorm's per-channel terms (the kernels' epilogues, whose plain
  versions run here) against ``_bn_fwd_math``, ``batch_moments`` and
  ``_bn_bwd``: in f32 ``rtol=atol=2e-5`` (means, var, inv, a, b) and
  ``rtol=3e-4, atol=1e-4`` (dscale, dbias, dx: sums of up to 512 terms
  that cancel); in float64 ``1e-10``, both sides in float64 (the JAX
  functions read ``jnp.float32`` as float64 for the test, as in
  ``test_torch_train.py``);
* the elementwise passes on those terms (``bn_apply``,
  ``bn_input_gradient``, whose plain versions run here) against y of
  ``_bn_fwd_math`` and dx of ``_bn_bwd``, with the tolerances of the
  terms they apply.

Both sides take the one-pass variance E[x^2] - E[x]^2 that the TPU kernel
feeds. In f32 it cancels where a channel's mean dwarfs its spread, and the
two sides then differ by how their sums round, not by what they compute;
so the f32 inputs here have mean 1 and spread 3 (``randn * 3 + 1``), where
the cancellation costs nothing measurable.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basi_tpu.models.basi import create_model as jax_create_model
from basi_tpu.models import norm as jax_norm
from basi_tpu.models.norm import FusedBatchNorm as JaxFusedBatchNorm
from basi_tpu.ops.pallas import bn_stats as jax_bn
from basi_tpu_torch.convert import load_jax_variables, to_jax_variables
from basi_tpu_torch.kernels import bn_apply as A
from basi_tpu_torch.kernels import bn_stats as K
from basi_tpu_torch.models import norm as N
from basi_tpu_torch.models.basi import create_model
from basi_tpu_torch.models.layers import BatchNorm2d, update_running_stats

from helpers import tiny_config
from test_torch_model import jax_variables
from test_torch_train import _Float32As64

# (N, H, W, C); rows = N*H*W = 15 in the last does not block in JAX
SHAPES = [(2, 16, 16, 128), (2, 8, 8, 16), (1, 3, 5, 24)]


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX and a torch NHWC array of ``dtype``."""
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)


def _close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_channel_moments_plain_matches_jax(shape, dtype):
    xj, xt = _pair(np.random.RandomState(1).randn(*shape).astype(np.float32),
                   dtype)
    n0 = K.channel_moments.launches
    got = K.channel_moments(xt)
    assert K.channel_moments.launches == n0  # the CPU runs no kernel
    _close(got, jax_bn.channel_moments_reference(xj))
    _close(got, jax_bn.channel_moments(xj, True))  # interpret mode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_channel_dual_sums_plain_matches_jax(shape, dtype):
    rng = np.random.RandomState(2)
    gj, gt = _pair(rng.randn(*shape).astype(np.float32), dtype)
    xj, xt = _pair(rng.randn(*shape).astype(np.float32), dtype)
    n0 = K.channel_dual_sums.launches
    got = K.channel_dual_sums(gt, xt)
    assert K.channel_dual_sums.launches == n0
    _close(got, jax_bn.channel_dual_sums_reference(gj, xj))
    _close(got, jax_bn.channel_dual_sums(gj, xj, True))


def test_bn_stats_plain_takes_the_channels_last_view_and_checks_shapes():
    x = torch.randn(2, 5, 6, 7)
    view = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    for a, b in zip(K.channel_moments(view),
                    K.channel_moments(x.permute(0, 2, 3, 1))):
        # the layout changes only the order of the f32 sums
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError, match="NHWC"):
        K.channel_moments(torch.zeros(3, 4))
    with pytest.raises(ValueError, match="does not match"):
        K.channel_dual_sums(torch.zeros(1, 2, 2, 8),
                            torch.zeros(1, 2, 2, 8, dtype=torch.float64))
    # (groups per block, slabs, rows per slab) for at most 660 blocks (132
    # SMs x 5): never more, so no block waits for a free SM
    assert K.launch_layout(16 * 65536, 64, 2, 660) == (8, 660, 1589)
    assert K.launch_layout(16 * 4096, 512, 2, 396) == (8, 49, 1338)
    assert K.launch_layout(16 * 256, 2048, 2, 660) == (8, 16, 256)
    assert K.launch_layout(15, 24, 4, 660) == (4, 1, 15)


# --- the BatchNorm's per-channel terms -------------------------------------------

TERM_TOL = {"float32": (dict(rtol=2e-5, atol=2e-5), dict(rtol=3e-4, atol=1e-4)),
            "float64": (dict(rtol=1e-10, atol=1e-10),) * 2}


def _terms_case(shape, dtype: str, monkeypatch):
    """x (mean 1, spread 3), g, scale and bias as numpy arrays of ``dtype``;
    in float64 the JAX BN functions compute in float64."""
    if dtype == "float64":
        monkeypatch.setattr(jax_norm, "jnp", _Float32As64())
        monkeypatch.setattr(jax_bn, "jnp", _Float32As64())
    rng = np.random.RandomState(8)
    c = shape[-1]
    return [a.astype(dtype) for a in (
        rng.randn(*shape) * 3 + 1, rng.randn(*shape), rng.rand(c) + 0.5,
        rng.randn(c))]


def _close_terms(got, want, tol, dtype):
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bn_forward_terms_plain_matches_jax(shape, dtype, monkeypatch):
    x, _, scale, bias = _terms_case(shape, dtype, monkeypatch)
    with jax.enable_x64(dtype == "float64"):
        sj = jnp.asarray(scale)
        _, mean, var, inv = jax_norm._bn_fwd_math(
            jnp.asarray(x), sj, jnp.asarray(bias), None, 1e-5)
        a = sj * inv
        want = (mean, var, inv, a, jnp.asarray(bias) - mean * a)
    n0 = K.channel_moments.launches
    got = K.bn_forward_terms(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(bias), 1e-5)
    assert K.channel_moments.launches == n0  # the CPU runs no kernel
    _close_terms(got, want, TERM_TOL[dtype][0], dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", SHAPES)
def test_channel_means_plain_matches_jax(shape, dtype, monkeypatch):
    x = _terms_case(shape, dtype, monkeypatch)[0]
    with jax.enable_x64(dtype == "float64"):
        want = jax_norm.batch_moments(jnp.asarray(x))
    _close_terms(K.channel_means(torch.from_numpy(x)), want,
                 TERM_TOL[dtype][0], dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bn_backward_terms_plain_matches_jax(shape, dtype, monkeypatch):
    """dscale and dbias from the terms, and dx from them through the
    module's elementwise pass, against ``_bn_bwd``."""
    x, gy, scale, bias = _terms_case(shape, dtype, monkeypatch)
    with jax.enable_x64(dtype == "float64"):
        xj, sj = jnp.asarray(x), jnp.asarray(scale)
        _, mean, _, inv = jax_norm._bn_fwd_math(xj, sj, jnp.asarray(bias),
                                                None, 1e-5)
        dx_j, dscale_j, dbias_j = jax_norm._bn_bwd(
            None, 1e-5, (xj, sj, mean, inv), (jnp.asarray(gy), None, None))
    mean, inv = (torch.from_numpy(np.array(v)) for v in (mean, inv))
    x_t, gy_t = torch.from_numpy(x), torch.from_numpy(gy)
    n0 = K.channel_dual_sums.launches
    dscale, dbias, a, a_mg, a_inv_mgxn = K.bn_backward_terms(
        gy_t, x_t, torch.from_numpy(scale), mean, inv)
    assert K.channel_dual_sums.launches == n0
    dx = A.bn_input_gradient(gy_t.permute(0, 3, 1, 2),
                             x_t.permute(0, 3, 1, 2), mean, a, a_mg,
                             a_inv_mgxn).permute(0, 2, 3, 1)
    _close_terms((dscale, dbias, dx), (dscale_j, dbias_j, dx_j),
                 TERM_TOL[dtype][1], dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bn_apply_plain_matches_jax(shape, dtype, monkeypatch):
    """``bn_apply`` (its plain version on the CPU) on the terms of
    ``bn_forward_terms``, channels_last, against y of ``_bn_fwd_math``."""
    x, _, scale, bias = _terms_case(shape, dtype, monkeypatch)
    with jax.enable_x64(dtype == "float64"):
        y_j = jax_norm._bn_fwd_math(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias), None, 1e-5)[0]
    _, _, _, a, b = K.bn_forward_terms(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        1e-5)
    xn = _nchw(x)
    n0 = A.bn_apply.launches
    y = A.bn_apply(xn, a, b)
    assert A.bn_apply.launches == n0  # the CPU runs no kernel
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, A.bn_apply_reference(xn, a, b))
    _close_terms((y.permute(0, 2, 3, 1),), (y_j,), TERM_TOL[dtype][0], dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bn_input_gradient_plain_matches_jax(shape, dtype, monkeypatch):
    """``bn_input_gradient`` (its plain version on the CPU) on the terms
    of ``bn_backward_terms``, channels_last, against dx of ``_bn_bwd``;
    the gradient it reads is left as it was."""
    x, gy, scale, bias = _terms_case(shape, dtype, monkeypatch)
    with jax.enable_x64(dtype == "float64"):
        xj, sj = jnp.asarray(x), jnp.asarray(scale)
        _, mean, _, inv = jax_norm._bn_fwd_math(xj, sj, jnp.asarray(bias),
                                                None, 1e-5)
        dx_j = jax_norm._bn_bwd(None, 1e-5, (xj, sj, mean, inv),
                                (jnp.asarray(gy), None, None))[0]
    mean, inv = (torch.from_numpy(np.array(v)) for v in (mean, inv))
    terms = K.bn_backward_terms(torch.from_numpy(gy), torch.from_numpy(x),
                                torch.from_numpy(scale), mean, inv)[2:]
    gn, xn = _nchw(gy), _nchw(x)
    g0 = gn.clone()
    n0 = A.bn_input_gradient.launches
    dx = A.bn_input_gradient(gn, xn, mean, *terms)
    assert A.bn_input_gradient.launches == n0
    assert torch.equal(gn, g0)
    assert dx.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(dx, A.bn_input_gradient_reference(gn, xn, mean, *terms))
    _close_terms((dx.permute(0, 2, 3, 1),), (dx_j,), TERM_TOL[dtype][1], dtype)


def test_bn_apply_layout_and_checks():
    """The kernels' launch layout (threads along C, row lanes, blocks over
    rows) for at most 1056 blocks (132 SMs x 8), and the wrappers' shape
    checks, which hold on the CPU too."""
    # bf16 vectors of 8 channels: the stem at batch 64, layer4's widest,
    # f32 vectors of 4 at 2048 channels (two tiles), 2050 channels by
    # scalars (nine even tiles), 24 channels of 15 rows (one block)
    assert A.launch_layout(64 * 65536, 64, 8, 1056) == (8, 32, 1056)
    assert A.launch_layout(64 * 256, 2048, 8, 1056) == (256, 1, 1056)
    assert A.launch_layout(10, 2048, 4, 1056) == (256, 1, 10)
    assert A.launch_layout(5, 2050, 1, 1056) == (228, 1, 5)
    assert A.launch_layout(15, 24, 8, 1056) == (3, 85, 1)
    x = torch.zeros(2, 8, 3, 3)
    with pytest.raises(ValueError, match="NCHW"):
        A.bn_apply(torch.zeros(8, 3, 3), torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match="does not match"):
        A.bn_input_gradient(x.double(), x, *[torch.zeros(8)] * 4)
    with pytest.raises(ValueError, match="does not match"):
        A.bn_input_gradient(x[:1], x, *[torch.zeros(8)] * 4)


# --- the module ------------------------------------------------------------------

C_BN = 32


def _jax_bn(mode: str, use_running_average: bool = False):
    return JaxFusedBatchNorm(use_running_average=use_running_average,
                             momentum=0.9, epsilon=1e-5, dtype=jnp.float32,
                             param_dtype=jnp.float32, mode=mode)


def _port_bn(mode: str, params=None) -> N.FusedBatchNorm:
    bn = N.FusedBatchNorm(C_BN, eps=1e-5, mode=mode)
    if params is not None:
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(np.array(params["scale"])))
            bn.bias.copy_(torch.from_numpy(np.array(params["bias"])))
    return bn


def _nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW torch in channels_last memory (a copy)."""
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _case(seed: int):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, 8, 8, C_BN) * 3 + 1).astype(np.float32)
    w = rng.randn(4, 8, 8, C_BN).astype(np.float32)
    params = {"scale": jnp.asarray(rng.rand(C_BN) + 0.5, jnp.float32),
              "bias": jnp.asarray(rng.randn(C_BN), jnp.float32)}
    stats = {"mean": jnp.zeros((C_BN,)), "var": jnp.ones((C_BN,))}
    return x, w, params, stats


@pytest.mark.parametrize("mode", ["full", "stats"])
def test_train_forward_and_running_stats_match_jax(mode):
    x, _, params, stats = _case(3)
    y_j, mut = _jax_bn(mode).apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x), mutable=["batch_stats"])
    bn = _port_bn(mode, params)
    y = bn(_nchw(x), train=True)
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y_j), rtol=2e-5, atol=2e-5)
    update_running_stats([bn])
    assert bn.batch_stats is None
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["full", "stats"])
def test_eval_forward_is_bitwise_xla(mode):
    rng = np.random.RandomState(4)
    x = _nchw(rng.randn(2, 8, 8, C_BN).astype(np.float32))
    fused, xla = _port_bn(mode), BatchNorm2d(C_BN, eps=1e-5)
    state = {"weight": rng.rand(C_BN), "bias": rng.randn(C_BN),
             "running_mean": rng.randn(C_BN), "running_var": rng.rand(C_BN) + .5}
    for bn in (fused, xla):
        bn.load_state_dict({**{k: torch.tensor(v, dtype=torch.float32)
                               for k, v in state.items()},
                            "num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        torch.testing.assert_close(fused(x), xla(x), rtol=0, atol=0)
        torch.testing.assert_close(fused(x, train=False), xla(x), rtol=0,
                                   atol=0)
    assert fused.batch_stats is None


@pytest.mark.parametrize("mode", ["full", "stats"])
def test_train_gradients_match_jax(mode):
    x0, w, params, stats = _case(5)

    def loss(p, x):
        y, _ = _jax_bn(mode).apply({"params": p, "batch_stats": stats}, x,
                                   mutable=["batch_stats"])
        return jnp.sum(jnp.tanh(y) * w)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x0))
    bn = _port_bn(mode, params)
    x = _nchw(x0).requires_grad_()
    (torch.tanh(bn(x, train=True)) * _nchw(w)).sum().backward()
    tol = dict(rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(x.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx), **tol)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               np.asarray(gp["scale"]), **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]),
                               **tol)


def test_bn_train_apply_gradcheck_float64():
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(3, 4, 5, 2)).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    scale = torch.from_numpy(rng.rand(4) + 0.5).requires_grad_()
    bias = torch.from_numpy(rng.randn(4)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, s, b: N.bn_train_apply(x, s, b, 1e-5)[0], (x, scale, bias))
    y, mean, var = N.bn_train_apply(x, scale, bias, 1e-5)
    assert y.dtype == mean.dtype == var.dtype == torch.float64
    assert not mean.requires_grad and not var.requires_grad


def test_batch_moments_gradcheck_float64():
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 3, 4, 5)
                         ).requires_grad_()
    assert torch.autograd.gradcheck(N.batch_moments, (x,))


def test_make_batch_norm():
    assert type(N.make_batch_norm("xla", 8)) is BatchNorm2d
    for impl, mode in (("fused", "full"), ("stats", "stats")):
        bn = N.make_batch_norm(impl, 8, eps=1e-3)
        assert isinstance(bn, N.FusedBatchNorm) and bn.mode == mode
        assert bn.eps == 1e-3 and bn.stats_hold_var
        assert set(bn.state_dict()) == set(BatchNorm2d(8).state_dict())
    with pytest.raises(ValueError, match="bn_impl"):
        N.make_batch_norm("nope", 8)
    with pytest.raises(ValueError, match="mode"):
        N.FusedBatchNorm(8, mode="nope")


# --- the model ------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["fused", "stats"])
def test_train_mode_model_matches_jax(impl):
    """The tiny model with ``model.bn_impl`` fused or stats against the JAX
    model with the same setting, same variables: train-mode outputs and the
    updated BN running statistics within 1e-4 (as for ``xla`` in
    ``test_torch_train.py``); every trunk BN is a ``FusedBatchNorm`` and
    the state dict keeps the names of ``xla``."""
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, bn_impl=impl))
    params, stats = jax_variables(cfg)
    x = np.random.RandomState(1).randn(3, 64, 64, 3).astype(np.float32)
    want, mutated = jax_create_model(cfg.model).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
        with_candidates=False, mutable=["batch_stats"])
    model = create_model(cfg.model, "cpu", train=True)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert bns and all(isinstance(m, N.FusedBatchNorm) for m in bns)
    assert {m.mode for m in bns} == {"full" if impl == "fused" else "stats"}
    xla = dataclasses.replace(cfg.model, bn_impl="xla")
    assert set(model.state_dict()) == set(
        create_model(xla, "cpu").state_dict())
    load_jax_variables(model, params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in ("saliency_logits", "cell_scores", "cell_kernels", "mask_feats"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-4,
                                   rtol=0, err_msg=k)
    got_stats = to_jax_variables(model)[1]
    for a, b in zip(jax.tree.leaves(got_stats),
                    jax.tree.leaves(mutated["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)
