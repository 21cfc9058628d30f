"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each kernel's public function runs its plain PyTorch version, so
these tests hold that plain version against the JAX kernel run in interpret
mode, on the same numpy inputs. Tolerances:

* ``upsample_int``: at most 1 bf16 ulp of the JAX value. Weights and the
  f32 blend are equal; the JAX kernel sums column pass then row pass, the
  port's plain version row pass then column pass, so the f32 sums may round
  apart by an f32 ulp and then, rarely, to neighbouring bf16 values.
* ``upsample_sigmoid``: ``atol=1e-5`` on f32 probabilities (both are f32
  interpolation at full precision; only the summation order differs).
* ``resize_bilinear``'s einsum path: f32 ``atol=1e-6``; bf16 inputs at 1
  bf16 ulp (both round an f32 result once).

``test_torch_gpu.py`` holds the CUDA kernels against these plain versions
on the card.
"""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basi_tpu.ops import resize as jax_resize
from basi_tpu.ops.pallas.upsample_int import upsample_int as jax_upsample_int
from basi_tpu.ops.pallas.upsample_sigmoid import (
    upsample_sigmoid as jax_upsample_sigmoid,
)
from basi_tpu_torch.kernels import _build
from basi_tpu_torch.kernels import upsample_int as U
from basi_tpu_torch.kernels import upsample_sigmoid as S
from basi_tpu_torch.ops import resize as R


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at each value (8 significant bits)."""
    a = np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def assert_within_bf16_ulp(got: np.ndarray, want: np.ndarray, msg=""):
    got = got.astype(np.float64)
    want = want.astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    bad = np.abs(got - want) > bf16_ulp(want)
    assert not bad.any(), (
        f"{msg}: {bad.sum()} values beyond 1 bf16 ulp, max diff "
        f"{np.abs(got - want).max()}")


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX and a torch array of ``dtype``."""
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("shape,f", [
    ((2, 8, 8, 8), 2), ((1, 6, 10, 64), 2), ((2, 4, 4, 8), 4),
    ((1, 4, 6, 64), 4), ((1, 3, 4, 8), 8), ((1, 4, 4, 64), 8),
])
def test_upsample_int_reference_matches_jax_kernel(rng, shape, f):
    xj, xt = _pair(rng.randn(*shape).astype(np.float32), "bfloat16")
    want = np.asarray(jax_upsample_int(xj, f, True), np.float32)
    got = U.upsample_int_reference(xt, f)
    assert got.dtype == torch.bfloat16
    assert_within_bf16_ulp(got.float().numpy(), want, f"{shape} x{f}")
    # On a CPU tensor the public function is the plain version.
    torch.testing.assert_close(U.upsample_int(xt, f), got, rtol=0, atol=0)


@pytest.mark.parametrize("bad", [
    lambda: U.upsample_int(torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16), 3),
    lambda: U.upsample_int(torch.zeros(1, 4, 4, 12, dtype=torch.bfloat16), 2),
    lambda: U.upsample_int(torch.zeros(1, 4, 4, 8), 2),
    lambda: U.upsample_int(torch.zeros(4, 4, 8, dtype=torch.bfloat16), 2),
])
def test_upsample_int_rejects_what_the_kernel_cannot_take(bad):
    with pytest.raises(ValueError):
        bad()


@pytest.mark.parametrize("shape,out_hw,dtype", [
    ((3, 16, 16), (64, 64), "float32"),
    ((2, 16, 16), (64, 64), "bfloat16"),
    ((2, 4, 8, 8), (32, 32), "float32"),
    ((2, 3, 12, 10), (40, 25), "float32"),
    ((3, 8, 8), (8, 8), "float32"),
    ((2, 3, 40, 40), (16, 24), "float32"),
    ((3, 7, 9), (20, 30), "bfloat16"),
])
def test_upsample_sigmoid_reference_matches_jax_kernel(rng, shape, out_hw,
                                                       dtype):
    xj, xt = _pair(rng.randn(*shape).astype(np.float32) * 3, dtype)
    want = np.asarray(jax_upsample_sigmoid(xj, out_hw, interpret=True))
    got = S.upsample_sigmoid(xt, out_hw)  # CPU: the plain version
    assert got.dtype == torch.float32
    assert tuple(got.shape) == shape[:-2] + out_hw
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if out_hw != shape[-2:]:
        torch.testing.assert_close(
            S.upsample_sigmoid_reference(xt, out_hw), got, rtol=0, atol=0)


@pytest.mark.parametrize("shape,out_hw,align", [
    ((2, 16, 16, 64), (32, 32), False),
    ((2, 16, 16, 64), (32, 32), True),
    ((2, 16, 16, 64), (32, 64), False),
    ((2, 16, 16, 64), (48, 48), False),
    ((2, 16, 16, 64), (8, 8), False),
    ((2, 16, 16, 3), (32, 32), False),
])
def test_kernel_route_predicate_matches_jax(shape, out_hw, align,
                                            monkeypatch):
    """The kernel route claims exactly the resizes the JAX package sends to
    its Pallas kernel (its backend check forced on), and f32 never."""
    monkeypatch.setattr(jax_resize, "pallas_upsample", True)
    oh, ow = out_hw
    want = jax_resize._use_pallas_upsample(
        jnp.zeros(shape, jnp.bfloat16), oh, ow, align)
    xt = torch.zeros(shape, dtype=torch.bfloat16)
    f = R.kernel_upsample_factor(xt, oh, ow, align)
    assert bool(f) == want
    if f:
        assert f == oh // shape[1]
    assert not R.kernel_upsample_factor(xt.float(), oh, ow, align)


@pytest.mark.parametrize("shape,out_hw,align,dtype", [
    ((2, 8, 8, 16), (16, 16), False, "float32"),
    ((2, 8, 12, 4), (20, 7), False, "float32"),
    ((1, 8, 8, 5), (17, 3), True, "float32"),
    ((8, 8, 3), (16, 16), False, "float32"),
    ((8, 8), (32, 32), False, "float32"),
    ((2, 16, 16, 8), (4, 4), False, "float32"),
    ((2, 8, 8, 16), (16, 16), False, "bfloat16"),
    ((2, 16, 16, 10), (4, 4), False, "bfloat16"),
])
def test_resize_bilinear_matches_jax(rng, shape, out_hw, align, dtype):
    xj, xt = _pair(rng.randn(*shape).astype(np.float32), dtype)
    want = np.asarray(jax_resize.resize_bilinear(xj, out_hw, align), np.float32)
    got = R.resize_bilinear(xt, out_hw, align)
    assert got.dtype == xt.dtype
    if dtype == "bfloat16":
        assert_within_bf16_ulp(got.float().numpy(), want, str(shape))
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_cpu_tensors_never_reach_the_kernel_build(rng, monkeypatch):
    """CPU tensors take the plain versions: nothing builds or loads the CUDA
    library, and no launch is counted."""
    def refuse():
        raise AssertionError("CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "library", refuse)
    before = (U.upsample_int.launches, S.upsample_sigmoid.launches)
    x = torch.from_numpy(rng.randn(2, 8, 8, 16).astype(np.float32))
    U.upsample_int(x.to(torch.bfloat16), 4)
    R.resize_bilinear(x.to(torch.bfloat16), (16, 16))
    R.resize_bilinear(x, (16, 16))
    S.upsample_sigmoid(x[..., 0], (32, 32))
    S.upsample_sigmoid(x[..., 0].to(torch.bfloat16), (32, 32))
    assert (U.upsample_int.launches, S.upsample_sigmoid.launches) == before


# --- normalize_and_flip ------------------------------------------------------

from basi_tpu.ops.pallas import normalize_aug as jax_norm  # noqa: E402
from basi_tpu_torch.kernels import normalize_aug as N  # noqa: E402

_NORM_DTYPES = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("shape,flags", [
    ((4, 8, 16, 3), (0, 1, 1, 0)),
    ((3, 5, 7, 3), (1, 0, 1)),
    ((2, 16, 32, 3), (1, 1)),
    ((1, 4, 4, 3), (0,)),
    ((3, 4, 48, 3), (1, 0, 1)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_and_flip_reference_matches_jax(rng, shape, flags, dtype):
    """The port's plain version against the JAX kernel (interpret mode) and
    the JAX reference, mixed flip flags. f32: within 2e-6 (the kernel's
    ``x*(1/255)*(1/std) + (-mean/std)`` against the reference's
    ``(x/255 - mean)/std``: a few f32 ulps of values up to ~2.7; the port
    and the JAX kernel do the same arithmetic). bf16: within 1 ulp (one
    rounding of those f32 values)."""
    imgs = (rng.rand(*shape) * 256).astype(np.uint8)
    flip = np.asarray(flags, np.int32)
    jdt, tdt = _NORM_DTYPES[dtype]
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    got = N.normalize_and_flip_reference(torch.from_numpy(imgs),
                                         torch.from_numpy(flip), mean, std, tdt)
    assert got.dtype == tdt and tuple(got.shape) == shape
    got = got.float().numpy()
    for want in (jax_norm.normalize_and_flip(jnp.asarray(imgs), jnp.asarray(flip),
                                             mean, std, interpret=True,
                                             out_dtype=jdt),
                 jax_norm.normalize_and_flip_reference(
                     jnp.asarray(imgs), jnp.asarray(flip), mean, std,
                     out_dtype=jdt)):
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
        else:
            assert_within_bf16_ulp(got, want, f"{shape} {flags}")
    # On a CPU tensor the public function is the plain version.
    pub = N.normalize_and_flip(torch.from_numpy(imgs), torch.from_numpy(flip),
                               mean, std, tdt)
    np.testing.assert_array_equal(pub.float().numpy(), got)


@pytest.mark.parametrize("bad", [
    lambda: N.normalize_and_flip(torch.zeros(2, 4, 4, 12, dtype=torch.uint8),
                                 torch.zeros(2, dtype=torch.int32)),
    lambda: N.normalize_and_flip(torch.zeros(2, 4, 4, 3),
                                 torch.zeros(2, dtype=torch.int32)),
    lambda: N.normalize_and_flip(torch.zeros(2, 4, 4, 3, dtype=torch.uint8),
                                 torch.zeros(3, dtype=torch.int32)),
    lambda: N.normalize_and_flip(torch.zeros(2, 4, 4, 3, dtype=torch.uint8),
                                 torch.zeros(2, dtype=torch.int32),
                                 out_dtype=torch.float16),
])
def test_normalize_and_flip_rejects_what_the_kernel_cannot_take(bad):
    """The s2d-packed (C=12) feed, non-uint8 images, a flag count that is
    not the batch and an output dtype other than bf16/f32 raise."""
    with pytest.raises(ValueError):
        bad()


# --- upsample_int backward ---------------------------------------------------

@pytest.mark.parametrize("shape,f", [
    ((2, 4, 4, 8), 2), ((1, 5, 3, 64), 2), ((2, 3, 4, 8), 4),
    ((1, 4, 4, 64), 4), ((2, 2, 3, 8), 8), ((1, 3, 2, 64), 8),
    ((1, 1, 1, 8), 4),
])
def test_upsample_int_backward_reference_matches_jax_vjp(rng, shape, f):
    """``upsample_int_backward_reference`` against ``jax.vjp`` of the JAX
    kernel (interpret mode), whose custom VJP is the transposed-matrix
    einsum: within 1 bf16 ulp (the same f32 sums, in another order, then
    one bf16 rounding)."""
    import jax

    n, h, w, c = shape
    x = jnp.asarray(rng.randn(*shape).astype(np.float32), jnp.bfloat16)
    g_np = rng.randn(n, f * h, f * w, c).astype(np.float32)
    gj, gt = _pair(g_np, "bfloat16")
    _, vjp = jax.vjp(lambda v: jax_upsample_int(v, f, True), x)
    want = np.asarray(vjp(gj)[0], np.float32)
    got = U.upsample_int_backward_reference(gt, f)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    assert_within_bf16_ulp(got.float().numpy(), want, f"{shape} x{f}")
    torch.testing.assert_close(U.upsample_int_backward(gt, f), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape,f", [((2, 4, 4, 16), 2), ((1, 3, 5, 8), 4),
                                     ((1, 2, 2, 64), 8)])
def test_upsample_int_autograd_on_cpu_matches_plain_autograd(rng, shape, f):
    """The ``autograd.Function`` on a CPU tensor (plain forward, plain
    adjoint) against autograd of the plain forward (einsum): forward equal,
    gradient within 1 bf16 ulp (autograd runs the transposed einsums in
    its own order)."""
    n, h, w, c = shape
    x0 = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.randn(n, f * h, f * w, c).astype(np.float32)).to(
        torch.bfloat16)
    x1, x2 = x0.clone().requires_grad_(), x0.clone().requires_grad_()
    y1 = U.upsample_int(x1, f)
    y2 = U.upsample_int_reference(x2, f)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    (gx1,) = torch.autograd.grad(y1, x1, g)
    (gx2,) = torch.autograd.grad(y2, x2, g)
    assert gx1.dtype == torch.bfloat16
    assert_within_bf16_ulp(gx1.float().numpy(), gx2.float().numpy(), str(shape))


def test_upsample_int_backward_rejects_bad_cotangents():
    with pytest.raises(ValueError):
        U.upsample_int_backward(torch.zeros(1, 8, 8, 8), 2)  # f32
    with pytest.raises(ValueError):
        U.upsample_int_backward(torch.zeros(1, 6, 8, 8, dtype=torch.bfloat16), 4)
    with pytest.raises(ValueError):
        U.upsample_int_backward(torch.zeros(1, 8, 8, 12, dtype=torch.bfloat16), 2)


def test_cpu_training_tensors_never_reach_the_kernel_build(rng, monkeypatch):
    """The new kernels' CPU paths (normalize, upsample backward through
    autograd) build nothing and count no launch."""
    def refuse():
        raise AssertionError("CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "library", refuse)
    before = (N.normalize_and_flip.launches, U.upsample_int_backward.launches)
    N.normalize_and_flip(torch.zeros(2, 4, 4, 3, dtype=torch.uint8),
                         torch.ones(2, dtype=torch.int32))
    x = torch.from_numpy(rng.randn(1, 4, 4, 8).astype(np.float32)).to(
        torch.bfloat16).requires_grad_()
    U.upsample_int(x, 2).float().sum().backward()
    assert x.grad is not None
    assert (N.normalize_and_flip.launches,
            U.upsample_int_backward.launches) == before
