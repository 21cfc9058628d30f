"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``gpu`` and skips where no CUDA device is present. The
file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu

Tolerances: ``upsample_int`` within 1 bf16 ulp of the plain version (the
kernel sums taps with FMAs, the plain version sums two einsums, so the f32
sums may round apart by an f32 ulp before the one bf16 rounding); its
backward within 1 bf16 ulp plus 2^-20 of the largest value (up to 4f^2 f32
terms, and where they cancel the sums' rounding outweighs an ulp of the
small result); ``upsample_sigmoid`` ``atol=1e-5`` on f32 probabilities;
``normalize_and_flip`` bit-exact (the same f32 operations in the same
order, no FMA, one rounding). TF32 is off, so the plain versions' f32
matmuls run in full f32.
"""

import numpy as np
import pytest
import torch

from basi_tpu_torch.kernels import normalize_aug as N
from basi_tpu_torch.kernels import upsample_int as U
from basi_tpu_torch.kernels import upsample_sigmoid as S
from basi_tpu_torch.ops import resize as R


def assert_within_bf16_ulp(got: torch.Tensor, want: torch.Tensor, msg=""):
    got = got.double().cpu()
    want = want.double().cpu()
    assert got.shape == want.shape, (got.shape, want.shape)
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    bad = (got - want).abs() > ulp
    assert not bad.any(), (
        f"{msg}: {int(bad.sum())} values beyond 1 bf16 ulp, max diff "
        f"{float((got - want).abs().max())}")


def assert_within_bf16_sum(got: torch.Tensor, want: torch.Tensor, msg=""):
    """1 bf16 ulp of ``want`` plus 2^-20 of its largest magnitude."""
    got = got.double().cpu()
    want = want.double().cpu()
    assert got.shape == want.shape, (got.shape, want.shape)
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    bad = (got - want).abs() > ulp + 2.0 ** -20 * float(want.abs().max())
    assert not bad.any(), (
        f"{msg}: {int(bad.sum())} values beyond the bound, max diff "
        f"{float((got - want).abs().max())}")


@pytest.fixture()
def rng():
    return np.random.RandomState(0)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,f", [
    ((2, 8, 8, 8), 2), ((1, 7, 5, 64), 2), ((2, 4, 6, 16), 4),
    ((1, 3, 4, 8), 8), ((8, 16, 16, 256), 2), ((8, 16, 16, 128), 8),
])
def test_gpu_upsample_int_kernel_matches_plain(rng, shape, f):
    dev = _cuda()
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        dev, torch.bfloat16)
    n0 = U.upsample_int.launches
    got = U.upsample_int(x, f)
    torch.cuda.synchronize()
    assert U.upsample_int.launches == n0 + 1
    want = U.upsample_int_reference(x, f)
    assert_within_bf16_ulp(got, want, f"{shape} x{f}")
    # the channels_last NHWC view the model hands it
    xcl = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(U.upsample_int(xcl.permute(0, 2, 3, 1), f),
                               got, rtol=0, atol=0)


@pytest.mark.gpu
def test_gpu_upsample_int_refuses_strided_input():
    dev = _cuda()
    x = torch.zeros(1, 8, 8, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        U.upsample_int(x[:, :, ::2], 2)
    with pytest.raises(ValueError):
        U.upsample_int(x.permute(0, 2, 1, 3), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,out_hw,dtype", [
    ((3, 16, 16), (64, 64), torch.float32),
    ((2, 16, 16), (64, 64), torch.bfloat16),
    ((2, 4, 8, 8), (32, 32), torch.float32),
    ((2, 3, 12, 10), (37, 25), torch.float32),
    ((8, 20, 128, 128), (512, 512), torch.bfloat16),
])
def test_gpu_upsample_sigmoid_kernel_matches_plain(rng, shape, out_hw, dtype):
    dev = _cuda()
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3).to(
        dev, dtype)
    n0 = S.upsample_sigmoid.launches
    got = S.upsample_sigmoid(x, out_hw)
    torch.cuda.synchronize()
    assert S.upsample_sigmoid.launches == n0 + 1
    want = S.upsample_sigmoid_reference(x, out_hw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,f", [
    ((2, 8, 8, 8), 2), ((1, 7, 5, 64), 2), ((3, 4, 6, 16), 4),
    ((1, 3, 4, 8), 8), ((1, 1, 1, 8), 4), ((16, 16, 16, 256), 2),
    ((16, 32, 32, 64), 4), ((16, 16, 16, 128), 8),
])
def test_gpu_upsample_int_backward_kernel_matches_plain(rng, shape, f):
    dev = _cuda()
    n, h, w, c = shape
    g = torch.from_numpy(rng.randn(n, f * h, f * w, c).astype(np.float32)).to(
        dev, torch.bfloat16)
    n0 = U.upsample_int_backward.launches
    got = U.upsample_int_backward(g, f)
    torch.cuda.synchronize()
    assert U.upsample_int_backward.launches == n0 + 1
    assert got.shape == shape and got.dtype == torch.bfloat16
    assert_within_bf16_sum(got, U.upsample_int_backward_reference(g, f),
                           f"{shape} x{f}")
    # a cotangent that is not NHWC-contiguous is made so first
    gcl = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    torch.testing.assert_close(U.upsample_int_backward(gcl, f), got,
                               rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,f", [((2, 8, 8, 64), 2), ((3, 4, 4, 16), 4),
                                     ((1, 2, 3, 128), 8), ((16, 16, 16, 64), 8)])
def test_gpu_resize_gradients_kernel_route_match_plain_route(rng, shape, f):
    """``torch.autograd.grad`` through ``resize_bilinear`` on the card (the
    kernels' autograd.Function) against the plain route (einsum autograd)
    on the same inputs: forward within 1 bf16 ulp, gradient within 1 bf16
    ulp plus 2^-20 of the largest (autograd sums columns first)."""
    dev = _cuda()
    n, h, w, c = shape
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        dev, torch.bfloat16).requires_grad_()
    g = torch.from_numpy(rng.randn(n, f * h, f * w, c).astype(np.float32)).to(
        dev, torch.bfloat16)
    f0, b0 = U.upsample_int.launches, U.upsample_int_backward.launches
    y = R.resize_bilinear(x, (f * h, f * w))
    (gx,) = torch.autograd.grad(y, x, g)
    torch.cuda.synchronize()
    assert (U.upsample_int.launches, U.upsample_int_backward.launches) == (
        f0 + 1, b0 + 1)
    y_ref = R._resize_einsum(x, (f * h, f * w), False)
    (gx_ref,) = torch.autograd.grad(y_ref, x, g)
    assert_within_bf16_ulp(y, y_ref, f"forward {shape} x{f}")
    assert_within_bf16_sum(gx, gx_ref, f"gradient {shape} x{f}")


@pytest.mark.gpu
def test_gpu_upsample_int_backward_refuses_other_dtypes():
    dev = _cuda()
    with pytest.raises(ValueError):
        U.upsample_int_backward(torch.zeros(1, 8, 8, 8, device=dev), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("n,hw,flags", [
    (4, (16, 16), "mixed"), (3, (8, 12), "zeros"), (5, (7, 9), "ones"),
    (1, (5, 5), "ones"), (16, (512, 512), "mixed"), (7, (33, 64), "mixed"),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gpu_normalize_and_flip_kernel_matches_plain(rng, n, hw, flags, dtype):
    """Flags all 0, all 1 and mixed; odd N; image sizes whose element count
    is not a multiple of the 16-byte vector (the kernel's scalar path)."""
    dev = _cuda()
    imgs = torch.from_numpy((rng.rand(n, *hw, 3) * 256).astype(np.uint8)).to(dev)
    flip = {"zeros": np.zeros(n), "ones": np.ones(n),
            "mixed": np.arange(n) % 2}[flags]
    flip = torch.from_numpy(flip.astype(np.int32)).to(dev)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    n0 = N.normalize_and_flip.launches
    got = N.normalize_and_flip(imgs, flip, mean, std, dtype)
    torch.cuda.synchronize()
    assert N.normalize_and_flip.launches == n0 + 1
    want = N.normalize_and_flip_reference(imgs, flip, mean, std, dtype)
    assert got.dtype == dtype and got.shape == imgs.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
def test_gpu_normalize_and_flip_refuses_flags_elsewhere():
    dev = _cuda()
    imgs = torch.zeros(2, 4, 4, 3, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        N.normalize_and_flip(imgs, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        N.normalize_and_flip(imgs[:, :, ::2], torch.zeros(2, dtype=torch.int32,
                                                         device=dev))
