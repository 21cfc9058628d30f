"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``gpu`` and skips where no CUDA device is present. The
file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu

Tolerances: ``upsample_int`` within 1 bf16 ulp of the plain version (the
kernel blends 4 taps with FMAs, the plain version sums two einsums, so the
f32 sums may round apart by an f32 ulp before the one bf16 rounding);
``upsample_sigmoid`` ``atol=1e-5`` on f32 probabilities. TF32 is off, so
the plain versions' f32 matmuls run in full f32.
"""

import numpy as np
import pytest
import torch

from basi_tpu_torch.kernels import upsample_int as U
from basi_tpu_torch.kernels import upsample_sigmoid as S


def assert_within_bf16_ulp(got: torch.Tensor, want: torch.Tensor, msg=""):
    got = got.double().cpu()
    want = want.double().cpu()
    assert got.shape == want.shape, (got.shape, want.shape)
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    bad = (got - want).abs() > ulp
    assert not bad.any(), (
        f"{msg}: {int(bad.sum())} values beyond 1 bf16 ulp, max diff "
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
