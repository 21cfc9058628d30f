"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the ``Trainer`` on its default device, the card.

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
order, no FMA, one rounding); ``channel_moments`` and ``channel_dual_sums``
within ``1e-5 * sum |term|`` per channel of the plain version (f32 sums of
up to a million terms taken in another order) and bit-equal from one launch
to the next (an atomic ticket only elects the block that sums the partials,
in a fixed order); their BatchNorm epilogues within 1e-5 of each term's
largest magnitude of the plain math on the same sums; ``FusedBatchNorm`` on
the card within 1e-4 of the same module on the CPU. TF32 is off, so the
plain versions' f32 matmuls run in full f32.

Evaluation on the card against the CPU: the paste within 1e-6, each
saliency metric within 1e-5 and the EDT bit for bit; the Gaussian and the
weighted F-measure unchanged with both TF32 flags on; ``evaluate`` of the
tiny config in f32 with saliency means within 1e-4 and AP/AR equal; one
bf16 eval batch launches 9 ``upsample_int`` and 1 ``upsample_sigmoid``.

Checkpoints on the card: a saved train state loads back bit-equal; a
Trainer fed from shards takes the first step of one fed from the synthetic
set at the same loss (the same batch); ``Inferencer(checkpoint=...)``
equals ``state_dict=`` of the same weights.

Image files on the card: the decoder's JPEG route builds and decodes the
JPEG fixtures of ``tests/test_torch_fixtures/`` (37 x 45 and photograph
sizes up to 640 x 480) to the JAX package's digests (libjpeg) or within
``NVJPEG_MAX_ABS`` levels a pixel and ``NVJPEG_MEAN_ABS`` on average
(nvJPEG: its IDCT rounds apart from libjpeg's); ``write_png``/``read_png``
round-trip;
``predict_paths`` of the tiny config in f32 on the card against the CPU:
the same instance counts, scores within 1e-3, at most 0.5% of an image's
PNG or RLE pixels apart.

The entry points on the card: the custom ops ``basi::upsample_int`` and
``basi::upsample_sigmoid`` launch the kernels (equal to the wrappers'
outputs, one launch a call); an artifact exported on the card
(``aot.py``) equals the live ``predict_batch`` bit for bit and launches
9 ``upsample_int`` a batch; the HTTP server answers concurrent uploads
import torch_threads  # noqa: F401  (first: torch's share of the cores)

from its handler threads, each label map equal to ``predict_batch`` +
``full_res_masks`` of its canvas.

The program's spans on the card (``utils/profiling.py``): a ``.item()``
and a ``torch.tensor(x, device=)`` inside a span count one sync each at
their own line, none outside; the six ``train.*`` stages of a traced roi
step sum to within 2% of its first event to its last; the harness's
``summarize`` counts no span as device work or as a launch; a step of
the tiny Trainer (roi with either BatchNorm, kernels sparse and dense)
counts no sync and runs under the sync debug mode ``error``.

The ConvNeXt-B trunk on the card (one block a stage, published widths):
bf16 outputs within 2e-2 and gradients within 5e-2 in norm of the
float32 reference (``perfbench/reference/convnext.py``); held in bf16, its
forward launches no copy or layout kernel, and its spans open 36, 44 and
36 times.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from basi_tpu_torch.kernels import bn_stats as B
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


# Earlier cases; a downsample; output widths that are not a multiple of 4
# (the scalar stores); an output wider than one 512-column tile; a tile
# whose input span does not fit the staged rows in shared memory (20x
# downsample of 2000 columns: the unstaged instance); both path shapes; and
# 65,536 masks (more than a grid dimension's 65,535).
@pytest.mark.gpu
@pytest.mark.parametrize("shape,out_hw,dtype", [
    ((3, 16, 16), (64, 64), torch.float32),
    ((2, 16, 16), (64, 64), torch.bfloat16),
    ((2, 4, 8, 8), (32, 32), torch.float32),
    ((2, 3, 12, 10), (37, 25), torch.float32),
    ((8, 20, 128, 128), (512, 512), torch.bfloat16),
    ((2, 3, 40, 40), (16, 24), torch.float32),
    ((2, 3, 40, 40), (16, 24), torch.bfloat16),
    ((3, 7, 9), (20, 30), torch.bfloat16),
    ((2, 16, 200), (40, 1100), torch.float32),
    ((1, 4, 2000), (8, 100), torch.bfloat16),
    ((20, 128, 128), (512, 512), torch.float32),
    ((65536, 2, 2), (4, 4), torch.float32),
])
def test_gpu_upsample_sigmoid_kernel_matches_plain(rng, shape, out_hw, dtype):
    """Within 1e-5 of the plain version, and two launches bit for bit
    equal."""
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
    assert torch.equal(S.upsample_sigmoid(x, out_hw), got), "launches differ"


@pytest.mark.gpu
@pytest.mark.parametrize("mag", [100.0, 1e4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_upsample_sigmoid_saturates(rng, mag, dtype):
    """Logits of +-mag: no NaN, within 1e-5 of the plain version, and
    exactly 1 and 0 in masks of one sign (every blended value is +-mag)."""
    dev = _cuda()
    signs = np.sign(rng.randn(6, 16, 16)).astype(np.float32)
    signs[:2] = 1.0
    signs[2:4] = -1.0
    x = torch.from_numpy(signs * np.float32(mag)).to(dev, dtype)
    got = S.upsample_sigmoid(x, (64, 64))
    torch.cuda.synchronize()
    assert not got.isnan().any()
    torch.testing.assert_close(got, S.upsample_sigmoid_reference(x, (64, 64)),
                               atol=1e-5, rtol=0)
    assert bool((got[:2] == 1.0).all()) and bool((got[2:4] == 0.0).all())


# (N, f*h, f*w, C) cotangents of the backward: earlier cases; for each f, h
# or w of 1, 3 and 5 (a ragged band of the two-stage kernel) with C = 8
# (less than its channel slab), 24 and 264 (not a multiple of it); heights
# and widths that need a second band or column tile (9, 17; 70, 33, 17
# against tiles of 64, 32 and 16 input columns); the nine training resizes
# at batch 2.
BWD_CASES = [
    ((2, 8, 8, 8), 2), ((1, 7, 5, 64), 2), ((3, 4, 6, 16), 4),
    ((1, 3, 4, 8), 8), ((1, 1, 1, 8), 4), ((16, 16, 16, 256), 2),
    ((16, 32, 32, 64), 4), ((16, 16, 16, 128), 8),
    ((2, 1, 5, 24), 2), ((1, 3, 1, 8), 2), ((2, 5, 3, 264), 2),
    ((1, 5, 1, 24), 4), ((2, 1, 3, 264), 4), ((1, 3, 5, 8), 4),
    ((1, 1, 3, 264), 8), ((2, 5, 5, 24), 8), ((1, 3, 1, 8), 8),
    ((1, 9, 70, 16), 2), ((1, 17, 33, 8), 4), ((2, 9, 17, 24), 8),
    ((2, 16, 16, 256), 2), ((2, 32, 32, 256), 2), ((2, 64, 64, 256), 2),
    ((2, 64, 64, 64), 2), ((2, 32, 32, 64), 4), ((2, 16, 16, 64), 8),
    ((2, 64, 64, 128), 2), ((2, 32, 32, 128), 4), ((2, 16, 16, 128), 8),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,f", BWD_CASES)
def test_gpu_upsample_int_backward_kernel_matches_plain(rng, shape, f):
    """Within 1 bf16 ulp plus 2^-20 of the largest of the plain version,
    and two launches bit for bit equal (no atomics)."""
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
    assert torch.equal(U.upsample_int_backward(g, f), got), "launches differ"
    # a cotangent that is not NHWC-contiguous is made so first
    gcl = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    torch.testing.assert_close(U.upsample_int_backward(gcl, f), got,
                               rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,f", [
    ((2, 8, 8, 64), 2), ((3, 4, 4, 16), 4), ((1, 2, 3, 128), 8),
    ((16, 16, 16, 64), 8), ((1, 5, 3, 24), 2), ((2, 3, 5, 264), 4),
    ((1, 1, 5, 8), 8), ((2, 9, 17, 16), 8), ((2, 64, 64, 128), 2)])
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
    *((n, hw, flags) for n, hw in ((3, (5, 16)), (4, (3, 48)), (2, (4, 528)))
      for flags in ("zeros", "ones", "mixed")),
    (3, (4, 12), "mixed"), (2, (5, 9), "mixed"),
    (65536, (1, 1), "mixed"),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gpu_normalize_and_flip_kernel_matches_plain(rng, n, hw, flags, dtype):
    """Flags all 0, all 1 and mixed; odd N; widths that are a multiple of
    the kernel's 16-pixel run (one, three and 33 runs a row: the vector
    path) and widths that are not (12, 9, 7, 5: the scalar path); 65,536
    images (more than a grid dimension's 65,535)."""
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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gpu_normalize_and_flip_misaligned_view(rng, dtype):
    """A contiguous view that starts off a 16-byte boundary takes the
    scalar path, bit-exact."""
    dev = _cuda()
    n, h, w = 3, 4, 32
    flat = torch.from_numpy((rng.rand(n * h * w * 3 + 1) * 256).astype(
        np.uint8)).to(dev)
    imgs = flat[1:].view(n, h, w, 3)
    flip = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
    got = N.normalize_and_flip(imgs, flip, out_dtype=dtype)
    want = N.normalize_and_flip_reference(imgs, flip, out_dtype=dtype)
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


# (N, H, W, C), dtype: ragged row counts, C not a multiple of the 16-byte
# vector (bf16: 20; f32: 12 and 7), and training shapes at batch 16.
BN_CASES = [
    ((2, 8, 8, 64), torch.bfloat16), ((3, 5, 7, 24), torch.bfloat16),
    ((1, 3, 5, 20), torch.bfloat16), ((2, 9, 11, 12), torch.float32),
    ((1, 1, 1, 7), torch.float32), ((16, 64, 64, 64), torch.bfloat16),
    ((16, 32, 32, 1024), torch.bfloat16), ((4, 16, 16, 2048), torch.float32),
    ((16, 256, 256, 64), torch.bfloat16),
]


def assert_sums_close(got, want, absum, msg=""):
    """Per channel within 1e-5 of the sum of the terms' magnitudes."""
    for g, w, a in zip(got, want, absum):
        assert g.dtype == torch.float32 and g.shape == w.shape
        bad = (g.double() - w.double()).abs() > 1e-5 * a.double()
        assert not bad.any(), (
            f"{msg}: {int(bad.sum())} channels beyond the bound, max diff "
            f"{float((g - w).abs().max())}")


def _nhwc(rng, shape, dtype, dev, loc=0.0):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32) * 2 + loc
                            ).to(dev, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", BN_CASES)
def test_gpu_channel_moments_kernel_matches_plain(rng, shape, dtype):
    dev = _cuda()
    x = _nhwc(rng, shape, dtype, dev, loc=0.5)
    n0 = B.channel_moments.launches
    got = B.channel_moments(x)
    again = B.channel_moments(x)
    torch.cuda.synchronize()
    assert B.channel_moments.launches == n0 + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b), "two launches differ"
    xf = x.float()
    absum = (xf.abs().sum((0, 1, 2)), (xf * xf).sum((0, 1, 2)))
    assert_sums_close(got, B.channel_moments_reference(x), absum, f"{shape}")
    # the NHWC view of a channels_last NCHW tensor is the same memory
    xcl = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    for a, b in zip(B.channel_moments(xcl.permute(0, 2, 3, 1)), got):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", BN_CASES)
def test_gpu_channel_dual_sums_kernel_matches_plain(rng, shape, dtype):
    dev = _cuda()
    g = _nhwc(rng, shape, dtype, dev)
    x = _nhwc(rng, shape, dtype, dev, loc=0.5)
    n0 = B.channel_dual_sums.launches
    got = B.channel_dual_sums(g, x)
    again = B.channel_dual_sums(g, x)
    torch.cuda.synchronize()
    assert B.channel_dual_sums.launches == n0 + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b), "two launches differ"
    gf, xf = g.float(), x.float()
    absum = (gf.abs().sum((0, 1, 2)), (gf * xf).abs().sum((0, 1, 2)))
    assert_sums_close(got, B.channel_dual_sums_reference(g, x), absum,
                      f"{shape}")


# (N, H, W, C) of ResNet-50's 12 BatchNorm shapes at batch 16 and 512^2
# (bf16), then ragged ones: odd row counts, C = 1, 3 and 2050 (scalar loads).
BN_RESNET50 = [(16, 256, 256, 64), (16, 128, 128, 64), (16, 128, 128, 256),
               (16, 128, 128, 128), (16, 64, 64, 128), (16, 64, 64, 512),
               (16, 64, 64, 256), (16, 32, 32, 256), (16, 32, 32, 1024),
               (16, 32, 32, 512), (16, 16, 16, 512), (16, 16, 16, 2048)]
BN_TERM_CASES = [(s, torch.bfloat16) for s in BN_RESNET50] + [
    ((3, 7, 5, 1), torch.float32), ((1, 9, 13, 3), torch.bfloat16),
    ((2, 5, 7, 2050), torch.float32), ((1, 3, 11, 2050), torch.bfloat16),
    ((5, 3, 3, 64), torch.float32)]


def assert_terms_close(got, want, msg=""):
    """Each (C,) row within 1e-5 of the largest magnitude of its plain
    counterpart (one-ulp differences of a division, an rsqrt taken in
    another kernel)."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        err = float((g.double() - w.double()).abs().max())
        assert err <= 1e-5 * float(w.double().abs().max()), (
            f"{msg}: term {i} off by {err}")


def _bn_params(c, dev):
    return (torch.linspace(0.5, 1.5, c, device=dev),
            torch.linspace(-1.0, 1.0, c, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", BN_TERM_CASES)
def test_gpu_bn_term_epilogues_match_plain(rng, shape, dtype):
    """``channel_means``, ``bn_forward_terms`` and ``bn_backward_terms``
    (the kernels with the BN's per-channel math in their last block)
    against the plain math on the kernel's own sums; their sums against the
    plain version; two launches bit for bit equal; and the module's
    elementwise passes on them: y within 1 bf16 ulp, dx within 1 bf16 ulp
    plus 2^-20 of its largest magnitude (its three terms cancel)."""
    from basi_tpu_torch.models import norm as BN

    dev = _cuda()
    x = _nhwc(rng, shape, dtype, dev, loc=0.5)
    g = _nhwc(rng, shape, dtype, dev)
    scale, bias = _bn_params(shape[-1], dev)
    m = shape[0] * shape[1] * shape[2]
    n0 = (B.channel_moments.launches, B.channel_dual_sums.launches)
    sx, sx2 = B.channel_moments(x)
    means = B.channel_means(x)
    fwd = B.bn_forward_terms(x, scale, bias, 1e-5)
    fwd2 = B.bn_forward_terms(x, scale, bias, 1e-5)
    mean, inv = fwd[0], fwd[2]
    sg, sgx = B.channel_dual_sums(g, x)
    bwd = B.bn_backward_terms(g, x, scale, mean, inv)
    bwd2 = B.bn_backward_terms(g, x, scale, mean, inv)
    torch.cuda.synchronize()
    assert (B.channel_moments.launches - n0[0],
            B.channel_dual_sums.launches - n0[1]) == (4, 3)
    for a, b in zip(fwd + bwd, fwd2 + bwd2):
        assert torch.equal(a, b), "two launches differ"
    plain_fwd = B.bn_forward_math(sx / m, sx2 / m, scale, bias, 1e-5)
    plain_bwd = B.bn_backward_math(sg, sgx, m, scale, mean, inv)
    assert_terms_close(means, (sx / m, sx2 / m), f"means {shape}")
    assert_terms_close(fwd, plain_fwd, f"forward {shape}")
    assert_terms_close(bwd, plain_bwd, f"backward {shape}")
    xf, gf = x.float(), g.float()
    assert_sums_close((sx, sx2), B.channel_moments_reference(x),
                      (xf.abs().sum((0, 1, 2)), (xf * xf).sum((0, 1, 2))),
                      f"{shape}")
    assert_sums_close((sg, sgx), B.channel_dual_sums_reference(g, x),
                      (gf.abs().sum((0, 1, 2)),
                       (gf * xf).abs().sum((0, 1, 2))), f"{shape}")
    xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    assert_within_bf16_ulp(BN._apply(xn, *fwd[3:]), BN._apply(xn, *plain_fwd[3:]),
                           f"y {shape}")
    assert_within_bf16_sum(BN._input_gradient(gn, xn, mean, *bwd[2:]),
                           BN._input_gradient(gn, xn, mean, *plain_bwd[2:]),
                           f"dx {shape}")


@pytest.mark.gpu
def test_gpu_bn_kernels_interleaved_calls_each_right(rng):
    """100 calls of both kernels, their epilogues in turn, at shapes that
    alternate (another tile count, dtype and slab count each time): every
    result equals the first call's bit for bit, so no counter is left
    behind by a launch and no workspace is read stale."""
    dev = _cuda()
    shapes = [((16, 32, 32, 256), torch.bfloat16), ((3, 7, 5, 24), torch.bfloat16),
              ((2, 9, 11, 12), torch.float32), ((4, 16, 16, 2048), torch.bfloat16),
              ((1, 3, 5, 2050), torch.float32)]
    cases = []
    for shape, dtype in shapes:
        x = _nhwc(rng, shape, dtype, dev, loc=0.5)
        g = _nhwc(rng, shape, dtype, dev)
        scale, bias = _bn_params(shape[-1], dev)
        mean, _, inv, _, _ = B.bn_forward_terms(x, scale, bias, 1e-5)
        calls = [lambda x=x: B.channel_moments(x),
                 lambda x=x: B.channel_means(x),
                 lambda x=x, s=scale, b=bias: B.bn_forward_terms(x, s, b, 1e-5),
                 lambda g=g, x=x: B.channel_dual_sums(g, x),
                 lambda g=g, x=x, s=scale, mu=mean, i=inv:
                     B.bn_backward_terms(g, x, s, mu, i)]
        cases.append([(fn, [t.clone() for t in fn()]) for fn in calls])
    for i in range(100):
        fn, want = cases[i % len(cases)][i % 5]
        got = fn()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (
            f"call {i}: {shapes[i % len(cases)]} epilogue {i % 5} differs")


@pytest.mark.gpu
def test_gpu_bn_kernels_launch_one_device_kernel_per_call(rng):
    """``torch.profiler``: five calls of each entry point run five device
    kernels, all ``bn_stats`` ones (no second pass, no fill, no copy)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = _cuda()
    x = _nhwc(rng, (16, 64, 64, 256), torch.bfloat16, dev, loc=0.5)
    g = _nhwc(rng, (16, 64, 64, 256), torch.bfloat16, dev)
    scale, bias = _bn_params(256, dev)
    mean, _, inv, _, _ = B.bn_forward_terms(x, scale, bias, 1e-5)
    calls = {"channel_moments": lambda: B.channel_moments(x),
             "channel_means": lambda: B.channel_means(x),
             "bn_forward_terms": lambda: B.bn_forward_terms(x, scale, bias, 1e-5),
             "channel_dual_sums": lambda: B.channel_dual_sums(g, x),
             "bn_backward_terms": lambda: B.bn_backward_terms(
                 g, x, scale, mean, inv)}
    for name, fn in calls.items():
        fn()  # plans and workspaces exist before the profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        assert len(kernels) == 5 and all("bn_stats" in k for k in kernels), (
            name, kernels)


@pytest.mark.gpu
def test_gpu_bn_stats_refuse_what_the_kernel_cannot_take():
    dev = _cuda()
    x = torch.zeros(2, 4, 4, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        B.channel_moments(x.permute(0, 2, 1, 3))
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        B.channel_dual_sums(x[:, :, ::2], x[:, :, ::2])
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        B.channel_moments(x.half())
    with pytest.raises(ValueError, match="does not match"):
        B.channel_dual_sums(x.float(), x)
    scale = torch.ones(16, device=dev)
    with pytest.raises(ValueError, match="per-channel"):
        B.bn_forward_terms(x, scale.double(), scale, 1e-5)
    with pytest.raises(ValueError, match="per-channel"):
        B.bn_backward_terms(x, x, scale, scale[:8], scale)
    n0 = B.channel_moments.launches
    empty = B.channel_moments(x[:0])
    assert B.channel_moments.launches == n0
    assert empty[0].shape == (16,) and not empty[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["full", "stats"])
def test_gpu_fused_batch_norm_matches_cpu(rng, mode):
    """f32 train forward, running statistics and the gradients of x, scale
    and bias on the card (the kernels) against the CPU (their plain
    versions): within 1e-4 relative to each tensor's largest magnitude;
    the launches are one channel_moments per forward and, in mode full,
    one channel_dual_sums per backward."""
    from basi_tpu_torch.models.layers import update_running_stats
    from basi_tpu_torch.models.norm import FusedBatchNorm

    dev = _cuda()
    x0 = torch.from_numpy(rng.randn(8, 64, 16, 16).astype(np.float32) * 3 + 1)
    # channels_last, as the model's gradients arrive
    w = torch.from_numpy(rng.randn(8, 64, 16, 16).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    out = []
    for d in (dev, "cpu"):
        bn = FusedBatchNorm(64, mode=mode).to(d)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 64))
            bn.bias.copy_(torch.linspace(-1, 1, 64))
        x = x0.to(d).contiguous(memory_format=torch.channels_last)
        x.requires_grad_()
        n0 = (B.channel_moments.launches, B.channel_dual_sums.launches)
        y = bn(x, train=True)
        (torch.tanh(y) * w.to(d)).sum().backward()
        update_running_stats([bn])
        n1 = (B.channel_moments.launches, B.channel_dual_sums.launches)
        if d != "cpu":
            torch.cuda.synchronize()
            assert (n1[0] - n0[0], n1[1] - n0[1]) == (
                1, 1 if mode == "full" else 0)
        out.append([t.detach().cpu() for t in (
            y, x.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
            bn.running_var)])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.gpu
def test_gpu_fused_batch_norm_refuses_a_gradient_in_another_layout():
    """The backward reads the gradient as the NHWC view of a channels_last
    tensor, the layout the model hands it; an NCHW-contiguous gradient
    raises instead of being copied."""
    from basi_tpu_torch.models.norm import FusedBatchNorm

    dev = _cuda()
    bn = FusedBatchNorm(16).to(dev)
    x = torch.randn(2, 16, 8, 8, device=dev).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = bn(x, train=True)
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        y.backward(torch.randn(2, 16, 8, 8, device=dev))


@pytest.mark.gpu
def test_gpu_trainer_runs_on_the_default_card():
    """The default device is the current CUDA device with its index, which
    the Trainer's feed thread sets as its own before it copies a batch."""
    from basi_tpu_torch.config import get_config
    from basi_tpu_torch.device import resolve_device
    from basi_tpu_torch.train.loop import Trainer

    _cuda()
    assert resolve_device() == torch.device("cuda",
                                            torch.cuda.current_device())
    cfg = get_config("", [
        "model.backbone=resnet_tiny", "model.fpn_channels=32",
        "model.mask_channels=32", "model.grid_size=8", "model.num_slots=8",
        "model.image_size=64", "data.image_size=64", "data.max_instances=4",
        "data.batch_size=2", "data.synthetic_n=4", "train.checkpoint_dir="])
    trainer = Trainer(cfg)
    feed = trainer.feed.epoch(0)
    batch = next(feed)
    feed.close()
    assert trainer.device == resolve_device()
    assert all(t.device == trainer.device for t in batch.values())
    metrics = trainer.train_step(trainer.state, batch)
    assert np.isfinite(float(metrics["loss"]))


# --- evaluation: paste, the saliency suite, Inferencer.evaluate ---------------

def _tiny_eval_cfg(*overrides):
    from basi_tpu_torch.config import get_config

    return get_config("", [
        "model.backbone=resnet_tiny", "model.fpn_channels=32",
        "model.mask_channels=32", "model.grid_size=8", "model.num_slots=8",
        "model.image_size=64", "data.image_size=64", "data.max_instances=4",
        "data.batch_size=4", "data.synthetic_n=40", "infer.batch_size=4",
        "infer.pre_nms_top_k=16", "infer.native_gt_cache=",
        "infer.dtype=float32", "train.checkpoint_dir=", *overrides])


def _sod_inputs(rng, n=3, h=96, w=112):
    yy, xx = np.mgrid[0:h, 0:w]
    gt = np.zeros((n, h, w), np.float32)
    for i in range(n - 1):  # the last image's GT is empty
        for _ in range(2):
            cy, cx = rng.randint(5, h - 5), rng.randint(5, w - 5)
            r = rng.randint(3, h // 4)
            gt[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1.0
    pred = np.clip(gt * 0.7 + rng.rand(n, h, w) * 0.4, 0, 1).astype(np.float32)
    valid = np.zeros((n, h, w), np.float32)
    valid[:, :h - 11, :w - 6] = 1.0
    return [torch.from_numpy(a) for a in (pred, gt, valid)]


@pytest.mark.gpu
def test_gpu_paste_matches_cpu(rng):
    """Non-square valid and original extents on a 768 x 896 canvas: 1e-6."""
    from basi_tpu_torch.ops.paste import paste_masks_batch

    dev = _cuda()
    masks = torch.from_numpy(rng.rand(3, 4, 128, 128).astype(np.float32))
    valid = torch.tensor([[128, 91], [85, 128], [128, 128]], dtype=torch.int32)
    orig = torch.tensor([[700, 501], [480, 722], [768, 896]], dtype=torch.int32)
    want = paste_masks_batch(masks, valid, (768, 896), orig)
    got = paste_masks_batch(masks.to(dev), valid.to(dev), (768, 896),
                            orig.to(dev))
    torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=0)


SOD_METRICS = ["f_measure_hist", "e_measure_hist", "s_measure",
               "boundary_f_measure", "weighted_f_measure"]


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", SOD_METRICS)
def test_gpu_saliency_metric_matches_cpu(rng, name, masked):
    """Each metric per image on the card against the CPU: 1e-5."""
    from basi_tpu_torch.evals import saliency as SAL

    dev = _cuda()
    pred, gt, valid = _sod_inputs(rng)
    v = valid if masked else None
    want = getattr(SAL, name)(pred, gt, valid=v)
    got = getattr(SAL, name)(pred.to(dev), gt.to(dev),
                             valid=None if v is None else v.to(dev))
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_gpu_edt_matches_cpu_exactly(rng):
    from basi_tpu_torch.evals.saliency import _edt_payload

    dev = _cuda()
    fg = torch.from_numpy((rng.rand(2, 70, 90) < 0.03).astype(np.float32))
    fg[:, ::16, ::16] = 1.0  # equidistant seeds: ties
    pay = torch.from_numpy(rng.rand(2, 70, 90).astype(np.float32))
    want = _edt_payload(fg, pay, chunk=16)
    got = _edt_payload(fg.to(dev), pay.to(dev), chunk=16)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_gpu_gauss7_and_weighted_f_ignore_tf32(rng):
    """With ``cudnn.allow_tf32`` and ``matmul.allow_tf32`` both on, the
    Gaussian and the weighted F give what they give with both off."""
    from basi_tpu_torch.evals.saliency import _gauss7, weighted_f_measure

    dev = _cuda()
    pred, gt, valid = (t.to(dev) for t in _sod_inputs(rng))
    x = torch.from_numpy(rng.rand(2, 200, 300).astype(np.float32)).to(dev)
    off = (_gauss7(x), weighted_f_measure(pred, gt, valid=valid))
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        on = (_gauss7(x), weighted_f_measure(pred, gt, valid=valid))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    for a, b in zip(on, off):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("orig", [False, True])
def test_gpu_evaluate_matches_cpu(orig):
    """``Inferencer.evaluate`` of the tiny config in f32, the same seeded
    weights on the card and on the CPU: saliency means within 1e-4, AP/AR
    equal, the same image count (letterbox and original frame, square
    originals: the paste is the identity; ``chip_smoke.py`` phase 7 holds
    non-square ones at full width)."""
    from basi_tpu_torch.infer import Inferencer

    dev = _cuda()
    cfg = _tiny_eval_cfg(f"infer.ap_at_original={str(orig).lower()}")
    got = Inferencer(cfg, device=dev, seed=3).evaluate()
    want = Inferencer(cfg, device="cpu", seed=3).evaluate()
    assert set(got) == set(want) and got["num_images"] == want["num_images"]
    for k, v in want.items():
        if k.startswith("saliency"):
            assert abs(got[k] - v) <= 1e-4, (k, got[k], v)
        elif k.startswith(("AP", "AR", "mAP")):
            assert got[k] == v, (k, got[k], v)


@pytest.mark.gpu
def test_gpu_eval_batch_launches_nine_upsample_int_and_one_sigmoid():
    """bf16: one eval batch launches the forward's 9 ``upsample_int`` and
    one ``upsample_sigmoid`` (the saliency map's f32 resize is the
    einsum's, as in the reference)."""
    from basi_tpu_torch.data.datasets import iter_epoch, make_dataset
    from basi_tpu_torch.infer import Inferencer
    from basi_tpu_torch.data.transforms import pack_masks_host

    dev = _cuda()
    cfg = _tiny_eval_cfg("infer.dtype=bfloat16")
    inf = Inferencer(cfg, device=dev)
    batch = next(iter_epoch(make_dataset(cfg.data, split="val"), 4,
                            shuffle=False, seed=0, drop_last=False))
    args = [torch.from_numpy(a).to(dev) for a in (
        batch["image"], pack_masks_host(batch["masks"]), batch["valid"],
        batch["valid_hw"])]
    U.upsample_int.launches = S.upsample_sigmoid.launches = 0
    with torch.inference_mode():
        res, _, _ = inf._eval_batch(*args)
    torch.cuda.synchronize()
    assert (U.upsample_int.launches, S.upsample_sigmoid.launches) == (9, 1)
    assert all(bool(torch.isfinite(v.float()).all()) for v in res.values())


# --- checkpoints and shards on the card -----------------------------------------

def _tiny_train_cfg(*overrides):
    return _tiny_eval_cfg("data.synthetic_n=8", "data.synthetic_orig_scale=1.5",
                          "train.ema_decay=0.9", "train.log_every=1",
                          *overrides)


@pytest.mark.gpu
def test_gpu_checkpoint_round_trip_is_bit_equal(tmp_path):
    """Two steps on the card, saved, then restored into a fresh state on
    the card: params, BatchNorm statistics, momentum, EMA, step and the
    generator bit-equal."""
    from basi_tpu_torch.train.loop import Trainer
    from basi_tpu_torch.utils.checkpoint import CheckpointManager

    dev = _cuda()
    tr = Trainer(_tiny_train_cfg(), device=dev)
    tr.train(max_steps=2)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(tr.state)
    fresh = Trainer(_tiny_train_cfg("train.seed=5"), device=dev)
    mgr.restore(fresh.state)
    a, b = tr.state, fresh.state
    assert b.step == a.step == 2
    for k, v in a.model.state_dict().items():
        got = b.model.state_dict()[k]
        assert got.device == v.device and torch.equal(got, v), k
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(a.optimizer.state[p]["momentum_buffer"],
                           b.optimizer.state[q]["momentum_buffer"])
    for k, v in a.ema.items():
        assert torch.equal(b.ema[k], v), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.gpu
def test_gpu_trainer_from_shards_takes_the_synthetic_first_step(tmp_path):
    """The shards of the synthetic set feed the same first batch, so the
    first step's loss on the card is the same."""
    from basi_tpu_torch.data.datasets import make_dataset
    from basi_tpu_torch.data.shards import pack_dataset
    from basi_tpu_torch.train.loop import Trainer

    dev = _cuda()
    cfg = _tiny_train_cfg()
    for split in ("train", "val"):
        pack_dataset(make_dataset(cfg.data, split=split),
                     str(tmp_path / split), log=None)
    losses = []
    for ov in ((), ("data.dataset=shards", f"data.root={tmp_path}")):
        tr = Trainer(_tiny_train_cfg(*ov), device=dev)
        losses.append(tr.train(max_steps=1)["loss"])
    assert losses[0] == losses[1] and np.isfinite(losses[0])


@pytest.mark.gpu
def test_gpu_inferencer_from_checkpoint_equals_state_dict(tmp_path):
    """``Inferencer(checkpoint=dir)`` on the card: the EMA weights the
    Trainer evaluates with, and the same metrics as ``state_dict=``."""
    from basi_tpu_torch.infer import Inferencer
    from basi_tpu_torch.train.loop import Trainer

    dev = _cuda()
    cfg = _tiny_train_cfg(f"train.checkpoint_dir={tmp_path / 'ckpt'}",
                          "train.epochs=1")
    tr = Trainer(cfg, device=dev)
    tr.train()
    a = Inferencer(cfg, device=dev, checkpoint=str(tmp_path / "ckpt"))
    b = Inferencer(cfg, device=dev, state_dict=tr.eval_state_dict())
    for k, v in b.model.state_dict().items():
        assert torch.equal(a.model.state_dict()[k], v), k
    timing = ("infer_ms_per_batch", "imgs_per_s")
    ma, mb = a.evaluate(), b.evaluate()
    assert {k: v for k, v in ma.items() if k not in timing} == \
        {k: v for k, v in mb.items() if k not in timing}


# --- image files on the card: the decoder, PNG, predict_paths -------------------

# nvJPEG's IDCT against libjpeg's on the embedded JPEGs (its decoded
# components go through libjpeg's upsampling and colour conversion in
# numpy): at most this many levels apart at a pixel, this many on average.
FIXTURES = Path(__file__).resolve().parent / "test_torch_fixtures"
# nvJPEG's IDCT rounds apart from libjpeg's by a level in a component at
# times; through YCbCr -> RGB that moves R by up to 1 + 1.402 and B by up
# to 1 + 1.772 levels, so 3 at most (measured on an H100 machine: 3 on the
# photographs, 2 at 37 x 45; mean 0.029-0.035)
NVJPEG_MAX_ABS = 3
NVJPEG_MEAN_ABS = 0.1


def _jpeg_fixtures():
    """(name, its ``jpeg.json`` entry, the file's bytes, the JAX decoder's
    decode) of each JPEG fixture."""
    import json

    from basi_tpu_torch.data.png import read_png

    manifest = json.loads((FIXTURES / "jpeg.json").read_text())
    for name, fx in manifest.items():
        yield (name, fx, (FIXTURES / fx["file"]).read_bytes(),
               read_png(FIXTURES / fx["reference"])[0])


@pytest.mark.gpu
def test_gpu_decoder_builds_and_decodes_the_embedded_jpegs():
    """The JPEG route of the card's machine builds and decodes the JPEG
    fixtures (4:4:4, 4:2:0, 4:2:2, grey, RGB-coded and progressive at
    37 x 45; 4:2:0,
    progressive 4:2:0 and 4:4:4 photographs up to 640 x 480) to the JAX
    package's decodes: the digests where the route is libjpeg, within
    ``NVJPEG_MAX_ABS`` and ``NVJPEG_MEAN_ABS`` where it is nvJPEG. The
    letterboxes of each reference decode to 64 and 512 give the
    reference's letterbox digests, bit for bit."""
    import hashlib

    from basi_tpu_torch.data import native as N

    _cuda()
    route = N.route()
    N.library()
    assert N.build_info["route"] == route and N.build_info["path"]
    for name, fx, data, ref in _jpeg_fixtures():
        got = N.decode_jpeg(data)
        assert got.shape == ref.shape == (*fx["shape"], 3), name
        if route == "libjpeg":
            assert hashlib.sha256(got.tobytes()).hexdigest() == fx["sha256"]
        else:
            diff = np.abs(got.astype(np.int32) - ref)
            assert diff.max() <= NVJPEG_MAX_ABS, (name, diff.max())
            assert diff.mean() <= NVJPEG_MEAN_ABS, (name, diff.mean())
        for size in (64, 512):
            lb = N.letterbox_rgb(ref, size)
            assert hashlib.sha256(lb.tobytes()).hexdigest() == \
                fx[f"sha256_lb{size}"], (name, size)


@pytest.mark.gpu
def test_gpu_jpeg_decode_does_not_wait_for_queued_work():
    """A decode on another thread, while about a second of work sits queued
    on the current stream, returns before that work ends: nvJPEG runs on
    the decoding thread's own non-blocking stream, so a folder's decodes
    overlap the batches ``evaluate`` has queued (on the libjpeg route the
    decode never touches the card)."""
    import threading

    from basi_tpu_torch.data import native as N

    _cuda()
    _, _, data, ref = next(f for f in _jpeg_fixtures() if f[0] == "photo_420")
    ready, go, out = threading.Event(), threading.Event(), {}
    queued = torch.cuda.Event()

    def worker():
        N.decode_jpeg(data)  # warm: the thread's stream, nvJPEG's buffers
        ready.set()
        go.wait()
        out["rgb"] = N.decode_jpeg(data)
        out["queued_done"] = queued.query()

    t = threading.Thread(target=worker)
    t.start()
    ready.wait()
    torch.cuda._sleep(2_000_000_000)  # ~1 s of clock cycles
    queued.record()
    go.set()
    t.join()
    assert not out["queued_done"], "the decode waited for the queued work"
    torch.cuda.synchronize()
    assert out["rgb"].shape == ref.shape


@pytest.mark.gpu
def test_gpu_png_round_trips(tmp_path, rng):
    """``write_png`` then ``read_png`` (L, RGB, P) give back the arrays;
    the decoder reads the RGB one unchanged at its own size."""
    from basi_tpu_torch.data import native as N
    from basi_tpu_torch.data import png as P

    _cuda()
    lum = rng.randint(0, 256, (31, 47)).astype(np.uint8)
    rgb = rng.randint(0, 256, (40, 23, 3)).astype(np.uint8)
    idx = rng.randint(0, 4, (9, 9)).astype(np.uint8)
    pal = np.array([[0, 0, 0], [9, 9, 9], [9, 9, 9], [200, 1, 2]], np.uint8)
    for name, arr, palette, mode in (("l", lum, None, "L"),
                                     ("rgb", rgb, None, "RGB"),
                                     ("p", idx, pal, "P")):
        path = tmp_path / f"{name}.png"
        P.write_png(path, arr, palette=palette)
        got, got_mode = P.read_png(path)
        assert got_mode == mode
        np.testing.assert_array_equal(got, arr)
    img, hw = N.NativeDecoder().decode_letterbox(str(tmp_path / "rgb.png"), 40)
    assert tuple(hw) == (40, 23)
    np.testing.assert_array_equal(img[:, :23], rgb)
    assert not img[:, 23:].any()


def _image_folder(tmp_path, rng) -> list[str]:
    """Non-square PNG scenes and the JPEG fixtures."""
    from basi_tpu_torch.data.datasets import SyntheticDataset
    from basi_tpu_torch.data.png import write_png

    scenes = SyntheticDataset(n=8, image_size=64, max_instances=4)
    paths = []
    for i, (h, w) in enumerate(((70, 50), (64, 96), (33, 80), (90, 90),
                                (41, 63), (57, 38))):
        img, _, _ = scenes._scene(i, h, w)
        paths.append(str(tmp_path / f"{i:04d}.png"))
        write_png(paths[-1], img)
    for name, _, data, _ in _jpeg_fixtures():
        paths.append(str(tmp_path / f"jpeg_{name}.jpg"))
        (tmp_path / f"jpeg_{name}.jpg").write_bytes(data)
    return paths


@pytest.mark.gpu
def test_gpu_predict_paths_matches_cpu(tmp_path, rng):
    """``predict_paths`` of the tiny config in f32, the same seeded weights
    (objectness bias 0) on the card and on the CPU, over 13 files (4
    batches of 4, the last padded): the same instance counts, scores
    within 1e-3, the same image ids and sizes in the results, at most
    0.5% of an RLE mask's or a PNG's pixels apart (``chip_smoke.py``
    phase 9 holds each apart pixel to a probability within 1e-3 of
    0.5)."""
    import json

    from basi_tpu_torch.data.coco import rle_decompress, rle_to_mask
    from basi_tpu_torch.data.png import read_png
    from basi_tpu_torch.infer import Inferencer

    from basi_tpu_torch.models.basi import create_model

    dev = _cuda()
    paths = _image_folder(tmp_path, rng)
    cfg = _tiny_eval_cfg("infer.score_threshold=0.05")
    model = create_model(cfg.model, "cpu", torch.Generator().manual_seed(3))
    with torch.no_grad():  # the focal prior's bias would fill no slot
        model.instance.score.bias.zero_()
    sd = model.state_dict()
    outs = {}
    for where in (dev, "cpu"):
        inf = Inferencer(cfg, device=where, state_dict=sd)
        tag = "card" if where == dev else "cpu"
        res = inf.predict_paths(paths, out_dir=str(tmp_path / tag),
                                results_path=str(tmp_path / f"{tag}.json"))
        outs[tag] = (res, json.loads((tmp_path / f"{tag}.json").read_text()))
    (rc, jc), (rp, jp) = outs["card"], outs["cpu"]
    assert [r["instances"] for r in rc] == [r["instances"] for r in rp]
    assert sum(r["instances"] for r in rp) > 0
    for a, b in zip(rc, rp):
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-3)
    assert len(jc) == len(jp)
    for a, b in zip(jc, jp):
        assert (a["image_id"], a["segmentation"]["size"]) == \
            (b["image_id"], b["segmentation"]["size"])
        h, w = a["segmentation"]["size"]
        ma = rle_to_mask(rle_decompress(a["segmentation"]["counts"]), h, w)
        mb = rle_to_mask(rle_decompress(b["segmentation"]["counts"]), h, w)
        assert (ma != mb).mean() <= 0.005
    for p in paths:
        stem = p.rsplit("/", 1)[1].rsplit(".", 1)[0]
        a = read_png(tmp_path / "card" / f"{stem}.png")[0]
        b = read_png(tmp_path / "cpu" / f"{stem}.png")[0]
        assert a.shape == b.shape and (a != b).mean() <= 0.005


# --- the entry points on the card: custom ops, artifacts, the server ------------


@pytest.mark.gpu
@pytest.mark.parametrize("shape,f", [((2, 8, 8, 16), 2), ((8, 16, 16, 256), 4)])
def test_gpu_upsample_int_custom_op_is_the_kernel(rng, shape, f):
    """``basi::upsample_int`` on CUDA launches the kernel (equal to the
    wrapper's output, one launch) and on the CPU runs the plain version."""
    dev = _cuda()
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        dev, torch.bfloat16)
    n0 = U.upsample_int.launches
    got = torch.ops.basi.upsample_int(x, f)
    torch.cuda.synchronize()
    assert U.upsample_int.launches == n0 + 1
    assert torch.equal(got, U.upsample_int(x, f))
    assert_within_bf16_ulp(got, U.upsample_int_reference(x, f))
    assert torch.equal(torch.ops.basi.upsample_int(x.cpu(), f),
                       U.upsample_int_reference(x.cpu(), f))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_upsample_sigmoid_custom_op_is_the_kernel(rng, dtype):
    dev = _cuda()
    x = torch.from_numpy(rng.randn(2, 3, 16, 16).astype(np.float32)).to(
        dev, dtype)
    n0 = S.upsample_sigmoid.launches
    got = torch.ops.basi.upsample_sigmoid(x, 64, 64)
    torch.cuda.synchronize()
    assert S.upsample_sigmoid.launches == n0 + 1
    assert torch.equal(got, S.upsample_sigmoid(x, (64, 64)))
    torch.testing.assert_close(got.cpu(), S.upsample_sigmoid_reference(
        x, (64, 64)).cpu(), rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_gpu_artifact_exported_on_the_card(tmp_path, rng):
    """An artifact exported on the card (bf16) loads there, equals the
    live ``predict_batch`` bit for bit and launches 9 ``upsample_int``
    kernels a batch; exporting changed no launch counter."""
    from basi_tpu_torch.aot import load_serving, save_serving
    from basi_tpu_torch.infer import Inferencer

    dev = _cuda()
    cfg = _tiny_eval_cfg("infer.dtype=bfloat16")
    inf = Inferencer(cfg, device=dev, seed=3)
    x = torch.from_numpy(rng.randint(0, 256, (4, 64, 64, 3)).astype(
        np.uint8)).to(dev)
    want = inf.predict_batch(x)
    n0 = U.upsample_int.launches
    path = str(tmp_path / "m.basiaot")
    meta = save_serving(path, cfg, state_dict=inf.model.state_dict(),
                        device=dev)
    assert U.upsample_int.launches == n0 and meta["platforms"] == ["cuda"]
    model = load_serving(path)
    got = model(x)
    torch.cuda.synchronize()
    assert U.upsample_int.launches == n0 + 9
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g, w)
    with pytest.raises(ValueError, match="exported for"):
        load_serving(path, "cpu")


@pytest.mark.gpu
def test_gpu_server_answers_from_handler_threads(rng):
    """The HTTP server on the card: 12 uploads (PNG and the JPEG
    fixtures, decoded by nvJPEG or libjpeg in the handler threads) from 6
    client threads, each answer equal to ``predict_batch`` +
    ``full_res_masks`` of its canvas."""
    import base64
    import json
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from basi_tpu_torch.data.datasets import letterbox_params
    from basi_tpu_torch.data.letterbox import resize_bilinear_u8
    from basi_tpu_torch.data.png import decode_png, encode_png, pil_view
    from basi_tpu_torch.infer import to_numpy
    from basi_tpu_torch.server import (
        _serve_in_thread,
        decode_upload,
        label_map,
    )

    from basi_tpu_torch.models.basi import create_model

    _cuda()
    cfg = _tiny_eval_cfg("infer.score_threshold=0.05")
    model = create_model(cfg.model, "cpu", torch.Generator().manual_seed(3))
    with torch.no_grad():  # the focal prior's bias would fill no slot
        model.instance.score.bias.zero_()
    base, httpd, svc = _serve_in_thread(cfg, predict_timeout=120,
                                        state_dict=model.state_dict())
    try:
        assert svc.predictor.inf.device.type == "cuda"
        uploads = [data for _, _, data, _ in _jpeg_fixtures()]
        uploads += [encode_png(rng.randint(0, 256, (40 + 8 * i, 64, 3))
                               .astype(np.uint8))
                    for i in range(12 - len(uploads))]

        def post(data):
            req = urllib.request.Request(base + "/predict", data=data,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())

        with ThreadPoolExecutor(6) as pool:
            answers = list(pool.map(post, uploads))
        inf = svc.predictor.inf
        for data, (code, out) in zip(uploads, answers):
            assert code == 200
            img = decode_upload(data)
            vh, vw = letterbox_params(*img.shape[:2], 64)
            batch = np.zeros((4, 64, 64, 3), np.uint8)
            batch[0, :vh, :vw] = resize_bilinear_u8(img, vh, vw)
            masks, scores, _ = inf.predict_batch(batch)
            full = to_numpy(inf.full_res_masks(masks[:1]))[0]
            lab, _ = label_map(full, to_numpy(scores)[0], 0.05,
                               cfg.infer.mask_threshold)
            got = pil_view(decode_png(base64.b64decode(
                out["label_png_b64"])))[0]
            assert np.array_equal(got, lab[:vh, :vw])
    finally:
        httpd.shutdown()
        svc.close()


# --- the training settings (train_multiscale_fused and the rest) -----------------

def _settings_cfg(*overrides):
    return _tiny_train_cfg("data.multiscale=true", "model.dtype=float32",
                           "data.hflip_prob=0.5", *overrides)


def _one_step(cfg, device, dtype=torch.float32):
    """One train step's gradients of ``cfg`` on ``device`` in ``dtype``
    from seeded weights, on a seeded batch of circles (4 images a
    micro-batch): (loss, {param: float64 grad on the CPU}, launch
    counts)."""
    from basi_tpu_torch.kernels import launch_counters
    from basi_tpu_torch.models.basi import create_model
    from basi_tpu_torch.train.state import create_train_state
    from basi_tpu_torch.train.step import accumulate_grads

    rng = np.random.RandomState(0)
    n, size, m = 4 * cfg.train.grad_accum, cfg.data.image_size, 4
    yy, xx = np.mgrid[0:size, 0:size]
    masks = np.zeros((n, m, size, size), np.uint8)
    for i in range(n):
        for j in range(m):
            cy, cx = rng.randint(8, size - 8, size=2)
            masks[i, j] = (yy - cy) ** 2 + (xx - cx) ** 2 <= rng.randint(
                4, size // 4) ** 2
    batch = {"image": torch.from_numpy(
                 (rng.rand(n, size, size, 3) * 255).astype(np.uint8)),
             "masks": torch.from_numpy(masks),
             "valid": torch.ones((n, m), dtype=torch.uint8)}
    model = create_model(cfg.model, device, torch.Generator().manual_seed(0),
                         train=True).to(dtype)
    state = create_train_state(model, cfg.train)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    metrics = accumulate_grads(state, {k: v.to(device)
                                       for k, v in batch.items()},
                               cfg.train, cfg.data, dtype)
    counts = {k: fn.launches for k, fn in counters.items()}
    grads = {k: p.grad.double().cpu() for k, p in model.named_parameters()}
    return float(metrics["loss"]), grads, counts


def _apart(g, ref):
    flat = torch.cat([(g[k] - ref[k]).flatten() for k in ref])
    return float(flat.abs().max()), float(flat.norm())


@pytest.mark.gpu
def test_gpu_random_augment_ignores_tf32(rng):
    """The scale jitter at the preset's shape for 4 images (8 masks, 512^2)
    on the card: the same bits with TF32 allowed as without (the wrapper
    turns it off around its matmuls), images within 1e-5 of the CPU's and
    masks equal to the CPU's wherever the CPU's value before the threshold
    lies more than 1e-5 from 0.5."""
    from basi_tpu_torch.data.transforms import (
        dynamic_interp_matrix,
        random_augment,
    )

    dev = _cuda()
    n, m, hw = 4, 8, 512
    imgs = torch.from_numpy(rng.randn(n, hw, hw, 3).astype(np.float32))
    masks = torch.from_numpy((rng.rand(n, m, hw // 16, hw // 16) > 0.6)
                             .astype(np.float32)).repeat_interleave(
        16, 2).repeat_interleave(16, 3)
    draws = [torch.tensor([0.75, 1.25, 0.9, 1.1]),
             torch.from_numpy(rng.rand(n).astype(np.float32)),
             torch.from_numpy(rng.rand(n).astype(np.float32))]
    out = {}
    for tf32 in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            out[tf32] = [t.cpu() for t in random_augment(
                imgs.to(dev), masks.to(dev), *draws)]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)
    ci, cm = random_augment(imgs, masks, *draws)
    torch.testing.assert_close(out[False][0], ci, atol=1e-5, rtol=0)
    # the CPU's resampled masks before the threshold
    r = 1.0 / draws[0]
    wy = dynamic_interp_matrix(hw, hw, r, draws[1] * (hw - r * hw))
    wx = dynamic_interp_matrix(hw, hw, r, draws[2] * (hw - r * hw))
    pre = torch.matmul(torch.matmul(wy[:, None], masks),
                       wx[:, None].transpose(-1, -2))
    clear = (pre - 0.5).abs() > 1e-5
    assert torch.equal(out[False][1][clear], cm[clear])


@pytest.mark.gpu
@pytest.mark.parametrize("overrides", [
    (), ("data.color_jitter=0.2,0.2,0.2",), ("train.grad_accum=2",)])
def test_gpu_multiscale_step_matches_cpu(overrides):
    """The multiscale f32 step on the card against the same step on the
    CPU, the same draws, and float64 on the CPU as the reference: loss within 1e-4 relative of the CPU's f32 loss; the card's
    gradients no further from float64 than twice the CPU's f32 gradients
    are, by the largest difference and in norm (plus 1e-6 of the
    reference's: zoomed-out scenes leave near-constant BatchNorm channels
    in the tiny trunk, where f32 gradients part from float64 by up to
    3.5e-2 on the CPU too); one ``normalize_and_flip`` a micro-batch."""
    dev = _cuda()
    cfg = _settings_cfg(*overrides)
    loss_d, g_d, n_d = _one_step(cfg, dev)
    loss_c, g_c, _ = _one_step(cfg, "cpu")
    _, ref, _ = _one_step(cfg, "cpu", torch.float64)
    assert n_d["normalize_and_flip"] == cfg.train.grad_accum
    assert abs(loss_d - loss_c) <= 1e-4 * abs(loss_c)
    rmax = max(float(r.abs().max()) for r in ref.values())
    rnorm = float(torch.cat([r.flatten() for r in ref.values()]).norm())
    (dm, dn), (cm, cn) = _apart(g_d, ref), _apart(g_c, ref)
    assert dm <= 2 * cm + 1e-6 * rmax, (dm, cm)
    assert dn <= 2 * cn + 1e-6 * rnorm, (dn, cn)


@pytest.mark.gpu
@pytest.mark.parametrize("overrides,per_step", [
    (("train.freeze_bn=true",), (0, 0)),
    (("train.remat=true",), (2, 1)),
    (("train.freeze_bn=true", "train.remat=true"), (0, 0)),
    ((), (1, 1)),
])
def test_gpu_bn_kernel_launches_under_freeze_bn_and_remat(overrides,
                                                          per_step):
    """Under ``model.bn_impl=fused`` a step launches ``channel_moments`` and
    ``channel_dual_sums`` once a BatchNorm each (17 in the tiny trunk); a
    frozen trunk launches neither; remat's recompute launches the forward's
    moments again (twice a BatchNorm) and the backward's sums once."""
    from basi_tpu_torch.models.basi import create_model
    from basi_tpu_torch.models.layers import BatchNorm2d

    dev = _cuda()
    cfg = _settings_cfg("model.bn_impl=fused", *overrides)
    _, _, counts = _one_step(cfg, dev)
    bns = sum(isinstance(m, BatchNorm2d)
              for m in create_model(cfg.model, "cpu").modules())
    assert (counts["channel_moments"], counts["channel_dual_sums"]) == (
        per_step[0] * bns, per_step[1] * bns), counts
    assert counts["normalize_and_flip"] == 1
    assert counts["upsample_int"] == counts["upsample_int_bwd"] == 0  # f32


@pytest.mark.gpu
def test_gpu_remat_moves_the_running_stats_as_the_plain_step():
    """One step with and without ``train.remat`` on the card (fused BN):
    the running statistics within 1e-6 of each other (cuDNN may pick
    another algorithm for the recompute) and the gradients within 1e-4."""
    from basi_tpu_torch.train.loop import Trainer
    from basi_tpu_torch.train.step import accumulate_grads

    dev = _cuda()
    out = []
    for remat in ("false", "true"):
        cfg = _settings_cfg("model.bn_impl=fused", f"train.remat={remat}")
        tr = Trainer(cfg, device=dev)
        feed = tr.feed.epoch(0)
        batch = next(feed)
        feed.close()
        accumulate_grads(tr.state, batch, cfg.train, cfg.data, tr.dtype)
        out.append(({k: b.cpu() for k, b in tr.state.model.named_buffers()},
                    {k: p.grad.cpu() for k, p in
                     tr.state.model.named_parameters()}))
    (s0, g0), (s1, g1) = out
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], atol=1e-6, rtol=1e-6)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_gpu_adamw_resume_is_bit_for_bit(tmp_path):
    """Two AdamW steps on the card, checkpointed, resumed by a new Trainer:
    params, both moments and the count bit-equal; the third step from each
    gives bit-equal params where the backward is deterministic (cuDNN is
    asked to be), and the loss of the third step equal."""
    from basi_tpu_torch.train.loop import Trainer

    dev = _cuda()
    torch.backends.cudnn.deterministic = True
    try:
        over = ("train.optimizer=adamw", f"train.checkpoint_dir={tmp_path}",
                "train.checkpoint_every_steps=2", "data.synthetic_n=16")
        a = Trainer(_settings_cfg(*over, "train.resume=none"), device=dev)
        a.train(max_steps=2)
        b = Trainer(_settings_cfg(*over, "train.resume=auto"), device=dev)
        assert b.state.step == 2
        for p, q in zip(a.state.model.parameters(),
                        b.state.model.parameters()):
            assert torch.equal(p, q)
            sa, sb = a.state.optimizer.state[p], b.state.optimizer.state[q]
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(sa[k], sb[k]), k
                assert sa[k].device == sb[k].device
        la = a.train(max_steps=3)["loss"]
        lb = b.train(max_steps=3)["loss"]
        assert la == lb
        for p, q in zip(a.state.model.parameters(),
                        b.state.model.parameters()):
            assert torch.equal(p, q)
    finally:
        torch.backends.cudnn.deterministic = False


# --- the program's spans and sync counter (utils/profiling.py) ----------------

def _item(x):
    return x.sum().item()


def _scalar_on(dev):
    return torch.tensor(2.0, device=dev)


@pytest.mark.gpu
def test_gpu_span_counts_each_sync_at_its_site():
    """A ``.item()`` and a ``torch.tensor(x, device=)`` inside a span count
    one sync each at their own line; the same calls outside spans, or with
    the profiler off, count none, and the sync debug mode is off again
    after the span."""
    from basi_tpu_torch.utils import profiling as P

    dev = _cuda()
    x = torch.ones(8, device=dev)
    mode = torch.cuda.get_sync_debug_mode()
    with torch.profiler.profile():
        P.reset()
        _item(x)
        with P.span("test.sync"):
            _item(x)
            _scalar_on(dev)
        assert torch.cuda.get_sync_debug_mode() == mode
        _item(x)
        _scalar_on(dev)
    with P.span("test.sync"):  # off
        _item(x)
    here = "tests/test_torch_gpu.py:"
    syncs = P.report()["syncs"]
    P.reset()
    assert syncs == {
        "count": 2, "by_span": {"test.sync": 2},
        "by_site": {here + str(_item.__code__.co_firstlineno + 1):
                    {"test.sync": 1},
                    here + str(_scalar_on.__code__.co_firstlineno + 1):
                    {"test.sync": 1}}}


_ROI = ("model.instance_mechanism=roi", "model.roi_resolution=8",
        "model.roi_top_k=16", "data.batch_size=8", "model.image_size=128",
        "data.image_size=128")


def _traced_step(activities, *overrides):
    """A traced step of a tiny Trainer on the card (after one untraced
    step): (trainer, its batch, profiler, the table's raw entries,
    report)."""
    from basi_tpu_torch.train.loop import Trainer
    from basi_tpu_torch.utils import profiling as P

    dev = _cuda()
    tr = Trainer(_tiny_train_cfg(*overrides), device=dev)
    feed = tr.feed.epoch(0)
    batch = next(feed)
    feed.close()
    tr.train_step(tr.state, batch)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        tr.train_step(tr.state, batch)
        torch.cuda.synchronize()
    entries = {k: list(v[2]) for k, v in P._spans.items()}
    rep = P.report()
    P.reset()
    return tr, batch, prof, entries, rep


STAGES = ("train.ingest", "train.targets", "train.forward", "train.loss",
          "train.backward", "train.update")


@pytest.mark.gpu
def test_gpu_train_stages_tile_a_traced_step():
    """The six stages' device times sum to within 2% of the step's time
    from its first event (``train.ingest``'s entry) to its last
    (``train.update``'s exit); ``roi.align`` runs twice inside them."""
    from torch.profiler import ProfilerActivity

    *_, entries, rep = _traced_step([ProfilerActivity.CPU], *_ROI)
    spans = rep["spans"]
    assert all(spans[s]["calls"] == 1 for s in STAGES)
    assert spans["roi.align"]["calls"] == 2
    first = entries["train.ingest"][0][0]
    last = entries["train.update"][-1][1]
    whole = first.elapsed_time(last) * 1e-3
    stages = sum(spans[s]["device_s"] for s in STAGES)
    assert abs(stages - whole) <= 0.02 * whole, (stages, whole)
    assert spans["roi.align"]["device_s"] < (spans["train.forward"]["device_s"]
                                             + spans["train.loss"]["device_s"])


@pytest.mark.gpu
def test_gpu_summarize_counts_no_span_as_device_work():
    """``perfbench.harness.trace.summarize`` of a traced step: the spans'
    mirrors on the device's timeline are neither busy time nor launches."""
    from torch.profiler import ProfilerActivity

    from perfbench.harness import trace as T

    _, _, prof, _, rep = _traced_step([ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA], *_ROI)
    events = list(prof.events())
    names = set(rep["spans"])
    assert not [e.name for e in events if e.name in names and T._is_device(e)]
    kernels = [e for e in events if T._is_device(e)
               and T.kernel_class(e.name) not in ("memcpy", "memset")]
    assert T.summarize(events, 1.0)["kernels"] == len(kernels) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("overrides", [
    (*_ROI, "model.bn_impl=xla"), (*_ROI, "model.bn_impl=fused"),
    ("train.max_pos_cells=64",), ("train.max_pos_cells=0",),
    (*_ROI, "model.backbone=convnext_test", "train.optimizer=adamw")],
    ids=["roi_xla", "roi_fused", "kernels_sparse", "kernels_dense",
         "roi_convnext_adamw"])
def test_gpu_train_step_never_syncs(overrides):
    """The step never waits on the card: a traced step counts no sync in
    its spans, and the next one runs under torch's sync debug mode
    ``error`` without raising (the roi mechanism with either BatchNorm and
    with the ConvNeXt trunk and AdamW, the kernels mechanism's sparse and
    dense targets); the mode is put back after it."""
    from torch.profiler import ProfilerActivity

    tr, batch, _, _, rep = _traced_step([ProfilerActivity.CPU], *overrides)
    assert rep["syncs"]["count"] == 0, rep["syncs"]
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.train_step(tr.state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert torch.cuda.get_sync_debug_mode() == mode
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_gpu_convnext_trunk_bf16_matches_float32_reference():
    """ConvNeXt-B's trunk at its published widths, one block a stage, on the
    card in bf16 (f32 params, as the port trains): the four outputs within
    2e-2 in norm of the float32 reference's (``perfbench/reference/
    convnext.py``, TF32 off), and each leaf's gradient of a fixed
    projection within 5e-2 in norm (the gradients of a bf16 backward
    through LayerNorm and four stages; ``tests/test_torch_bf16.py`` holds
    bf16 steps to 0.3)."""
    from basi_tpu_torch.models.convnext import CONVNEXT, ConvNeXtTrunk
    from perfbench.reference import convnext as RC

    dev = _cuda()
    depths, dims = (1, 1, 1, 1), CONVNEXT["convnext_base"][1]
    gen = torch.Generator().manual_seed(0)
    p = {}
    for name, shape, kind in RC.trunk_spec(depths, dims):
        z = torch.randn(shape, generator=gen)
        if kind in ("conv", "linear"):
            z = z * RC.init_std(shape, kind)
        else:
            z = {"one": 1 + 0.2 * z, "zero": 0.1 * z, "gamma": 0.5 * z}[kind]
        p[name] = z.to(dev)
    trunk = ConvNeXtTrunk(depths, dims).to(dev).to(
        memory_format=torch.channels_last)
    trunk.load_state_dict({k[len("backbone."):]: v for k, v in p.items()})
    x = torch.randn(4, 3, 128, 128, generator=gen).to(dev)
    got = trunk(x.to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    RC.CONVNEXT["one_block_base"] = (depths, dims)
    try:
        ref = RC.ConvNeXtRef(leaves, {"backbone": "one_block_base"},
                             (0, 0, 0), (1, 1, 1), {})
        want = ref.trunk(x)
        proj = [torch.randn(t.shape, generator=gen).to(dev) for t in want]
        sum((w.float() * q).sum() for w, q in zip(got, proj)).backward()
        sum((w * q).sum() for w, q in zip(want, proj)).backward()
    finally:
        del RC.CONVNEXT["one_block_base"]
    for i, (a, b) in enumerate(zip(got, want)):
        rel = float((a.float() - b).detach().norm() / b.detach().norm())
        assert a.dtype == torch.bfloat16 and rel <= 2e-2, (i, rel)
    named = dict(trunk.named_parameters())
    worst = max((float((named[k[9:]].grad - v.grad).norm() / v.grad.norm()),
                 k) for k, v in leaves.items())
    print(f"convnext trunk bf16 vs f32: worst gradient {worst}")
    assert worst[0] <= 5e-2, worst


@pytest.mark.gpu
def test_gpu_convnext_trunk_makes_no_layout_copy():
    """ConvNeXt-B's trunk held in bf16 (as serving casts it) on a
    ``channels_last`` bf16 input: no copy, transpose or layout kernel in its
    forward (the NHWC views of LayerNorm and the Linears are free), and
    its spans open once a block (``convnext.dwconv``, ``convnext.mlp``) or
    once a norm (``convnext.norm``: 36 + 8)."""
    from torch.profiler import ProfilerActivity

    from basi_tpu_torch.models.convnext import CONVNEXT, ConvNeXtTrunk
    from basi_tpu_torch.utils import profiling as P

    dev = _cuda()
    trunk = ConvNeXtTrunk(*CONVNEXT["convnext_base"]).to(dev).to(
        torch.bfloat16).to(memory_format=torch.channels_last)
    x = torch.randn(2, 3, 256, 256, device=dev, dtype=torch.bfloat16
                    ).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        trunk(x)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA,
                                                ProfilerActivity.CPU]) as prof:
            trunk(x)
            torch.cuda.synchronize()
    spans = P.report()["spans"]
    P.reset()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    layout = [k for k in kernels if any(
        f in k.lower() for f in ("copy", "transpose", "nchwtonhwc",
                                 "nhwctonchw", "permute", "contiguous"))]
    assert kernels and not layout, layout
    assert spans["convnext.dwconv"]["calls"] == 36
    assert spans["convnext.mlp"]["calls"] == 36
    assert spans["convnext.norm"]["calls"] == 44
