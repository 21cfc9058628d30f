"""Fused BatchNorm (port of ``basi_tpu/models/norm.py``).

``model.bn_impl`` picks every trunk BN: ``"xla"`` is ``layers.BatchNorm2d``
(the framework's batch norm); ``"fused"`` and ``"stats"`` are
``FusedBatchNorm``, whose batch statistics come from the ``channel_moments``
kernel (``kernels/bn_stats.py``):

forward:   mu = Sx/M, var = max(Sx2/M - mu^2, 0) (one pass), inv = rsqrt(var+eps)
           y  = x*a + b with a = scale*inv, b = bias - mu*a, in f32, cast once
backward ("fused", ``bn_train_apply``): (Sg, Sgx) from ``channel_dual_sums``;
           m_g = Sg/M, m_gxn = (Sgx - mu*Sg)*inv/M
           dx = a*g - a*m_g - (a*inv*m_gxn)*(x - mu)
           dscale = (Sgx - mu*Sg)*inv, dbias = Sg
backward ("stats", ``batch_moments``): only the moments have a hand-written
           backward, the elementwise dx = g_mean/M + 2x*g_msq/M; the apply
           is a plain expression that autograd differentiates.

In mode "fused" the kernels compute every per-channel term in their last
block (``bn_forward_terms``, ``bn_backward_terms``), and the two elementwise
passes over x are kernels too (``kernels/bn_apply.py``: ``bn_apply``,
``bn_input_gradient``): two launches each way, the same values bit for bit
as the plain passes. In mode "stats" the kernel returns the means
(``channel_means``) and the rest is ``bn_forward_math`` and the plain apply
in tensor operations, which autograd differentiates.

The one-pass variance is what the TPU kernel feeds, and it is mirrored:
where a channel's mean dwarfs its spread it cancels in f32, as the JAX
package's does. Each step follows the JAX functions' order of operations.
The model is NCHW in ``channels_last`` memory, so the kernels read the NHWC
view of x (and of its gradient) in place. Names, parameters, buffers and the
eval path are ``BatchNorm2d``'s, so state dicts and ``convert.py`` serve
every ``bn_impl``, and serving launches no kernel.
"""

from __future__ import annotations

import torch

from basi_tpu_torch.kernels.bn_apply import (
    bn_apply,
    bn_apply_reference,
    bn_input_gradient,
)
from basi_tpu_torch.kernels.bn_stats import (
    bn_backward_terms,
    bn_forward_math,
    bn_forward_terms,
    channel_means,
)
from basi_tpu_torch.models.layers import BatchNorm2d


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _count(x: torch.Tensor) -> int:
    return x.shape[0] * x.shape[2] * x.shape[3]


class _BNTrainApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        mean, var, inv, a, b = bn_forward_terms(_nhwc(x), scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return bn_apply(x, a, b), mean, var

    @staticmethod
    def backward(ctx, gy, _g_mean, _g_var):
        # mean and var only feed the running update: no cotangent
        x, scale, mean, inv = ctx.saved_tensors
        dscale, dbias, a, a_mg, a_inv_mgxn = bn_backward_terms(
            _nhwc(gy), _nhwc(x), scale, mean, inv)
        dx = bn_input_gradient(gy, x, mean, a, a_mg, a_inv_mgxn)
        return dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None


def bn_train_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float):
    """Train-mode BN of NCHW ``x`` on its batch statistics over (N, H, W):
    (y in x's dtype, mean, biased var), the last two f32 and
    non-differentiable, with the hand-written backward."""
    return _BNTrainApply.apply(x, scale, bias, eps)


class _BatchMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return channel_means(_nhwc(x))

    @staticmethod
    def backward(ctx, g_mean, g_msq):
        (x,) = ctx.saved_tensors
        m = _count(x)
        dx = x * _per_channel(2.0 * (g_msq / m))
        return dx.add_(_per_channel(g_mean / m)).to(x.dtype)


def batch_moments(x: torch.Tensor):
    """(mean, mean of squares) over (N, H, W) of NCHW ``x``, f32, with the
    elementwise backward."""
    return _BatchMoments.apply(x)


class FusedBatchNorm(BatchNorm2d):
    """``BatchNorm2d`` whose train mode takes its statistics from the
    ``bn_stats`` kernels. ``mode="full"``: ``bn_train_apply``;
    ``mode="stats"``: ``batch_moments`` and a plain apply. Eval mode is
    ``BatchNorm2d``'s. Hands (mean, biased var) to
    ``layers.update_running_stats``."""

    stats_hold_var = True

    def __init__(self, num_features: int, eps: float = 1e-5,
                 mode: str = "full"):
        if mode not in ("full", "stats"):
            raise ValueError(f"FusedBatchNorm mode {mode!r} (full | stats)")
        super().__init__(num_features, eps=eps)
        self.mode = mode

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return super().forward(x, False)
        weight, bias = self.scale_bias()
        if self.mode == "stats":
            mean, var, _, a, b = bn_forward_math(
                *batch_moments(x), weight, bias, self.eps)
            y = bn_apply_reference(x, a, b)
        else:
            y, mean, var = bn_train_apply(x, weight, bias, self.eps)
        if self.keeps_stats:
            self.batch_stats = (mean.detach(), var.detach())
        return y


def make_batch_norm(impl: str, num_features: int,
                    eps: float = 1e-5) -> BatchNorm2d:
    """The BN of one trunk site for ``model.bn_impl``: "xla" ->
    ``BatchNorm2d``, "fused" / "stats" -> ``FusedBatchNorm``."""
    if impl in ("fused", "stats"):
        return FusedBatchNorm(num_features, eps=eps,
                              mode="full" if impl == "fused" else "stats")
    if impl != "xla":
        raise ValueError(f"model.bn_impl={impl!r} (expected 'xla', 'fused' "
                         "or 'stats')")
    return BatchNorm2d(num_features, eps=eps)
