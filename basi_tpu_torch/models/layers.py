"""Conv and norm layers with the JAX package's mixed-precision contract.

Flax modules built with ``dtype=bfloat16, param_dtype=float32`` keep f32
params and cast them to bf16 inside every conv, while BatchNorm and
GroupNorm take their statistics and normalize in f32 and round the result
to bf16 once. So every activation is bf16 and every master weight f32, and
``torch.autocast`` would not match (it runs GroupNorm in f32 and leaves its
output f32). These subclasses write the contract out:

* ``Conv2d`` computes in its input's dtype: weight and bias are cast to it
  on the way in, so the gradient reaches an f32 master as f32.
* ``GroupNorm`` normalizes in at least f32 and casts back to the input's
  dtype.
* ``BatchNorm2d`` takes an explicit ``train`` flag. Train mode normalizes
  with the batch statistics and keeps them; ``update_running_stats`` then
  moves the running ones as flax does, ``ra = 0.9 * ra + 0.1 * stat`` with
  the *biased* variance (``nn.BatchNorm2d`` would use momentum 0.1 on the
  unbiased one). Eval mode reads the running statistics whatever the
  module's ``training``. Inside ``no_running_update`` (the trunk's
  recompute under ``train.remat``) train mode keeps no statistics, so the
  running ones move once a step. Params held in bf16
  (``model.param_dtype``) enter the normalization widened to the f32
  statistics, as flax's BatchNorm promotes them.

State-dict names are ``nn``'s, so ``export_basinet`` output loads as before.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_MOMENTUM = 0.9  # flax's: the weight of the old running value


@contextlib.contextmanager
def no_running_update(module: nn.Module):
    """The train-mode BatchNorms of ``module`` keep no batch statistics
    inside, so ``update_running_stats`` finds nothing of theirs: the
    context of a checkpointed trunk's recompute, which runs in the
    backward."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for bn in bns:
        bn.keeps_stats = False
    try:
        yield
    finally:
        for bn in bns:
            bn.keeps_stats = True




class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class GroupNorm(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, torch.float32)  # flax: at least f32
        return F.group_norm(x.to(dt), self.num_groups, self.weight.to(dt),
                            self.bias.to(dt), self.eps).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    # (mean, 1/sqrt(var + eps)) of the last train-mode call, until
    # update_running_stats folds them into the running statistics
    batch_stats: tuple[torch.Tensor, torch.Tensor] | None = None
    # True where batch_stats holds (mean, biased var) itself
    # (models/norm.py's FusedBatchNorm)
    stats_hold_var = False
    keeps_stats = True  # False inside no_running_update

    def scale_bias(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(scale, bias) in the running statistics' dtype: bf16 params
        (``model.param_dtype``) widened to the f32 statistics; a model cast
        whole to one dtype (serving) as it is."""
        dt = self.running_mean.dtype
        return self.weight.to(dt), self.bias.to(dt)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        weight, bias = self.scale_bias()
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                weight, bias, False, 0.0, self.eps)
        # Normalize with the batch statistics (taken in f32 from a bf16
        # input; the output keeps the input's dtype) and keep them for the
        # running update.
        y, mean, invstd = torch.native_batch_norm(
            x, weight, bias, None, None, True, 0.0, self.eps)
        if self.keeps_stats:
            self.batch_stats = (mean.detach(), invstd.detach())
        return y


@torch.no_grad()
def update_running_stats(bns: list[BatchNorm2d]) -> None:
    """flax's running update for every BN that ran in train mode since the
    last call: ``ra = m * ra + (1 - m) * stat`` with the biased variance,
    as a handful of foreach launches for all layers (not a few per layer).
    The variance is the layer's own where it hands one over (fused layers:
    flax's clamped one-pass variance), else ``1/invstd^2 - eps``."""
    held = [bn for bn in bns if bn.batch_stats is not None
            and bn.stats_hold_var]
    from_inv = [bn for bn in bns if bn.batch_stats is not None
                and not bn.stats_hold_var]
    ran = held + from_inv
    if not ran:
        return
    means = [bn.batch_stats[0] for bn in ran]
    var = [bn.batch_stats[1] for bn in held]
    if from_inv:
        v = torch._foreach_pow([bn.batch_stats[1] for bn in from_inv], -2)
        torch._foreach_sub_(v, [bn.eps for bn in from_inv])
        var += v
    for ra, stat in (([bn.running_mean for bn in ran], means),
                     ([bn.running_var for bn in ran], var)):
        torch._foreach_mul_(ra, BN_MOMENTUM)
        torch._foreach_add_(ra, stat, alpha=1 - BN_MOMENTUM)
    for bn in ran:
        bn.batch_stats = None
