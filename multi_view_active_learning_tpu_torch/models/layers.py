"""Layers with the JAX package's training semantics.

  * ``Conv2d`` / ``ConvTranspose2d`` run in their input's dtype and cast
    their weights to it.  The inference model stores its weights in the
    compute dtype, so the cast costs nothing there; the engine's training
    step binds float32 master weights in their place, which then train as
    flax trains them (``param_dtype=float32``, bf16 compute) while the
    float32 final layer stays float32.
  * ``BatchNorm2d`` in train mode normalizes by the statistics of the
    **global** batch, as JAX computes them over a sharded batch (JAX
    engine.py:19-21): ``_GlobalBatchNorm`` sums each channel's count, mean
    and centered sum of squares over the ranks of the module's ``group``
    (set by the engine to the batch's group, ``parallel.batch_group``: every
    rank when views shard, the data group when the ranks of a data row hold
    the same crops; the identity in one process), and in the backward pass
    the sums of ``dy`` and ``dy * xhat`` that the other ranks' share of the
    gradient needs.  The
    variance is combined from each rank's centered one in float64, not
    taken as flax's ``E[x^2] - E[x]^2``, which loses the digits of a
    variance far below the squared mean (ROADMAP Queue C7): a batch padded
    with a copy of its frame then trains like the frame alone.  It leaves
    its running statistics alone and records the mean and the **biased**
    variance in ``batch_stats``, once a step, for the engine to fold into
    the running statistics as flax does (``ra = 0.9 ra + 0.1 batch``, JAX
    models/pose_resnet.py:41-50).  ``nn.BatchNorm2d`` (and
    ``nn.SyncBatchNorm``) would fold the unbiased variance in, in place,
    and a rematerialized forward (``TPU.REMAT``) would fold it in twice.
  * ``run_block`` rematerializes a block under ``TPU.REMAT`` with
    ``torch.utils.checkpoint`` (non-reentrant): the recomputed forward
    finds each BatchNorm's record taken and leaves it as it is.

Module names and state-dict keys are those of the torch layers they
subclass, so reference state dicts load unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import parallel


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm with the statistics of the global batch.

    Forward: the native kernel normalizes this rank's rows by their own
    statistics; each rank's count, mean and sum of squares about its mean
    are then summed over the ranks of `group` in float64, as ``[n * mean | M2 + n *
    mean^2 | n]`` (one collective), giving the global mean and biased
    variance, and with more than one rank the rows are normalized again by
    those.  Backward: the native kernel's gradient uses this rank's means of
    ``dy`` and ``dy * xhat``; their sums are summed over the ranks (one
    collective), and with more than one rank ``dx`` is corrected to the
    global means, ``w * invstd * (mean_r - mean_global)`` per term.  The
    weight and bias get this rank's share, which the engine's gradient
    sum completes.  In one process the sums are this batch's, by the same
    code, and every result is the native kernel's."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        n = x.numel() // c
        y, mean, invstd = torch.native_batch_norm(x, weight, bias, None, None, True, 0.0, eps)
        mean64 = mean.double()
        m2 = (invstd.double() ** -2 - eps) * n
        sums = parallel.all_reduce_sum(torch.cat([
            mean64 * n, m2 + n * mean64 * mean64,
            torch.full((1,), n, dtype=torch.float64, device=x.device)]), group)
        total = sums[-1]
        mean64 = sums[:c] / total
        batch_mean = mean64.to(weight.dtype)
        batch_var = torch.clamp(sums[c:2 * c] / total - mean64 * mean64, min=0.0).to(weight.dtype)
        if parallel.group_size(group) > 1:
            mean, invstd = batch_mean, torch.rsqrt(batch_var + eps)
            y = torch.batch_norm(x, weight, bias, batch_mean, batch_var, False, 0.0, eps,
                                 torch.backends.cudnn.enabled)
        ctx.save_for_backward(x, weight, mean, invstd, total)
        ctx.eps, ctx.group = eps, group
        ctx.mark_non_differentiable(batch_mean, batch_var)
        return y, batch_mean, batch_var

    @staticmethod
    def backward(ctx, grad, _grad_mean, _grad_var):
        x, weight, mean, invstd, total = ctx.saved_tensors
        c = x.shape[1]
        n = x.numel() // c
        dx, dw, db = torch.ops.aten.native_batch_norm_backward(
            grad, x, weight, None, None, mean, invstd, True, ctx.eps, [True, True, True])
        # db = sum(dy), dw = sum(dy * xhat) over this rank's rows.
        sums = parallel.all_reduce_sum(torch.cat([db, dw]), ctx.group)
        if parallel.group_size(ctx.group) > 1:
            total = total.to(dw.dtype)
            alpha = db / n - sums[:c] / total
            beta = (dw / n - sums[c:] / total) * invstd
            scale = weight * invstd
            dx = torch.addcmul((dx.to(scale.dtype) + (scale * (alpha - mean * beta))[:, None, None]),
                               x, (scale * beta)[:, None, None]).to(x.dtype)
        return dx, dw, db, None, None


class BatchNorm2d(nn.BatchNorm2d):
    """Float32 parameters and statistics; the output in the input's dtype."""

    batch_stats = None  # (mean, biased var) of the last train-mode batch
    group = None  # the ranks whose rows make the batch (parallel.Group; None: every rank)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, self.group)
        if self.batch_stats is None:
            self.batch_stats = (mean, var)
        return y


def batch_norms(model: nn.Module):
    """(name, module) of every BatchNorm2d of `model`, in module order."""
    return [(name, m) for name, m in model.named_modules() if isinstance(m, BatchNorm2d)]


def run_block(block, x, remat: bool):
    """`block(x)`, rematerialized in the backward pass when `remat` is set
    and autograd records this forward."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, x, use_reentrant=False)
    return block(x)
