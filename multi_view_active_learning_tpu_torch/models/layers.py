"""Layers with the JAX package's training semantics.

  * ``Conv2d`` / ``ConvTranspose2d`` run in their input's dtype and cast
    their weights to it.  The inference model stores its weights in the
    compute dtype, so the cast costs nothing there; the engine's training
    step binds float32 master weights in their place, which then train as
    flax trains them (``param_dtype=float32``, bf16 compute) while the
    float32 final layer stays float32.
  * ``BatchNorm2d`` in train mode normalizes by the batch statistics and
    leaves its running statistics alone.  It records the batch mean and
    the **biased** variance (float32) in ``batch_stats``, once a step, for
    the engine to fold into the running statistics as flax does
    (``ra = 0.9 ra + 0.1 batch``, JAX models/pose_resnet.py:41-50).
    ``nn.BatchNorm2d`` would fold the unbiased variance in, in place, and
    a rematerialized forward (``TPU.REMAT``) would fold it in twice.
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


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """Float32 parameters and statistics; the output in the input's dtype."""

    batch_stats = None  # (mean, biased var) of the last train-mode batch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True,
                                                  0.0, self.eps)
        if self.batch_stats is None:
            self.batch_stats = (mean.detach(), (invstd.detach() ** -2) - self.eps)
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
