"""Shared building blocks (mirrors cmda_tpu.models.common), NCHW.

Every layer computes in the dtype of its input, as the JAX package's
modules compute in their ``dtype``: float32 parameters, cast per call, so a
bfloat16 input runs the matmuls and convolutions in bfloat16 and hands
bfloat16 activations on, while the norms take their statistics in float32.

Random initialisation follows the reference scheme (truncated normal std
0.02 for linear layers, fan-out normal for convs) through ``init_weights``,
which takes an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

# the outputs that remat_policy='dots' keeps: the matrix products without
# batch dimensions (the linears), as JAX's
# ``checkpoint_policies.dots_with_no_batch_dims_saveable``; the attention's
# batched products (bmm) and the convolutions are recomputed, as there
DOTS_SAVED = frozenset({torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def maybe_checkpoint(fn, *args, remat: bool, policy: str = "full"):
    """``fn(*args)``, rematerialised in the backward pass
    (``torch.utils.checkpoint``, non-reentrant) when ``remat`` is set and
    gradients are being recorded. ``policy='dots'`` saves the outputs of
    ``DOTS_SAVED`` and recomputes the rest (selective checkpointing, the
    JAX package's ``remat_policy='dots'``); any other name rematerialises
    the whole of ``fn``, as the JAX package does. The values are the
    same under every policy."""
    if remat and torch.is_grad_enabled():
        if policy == "dots":
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=_dots_context)
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype, its float32 weights
    cast to it: a flax ``Dense`` with ``dtype``, as the JAX package's
    bfloat16 mode runs it (bfloat16 in, bfloat16 out)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype, its float32 weights
    cast to it (a flax ``Conv`` with ``dtype``)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with its statistics and affine in float32 and its
    output in the input's dtype (a flax ``LayerNorm`` with ``dtype``)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


def divide_by(x: torch.Tensor, value: float, cache: dict) -> torch.Tensor:
    """``x / value`` with ``value`` rounded to ``x``'s dtype and a true
    division, as JAX divides an array by a weakly typed scalar. (A Python
    scalar divisor would be a reciprocal multiply on CUDA.) ``cache``, the
    calling module's dict, keeps the 0-d divisor per value, dtype and
    device, so a call launches only the division."""
    key = (value, x.dtype, x.device)
    d = cache.get(key)
    if d is None:
        d = cache[key] = torch.full((), value, dtype=x.dtype, device=x.device)
    return x / d


class DropPath(nn.Module):
    """Per-sample stochastic depth with pre-drawn uniforms: ``u`` [B] keeps
    sample b iff ``u[b] < 1 - rate`` (a Bernoulli(1 - rate) draw, as
    cmda_tpu.models.mit.MiTBlockScan._drop_path), dividing kept samples by
    1 - rate. Without ``u`` it is the identity (eval).

    keep = 1 - rate is taken in float32 for the mask; the divisor is keep
    rounded to the activation's dtype, as the JAX package divides (an
    explicit cast in ``MiTBlockScan._drop_path``, weak typing in
    ``common.DropPath``): in bfloat16, x / bf16(0.95), not x / 0.95."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self._divisors = {}

    def forward(self, x, u: torch.Tensor | None = None):
        if u is None or self.rate == 0.0:
            return x
        keep = float(np.float32(1.0) - np.float32(self.rate))
        mask = (u < keep).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return torch.where(mask, divide_by(x, keep, self._divisors),
                           torch.zeros_like(x))


class StreamBatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW with the flax ``BatchNorm`` semantics of the JAX
    package (eps 1e-5, math in float32). The mode is the call's, not the
    module's ``training`` flag:

    * ``bn_train=False``: normalise with the running statistics;
    * ``bn_train=True``: normalise with the batch statistics, the variance
      in one pass, ``E[x^2] - E[x]^2`` clamped at 0, and (``update=True``)
      move the running statistics by ``r <- 0.9 r + 0.1 s`` with the
      **biased** batch variance (``nn.BatchNorm2d``'s own update keeps the
      unbiased one, so it is not used);
    * ``bn_train=True, update=False``: batch statistics, running statistics
      untouched (the EMA teacher's forward).

    ``groups=k`` (cmda_tpu.models.common.StreamBatchNorm's
    ``stream_groups``) takes the batch as k stacked streams through a
    shared decoder: each group is normalised by its own batch statistics,
    as k calls one after another would be, and the running statistics take
    the k-fold sequential update ``r' = m^k r + (1-m) sum_i m^(k-1-i) s_i``
    in one step."""

    MOMENTUM = 0.9

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x, bn_train: bool = False, update: bool = True,
                groups: int = 1):
        if not bn_train:
            y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.to(x.dtype)
        xf = x.float()
        if groups == 1:
            dims, shape = (0, 2, 3), (1, -1, 1, 1)
        else:   # [k, B/k, C, H, W]
            xf = xf.reshape((groups, -1) + tuple(x.shape[1:]))
            dims, shape = (1, 3, 4), (groups, 1, -1, 1, 1)
        mean = xf.mean(dim=dims)
        var = ((xf * xf).mean(dim=dims) - mean * mean).clamp(min=0.0)
        affine = (1, -1, 1, 1)
        y = ((xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                      + self.eps)
             * self.weight.reshape(affine) + self.bias.reshape(affine))
        if update:
            self._update_running(mean.detach().reshape(groups, -1),
                                 var.detach().reshape(groups, -1))
        return y.reshape(x.shape).to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean, var):
        """The running statistics after ``len(mean)`` sequential updates
        with the groups' statistics ``mean``, ``var`` [k, C]."""
        m, k = self.MOMENTUM, mean.shape[0]
        if k == 1:
            self.running_mean.mul_(m).add_(mean[0], alpha=1.0 - m)
            self.running_var.mul_(m).add_(var[0], alpha=1.0 - m)
            return
        # in float32, as the JAX package weighs them
        w = (1.0 - m) * torch.pow(
            torch.tensor(m, dtype=torch.float32, device=mean.device),
            torch.arange(k - 1, -1, -1, dtype=torch.float32,
                         device=mean.device))
        decay = m ** k
        self.running_mean.copy_(decay * self.running_mean + w @ mean)
        self.running_var.copy_(decay * self.running_var + w @ var)


class ConvBNReLU(nn.Module):
    """mmcv ConvModule (conv without bias -> BN -> ReLU): children ``conv``
    and ``bn``. The variants without norm or activation come with the
    modules that use them."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 dilation: int = 1, groups: int = 1):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel_size,
                           padding=dilation * (kernel_size // 2),
                           dilation=dilation, groups=groups, bias=False)
        self.bn = StreamBatchNorm(features)

    def forward(self, x, bn_train: bool = False, update: bool = True,
                groups: int = 1):
        return F.relu(self.bn(self.conv(x), bn_train, update, groups))


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator):
    """Reference random init, drawn from ``generator`` in module order:
    Linear trunc-normal(0.02) with zero bias; Conv normal(0, sqrt(2/fan_out))
    with fan_out divided by groups, zero bias; the classifiers (DLV2Head's
    dilated branches too) normal(0.01); norms weight 1, bias 0, running
    mean 0, running var 1."""
    from .daformer import Classifier
    from .heads import DLV2Branch
    for m in module.modules():
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (Classifier, DLV2Branch)):
            m.weight.normal_(0.0, 0.01, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            fan_out = kh * kw * m.out_channels // m.groups
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                             generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
