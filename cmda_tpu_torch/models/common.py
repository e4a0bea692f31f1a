"""Shared building blocks (mirrors cmda_tpu.models.common), NCHW.

Random initialisation follows the reference scheme (truncated normal std
0.02 for linear layers, fan-out normal for convs) through ``init_weights``,
which takes an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class DropPath(nn.Module):
    """Per-sample stochastic depth; the identity in eval mode."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class StreamBatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW in eval mode: running statistics, eps 1e-5, math
    in float32 (flax ``BatchNorm`` semantics of the JAX package). The
    train-mode grouped batch statistics of cmda_tpu.models.common come with
    the trainer; until then train mode raises instead of computing torch's
    different running-variance update."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "StreamBatchNorm train mode is not ported yet; call .eval()")
        y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                         self.weight, self.bias, False, 0.0, self.eps)
        return y.to(x.dtype)


class ConvBNReLU(nn.Module):
    """mmcv ConvModule (conv without bias -> BN -> ReLU): children ``conv``
    and ``bn``. The variants without norm or activation come with the
    modules that use them."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 dilation: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel_size,
                              padding=dilation * (kernel_size // 2),
                              dilation=dilation, groups=groups, bias=False)
        self.bn = StreamBatchNorm(features)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator):
    """Reference random init, drawn from ``generator`` in module order:
    Linear trunc-normal(0.02) with zero bias; Conv normal(0, sqrt(2/fan_out))
    with fan_out divided by groups, zero bias; the classifier normal(0.01);
    norms weight 1, bias 0, running mean 0, running var 1."""
    from .daformer import Classifier
    for m in module.modules():
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Classifier):
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
