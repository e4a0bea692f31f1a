"""ResNet-family backbones of the legacy baselines (mirrors
cmda_tpu.models.resnet), NCHW: the V1c deep stem (three 3x3 convs, stride 2
first, then a 3x3 max pool stride 2) and four stages returning the four
maps; the d8 variants (strides (1, 2, 1, 1), dilations (1, 1, 2, 4)) give
output stride 8 for the DeepLab heads.

Parameter names are mmcv's ResNetV1c keys, so an open-mmlab
``resnet101_v1c`` state_dict loads as it is (``load_pretrained_backbone``):
``stem.{0,3,6}`` convs with ``stem.{1,4,7}`` BNs, ``layer{s}.{i}.conv{k}`` /
``bn{k}``, ``layer{s}.{i}.downsample.{0,1}`` (conv, BN). ResNeSt's
split-attention conv is ``conv2.{conv,bn,fc1,fc2}`` and its shortcut's
average pool has no parameters. ``train`` puts every BatchNorm on batch
statistics that move the running statistics (the JAX modules' ``train``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from .common import Conv2d, ConvBNReLU, StreamBatchNorm


def _conv(cin, cout, k, stride=1, dilation=1, groups=1, bias=False):
    return Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2),
                  dilation=dilation, groups=groups, bias=bias)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 to ``planes * 4``, BN after
    each, the shortcut a strided 1x1 + BN in the first block of a stage."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 width: int | None = None, groups: int = 1):
        super().__init__()
        width = planes if width is None else width
        self.stride = stride
        self.conv1 = _conv(in_channels, width, 1)
        self.bn1 = StreamBatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride, dilation, groups)
        self.bn2 = StreamBatchNorm(width)
        self.conv3 = _conv(width, planes * 4, 1)
        self.bn3 = StreamBatchNorm(planes * 4)
        self.downsample = (nn.ModuleList([
            _conv(in_channels, planes * 4, 1, self._shortcut_stride()),
            StreamBatchNorm(planes * 4)]) if downsample else None)

    def _shortcut_stride(self):
        return self.stride

    def _middle(self, y, train):
        return F.relu(self.bn2(self.conv2(y), train))

    def _shortcut(self, x, train):
        if self.downsample is None:
            return x
        conv, bn = self.downsample
        return bn(conv(x), train)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self._middle(y, train)
        y = self.bn3(self.conv3(y), train)
        return F.relu(y + self._shortcut(x, train))


class ResNeXtBottleneck(Bottleneck):
    """The grouped-conv bottleneck: width = int(planes * base_width / 64)
    * groups, the 3x3 conv in ``groups`` groups."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 groups: int = 32, base_width: int = 4):
        super().__init__(in_channels, planes, stride, dilation, downsample,
                         width=int(planes * (base_width / 64.0)) * groups,
                         groups=groups)


class SplitAttentionConv(nn.Module):
    """ResNeSt's SplAtConv2d: a 3x3 conv to channels * radix (groups *
    radix groups) + BN + ReLU, the radix splits summed and pooled, ``fc1``
    (1x1 conv+BN+ReLU to max(channels * radix / 4, 32)), ``fc2`` (1x1 conv
    with bias back to channels * radix), a softmax over the radix in
    float32 weighing the splits."""

    def __init__(self, in_channels: int, channels: int, radix: int = 2,
                 groups: int = 1, stride: int = 1, dilation: int = 1,
                 reduction_factor: int = 4):
        super().__init__()
        self.radix, self.channels = radix, channels
        self.conv = _conv(in_channels, channels * radix, 3, stride, dilation,
                          groups * radix)
        self.bn = StreamBatchNorm(channels * radix)
        inter = max(channels * radix // reduction_factor, 32)
        self.fc1 = ConvBNReLU(channels, inter, 1, groups=groups)
        self.fc2 = _conv(inter, channels * radix, 1, groups=groups,
                         bias=True)

    def forward(self, x, train: bool = False):
        r, c = self.radix, self.channels
        y = F.relu(self.bn(self.conv(x), train))
        b, _, h, w = y.shape
        splits = y.reshape(b, r, c, h, w)
        gap = splits.sum(dim=1).mean(dim=(2, 3), keepdim=True)
        atten = self.fc2(self.fc1(gap, train)).reshape(b, r, c, 1, 1)
        atten = atten.float().softmax(dim=1).to(y.dtype)
        return (splits * atten).sum(dim=1)


class ResNeStBottleneck(Bottleneck):
    """The ResNeSt bottleneck: the split-attention 3x3 at stride 1, then a
    3x3 average pool (padding 1, counted) at the block's stride; the
    shortcut pools by kernel = stride before its 1x1 (avg_down)."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 groups: int = 1, base_width: int = 4, radix: int = 2):
        super().__init__(in_channels, planes, stride, dilation, downsample,
                         width=int(planes * (base_width / 64.0)) * groups)
        width = self.conv1.out_channels
        del self.bn2
        self.conv2 = SplitAttentionConv(width, width, radix=radix,
                                        groups=groups, dilation=dilation)

    def _shortcut_stride(self):
        return 1

    def _middle(self, y, train):
        y = self.conv2(y, train)
        if self.stride > 1:
            y = F.avg_pool2d(y, 3, stride=self.stride, padding=1,
                             count_include_pad=True)
        return y

    def _shortcut(self, x, train):
        if self.downsample is not None and self.stride > 1:
            x = F.avg_pool2d(x, self.stride, stride=self.stride)
        return super()._shortcut(x, train)


@dataclass(frozen=True)
class ResNetConfig:
    depths: Sequence[int] = (3, 4, 6, 3)      # resnet50
    strides: Sequence[int] = (1, 2, 2, 2)
    dilations: Sequence[int] = (1, 1, 1, 1)
    base_planes: int = 64
    block: str = "bottleneck"                 # | 'resnext' | 'resnest'
    groups: int = 1
    base_width: int = 4


RESNET_VARIANTS = {
    "resnet50": ResNetConfig(),
    "resnet101": ResNetConfig(depths=(3, 4, 23, 3)),
    # output-stride-8 dilated variants for the DeepLab heads (V1c-d8)
    "resnet50_d8": ResNetConfig(strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4)),
    "resnet101_d8": ResNetConfig(depths=(3, 4, 23, 3), strides=(1, 2, 1, 1),
                                 dilations=(1, 1, 2, 4)),
    # the legacy grid's extras
    "resnext101_d8": ResNetConfig(depths=(3, 4, 23, 3), strides=(1, 2, 1, 1),
                                  dilations=(1, 1, 2, 4), block="resnext",
                                  groups=32, base_width=4),
    "resnest101_d8": ResNetConfig(depths=(3, 4, 23, 3), strides=(1, 2, 1, 1),
                                  dilations=(1, 1, 2, 4), block="resnest",
                                  base_planes=128),
    "resnest50": ResNetConfig(block="resnest", base_planes=64),
    "resnext50": ResNetConfig(block="resnext", groups=32, base_width=4),
}

OUT_CHANNELS = (256, 512, 1024, 2048)


class ResNetV1c(nn.Module):
    """Deep-stem ResNet: NCHW image -> the four stage maps (256, 512, 1024
    and 2048 channels)."""

    def __init__(self, cfg: ResNetConfig = ResNetConfig(),
                 in_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        half = cfg.base_planes // 2
        self.stem = nn.ModuleList([
            _conv(in_channels, half, 3, stride=2), StreamBatchNorm(half),
            nn.ReLU(), _conv(half, half, 3), StreamBatchNorm(half), nn.ReLU(),
            _conv(half, cfg.base_planes, 3), StreamBatchNorm(cfg.base_planes),
            nn.ReLU()])
        block_cls = {"bottleneck": Bottleneck, "resnext": ResNeXtBottleneck,
                     "resnest": ResNeStBottleneck}[cfg.block]
        extra = ({"groups": cfg.groups, "base_width": cfg.base_width}
                 if cfg.block != "bottleneck" else {})
        cin, planes = cfg.base_planes, 64
        for s in range(4):
            blocks = []
            for i in range(cfg.depths[s]):
                blocks.append(block_cls(
                    cin, planes, stride=cfg.strides[s] if i == 0 else 1,
                    dilation=cfg.dilations[s], downsample=(i == 0), **extra))
                cin = planes * 4
            setattr(self, f"layer{s + 1}", nn.ModuleList(blocks))
            planes *= 2

    def forward(self, x, train: bool = False):
        for j in range(3):
            conv, bn = self.stem[3 * j], self.stem[3 * j + 1]
            x = F.relu(bn(conv(x), train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for s in range(1, 5):
            for blk in getattr(self, f"layer{s}"):
                x = blk(x, train)
            outs.append(x)
        return outs
