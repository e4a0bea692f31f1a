"""Cross-modality feature fusion (mirrors cmda_tpu.models.fusion).

Each takes two 4-scale NCHW pyramids and returns one fused pyramid. In
training each MiT block takes its drop-path uniforms, ``u`` [n_blocks, 2, B]
in ``basic_block`` order (empty for the modules without one), and
``bn_train`` puts the BatchNorms on batch statistics that move the running
statistics (the JAX module's ``train``: the EMA teacher's fusion runs on
running statistics while its head takes batch statistics); ``remat=True``
checkpoints each MiT block.
  * AttentionAvgFusion: per scale, one MiT block on the image tokens and one
    on the event tokens (``basic_block.{2i}`` / ``basic_block.{2i+1}``),
    averaged. cs2dsec's ``fusion_module``.
  * AttentionFusion: per scale, channel concat (2C) -> MiT block at 2C
    (``basic_block.{i}``) -> MixFFN 2C->C (``linear_block.{i}``). cs2dz's
    ``fusion_module`` and cs2dsec's ``fusion_isr_module``.
  * AverageFusion (``--fusion af``): the elementwise mean.
  * ConcatenateFusion: channel concat -> 3x3 conv (``conv{i}``).
  * ConvertAvgFusion (``--fusion caf``): a ResNet BasicBlock per stream
    (``basic_block.{2i}`` image, ``basic_block.{2i+1}`` events), averaged.
  * FeaturesSplit: the difference of two BasicBlocks on one pyramid
    (``block_a{i}`` / ``block_b{i}``).

ConcatenateFusion and ConvertAvgFusion have the JAX modules' fixed widths
(64, 128, 320, 512), whatever the backbone: ConcatenateFusion outputs them,
and ConvertAvgFusion's residual only adds up at them. So both exist at the
MiT-b1..b5 widths only, and the port raises ``ValueError`` for others.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Conv2d, StreamBatchNorm, maybe_checkpoint
from .mit import MiTBlock, MixFFN, map_to_tokens, tokens_to_map

# the JAX ConcatenateFusion / ConvertAvgFusion widths
FIXED_WIDTHS = (64, 128, 320, 512)


class AttentionAvgFusion(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (64, 128, 320, 512),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1), num_heads: int = 1,
                 drop_path_rate: float = 0.05, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.basic_block = nn.ModuleList([
            MiTBlock(c, num_heads, sr_ratio=sr_ratios[i], qkv_bias=True,
                     drop_path=drop_path_rate)
            for i, c in enumerate(in_channels) for _ in range(2)])

    def forward(self, image_feats, events_feats, u=None, bn_train=False):
        fused = []
        for i, (fi, fe) in enumerate(zip(image_feats, events_feats)):
            hw = fi.shape[2:]
            ui, ue = (None, None) if u is None else (u[2 * i], u[2 * i + 1])
            xi = maybe_checkpoint(self.basic_block[2 * i], map_to_tokens(fi),
                                  hw, ui, remat=self.remat)
            xe = maybe_checkpoint(self.basic_block[2 * i + 1],
                                  map_to_tokens(fe), hw, ue, remat=self.remat)
            fused.append(tokens_to_map((xi + xe) / 2, hw))
        return fused


class AttentionFusion(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (64, 128, 320, 512),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1), num_heads: int = 1,
                 drop_path_rate: float = 0.05, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.basic_block = nn.ModuleList([
            MiTBlock(2 * c, num_heads, sr_ratio=sr_ratios[i], qkv_bias=True,
                     drop_path=drop_path_rate)
            for i, c in enumerate(in_channels)])
        self.linear_block = nn.ModuleList([
            MixFFN(2 * c, c, c) for c in in_channels])

    def forward(self, image_feats, events_feats, u=None, bn_train=False):
        fused = []
        for i, (fi, fe) in enumerate(zip(image_feats, events_feats)):
            hw = fi.shape[2:]
            x = map_to_tokens(torch.cat([fi, fe], dim=1))
            x = maybe_checkpoint(self.basic_block[i], x, hw,
                                 None if u is None else u[i],
                                 remat=self.remat)
            fused.append(tokens_to_map(self.linear_block[i](x, hw), hw))
        return fused


class AverageFusion(nn.Module):
    """The elementwise mean of the two pyramids (no parameters)."""

    def __init__(self, in_channels: Sequence[int] = FIXED_WIDTHS,
                 remat: bool = False):
        super().__init__()

    def forward(self, image_feats, events_feats, u=None, bn_train=False):
        return [(a + b) / 2 for a, b in zip(image_feats, events_feats)]


def _check_fixed_widths(kind: str, in_channels: Sequence[int]):
    if tuple(in_channels) != FIXED_WIDTHS:
        raise ValueError(
            f"fusion {kind!r} has the JAX module's fixed widths "
            f"{FIXED_WIDTHS} (the MiT-b1..b5 pyramids), not the backbone's "
            f"{tuple(in_channels)}")


class ConcatenateFusion(nn.Module):
    """Per scale, channel concat -> 3x3 conv with bias to the fixed width."""

    def __init__(self, in_channels: Sequence[int] = FIXED_WIDTHS,
                 remat: bool = False):
        super().__init__()
        _check_fixed_widths("concatenate", in_channels)
        for i, c in enumerate(FIXED_WIDTHS):
            self.add_module(f"conv{i}", Conv2d(2 * in_channels[i], c, 3,
                                               padding=1))

    def forward(self, image_feats, events_feats, u=None, bn_train=False):
        return [getattr(self, f"conv{i}")(torch.cat([a, b], dim=1))
                for i, (a, b) in enumerate(zip(image_feats, events_feats))]


class BasicBlock(nn.Module):
    """ResNet BasicBlock: 3x3 conv, BN, ReLU, 3x3 conv, BN, + the input,
    ReLU (mmcv's names ``conv1``, ``bn1``, ``conv2``, ``bn2``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn1 = StreamBatchNorm(channels)
        self.conv2 = Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = StreamBatchNorm(channels)

    def forward(self, x, bn_train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), bn_train))
        return F.relu(self.bn2(self.conv2(y), bn_train) + x)


class ConvertAvgFusion(nn.Module):
    """Per scale, a BasicBlock on each stream, averaged."""

    def __init__(self, in_channels: Sequence[int] = FIXED_WIDTHS,
                 remat: bool = False):
        super().__init__()
        _check_fixed_widths("convert_avg", in_channels)
        self.basic_block = nn.ModuleList([
            BasicBlock(c) for c in FIXED_WIDTHS for _ in range(2)])

    def forward(self, image_feats, events_feats, u=None, bn_train=False):
        return [(self.basic_block[2 * i](a, bn_train)
                 + self.basic_block[2 * i + 1](b, bn_train)) / 2
                for i, (a, b) in enumerate(zip(image_feats, events_feats))]


class FeaturesSplit(nn.Module):
    """Content/motion split: per scale, the difference of two BasicBlocks
    on one pyramid."""

    def __init__(self, in_channels: Sequence[int] = FIXED_WIDTHS):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"block_a{i}", BasicBlock(c))
            self.add_module(f"block_b{i}", BasicBlock(c))

    def forward(self, feats, bn_train: bool = False):
        return [getattr(self, f"block_a{i}")(a, bn_train)
                - getattr(self, f"block_b{i}")(a, bn_train)
                for i, a in enumerate(feats)]


FUSION_REGISTRY = {
    "attention_avg": AttentionAvgFusion,
    "attention": AttentionFusion,
    "average": AverageFusion,
    "concatenate": ConcatenateFusion,
    "convert_avg": ConvertAvgFusion,
}


def build_fusion_module(kind: str, in_channels: Sequence[int],
                        remat: bool = False):
    if kind in ("", "none", None):
        return None
    if kind not in FUSION_REGISTRY:
        raise ValueError(f"unknown fusion {kind!r} (one of "
                         f"{sorted(FUSION_REGISTRY)})")
    return FUSION_REGISTRY[kind](in_channels=tuple(in_channels), remat=remat)


def num_drop_path_blocks(module) -> int:
    """How many MiT blocks (rows of ``u``) a fusion module has: 0 for the
    modules without one (AverageFusion, ConcatenateFusion, the BasicBlocks
    of ConvertAvgFusion)."""
    if module is None:
        return 0
    return sum(isinstance(m, MiTBlock) for m in module.modules())
