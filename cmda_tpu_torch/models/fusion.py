"""Cross-modality feature fusion (mirrors cmda_tpu.models.fusion; the two
attention fusions the flagship presets use).

Both take two 4-scale NCHW pyramids and return one fused pyramid. In
training each MiT block takes its drop-path uniforms, ``u`` [n_blocks, 2, B]
in ``basic_block`` order; ``remat=True`` checkpoints each block.
  * AttentionAvgFusion: per scale, one MiT block on the image tokens and one
    on the event tokens (``basic_block.{2i}`` / ``basic_block.{2i+1}``),
    averaged. cs2dsec's ``fusion_module``.
  * AttentionFusion: per scale, channel concat (2C) -> MiT block at 2C
    (``basic_block.{i}``) -> MixFFN 2C->C (``linear_block.{i}``). cs2dz's
    ``fusion_module`` and cs2dsec's ``fusion_isr_module``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .common import maybe_checkpoint
from .mit import MiTBlock, MixFFN, map_to_tokens, tokens_to_map


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

    def forward(self, image_feats, events_feats, u=None):
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

    def forward(self, image_feats, events_feats, u=None):
        fused = []
        for i, (fi, fe) in enumerate(zip(image_feats, events_feats)):
            hw = fi.shape[2:]
            x = map_to_tokens(torch.cat([fi, fe], dim=1))
            x = maybe_checkpoint(self.basic_block[i], x, hw,
                                 None if u is None else u[i],
                                 remat=self.remat)
            fused.append(tokens_to_map(self.linear_block[i](x, hw), hw))
        return fused


FUSION_REGISTRY = {
    "attention_avg": AttentionAvgFusion,
    "attention": AttentionFusion,
}


def build_fusion_module(kind: str, in_channels: Sequence[int],
                        remat: bool = False):
    if kind in ("", "none", None):
        return None
    if kind not in FUSION_REGISTRY:
        raise NotImplementedError(f"fusion {kind!r} is not ported (ROADMAP "
                                  "queue A item 6; ported: "
                                  f"{sorted(FUSION_REGISTRY)})")
    return FUSION_REGISTRY[kind](in_channels=tuple(in_channels), remat=remat)


def num_drop_path_blocks(module) -> int:
    """How many MiT blocks (rows of ``u``) a fusion module has."""
    return 0 if module is None else len(module.basic_block)
