"""MixVisionTransformer (SegFormer MiT-b0..b5 encoder), mirrors
cmda_tpu.models.mit.

Parameter names are the reference mmseg/NVlabs state_dict keys
(``patch_embed{s}.proj``, ``block{s}.{i}.attn.q``, ``norm{s}``, ...). Each
stage is a ``ModuleList`` of blocks where the JAX package scans one block
over stacked parameters. Modules take and return NCHW feature maps; inside
a stage, tokens are [B, H*W, C], row-major over (h, w) like the JAX
reshape. Numerics follow the JAX package: LayerNorm eps 1e-6, exact GELU,
the qk softmax in float32, attention as plain matmul + softmax.

Training: stochastic depth takes pre-drawn uniforms, one [depth, 2, B]
tensor per stage (``u[i, 0]`` for block i's attention branch, ``u[i, 1]``
for its MLP branch), as the JAX package draws them outside its stage scan.
``remat=True`` checkpoints each block (``remat_policy='dots'`` saves the
linears' outputs, ``models/common.py``); the injected uniforms make the
recompute deterministic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Conv2d, DropPath, LayerNorm, Linear, maybe_checkpoint


@dataclass(frozen=True)
class MiTConfig:
    embed_dims: Sequence[int] = (64, 128, 320, 512)
    num_heads: Sequence[int] = (1, 2, 5, 8)
    depths: Sequence[int] = (3, 6, 40, 3)
    sr_ratios: Sequence[int] = (8, 4, 2, 1)
    mlp_ratios: Sequence[int] = (4, 4, 4, 4)
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1


MIT_VARIANTS = {
    # not a reference variant: one block per stage, for small tests
    "mit_micro": MiTConfig(embed_dims=(16, 32, 64, 128),
                           num_heads=(1, 2, 4, 8), depths=(1, 1, 1, 1)),
    "mit_b0": MiTConfig(embed_dims=(32, 64, 160, 256), depths=(2, 2, 2, 2)),
    "mit_b1": MiTConfig(depths=(2, 2, 2, 2)),
    "mit_b2": MiTConfig(depths=(3, 4, 6, 3)),
    "mit_b3": MiTConfig(depths=(3, 4, 18, 3)),
    "mit_b4": MiTConfig(depths=(3, 8, 27, 3)),
    "mit_b5": MiTConfig(depths=(3, 6, 40, 3)),
}


def tokens_to_map(x: torch.Tensor, hw) -> torch.Tensor:
    """[B, H*W, C] -> [B, C, H, W]."""
    b, _, c = x.shape
    return x.transpose(1, 2).reshape(b, c, hw[0], hw[1])


def map_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C]."""
    return x.flatten(2).transpose(1, 2)


class DWConv3x3(nn.Module):
    """3x3 depthwise conv over the token grid (MixFFN positional mixing)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim, bias=True)

    def forward(self, x, hw):
        return map_to_tokens(self.dwconv(tokens_to_map(x, hw)))


class MixFFN(nn.Module):
    """fc1 -> dwconv -> gelu -> fc2 (+ dropout)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 drop_rate: float = 0.0):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden_dim)
        self.dwconv = DWConv3x3(hidden_dim)
        self.fc2 = Linear(hidden_dim, out_dim)
        self.drop = nn.Dropout(drop_rate)

    def forward(self, x, hw):
        x = self.dwconv(self.fc1(x), hw)
        x = self.drop(F.gelu(x))
        return self.drop(self.fc2(x))


class SRAttention(nn.Module):
    """Multi-head attention with spatial reduction of K/V (a stride-``sr``
    VALID conv + LayerNorm)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 qkv_bias: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.dim, self.num_heads, self.sr_ratio = dim, num_heads, sr_ratio
        self.scale = (dim // num_heads) ** -0.5
        self.q = Linear(dim, dim, bias=qkv_bias)
        self.kv = Linear(dim, dim * 2, bias=qkv_bias)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj = Linear(dim, dim)
        self.proj_drop = nn.Dropout(proj_drop)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = LayerNorm(dim, eps=1e-6)

    def forward(self, x, hw):
        b, n, c = x.shape
        heads, hd = self.num_heads, self.dim // self.num_heads
        q = self.q(x).reshape(b, n, heads, hd).transpose(1, 2)
        if self.sr_ratio > 1:
            kv_in = self.norm(map_to_tokens(self.sr(tokens_to_map(x, hw))))
        else:
            kv_in = x
        kv = self.kv(kv_in).reshape(b, -1, 2, heads, hd).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
        attn = (q @ k.transpose(-2, -1)) * self.scale
        attn = attn.float().softmax(dim=-1).to(v.dtype)
        attn = self.attn_drop(attn)
        out = (attn @ v).transpose(1, 2).reshape(b, n, self.dim)
        return self.proj_drop(self.proj(out))


class MiTBlock(nn.Module):
    """Pre-norm SRA + MixFFN residual block with stochastic depth."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 sr_ratio: int = 1, qkv_bias: bool = True,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = SRAttention(dim, num_heads, sr_ratio, qkv_bias,
                                attn_drop_rate, drop_rate)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = MixFFN(dim, dim * mlp_ratio, dim, drop_rate)

    def forward(self, x, hw, u: torch.Tensor | None = None):
        """``u`` [2, B]: the drop-path uniforms of the two branches (None in
        eval)."""
        u0, u1 = (None, None) if u is None else (u[0], u[1])
        x = x + self.drop_path(self.attn(self.norm1(x), hw), u0)
        return x + self.drop_path(self.mlp(self.norm2(x), hw), u1)


class OverlapPatchEmbed(nn.Module):
    """Overlapping strided conv patch embed + LayerNorm -> tokens."""

    def __init__(self, patch_size: int, stride: int, in_chans: int,
                 embed_dim: int):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=stride,
                           padding=patch_size // 2)
        self.norm = LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x):
        x = self.proj(x)
        hw = x.shape[2:]
        return self.norm(map_to_tokens(x)), hw


class MixVisionTransformer(nn.Module):
    """4-stage MiT encoder: NCHW input -> 4 NCHW feature maps at strides
    4/8/16/32. Stochastic depth ramps linearly to ``drop_path_rate`` over all
    blocks."""

    def __init__(self, cfg: MiTConfig = MiTConfig(), in_chans: int = 3,
                 remat: bool = False, remat_policy: str = "full"):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.remat_policy = remat_policy
        total = sum(cfg.depths)
        dpr = [cfg.drop_path_rate * i / max(total - 1, 1)
               for i in range(total)]
        cur = 0
        for s in range(4):
            dim = cfg.embed_dims[s]
            setattr(self, f"patch_embed{s + 1}", OverlapPatchEmbed(
                7 if s == 0 else 3, 4 if s == 0 else 2,
                in_chans if s == 0 else cfg.embed_dims[s - 1], dim))
            setattr(self, f"block{s + 1}", nn.ModuleList([
                MiTBlock(dim, cfg.num_heads[s], cfg.mlp_ratios[s],
                         cfg.sr_ratios[s], cfg.qkv_bias, cfg.drop_rate,
                         cfg.attn_drop_rate, dpr[cur + i])
                for i in range(cfg.depths[s])]))
            setattr(self, f"norm{s + 1}", LayerNorm(dim, eps=1e-6))
            cur += cfg.depths[s]

    def forward(self, x, droppath=None):
        """``droppath``: None (eval) or 4 tensors [depth_s, 2, B] of
        drop-path uniforms, one per stage."""
        outs = []
        for s in range(1, 5):
            x, hw = getattr(self, f"patch_embed{s}")(x)
            for i, blk in enumerate(getattr(self, f"block{s}")):
                u = None if droppath is None else droppath[s - 1][i]
                x = maybe_checkpoint(blk, x, hw, u, remat=self.remat,
                                     policy=self.remat_policy)
            x = tokens_to_map(getattr(self, f"norm{s}")(x), hw)
            outs.append(x)
        return outs
