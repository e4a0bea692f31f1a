"""Legacy decode heads (mirrors cmda_tpu.models.heads), NCHW: SegFormer,
FCN, ASPP (and its DeepLabV3+ variant), PSP, UPer, ISA, DA and DeepLabV2,
with the SegFormerAdapter neck. They are the heads of the reference's
architecture grid (``GenericEncoderDecoder``); the DAFormer decoder's 'isa'
fuse type takes ``ISALayer``.

Every head takes the backbone's four NCHW maps and returns stride-of-its-
input logits [B, num_classes, h, w] in float32 through Dropout2d + a 1x1
classifier (``conv_seg``; DLV2Head has none). ``train`` turns on the
Dropout2d with the keep-masks ``dropout_keep`` [B, channels] and puts the
BatchNorms on batch statistics that move the running statistics, as the
JAX heads' ``train`` does.

Layer names are the JAX module names (``image_pool``, ``pool{i}``,
``ppm{i}``, ``lateral{i}``, ``fpn{i}``, ``in_conv``, ``pam_gamma``, ...),
each conv+BN+ReLU a ``ConvBNReLU`` (``.conv`` / ``.bn``), except where the
weights bridge renames them to the reference's: ``aspp_modules.{i}``,
``depthwise_conv`` / ``pointwise_conv``, SegFormerHead's ``embed_layers``
and ``fuse_layer``, and FCNHead's ``conv{i}`` / ``bn{i}``.

PSP and UPer pool by floor: an average pool of kernel = stride =
(h // s, w // s), as the JAX heads' ``nn.avg_pool`` does; where h is not a
multiple of s that is another grid than ``adaptive_avg_pool2d``'s.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Conv2d, ConvBNReLU, StreamBatchNorm
from .daformer import Classifier, MLPEmbed, SepConvBNReLU
from ..ops.resize import upsample_bilinear_nchw


@dataclass(frozen=True)
class HeadConfig:
    in_channels: Sequence[int] = (64, 128, 320, 512)
    channels: int = 256
    num_classes: int = 19
    dropout_ratio: float = 0.1


class _ClassifiedHead(nn.Module):
    """A head whose last layer is ``conv_seg`` (Dropout2d + 1x1 conv)."""

    def __init__(self, cfg: HeadConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_seg = Classifier(cfg.channels, cfg.num_classes,
                                   cfg.dropout_ratio)

    def features(self, feats, train: bool):
        """The pre-classifier map."""
        raise NotImplementedError

    def forward(self, feats, train: bool = False,
                dropout_keep: torch.Tensor | None = None):
        if train and self.conv_seg.dropout_ratio > 0 and dropout_keep is None:
            raise ValueError("train=True needs the Dropout2d keep-masks")
        return self.conv_seg(self.features(feats, train),
                             dropout_keep if train else None)


def _floor_pool(x, s: int):
    """``nn.avg_pool`` of kernel = stride = (h // s, w // s) (at least 1)."""
    h, w = x.shape[2:]
    k = (max(h // s, 1), max(w // s, 1))
    return F.avg_pool2d(x, k, stride=k)


class SegFormerHead(_ClassifiedHead):
    """Per-scale linear embed -> upsample -> concat (last scale first) ->
    1x1 fuse -> classifier (the SegFormer decoder)."""

    def __init__(self, cfg: HeadConfig):
        super().__init__(cfg)
        self.embed_layers = nn.ModuleList([
            MLPEmbed(c, cfg.channels) for c in cfg.in_channels])
        self.fuse_layer = ConvBNReLU(len(cfg.in_channels) * cfg.channels,
                                     cfg.channels, 1)

    def features(self, feats, train):
        target = tuple(feats[0].shape[2:])
        embeds = [upsample_bilinear_nchw(layer(f), target)
                  for layer, f in zip(self.embed_layers, feats)]
        return self.fuse_layer(torch.cat(embeds[::-1], dim=1), train)


class FCNHead(_ClassifiedHead):
    """``num_convs`` 3x3 conv+BN+ReLU on the selected map."""

    def __init__(self, cfg: HeadConfig, num_convs: int = 2,
                 in_index: int = -1):
        super().__init__(cfg)
        self.num_convs, self.in_index = num_convs, in_index
        cin = cfg.in_channels[in_index]
        for i in range(num_convs):
            self.add_module(f"conv{i}", Conv2d(cin, cfg.channels, 3,
                                               padding=1, bias=False))
            self.add_module(f"bn{i}", StreamBatchNorm(cfg.channels))
            cin = cfg.channels

    def features(self, feats, train):
        x = feats[self.in_index]
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x),
                                               train))
        return x


class ASPPHead(_ClassifiedHead):
    """ASPP with an image pool; ``sep`` takes depthwise-separable dilated
    branches, and ``c1_channels`` > 0 fuses the stride-4 map as DeepLabV3+
    does (a 1x1 on it, the ASPP output upsampled to it, two separable 3x3
    convs)."""

    def __init__(self, cfg: HeadConfig,
                 dilations: Sequence[int] = (1, 12, 24, 36),
                 sep: bool = False, c1_channels: int = 0,
                 in_index: int = -1):
        super().__init__(cfg)
        self.in_index, self.c1_channels = in_index, c1_channels
        cin, ch = cfg.in_channels[in_index], cfg.channels
        self.image_pool = ConvBNReLU(cin, ch, 1)
        self.aspp_modules = nn.ModuleList([
            ConvBNReLU(cin, ch, 1) if d == 1
            else SepConvBNReLU(cin, ch, 3, dilation=d) if sep
            else ConvBNReLU(cin, ch, 3, dilation=d) for d in dilations])
        self.bottleneck = ConvBNReLU((len(dilations) + 1) * ch, ch, 3)
        if c1_channels > 0:
            self.c1_bottleneck = ConvBNReLU(cfg.in_channels[0], c1_channels,
                                            1)
            self.sep_fuse0 = SepConvBNReLU(ch + c1_channels, ch, 3)
            self.sep_fuse1 = SepConvBNReLU(ch, ch, 3)

    def features(self, feats, train):
        x = feats[self.in_index]
        pool = self.image_pool(x.mean(dim=(2, 3), keepdim=True), train)
        branches = [pool.expand(-1, -1, *x.shape[2:])]
        branches += [m(x, train) for m in self.aspp_modules]
        y = self.bottleneck(torch.cat(branches, dim=1), train)
        if self.c1_channels > 0:
            c1 = self.c1_bottleneck(feats[0], train)
            y = upsample_bilinear_nchw(y, tuple(c1.shape[2:]))
            y = self.sep_fuse0(torch.cat([y, c1], dim=1), train)
            y = self.sep_fuse1(y, train)
        return y


class PSPHead(_ClassifiedHead):
    """Pyramid pooling (scales 1/2/3/6, floor pools) + 3x3 bottleneck."""

    def __init__(self, cfg: HeadConfig,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 in_index: int = -1):
        super().__init__(cfg)
        self.pool_scales, self.in_index = tuple(pool_scales), in_index
        cin, ch = cfg.in_channels[in_index], cfg.channels
        for i in range(len(pool_scales)):
            self.add_module(f"pool{i}", ConvBNReLU(cin, ch, 1))
        self.bottleneck = ConvBNReLU(cin + len(pool_scales) * ch, ch, 3)

    def features(self, feats, train):
        x = feats[self.in_index]
        hw = tuple(x.shape[2:])
        outs = [x] + [upsample_bilinear_nchw(
            getattr(self, f"pool{i}")(_floor_pool(x, s), train), hw)
            for i, s in enumerate(self.pool_scales)]
        return self.bottleneck(torch.cat(outs, dim=1), train)


class UPerHead(_ClassifiedHead):
    """FPN + PPM (floor pools) on the last map."""

    def __init__(self, cfg: HeadConfig,
                 pool_scales: Sequence[int] = (1, 2, 3, 6)):
        super().__init__(cfg)
        self.pool_scales = tuple(pool_scales)
        ins, ch = cfg.in_channels, cfg.channels
        for i in range(len(pool_scales)):
            self.add_module(f"ppm{i}", ConvBNReLU(ins[-1], ch, 1))
        self.ppm_bottleneck = ConvBNReLU(ins[-1] + len(pool_scales) * ch,
                                         ch, 3)
        for i, c in enumerate(ins[:-1]):
            self.add_module(f"lateral{i}", ConvBNReLU(c, ch, 1))
            self.add_module(f"fpn{i}", ConvBNReLU(ch, ch, 3))
        self.fpn_bottleneck = ConvBNReLU(len(ins) * ch, ch, 3)

    def features(self, feats, train):
        x = feats[-1]
        hw = tuple(x.shape[2:])
        ppm = [x] + [upsample_bilinear_nchw(
            getattr(self, f"ppm{i}")(_floor_pool(x, s), train), hw)
            for i, s in enumerate(self.pool_scales)]
        top = self.ppm_bottleneck(torch.cat(ppm, dim=1), train)
        laterals = [getattr(self, f"lateral{i}")(f, train)
                    for i, f in enumerate(feats[:-1])] + [top]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_bilinear_nchw(
                laterals[i], tuple(laterals[i - 1].shape[2:]))
        fpn = [getattr(self, f"fpn{i}")(laterals[i], train)
               for i in range(len(laterals) - 1)] + [laterals[-1]]
        size = tuple(fpn[0].shape[2:])
        return self.fpn_bottleneck(torch.cat(
            [upsample_bilinear_nchw(f, size) for f in fpn], dim=1), train)


class QKVAttention(nn.Module):
    """mmseg's SelfAttentionBlock core as ISA and DA use it: the query and
    the key each through ``key_query_num_convs`` 1x1 projections to
    ``channels`` (conv+BN+ReLU with ``key_query_norm``, else a conv with
    bias; ``query{i}`` / ``key{i}``), the value a 1x1 conv with bias to
    ``out_channels`` (``value``); softmax(q k^T [* channels^-0.5]) over the
    positions in float32, out = attn v."""

    def __init__(self, in_channels: int, channels: int, out_channels: int,
                 key_query_num_convs: int = 2, key_query_norm: bool = True,
                 matmul_norm: bool = True):
        super().__init__()
        self.channels, self.matmul_norm = channels, matmul_norm
        self.n, self.norm = key_query_num_convs, key_query_norm
        for name in ("query", "key"):
            cin = in_channels
            for i in range(key_query_num_convs):
                self.add_module(f"{name}{i}", ConvBNReLU(cin, channels, 1)
                                if key_query_norm
                                else Conv2d(cin, channels, 1))
                cin = channels
        self.value = Conv2d(in_channels, out_channels, 1)

    def _project(self, name, x, train, update):
        for i in range(self.n):
            m = getattr(self, f"{name}{i}")
            x = m(x, train, update) if self.norm else m(x)
        return x.flatten(2)                       # [b, C', hw]

    def forward(self, x, train: bool = False, update: bool = True):
        b, _, h, w = x.shape
        q = self._project("query", x, train, update)
        k = self._project("key", x, train, update)
        v = self.value(x).flatten(2)              # [b, Cout, hw]
        sim = q.transpose(1, 2) @ k               # [b, hw, hw]
        if self.matmul_norm:
            sim = sim * (self.channels ** -0.5)
        attn = sim.float().softmax(dim=-1).to(x.dtype)
        return (v @ attn.transpose(1, 2)).reshape(b, -1, h, w)


class ISACore(nn.Module):
    """Interlaced sparse self-attention: a global relation over the glb grid
    (one attention per local offset), then a local relation within each glb
    cell, each followed by a 1x1 conv+BN+ReLU (``global_relation_out``,
    ``local_relation_out``). The map is padded to multiples of
    ``down_factor``, ``pad // 2`` before and the rest after, and cropped
    back."""

    def __init__(self, channels: int, isa_channels: int,
                 down_factor=(8, 8)):
        super().__init__()
        self.down_factor = tuple(down_factor)
        for name in ("global_relation", "local_relation"):
            self.add_module(name, QKVAttention(channels, isa_channels,
                                               channels))
            self.add_module(f"{name}_out", ConvBNReLU(channels, channels, 1))

    def _attention(self, name, x, train, update):
        return getattr(self, f"{name}_out")(
            getattr(self, name)(x, train, update), train, update)

    def forward(self, x, train: bool = False, update: bool = True):
        n, c, h, w = x.shape
        lh, lw = self.down_factor
        gh, gw = -(-h // lh), -(-w // lw)
        ph, pw = gh * lh - h, gw * lw - w
        if ph or pw:
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        # global: the (gh, gw) grid of each local offset
        x = x.reshape(n, c, gh, lh, gw, lw).permute(0, 3, 5, 1, 2, 4)
        x = self._attention("global_relation",
                            x.reshape(n * lh * lw, c, gh, gw), train, update)
        # local: the (lh, lw) cell of each global position
        x = x.reshape(n, lh, lw, c, gh, gw).permute(0, 4, 5, 3, 1, 2)
        x = self._attention("local_relation",
                            x.reshape(n * gh * gw, c, lh, lw), train, update)
        x = x.reshape(n, gh, gw, c, lh, lw).permute(0, 3, 1, 4, 2, 5)
        x = x.reshape(n, c, gh * lh, gw * lw)
        if ph or pw:
            x = x[:, :, ph // 2:ph // 2 + h, pw // 2:pw // 2 + w]
        return x


class ISALayer(nn.Module):
    """1x1 ``in_conv``, the ISA core, then (``out_cat_and_conv``) a 1x1
    ``out_conv`` over [core, in_conv output]: the DAFormer 'isa' fuse."""

    def __init__(self, in_channels: int, channels: int,
                 isa_channels: int = 64, down_factor=(8, 8),
                 out_cat_and_conv: bool = True):
        super().__init__()
        self.in_conv = ConvBNReLU(in_channels, channels, 1)
        self.core = ISACore(channels, isa_channels, down_factor)
        self.out_cat_and_conv = out_cat_and_conv
        if out_cat_and_conv:
            self.out_conv = ConvBNReLU(2 * channels, channels, 1)

    def forward(self, x, bn_train: bool = False, update: bool = True):
        x = self.in_conv(x, bn_train, update)
        y = self.core(x, bn_train, update)
        if self.out_cat_and_conv:
            y = self.out_conv(torch.cat([y, x], dim=1), bn_train, update)
        return y


class ISAHead(_ClassifiedHead):
    """3x3 ``in_conv``, the ISA core, 1x1 ``out_conv`` over [core,
    in_conv output], classifier."""

    def __init__(self, cfg: HeadConfig, isa_channels: int = 256,
                 down_factor=(8, 8), in_index: int = -1):
        super().__init__(cfg)
        self.in_index = in_index
        self.in_conv = ConvBNReLU(cfg.in_channels[in_index], cfg.channels, 3)
        self.core = ISACore(cfg.channels, isa_channels, down_factor)
        self.out_conv = ConvBNReLU(2 * cfg.channels, cfg.channels, 1)

    def features(self, feats, train):
        x = self.in_conv(feats[self.in_index], train)
        return self.out_conv(torch.cat([self.core(x, train), x], dim=1),
                             train)


class DAHead(_ClassifiedHead):
    """Dual attention: the position branch (``pam``, its output scaled by
    the scalar ``pam_gamma`` and added) and the channel branch (the
    max-minus-energy softmax over channels, scaled by ``cam_gamma``), each
    between two 3x3 conv+BN+ReLU, summed; the pam_cam logits. The gammas
    start at 0, as in the JAX head."""

    def __init__(self, cfg: HeadConfig, pam_channels: int = 64,
                 in_index: int = -1):
        super().__init__(cfg)
        self.in_index = in_index
        cin, ch = cfg.in_channels[in_index], cfg.channels
        self.pam_in_conv = ConvBNReLU(cin, ch, 3)
        self.pam = QKVAttention(ch, pam_channels, ch, key_query_num_convs=1,
                                key_query_norm=False, matmul_norm=False)
        self.pam_gamma = nn.Parameter(torch.zeros(()))
        self.pam_out_conv = ConvBNReLU(ch, ch, 3)
        self.cam_in_conv = ConvBNReLU(cin, ch, 3)
        self.cam_gamma = nn.Parameter(torch.zeros(()))
        self.cam_out_conv = ConvBNReLU(ch, ch, 3)

    def features(self, feats, train):
        x = feats[self.in_index]
        p = self.pam_in_conv(x, train)
        p = self.pam_gamma * self.pam(p, train) + p
        p = self.pam_out_conv(p, train)
        q = self.cam_in_conv(x, train)
        flat = q.flatten(2)                                   # [b, c, n]
        energy = flat @ flat.transpose(1, 2)                  # [b, c, c]
        energy = energy.amax(dim=-1, keepdim=True) - energy
        attn = energy.float().softmax(dim=-1).to(q.dtype)
        q = self.cam_gamma * (attn @ flat).reshape(q.shape) + q
        q = self.cam_out_conv(q, train)
        return p + q


class DLV2Branch(Conv2d):
    """One dilated 3x3 classifier conv of DLV2Head: a classifier, so
    ``init_weights`` draws it as the classifiers, N(0, 0.01)."""


class DLV2Head(nn.Module):
    """DeepLabV2: dilated 3x3 convs with bias to the classes (``branch{i}``),
    summed, in float32; no BatchNorm, no dropout."""

    def __init__(self, cfg: HeadConfig,
                 dilations: Sequence[int] = (6, 12, 18, 24),
                 in_index: int = -1):
        super().__init__()
        self.cfg, self.in_index = cfg, in_index
        for i, d in enumerate(dilations):
            self.add_module(f"branch{i}", DLV2Branch(
                cfg.in_channels[in_index], cfg.num_classes, 3, padding=d,
                dilation=d))
        self.n = len(dilations)

    def forward(self, feats, train: bool = False,
                dropout_keep: torch.Tensor | None = None):
        x = feats[self.in_index].float()
        out = getattr(self, "branch0")(x)
        for i in range(1, self.n):
            out = out + getattr(self, f"branch{i}")(x)
        return out


class SegFormerAdapter(nn.Module):
    """The 'sfa_' neck: upsample the maps of ``out_layers`` by ``scales``
    and put their concat in the last slot; the others pass through.
    Parameter-free."""

    def __init__(self, out_layers: Sequence[int] = (3,),
                 scales: Sequence[int] = (4,)):
        super().__init__()
        self.out_layers, self.scales = tuple(out_layers), tuple(scales)

    def forward(self, feats):
        cat = []
        for i, s in zip(self.out_layers, self.scales):
            x = feats[i]
            if s != 1:
                x = upsample_bilinear_nchw(x, (x.shape[2] * s,
                                               x.shape[3] * s))
            cat.append(x)
        return list(feats[:-1]) + [torch.cat(cat, dim=1)]

