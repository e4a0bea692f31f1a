"""DAFormer decode heads (mirrors cmda_tpu.models.daformer), NCHW.

Per-scale linear embed to ``embed_dim`` channels, bilinear upsample of every
scale to the stride-4 grid, channel concat in scale order, a fuse layer of
``fusion_type`` ('aspp': the depthwise-separable ASPP, dilations 1/6/12/18,
BN+ReLU, no image pool, with a 3x3 bottleneck; 'aspp_nonsep': the same with
plain convs; 'conv': a 1x1 conv+BN+ReLU; 'rawconv_and_aspp': a 3x3 conv with
bias, then the separable ASPP; 'isa': an interlaced sparse self-attention
layer), then Dropout2d + a 1x1 classifier in float32.

Parameter names are the reference mmseg DAFormerHeadFusion keys:
``embed_layers_image.{i}.proj``, ``fuse_layer_image.aspp_modules.{i}``
(``.conv``/``.bn``, or ``.depthwise_conv``/``.pointwise_conv``),
``fuse_layer_image.bottleneck`` and ``conv_seg``; the unshared decoders of
``share='none'`` are ``embed_layers_events`` / ``fuse_layer_events`` and
``embed_layers_fusion`` / ``fuse_layer_fusion``.

Training separates two flags, as the JAX package does: ``train`` turns on
the classifier's Dropout2d (its channel masks are passed in), ``bn_train``
normalises with batch statistics (``bn_update`` says whether the running
statistics move; the EMA teacher runs ``train=False, bn_train=True,
bn_update=False``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn as nn

from .common import Conv2d, ConvBNReLU, Linear, divide_by
from ..ops.resize import upsample_bilinear_nchw


@dataclass(frozen=True)
class DAFormerHeadConfig:
    in_channels: Sequence[int] = (64, 128, 320, 512)
    embed_dim: int = 256
    channels: int = 256
    num_classes: int = 19
    dropout_ratio: float = 0.1
    aspp_dilations: Sequence[int] = (1, 6, 12, 18)
    fusion_type: str = "aspp"  # one of FUSION_TYPES


class SepConvBNReLU(nn.Module):
    """mmcv DepthwiseSeparableConvModule: depthwise (conv+BN+ReLU) then
    pointwise (conv+BN+ReLU)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 dilation: int = 1):
        super().__init__()
        self.depthwise_conv = ConvBNReLU(in_channels, in_channels,
                                         kernel_size, dilation=dilation,
                                         groups=in_channels)
        self.pointwise_conv = ConvBNReLU(in_channels, features, 1)

    def forward(self, x, bn_train: bool = False, update: bool = True,
                groups: int = 1):
        return self.pointwise_conv(
            self.depthwise_conv(x, bn_train, update, groups), bn_train,
            update, groups)


class SepASPP(nn.Module):
    """Depthwise-separable ASPP + 3x3 bottleneck (ASPPWrapper, pool=False);
    ``sep=False`` takes plain dilated convs."""

    def __init__(self, in_channels: int, channels: int,
                 dilations: Sequence[int] = (1, 6, 12, 18), sep: bool = True):
        super().__init__()
        self.aspp_modules = nn.ModuleList([
            ConvBNReLU(in_channels, channels, 1) if d == 1
            else SepConvBNReLU(in_channels, channels, 3, dilation=d) if sep
            else ConvBNReLU(in_channels, channels, 3, dilation=d)
            for d in dilations])
        self.bottleneck = ConvBNReLU(len(dilations) * channels, channels, 3)

    def forward(self, x, bn_train: bool = False, update: bool = True,
                groups: int = 1):
        return self.bottleneck(
            torch.cat([m(x, bn_train, update, groups)
                       for m in self.aspp_modules], dim=1),
            bn_train, update, groups)


class PlainASPP(SepASPP):
    """Non-separable ASPP + 3x3 bottleneck (ASPPWrapper sep=False): a 1x1
    conv at dilation 1, dilated 3x3 convs elsewhere, each conv+BN+ReLU."""

    def __init__(self, in_channels: int, channels: int,
                 dilations: Sequence[int] = (1, 6, 12, 18)):
        super().__init__(in_channels, channels, dilations, sep=False)


class MLPEmbed(nn.Module):
    """Per-scale linear embedding over channels (reference ``MLP.proj``)."""

    def __init__(self, in_channels: int, embed_dim: int):
        super().__init__()
        self.proj = Linear(in_channels, embed_dim)

    def forward(self, x):
        return self.proj(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


FUSION_TYPES = ("aspp", "aspp_nonsep", "conv", "rawconv_and_aspp", "isa")


def fuse_layer(cfg: "DAFormerHeadConfig", in_channels: int) -> nn.Module:
    """The decoder's fuse layer of ``cfg.fusion_type``: 'aspp' the
    separable ASPP, 'aspp_nonsep' the plain one, 'conv' a 1x1
    conv+BN+ReLU, 'rawconv_and_aspp' the separable ASPP after the raw 3x3
    conv (built beside it), 'isa' an ``ISALayer(channels, channels // 2)``."""
    kind, ch = cfg.fusion_type, cfg.channels
    if kind in ("aspp", "rawconv_and_aspp"):
        return SepASPP(ch if kind == "rawconv_and_aspp" else in_channels,
                       ch, cfg.aspp_dilations)
    if kind == "aspp_nonsep":
        return PlainASPP(in_channels, ch, cfg.aspp_dilations)
    if kind == "conv":
        return ConvBNReLU(in_channels, ch, 1)
    if kind == "isa":
        from .heads import ISALayer
        return ISALayer(in_channels, ch, isa_channels=ch // 2)
    raise ValueError(f"fusion_type {kind!r} (one of {FUSION_TYPES})")


class DAFormerDecoder(nn.Module):
    """Embed + upsample + concat + fuse -> pre-classifier features.

    ``stream`` suffixes the parameter names the way the reference fusion
    head does (``embed_layers_image``, ``fuse_layer_image``; and
    ``fuse_rawconv_image`` for 'rawconv_and_aspp'); ``add_stream`` builds
    another stream's layers beside them (the unshared decoders of
    ``share='none'``)."""

    def __init__(self, cfg: DAFormerHeadConfig, stream: str | None = None):
        super().__init__()
        self.fusion_type = cfg.fusion_type
        self._names = {}
        self.add_stream(cfg, stream)

    def add_stream(self, cfg: DAFormerHeadConfig, stream: str | None):
        """Build the layers of ``stream``'s decoder, named by it."""
        sfx = f"_{stream}" if stream else ""
        names = dict(embed=f"embed_layers{sfx}", fuse=f"fuse_layer{sfx}",
                     raw=f"fuse_rawconv{sfx}")
        cat = cfg.embed_dim * len(cfg.in_channels)
        setattr(self, names["embed"], nn.ModuleList([
            MLPEmbed(c, cfg.embed_dim) for c in cfg.in_channels]))
        if cfg.fusion_type == "rawconv_and_aspp":
            setattr(self, names["raw"], Conv2d(cat, cfg.channels, 3,
                                               padding=1))
        setattr(self, names["fuse"], fuse_layer(cfg, cat))
        self._names[stream] = names

    def decode(self, feats, bn_train: bool = False, update: bool = True,
               groups: int = 1, stream: str | None = None):
        """``groups``: the feats hold that many streams stacked along the
        batch, each normalised by its own batch statistics (not with
        'isa', whose attention normalises the stack as one). ``stream``
        picks the decoder (default the first built)."""
        names = self._names[stream if stream in self._names
                            else next(iter(self._names))]
        target = tuple(feats[0].shape[2:])
        embeds = [upsample_bilinear_nchw(layer(f), target)
                  for layer, f in zip(getattr(self, names["embed"]), feats)]
        x = torch.cat(embeds, dim=1)
        if self.fusion_type == "rawconv_and_aspp":
            x = getattr(self, names["raw"])(x)
        fuse = getattr(self, names["fuse"])
        if self.fusion_type == "isa":
            return fuse(x, bn_train, update)
        return fuse(x, bn_train, update, groups)

    def forward(self, feats, bn_train: bool = False, update: bool = True):
        return self.decode(feats, bn_train, update)


class Classifier(nn.Conv2d):
    """Dropout2d + 1x1 conv classifier (``cls_seg``). Dropout2d takes its
    channel keep-mask ``keep`` [B, C] (bool, drawn with probability
    1 - dropout_ratio by the caller's generator) and divides the kept
    channels by 1 - dropout_ratio; without a mask it is the identity
    (eval). As in the JAX package, the dropout runs in the input's dtype
    (in bfloat16, bf16(x / bf16(0.9))) and the conv in float32 after it."""

    def __init__(self, channels: int, num_classes: int,
                 dropout_ratio: float = 0.1):
        super().__init__(channels, num_classes, 1)
        self.dropout_ratio = dropout_ratio
        self._divisors = {}

    def dropout(self, x, keep: torch.Tensor | None = None):
        """The Dropout2d half of ``forward``, in ``x``'s dtype."""
        if keep is None or self.dropout_ratio == 0:
            return x
        return torch.where(keep[:, :, None, None],
                           divide_by(x, 1.0 - self.dropout_ratio,
                                     self._divisors),
                           torch.zeros_like(x))

    def forward(self, x, keep: torch.Tensor | None = None):
        return super().forward(self.dropout(x, keep).float())


class DAFormerHead(DAFormerDecoder):
    """Single-stream DAFormer head (the reference ``DAFormerHead``: keys
    ``embed_layers.{i}.proj``, ``fuse_layer``, ``conv_seg``) -> stride-4
    logits [B, C, h, w]: ``EncoderDecoder``'s head. ``train`` turns on the
    Dropout2d with the keep-masks ``dropout_keep`` [B, C] and BatchNorm on
    batch statistics, which move the running statistics."""

    def __init__(self, cfg: DAFormerHeadConfig):
        super().__init__(cfg)
        self.conv_seg = Classifier(cfg.channels, cfg.num_classes,
                                   cfg.dropout_ratio)

    def forward(self, feats, train: bool = False,
                dropout_keep: torch.Tensor | None = None):
        if train and self.conv_seg.dropout_ratio > 0 and dropout_keep is None:
            raise ValueError("train=True needs the Dropout2d keep-masks")
        return self.conv_seg(self.decode(feats, train),
                             dropout_keep if train else None)


class DAFormerFusionHead(DAFormerDecoder):
    """Multi-stream head over the {image, events, fusion, ISR} pyramids.
    ``share`` (``model.share_decoder``): 'full' one decoder for every
    stream; 'half' the same decoder, each stream decoded on its own (never
    stacked); 'none' three decoders, the ISR stream through the events
    one, each built from ``cfg.in_channels``. One classifier, or
    with ``split_cls`` three: ``conv_seg`` for the image stream,
    ``conv_seg_events`` (``events_classes`` wide, default ``num_classes``)
    for the events and ISR streams and ``conv_seg_fusion`` for the fusion
    stream (the reference's key names); ``conv_seg_fusion`` only where the
    model has a fusion stream (``with_fusion``), as the JAX head has its
    parameters only when a fusion stream is decoded.

    In eval mode (BN on running statistics) several streams are decoded as
    one batch stacked along dim 0 and split back, which equals the
    per-stream loop; with ``batched_train`` (``model.head_batched_train``)
    also with batch statistics, each stream a group of the grouped
    ``StreamBatchNorm``. With ``split_cls``, ``share`` other than 'full' or
    the 'isa' fuse type the streams always take the per-stream loop, as in
    the JAX head."""

    def __init__(self, cfg: DAFormerHeadConfig, share: str = "full",
                 split_cls: bool = False, events_classes: int | None = None,
                 batched_train: bool = False, with_fusion: bool = True):
        if share not in ("full", "half", "none"):
            raise ValueError(f"share={share!r} (one of full, half, none)")
        super().__init__(cfg, stream="image")
        self.share = share
        if share == "none":
            self.add_stream(cfg, "events")
            self.add_stream(cfg, "fusion")
        self.conv_seg = Classifier(cfg.channels, cfg.num_classes,
                                   cfg.dropout_ratio)
        self.split_cls = split_cls
        if split_cls:
            self.conv_seg_events = Classifier(
                cfg.channels, events_classes or cfg.num_classes,
                cfg.dropout_ratio)
            if with_fusion:
                self.conv_seg_fusion = Classifier(
                    cfg.channels, cfg.num_classes, cfg.dropout_ratio)
        self.batched_train = batched_train

    def classifier(self, stream: str) -> Classifier:
        """The classifier of ``stream`` ('image', 'events', 'fusion' or
        'isr'; the ISR stream takes the events classifier)."""
        if not self.split_cls or stream == "image":
            return self.conv_seg
        if stream in ("events", "isr"):
            return self.conv_seg_events
        return self.conv_seg_fusion

    def forward(self, feats: dict, streams=None, *, train: bool = False,
                bn_train: bool | None = None, bn_update: bool = True,
                dropout_keep: torch.Tensor | None = None):
        """feats: {'f_image', 'f_events', 'f_fusion', 'f_img_self_res'}
        (NCHW lists or None) -> {'image_output', 'events_output',
        'fusion_output', 'img_self_res_output'} stride-4 logits [B, C, h, w]
        (None where the input is missing or not in ``streams``).

        ``bn_train`` defaults to ``train``. With running-statistics BN, or
        with ``batched_train``, several streams are decoded as one batch
        stacked along dim 0 and split back (never with ``split_cls``); with
        batch statistics each stream is a group of the decoder's
        BatchNorms, which gives the values and running statistics of the
        per-stream loop. Otherwise the streams go one after another through
        the shared decoder, in the order image, events, fusion, isr, each
        moving the running statistics in turn. ``dropout_keep`` [S, B, C]
        holds the Dropout2d keep-masks of the decoded streams in that order
        (needed when ``train``; rows past the decoded streams are unused):
        the JAX head draws one mask per stream it decodes (the batched head
        one [S*B] mask, the same masks stacked)."""
        bn = train if bn_train is None else bn_train
        plan = [("image", "image_output", feats.get("f_image")),
                ("events", "events_output", feats.get("f_events")),
                ("fusion", "fusion_output", feats.get("f_fusion")),
                ("isr", "img_self_res_output", feats.get("f_img_self_res"))]
        active = [(n, k, f) for n, k, f in plan
                  if f is not None and (streams is None or n in streams)]
        out = {k: None for _, k, _ in plan}
        if train and self.conv_seg.dropout_ratio > 0 and dropout_keep is None:
            raise ValueError("train=True needs the Dropout2d keep-masks")
        if (len(active) > 1 and not self.split_cls and self.share == "full"
                and self.fusion_type != "isa"
                and (not bn or self.batched_train)):
            n = len(active)
            stacked = [torch.cat([f[i] for _, _, f in active], dim=0)
                       for i in range(len(active[0][2]))]
            keep = (dropout_keep[:n].reshape(-1, dropout_keep.shape[-1])
                    if train and dropout_keep is not None else None)
            logits = self.conv_seg(
                self.decode(stacked, bn, bn_update, groups=n if bn else 1),
                keep)
            for (_, key, _), part in zip(active, logits.chunk(n, dim=0)):
                out[key] = part
            return out
        for j, (name, key, f) in enumerate(active):
            keep = (dropout_keep[j] if train and dropout_keep is not None
                    else None)
            # unshared: the ISR stream decodes through the events decoder
            dec = "events" if name == "isr" else name
            out[key] = self.classifier(name)(
                self.decode(f, bn, bn_update, stream=dec), keep)
        return out
