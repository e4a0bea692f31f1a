"""The dual-backbone image+events segmentor (mirrors
cmda_tpu.models.segmentor.FusionEncoderDecoder).

``backbone_image`` + ``backbone_events`` (the events backbone also encodes
the ISR stream), a fusion module over the two pyramids (+ the optional
``fusion_isr_module``) and the DAFormer fusion head. ``forward_logits`` and
``forward`` take NHWC inputs and return NHWC logits, like the JAX package;
the modules inside are NCHW.

Training (``forward_train``, or ``forward_logits(train=True)``) takes its
random draws as a ``ForwardDraws``: the drop-path uniforms of every encoder
stage and fusion block and the classifier's Dropout2d keep-masks. With both
an events and an ISR input (the ``events_together`` forward) they share one
double-batch pass through ``backbone_events``, so its uniforms are
[depth, 2, 2B], one draw for both halves, as in the JAX package. Without
the ISR input (the single-batch forward of ``cs2dz_image+raw-isr`` and
``cs2dsec_image+events``, whose second input is the ISR or the events) the
events backbone takes [depth, 2, B] and three streams are decoded.

Training runs in the modes ``default`` (``fusion_module`` on the image and
events pyramids; no fusion stream for a model without one,
``model.fusion=""``), ``fusion_isr`` (``fusion_isr_module`` on the image and
the ISR pyramid, or the events pyramid when the single batch carries the
ISR as its events input), ``fusion_all`` (the mean of both modules, the
events+ISR double batch only) and ``no_fusion`` (the image and events
streams, single batch); each fusion module takes its own drop-path
uniforms, which the JAX forward draws from the module's own key, so one
``ForwardDraws`` serves every mode.

``EncoderDecoder`` is the single-backbone segmentor (one MiT, the
single-stream DAFormer head): the frozen ImageNet encoder of the feature
distance, and the model of the image-only trainers (OrgDACS, DACSImage),
with a training forward of its own. ``EventsEncoderDecoder`` feeds it the
image and events concatenated (early fusion); ``GenericEncoderDecoder`` is
any backbone (MiT or a ResNet of ``models/resnet.py``), optional neck and
head (``models/heads.py``, or a DAFormer head): the legacy architecture
grid's model and OrgDACS's ``model=``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
import torch.nn as nn

from .daformer import DAFormerFusionHead, DAFormerHead, DAFormerHeadConfig
from .fusion import build_fusion_module, num_drop_path_blocks
from .mit import MIT_VARIANTS, MixVisionTransformer
from ..ops.resize import resize_bilinear


@dataclass(frozen=True)
class SegmentorConfig:
    backbone: str = "mit_b5"
    num_classes: int = 19
    train_type: str = "cs2dsec_image+events_together"
    fusion: str = "attention_avg"
    fusion_isr: str = "attention"
    share_decoder: str = "full"     # 'full' | 'half' | 'none'
    split_cls: bool = False
    events_classes: int | None = None
    head: DAFormerHeadConfig = field(default_factory=DAFormerHeadConfig)
    drop_path_rate: float = 0.1
    remat: bool = False
    remat_policy: str = "full"
    scan_split_transpose: bool = False
    scan_unroll_short: bool = False
    head_batched_train: bool = False


def check_model_options(cfg: SegmentorConfig):
    """Raise ``NotImplementedError`` for an option the port cannot honour:
    ``scan_split_transpose`` and ``scan_unroll_short`` schedule the JAX
    package's ``lax.scan`` over a stage's blocks, and the port runs its
    blocks as a Python loop, with no scan to schedule."""
    for name in ("scan_split_transpose", "scan_unroll_short"):
        if getattr(cfg, name):
            raise NotImplementedError(
                f"model.{name}=True is a lax.scan schedule option of the JAX "
                "package; the port runs each stage's blocks as a loop, with "
                "no scan (ROADMAP C4)")


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OUTPUT_KEYS = {"fusion": "fusion_output", "image": "image_output",
               "events": "events_output", "isr": "img_self_res_output"}


def _nchw(x, dtype):
    return None if x is None else x.permute(0, 3, 1, 2).to(dtype)


@dataclass
class ForwardDraws:
    """Random draws of one training forward. Drop-path uniforms are U[0, 1)
    per encoder stage, ``image`` [depth_s, 2, B] and ``events``
    [depth_s, 2, 2B] for the events+ISR double batch ([depth_s, 2, B]
    without the ISR input), ``fusion`` [n_blocks, 2, B] for the fusion
    module and ``fusion_isr`` [n_isr_blocks, 2, B] for the ISR fusion
    module (modes ``fusion_isr`` and ``fusion_all``; None when no step
    runs them); ``dropout_keep`` [S, B, C] are the classifier's channel
    keep-masks of the image, events, fusion (and isr) streams, S = 4 with
    the ISR input and 3 without."""
    image: Optional[Sequence[torch.Tensor]] = None
    events: Optional[Sequence[torch.Tensor]] = None
    fusion: Optional[torch.Tensor] = None
    dropout_keep: Optional[torch.Tensor] = None
    fusion_isr: Optional[torch.Tensor] = None

    def to(self, device) -> "ForwardDraws":
        """The same draws on ``device``."""
        return ForwardDraws(**{k: _tensors_to(v, device)
                               for k, v in self.__dict__.items()})


def _tensors_to(value, device):
    """A tensor, or a list / tuple of tensors, on ``device`` (None stays)."""
    if isinstance(value, (list, tuple)):
        return type(value)(_tensors_to(v, device) for v in value)
    return None if value is None else value.to(device)


class FusionEncoderDecoder(nn.Module):
    """Dual-backbone image+events segmentor with feature-level fusion.

    ``dtype='bfloat16'`` casts the inputs to bfloat16, and every layer
    computes in the dtype it is handed (``models/common.py``), so the
    matmuls, convs and residual stream run in bfloat16 while the qk softmax,
    the norm statistics and the classifier stay float32, as in the JAX
    package's bfloat16 mode. ``dtype`` may be changed between calls."""

    def __init__(self, cfg: SegmentorConfig = SegmentorConfig(),
                 dtype: str = "float32"):
        super().__init__()
        check_model_options(cfg)
        self.cfg = cfg
        self.dtype = DTYPES[dtype]
        mit_cfg = MIT_VARIANTS[cfg.backbone]
        mit_cfg = type(mit_cfg)(**{**mit_cfg.__dict__,
                                   "drop_path_rate": cfg.drop_path_rate})
        # the remat policy reaches the two encoders, as in the JAX
        # segmentor; its fusion modules rematerialise whole blocks
        self.backbone_image = MixVisionTransformer(
            mit_cfg, remat=cfg.remat, remat_policy=cfg.remat_policy)
        self.backbone_events = MixVisionTransformer(
            mit_cfg, remat=cfg.remat, remat_policy=cfg.remat_policy)
        self.fusion_module = build_fusion_module(
            cfg.fusion, mit_cfg.embed_dims, remat=cfg.remat)
        self.fusion_isr_module = build_fusion_module(
            cfg.fusion_isr, mit_cfg.embed_dims, remat=cfg.remat)
        self.decode_head = DAFormerFusionHead(
            cfg.head, share=cfg.share_decoder, split_cls=cfg.split_cls,
            events_classes=cfg.events_classes,
            batched_train=cfg.head_batched_train,
            with_fusion=bool(cfg.fusion or cfg.fusion_isr))

    def new_draws(self, batch: int, *, generator: torch.Generator,
                  device: torch.device, with_isr: bool = True,
                  fusion_isr: bool = False) -> ForwardDraws:
        """Fresh ``ForwardDraws`` for a training forward at ``batch``, drawn
        from ``generator`` on ``device``: for the events+ISR double batch
        (``with_isr``) or the single-batch forward without the ISR input;
        with ``fusion_isr`` also the ISR fusion module's uniforms, drawn
        last."""
        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=device)

        depths = self.backbone_image.cfg.depths
        rate = self.decode_head.conv_seg.dropout_ratio
        n_cls = self.decode_head.conv_seg.in_channels
        events = 2 * batch if with_isr else batch
        return ForwardDraws(
            image=[uniform(d, 2, batch) for d in depths],
            events=[uniform(d, 2, events) for d in depths],
            fusion=uniform(num_drop_path_blocks(self.fusion_module), 2,
                           batch),
            dropout_keep=uniform(4 if with_isr else 3, batch, n_cls)
            < 1.0 - rate,
            fusion_isr=(uniform(num_drop_path_blocks(self.fusion_isr_module),
                                2, batch) if fusion_isr else None))

    def extract_feat(self, image, events, img_self_res=None,
                     mode: str = "default",
                     draws: ForwardDraws | None = None):
        """NCHW inputs -> {'f_image', 'f_events', 'f_fusion',
        'f_img_self_res'} NCHW pyramids (None where absent). ``draws``
        (training) carries the drop-path uniforms; None is eval. Training
        is ported for modes 'default' and 'fusion_isr', with the events+ISR
        double batch or with events alone, 'fusion_all', with the double
        batch, and 'no_fusion', with events alone."""
        double = (events is not None and img_self_res is not None
                  and events.shape == img_self_res.shape)
        if draws is not None and not (
                events is not None
                and (mode in ("default", "fusion_isr")
                     and (double or img_self_res is None)
                     or mode == "fusion_all" and double
                     or mode == "no_fusion" and img_self_res is None)):
            raise NotImplementedError(
                f"training forward in mode {mode!r} with events "
                f"{'absent' if events is None else 'present'} and ISR "
                f"{'absent' if img_self_res is None else 'present'} is not "
                "ported")
        if (draws is not None and mode in ("fusion_isr", "fusion_all")
                and draws.fusion_isr is None):
            raise ValueError(f"a training forward in mode {mode!r} needs "
                             "ForwardDraws.fusion_isr")
        d = draws if draws is not None else ForwardDraws()
        # the fusion modules' BatchNorms follow the forward's train (the
        # JAX modules' ``train``), not the head's bn_train
        train = draws is not None
        f_image = (self.backbone_image(image, d.image)
                   if image is not None else None)
        if double:
            # events and ISR share the events backbone: one double-batch pass
            both = self.backbone_events(torch.cat([events, img_self_res], 0),
                                        d.events)
            b = events.shape[0]
            f_events = [f[:b] for f in both]
            f_isr = [f[b:] for f in both]
        else:
            f_events = (self.backbone_events(events, d.events)
                        if events is not None else None)
            f_isr = (self.backbone_events(img_self_res)
                     if img_self_res is not None else None)
        if mode == "no_fusion":
            f_fusion = None
        elif mode == "fusion_isr":
            other = f_events if f_isr is None else f_isr
            f_fusion = self.fusion_isr_module(f_image, other, d.fusion_isr,
                                              train)
        elif mode == "fusion_all":
            f_a = self.fusion_isr_module(f_image, f_isr, d.fusion_isr, train)
            f_b = self.fusion_module(f_image, f_events, d.fusion, train)
            f_fusion = [(a + b) / 2 for a, b in zip(f_a, f_b)]
        elif mode == "default":
            f_fusion = (self.fusion_module(f_image, f_events, d.fusion,
                                           train)
                        if (self.fusion_module is not None
                            and f_events is not None) else None)
        else:
            raise ValueError(f"unknown extract_feat mode {mode!r}")
        return {"f_image": f_image, "f_events": f_events,
                "f_fusion": f_fusion, "f_img_self_res": f_isr}

    def forward_logits(self, image, events, img_self_res=None,
                       mode: str = "default", resize_to_input: bool = True,
                       streams=None, *, train: bool = False,
                       bn_train: bool | None = None, bn_update: bool = True,
                       draws: ForwardDraws | None = None,
                       return_feats: bool = False):
        """NHWC inputs -> dict of NHWC float32 logit streams, at the input
        resolution (``resize_to_input``) or at stride 4. ``streams`` limits
        which outputs are decoded.

        ``train`` turns on drop-path and Dropout2d with the draws in
        ``draws`` (required then); ``bn_train`` (default ``train``) uses
        batch statistics in BN, and ``bn_update`` whether they move the
        running statistics (the EMA teacher: ``train=False,
        bn_train=True, bn_update=False``)."""
        if train and draws is None:
            raise ValueError("train=True needs the forward's draws")
        ref = image if image is not None else events
        dt = self.dtype
        feats = self.extract_feat(_nchw(image, dt), _nchw(events, dt),
                                  _nchw(img_self_res, dt), mode,
                                  draws if train else None)
        out = self.decode_head(
            feats, streams=streams, train=train, bn_train=bn_train,
            bn_update=bn_update,
            dropout_keep=draws.dropout_keep if train else None)
        out = {k: (v.permute(0, 2, 3, 1) if v is not None else None)
               for k, v in out.items()}
        if resize_to_input:
            out = {k: (resize_bilinear(v, ref.shape[1:3])
                       if v is not None else None) for k, v in out.items()}
        return (out, feats) if return_feats else out

    def forward_train(self, image, events, img_self_res=None,
                      mode: str = "default",
                      draws: ForwardDraws | None = None):
        """Training forward: (stride-4 NHWC logits dict, NCHW features),
        with drop-path, Dropout2d and batch-statistics BN that moves the
        running statistics."""
        return self.forward_logits(image, events, img_self_res, mode,
                                   resize_to_input=False, train=True,
                                   draws=draws, return_feats=True)

    def forward(self, image, events, img_self_res=None, mode: str = "default",
                output: str = "fusion"):
        """One selected stream, resized to the input size (NHWC)."""
        out = self.forward_logits(image, events, img_self_res, mode)
        got = out[OUTPUT_KEYS[output]]
        if got is None:  # events-less inference falls back to image stream
            got = out["image_output"]
        return got


class EncoderDecoder(nn.Module):
    """Single-backbone segmentor (mirrors cmda_tpu.models.segmentor.
    EncoderDecoder): ``backbone`` (MiT) and ``decode_head``
    (``DAFormerHead``). ``forward`` and ``extract_feat`` are eval mode (no
    drop-path, no dropout, BatchNorm on running statistics): the frozen
    ImageNet encoder of the feature distance and the OrgDACS teacher.
    ``forward_with_features(train=True, draws=...)`` is the training
    forward of OrgDACS and DACSImage: the drop-path uniforms and the
    classifier's Dropout2d keep-masks of a ``ForwardDraws`` (``image``
    [depth_s, 2, B] per stage, ``dropout_keep`` [1, B, C]), BatchNorm on
    batch statistics that move the running statistics."""

    def __init__(self, cfg: SegmentorConfig = SegmentorConfig(),
                 dtype: str = "float32"):
        super().__init__()
        check_model_options(cfg)
        self.cfg = cfg
        self.dtype = DTYPES[dtype]
        mit_cfg = MIT_VARIANTS[cfg.backbone]
        mit_cfg = type(mit_cfg)(**{**mit_cfg.__dict__,
                                   "drop_path_rate": cfg.drop_path_rate})
        # full-block remat whatever remat_policy says: the JAX
        # EncoderDecoder passes its encoder ``remat`` alone
        self.backbone = MixVisionTransformer(mit_cfg, remat=cfg.remat)
        self.decode_head = DAFormerHead(cfg.head)

    def new_draws(self, batch: int, *, generator: torch.Generator,
                  device: torch.device) -> ForwardDraws:
        """Fresh ``ForwardDraws`` of a training forward at ``batch``, drawn
        from ``generator`` on ``device``."""
        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=device)
        cls = self.decode_head.conv_seg
        return ForwardDraws(
            image=[uniform(d, 2, batch) for d in self.backbone.cfg.depths],
            dropout_keep=uniform(1, batch, cls.in_channels)
            < 1.0 - cls.dropout_ratio)

    def extract_feat(self, img, draws: ForwardDraws | None = None):
        """NHWC image -> the backbone's four NCHW feature maps (eval, or
        with ``draws``' drop-path uniforms)."""
        return self._encode(img, draws)

    def _encode(self, img, draws):
        return self.backbone(_nchw(img, self.dtype),
                             draws.image if draws is not None else None)

    def forward_with_features(self, img, train: bool = False,
                              draws: ForwardDraws | None = None):
        """NHWC image -> (NHWC float32 logits at the input size, the NCHW
        feature maps). ``train`` needs ``draws``."""
        if train and draws is None:
            raise ValueError("train=True needs the forward's draws")
        feats = self._encode(img, draws if train else None)
        keep = draws.dropout_keep[0] if train else None
        logits = self.decode_head(feats, train, keep)
        return (resize_bilinear(logits.permute(0, 2, 3, 1), img.shape[1:3]),
                feats)

    def forward(self, img):
        """NHWC image -> NHWC float32 logits at the input size (eval)."""
        return self.forward_with_features(img)[0]


class EventsEncoderDecoder(EncoderDecoder):
    """Early fusion (mirrors cmda_tpu.models.segmentor.EventsEncoderDecoder):
    the image and the events concatenated along channels into ONE MiT
    (``in_chans`` = their channels together, 6 for a 3-channel image and
    3-channel events) and the single-stream DAFormer head. ``forward`` is
    eval; ``forward_with_features(image, events, train=True, draws=...)``
    the training forward, with ``EncoderDecoder``'s draws."""

    def __init__(self, cfg: SegmentorConfig = SegmentorConfig(),
                 dtype: str = "float32", in_chans: int = 6):
        nn.Module.__init__(self)
        check_model_options(cfg)
        self.cfg = cfg
        self.dtype = DTYPES[dtype]
        mit_cfg = MIT_VARIANTS[cfg.backbone]
        mit_cfg = type(mit_cfg)(**{**mit_cfg.__dict__,
                                   "drop_path_rate": cfg.drop_path_rate})
        self.backbone = MixVisionTransformer(mit_cfg, in_chans=in_chans,
                                             remat=cfg.remat)
        self.decode_head = DAFormerHead(cfg.head)

    def extract_feat(self, image, events, draws: ForwardDraws | None = None):
        """NHWC image and events -> the backbone's four NCHW maps."""
        return self._encode(torch.cat([image, events], dim=-1), draws)

    def forward_with_features(self, image, events, train: bool = False,
                              draws: ForwardDraws | None = None):
        return super().forward_with_features(
            torch.cat([image, events], dim=-1), train, draws)

    def forward(self, image, events):
        """NHWC image and events -> NHWC float32 logits at the input size
        (eval)."""
        return self.forward_with_features(image, events)[0]


class GenericEncoderDecoder(nn.Module):
    """Any (backbone[, neck], head) pipeline -> logits at the input size
    (mirrors cmda_tpu.models.segmentor.GenericEncoderDecoder): the legacy
    architecture grid's ResNet / ResNeXt / ResNeSt / MiT x DLV2 / DLV3+ /
    DA / ISA / SegFormer / UPer / DAFormer combos, the 'sfa_' ones with the
    SegFormerAdapter neck, float32.

    ``forward_with_features(img, train=True, draws=...)`` is the training
    forward (OrgDACS's and the supervised grid step's): BatchNorm on batch
    statistics that move the running statistics; a MiT backbone's
    drop-path uniforms (``draws.image``) and the classifier's Dropout2d
    keep-masks (``draws.dropout_keep`` [1, B, C]) where the model has them
    (``new_draws``). Eval (``forward``, ``extract_feat``) runs BatchNorm on
    the running statistics.

    The JAX module names its head ``head``, not ``decode_head``, so the JAX
    optimizer trains it at the backbone's lr; OrgDACS builds its optimizer
    with ``make_optimizer(head=False)`` for such a model, where the head
    keeps the reference's ``decode_head`` name."""

    def __init__(self, backbone: nn.Module, head: nn.Module,
                 neck: nn.Module | None = None):
        super().__init__()
        self.backbone = backbone
        self.decode_head = head
        self.neck = neck
        self.dtype = torch.float32

    @property
    def _mit(self) -> bool:
        return isinstance(self.backbone, MixVisionTransformer)

    def _dropout(self):
        cls = getattr(self.decode_head, "conv_seg", None)
        return (None if cls is None or cls.dropout_ratio == 0
                else (cls.dropout_ratio, cls.in_channels))

    def new_draws(self, batch: int, *, generator: torch.Generator,
                  device: torch.device) -> ForwardDraws:
        """Fresh ``ForwardDraws`` of a training forward at ``batch`` (None
        where the model draws nothing)."""
        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=device)
        image = ([uniform(d, 2, batch) for d in self.backbone.cfg.depths]
                 if self._mit else None)
        drop = self._dropout()
        keep = (uniform(1, batch, drop[1]) < 1.0 - drop[0]
                if drop is not None else None)
        return ForwardDraws(image=image, dropout_keep=keep)

    def extract_feat(self, img, draws: ForwardDraws | None = None,
                     train: bool = False):
        """NHWC image -> the backbone's (and neck's) NCHW maps; eval unless
        ``train``."""
        x = _nchw(img, self.dtype)
        if self._mit:
            feats = self.backbone(x, draws.image if train and draws is not None
                                  else None)
        else:
            feats = self.backbone(x, train)
        return self.neck(feats) if self.neck is not None else feats

    def forward_with_features(self, img, train: bool = False,
                              draws: ForwardDraws | None = None):
        """NHWC image -> (NHWC float32 logits at the input size, the NCHW
        maps)."""
        if train:
            d = draws if draws is not None else ForwardDraws()
            if ((self._mit and self.backbone.cfg.drop_path_rate > 0
                 and d.image is None)
                    or (self._dropout() is not None
                        and d.dropout_keep is None)):
                raise ValueError("train=True needs the forward's draws")
        feats = self.extract_feat(img, draws, train)
        keep = (draws.dropout_keep[0] if train and draws is not None
                and draws.dropout_keep is not None else None)
        logits = self.decode_head(feats, train, keep)
        return (resize_bilinear(logits.permute(0, 2, 3, 1), img.shape[1:3]),
                feats)

    def forward(self, img):
        """NHWC image -> NHWC float32 logits at the input size (eval)."""
        return self.forward_with_features(img)[0]


def multi_scale_flip_inference(apply_fn, img, *, scales=(1.0,),
                               flip: bool = False):
    """The reference's aug_test (encoder_decoder.py:986-1003): the softmax
    of ``apply_fn(x)`` (logits at x's size, NHWC) averaged over ``scales``
    and, with ``flip``, horizontal flips, each resized back to the input's
    size [B, H, W, C] first; float32."""
    h, w = img.shape[1:3]
    acc, n = None, 0
    for s in scales:
        # Python's round (half to even), as the JAX package sizes a scale
        sh, sw = int(round(h * s)), int(round(w * s))
        x = resize_bilinear(img, (sh, sw)) if (sh, sw) != (h, w) else img
        variants = [x] + ([torch.flip(x, dims=(2,))] if flip else [])
        for vi, v in enumerate(variants):
            logits = resize_bilinear(apply_fn(v), (h, w))
            sm = torch.softmax(logits.float(), dim=-1)
            if vi == 1:
                sm = torch.flip(sm, dims=(2,))
            acc = sm if acc is None else acc + sm
            n += 1
    return acc / n


def slide_grid(size, crop_size, stride):
    """The (y1, x1) corners of the reference's static crop grid
    (encoder_decoder.py:175-218), row by row; the last crop of a row or
    column is clamped to end at the image's edge."""
    h, w = size
    h_crop, w_crop = crop_size
    h_stride, w_stride = stride
    h_grids = max(h - h_crop + h_stride - 1, 0) // h_stride + 1
    w_grids = max(w - w_crop + w_stride - 1, 0) // w_stride + 1
    return [(min(hi * h_stride, h - h_crop), min(wi * w_stride, w - w_crop))
            for hi in range(h_grids) for wi in range(w_grids)]


def _chunk_spans(total: int, chunk: int):
    """(start, length) spans covering ``total`` in steps of ``chunk``."""
    return [(s, min(chunk, total - s)) for s in range(0, total, chunk)]


def slide_inference(apply_fn, img, *, crop_size, stride, num_classes: int,
                    crop_chunk: int | None = None):
    """Sliding-window logits [B, H, W, num_classes] (float32) of NHWC
    ``img``: the G crops of ``slide_grid`` are folded into the batch and
    run through ``apply_fn`` (logits at crop size) in one forward of G*B
    crops, or in forwards of at most ``crop_chunk`` crops; each crop's
    logits are added where it came from, in grid order, and the sum is
    divided by the number of crops over each pixel."""
    b, h, w, _ = img.shape
    h_crop, w_crop = crop_size
    offsets = slide_grid((h, w), crop_size, stride)
    g_total = len(offsets)
    flat = torch.cat([img[:, y1:y1 + h_crop, x1:x1 + w_crop]
                      for y1, x1 in offsets])      # [G*B, hc, wc, C_in]
    chunk = g_total if not crop_chunk else min(crop_chunk, g_total)
    logits = torch.cat([apply_fn(flat[s * b:(s + g) * b])
                        for s, g in _chunk_spans(g_total, chunk)])
    preds = torch.zeros((b, h, w, num_classes), dtype=torch.float32,
                        device=img.device)
    count = torch.zeros((b, h, w, 1), dtype=torch.float32, device=img.device)
    for g, (y1, x1) in enumerate(offsets):
        preds[:, y1:y1 + h_crop, x1:x1 + w_crop] += logits[
            g * b:(g + 1) * b].float()
        count[:, y1:y1 + h_crop, x1:x1 + w_crop] += 1.0
    return preds / count
