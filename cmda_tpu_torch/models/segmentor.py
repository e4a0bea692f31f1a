"""The dual-backbone image+events segmentor (mirrors
cmda_tpu.models.segmentor.FusionEncoderDecoder).

``backbone_image`` + ``backbone_events`` (the events backbone also encodes
the ISR stream), a fusion module over the two pyramids (+ the optional
``fusion_isr_module``) and the DAFormer fusion head. ``forward_logits`` and
``forward`` take NHWC inputs and return NHWC logits, like the JAX package;
the modules inside are NCHW.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
import torch.nn as nn

from .daformer import DAFormerFusionHead, DAFormerHeadConfig
from .fusion import build_fusion_module
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


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OUTPUT_KEYS = {"fusion": "fusion_output", "image": "image_output",
               "events": "events_output", "isr": "img_self_res_output"}


def _nchw(x):
    return None if x is None else x.permute(0, 3, 1, 2)


class FusionEncoderDecoder(nn.Module):
    """Dual-backbone image+events segmentor with feature-level fusion.

    ``dtype='bfloat16'`` runs the convs and matmuls under autocast; the qk
    softmax, the norms and the classifier stay float32, as in the JAX
    package's bfloat16 mode."""

    def __init__(self, cfg: SegmentorConfig = SegmentorConfig(),
                 dtype: str = "float32"):
        super().__init__()
        self.cfg = cfg
        self.dtype = DTYPES[dtype]
        mit_cfg = MIT_VARIANTS[cfg.backbone]
        mit_cfg = type(mit_cfg)(**{**mit_cfg.__dict__,
                                   "drop_path_rate": cfg.drop_path_rate})
        self.backbone_image = MixVisionTransformer(mit_cfg)
        self.backbone_events = MixVisionTransformer(mit_cfg)
        self.fusion_module = build_fusion_module(cfg.fusion,
                                                 mit_cfg.embed_dims)
        self.fusion_isr_module = build_fusion_module(cfg.fusion_isr,
                                                     mit_cfg.embed_dims)
        self.decode_head = DAFormerFusionHead(
            cfg.head, share=cfg.share_decoder, split_cls=cfg.split_cls,
            events_classes=cfg.events_classes)

    def _autocast(self, device):
        if self.dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=self.dtype)

    def extract_feat(self, image, events, img_self_res=None,
                     mode: str = "default"):
        """NCHW inputs -> {'f_image', 'f_events', 'f_fusion',
        'f_img_self_res'} NCHW pyramids (None where absent)."""
        f_image = self.backbone_image(image) if image is not None else None
        if (events is not None and img_self_res is not None
                and events.shape == img_self_res.shape):
            # events and ISR share the events backbone: one double-batch pass
            both = self.backbone_events(torch.cat([events, img_self_res], 0))
            b = events.shape[0]
            f_events = [f[:b] for f in both]
            f_isr = [f[b:] for f in both]
        else:
            f_events = (self.backbone_events(events)
                        if events is not None else None)
            f_isr = (self.backbone_events(img_self_res)
                     if img_self_res is not None else None)
        if mode == "no_fusion":
            f_fusion = None
        elif mode == "fusion_isr":
            other = f_events if f_isr is None else f_isr
            f_fusion = self.fusion_isr_module(f_image, other)
        elif mode == "fusion_all":
            f_a = self.fusion_isr_module(f_image, f_isr)
            f_b = self.fusion_module(f_image, f_events)
            f_fusion = [(a + b) / 2 for a, b in zip(f_a, f_b)]
        elif mode == "default":
            f_fusion = (self.fusion_module(f_image, f_events)
                        if (self.fusion_module is not None
                            and f_events is not None) else None)
        else:
            raise ValueError(f"unknown extract_feat mode {mode!r}")
        return {"f_image": f_image, "f_events": f_events,
                "f_fusion": f_fusion, "f_img_self_res": f_isr}

    def forward_logits(self, image, events, img_self_res=None,
                       mode: str = "default", resize_to_input: bool = True,
                       streams=None):
        """NHWC inputs -> dict of NHWC float32 logit streams, at the input
        resolution (``resize_to_input``) or at stride 4. ``streams`` limits
        which outputs are decoded."""
        ref = image if image is not None else events
        with self._autocast(ref.device):
            feats = self.extract_feat(_nchw(image), _nchw(events),
                                      _nchw(img_self_res), mode)
            out = self.decode_head(feats, streams=streams)
        out = {k: (v.permute(0, 2, 3, 1) if v is not None else None)
               for k, v in out.items()}
        if resize_to_input:
            out = {k: (resize_bilinear(v, ref.shape[1:3])
                       if v is not None else None) for k, v in out.items()}
        return out

    def forward(self, image, events, img_self_res=None, mode: str = "default",
                output: str = "fusion"):
        """One selected stream, resized to the input size (NHWC)."""
        out = self.forward_logits(image, events, img_self_res, mode)
        got = out[OUTPUT_KEYS[output]]
        if got is None:  # events-less inference falls back to image stream
            got = out["image_output"]
        return got
