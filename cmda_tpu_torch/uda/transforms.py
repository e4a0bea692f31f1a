"""UDA loss pieces (mirrors the flagship's part of cmda_tpu.uda.transforms).

* ``multi_stream_loss``: the weighted sum over the head's streams,
  fusion*w_f + image*w_i, plus isr*w_isr + events*(w_e/2) when the ISR
  stream is there, else events*w_e; each stream's CE is taken on its
  stride-4 logits upsampled to the label size, through the fused
  upsample+CE kernels for integer factors (``fused_resize_ce``) and the
  plain resize+CE otherwise. ``acc_seg`` comes from the fusion stream (the
  image stream without fusion), through the fused upsample+argmax kernel.
  With ``stacked`` (``uda.stacked_stream_ce``) and all four streams, the
  four CEs are one checkpointed resize + CE over the [4, B, h, w, C] stack
  (``stacked_stream_ce``), plain torch as it is plain XLA in the JAX
  package: that step launches no CE kernel, the JAX step no Pallas CE.
* ``pseudo_label_and_weight`` / ``pseudo_label_and_weight_coarse``: the
  teacher's argmax labels and the scalar confidence-ratio weight (share of
  pixels whose max softmax >= threshold), with optional top/bottom rows
  zeroed; the coarse form takes stride-4 logits through the fused
  upsample+argmax kernel, so the full-size teacher logits never exist.
* ``split_stream_loss``: the two-stream loss of the cs2dz split, no-fusion
  and d2n train types, each stream with its own labels and pixel weights,
  both terms times ``factor``; an unweighted stream through the fused
  upsample+CE kernels, the class-weighted edge stream (``isr_edge`` with
  ``isr_edge_class_weight``) a checkpointed plain resize + class-weighted
  CE, as it is XLA in the JAX step; ``acc_seg`` from the image stream.
* ``seg_label_to_edge_label``: the binary edge map of a label map (3x3
  replicate-padded window mean != centre, 0 where the window holds an
  ignored pixel).
* ``feature_consistency_loss`` (the ISR-feature consistency),
  ``downscale_label_ratio`` and ``masked_feat_dist`` (the ImageNet feature
  distance), on NCHW features.
"""
from __future__ import annotations

import torch

from ..models.common import maybe_checkpoint
from ..ops.fused_ce import fused_resize_ce, resize_ce
from ..ops.fused_resize import (fused_resize_argmax, is_integer_factor,
                                resize_argmax)
from ..ops.losses import (accuracy_of_labels, weighted_cross_entropy,
                          weighted_cross_entropy_stacked)
from ..ops.resize import resize_bilinear


def _stream_accuracy(x: torch.Tensor, label: torch.Tensor,
                     ignore_index: int = 255) -> torch.Tensor:
    """pixel_accuracy of ``x`` [B, h, w, C] upsampled to the label size."""
    size = tuple(label.shape[1:3])
    x = x.detach().contiguous()
    if is_integer_factor(x.shape, size):
        pred = fused_resize_argmax(x, size, with_prob=False)[0]
    else:
        pred = resize_argmax(x, size, with_prob=False)[0]
    return accuracy_of_labels(pred, label, ignore_index)


def stream_ce(x: torch.Tensor, label: torch.Tensor,
              weight: torch.Tensor | None,
              ignore_index: int = 255) -> torch.Tensor:
    """CE of stride-4 logits ``x`` upsampled to the label size: the fused
    kernels for integer factors, the plain resize+CE for any other
    geometry (a dispatch on shape, visible in the kernels' launch
    counters)."""
    if is_integer_factor(x.shape, label.shape[1:3]):
        return fused_resize_ce(x.contiguous(), label, weight,
                               ignore_index=ignore_index)
    return resize_ce(x, label, weight, ignore_index)


def stacked_stream_ce(xs: torch.Tensor, label: torch.Tensor,
                      weight: torch.Tensor | None,
                      ignore_index: int = 255) -> torch.Tensor:
    """The CEs of the stacked stride-4 streams ``xs`` [S, B, h, w, C]
    upsampled to the label size, [S]: one resize and one CE chain,
    recomputed in the backward pass (``torch.utils.checkpoint``, as the JAX
    package's ``jax.checkpoint``) so the upsampled logits are not kept."""
    size = tuple(label.shape[1:3])

    def fn(xs):
        big = resize_bilinear(xs.reshape((-1,) + tuple(xs.shape[2:])), size)
        return weighted_cross_entropy_stacked(
            big.reshape(tuple(xs.shape[:2]) + tuple(big.shape[1:])), label,
            weight, ignore_index)
    return maybe_checkpoint(fn, xs, remat=True)


def multi_stream_loss(logits: dict, label: torch.Tensor,
                      seg_weight: torch.Tensor | None, *, w_image: float,
                      w_events: float, w_fusion, w_isr: float,
                      ignore_index: int = 255, stacked: bool = False):
    """logits: dict of stride-4 NHWC streams (None where absent); label
    [B, H, W] int32; seg_weight [B, H, W] float32 or None; ``w_fusion`` a
    float or a 0-dim tensor (``isr_no_fusion``'s gated weight). Returns
    (loss, logs), the logs as 0-dim tensors. ``stacked``: the four streams'
    CEs through ``stacked_stream_ce`` when all four are there."""
    def ce(x):
        return stream_ce(x, label, seg_weight, ignore_index)

    keys = ("image_output", "fusion_output", "events_output",
            "img_self_res_output")
    if stacked and all(logits.get(k) is not None for k in keys):
        l_image, l_fusion, l_events, l_isr = stacked_stream_ce(
            torch.stack([logits[k] for k in keys]), label, seg_weight,
            ignore_index)
        loss = (l_image * w_image + l_fusion * w_fusion + l_isr * w_isr
                + l_events * (w_events / 2.0))
        logs = {"loss_image": l_image, "loss_fusion": l_fusion,
                "loss_events": l_events, "loss_isr": l_isr,
                "acc_seg": _stream_accuracy(logits["fusion_output"], label,
                                            ignore_index),
                "loss_seg": loss}
        return loss, {k: v.detach() for k, v in logs.items()}

    l_image = ce(logits["image_output"])
    loss = l_image * w_image
    logs = {"loss_image": l_image}
    if logits.get("fusion_output") is not None:
        l_fusion = ce(logits["fusion_output"])
        loss = loss + l_fusion * w_fusion
        logs["loss_fusion"] = l_fusion
        logs["acc_seg"] = _stream_accuracy(logits["fusion_output"], label,
                                           ignore_index)
    else:
        logs["acc_seg"] = _stream_accuracy(logits["image_output"], label,
                                           ignore_index)
    if logits.get("events_output") is not None:
        l_events = ce(logits["events_output"])
        logs["loss_events"] = l_events
        if logits.get("img_self_res_output") is not None:
            l_isr = ce(logits["img_self_res_output"])
            logs["loss_isr"] = l_isr
            loss = loss + l_isr * w_isr + l_events * (w_events / 2.0)
        else:
            loss = loss + l_events * w_events
    logs["loss_seg"] = loss
    return loss, {k: v.detach() for k, v in logs.items()}


def split_stream_loss(logits: dict, labels: dict, weights: dict, *,
                      w_image: float, w_events: float, factor: float = 2.0,
                      ignore_index: int = 255,
                      events_class_weight: torch.Tensor | None = None):
    """The image and events streams' CEs, each on its own label map
    (``labels['image']``, ``labels['events']``) and pixel weight
    (``weights.get(...)``, None for none): loss = (l_image * w_image +
    l_events * w_events) * factor (factor 2: the split type; 1: no-fusion
    and d2n). ``events_class_weight`` [C_events] weights the events stream's
    classes (a checkpointed plain resize + CE, no kernel). Returns (loss,
    logs), the logs as 0-dim tensors."""
    size = tuple(labels["image"].shape[1:3])

    def class_weighted_ce(x, lbl, w):
        return maybe_checkpoint(lambda x: weighted_cross_entropy(
            resize_bilinear(x.float(), size), lbl, w, ignore_index,
            events_class_weight), x, remat=True)

    l_img = stream_ce(logits["image_output"], labels["image"],
                      weights.get("image"), ignore_index)
    if events_class_weight is None:
        l_ev = stream_ce(logits["events_output"], labels["events"],
                         weights.get("events"), ignore_index)
    else:
        l_ev = class_weighted_ce(logits["events_output"], labels["events"],
                                 weights.get("events"))
    loss = l_img * w_image * factor + l_ev * w_events * factor
    logs = {"loss_image": l_img, "loss_events": l_ev, "loss_seg": loss,
            "acc_seg": _stream_accuracy(logits["image_output"],
                                        labels["image"], ignore_index)}
    return loss, {k: v.detach() for k, v in logs.items()}


def seg_label_to_edge_label(label: torch.Tensor,
                            ignore_index: int = 255) -> torch.Tensor:
    """[B, H, W] labels -> int32 edge map (reference
    dacs_transforms.py:174-183): 1 where the 3x3 replicate-padded window's
    mean differs from the centre, 0 where the window's max is at or above
    ``ignore_index``."""
    lf = label.float()[:, None]
    padded = torch.nn.functional.pad(lf, (1, 1, 1, 1), mode="replicate")
    # an exact integer sum, then the division, as the JAX function's
    win = torch.nn.functional.avg_pool2d(padded, 3, stride=1,
                                         divisor_override=1) / 9.0
    mx = torch.nn.functional.max_pool2d(padded, 3, stride=1)
    edge = torch.where(win != lf, 1, 0)
    edge = torch.where(mx >= ignore_index, 0, edge)
    return edge[:, 0].to(torch.int32)


def feature_consistency_loss(f_image, f_target, lam: float) -> torch.Tensor:
    """lam * sum over scales of the mean squared difference between
    ``f_image`` and the detached ``f_target`` (reference
    encoder_decoder.py:833-848), in float32."""
    loss = 0.0
    for a, b in zip(f_image, f_target):
        loss = loss + ((a.float() - b.detach().float()) ** 2).mean()
    return lam * loss


def downscale_label_ratio(gt: torch.Tensor, scale_factor: int,
                          min_ratio: float, n_classes: int,
                          ignore_index: int = 255) -> torch.Tensor:
    """[B, H, W] -> [B, H/s, W/s] int32 (reference utils.py:18-40): each
    s x s block's majority class (the ignore id counted as a class), or
    ``ignore_index`` where that class holds less than ``min_ratio`` of the
    block."""
    if scale_factor <= 1:
        raise ValueError(f"scale_factor {scale_factor} must be above 1")
    ignore_sub = n_classes
    out = torch.where(gt == ignore_index, ignore_sub, gt).long()
    onehot = torch.nn.functional.one_hot(out, n_classes + 1).float()
    b, h, w, c = onehot.shape
    s = scale_factor
    pooled = onehot.reshape(b, h // s, s, w // s, s, c).mean(dim=(2, 4))
    ratio, lbl = pooled.amax(dim=-1), pooled.argmax(dim=-1)
    lbl = torch.where(lbl == ignore_sub, ignore_index, lbl)
    lbl = torch.where(ratio < min_ratio, ignore_index, lbl)
    return lbl.to(torch.int32)


def masked_feat_dist(f_student: torch.Tensor, f_imnet: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """The mean over the ``mask`` [B, h, w] positions of the L2 norm over
    channels of the NCHW feature difference (reference dacs.py:317-326)."""
    diff = f_student.float() - f_imnet.float()
    dist = torch.sqrt((diff * diff).sum(dim=1) + 1e-12)
    m = mask.float()
    return (dist * m).sum() / m.sum().clamp(min=1.0)


def _weight_from_prob(prob, threshold, ignore_top, ignore_bottom):
    ratio = (prob >= threshold).float().mean()
    weight = torch.ones_like(prob) * ratio
    if ignore_top > 0:
        weight[:, :ignore_top, :] = 0.0
    if ignore_bottom > 0:
        weight[:, -ignore_bottom:, :] = 0.0
    return weight


def pseudo_label_and_weight(fusion_logits: torch.Tensor, *,
                            threshold: float = 0.968, ignore_top: int = 0,
                            ignore_bottom: int = 0):
    """Full-size teacher logits [B, H, W, C] -> (pseudo_label int32,
    weight float32 [B, H, W])."""
    z = fusion_logits.float()
    softmax = torch.softmax(z, dim=-1)
    prob, _ = softmax.max(dim=-1)
    label = softmax.argmax(dim=-1).to(torch.int32)
    return label, _weight_from_prob(prob, threshold, ignore_top,
                                    ignore_bottom)


def pseudo_label_and_weight_coarse(logits_s4: torch.Tensor, out_size, *,
                                   threshold: float = 0.968,
                                   ignore_top: int = 0,
                                   ignore_bottom: int = 0):
    """``pseudo_label_and_weight`` of stride-4 logits upsampled to
    ``out_size``: the fused upsample+argmax kernel for integer factors, the
    plain resize + softmax otherwise (the same math)."""
    out_size = tuple(out_size)
    if is_integer_factor(logits_s4.shape, out_size):
        label, prob = fused_resize_argmax(logits_s4.detach().contiguous(),
                                          out_size)
    else:
        label, prob = resize_argmax(logits_s4.detach(), out_size)
    return label, _weight_from_prob(prob, threshold, ignore_top,
                                    ignore_bottom)
