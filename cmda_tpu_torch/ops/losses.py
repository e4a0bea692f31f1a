"""Segmentation losses (mirrors cmda_tpu.ops.losses).

* ``weighted_cross_entropy``: per-pixel CE, zero at ``ignore_index``, times
  the per-pixel weight, then the mean over **all** B*H*W pixels, ignored
  ones included (the reference's ``F.cross_entropy(reduction='none')``
  followed by ``.mean()``). ``F.cross_entropy(reduction='mean',
  ignore_index=...)`` divides by the valid count instead, so it is not used.
  With ``class_weight`` [C] each pixel's CE is also times its class's
  weight, and the sum is divided by the summed class weight of the valid
  pixels (floored at 1e-8), as ``F.cross_entropy(weight=...)`` normalises.
* ``weighted_cross_entropy_stacked``: the same CE of S stacked streams
  with one label and weight map, one value per stream.
* ``pixel_accuracy``: 100 * #(argmax == label) / numel(label), ignored
  pixels in the denominator (they can never match).
* ``charbonnier_loss``, ``weighted_binary_cross_entropy`` and
  ``ohem_weights``: the robust L1, the one-hot BCE with logits and the OHEM
  pixel weights of the reference's loss and sampler zoo.

Logits are NHWC [B, H, W, C]; labels [B, H, W] integers.
"""
from __future__ import annotations

import torch


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           weight: torch.Tensor | None = None,
                           ignore_index: int = 255,
                           class_weight: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Mean per-pixel CE with pixel weights, B*H*W denominator; with
    ``class_weight``, the class-weighted sum over the valid pixels' summed
    class weight."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    if class_weight is not None:
        cw = class_weight.float()[safe]
        nll = nll * cw
    nll = torch.where(valid, nll, 0.0)
    if weight is not None:
        nll = nll * weight.float()
    if class_weight is not None:
        return nll.sum() / torch.where(valid, cw, 0.0).sum().clamp(min=1e-8)
    return nll.mean()


def weighted_cross_entropy_stacked(logits: torch.Tensor,
                                   labels: torch.Tensor,
                                   weight: torch.Tensor | None = None,
                                   ignore_index: int = 255) -> torch.Tensor:
    """``weighted_cross_entropy`` of S streams sharing one label and weight
    map, in one chain: logits [S, B, H, W, C], labels [B, H, W] -> [S]."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    index = safe.unsqueeze(0).unsqueeze(-1).expand(
        logits.shape[0], *safe.shape, 1)
    nll = -logp.gather(-1, index).squeeze(-1)              # [S, B, H, W]
    nll = torch.where(valid, nll, 0.0)
    if weight is not None:
        nll = nll * weight.float()
    return nll.mean(dim=(1, 2, 3))


def pixel_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = 255) -> torch.Tensor:
    """Top-1 accuracy in percent over all pixels."""
    pred = logits.argmax(dim=-1)
    return accuracy_of_labels(pred, labels, ignore_index)


def accuracy_of_labels(pred: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255) -> torch.Tensor:
    """``pixel_accuracy`` of already-computed predicted labels."""
    correct = ((pred == labels) & (labels != ignore_index)).sum()
    return 100.0 * correct.float() / labels.numel()


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Robust L1 (Charbonnier): mean(sqrt(diff^2 + eps^2)) in float32."""
    diff = pred.float() - target.float()
    return torch.sqrt(diff * diff + eps * eps).mean()


def weighted_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  weight: torch.Tensor | None = None,
                                  ignore_index: int = 255) -> torch.Tensor:
    """BCE with logits against the one-hot labels (the reference's
    binary_cross_entropy path): ignored pixels contribute 0, times the
    pixel weight, the mean over all B*H*W*C elements."""
    valid = labels != ignore_index
    onehot = torch.nn.functional.one_hot(
        torch.where(valid, labels, 0).long(), logits.shape[-1]).float()
    x = logits.float()
    loss = x.clamp(min=0) - x * onehot + torch.log1p(torch.exp(-x.abs()))
    loss = loss * valid[..., None].float()
    if weight is not None:
        loss = loss * weight[..., None].float()
    return loss.mean()


def ohem_weights(logits: torch.Tensor, labels: torch.Tensor, *,
                 thresh: float | None = 0.7, min_kept: int = 100000,
                 ignore_index: int = 255) -> torch.Tensor:
    """Online hard example mining pixel weights (the reference's
    OHEMPixelSampler): per image, the valid pixels whose probability of
    their label is at most max(the ``min_kept``-th smallest such
    probability, ``thresh``). A 0/1 float32 map [B, H, W]."""
    b = logits.shape[0]
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    prob = torch.softmax(logits.float(), dim=-1)
    gt_prob = prob.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    gt_prob = torch.where(valid, gt_prob, torch.inf)
    flat = gt_prob.reshape(b, -1)
    k = min(min_kept, flat.shape[1])
    kth = torch.sort(flat, dim=1).values[:, k - 1]
    cutoff = kth.clamp(min=thresh if thresh is not None else 0.0)
    sel = flat <= cutoff[:, None]
    return (sel.reshape(labels.shape) & valid).float()
