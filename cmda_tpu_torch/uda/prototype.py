"""The prototype bank and the pixel contrastive loss (mirrors
cmda_tpu.uda.prototype), the auxiliary machinery of the reference's
DACSImage (mmseg/models/uda/prototype_contrast.py):

* ``PrototypeBank``, ``class_mean_features``, ``update_prototypes``: the
  per-class mean feature vectors, a plain average for the first 100
  updates, then proto * (1 - m) + m * vector (sic, as the reference);
  classes with fewer than ``min_pixels`` predicted pixels skipped;
* ``ContrastQueues``, ``enqueue``, ``_ring_write``: per-class segment and
  pixel memory queues, L2-normalised rows written in a ring;
* ``pixel_contrast_loss``: supervised InfoNCE of ``n_view`` anchor pixels
  per (sample, class), half "hard" (predicted c, labelled otherwise), half
  "easy", against the queue (class 0 skipped).

Static shapes, as in the JAX package: anchors and enqueued pixels are
picked by ranking random scores over the eligible pixels, with validity
masks. Every random value is an explicit input (``scores``, the queues'
initial ``noise``), so both packages can be handed the same. The rankings
sort stably ascending, as ``jnp.argsort``; the anchors take the reverse of
that order, as the JAX ``[::-1]``, so equal scores (the -1 of ineligible
pixels) pick the same indices. Features are channels-last ([B, h, w, D])
and labels [B, H, W] (taken at stride H / h), as in the JAX functions.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F


@dataclass
class PrototypeBank:
    protos: torch.Tensor      # [K, D]
    counts: torch.Tensor      # [K]

    @classmethod
    def create(cls, num_classes: int = 19, dim: int = 256, device="cpu"):
        return cls(protos=torch.zeros((num_classes, dim), device=device),
                   counts=torch.zeros((num_classes,), device=device))


def _one_hot(index: torch.Tensor, k: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, k) gives a row of zeros."""
    inside = (index >= 0) & (index < k)
    safe = torch.where(inside, index, k).long()
    return F.one_hot(safe, k + 1)[..., :k].to(dtype)


def class_mean_features(feats, logits, labels=None, *, num_classes: int = 19,
                        min_pixels: int = 10):
    """Per-class mean of ``feats`` [B, h, w, D] over the pixels predicted
    as the class by ``logits`` [B, h, w, K] (and labelled so, with
    ``labels`` [B, h, w]): (means [B, K, D], valid [B, K] where the class
    has at least ``min_pixels`` pixels)."""
    onehot = _one_hot(logits.argmax(dim=-1), num_classes, feats.dtype)
    if labels is not None:
        onehot = onehot * _one_hot(
            torch.where(labels >= num_classes, num_classes, labels),
            num_classes, feats.dtype)
    counts = onehot.sum(dim=(1, 2))                             # [B, K]
    sums = torch.einsum("bhwk,bhwd->bkd", onehot, feats)
    means = sums / counts[..., None].clamp(min=1.0)
    return means, counts >= min_pixels


def update_prototypes(bank: PrototypeBank, means, valid, *,
                      momentum: float = 0.9999,
                      start_mean_until: int = 100) -> PrototypeBank:
    """Fold a batch of per-sample class means into the bank, one sample
    after another (the reference's update_single_prototype)."""
    protos, counts = bank.protos, bank.counts
    for i in range(means.shape[0]):
        v = means[i]
        ok = valid[i][:, None]
        n = counts[:, None]
        mean_upd = (protos * n + v) / (n + 1.0)
        ema_upd = protos * (1.0 - momentum) + momentum * v
        upd = torch.where(n < start_mean_until, mean_upd, ema_upd)
        protos = torch.where(ok, upd, protos)
        counts = (counts + valid[i].float()).clamp(max=3000.0)
    return replace(bank, protos=protos, counts=counts)


def _l2(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


@dataclass
class ContrastQueues:
    segment_queue: torch.Tensor  # [K, M, D], L2-normalised rows
    pixel_queue: torch.Tensor    # [K, M, D]
    segment_ptr: torch.Tensor    # [K] int64
    pixel_ptr: torch.Tensor      # [K] int64

    @classmethod
    def create(cls, noise=None, *, num_classes: int = 19,
               memory_size: int = 5000, dim: int = 256,
               generator: torch.Generator | None = None, device="cpu"):
        """Queues of L2-normalised N(0, 1) rows: ``noise`` (segment, pixel)
        [K, M, D] each, handed in, or drawn from ``generator``."""
        if noise is None:
            shape = (num_classes, memory_size, dim)
            noise = tuple(torch.randn(shape, generator=generator,
                                      device=device) for _ in range(2))
        sq, pq = noise
        z = torch.zeros((sq.shape[0],), dtype=torch.int64, device=sq.device)
        return cls(segment_queue=_l2(sq), pixel_queue=_l2(pq),
                   segment_ptr=z, pixel_ptr=z.clone())


def _ring_write(queue, ptr, rows, ok):
    """queue [K, M, D] with rows[k] written at queue[k, ptr[k]] where
    ok[k] (in place; the same values as the JAX one-hot blend for finite
    rows)."""
    k = torch.arange(queue.shape[0], device=queue.device)
    queue[k, ptr] = torch.where(ok[:, None], rows.to(queue.dtype),
                                queue[k, ptr])
    return queue


def enqueue(queues: ContrastQueues, feats, labels, scores, *,
            pixel_update_freq: int = 10) -> ContrastQueues:
    """Write, per sample and present class, the L2-normalised mean feature
    into the segment queue and up to ``pixel_update_freq`` pixels into the
    pixel queue: the class's highest of ``scores`` [B, h*w] (U[0, 1) in
    the JAX function), then the next. feats [B, h, w, D]; labels
    [B, H, W]. The queues are written in place."""
    b, h, w, d = feats.shape
    stride = labels.shape[1] // h
    lbl = labels[:, ::stride, ::stride]
    K, M = queues.segment_queue.shape[:2]
    sq, pq = queues.segment_queue, queues.pixel_queue
    sptr, pptr = queues.segment_ptr, queues.pixel_ptr
    flat_f = feats.reshape(b, h * w, d)
    flat_l = lbl.reshape(b, h * w)
    for i in range(b):
        onehot = _one_hot(torch.where(flat_l[i] >= K, K, flat_l[i]), K,
                          feats.dtype)
        cnt = onehot.sum(dim=0)                                  # [K]
        present = cnt > 0
        seg_feat = _l2((onehot.T @ flat_f[i]) / cnt[:, None].clamp(min=1.0))
        sq = _ring_write(sq, sptr, seg_feat, present)
        sptr = torch.where(present, (sptr + 1) % M, sptr)
        masked = scores[i][None, :] * onehot.T - (1 - onehot.T)    # [K, hw]
        order = torch.argsort(masked, dim=1, stable=True)
        for k_off in range(pixel_update_freq):
            idx = order[:, -(k_off + 1)]
            feat_k = _l2(flat_f[i][idx])
            ok = present & (cnt > k_off)
            pq = _ring_write(pq, pptr, feat_k, ok)
            pptr = torch.where(ok, (pptr + 1) % M, pptr)
    return replace(queues, segment_queue=sq, pixel_queue=pq,
                   segment_ptr=sptr, pixel_ptr=pptr)


def pixel_contrast_loss(scores, feats, labels, predict, queue, *,
                        temperature: float = 0.1,
                        base_temperature: float = 0.07, n_view: int = 32,
                        num_classes: int = 19, ignore_index: int = 255):
    """Static-shape supervised InfoNCE (the reference PixelContrastLoss).

    scores [B, num_classes, h*w] (U[0, 1) in the JAX function, one row per
    sample and class); feats [B, h, w, D] (L2-normalised here); labels
    [B, H, W] taken at stride H / h; predict [B, h, w] predicted labels;
    queue [K, Q, D]. Anchors: per (sample, class) ``n_view`` pixels, the
    first half ranked among the "hard" ones (predicted c, labelled another
    class), the rest among the "easy" ones (both c), masked where there are
    too few; a class with at most ``n_view`` eligible pixels gives none."""
    b, h, w, d = feats.shape
    stride = labels.shape[1] // h
    lbl = labels[:, ::stride, ::stride].reshape(b, 1, h * w)
    pred = predict.reshape(b, 1, h * w)
    f = _l2(feats.reshape(b, h * w, d))
    c = torch.arange(num_classes, device=feats.device)[None, :, None]
    is_c_pred = pred == c                                  # [B, K, hw]
    easy = is_c_pred & (lbl == c)
    hard = is_c_pred & (lbl != c) & (lbl != ignore_index)
    half = n_view // 2

    def ranked(eligible, n):
        order = torch.argsort(torch.where(eligible, scores, -1.0), dim=-1,
                              stable=True)
        return order.flip(-1)[..., :n]
    idx = torch.cat([ranked(hard, half), ranked(easy, n_view - half)], -1)
    n_hard, n_easy = hard.sum(-1, keepdim=True), easy.sum(-1, keepdim=True)
    view = torch.arange(n_view, device=feats.device)
    ok = torch.where(view < half, view < n_hard, view - half < n_easy)
    ok = ok & ((n_easy + n_hard) > n_view)                 # [B, K, n_view]
    anchors = torch.gather(
        f[:, None].expand(b, num_classes, h * w, d), 2,
        idx[..., None].expand(-1, -1, -1, d)).reshape(-1, d)
    a_ok = ok.reshape(-1).float()
    a_y = c.expand(b, num_classes, n_view).reshape(-1)

    # the contrast set: the queue without class 0 (reference
    # _sample_negative)
    kq, q = queue.shape[:2]
    c_y = torch.arange(kq, device=feats.device).repeat_interleave(q)
    contrast = queue.reshape(kq * q, d)
    cmask = (c_y != 0).float()
    logits = (anchors @ contrast.T) / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    same = (a_y[:, None] == c_y[None, :]).float()
    pos = same * cmask
    neg = (1.0 - same) * cmask
    exp_logits = torch.exp(logits) * cmask
    neg_sum = (exp_logits * neg).sum(1, keepdim=True)
    log_prob = logits - torch.log(exp_logits + neg_sum + 1e-12)
    mean_log_prob_pos = (pos * log_prob).sum(1) / pos.sum(1).clamp(min=1.0)
    per_anchor = -(temperature / base_temperature) * mean_log_prob_pos
    return (per_anchor * a_ok).sum() / a_ok.sum().clamp(min=1.0)
