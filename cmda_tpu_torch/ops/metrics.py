"""Segmentation evaluation metrics (mIoU / aAcc / per-class IoU & Acc).

Behavioral contract: reference mmseg/core/evaluation/metrics.py:27-328 —
histogram-based intersect/union with an ignore mask, float64 accumulation,
nan for classes absent from both pred and gt.  The DSEC evaluation reports
18-class mIoU by converting the 19-class mean (reference README.md:220-224:
``miou_18 = miou_19 * 19 / 18`` since class 'train' never appears).

A numpy copy of cmda_tpu.ops.metrics, and ``intersect_and_union_torch``,
its on-device histogram variant (the JAX package's
``intersect_and_union_jnp``): the same integer histograms as the numpy
``intersect_and_union``, as int64 tensors on the inputs' device.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


def intersect_and_union(pred, label, num_classes: int, ignore_index: int = 255):
    """Per-image histograms: (intersect, union, pred_hist, label_hist)."""
    pred = np.asarray(pred)
    label = np.asarray(label)
    mask = label != ignore_index
    pred = pred[mask]
    label = label[mask]
    intersect = pred[pred == label]
    area_intersect = np.bincount(intersect, minlength=num_classes)[:num_classes]
    area_pred = np.bincount(pred, minlength=num_classes)[:num_classes]
    area_label = np.bincount(label, minlength=num_classes)[:num_classes]
    area_union = area_pred + area_label - area_intersect
    return (area_intersect.astype(np.float64), area_union.astype(np.float64),
            area_pred.astype(np.float64), area_label.astype(np.float64))


def intersect_and_union_torch(pred: torch.Tensor, label: torch.Tensor,
                              num_classes: int, ignore_index: int = 255):
    """(intersect, union, pred_hist, label_hist) [num_classes] int64 of
    ``pred`` and ``label`` (any equal shapes), on their device: ignored
    pixels go to two spare bins past the classes, which are dropped."""
    mask = label != ignore_index
    safe_label = torch.where(mask, label, num_classes).long().reshape(-1)
    safe_pred = torch.where(mask, pred, num_classes + 1).long().reshape(-1)
    inter = torch.where(safe_pred == safe_label, safe_pred,
                        num_classes)
    n = num_classes + 2
    area_intersect = torch.bincount(inter, minlength=n)[:num_classes]
    area_pred = torch.bincount(safe_pred, minlength=n)[:num_classes]
    area_label = torch.bincount(safe_label, minlength=n)[:num_classes]
    return (area_intersect, area_pred + area_label - area_intersect,
            area_pred, area_label)


def eval_metrics(total_intersect, total_union, total_pred, total_label,
                 metrics=("mIoU",), nan_to_num=None, beta: int = 1):
    """Aggregate histograms -> {'aAcc', 'IoU', 'Acc', ...} numpy arrays.

    Mirrors the reference's total_area_* -> metric mapping; classes with
    union 0 give nan (and are nan-ignored in summary means by callers).
    """
    if isinstance(metrics, str):
        metrics = [metrics]
    allowed = {"mIoU", "mDice", "mFscore"}
    if not set(metrics).issubset(allowed):
        raise KeyError(f"metrics {metrics} is not supported")
    with np.errstate(divide="ignore", invalid="ignore"):
        ret = OrderedDict(
            aAcc=np.nansum(total_intersect) / np.nansum(total_label))
        for metric in metrics:
            if metric == "mIoU":
                ret["IoU"] = total_intersect / total_union
                ret["Acc"] = total_intersect / total_label
            elif metric == "mDice":
                ret["Dice"] = 2 * total_intersect / (total_pred + total_label)
                ret["Acc"] = total_intersect / total_label
            elif metric == "mFscore":
                precision = total_intersect / total_pred
                recall = total_intersect / total_label
                score = ((1 + beta ** 2) * precision * recall
                         / (beta ** 2 * precision + recall))
                ret["Fscore"] = score
                ret["Precision"] = precision
                ret["Recall"] = recall
    ret = {k: np.asarray(v) for k, v in ret.items()}
    if nan_to_num is not None:
        ret = {k: np.nan_to_num(v, nan=nan_to_num) for k, v in ret.items()}
    return ret


def summarize_miou(ret: dict, valid_classes: int | None = None) -> dict:
    """nanmean summary; optional 19->18-class rescale for DSEC
    (reference README.md:222-224)."""
    miou = float(np.nanmean(ret["IoU"]))
    out = {
        "mIoU": miou,
        "aAcc": float(ret["aAcc"]),
        "mAcc": float(np.nanmean(ret["Acc"])),
    }
    if valid_classes is not None:
        n = len(ret["IoU"])
        out[f"mIoU_{valid_classes}cls"] = miou * n / valid_classes
    return out
