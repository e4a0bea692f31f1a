"""Whole-frame evaluation (the ``evaluate_fusion`` of cmda_tpu.train.loop,
whole-image mode). The trainer, checkpoints, slide and aug-test inference
come with later slices."""
from __future__ import annotations

import numpy as np
import torch

from ..apis import Segmentor, model_device, predict_labels, select_logits
from ..data.synthetic import collate
from ..ops.metrics import eval_metrics, intersect_and_union, summarize_miou

CLASS_NAMES = ("road", "sidewalk", "building", "wall", "fence", "pole",
               "traffic light", "traffic sign", "vegetation", "terrain",
               "sky", "person", "rider", "car", "truck", "bus", "train",
               "motorcycle", "bicycle")


@torch.no_grad()
def evaluate_fusion(model, dataset, *, output: str = "fusion",
                    num_classes: int = 19, max_samples: int | None = None,
                    batch_size: int = 1) -> dict:
    """Whole-image inference over a test dataset -> mIoU summary.

    ``model`` is the port's FusionEncoderDecoder (in eval mode) or a
    Segmentor. Each batch's prediction is the argmax of the selected
    stream's logits upsampled to the input size, through the fused
    upsample+argmax kernel (``apis.predict_labels``); 19-class histograms,
    and the 18-class summary with the x19/18 rule."""
    if isinstance(model, Segmentor):
        model = model.model
    dev = model_device(model)
    totals = [np.zeros(num_classes, np.float64) for _ in range(4)]
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    for start in range(0, n, batch_size):
        samples = [dataset[i] for i in range(start, min(start + batch_size, n))]
        batch = collate(samples)
        image = torch.from_numpy(batch["image"]).to(dev)
        second = batch.get("events", batch.get("isr"))
        if second is not None:
            second = torch.from_numpy(second).to(dev)
        logits = select_logits(model, image, second, output)
        pred = predict_labels(logits, image.shape[1:3]).cpu().numpy()
        for j, s in enumerate(samples):
            res = intersect_and_union(pred[j], s["label"], num_classes)
            for k in range(4):
                totals[k] += res[k]
    ret = eval_metrics(*totals)
    summary = summarize_miou(ret, valid_classes=18)
    summary["per_class_iou"] = {
        CLASS_NAMES[i]: float(ret["IoU"][i]) for i in range(num_classes)}
    return summary
