"""Synthetic source/target data with the real datasets' interfaces (numpy
copies of cmda_tpu.data.synthetic.SyntheticSource and SyntheticTarget, the
same draws for the same seed, so both packages see identical samples).

``uda_batch`` builds the trainer's ``{'source', 'target'}`` batch with
``data.loader.collate`` (re-exported here)."""
from __future__ import annotations

import numpy as np

from .loader import collate


class SyntheticSource:
    """CityscapesIC stand-in: image / img_time_res / img_self_res / label
    (5% of the labels set to the ignore id 255).

    ``crop_size`` is (w, h), as in the JAX package; ``files`` names each
    sample as a Cityscapes image file, for Rare Class Sampling."""

    def __init__(self, *, crop_size=(512, 512), num_classes: int = 19,
                 length: int = 64, seed: int = 0, with_time_res: bool = True):
        self.h, self.w = crop_size[1], crop_size[0]
        self.num_classes = num_classes
        self.length = length
        self.seed = seed
        self.with_time_res = with_time_res
        self.files = [f"synthetic_{i:06d}_leftImg8bit.png"
                      for i in range(length)]

    def __len__(self):
        return self.length

    def load(self, idx, rng=None):
        g = np.random.default_rng(self.seed * 100003 + idx)
        img = g.normal(size=(self.h, self.w, 3)).astype(np.float32)
        label = g.integers(0, self.num_classes,
                           size=(self.h, self.w)).astype(np.int32)
        label[g.random(size=label.shape) < 0.05] = 255
        out = {
            "image": img,
            "img_self_res": np.clip(
                g.normal(size=(self.h, self.w, 1)), -1, 1
            ).astype(np.float32).repeat(3, axis=-1),
            "label": label,
        }
        if self.with_time_res:
            out["img_time_res"] = np.clip(
                g.normal(size=(self.h, self.w, 1)), -1, 1
            ).astype(np.float32).repeat(3, axis=-1)
        return out

    def __getitem__(self, idx):
        return self.load(idx)


class SyntheticTarget:
    """DSEC/DarkZurich stand-in: image / events / isr (+ label in test).

    ``crop_size`` is (w, h), as in the JAX package."""

    def __init__(self, *, crop_size=(512, 512), length: int = 64,
                 seed: int = 1, with_events: bool = True,
                 test_mode: bool = False, num_classes: int = 19):
        self.h, self.w = crop_size[1], crop_size[0]
        self.length = length
        self.seed = seed
        self.with_events = with_events
        self.test_mode = test_mode
        self.num_classes = num_classes

    def __len__(self):
        return self.length

    def load(self, idx, rng=None):
        g = np.random.default_rng(self.seed * 100003 + idx)
        out = {
            "image": g.normal(size=(self.h, self.w, 3)).astype(np.float32),
            "isr": np.clip(g.normal(size=(self.h, self.w, 1)), -1, 1
                           ).astype(np.float32).repeat(3, axis=-1),
        }
        if self.with_events:
            ev = np.clip(g.normal(size=(self.h, self.w, 1)), -1, 1)
            ev[np.abs(ev) < 0.8] = 0.0
            out["events"] = ev.astype(np.float32).repeat(3, axis=-1)
        if self.test_mode:
            out["label"] = g.integers(0, self.num_classes,
                                      size=(self.h, self.w)).astype(np.int32)
        return out

    def __getitem__(self, idx):
        return self.load(idx)


def uda_batch(source, target, indices) -> dict:
    """The trainer's batch {'source': {image, img_self_res, label,
    img_time_res}, 'target': {image, isr, events}} of the samples at
    ``indices`` of both datasets, as numpy arrays."""
    return {"source": collate([source[i] for i in indices]),
            "target": collate([target[i] for i in indices])}
