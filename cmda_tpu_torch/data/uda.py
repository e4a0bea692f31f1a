"""Source/target pairing with Rare Class Sampling (mirrors
cmda_tpu.data.uda; reference mmseg/datasets/uda_dataset.py:12-143).

* ``rcs_class_probs``: P(c) = softmax((1 - freq_c) / T) over the classes
  with a pixel count > 0 (T = 0.01 in the reference).
* ``UDAPairDataset``: one source and one target sample per index, every
  random choice from the caller's ``random.Random`` (the loader worker's).
  With RCS: a class c ~ P, a source file holding at least ``min_pixels``
  of c (``samples_with_class.json``), and the crop redrawn up to 10 times
  until ``min_pixels * min_crop_ratio`` pixels of c survive.
"""
from __future__ import annotations

import json
import os
import random

import numpy as np


def rcs_class_probs(sample_class_stats: dict | str, temperature: float = 0.01,
                    num_classes: int = 19):
    """``sample_class_stats_dict.json`` (path or dict) -> (classes, probs)."""
    if isinstance(sample_class_stats, str):
        with open(sample_class_stats) as f:
            sample_class_stats = json.load(f)
    overall = np.zeros(num_classes, np.float64)
    for stats in sample_class_stats.values():
        for c, n in stats.items():
            c = int(c)
            if c < num_classes:
                overall[c] += n
    present = overall > 0
    freq = overall / overall.sum()
    logits = (1.0 - freq) / temperature
    logits[~present] = -np.inf
    e = np.exp(logits - logits[present].max())
    e[~present] = 0.0
    probs = e / e.sum()
    return np.nonzero(present)[0], probs[present]


class UDAPairDataset:
    """Pairs a source and a target dataset; optional Rare Class Sampling
    (the source must then list its image files as ``source.files``)."""

    def __init__(self, source, target, *, rcs: bool = False,
                 samples_with_class: dict | str | None = None,
                 sample_class_stats: dict | str | None = None,
                 class_temp: float = 0.01, min_pixels: int = 3000,
                 min_crop_ratio: float = 0.5, seed: int | None = None):
        self.source = source
        self.target = target
        self.rcs = rcs and samples_with_class is not None
        self.min_pixels = min_pixels
        self.min_crop_ratio = min_crop_ratio
        self.rng = random.Random(seed)
        if self.rcs:
            if isinstance(samples_with_class, str):
                with open(samples_with_class) as f:
                    samples_with_class = json.load(f)
            self.samples_with_class = {
                int(c): [(os.path.basename(fn), n) for fn, n in entries
                         if n >= min_pixels]
                for c, entries in samples_with_class.items()}
            self.rcs_classes, self.rcs_probs = rcs_class_probs(
                sample_class_stats, class_temp)
            self.file_to_idx = {
                os.path.basename(f): i for i, f in enumerate(source.files)}

    def __len__(self):
        return max(len(self.source), 1)

    def _rcs_source_sample(self, rng: random.Random):
        c = int(rng.choices(list(self.rcs_classes),
                            weights=list(self.rcs_probs))[0])
        candidates = self.samples_with_class.get(c, [])
        if not candidates:
            return self.source.load(rng.randrange(len(self.source)), rng=rng)
        fname, _ = rng.choice(candidates)
        # label file names map back to image file names
        key = fname.replace("_gtFine_labelTrainIds.png", "_leftImg8bit.png")
        idx = self.file_to_idx.get(key)
        if idx is None:
            idx = rng.randrange(len(self.source))
        for _ in range(10):
            sample = self.source.load(idx, rng=rng)
            if np.sum(sample["label"] == c) >= (self.min_pixels
                                                * self.min_crop_ratio):
                break
        return sample

    def load(self, idx, rng: random.Random | None = None):
        """The pair at ``idx``; ``rng`` is the loader worker's
        ``random.Random`` (default: the dataset's own, for single-threaded
        use)."""
        r = rng if rng is not None else self.rng
        if self.rcs:
            src = self._rcs_source_sample(r)
        else:
            src = self.source.load(idx % len(self.source), rng=r)
        tgt = self.target.load(r.randrange(max(len(self.target), 1)), rng=r)
        return {"source": src, "target": tgt}

    def __getitem__(self, idx):
        return self.load(idx)
