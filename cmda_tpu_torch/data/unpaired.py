"""Unpaired two-folder dataset for CycleGAN training (the port's own copy
of cmda_tpu.data.unpaired, bitwise equal to it).

The crop folders of ``tools/create_cityscapes_image_change.py --mode
crops`` go through the junyanz repo's unaligned pipeline: per domain,
load -> PIL-bilinear resize to ``load_size`` -> random ``crop_size`` crop ->
random horizontal flip -> scale to [-1, 1].  Domain-B index is drawn
independently of A (unaligned mode), from the worker's private rng.
"""
from __future__ import annotations

import os
import random

import numpy as np
from PIL import Image

_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def _list_images(root: str):
    files = sorted(
        os.path.join(root, f) for f in os.listdir(root)
        if f.lower().endswith(_EXTS))
    if not files:
        raise FileNotFoundError(f"no images under {root}")
    return files


class UnpairedFolderDataset:
    def __init__(self, root_a: str, root_b: str, *, load_size=(286, 286),
                 crop_size=(256, 256), grayscale: bool = True,
                 flip: bool = True):
        self.files_a = _list_images(root_a)
        self.files_b = _list_images(root_b)
        self.load_size = load_size    # (W, H), PIL convention
        self.crop_size = crop_size
        self.grayscale = grayscale
        self.flip = flip

    def __len__(self):
        return len(self.files_a)

    def _one(self, path: str, rng):
        img = Image.open(path)
        img = img.convert("L" if self.grayscale else "RGB")
        img = img.resize(self.load_size, resample=Image.BILINEAR)
        cw, ch = self.crop_size
        x = rng.randint(0, self.load_size[0] - cw)
        y = rng.randint(0, self.load_size[1] - ch)
        img = img.crop((x, y, x + cw, y + ch))
        if self.flip and rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        arr = np.asarray(img, np.float32) / 255.0
        arr = (arr - 0.5) / 0.5
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr

    def load(self, idx: int, rng):
        a = self._one(self.files_a[idx % len(self.files_a)], rng)
        b = self._one(self.files_b[rng.randrange(len(self.files_b))], rng)
        return {"a": a, "b": b}

    def __getitem__(self, idx):
        return self.load(idx, random.Random(idx))
