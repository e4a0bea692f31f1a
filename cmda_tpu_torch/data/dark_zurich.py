"""DarkZurich: the night target (image + raw ISR) and its labeled val split
(mirrors cmda_tpu.data.dark_zurich; reference
mmseg/datasets/dark_zurich_ic.py:22-467).

* files: ``rgb_anon/{train|val|test}/night/<seq>/*.png``; labels
  ``gt/val/night/<seq>/*_gt_labelTrainIds.png``.
* every frame is resized to ``image_resize_size`` (960x540) PIL-bilinear;
  train takes a random 512x512 crop and flip, val/test the whole frame.
* the ISR is computed on the host from the resized whole frame, then
  cropped, in direction ``direct[x % 2][y % 2]`` for shift_type 'random'
  (the crop's corner; (0, 0) at test time); ``shift_3_channel`` stacks three
  parameter rows rightdown.
* labels are resized NEAREST to the frame size.

* ``outputs`` may add ``image_deflare`` / ``isr_deflare``: the same crop,
  flip and ISR of the flare-removed frame at the same path under
  ``night_deflare`` (every ``night`` in the path so replaced, as the JAX
  dataset does; reference dark_zurich_ic.py:61-62, 181-218).
* ``with_day_pair`` (train only, the d2n variant): a random day frame of
  ``rgb_anon/train/day`` (``day_image``, the night crop's box and flip)
  and, where it exists, its CycleGAN-transferred ISR (``day_isr``): the
  right half, x in [960, 1920), of the side-by-side PNG at the path with
  every ``day`` replaced by ``day_t_isr``, as gray in [-1, 1].

Outputs: ``image``, ``isr`` (HWC), ``label`` (HW int32), and the above.
"""
from __future__ import annotations

import os
import random

import numpy as np

from .host_isr import (host_image_change, normalize_image, open_rgb,
                       pick_shift_direction)


class DarkZurichDataset:
    def __init__(self, root: str, *, split: str = "train",
                 image_resize_size=(960, 540), image_crop_size=(512, 512),
                 isr_params=None, shift_type: str = "rightdown",
                 outputs=("image", "isr"), with_day_pair: bool = False,
                 shift_3_channel: bool = False, auto_threshold: bool = False):
        if auto_threshold:
            # the reference forwards it to get_image_change_from_pil, which
            # raises 'auto_threshold function not implement' (utils.py:124)
            raise NotImplementedError(
                "auto_threshold is unimplemented in the reference "
                "(mmseg/datasets/utils.py:124-125) and is not supported")
        if shift_3_channel and "isr_deflare" in outputs:
            # the reference's deflare + 3-channel path splats the parameter
            # rows (dark_zurich_ic.py:195-200); the JAX dataset asserts
            raise ValueError("isr_deflare takes no shift_3_channel")
        self.root = root
        self.split = split
        self.resize = tuple(image_resize_size)
        self.crop = tuple(image_crop_size)
        self.outputs = set(outputs)
        self.shift_type = shift_type
        self.with_day_pair = with_day_pair
        self.shift_3_channel = shift_3_channel

        def kw(p):
            return dict(val_range=p.val_range, threshold=p.threshold,
                        clip_range=p.clip_range, shift_pixel=p.shift_pixel)

        if shift_3_channel:
            # per-channel parameter rows, fixed rightdown (reference
            # dark_zurich_ic.py:232-240)
            if not (isinstance(isr_params, (list, tuple))
                    and len(isr_params) == 3):
                raise ValueError("shift_3_channel takes three IsrParams")
            self.isr_kw = [kw(p) for p in isr_params]
        else:
            self.isr_kw = kw(isr_params)
        self.files = []
        base = os.path.join(root, "rgb_anon", split, "night")
        if os.path.isdir(base):
            for seq in sorted(os.listdir(base)):
                sdir = os.path.join(base, seq)
                for name in sorted(os.listdir(sdir)):
                    self.files.append(os.path.join(sdir, name))
        self.day_files = []
        day_base = os.path.join(root, "rgb_anon", "train", "day")
        if with_day_pair and os.path.isdir(day_base):
            for seq in sorted(os.listdir(day_base)):
                sdir = os.path.join(day_base, seq)
                for name in sorted(os.listdir(sdir)):
                    self.day_files.append(os.path.join(sdir, name))

    def __len__(self):
        return len(self.files)

    def _label_path(self, image_path):
        return image_path.replace("rgb_anon", "gt").replace(
            "_gt", "_gt_labelTrainIds")

    def load(self, idx: int, rng: random.Random | None = None):
        """Sample ``idx``; ``rng`` draws the train crop and flip (the
        module's ``random`` when None)."""
        from PIL import Image
        r = rng if rng is not None else random
        path = self.files[idx]
        test_mode = self.split != "train"
        out = {}
        img_pil = open_rgb(path).resize(self.resize, resample=Image.BILINEAR)
        x = y = 0
        box = flip = None
        if not test_mode:
            x = r.randint(0, self.resize[0] - self.crop[0])
            y = r.randint(0, self.resize[1] - self.crop[1])
            flip = r.random() < 0.5
            box = (x, y, x + self.crop[0], y + self.crop[1])

        def crop_image(pil):
            if box is not None:
                pil = pil.crop(box)
                if flip:
                    pil = pil.transpose(Image.FLIP_LEFT_RIGHT)
            return pil

        def isr_of(pil):
            """The resized frame's ISR, cropped and flipped: [h, w]."""
            isr = host_image_change(
                pil, shift_direction=pick_shift_direction(self.shift_type,
                                                          x, y),
                **self.isr_kw)
            return crop_map(isr)

        def crop_map(a):
            if box is not None:
                a = a[y: y + self.crop[1], x: x + self.crop[0]]
                if flip:
                    a = np.ascontiguousarray(a[:, ::-1])
            return a

        if "image" in self.outputs:
            out["image"] = normalize_image(crop_image(img_pil))

        if "isr" in self.outputs:
            if self.shift_3_channel:
                isr = crop_map(np.stack([
                    host_image_change(img_pil, shift_direction="rightdown",
                                      **kw) for kw in self.isr_kw], axis=-1))
            else:
                isr = isr_of(img_pil)
            out["isr"] = (isr if isr.ndim == 3
                          else np.repeat(isr[..., None], 3, axis=-1))

        if "label" in self.outputs:
            lbl_pil = Image.open(self._label_path(path))
            if lbl_pil.size != self.resize:
                lbl_pil = lbl_pil.resize(self.resize, resample=Image.NEAREST)
            out["label"] = np.asarray(lbl_pil).astype(np.int32)

        if "image_deflare" in self.outputs or "isr_deflare" in self.outputs:
            df_pil = open_rgb(path.replace("night", "night_deflare")).resize(
                self.resize, resample=Image.BILINEAR)
            if "image_deflare" in self.outputs:
                out["image_deflare"] = normalize_image(crop_image(df_pil))
            if "isr_deflare" in self.outputs:
                out["isr_deflare"] = np.repeat(isr_of(df_pil)[..., None], 3,
                                               axis=-1)

        if self.with_day_pair and self.day_files and not test_mode:
            didx = r.randint(0, len(self.day_files) - 1)
            day_pil = open_rgb(self.day_files[didx]).resize(
                self.resize, resample=Image.BILINEAR)
            out["day_image"] = normalize_image(crop_image(day_pil))
            t_isr_path = self.day_files[didx].replace("day", "day_t_isr")
            if os.path.exists(t_isr_path):
                t_isr = crop_image(Image.open(t_isr_path).convert("L").crop(
                    (960, 0, 1920, 540)))
                arr = (np.asarray(t_isr, np.float32) / 255.0 - 0.5) / 0.5
                out["day_isr"] = np.repeat(arr[..., None], 3, axis=-1)
        return out

    def __getitem__(self, idx):
        return self.load(idx)
