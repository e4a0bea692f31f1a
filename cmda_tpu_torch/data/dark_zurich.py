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

Outputs: ``image``, ``isr`` (HWC), ``label`` (HW int32). The day pair of
the d2n variant and the deflared outputs are not ported (ROADMAP queue A
item 5).
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
        unported = {"image_deflare", "isr_deflare"} & set(outputs)
        if with_day_pair or unported:
            what = "with_day_pair" if with_day_pair else sorted(unported)
            raise NotImplementedError(
                f"DarkZurichDataset {what} is not ported (ROADMAP queue A "
                "item 5)")
        self.root = root
        self.split = split
        self.resize = tuple(image_resize_size)
        self.crop = tuple(image_crop_size)
        self.outputs = set(outputs)
        self.shift_type = shift_type
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
        if not test_mode:
            x = r.randint(0, self.resize[0] - self.crop[0])
            y = r.randint(0, self.resize[1] - self.crop[1])
            flip = r.random() < 0.5
            box = (x, y, x + self.crop[0], y + self.crop[1])

        if "image" in self.outputs:
            img = img_pil
            if not test_mode:
                img = img.crop(box)
                if flip:
                    img = img.transpose(Image.FLIP_LEFT_RIGHT)
            out["image"] = normalize_image(img)

        if "isr" in self.outputs:
            if self.shift_3_channel:
                isr = np.stack([
                    host_image_change(img_pil, shift_direction="rightdown",
                                      **kw) for kw in self.isr_kw], axis=-1)
            else:
                direction = (pick_shift_direction(self.shift_type, x, y)
                             if not test_mode else
                             pick_shift_direction(self.shift_type, 0, 0))
                isr = host_image_change(img_pil, shift_direction=direction,
                                        **self.isr_kw)
            if not test_mode:
                isr = isr[y: y + self.crop[1], x: x + self.crop[0]]
                if flip:
                    isr = np.ascontiguousarray(isr[:, ::-1])
            out["isr"] = (isr if isr.ndim == 3
                          else np.repeat(isr[..., None], 3, axis=-1))

        if "label" in self.outputs:
            lbl_pil = Image.open(self._label_path(path))
            if lbl_pil.size != self.resize:
                lbl_pil = lbl_pil.resize(self.resize, resample=Image.NEAREST)
            out["label"] = np.asarray(lbl_pil).astype(np.int32)
        return out

    def __getitem__(self, idx):
        return self.load(idx)
