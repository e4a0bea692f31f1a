"""CityscapesIC: the labeled day source (image, temporal IC, ISR, label)
(mirrors cmda_tpu.data.cityscapes_ic; reference
mmseg/datasets/cityscapes_ic.py:22-272).

* files: ``leftImg8bit/train/<city>/*.png``; labels
  ``gtFine/train/<city>/*_gtFine_labelTrainIds.png``.
* geometry: every frame resized to ``image_resize_size`` (1024x512; PIL
  bilinear, labels NEAREST), then one ``(x, y, flip)`` draw, a 512x512 crop
  and a horizontal flip shared by every modality.
* ``img_time_res``: a gray PNG resized and cropped as the image, then
  ``(v / 255 - 0.5) / 0.5``; from ``leftImg8bit_IC1`` ('image_change',
  'ic_wo_cyclegan'), the frame itself ('gray_image'), or the simulated
  events PNGs ('events_gan'; 'events_esim', already at crop size).
* ``img_self_res``: the host ISR of the cropped image, its direction
  ``direct[x % 2][flip]`` for shift_type 'random'.

Outputs: ``image``, ``img_time_res``, ``img_self_res`` (HWC float32) and
``label`` (HW int32). ``files`` lists the image paths, which Rare Class
Sampling maps its JSON entries to; ``load(idx, crop_xy, flip, rng)`` lets it
force a crop. The source augmentations (ISR noise, CowMix erase, lens flare,
sky noise) and the 3-channel and high-resolution ISR are not ported
(ROADMAP queue A item 4) and raise.
"""
from __future__ import annotations

import os
import random

import numpy as np
from PIL import Image

from .cache import DecodeCache
from .host_isr import (host_image_change, normalize_image, open_rgb,
                       pick_shift_direction)

IC_MODES = ("image_change", "ic_wo_cyclegan", "gray_image", "events_gan",
            "events_esim")


class CityscapesICDataset:
    def __init__(self, root: str, *, image_resize_size=(1024, 512),
                 image_crop_size=(512, 512), isr_params=None,
                 shift_type: str = "random",
                 outputs=("image", "img_time_res", "img_self_res", "label"),
                 isr_noise: bool = False, isr_cow_mask: bool = False,
                 flare_dir: str | None = None,
                 sky_noise_dir: str | None = None, sky_mask: bool = False,
                 shift_3_channel: bool = False,
                 high_resolution_isr: bool = False,
                 return_gi_or_ic: str = "image_change",
                 decode_cache: int = 0):
        unported = [name for name, on in (
            ("isr_noise", isr_noise), ("isr_cow_mask", isr_cow_mask),
            ("flare_dir", flare_dir is not None),
            ("sky_mask", sky_mask or sky_noise_dir is not None),
            ("shift_3_channel", shift_3_channel),
            ("high_resolution_isr", high_resolution_isr)) if on]
        if unported:
            raise NotImplementedError(
                f"CityscapesICDataset {', '.join(unported)}: the source "
                "augmentations are not ported (ROADMAP queue A item 4)")
        if return_gi_or_ic not in IC_MODES:
            raise ValueError(f"unknown return_gi_or_ic {return_gi_or_ic!r}")
        self.root = root
        self.resize = tuple(image_resize_size)   # (W, H), PIL's order
        self.crop = tuple(image_crop_size)
        self.outputs = set(outputs)
        self.shift_type = shift_type
        self.return_gi_or_ic = return_gi_or_ic
        self._cache = DecodeCache(decode_cache)
        p = isr_params
        self.isr_kw = dict(val_range=p.val_range, threshold=p.threshold,
                           clip_range=p.clip_range, shift_pixel=p.shift_pixel)
        self.files = []
        img_root = os.path.join(root, "leftImg8bit", "train")
        if os.path.isdir(img_root):
            for city in sorted(os.listdir(img_root)):
                cdir = os.path.join(img_root, city)
                for name in sorted(os.listdir(cdir)):
                    self.files.append(os.path.join(cdir, name))

    def __len__(self):
        return len(self.files)

    @staticmethod
    def _ic_path(image_path):
        return (image_path.replace("leftImg8bit", "leftImg8bit_IC1")[:-8]
                + ".png")

    @staticmethod
    def _label_path(image_path):
        return (image_path.replace("leftImg8bit", "gtFine")[:-4]
                + "_labelTrainIds.png")

    def _load_ic(self, path):
        """The resized gray frame behind ``img_time_res``."""
        mode = self.return_gi_or_ic
        if mode == "gray_image":
            src = path
        elif mode in ("events_gan", "events_esim"):
            sub = "leftImg8bit_EventGAN" if mode == "events_gan" else (
                "leftImg8bit_esim")
            src = path.replace("leftImg8bit", sub)[:-13] + ".png"
        else:
            src = self._ic_path(path)
        ic = Image.open(src).convert("L")
        if mode != "events_esim":   # the esim PNGs are at crop size already
            ic = ic.resize(self.resize, resample=Image.BILINEAR)
        return ic

    def load(self, idx: int, crop_xy=None, flip=None,
             rng: random.Random | None = None):
        """Sample ``idx``; ``crop_xy`` and ``flip`` may be forced (Rare
        Class Sampling re-crops, reference uda_dataset.py:89-106). ``rng``
        is the loader worker's ``random.Random`` (the module's ``random``
        when None)."""
        r = rng if rng is not None else random
        path = self.files[idx]
        w_max = self.resize[0] - self.crop[0]
        h_max = self.resize[1] - self.crop[1]
        if crop_xy is None:
            crop_xy = (r.randint(0, w_max), r.randint(0, h_max))
        if flip is None:
            flip = r.random() < 0.5
        x, y = crop_xy
        box = (x, y, x + self.crop[0], y + self.crop[1])
        out = {}

        crop_image = None
        if "image" in self.outputs or "img_self_res" in self.outputs:
            img = self._cache.get(("img", path), lambda: open_rgb(path).resize(
                self.resize, resample=Image.BILINEAR)).crop(box)
            if flip:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            crop_image = img
            if "image" in self.outputs:
                out["image"] = normalize_image(img)

        if "label" in self.outputs:
            lbl = self._cache.get(
                ("lbl", path),
                lambda: Image.open(self._label_path(path)).resize(
                    self.resize, resample=Image.NEAREST)).crop(box)
            if flip:
                lbl = lbl.transpose(Image.FLIP_LEFT_RIGHT)
            out["label"] = np.asarray(lbl).astype(np.int32)

        if "img_time_res" in self.outputs:
            ic = self._cache.get(("ic", self.return_gi_or_ic, path),
                                 lambda: self._load_ic(path)).crop(box)
            if flip:
                ic = ic.transpose(Image.FLIP_LEFT_RIGHT)
            arr = (np.asarray(ic, np.float32) / 255.0 - 0.5) / 0.5
            out["img_time_res"] = np.broadcast_to(arr[..., None],
                                                  arr.shape + (3,))

        if "img_self_res" in self.outputs:
            direction = pick_shift_direction(self.shift_type, x, int(flip))
            isr = host_image_change(crop_image, shift_direction=direction,
                                    **self.isr_kw)
            out["img_self_res"] = np.broadcast_to(
                isr[..., None], isr.shape + (3,)).astype(np.float32,
                                                         copy=False)
        return out

    def __getitem__(self, idx):
        return self.load(idx)
