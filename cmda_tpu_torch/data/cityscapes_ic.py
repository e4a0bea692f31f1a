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

The source options (reference cityscapes_ic.py:38-45, 99-116, 212-336;
``data/source_augs.py``), drawn from the worker's ``rng`` in the JAX
package's order:
* ``flare_dir``: a lens-flare PNG added onto the image crop (so the ISR is
  that of the flared crop);
* ``shift_3_channel``: the ISR of each of three parameter sets
  (``isr_params`` a triple), rightdown, as the three channels;
* ``high_resolution_isr``: the ISR of the raw frame at twice the shift,
  rightdown, then a nearest subsample to the resize and the crop (and
  flip); not with ``shift_3_channel``;
* ``sky_mask`` (implied by ``sky_noise_dir``): the one-channel ISR erased
  under the sky and noise spliced around it, from the label, read even
  when ``label`` is not an output;
* ``isr_noise``: blur, dropout and speckle, channel by channel;
* ``isr_cow_mask``: the ISR times one CowMix mask.

Outputs: ``image``, ``img_time_res``, ``img_self_res`` (HWC float32) and
``label`` (HW int32). ``files`` lists the image paths, which Rare Class
Sampling maps its JSON entries to; ``load(idx, crop_xy, flip, rng)`` lets it
force a crop.
"""
from __future__ import annotations

import os
import random

import numpy as np
from PIL import Image

from .cache import DecodeCache
from .host_isr import (host_image_change, normalize_image, open_rgb,
                       pick_shift_direction)
from .source_augs import (cow_mask_np, flare_transform_np, isr_noise_np,
                          sky_mask_transform_np)

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
        if shift_3_channel and high_resolution_isr:
            raise ValueError("shift_3_channel and high_resolution_isr "
                             "exclude each other")
        if return_gi_or_ic not in IC_MODES:
            raise ValueError(f"unknown return_gi_or_ic {return_gi_or_ic!r}")
        self.root = root
        self.resize = tuple(image_resize_size)   # (W, H), PIL's order
        self.crop = tuple(image_crop_size)
        self.outputs = set(outputs)
        self.shift_type = shift_type
        self.return_gi_or_ic = return_gi_or_ic
        self._cache = DecodeCache(decode_cache)
        self.isr_noise = isr_noise
        self.isr_cow_mask = isr_cow_mask
        self.flare_dir = flare_dir
        self.sky_noise_dir = sky_noise_dir
        self.sky_mask = sky_mask or sky_noise_dir is not None
        self.shift_3_channel = shift_3_channel
        self.high_resolution_isr = high_resolution_isr

        def kw(p):
            return dict(val_range=p.val_range, threshold=p.threshold,
                        clip_range=p.clip_range, shift_pixel=p.shift_pixel)
        if shift_3_channel:
            if not (isinstance(isr_params, (list, tuple))
                    and len(isr_params) == 3):
                raise ValueError("shift_3_channel takes three isr_params, "
                                 f"got {isr_params!r}")
            self.isr_kw = [kw(p) for p in isr_params]
        else:
            self.isr_kw = kw(isr_params)
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
            if self.flare_dir is not None:
                img = flare_transform_np(img, self.flare_dir, r)
            crop_image = img
            if "image" in self.outputs:
                out["image"] = normalize_image(img)

        label = None
        if "label" in self.outputs or self.sky_mask:
            lbl = self._cache.get(
                ("lbl", path),
                lambda: Image.open(self._label_path(path)).resize(
                    self.resize, resample=Image.NEAREST)).crop(box)
            if flip:
                lbl = lbl.transpose(Image.FLIP_LEFT_RIGHT)
            label = np.asarray(lbl).astype(np.int32)
            if "label" in self.outputs:
                out["label"] = label

        if "img_time_res" in self.outputs:
            ic = self._cache.get(("ic", self.return_gi_or_ic, path),
                                 lambda: self._load_ic(path)).crop(box)
            if flip:
                ic = ic.transpose(Image.FLIP_LEFT_RIGHT)
            arr = (np.asarray(ic, np.float32) / 255.0 - 0.5) / 0.5
            out["img_time_res"] = np.broadcast_to(arr[..., None],
                                                  arr.shape + (3,))

        if "img_self_res" in self.outputs:
            out["img_self_res"] = self._isr(path, crop_image, x, y, flip,
                                            label, r)
        return out

    def _isr(self, path, crop_image, x, y, flip, label, r):
        """``img_self_res`` [H, W, 3] float32 of the crop at (x, y) with its
        options applied (the module docstring's order)."""
        if self.high_resolution_isr:
            raw = self._cache.get(("raw", path), lambda: open_rgb(path))
            kw = dict(self.isr_kw, shift_pixel=2 * self.isr_kw["shift_pixel"])
            full = host_image_change(raw, shift_direction="rightdown", **kw)
            ys = np.arange(self.resize[1]) * full.shape[0] // self.resize[1]
            xs = np.arange(self.resize[0]) * full.shape[1] // self.resize[0]
            isr = full[np.ix_(ys, xs)][y: y + self.crop[1],
                                       x: x + self.crop[0]]
            if flip:
                isr = np.ascontiguousarray(isr[:, ::-1])
        elif self.shift_3_channel:
            isr = np.stack([host_image_change(
                crop_image, shift_direction="rightdown", **kw)
                for kw in self.isr_kw], axis=-1)
        else:
            direction = pick_shift_direction(self.shift_type, x, int(flip))
            isr = host_image_change(crop_image, shift_direction=direction,
                                    **self.isr_kw)
        if self.sky_mask and isr.ndim == 2:
            isr = sky_mask_transform_np(isr, label, r,
                                        noise_dir=self.sky_noise_dir)
        if self.isr_noise:
            isr = (isr_noise_np(isr, r) if isr.ndim == 2 else np.stack(
                [isr_noise_np(isr[..., i], r) for i in range(isr.shape[-1])],
                axis=-1))
        if self.isr_cow_mask:
            mask = cow_mask_np(isr.shape[:2], r)
            isr = isr * (mask if isr.ndim == 2 else mask[..., None])
        if isr.ndim == 2:
            isr = np.broadcast_to(isr[..., None], isr.shape + (3,))
        return isr.astype(np.float32, copy=False)

    def __getitem__(self, idx):
        return self.load(idx)
