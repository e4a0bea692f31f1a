"""Host-side (numpy/PIL) source-domain ISR and image augmentations (mirrors
cmda_tpu.data.source_augs; reference mmseg/datasets/cityscapes_ic.py:243-336
and mmseg/models/utils/dacs_transforms.py:134-171). They run in the loader
threads:

* ``isr_noise_np``: with p=0.5 a 2x average-pool + bilinear-up blur, then
  pixel dropout and Gaussian speckle of the ISR (cityscapes_ic.py:243-261);
* ``cow_mask_np``: the CowMix smooth-noise threshold mask with the
  source-ISR parameters, proportion 0.7 and sigma in [16, 17]
  (cityscapes_ic.py:263-266);
* ``flare_transform_np``: a random lens-flare PNG, affine-jittered,
  brightness-jittered and blurred, added onto the crop image
  (cityscapes_ic.py:274-301);
* ``sky_mask_transform_np``: the ISR erased under the sky class and
  chunk-shuffled noise spliced in around the sky boundary
  (cityscapes_ic.py:303-336, dacs_transforms.py:134-171).

Each takes the worker's ``random.Random`` and derives its numpy Generator
from it (``_np_gen``), so a seed gives the same bits as in the JAX package.
"""
from __future__ import annotations

import math
import os
import random

import numpy as np
from PIL import Image, ImageFilter

from .dsec import bilinear_resize


def _np_gen(rng: random.Random) -> np.random.Generator:
    return np.random.default_rng(rng.getrandbits(63))


def _bilinear_up(arr: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """align_corners=False bilinear upsample of a 2-D float array."""
    return bilinear_resize(arr, out_hw)


def isr_noise_np(isr: np.ndarray, rng: random.Random) -> np.ndarray:
    """Degrade a single-channel ISR (H, W) in [-1, 1]: with p=0.5 a 2x
    average-pool + bilinear-up blur; pixel dropout where |N(0,1)| <
    U(1, 1.5); speckle N(0,1) * U(0.1, 0.3) where |N(0,1)| < U(0.4, 0.6);
    clipped to [-1, 1]."""
    g = _np_gen(rng)
    h, w = isr.shape
    out = isr.astype(np.float32)
    if rng.random() < 0.5:  # blur
        hh, ww = h - h % 2, w - w % 2
        small = out[:hh, :ww].reshape(hh // 2, 2, ww // 2, 2).mean((1, 3))
        out = _bilinear_up(small, (h, w))
    dis_thr = rng.uniform(1.0, 1.5)
    out = out * (np.abs(g.standard_normal(out.shape)) < dis_thr)
    rnd_thr = rng.uniform(0.4, 0.6)
    intensity = rng.uniform(0.1, 0.3)
    mask = np.abs(g.standard_normal(out.shape)) < rnd_thr
    out = out + g.standard_normal(out.shape).astype(np.float32) * intensity * mask
    return np.clip(out, -1.0, 1.0).astype(np.float32)


def cow_mask_np(shape_hw: tuple[int, int], rng: random.Random, *,
                prop_range=(0.7, 0.7),
                log_sigma_range=(math.log(16), math.log(17)),
                max_sigma: int = 17) -> np.ndarray:
    """Smooth-noise threshold mask (H, W), float {0, 1} (reference
    mmseg/datasets/utils.py:171-200 with the source-ISR parameters): a
    reflect-padded separable Gaussian of N(0,1) noise, thresholded at its
    mean + sqrt(2) erfinv(2p - 1) std."""
    g = _np_gen(rng)
    h, w = shape_hw
    p = rng.uniform(*prop_range)
    threshold_factor = math.sqrt(2.0) * _erfinv(2 * p - 1)
    sigma = math.exp(rng.uniform(*log_sigma_range))
    noise = g.standard_normal((h, w)).astype(np.float32)

    size = round(max_sigma * 3) * 2 + 1
    xs = np.arange(-size, size + 1, dtype=np.float32)
    kern = np.exp(-0.5 * xs ** 2 / sigma ** 2) / (sigma * math.sqrt(2 * math.pi))

    def conv1d(a, axis):
        pad = len(kern) // 2
        a = np.pad(a, [(pad, pad) if ax == axis else (0, 0)
                       for ax in range(2)], mode="reflect")
        return np.apply_along_axis(
            lambda v: np.convolve(v, kern, mode="valid"), axis, a)

    smooth = conv1d(conv1d(noise, 0), 1)
    thr = threshold_factor * smooth.std(ddof=1) + smooth.mean()
    return (smooth <= thr).astype(np.float32)


def _erfinv(x: float) -> float:
    """Inverse error function of a scalar: Winitzki's approximation and two
    Newton steps on erf(y) - x."""
    a = 0.147
    ln1mx2 = math.log(max(1 - x * x, 1e-12))
    t1 = 2 / (math.pi * a) + ln1mx2 / 2
    y = math.copysign(math.sqrt(math.sqrt(t1 * t1 - ln1mx2 / a) - t1), x)
    for _ in range(2):
        err = math.erf(y) - x
        y -= err * math.sqrt(math.pi) / 2 * math.exp(y * y)
    return y


def flare_transform_np(crop_image: Image.Image, flare_dir: str,
                       rng: random.Random) -> Image.Image:
    """A random flare PNG of ``flare_dir`` added onto the crop and clipped:
    the flare normalized per channel, a PIL affine (rotation U(0, 360),
    scale U(0.2, 0.4), translation U(+-256/1440) x W and U(+-128/1440) x H,
    shear U(+-20)), brightness x U(0.8, 3), Gaussian blur of radius
    U(0.1, 3), offset U(+-0.02), resized to the crop when their sizes
    differ. An empty directory leaves the crop as it is."""
    names = sorted(os.listdir(flare_dir))
    if not names:
        return crop_image
    flare = Image.open(os.path.join(flare_dir,
                                    names[rng.randrange(len(names))]))
    flare = flare.convert("RGB")
    f = np.asarray(flare, np.float32) / 255.0
    rgb_max = f.max((0, 1))
    rgb_min = f.min((0, 1))
    f = (f - rgb_min) * rgb_max / (rgb_max - rgb_min + 1e-7)

    pil_f = Image.fromarray(np.uint8(np.clip(f * 255, 0, 255)))
    w, h = pil_f.size
    angle = rng.uniform(0, 360)
    scale = rng.uniform(0.2, 0.4)
    tx = rng.uniform(-256 / 1440, 256 / 1440) * w
    ty = rng.uniform(-128 / 1440, 128 / 1440) * h
    shear = rng.uniform(-20, 20)
    pil_f = pil_f.rotate(angle, resample=Image.BILINEAR, center=(w / 2, h / 2))
    sw, sh = max(int(w * scale), 1), max(int(h * scale), 1)
    scaled = pil_f.resize((sw, sh), Image.BILINEAR)
    canvas = Image.new("RGB", (w, h))
    canvas.paste(scaled, (int((w - sw) / 2 + tx), int((h - sh) / 2 + ty)))
    shear_rad = math.radians(shear)
    canvas = canvas.transform((w, h), Image.AFFINE,
                              (1, math.tan(shear_rad), 0, 0, 1, 0),
                              resample=Image.BILINEAR)
    f = np.asarray(canvas, np.float32) / 255.0

    f = f * rng.uniform(0.8, 3.0)  # brightness jitter (hue 0)
    sigma = rng.uniform(0.1, 3.0)
    pil_blur = Image.fromarray(np.uint8(np.clip(f * 255, 0, 255))).filter(
        ImageFilter.GaussianBlur(radius=sigma))
    f = np.asarray(pil_blur, np.float32) / 255.0
    f = np.clip(f + rng.uniform(-0.02, 0.02), 0.0, 1.0)

    if pil_f.size != crop_image.size:
        f = np.asarray(Image.fromarray(np.uint8(f * 255)).resize(
            crop_image.size, Image.BILINEAR), np.float32) / 255.0
    img = np.asarray(crop_image, np.float32) / 255.0
    merged = np.clip(img + f, 0.0, 1.0)
    return Image.fromarray(np.uint8(merged * 255))


def sky_mask_transform_np(isr: np.ndarray, label: np.ndarray,
                          rng: random.Random, *,
                          noise_dir: str | None = None,
                          enforce_sky_zero: bool = True,
                          sky_id: int = 10,
                          chunk_size: int = 8) -> np.ndarray:
    """Erase the ISR (H, W) under the sky and splice in noise near its
    boundary: window k in U{21..60} made odd, lambda U(0.1, 0.3), intensity
    U(0.5, 1.2); expansion = the k x k max of the sky mask, weight = its
    k x k mean outside the sky, min-max normalized; out = isr * (1 -
    clip(weight + lambda (weight > 0))) + noise * expansion * intensity,
    clipped. The noise is a random PNG of ``noise_dir`` (v / 128 - 1,
    resized to the ISR when its size differs) or, without one, clipped
    N(0,1), then shuffled in 8-pixel chunks along both axes. Fewer than 10
    sky pixels leave the ISR as it is."""
    g = _np_gen(rng)
    k = rng.randint(21, 60)
    if k % 2 == 0:
        k += 1
    lam = rng.uniform(0.1, 0.3)
    intensity = rng.uniform(0.5, 1.2)
    sky = (label == sky_id).astype(np.float32)
    if sky.sum() < 10:
        return isr
    out = isr.astype(np.float32)
    if enforce_sky_zero:
        out = out * (1.0 - sky)

    def slide(a, reducer):
        """Separable k x k zero-padded window ``reducer``."""
        pad = k // 2
        for axis in (0, 1):
            p = [(pad, pad) if ax == axis else (0, 0) for ax in range(2)]
            padded = np.pad(a, p, mode="constant")
            win = np.lib.stride_tricks.sliding_window_view(padded, k,
                                                           axis=axis)
            a = reducer(win, -1)
        return a

    expansion = slide(sky, np.max)
    weight = slide(sky, np.mean)
    weight = weight * (sky == 0)
    wmin, wmax = weight.min(), weight.max()
    weight = (weight - wmin) / (wmax - wmin + 1e-12)
    blur_w = 1.0 - np.clip(weight + lam * (weight != 0), 0.0, 1.0)

    h, w = isr.shape
    if noise_dir and os.path.isdir(noise_dir) and os.listdir(noise_dir):
        names = sorted(os.listdir(noise_dir))
        noise = np.asarray(Image.open(
            os.path.join(noise_dir, names[rng.randrange(len(names))])),
            np.float32) / 128.0 - 1.0
        if noise.ndim == 3:
            noise = noise[..., 0]
        if noise.shape != (h, w):
            noise = np.asarray(Image.fromarray(
                np.uint8(np.clip((noise + 1) * 127.5, 0, 255))).resize(
                    (w, h), Image.BILINEAR), np.float32) / 127.5 - 1.0
    else:
        noise = np.clip(g.standard_normal((h, w)).astype(np.float32), -1, 1)
    for axis in range(2):
        n_chunks = noise.shape[axis] // chunk_size + (
            1 if noise.shape[axis] % chunk_size else 0)
        chunks = np.array_split(noise, n_chunks, axis=axis)
        order = list(range(len(chunks)))
        rng.shuffle(order)
        noise = np.concatenate([chunks[i] for i in order], axis=axis)

    out = out * blur_w + noise * expansion * intensity
    return np.clip(out, -1.0, 1.0).astype(np.float32)
