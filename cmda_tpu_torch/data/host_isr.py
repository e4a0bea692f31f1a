"""Host-side (numpy/PIL) image helpers and ISR (mirrors
cmda_tpu.data.host_isr): the DarkZurich loader's ISR of the resized frame,
computed on the host as in the JAX package (reference
mmseg/datasets/utils.py:87-152: PIL 'L' grayscale, border-replicating
shifts). The ISR of the serving and training paths runs on the device
(``ops/isr_kernel.py``)."""
from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.asarray([58.395, 57.12, 57.375], np.float32)


def _norm_range(x, lo, hi):
    xmin, xmax = x.min(), x.max()
    return (x - xmin) / (xmax - xmin + 1e-8) * (hi - lo) + lo


def host_get_ic(front, now, val_range, threshold, clip_range):
    """Log-intensity change between two gray frames (0..255), in [-1, 1]:
    dead zone and clip as fractions of ``log(hi) - log(lo)``, each sign
    min-max normalised over the frame."""
    lo, hi = float(val_range[0]), float(val_range[1])
    a = np.log(front.astype(np.float32) / 255.0 * (hi - lo) + lo)
    b = np.log(now.astype(np.float32) / 255.0 * (hi - lo) + lo)
    d = b - a
    span = np.log(hi) - np.log(lo)
    thr, clip = span * threshold, span * clip_range
    d[np.abs(d) <= thr] = 0.0
    pos = np.clip(np.maximum(d, 0.0), 0.0, clip)
    pos = _norm_range(pos, 0.0, 1.0)
    neg = np.clip(np.minimum(d, 0.0), -clip, 0.0)
    neg = _norm_range(neg, -1.0, 0.0)
    return pos + neg


def _shift(gray, s, direction):
    """``gray`` shifted by ``s`` px; the ``s`` rows or columns left behind
    keep their own values (the reference's concatenation)."""
    h, w = gray.shape
    if direction == "right":
        return np.concatenate([gray[:, :s], gray[:, : w - s]], axis=1)
    if direction == "left":
        return np.concatenate([gray[:, s:], gray[:, w - s:]], axis=1)
    if direction == "down":
        return np.concatenate([gray[:s, :], gray[: h - s, :]], axis=0)
    if direction != "up":
        raise ValueError(f"unknown shift direction {direction!r}")
    return np.concatenate([gray[s:, :], gray[h - s:, :]], axis=0)


def host_image_change_numpy(gray, *, val_range, threshold, clip_range,
                            shift_pixel=1, shift_direction="rightdown"):
    """ISR of an [H, W] float32 grayscale array: the mean of the row and
    the column shift's change ('all': of the four one-sided shifts')."""
    def ic(now):
        return host_get_ic(gray, now, val_range, threshold, clip_range)

    s = shift_pixel
    if shift_direction == "all":
        return (ic(_shift(gray, s, "up")) + ic(_shift(gray, s, "left"))
                + ic(_shift(gray, s, "down"))
                + ic(_shift(gray, s, "right"))) / 4.0
    row = "left" if "left" in shift_direction else "right"
    col = "up" if "up" in shift_direction else "down"
    return ic(_shift(gray, s, row)) / 2.0 + ic(_shift(gray, s, col)) / 2.0


def host_image_change(pil_image, *, val_range, threshold, clip_range,
                      shift_pixel=1, shift_direction="rightdown"):
    """PIL image -> ISR float32 [H, W] in [-1, 1], on PIL's 'L' grayscale."""
    gray = np.array(pil_image.convert("L"), dtype=np.float32)
    return host_image_change_numpy(
        gray, val_range=val_range, threshold=threshold, clip_range=clip_range,
        shift_pixel=shift_pixel, shift_direction=shift_direction)


def pick_shift_direction(shift_type: str, a: int, b: int) -> str:
    """The reference's deterministic-from-crop 'random' direction:
    ``direct[a % 2][b % 2]``."""
    if shift_type != "random":
        return shift_type
    direct = [["leftdown", "leftup"], ["rightdown", "rightup"]]
    return direct[a % 2][b % 2]


def normalize_image(pil_image) -> np.ndarray:
    """RGB PIL -> ImageNet-normalised float32 HWC."""
    arr = np.asarray(pil_image, dtype=np.float32)
    arr -= IMAGENET_MEAN
    arr /= IMAGENET_STD
    return arr


def open_rgb(path: str):
    """Open an image file as an RGB PIL Image."""
    from PIL import Image
    with Image.open(path) as im:
        return im.convert("RGB")
