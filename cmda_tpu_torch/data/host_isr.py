"""Host-side image helpers of the serving path (subset of
cmda_tpu.data.host_isr; the ISR itself runs on the device in this package,
``ops/isr_kernel.py``)."""
from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.asarray([58.395, 57.12, 57.375], np.float32)


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
