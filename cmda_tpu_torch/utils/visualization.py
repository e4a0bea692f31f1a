"""Cityscapes palette, label colorization and PIL panels (mirrors
cmda_tpu.utils.visualization): the image|second|pred|GT panels of
evaluation (reference base.py:745-837) and the cells of the DACS
``class_mix_debug`` grids (reference dacs.py:882-1097)."""
from __future__ import annotations

import os

import numpy as np
from PIL import Image

from ..data.host_isr import IMAGENET_MEAN, IMAGENET_STD

CITYSCAPES_PALETTE = np.asarray([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100],
    [0, 80, 100], [0, 0, 230], [119, 11, 32]], dtype=np.uint8)


def colorize_label(label: np.ndarray, palette=CITYSCAPES_PALETTE) -> np.ndarray:
    """int label [H, W] -> uint8 [H, W, 3]; the ignore id renders black."""
    out = np.zeros(label.shape + (3,), np.uint8)
    valid = label < len(palette)
    out[valid] = palette[label[valid]]
    return out


def denorm_to_uint8(img: np.ndarray) -> np.ndarray:
    """Normalized float [H, W, 3] -> uint8 RGB."""
    x = img * IMAGENET_STD + IMAGENET_MEAN
    return np.clip(x, 0, 255).astype(np.uint8)


def signed_to_uint8(x: np.ndarray) -> np.ndarray:
    """Values in [-1, 1] (events, ISR) -> uint8; [H, W] becomes gray RGB."""
    u = np.clip((x + 1.0) * 127.5, 0, 255).astype(np.uint8)
    if u.ndim == 2:
        u = np.repeat(u[..., None], 3, -1)
    return u


def hstack_panel(images: list[np.ndarray]) -> np.ndarray:
    """Cells side by side, the shorter ones padded with black below."""
    h = max(im.shape[0] for im in images)
    padded = []
    for im in images:
        if im.shape[0] < h:
            pad = np.zeros((h - im.shape[0],) + im.shape[1:], im.dtype)
            im = np.concatenate([im, pad], axis=0)
        padded.append(im)
    return np.concatenate(padded, axis=1)


def grid_panel(rows: list[list[np.ndarray]]) -> np.ndarray:
    return np.concatenate([hstack_panel(r) for r in rows], axis=0)


def show_result(image, pred, gt=None, events=None, out_path=None,
                opacity: float | None = None):
    """The image|second|pred|GT panel (uint8 [H, W', 3]), written to
    ``out_path`` when given. With ``opacity`` the pred cell is the
    reference's overlay ``img * (1 - opacity) + colors * opacity``
    (base.py:241-248) instead of the bare colour map."""
    cells = [denorm_to_uint8(image)]
    if events is not None:
        cells.append(signed_to_uint8(events[..., 0] if events.ndim == 3
                                     else events))
    if opacity is not None:
        if not 0 < opacity <= 1.0:
            raise ValueError(f"opacity must be in (0, 1], got {opacity}")
        blend = (cells[0].astype(np.float32) * (1 - opacity)
                 + colorize_label(pred).astype(np.float32) * opacity)
        cells.append(blend.astype(np.uint8))
    else:
        cells.append(colorize_label(pred))
    if gt is not None:
        cells.append(colorize_label(gt))
    panel = hstack_panel(cells)
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        Image.fromarray(panel).save(out_path)
    return panel
