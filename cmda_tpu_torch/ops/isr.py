"""Image Self-Residual (ISR): a fake event frame computed from one image
(mirrors cmda_tpu.ops.isr).

Grayscale, shift by ``shift_pixel`` along a row and a column direction, take
the log-intensity difference with a dead-zone threshold, clip each sign, and
min-max renormalise each sign over the whole frame to [0, 1] / [-1, 0].

These functions are the plain PyTorch version of the batched ISR kernel
(``ops/isr_kernel.py``): the wrapper uses them for CPU tensors, and the
tests and ``chip_smoke.py`` hold the kernel against them.
"""
from __future__ import annotations

import math

import torch

from .normalize import normalize_to_range

# shift_type='random' picks one of these four [row, col] combos
# (row in {left, right}, col in {up, down}); index = direction_idx.
SHIFT_DIRECTIONS = ("leftdown", "leftup", "rightdown", "rightup")


def pil_grayscale(rgb_uint8: torch.Tensor) -> torch.Tensor:
    """PIL ``Image.convert('L')`` on a (..., 3) uint8 RGB tensor, bit-exact:
    ``L = (19595 R + 38470 G + 7471 B + 0x8000) >> 16``. Returns uint8."""
    rgb = rgb_uint8.to(torch.int32)
    l24 = (19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2]
           + 0x8000)
    return (l24 >> 16).to(torch.uint8)


def get_ic(front: torch.Tensor, now: torch.Tensor, val_range,
           threshold: float, clip_range: float) -> torch.Tensor:
    """Log-intensity change between two gray frames (0..255), in [-1, 1].

    The dead-zone threshold and the clip are fractions of
    ``log(hi) - log(lo)``; the positive and negative parts are min-max
    normalised over the whole frame independently, then summed."""
    lo, hi = float(val_range[0]), float(val_range[1])
    a = torch.log(front.float() / 255.0 * (hi - lo) + lo)
    b = torch.log(now.float() / 255.0 * (hi - lo) + lo)
    d = b - a
    log_span = math.log(hi) - math.log(lo)
    thr = log_span * threshold
    clip = log_span * clip_range
    d = torch.where(d.abs() <= thr, torch.zeros_like(d), d)
    pos = d.clamp(min=0.0).clamp(0.0, clip)
    pos = normalize_to_range(pos, 0.0, 1.0)
    neg = d.clamp(max=0.0).clamp(-clip, 0.0)
    neg = normalize_to_range(neg, -1.0, 0.0)
    return pos + neg


def _shift_row(gray: torch.Tensor, shift: int, left: bool) -> torch.Tensor:
    """Shift columns by ``shift`` px; the ``shift`` columns the content left
    behind keep their own values (the reference's concatenation trick)."""
    w = gray.shape[-1]
    if left:
        return torch.cat([gray[..., shift:], gray[..., w - shift:]], dim=-1)
    return torch.cat([gray[..., :shift], gray[..., : w - shift]], dim=-1)


def _shift_col(gray: torch.Tensor, shift: int, up: bool) -> torch.Tensor:
    h = gray.shape[-2]
    if up:
        return torch.cat([gray[..., shift:, :], gray[..., h - shift:, :]],
                         dim=-2)
    return torch.cat([gray[..., :shift, :], gray[..., : h - shift, :]], dim=-2)


def image_change_from_gray(gray: torch.Tensor, *, val_range, threshold: float,
                           clip_range: float, shift_pixel: int = 1,
                           shift_direction: str | None = "rightdown",
                           direction_idx: int | None = None) -> torch.Tensor:
    """ISR from one gray frame (H, W) -> float (H, W) in [-1, 1].

    ``shift_direction='all'`` averages the four directions; otherwise a
    combo of {left,right} x {up,down}. ``direction_idx`` (0..3, an index
    into SHIFT_DIRECTIONS) overrides ``shift_direction``."""
    def ic(now):
        return get_ic(gray, now, val_range, threshold, clip_range)

    if shift_direction == "all" and direction_idx is None:
        return (ic(_shift_col(gray, shift_pixel, True))
                + ic(_shift_row(gray, shift_pixel, True))
                + ic(_shift_col(gray, shift_pixel, False))
                + ic(_shift_row(gray, shift_pixel, False))) / 4.0
    if direction_idx is not None:
        d = int(direction_idx)
        if not 0 <= d < 4:
            raise ValueError(f"direction_idx must be in [0, 4), got {d}")
        left, up = d < 2, d % 2 == 1
    else:
        left, up = "left" in shift_direction, "up" in shift_direction
    row = ic(_shift_row(gray, shift_pixel, left))
    col = ic(_shift_col(gray, shift_pixel, up))
    return row / 2.0 + col / 2.0


def image_to_isr(rgb01: torch.Tensor, *, val_range, threshold: float,
                 clip_range: float, shift_pixel: int = 1,
                 shift_direction: str | None = "rightdown",
                 direction_idx: int | None = None,
                 quantize: bool = True) -> torch.Tensor:
    """Image -> ISR for one [0, 1] RGB frame (H, W, 3) -> (H, W).

    ``quantize=True`` goes through uint8 and PIL-exact grayscale, as the
    reference's PIL round trip does."""
    if quantize:
        rgb_u8 = (rgb01 * 255.0).clamp(0, 255).to(torch.uint8)
        gray = pil_grayscale(rgb_u8).float()
    else:
        gray = (rgb01[..., 0] * 0.299 + rgb01[..., 1] * 0.587
                + rgb01[..., 2] * 0.114) * 255.0
    return image_change_from_gray(
        gray, val_range=val_range, threshold=threshold, clip_range=clip_range,
        shift_pixel=shift_pixel, shift_direction=shift_direction,
        direction_idx=direction_idx)
