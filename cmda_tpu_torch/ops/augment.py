"""DACS strong transform + ClassMix on the device (mirrors the part of
cmda_tpu.ops.augment that the flagship preset runs).

Every op takes its random values as tensors, drawn by the caller (the
trainer's ``torch.Generator``, or a test that hands both packages the same
numbers):

* ClassMix: ``sample_class_half`` picks, per sample, ceil(n/2) of the n
  label ids present in the whole batch (the reference's
  ``torch.unique(labels)`` quirk) by ranking uniform scores;
  ``class_mix_mask`` marks the pixels of the picked ids; ``one_mix`` blends.
* ``color_jitter``: per-sample brightness/contrast/saturation/hue factors on
  the [0, 1] image, through RGB <-> HSV.
* ``gaussian_blur``: reflect-padded separable Gaussian with the reference's
  kernel-size rule and a tensor sigma.

Images are NHWC.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .normalize import IMAGENET_MEAN, IMAGENET_STD, denorm_image, renorm_image

# ---------------------------------------------------------------------------
# ClassMix
# ---------------------------------------------------------------------------


def sample_class_half(scores: torch.Tensor, batch_labels: torch.Tensor,
                      num_classes: int = 19,
                      ignore_index: int = 255) -> torch.Tensor:
    """bool [B, num_classes + 1] (the last slot is the ignore id): per
    sample, the present ids whose uniform ``scores`` [B, num_classes + 1]
    rank below ceil(n_present / 2), presence taken over the whole batch."""
    ids = torch.cat([torch.arange(num_classes, device=batch_labels.device),
                     torch.tensor([ignore_index], device=batch_labels.device)])
    present = (batch_labels.unsqueeze(-1) == ids).flatten(0, -2).any(dim=0)
    n_present = present.sum()
    k = (n_present + n_present % 2) // 2
    s = torch.where(present[None, :], scores, float("-inf"))
    # per-sample rank = number of scores strictly greater
    rank = (s[:, None, :] > s[:, :, None]).sum(dim=2)
    return present[None, :] & (rank < k)


def class_mix_mask(labels: torch.Tensor, selected: torch.Tensor,
                   num_classes: int = 19,
                   ignore_index: int = 255) -> torch.Tensor:
    """bool [B, H, W]: the pixel's id is selected (``selected`` is
    [num_classes + 1] or per sample [B, num_classes + 1])."""
    idx = torch.where(labels == ignore_index, num_classes, labels)
    idx = idx.clamp(0, num_classes).long()
    if selected.ndim == 1:
        return selected[idx]
    return torch.gather(selected, 1, idx.flatten(1)).reshape(labels.shape)


def one_mix(mask: torch.Tensor, source: torch.Tensor,
            target: torch.Tensor) -> torch.Tensor:
    """mask * source + (1 - mask) * target, mask [B, H, W] broadcast."""
    while mask.ndim < source.ndim:
        mask = mask.unsqueeze(-1)
    m = mask.to(source.dtype)
    return m * source + (1 - m) * target


# ---------------------------------------------------------------------------
# Color jitter
# ---------------------------------------------------------------------------


def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-8), 0.0)
    safe = torch.where(delta > 0, delta, 1.0)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(c0, c1, c2, c3, c4, c5):
        return torch.where(i == 0, c0, torch.where(
            i == 1, c1, torch.where(i == 2, c2, torch.where(
                i == 3, c3, torch.where(i == 4, c4, c5)))))

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def jitter_factors(batch: int, strength: float, generator: torch.Generator,
                   device) -> tuple:
    """(brightness, contrast, saturation [B, 1, 1, 1] in U[1-s, 1+s), hue
    [B, 1, 1] in U[-s, s)) drawn from ``generator``."""
    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=device)
    s = strength
    return (u((batch, 1, 1, 1), 1 - s, 1 + s), u((batch, 1, 1, 1), 1 - s, 1 + s),
            u((batch, 1, 1, 1), 1 - s, 1 + s), u((batch, 1, 1), -s, s))


def color_jitter(img01: torch.Tensor, factors) -> torch.Tensor:
    """Jitter [0, 1] NHWC images with per-sample ``factors`` (brightness,
    contrast, saturation, hue)."""
    brightness, contrast, saturation, hue = factors
    x = (img01 * brightness).clamp(0.0, 1.0)
    gray_mean = (x[..., 0] * 0.299 + x[..., 1] * 0.587
                 + x[..., 2] * 0.114).mean(dim=(1, 2), keepdim=True)[..., None]
    x = ((x - gray_mean) * contrast + gray_mean).clamp(0.0, 1.0)
    gray = (x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114)[..., None]
    x = (gray + (x - gray) * saturation).clamp(0.0, 1.0)
    hsv = _rgb_to_hsv(x)
    hsv = torch.cat([torch.remainder(hsv[..., :1] + hue[..., None], 1.0),
                     hsv[..., 1:]], dim=-1)
    return _hsv_to_rgb(hsv).clamp(0.0, 1.0)


def maybe_color_jitter_normalized(img: torch.Tensor, apply: torch.Tensor,
                                  factors, mean=IMAGENET_MEAN,
                                  std=IMAGENET_STD) -> torch.Tensor:
    """Jitter a *normalized* image batch where ``apply`` (a bool tensor),
    chosen on the device without a host sync."""
    jittered = renorm_image(color_jitter(denorm_image(img, mean, std),
                                         factors), mean, std)
    return torch.where(apply, jittered, img)


# ---------------------------------------------------------------------------
# Gaussian blur
# ---------------------------------------------------------------------------


def reference_blur_kernel_size(dim: int) -> int:
    """k = floor(ceil(0.1*dim) - 0.5 + ceil(0.1*dim) % 2)."""
    c = math.ceil(0.1 * dim)
    return int(math.floor(c - 0.5 + c % 2))


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor,
                  kernel_size: tuple[int, int]) -> torch.Tensor:
    """Separable reflect-padded Gaussian blur of NHWC with a tensor sigma:
    first along H, then along W."""
    ky, kx = kernel_size

    def kernel_1d(k):
        half = (k - 1) // 2
        xs = torch.arange(-half, half + 1, dtype=torch.float32,
                          device=img.device)
        w = torch.exp(-0.5 * (xs / sigma) ** 2)
        return w / w.sum()

    c = img.shape[-1]
    x = img.permute(0, 3, 1, 2)
    x = F.pad(x, (0, 0, (ky - 1) // 2, (ky - 1) // 2), mode="reflect")
    x = F.conv2d(x, kernel_1d(ky).reshape(1, 1, ky, 1).expand(c, 1, ky, 1),
                 groups=c)
    x = F.pad(x, ((kx - 1) // 2, (kx - 1) // 2, 0, 0), mode="reflect")
    x = F.conv2d(x, kernel_1d(kx).reshape(1, 1, 1, kx).expand(c, 1, 1, kx),
                 groups=c)
    return x.permute(0, 2, 3, 1)


def maybe_gaussian_blur(img: torch.Tensor, sigma: torch.Tensor,
                        apply: torch.Tensor) -> torch.Tensor:
    """``gaussian_blur`` with the reference kernel size where ``apply``."""
    k = (reference_blur_kernel_size(img.shape[1]),
         reference_blur_kernel_size(img.shape[2]))
    return torch.where(apply, gaussian_blur(img, sigma, k), img)
