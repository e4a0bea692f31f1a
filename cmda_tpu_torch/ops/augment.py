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
* ``add_noise_on_isr``: the mixed ISR's blur, dropout and speckle
  (``uda.isr_noise_dacs_type``), its draws an ``IsrNoiseDraws``.
* ``cow_masks``: the CowMix smooth-noise threshold masks on the device.

Images are NHWC.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .normalize import IMAGENET_MEAN, IMAGENET_STD, denorm_image, renorm_image
from .resize import resize_bilinear

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
        # float32, or float64 for a float64 image
        xs = torch.arange(-half, half + 1, device=img.device,
                          dtype=torch.promote_types(img.dtype, torch.float32))
        w = torch.exp(-0.5 * (xs / sigma.to(xs.dtype)) ** 2)
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


# ---------------------------------------------------------------------------
# ISR noise (reference mmseg/models/utils/dacs_transforms.py:186-211)
# ---------------------------------------------------------------------------


class IsrNoiseDraws(NamedTuple):
    """The random values of one ``add_noise_on_isr`` call on an ISR of
    shape [B, H, W, C]: ``gate`` [] U[0, 1) (the batch-wide blur coin);
    ``dis_thr`` [B, 1, 1, 1] U[1, 1.5); ``dis_normal`` N(0, 1) of the ISR's
    shape; ``rnd_thr`` [B, 1, 1, 1] U[0.4, 0.6); ``intensity`` [B, 1, 1, 1]
    U[0.1, 0.3); ``rnd_normal`` and ``noise`` N(0, 1) of the ISR's
    shape."""
    gate: torch.Tensor
    dis_thr: torch.Tensor
    dis_normal: torch.Tensor
    rnd_thr: torch.Tensor
    intensity: torch.Tensor
    rnd_normal: torch.Tensor
    noise: torch.Tensor


def isr_noise_draws(shape, generator: torch.Generator,
                    device) -> IsrNoiseDraws:
    """``IsrNoiseDraws`` for an ISR of ``shape`` [B, H, W, C] from
    ``generator``."""
    def u(shp, lo, hi):
        return lo + (hi - lo) * torch.rand(shp, generator=generator,
                                           device=device)

    def n():
        return torch.randn(tuple(shape), generator=generator, device=device)
    per = (shape[0], 1, 1, 1)
    return IsrNoiseDraws(gate=u((), 0.0, 1.0), dis_thr=u(per, 1.0, 1.5),
                         dis_normal=n(), rnd_thr=u(per, 0.4, 0.6),
                         intensity=u(per, 0.1, 0.3), rnd_normal=n(),
                         noise=n())


def add_noise_on_isr(isr: torch.Tensor, draws: IsrNoiseDraws,
                     transform_type: str = "noise+blur") -> torch.Tensor:
    """Degrade an ISR batch [B, H, W, C] in [-1, 1]. 'blur': where
    ``draws.gate`` < 0.5 (one coin for the batch, as the reference draws one
    torch.rand(1) per call), a 2x average pool and a bilinear resize back.
    'noise': zeroed where |dis_normal| < dis_thr fails, plus ``noise`` x
    ``intensity`` where |rnd_normal| < rnd_thr, clipped to [-1, 1]."""
    h, w = isr.shape[1:3]
    out = isr
    if "blur" in transform_type:
        small = F.avg_pool2d(out.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        out = torch.where(draws.gate < 0.5, resize_bilinear(small, (h, w)),
                          out)
    if "noise" in transform_type:
        out = out * (draws.dis_normal.abs() < draws.dis_thr)
        rnd_mask = draws.rnd_normal.abs() < draws.rnd_thr
        out = out + draws.noise * draws.intensity * rnd_mask
        out = out.clamp(-1.0, 1.0)
    return out


# ---------------------------------------------------------------------------
# Cow masks (reference mmseg/datasets/utils.py:171-200)
# ---------------------------------------------------------------------------


def cow_masks(p: torch.Tensor, sigmas: torch.Tensor, noise: torch.Tensor,
              max_sigma: int = 16) -> torch.Tensor:
    """Smooth-noise threshold masks [B, H, W] bool (mirrors
    cmda_tpu.ops.augment.cow_masks, its draws handed in): ``noise``
    [B, H, W, 1] N(0, 1) smoothed by a reflect-padded separable Gaussian of
    each sample's ``sigmas`` [B] (a 2 * (3 * max_sigma) * 2 + 1 tap kernel,
    along W then H), then kept at or below its mean + erfinv(2 p - 1)
    sqrt(2) std (``p`` [B] the mask's share; the std with ddof 1). The JAX
    function draws p ~ U[0.25, 1), log(sigmas) ~ U[log 4, log 16) and the
    noise."""
    b, h, w, _ = noise.shape
    threshold_factors = torch.erfinv(2 * p - 1) * math.sqrt(2.0)
    size = round(max_sigma * 3) * 2 + 1
    xs = torch.arange(-size, size + 1, dtype=torch.float32,
                      device=noise.device)
    kernels = torch.exp(-0.5 * xs[None, :] ** 2 / sigmas[:, None] ** 2)
    kernels = kernels / (sigmas[:, None] * math.sqrt(2 * math.pi))
    pad = (kernels.shape[1] - 1) // 2
    # one group per sample: [1, B, H, W] against [B, 1, 1, k] / [B, 1, k, 1]
    x = F.pad(noise[..., 0][None], (pad, pad, 0, 0), mode="reflect")
    x = F.conv2d(x, kernels[:, None, None, :], groups=b)
    x = F.pad(x, (0, 0, pad, pad), mode="reflect")
    smooth = F.conv2d(x, kernels[:, None, :, None], groups=b)[0]
    mean = smooth.mean(dim=(1, 2), keepdim=True)
    std = smooth.std(dim=(1, 2), keepdim=True, correction=1)
    return smooth <= threshold_factors[:, None, None] * std + mean
