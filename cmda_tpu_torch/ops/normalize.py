"""Range normalisation and the ImageNet image normalisation (mirrors
cmda_tpu.ops.normalize)."""
from __future__ import annotations

import torch


def normalize_to_range(x: torch.Tensor, min_val: float, max_val: float):
    """Global min-max rescale of the whole tensor to [min_val, max_val]:
    ``(x - min) / (max - min + 1e-8) * (max_val - min_val) + min_val``."""
    x_min = x.min()
    x_max = x.max()
    return (x - x_min) / (x_max - x_min + 1e-8) * (max_val - min_val) + min_val


# img_norm_cfg mean/std applied to 0-255 RGB images
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def _channel_const(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=torch.float32, device=like.device)


def denorm_image(img: torch.Tensor, mean=IMAGENET_MEAN,
                 std=IMAGENET_STD) -> torch.Tensor:
    """Normalized NHWC image -> [0, 1] RGB."""
    return (img * _channel_const(std, img) + _channel_const(mean, img)) / 255.0


def renorm_image(img01: torch.Tensor, mean=IMAGENET_MEAN,
                 std=IMAGENET_STD) -> torch.Tensor:
    """[0, 1] RGB NHWC image -> normalized."""
    return ((img01 * 255.0 - _channel_const(mean, img01))
            / _channel_const(std, img01))
