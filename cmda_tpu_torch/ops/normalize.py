"""Range normalisation (mirrors cmda_tpu.ops.normalize)."""
from __future__ import annotations

import torch


def normalize_to_range(x: torch.Tensor, min_val: float, max_val: float):
    """Global min-max rescale of the whole tensor to [min_val, max_val]:
    ``(x - min) / (max - min + 1e-8) * (max_val - min_val) + min_val``."""
    x_min = x.min()
    x_max = x.max()
    return (x - x_min) / (x_max - x_min + 1e-8) * (max_val - min_val) + min_val
