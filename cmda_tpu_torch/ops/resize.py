"""Resize ops with torch ``F.interpolate`` semantics (mirrors cmda_tpu.ops.resize).

* bilinear, align_corners=False: half-pixel sampling, no antialias.
* nearest: the asymmetric rule ``src = floor(dst * in / out)``, done with an
  explicit integer gather so it never depends on a float scale.

Both take NHWC (or NHW) tensors, like the JAX package's public functions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC (or NHW) to spatial ``size`` (H, W), computed
    in float32 and cast back to the input dtype."""
    if x.ndim not in (3, 4):
        raise ValueError(f"expected 3D/4D input, got {tuple(x.shape)}")
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    nchw = x.unsqueeze(1) if x.ndim == 3 else x.permute(0, 3, 1, 2)
    y = F.interpolate(nchw.float(), size=tuple(size), mode="bilinear",
                      align_corners=False)
    y = y.squeeze(1) if x.ndim == 3 else y.permute(0, 2, 3, 1)
    return y.to(x.dtype)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize matching torch ``F.interpolate(mode='nearest')``:
    ``src_idx = floor(dst_idx * in_size / out_size)``. NHWC or NHW."""
    h, w = x.shape[1], x.shape[2]
    oh, ow = size
    ys = (torch.arange(oh, device=x.device) * h // oh).clamp_(0, h - 1)
    xs = (torch.arange(ow, device=x.device) * w // ow).clamp_(0, w - 1)
    return x[:, ys][:, :, xs]
