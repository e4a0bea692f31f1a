"""The fixed edge operators of the reference's utils/utils.py (mirrors
cmda_tpu.utils.misc):

  * ``rho_edges``: the four-kernel 2x2 edge operator (Rho, utils.py:75-94),
    reflect-pad 1, the four rotations of [[3, -1], [-1, -1]], cropped to
    the input size;
  * ``diff_edges``: its first kernel alone (Diff, utils.py:97-110).

Images are NHWC [B, H, W, 1], float32 out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_RHO_KERNELS = [
    [[3, -1], [-1, -1]],
    [[-1, 3], [-1, -1]],
    [[-1, -1], [-1, 3]],
    [[-1, -1], [3, -1]],
]


def _edge_conv(x: torch.Tensor, kernels) -> torch.Tensor:
    """x [B, H, W, 1] -> [B, H, W, len(kernels)]: the fixed 2x2 convs of
    the reflect-padded image; the reference's Conv2d(k=2, pad=1) gives
    H + 1 rows and columns, of which the last are cropped."""
    w = torch.tensor(kernels, dtype=torch.float32, device=x.device)[:, None]
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return F.conv2d(xp, w)[:, :, :-1, :-1].permute(0, 2, 3, 1)


def rho_edges(x: torch.Tensor) -> torch.Tensor:
    """The 4-direction fixed edge responses [B, H, W, 4] of a [B, H, W, 1]
    image."""
    return _edge_conv(x, _RHO_KERNELS)


def diff_edges(x: torch.Tensor) -> torch.Tensor:
    """The single-direction fixed edge response [B, H, W, 1]."""
    return _edge_conv(x, _RHO_KERNELS[:1])
