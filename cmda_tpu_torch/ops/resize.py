"""Resize ops with torch ``F.interpolate`` semantics (mirrors cmda_tpu.ops.resize).

* bilinear, align_corners=False: half-pixel sampling, no antialias.
* nearest: the asymmetric rule ``src = floor(dst * in / out)``, done with an
  explicit integer gather so it never depends on a float scale.

Both take NHWC (or NHW) tensors, like the JAX package's public functions.

``set_fused_int_upsample(True)`` (the train CLI's ``--fused-resize``)
routes every integer-factor bilinear upsample of a 4-D tensor, here and in
the DAFormer decoder (``upsample_bilinear_nchw``), through
``phase_upsample_bilinear``: the same two-tap weights as fixed-phase
weighted adds of shifted copies, equal to ``F.interpolate`` to float
roundoff. In the JAX package it is an XLA lever (elementwise adds that
fuse into their consumer instead of a dot_general); here it is plain torch.
The flag is read at each call, so there is no cache to clear.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_FUSED_INT_UPSAMPLE = False


def set_fused_int_upsample(enabled: bool) -> None:
    """Route integer-factor bilinear upsamples through the phase form
    (process-wide, as in the JAX package)."""
    global _FUSED_INT_UPSAMPLE
    _FUSED_INT_UPSAMPLE = bool(enabled)


def _integer_upsample(in_hw, size) -> bool:
    return size[0] % in_hw[0] == 0 and size[1] % in_hw[1] == 0


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC (or NHW) to spatial ``size`` (H, W), computed
    in float32 and cast back to the input dtype."""
    if x.ndim not in (3, 4):
        raise ValueError(f"expected 3D/4D input, got {tuple(x.shape)}")
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    if (_FUSED_INT_UPSAMPLE and x.ndim == 4
            and _integer_upsample(x.shape[1:3], size)):
        return phase_upsample_bilinear(x, size)
    nchw = x.unsqueeze(1) if x.ndim == 3 else x.permute(0, 3, 1, 2)
    y = F.interpolate(nchw.float(), size=tuple(size), mode="bilinear",
                      align_corners=False)
    y = y.squeeze(1) if x.ndim == 3 else y.permute(0, 2, 3, 1)
    return y.to(x.dtype)


def upsample_bilinear_nchw(x: torch.Tensor, size) -> torch.Tensor:
    """``resize_bilinear`` of an NCHW tensor (the decoder's layout), in
    float32, cast back to the input dtype."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    if _FUSED_INT_UPSAMPLE and _integer_upsample(x.shape[2:], size):
        return _phase_upsample(x, size, axes=(2, 3))
    return F.interpolate(x.float(), size=tuple(size), mode="bilinear",
                         align_corners=False).to(x.dtype)


def _phase_upsample_axis(x: torch.Tensor, axis: int,
                         factor: int) -> torch.Tensor:
    """Integer-factor half-pixel bilinear upsample of float32 ``x`` along
    ``axis``: output ``o = factor * i + p`` samples the input at
    ``i + (p + 0.5) / factor - 0.5``, a fixed blend of ``x[i]`` with its
    clamped left or right neighbour whose weights depend only on the phase
    ``p``."""
    n = x.shape[axis]
    first, last = x.narrow(axis, 0, 1), x.narrow(axis, n - 1, 1)
    prev = torch.cat([first, x.narrow(axis, 0, n - 1)], dim=axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), last], dim=axis)
    d = (torch.arange(factor, dtype=torch.float32, device=x.device)
         + 0.5) / factor - 0.5
    w_prev, w_next = (-d).clamp(min=0.0), d.clamp(min=0.0)
    w_self = 1.0 - w_prev - w_next
    shape = [1] * (x.ndim + 1)
    shape[axis + 1] = factor
    w_prev, w_self, w_next = (w.reshape(shape)
                              for w in (w_prev, w_self, w_next))
    y = (w_prev * prev.unsqueeze(axis + 1) + w_self * x.unsqueeze(axis + 1)
         + w_next * nxt.unsqueeze(axis + 1))
    out_shape = list(x.shape)
    out_shape[axis] = n * factor
    return y.reshape(out_shape)


def _phase_upsample(x: torch.Tensor, size, axes) -> torch.Tensor:
    (ah, aw), (h, w) = axes, (x.shape[axes[0]], x.shape[axes[1]])
    fh, fw = size[0] // h, size[1] // w
    if fh * h != size[0] or fw * w != size[1]:
        raise ValueError(f"{tuple(x.shape)} -> {tuple(size)} is not an "
                         "integer upsample")
    y = x.float()
    if fh > 1:
        y = _phase_upsample_axis(y, ah, fh)
    if fw > 1:
        y = _phase_upsample_axis(y, aw, fw)
    return y.to(x.dtype)


def phase_upsample_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """NHWC integer-factor bilinear upsample (align_corners=False) as
    fixed-phase weighted adds, computed in float32 and cast back to the
    input dtype; equal to ``F.interpolate`` to float roundoff in values and
    gradients."""
    return _phase_upsample(x, size, axes=(1, 2))


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize matching torch ``F.interpolate(mode='nearest')``:
    ``src_idx = floor(dst_idx * in_size / out_size)``. NHWC or NHW."""
    h, w = x.shape[1], x.shape[2]
    oh, ow = size
    ys = (torch.arange(oh, device=x.device) * h // oh).clamp_(0, h - 1)
    xs = (torch.arange(ow, device=x.device) * w // ow).clamp_(0, w - 1)
    return x[:, ys][:, :, xs]
