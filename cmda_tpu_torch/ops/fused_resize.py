"""Fused integer-factor bilinear upsample + argmax / max-softmax: the CUDA
kernel ``csrc/fused_resize_argmax.cu`` and its wrapper (counterpart of the
serving half of cmda_tpu.ops.pallas_ce).

``fused_resize_argmax`` launches the kernel for CUDA tensors and runs the
plain version ``resize_argmax`` for CPU tensors; there is no other
fallback. ``fused_resize_argmax.launches`` counts kernel launches. The
kernel needs integer upsample factors; ``resize_argmax`` takes any geometry
and is what a caller dispatches to for the others.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .resize import resize_bilinear


def resize_argmax(logits: torch.Tensor, out_size, *, with_prob: bool = True):
    """Plain version: (argmax, max softmax) over classes of
    ``resize_bilinear(logits, out_size)``. logits [B, h, w, C] -> (label
    int32 [B, H, W], prob float32 [B, H, W] or None); ties go to the first
    class."""
    z = resize_bilinear(logits.float(), tuple(out_size))
    label = z.argmax(dim=-1).to(torch.int32)
    if not with_prob:
        return label, None
    m = z.amax(dim=-1, keepdim=True)
    prob = 1.0 / torch.exp(z - m).sum(dim=-1)
    return label, prob


def is_integer_factor(logits_shape, out_size) -> bool:
    """Whether ``[B, h, w, C] -> out_size`` is an integer-factor upsample
    (the only geometry the kernel takes)."""
    h, w = logits_shape[1], logits_shape[2]
    return (out_size[0] % h == 0 and out_size[1] % w == 0
            and out_size[0] >= h and out_size[1] >= w)


def fused_resize_argmax(logits: torch.Tensor, out_size, *,
                        with_prob: bool = True):
    """(argmax, max-softmax prob) of the bilinear upsample of ``logits``
    [B, h, w, C] (NHWC, float32 or bfloat16) to ``out_size`` (H, W), an
    integer multiple of (h, w). Returns (label int32 [B, H, W], prob
    float32 [B, H, W] or None)."""
    if logits.ndim != 4 or logits.shape[-1] < 1:
        raise ValueError(f"logits must be [B, h, w, C], got "
                         f"{tuple(logits.shape)}")
    if not is_integer_factor(logits.shape, out_size):
        raise ValueError(f"{tuple(logits.shape)} -> {tuple(out_size)} is not "
                         "an integer-factor upsample")
    if logits.device.type == "cpu":
        return resize_argmax(logits, out_size, with_prob=with_prob)
    if logits.device.type != "cuda":
        raise ValueError(f"fused_resize_argmax: unsupported device "
                         f"{logits.device}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be float32 or bfloat16, got "
                        f"{logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("fused_resize_argmax: logits must be contiguous "
                         "NHWC")
    b, h, w, c = logits.shape
    hh, ww = int(out_size[0]), int(out_size[1])
    if b * h * w >= 2 ** 31:   # at most one block per coarse pixel
        raise ValueError("fused_resize_argmax: input too large for one grid")
    label = torch.empty((b, hh, ww), dtype=torch.int32, device=logits.device)
    prob = (torch.empty((b, hh, ww), dtype=torch.float32,
                        device=logits.device) if with_prob else None)
    lib = _build.load("fused_resize_argmax")
    name = ("cmda_fused_resize_argmax_f32" if logits.dtype == torch.float32
            else "cmda_fused_resize_argmax_bf16")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(logits.data_ptr(), label.data_ptr(),
                  prob.data_ptr() if prob is not None else None,
                  b, h, w, c, hh // h, ww // w, stream)
    _build.check(lib, "cmda_fused_resize_argmax_error_string", code,
                 "fused_resize_argmax")
    fused_resize_argmax.launches += 1
    return label, prob


fused_resize_argmax.launches = 0
