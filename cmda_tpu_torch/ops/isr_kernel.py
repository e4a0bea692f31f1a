"""Batched ISR: the CUDA kernel ``csrc/batched_isr.cu`` and its wrapper
(counterpart of cmda_tpu.ops.pallas_kernels.pallas_batched_isr).

``batched_isr`` calls the custom op ``cmda_tpu_torch::batched_isr``
(registered when this module is imported, no ``nvcc`` needed until its
first CUDA call): its CUDA implementation launches the kernel (one
cooperative launch per call), its CPU implementation is the plain PyTorch
version (``ops/isr.py``, image by image); there is no other fallback. Its
fake implementation lets ``torch.export`` keep the op in a graph. An eager
call on a plain tensor skips the op's dispatch and calls the same
implementation itself (``fused_resize.direct_call``).
``batched_isr.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .fused_resize import direct_call
from .isr import image_change_from_gray

_FN = "cmda_batched_isr"


def batched_isr_plain(gray: torch.Tensor, direction_idx: torch.Tensor, *,
                      val_range, threshold: float, clip_range: float,
                      shift_pixel: int = 1) -> torch.Tensor:
    """The kernel's plain version: ``image_change_from_gray`` per image."""
    return torch.stack([
        image_change_from_gray(
            g.float(), val_range=val_range, threshold=threshold,
            clip_range=clip_range, shift_pixel=shift_pixel,
            shift_direction=None, direction_idx=int(d))
        for g, d in zip(gray, direction_idx.tolist())])


def _check(gray, direction_idx, shift_pixel):
    if gray.ndim != 3:
        raise ValueError(f"gray must be [B, H, W], got {tuple(gray.shape)}")
    if gray.dtype != torch.float32:
        raise TypeError(f"gray must be float32, got {gray.dtype}")
    if direction_idx.shape != (gray.shape[0],):
        raise ValueError(f"direction_idx must be [{gray.shape[0]}], got "
                         f"{tuple(direction_idx.shape)}")
    if direction_idx.dtype != torch.int32:
        raise TypeError(f"direction_idx must be int32, got "
                        f"{direction_idx.dtype}")
    if not 0 <= shift_pixel <= min(gray.shape[1], gray.shape[2]):
        raise ValueError(f"shift_pixel {shift_pixel} outside [0, min(H, W)]")


def batched_isr(gray: torch.Tensor, direction_idx: torch.Tensor, *,
                val_range, threshold: float, clip_range: float,
                shift_pixel: int = 1) -> torch.Tensor:
    """gray [B, H, W] float32 (0..255); direction_idx [B] int32 in [0, 4)
    (leftdown/leftup/rightdown/rightup) -> ISR [B, H, W] float32 in [-1, 1].
    Runs the custom op ``torch.ops.cmda_tpu_torch.batched_isr``, which
    ``torch.export`` keeps in its graph, or its implementation directly
    where ``direct_call`` allows. The output carries no gradient."""
    _check(gray, direction_idx, shift_pixel)
    args = (gray.detach(), direction_idx, float(val_range[0]),
            float(val_range[1]), float(threshold), float(clip_range),
            int(shift_pixel))
    impl = _ISR_IMPLS.get(gray.device.type)
    if impl is not None and direct_call(gray):
        return impl(*args)
    return torch.ops.cmda_tpu_torch.batched_isr(*args)


batched_isr.launches = 0


@torch.library.custom_op("cmda_tpu_torch::batched_isr", mutates_args=())
def _isr_op(gray: torch.Tensor, direction_idx: torch.Tensor, lo: float,
            hi: float, threshold: float, clip_range: float,
            shift_pixel: int) -> torch.Tensor:
    raise NotImplementedError(
        f"cmda_tpu_torch::batched_isr has no kernel for {gray.device}: it "
        "takes CUDA tensors (the kernel) and CPU tensors (the plain "
        "version)")


@_isr_op.register_fake
def _isr_fake(gray, direction_idx, lo, hi, threshold, clip_range,
              shift_pixel):
    _check(gray, direction_idx, shift_pixel)
    return torch.empty_like(gray)


@_isr_op.register_kernel("cpu")
def _isr_cpu(gray, direction_idx, lo, hi, threshold, clip_range,
             shift_pixel):
    _check(gray, direction_idx, shift_pixel)
    if direction_idx.device != gray.device:
        raise ValueError(f"batched_isr: gray on {gray.device}, direction_idx "
                         f"on {direction_idx.device}")
    return batched_isr_plain(gray, direction_idx, val_range=(lo, hi),
                             threshold=threshold, clip_range=clip_range,
                             shift_pixel=shift_pixel)


@_isr_op.register_kernel("cuda")
def _isr_cuda(gray, direction_idx, lo, hi, threshold, clip_range,
              shift_pixel):
    _check(gray, direction_idx, shift_pixel)
    if direction_idx.device != gray.device:
        raise ValueError(f"batched_isr: gray on {gray.device}, direction_idx "
                         f"on {direction_idx.device}; both must be one CUDA "
                         "device (or the CPU)")
    if not gray.is_contiguous():
        raise ValueError("batched_isr: gray must be contiguous")
    direction_idx = direction_idx.contiguous()
    b, h, w = gray.shape
    if b * h * w >= 2 ** 31:
        raise ValueError(f"batched_isr: {b * h * w} pixels, the kernel takes "
                         "fewer than 2^31")
    span = math.log(hi) - math.log(lo)
    out = torch.empty_like(gray)
    # one slot of 8 extrema per chunk (at least 1024 pixels of one image)
    partials = torch.empty(b * -(-(h * w) // 1024) * 8, dtype=torch.float32,
                           device=gray.device)
    lib = _build.load("batched_isr")
    fn = getattr(lib, _FN)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(gray.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(gray.data_ptr(), direction_idx.data_ptr(),
                  partials.data_ptr(), out.data_ptr(), b, h, w, lo,
                  (hi - lo) / 255.0,
                  span * threshold, span * clip_range, int(shift_pixel),
                  stream)
    _build.check(lib, "cmda_batched_isr_error_string", code, "batched_isr")
    batched_isr.launches += 1
    return out


_ISR_IMPLS = {"cpu": _isr_cpu, "cuda": _isr_cuda}
