"""Fused integer-factor bilinear upsample + argmax / max-softmax: the CUDA
kernel ``csrc/fused_resize_argmax.cu`` and its wrapper (counterpart of the
serving half of cmda_tpu.ops.pallas_ce).

``fused_resize_argmax`` calls the custom op
``cmda_tpu_torch::fused_resize_argmax`` (registered when this module is
imported; it needs no ``nvcc`` until its first CUDA call), whose CUDA
implementation launches the kernel and whose CPU implementation is the
plain version ``resize_argmax``; there is no other fallback, and a CUDA
tensor never reaches the plain version. Its fake implementation gives the
outputs' shapes and dtypes, so ``torch.export`` keeps the op in the
exported graph. An eager call on a plain tensor skips the op's dispatch
and calls the same implementation itself (``direct_call``).
``fused_resize_argmax.launches`` counts kernel launches. The kernel needs integer upsample factors; ``resize_argmax`` takes any
geometry and is what a caller dispatches to for the others.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from . import _build
from .resize import resize_bilinear


def direct_call(t: torch.Tensor) -> bool:
    """Whether a kernel's wrapper may call the op's implementation for
    ``t``'s device itself: ``t`` is a plain tensor and nothing traces
    (``torch.export``, ``torch.compile``, a dispatch mode), so the op's
    dispatch would reach that same function. Skipping it saves the
    dispatch's host time on every eager call."""
    return (type(t) is torch.Tensor and not torch.compiler.is_compiling()
            and _get_current_dispatch_mode() is None)


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


def _check_geometry(logits: torch.Tensor, out_size):
    if logits.ndim != 4 or logits.shape[-1] < 1:
        raise ValueError(f"logits must be [B, h, w, C], got "
                         f"{tuple(logits.shape)}")
    if not is_integer_factor(logits.shape, out_size):
        raise ValueError(f"{tuple(logits.shape)} -> {tuple(out_size)} is not "
                         "an integer-factor upsample")


def fused_resize_argmax(logits: torch.Tensor, out_size, *,
                        with_prob: bool = True):
    """(argmax, max-softmax prob) of the bilinear upsample of ``logits``
    [B, h, w, C] (NHWC, float32 or bfloat16) to ``out_size`` (H, W), an
    integer multiple of (h, w). Returns (label int32 [B, H, W], prob
    float32 [B, H, W] or None). Runs the custom op
    ``torch.ops.cmda_tpu_torch.fused_resize_argmax``, which
    ``torch.export`` keeps in its graph, or its implementation directly
    where ``direct_call`` allows. The outputs carry no gradient."""
    _check_geometry(logits, out_size)
    args = (logits.detach(), int(out_size[0]), int(out_size[1]), with_prob)
    impl = _ARGMAX_IMPLS.get(logits.device.type)
    if impl is not None and direct_call(logits):
        label, prob = impl(*args)
    else:
        label, prob = torch.ops.cmda_tpu_torch.fused_resize_argmax(*args)
    return label, (prob if with_prob else None)


fused_resize_argmax.launches = 0


# The custom op: its schema has fixed types, so the prob is always an
# output, empty ([0]) when with_prob is false.
@torch.library.custom_op("cmda_tpu_torch::fused_resize_argmax",
                         mutates_args=())
def _argmax_op(logits: torch.Tensor, out_h: int, out_w: int,
               with_prob: bool) -> tuple[torch.Tensor, torch.Tensor]:
    raise NotImplementedError(
        f"cmda_tpu_torch::fused_resize_argmax has no kernel for "
        f"{logits.device}: it takes CUDA tensors (the kernel) and CPU "
        "tensors (the plain version)")


@_argmax_op.register_fake
def _argmax_fake(logits, out_h, out_w, with_prob):
    _check_geometry(logits, (out_h, out_w))
    b = logits.shape[0]
    label = logits.new_empty((b, out_h, out_w), dtype=torch.int32)
    prob = logits.new_empty((b, out_h, out_w) if with_prob else (0,),
                            dtype=torch.float32)
    return label, prob


@_argmax_op.register_kernel("cpu")
def _argmax_cpu(logits, out_h, out_w, with_prob):
    _check_geometry(logits, (out_h, out_w))
    label, prob = resize_argmax(logits, (out_h, out_w), with_prob=with_prob)
    if prob is None:
        prob = logits.new_empty((0,), dtype=torch.float32)
    return label, prob


@_argmax_op.register_kernel("cuda")
def _argmax_cuda(logits, out_h, out_w, with_prob):
    _check_geometry(logits, (out_h, out_w))
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be float32 or bfloat16, got "
                        f"{logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("fused_resize_argmax: logits must be contiguous "
                         "NHWC")
    b, h, w, c = logits.shape
    if b * h * w >= 2 ** 31:   # at most one block per coarse pixel
        raise ValueError("fused_resize_argmax: input too large for one grid")
    label = torch.empty((b, out_h, out_w), dtype=torch.int32,
                        device=logits.device)
    prob = torch.empty((b, out_h, out_w) if with_prob else (0,),
                       dtype=torch.float32, device=logits.device)
    lib = _build.load("fused_resize_argmax")
    name = ("cmda_fused_resize_argmax_f32" if logits.dtype == torch.float32
            else "cmda_fused_resize_argmax_bf16")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(logits.data_ptr(), label.data_ptr(),
                  prob.data_ptr() if with_prob else None,
                  b, h, w, c, out_h // h, out_w // w, stream)
    _build.check(lib, "cmda_fused_resize_argmax_error_string", code,
                 "fused_resize_argmax")
    fused_resize_argmax.launches += 1
    return label, prob


_ARGMAX_IMPLS = {"cpu": _argmax_cpu, "cuda": _argmax_cuda}
