"""Fused integer-factor bilinear upsample + softmax cross-entropy: the CUDA
kernels ``csrc/fused_resize_ce.cu`` and their wrappers (counterpart of the
training half of cmda_tpu.ops.pallas_ce).

``fused_resize_ce(logits, labels, weight)`` equals
``resize_ce(logits, labels, weight)``, the plain version
``weighted_cross_entropy(resize_bilinear(logits, labels.shape[1:]), ...)``,
without the [B, H, W, C] upsampled logits in device memory in either
direction. For CUDA tensors it is a ``torch.autograd.Function``: the
forward kernel writes the loss and each fine pixel's log-sum-exp; the
backward launches the dx kernel, and the dweight kernel only when the
weight's gradient is asked for (in DACS the pixel weights carry none, so it
never runs there). For CPU tensors it is the plain version, differentiated
by autograd; there is no other fallback.

Each kernel wrapper counts its launches: ``fused_resize_ce.launches``,
``fused_resize_ce_dx.launches``, ``fused_resize_ce_dweight.launches``.

The kernels take any integer factors ``fh, fw >= 1``; a caller dispatches
any other geometry to ``resize_ce`` (``is_integer_factor``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_resize import is_integer_factor
from .losses import weighted_cross_entropy
from .resize import resize_bilinear

_LIB = "fused_resize_ce"
_P, _I = ctypes.c_void_p, ctypes.c_int


def resize_ce(logits: torch.Tensor, labels: torch.Tensor,
              weight: torch.Tensor | None = None,
              ignore_index: int = 255) -> torch.Tensor:
    """Plain version: the weighted CE of the float32 bilinear upsample of
    ``logits`` [B, h, w, C] to the labels' [B, H, W] (any geometry),
    differentiable by autograd."""
    z = resize_bilinear(logits.float(), tuple(labels.shape[1:3]))
    return weighted_cross_entropy(z, labels, weight, ignore_index)


def _check(logits, labels, weight):
    if logits.ndim != 4 or labels.ndim != 3 or labels.shape[0] != logits.shape[0]:
        raise ValueError(f"logits [B, h, w, C] and labels [B, H, W] expected, "
                         f"got {tuple(logits.shape)} and {tuple(labels.shape)}")
    if not is_integer_factor(logits.shape, labels.shape[1:3]):
        raise ValueError(f"{tuple(logits.shape)} -> {tuple(labels.shape)} is "
                         "not an integer-factor upsample")
    if weight is not None and weight.shape != labels.shape:
        raise ValueError(f"weight {tuple(weight.shape)} must match labels "
                         f"{tuple(labels.shape)}")


def _check_cuda(logits, labels, weight):
    dev = logits.device
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be float32 or bfloat16, got "
                        f"{logits.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    if weight is not None and weight.dtype != torch.float32:
        raise TypeError(f"weight must be float32, got {weight.dtype}")
    for name, t in (("logits", logits), ("labels", labels), ("weight", weight)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"fused_resize_ce: {name} on {t.device}, logits "
                             f"on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"fused_resize_ce: {name} must be contiguous")


def _geometry(logits, labels):
    b, h, w, c = logits.shape
    hh, ww = labels.shape[1], labels.shape[2]
    if b * hh * ww >= 2 ** 31 * 256 or b * h * w * c >= 2 ** 31 * 256:
        raise ValueError("fused_resize_ce: too large for one grid")
    return [b, h, w, c, hh // h, ww // w]


_ENTRIES: dict = {}   # entry-point name -> ctypes function


def _entry(lib, name, argtypes, restype=_I):
    """A C entry point with its ctypes signature, set once per name."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
        _ENTRIES[name] = fn
    return fn


def _fn(lib, name, n_ptr):
    return _entry(lib, name, [_P] * n_ptr + [_I] * 7 + [_P])


_DONE: dict = {}   # (device index, stream) -> the forward's block counter


def _done_counter(device, stream):
    """The forward kernel's count of finished blocks on ``stream``: zero
    when allocated, and the kernel leaves it at zero. Launches on one
    stream run in turn, so each stream needs only one."""
    key = (device.index, stream)
    done = _DONE.get(key)
    if done is None:
        done = _DONE[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return done


def _suffix(logits):
    return "f32" if logits.dtype == torch.float32 else "bf16"


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch(fn, lib, what, device, *args):
    """Call a C entry point on ``device``'s current stream; tensors pass as
    their data pointers, None as a null pointer."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(*[_ptr(a) if isinstance(a, torch.Tensor) or a is None
                    else a for a in args], stream)
    _build.check(lib, "cmda_fused_resize_ce_error_string", code, what)


def fused_resize_ce_forward(logits, labels, weight=None, *,
                            ignore_index: int = 255):
    """The forward kernel: (loss float32 [], lse float32 [B, H, W])."""
    _check(logits, labels, weight)
    _check_cuda(logits, labels, weight)
    lib = _build.load(_LIB)
    lse = torch.empty(labels.shape, dtype=torch.float32, device=logits.device)
    if labels.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=logits.device), lse
    geometry = _geometry(logits, labels)
    count = _entry(lib, "cmda_fused_resize_ce_num_partials", [_I] * 6,
                   ctypes.c_longlong)
    partials = torch.empty(int(count(*geometry)), dtype=torch.float32,
                           device=logits.device)
    # the kernel writes the loss
    loss = torch.empty((), dtype=torch.float32, device=logits.device)
    fn = _fn(lib, f"cmda_fused_resize_ce_fwd_{_suffix(logits)}", 7)
    dev = logits.device
    done = _done_counter(dev, torch.cuda.current_stream(dev).cuda_stream)
    _launch(fn, lib, "fused_resize_ce", dev, logits, labels, weight, lse,
            partials, done, loss, *geometry, int(ignore_index))
    fused_resize_ce.launches += 1
    return loss, lse


def fused_resize_ce_dx(g, logits, labels, weight, lse, *,
                       ignore_index: int = 255):
    """The dx kernel: d loss / d logits for upstream gradient ``g`` (a
    float32 scalar tensor on the device), in the logits' dtype."""
    _check_cuda(logits, labels, weight)
    lib = _build.load(_LIB)
    out = torch.empty_like(logits)
    if out.numel() == 0:
        return out
    fn = _fn(lib, f"cmda_fused_resize_ce_dx_{_suffix(logits)}", 6)
    _launch(fn, lib, "fused_resize_ce_dx", logits.device,
            g.float().contiguous(), logits, labels, weight, lse, out,
            *_geometry(logits, labels), int(ignore_index))
    fused_resize_ce_dx.launches += 1
    return out


def fused_resize_ce_dweight(g, logits, labels, lse, *,
                            ignore_index: int = 255):
    """The dweight kernel: d loss / d weight [B, H, W] float32."""
    _check_cuda(logits, labels, None)
    lib = _build.load(_LIB)
    out = torch.empty(labels.shape, dtype=torch.float32, device=logits.device)
    if out.numel() == 0:
        return out
    fn = _fn(lib, f"cmda_fused_resize_ce_dweight_{_suffix(logits)}", 5)
    _launch(fn, lib, "fused_resize_ce_dweight", logits.device,
            g.float().contiguous(), logits, labels, lse, out,
            *_geometry(logits, labels), int(ignore_index))
    fused_resize_ce_dweight.launches += 1
    return out


class _FusedResizeCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, weight, ignore_index):
        loss, lse = fused_resize_ce_forward(logits, labels, weight,
                                            ignore_index=ignore_index)
        ctx.save_for_backward(logits, labels, weight, lse)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, weight, lse = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = fused_resize_ce_dx(g, logits, labels, weight, lse,
                                    ignore_index=ctx.ignore_index)
        if weight is not None and ctx.needs_input_grad[2]:
            dw = fused_resize_ce_dweight(g, logits, labels, lse,
                                         ignore_index=ctx.ignore_index)
        return dx, None, dw, None


def fused_resize_ce(logits: torch.Tensor, labels: torch.Tensor,
                    weight: torch.Tensor | None = None, *,
                    ignore_index: int = 255) -> torch.Tensor:
    """Weighted CE of the bilinear upsample of ``logits`` [B, h, w, C]
    (NHWC, float32 or bfloat16, math in float32) to ``labels`` [B, H, W]
    int32, an integer multiple of (h, w); ``weight`` [B, H, W] float32 or
    None. Mean over all B*H*W pixels. Differentiable in logits and weight."""
    _check(logits, labels, weight)
    if logits.device.type == "cpu":
        return resize_ce(logits, labels, weight, ignore_index)
    if logits.device.type != "cuda":
        raise ValueError(f"fused_resize_ce: unsupported device {logits.device}")
    return _FusedResizeCE.apply(logits, labels, weight, int(ignore_index))


fused_resize_ce.launches = 0
fused_resize_ce_dx.launches = 0
fused_resize_ce_dweight.launches = 0
