"""Tensor ops of the port: resize, ISR, the CUDA kernel wrappers and metrics.

Importing this package registers the serving kernels as custom ops,
``torch.ops.cmda_tpu_torch.fused_resize_argmax`` and
``torch.ops.cmda_tpu_torch.batched_isr`` (no ``nvcc`` is needed for that:
a kernel is built at its first CUDA call). An exported program that calls
them loads only after this import.
"""
from . import fused_resize, isr_kernel  # noqa: F401  (register the ops)
