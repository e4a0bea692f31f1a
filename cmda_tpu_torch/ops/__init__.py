"""Tensor ops of the port: resize, ISR, the CUDA kernel wrappers and metrics."""
