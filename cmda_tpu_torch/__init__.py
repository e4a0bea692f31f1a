"""PyTorch/CUDA port of cmda_tpu for NVIDIA Hopper (H100).

Module names mirror ``cmda_tpu`` so each file has an obvious counterpart.
This package imports ``torch`` and never ``jax`` or ``cmda_tpu``; the JAX
package is the numerical reference that ``tests/test_torch_*.py`` hold it
against. Hand-written CUDA kernels live in ``csrc/`` and are built with
``nvcc`` at first use (``ops/_build.py``).
"""
