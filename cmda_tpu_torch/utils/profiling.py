"""Profiling utilities of the port (mirrors cmda_tpu.utils.profiling).

* ``trace(log_dir)``: a ``torch.profiler`` context over CPU and (when a
  GPU is present) CUDA activity that writes one chrome trace,
  ``<log_dir>/trace.json``, which ``tools/analyze_trace.py`` reads;
* ``StepTimer``: host-clock step times, each ended by a synchronise of
  the device its result lives on;
* ``device_memory_stats(device)``: the CUDA caching allocator's bytes in
  use, its peak and the device's total memory; ``{}`` on the CPU.

The JAX package's ``enable_compile_cache`` has no counterpart: PyTorch
runs eagerly, compiles no program, and the port's CUDA kernels are built
once into ``build/`` by ``ops/_build.py``, keyed by a hash of their source.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.utils._pytree import tree_leaves

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit write ``<log_dir>/trace.json`` (chrome
    trace format). Yields the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _sync(result):
    """Wait for the CUDA device of the first such tensor in ``result`` (a
    tensor, or a dict / list / tuple holding tensors)."""
    for leaf in tree_leaves(result):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
            return


class StepTimer:
    """Accumulates per-step host times; ``stop(result)`` first waits for
    the device that ``result``'s tensors live on."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        if result is not None:
            _sync(result)
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {"mean_s": sum(ts) / n, "p50_s": ts[n // 2],
                "min_s": ts[0], "max_s": ts[-1], "steps": n}


def device_memory_stats(device=None) -> dict:
    """``bytes_in_use``, ``peak_bytes_in_use`` (since the last
    ``torch.cuda.reset_peak_memory_stats``) and ``bytes_limit`` of a CUDA
    device (default: the current one); ``{}`` for the CPU."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return {}
    if dev is None and not torch.cuda.is_available():
        return {}
    return {"bytes_in_use": torch.cuda.memory_allocated(dev),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
            "bytes_limit": torch.cuda.get_device_properties(
                dev if dev is not None else torch.cuda.current_device()
            ).total_memory}


def timed(fn, *args, steps: int = 5, warmup: int = 2) -> StepTimer:
    """``warmup`` calls of ``fn(*args)``, then ``steps`` calls each timed
    by a ``StepTimer`` and ended by a synchronise of its result's device."""
    for _ in range(warmup):
        _sync(fn(*args))
    timer = StepTimer()
    for _ in range(steps):
        timer.start()
        timer.stop(fn(*args))
    return timer


def device_info(device) -> dict:
    """The device a measurement ran on: a CUDA card's name and power limit
    as ``nvidia-smi --query-gpu=name,power.limit`` gives them, or the
    CPU's platform."""
    import platform
    import subprocess
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"name": f"cpu ({platform.processor() or platform.machine()})",
                "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    info = {"name": torch.cuda.get_device_name(index), "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        info["power_limit"] = out.strip().split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return info
