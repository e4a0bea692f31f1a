"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, which is loaded with ``ctypes``. The
library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is never
served by a stale build. Builds go under ``build/`` at the
repository root (git-ignored). Nothing here runs at import time: the CPU
tests import every module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cmda_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("fused_resize_argmax", "batched_isr", "fused_resize_ce")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report (registers, spills) and build seconds per source
build_log: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    # the source, every shared header it may include, and the flags
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every named source that has no current library, one ``nvcc``
    process per source, all started together. Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return build_log


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                build((name,))
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, error_string_fn: str, code: int, what: str):
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if code != 0:
        fn = getattr(lib, error_string_fn)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({fn(code).decode(errors='replace')})")
