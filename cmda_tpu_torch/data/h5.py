"""Slices of the DSEC ``events.h5`` datasets (the port's counterpart of
cmda_tpu.data.native_h5.read_slice).

One path: h5py reads and decompresses the slice. Every libhdf5 call, the
dataset lookup and its metadata included, runs under the caller's lock, so
loader threads that share one ``h5py.File`` never interleave inside
libhdf5. A failure raises.
"""
from __future__ import annotations

import numpy as np


def read_slice(group, name: str, start: int, stop: int,
               lock) -> np.ndarray:
    """``group[name][start:stop]`` of a 1-D dataset, as one numpy array,
    with the lookup and the read under ``lock`` (a ``threading.Lock``)."""
    with lock:
        return group[name][int(start):int(stop)]
