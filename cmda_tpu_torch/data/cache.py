"""LRU over decoded base frames (mirrors cmda_tpu.data.cache).

Every random part of a draw (crop, flip, ISR direction, events clip, resize)
acts on the decoded base frame after the decode, so memoising the decode and
its fixed resize leaves every sample as it was. Capacity counts entries (one
decoded frame each) and is 0 (off) by default; ``data.decode_cache`` sets
it for both datasets.
"""
from __future__ import annotations

import threading
from collections import OrderedDict


class DecodeCache:
    """Thread-safe LRU: ``get(key, fn)`` returns the cached value or computes
    and stores it; a capacity <= 0 caches nothing."""

    def __init__(self, capacity: int = 0):
        self.capacity = int(capacity)
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, fn):
        if self.capacity <= 0:
            return fn()
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
        val = fn()   # the decode runs outside the lock
        with self._lock:
            self._d[key] = val
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
        return val
