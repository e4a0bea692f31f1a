"""Input pipeline: batching, background loading and the host-to-device feed
(mirrors cmda_tpu.data.loader and cmda_tpu.train.loop.device_prefetch).

* ``collate`` preallocates each batch and ``np.copyto``s the samples into
  it; a mono stream (a stride-0 broadcast over its last axis in every
  sample) stays one ``[B, ..., 1]`` buffer re-broadcast to ``[B, ..., C]``,
  so ``data.wire.encode_wire`` can ship one channel.
* ``PrefetchLoader``: worker threads, each with its own
  ``random.Random(seed * 1000 + wid)`` and bounded queue; the consumer
  takes the queues in turn, so the batch stream depends only on
  ``(seed, num_workers)``. A sample that fails raises in the consumer (no
  retry that would draw other indices).
* ``device_prefetch``: host batches as contiguous tensors on the device,
  ``depth`` batches ahead. On CUDA each batch goes through a pinned host
  buffer and a ``non_blocking`` copy on a copy stream; the consuming
  stream waits on the copy's event, and a pinned buffer is refilled only
  once its previous copy has finished.
"""
from __future__ import annotations

import queue
import random
import threading
from collections import deque

import numpy as np
import torch


def collate(samples: list) -> dict:
    """List of nested dicts of numpy arrays -> nested dict of batch arrays
    (preallocated, filled by ``np.copyto``). A slot whose every sample is a
    stride-0 broadcast over its last axis is stored as one contiguous
    [B, ..., 1] buffer and returned re-broadcast to [B, ..., C]."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: collate([s[k] for s in samples]) for k in first}
    first = np.asarray(first)
    if (first.ndim >= 1 and first.shape[-1] > 1 and first.strides[-1] == 0
            and all(np.asarray(s).strides[-1] == 0 for s in samples)):
        out = np.empty((len(samples),) + first.shape[:-1] + (1,), first.dtype)
        for j, s in enumerate(samples):
            np.copyto(out[j], np.asarray(s)[..., :1])
        return np.broadcast_to(out, (len(samples),) + first.shape)
    out = np.empty((len(samples),) + first.shape, first.dtype)
    for j, s in enumerate(samples):
        np.copyto(out[j], s)
    return out


class PrefetchLoader:
    """Infinite batched loader with background worker threads.

    ``dataset.load(idx, rng=...)`` (or ``dataset[idx]``) gives a nested
    dict of numpy arrays; batches are drawn with replacement. Worker ``w``
    draws its indices and every random choice of ``load`` from
    ``random.Random(seed * 1000 + w)`` and fills its own queue; ``next``
    takes the queues in turn."""

    def __init__(self, dataset, batch_size: int, *, num_workers: int = 4,
                 prefetch: int = 4, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self._stop = threading.Event()
        self._seed = seed
        n_workers = max(num_workers, 1)
        self.queues = [queue.Queue(maxsize=max(prefetch, 1))
                       for _ in range(n_workers)]
        self._next_q = 0
        self.workers = [
            threading.Thread(target=self._worker, args=(w,), daemon=True)
            for w in range(n_workers)]
        for w in self.workers:
            w.start()

    def _worker(self, wid: int):
        rng = random.Random(self._seed * 1000 + wid)
        n = len(self.dataset)
        out = self.queues[wid]
        fetch = getattr(self.dataset, "load", None)
        while not self._stop.is_set():
            idxs = [rng.randrange(n) for _ in range(self.batch_size)]
            try:
                if fetch is not None:
                    batch = collate([fetch(i, rng=rng) for i in idxs])
                else:
                    batch = collate([self.dataset[i] for i in idxs])
            except Exception as e:  # noqa: BLE001 — raised by the consumer
                batch = e
            while not self._stop.is_set():
                try:
                    out.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return

    def __iter__(self):
        return self

    def __next__(self):
        item = self.queues[self._next_q].get()
        self._next_q = (self._next_q + 1) % len(self.queues)
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        """Stop the workers and wait for them (a worker blocked on a full
        queue sees the stop flag within its 0.5 s put timeout)."""
        self._stop.set()
        for q in self.queues:
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        for w in self.workers:
            w.join(timeout=5.0)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def host_tensor(x) -> torch.Tensor:
    """A numpy array or CPU tensor as a contiguous CPU tensor (a broadcast
    or read-only array is copied; a contiguous writable one is shared)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous()
    x = np.asarray(x)
    if not (x.flags.c_contiguous and x.flags.writeable):
        x = np.array(x, order="C")
    return torch.from_numpy(x)


def device_put_batch(batch, device) -> dict:
    """A nested dict of host arrays -> the same dict of contiguous tensors
    on ``device`` (a synchronous copy)."""
    return _tree_map(lambda x: host_tensor(x).to(device), batch)


def _pinned_like(x, old):
    """A pinned CPU tensor of ``x``'s shape and dtype: ``old`` if it
    matches, else a new one."""
    shape = tuple(x.shape)
    dtype = (x.dtype if isinstance(x, torch.Tensor)
             else torch.from_numpy(np.empty(0, x.dtype)).dtype)
    if old is not None and tuple(old.shape) == shape and old.dtype == dtype:
        return old
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _fill(dst: torch.Tensor, x):
    if isinstance(x, torch.Tensor):
        dst.copy_(x)
    else:
        np.copyto(dst.numpy(), x)


def _pinned_batch(batch, old):
    if isinstance(batch, dict):
        return {k: _pinned_batch(v, old.get(k) if isinstance(old, dict)
                                 else None) for k, v in batch.items()}
    dst = _pinned_like(batch, old)
    _fill(dst, batch)
    return dst


def device_prefetch(host_batches, device, depth: int = 1):
    """Yield each host batch of ``host_batches`` (nested dicts of numpy
    arrays or CPU tensors) as contiguous tensors on ``device``, with the
    copies of the next ``depth`` batches already issued.

    On CUDA a batch is copied into a pinned host buffer (a ring of
    ``depth + 1`` buffer sets; a set is refilled only after its previous
    copy's event has completed), then to the device with
    ``non_blocking=True`` on a copy stream. When a batch is handed out, the
    current stream waits on its copy's event and its tensors are recorded
    as used there. On the CPU each batch is placed as it is drawn."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in host_batches:
            yield device_put_batch(batch, device)
        return
    depth = max(depth, 0)
    copy_stream = torch.cuda.Stream(device)
    ring = [None] * (depth + 1)        # (pinned batch, copy-done event)
    pending = deque()

    def hand_out(dev, done):
        current = torch.cuda.current_stream(device)
        current.wait_event(done)
        for t in _leaves(dev):
            t.record_stream(current)
        return dev

    for n, batch in enumerate(host_batches):
        slot = n % len(ring)
        old = None
        if ring[slot] is not None:
            old, last_copy = ring[slot]
            last_copy.synchronize()
        pinned = _pinned_batch(batch, old)
        with torch.cuda.stream(copy_stream):
            dev = _tree_map(lambda t: t.to(device, non_blocking=True), pinned)
            done = torch.cuda.Event()
            done.record(copy_stream)
        ring[slot] = (pinned, done)
        pending.append((dev, done))
        if len(pending) > depth:
            yield hand_out(*pending.popleft())
    while pending:
        yield hand_out(*pending.popleft())
