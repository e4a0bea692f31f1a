"""Compact host-to-device wire format of training batches (mirrors
cmda_tpu.data.wire).

``encode_wire`` (host) turns float32 leaves into bfloat16 (torch's CPU
cast, round to nearest even), int32 labels into uint8 (trainIds 0-18 and
the ignore id 255) and a mono stream (a stride-0 broadcast over its last
axis, as ``data.loader.collate`` keeps it) into its one channel; with
``pack`` all bf16 streams of one [B, H, W] geometry are concatenated into
one ``packed::<spec>`` tensor, so a batch is two copies (floats and
labels). Every transform rides in a key (``packed::path:ch[>out],...`` or a
``mono::<ch>::`` prefix), so ``decode_wire`` applies only what the encoder
marked, and a batch that was never encoded passes through unchanged.

``decode_wire`` runs on the device as the first thing
``DACSTrainer.train_step`` does: it splits the packed tensor, widens bf16
to float32 and uint8 labels to int32, and re-broadcasts mono streams. Every
tensor it returns is contiguous (none is a view of the packed tensor or a
stride-0 broadcast), so an in-place op downstream writes each element once.
"""
from __future__ import annotations

import numpy as np
import torch

from .loader import host_tensor

_PACKED = "packed::"
_MONO = "mono::"


def _encode_leaf(key, arr):
    """(encoded CPU tensor, broadcast-to channels or 0)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.numpy()
    arr = np.asarray(arr)
    if key == "label" and arr.dtype == np.int32:
        return torch.from_numpy(arr.astype(np.uint8)), 0
    if arr.dtype == np.float32:
        out_ch = 0
        if arr.ndim >= 2 and arr.shape[-1] > 1 and arr.strides[-1] == 0:
            out_ch = arr.shape[-1]
            arr = arr[..., :1]
        return host_tensor(arr).to(torch.bfloat16), out_ch
    return host_tensor(arr), 0


def encode_wire(batch, pack: bool = True) -> dict:
    """Nested dict of numpy arrays -> the wire dict of CPU tensors."""
    out = {}
    packable = []   # (dotted path, encoded [B, H, W, c] bf16, broadcast-to)
    geom = None

    def walk(prefix, d, dst):
        nonlocal geom
        for k, v in d.items():
            if isinstance(v, dict):
                walk(prefix + k + ".", v, dst.setdefault(k, {}))
                continue
            e, out_ch = _encode_leaf(k, v)
            if (pack and e.dtype == torch.bfloat16 and e.ndim == 4
                    and (geom is None or tuple(e.shape[:3]) == geom)):
                geom = tuple(e.shape[:3])
                packable.append((prefix + k, e, out_ch))
            elif out_ch:
                dst[f"{_MONO}{out_ch}::{k}"] = e
            else:
                dst[k] = e

    walk("", batch, out)
    if len(packable) > 1:
        spec = ",".join(
            f"{p}:{a.shape[-1]}>{c}" if c else f"{p}:{a.shape[-1]}"
            for p, a, c in packable)
        out[_PACKED + spec] = torch.cat([a for _, a, _ in packable], dim=-1)
    else:
        for p, a, c in packable:
            parts = p.split(".")
            d = out
            for q in parts[:-1]:
                d = d.setdefault(q, {})
            d[f"{_MONO}{c}::{parts[-1]}" if c else parts[-1]] = a
    return {k: v for k, v in out.items() if not isinstance(v, dict) or v}


def _widen(key, x):
    if key == "label" and x.dtype != torch.int32:
        return x.to(torch.int32)
    if x.dtype == torch.bfloat16:
        return x.float()
    return x


def _decode_leaf(key, x, out_ch=0):
    x = _widen(key, x)
    if out_ch:
        x = x.expand(*x.shape[:-1], out_ch)
    return x.contiguous()


def _decode_item(key, x):
    if isinstance(x, dict):
        return key, dict(_decode_item(k, v) for k, v in x.items())
    if isinstance(key, str) and key.startswith(_MONO):
        ch, real_key = key[len(_MONO):].split("::", 1)
        return real_key, _decode_leaf(real_key, x, int(ch))
    return key, _decode_leaf(key, x)


def decode_wire(batch: dict) -> dict:
    """Inverse of ``encode_wire`` on tensors (on any device): only the
    transforms the keys mark, plus bf16 -> float32 and label -> int32."""
    out = {}
    packed = []
    for k, v in batch.items():
        if isinstance(k, str) and k.startswith(_PACKED):
            packed.append((k, v))
        else:
            k2, v2 = _decode_item(k, v)
            out[k2] = v2
    for k, v in packed:
        off = 0
        for entry in k[len(_PACKED):].split(","):
            path, ch = entry.rsplit(":", 1)
            ch, _, out_ch = ch.partition(">")
            ch = int(ch)
            parts = path.split(".")
            d = out
            for q in parts[:-1]:
                d = d.setdefault(q, {})
            d[parts[-1]] = _decode_leaf(parts[-1], v[..., off:off + ch],
                                        int(out_ch or 0))
            off += ch
    return out
