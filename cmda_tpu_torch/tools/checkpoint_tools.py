"""Checkpoint and work-dir utilities for the port's torch checkpoints
(mirrors tools/checkpoint_tools.py of the JAX package):

* ``publish``: strip the AdamW state, the EMA teacher and the frozen
  ImageNet encoder from an ``iter_<n>.pth``, keep the student
  (``state_dict``), ``step`` and ``meta``, and append the first 8 hex
  digits of a hash of the content to the file name (reference
  tools/publish_model.py:20-30);
* ``convert``: the student's ``state_dict`` alone (reference
  function.py:29-38 ``convert_pth``);
* ``param-count``: parameters per top-level module of a preset's
  segmentor (reference tools/get_param_count.py:24-36), built on the
  ``meta`` device, so no weights are allocated;
* ``rename-work-dirs``: append the last evaluation's mIoU (the newest
  ``test_results_<iter>_<mIoU>`` dir) to each work dir's name (reference
  function.py:5-27).

Each output loads with ``apis.init_segmentor(checkpoint=...)``.

    python -m cmda_tpu_torch.tools.checkpoint_tools publish iter_40000.pth out.pth
    python -m cmda_tpu_torch.tools.checkpoint_tools convert iter_40000.pth student.pth
    python -m cmda_tpu_torch.tools.checkpoint_tools param-count --config cs2dsec
    python -m cmda_tpu_torch.tools.checkpoint_tools rename-work-dirs --root work_dirs
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re

import torch

from .. import config as C
from ..models.segmentor import FusionEncoderDecoder

PUBLISHED_KEYS = ("state_dict", "step", "meta")


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def content_hash(ckpt: dict) -> str:
    """The first 8 hex digits of a SHA-256 over the tensors' names, dtypes,
    shapes and bytes and the other entries' JSON."""
    h = hashlib.sha256()

    def feed(prefix, value):
        if isinstance(value, torch.Tensor):
            t = value.detach().cpu().contiguous()
            h.update(f"{prefix}:{t.dtype}:{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        elif isinstance(value, dict):
            for k in sorted(value, key=str):
                feed(f"{prefix}/{k}", value[k])
        else:
            h.update(f"{prefix}={json.dumps(value, default=str)}".encode())
    feed("", ckpt)
    return h.hexdigest()[:8]


def publish(in_path: str, out_path: str) -> str:
    """Write the student, ``step`` and ``meta`` of ``in_path`` to
    ``<out_path without .pth>-<hash>.pth``; returns that path."""
    ckpt = _load(in_path)
    kept = {k: ckpt[k] for k in PUBLISHED_KEYS if k in ckpt}
    stem = out_path[:-4] if out_path.endswith(".pth") else out_path
    final = f"{stem}-{content_hash(kept)}.pth"
    torch.save(kept, final)
    print(json.dumps({"published": final, "kept": sorted(kept),
                      "dropped": sorted(set(ckpt) - set(kept))}))
    return final


def convert(in_path: str, out_path: str) -> str:
    """Write the student's ``state_dict`` alone to ``out_path``."""
    ckpt = _load(in_path)
    torch.save({"state_dict": ckpt["state_dict"]}, out_path)
    print(json.dumps({"converted": out_path, "kept": ["state_dict"]}))
    return out_path


def param_count(config_name: str) -> dict:
    """{top-level module: parameter count, 'TOTAL': their sum} of the
    preset's segmentor."""
    cfg = C.PRESETS[config_name]()
    with torch.device("meta"):
        model = FusionEncoderDecoder(cfg.model, dtype=cfg.dtype)
    counts = {}
    for name, child in model.named_children():
        n = sum(p.numel() for p in child.parameters())
        if n:
            counts[name] = n
    counts["TOTAL"] = sum(counts.values())
    print(json.dumps(counts, indent=2))
    return counts


def rename_work_dirs(root: str) -> list:
    """Append ``[mIoU]`` from the last ``test_results_<iter>_<score>``."""
    renamed = []
    if not os.path.isdir(root):
        return renamed
    for wd in sorted(os.listdir(root)):
        path = os.path.join(root, wd)
        if not os.path.isdir(path) or ("[" in wd and "]" in wd):
            continue
        results = sorted(
            (d for d in os.listdir(path)
             if re.match(r"test_results_\d+_[\d.]+$", d)),
            key=lambda d: int(d.split("_")[2]))
        if not results:
            continue
        score = results[-1].rsplit("_", 1)[1]
        dst = f"{path}[{score}]"
        os.rename(path, dst)
        renamed.append(dst)
    print(json.dumps({"renamed": renamed}))
    return renamed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("publish")
    p.add_argument("in_path")
    p.add_argument("out_path")
    p = sub.add_parser("convert")
    p.add_argument("in_path")
    p.add_argument("out_path")
    p = sub.add_parser("param-count")
    p.add_argument("--config", default="cs2dsec", choices=sorted(C.PRESETS))
    p = sub.add_parser("rename-work-dirs")
    p.add_argument("--root", default="work_dirs")
    args = ap.parse_args(argv)
    if args.cmd == "publish":
        return publish(args.in_path, args.out_path)
    if args.cmd == "convert":
        return convert(args.in_path, args.out_path)
    if args.cmd == "param-count":
        return param_count(args.config)
    return rename_work_dirs(args.root)


if __name__ == "__main__":
    main()
