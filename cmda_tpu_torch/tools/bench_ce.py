"""Microbenchmark of the port's fused upsample+CE kernels against the plain
chain (mirrors tools/bench_ce.py of the JAX package).

Times the loss and its gradient, forward plus backward, of the per-stream
loss (a bilinear upsample of stride-4 logits to the label size + a weighted
softmax CE mean; reference decode_head.py:221-239) at the flagship
[8,128,128,19] -> [8,512,512], comparing:

  * ``plain``: ``torch.utils.checkpoint`` of ``resize_ce`` (the upsample
    and the weighted CE in PyTorch, the upsampled logits recomputed in the
    backward, as the JAX ``jax.checkpoint`` chain), differentiated by
    autograd;
  * ``fused``: ``fused_resize_ce`` (the CE forward and dx kernels).

Each timed iteration ends in a synchronise; the mean after 2 warm-ups.

    python -m cmda_tpu_torch.tools.bench_ce [--batch 8] [--iters 50] \\
        [--no-weight] [--device cuda]

Prints one JSON line: ms per iteration of each, their ratio, the largest
difference of the two ``dx`` (and of the losses), and the launches of each
CE kernel in the fused tool's timed and warm-up iterations.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..apis import resolve_device
from ..ops.fused_ce import (fused_resize_ce, fused_resize_ce_dweight,
                            fused_resize_ce_dx, resize_ce)
from ..utils.profiling import device_info, timed

KERNELS = {"fused_resize_ce": fused_resize_ce,
           "fused_resize_ce_dx": fused_resize_ce_dx,
           "fused_resize_ce_dweight": fused_resize_ce_dweight}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--h", type=int, default=128)
    ap.add_argument("--w", type=int, default=128)
    ap.add_argument("--classes", type=int, default=19)
    ap.add_argument("--factor", type=int, default=4)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--no-weight", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    b, h, w, c, f = args.batch, args.h, args.w, args.classes, args.factor
    hh, ww = h * f, w * f
    g = np.random.default_rng(0)
    x0 = torch.from_numpy(g.normal(size=(b, h, w, c)).astype(np.float32)).to(dev)
    lbl = torch.from_numpy(g.integers(0, c, size=(b, hh, ww))
                           .astype(np.int32)).to(dev)
    wgt = (None if args.no_weight else torch.from_numpy(
        g.uniform(0, 1, size=(b, hh, ww)).astype(np.float32)).to(dev))

    def plain_loss(x):
        return checkpoint(resize_ce, x, lbl, wgt, use_reentrant=False)

    def fused_loss(x):
        return fused_resize_ce(x, lbl, wgt)

    def value_and_grad(loss_fn):
        def step():
            x = x0.detach().requires_grad_(True)
            val = loss_fn(x)
            (dx,) = torch.autograd.grad(val, x)
            return val.detach(), dx
        return step

    report = {}
    outs = {}
    for name, loss_fn in (("plain", plain_loss), ("fused", fused_loss)):
        step = value_and_grad(loss_fn)
        outs[name] = step()
        before = {k: fn.launches for k, fn in KERNELS.items()}
        timer = timed(step, steps=args.iters, warmup=2)
        report[f"{name}_ms"] = timer.summary()["mean_s"] * 1e3
        if name == "fused":
            report["launches"] = {k: fn.launches - before[k]
                                  for k, fn in KERNELS.items()}
    report["plain_over_fused"] = report["plain_ms"] / report["fused_ms"]
    report["max_abs_dx_diff"] = float(
        (outs["fused"][1] - outs["plain"][1]).abs().max())
    report["max_abs_dx"] = float(outs["plain"][1].abs().max())
    report["loss"] = float(outs["plain"][0])
    report["loss_diff"] = float((outs["fused"][0] - outs["plain"][0]).abs())
    out = {"metric": "fused_resize_ce_value_and_grad",
           "shape": [b, h, w, c], "labels": [b, hh, ww],
           "weighted": wgt is not None, **report,
           "device": device_info(dev)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
