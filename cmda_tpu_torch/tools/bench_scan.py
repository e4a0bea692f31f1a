"""Microbenchmark of MiT-b5's stage 3, the b5 hot loop (mirrors
tools/bench_scan.py of the JAX package).

Times the stage (depth 40, dim 320, 5 heads, spatial reduction 2, 32x32
tokens, batch 8, bfloat16) as the port runs it, a loop of ``MiTBlock``s
with injected drop-path uniforms: the forward alone (no gradients
recorded), and forward plus backward of the output's sum with remat none,
full and ``dots`` (``models/common.py``: the linears' outputs saved, the
rest recomputed). Reports ms (mean of ``--steps`` after 2 warm-ups, each
ended by a synchronise) and the peak GiB of device memory of each.

    python -m cmda_tpu_torch.tools.bench_scan [--batch 8] [--tokens 1024] \\
        [--dim 320] [--depth 40] [--device cuda]

The JAX tool's ``--unrolls`` and ``--split-transpose`` set ``lax.scan``
schedule options; the port runs its blocks as a loop, with no scan, so it
refuses them (ROADMAP C4).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..apis import resolve_device
from ..models.common import init_weights, maybe_checkpoint
from ..models.mit import MiTBlock
from ..utils.profiling import device_info, timed

REMATS = {"none": (False, "full"), "full": (True, "full"),
          "dots": (True, "dots")}


class Stage(torch.nn.Module):
    """``depth`` MiT blocks run one after another, each with its slice of
    the drop-path uniforms ``u`` [depth, 2, B]; stochastic depth ramps
    from 0 to ``max_rate`` over the stage."""

    def __init__(self, depth, dim, heads, sr, max_rate=0.1):
        super().__init__()
        self.blocks = torch.nn.ModuleList([
            MiTBlock(dim, heads, 4, sr, True, 0.0, 0.0,
                     max_rate * i / max(depth - 1, 1))
            for i in range(depth)])
        self.remat, self.policy = False, "full"

    def forward(self, x, hw, u):
        for blk, ub in zip(self.blocks, u):
            x = maybe_checkpoint(blk, x, hw, ub, remat=self.remat,
                                 policy=self.policy)
        return x


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=1024)   # the 32x32 grid
    ap.add_argument("--dim", type=int, default=320)
    ap.add_argument("--depth", type=int, default=40)
    ap.add_argument("--heads", type=int, default=5)
    ap.add_argument("--sr", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--unrolls", default=None, help="refused (C4)")
    ap.add_argument("--split-transpose", default=None, help="refused (C4)")
    args = ap.parse_args(argv)
    for flag in ("unrolls", "split_transpose"):
        if getattr(args, flag) is not None:
            ap.error(f"--{flag.replace('_', '-')} sets a lax.scan schedule "
                     "option of the JAX package; the port runs the stage "
                     "as a loop of blocks, with no scan (ROADMAP C4)")

    dev = resolve_device(args.device)
    side = int(round(args.tokens ** 0.5))
    if side * side != args.tokens:
        ap.error(f"--tokens {args.tokens} is not a square grid")
    hw = (side, side)
    with torch.device(dev):
        stage = Stage(args.depth, args.dim, args.heads, args.sr)
    init_weights(stage, torch.Generator(device=dev).manual_seed(0))
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.normal(size=(args.batch, args.tokens, args.dim))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    u = torch.from_numpy(g.uniform(size=(args.depth, 2, args.batch))
                         .astype(np.float32)).to(dev)
    cuda = dev.type == "cuda"

    def peak_gib(fn):
        if not cuda:
            return None
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize(dev)
        return torch.cuda.max_memory_allocated(dev) / 2 ** 30

    @torch.no_grad()
    def fwd():
        return stage(x, hw, u)

    def grad():
        stage.zero_grad(set_to_none=True)
        xs = x.detach().requires_grad_(True)
        stage(xs, hw, u).float().sum().backward()
        return xs.grad

    report = {"fwd_ms": timed(fwd, steps=args.steps).summary()["mean_s"] * 1e3,
              "fwd_peak_gib": peak_gib(fwd)}
    for name, (remat, policy) in REMATS.items():
        stage.remat, stage.policy = remat, policy
        report[f"grad_{name}_ms"] = timed(
            grad, steps=args.steps).summary()["mean_s"] * 1e3
        report[f"grad_{name}_peak_gib"] = peak_gib(grad)
    out = {"metric": "mit_stage_loop",
           "shape": {"batch": args.batch, "tokens": args.tokens,
                     "dim": args.dim, "depth": args.depth,
                     "heads": args.heads, "sr": args.sr,
                     "dtype": "bfloat16"},
           **report, "device": device_info(dev)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
