"""Serving artifact of the port: the whole-inference forward exported once
with ``torch.export`` and run later without the model's code (mirrors
tools/export_model.py of the JAX package).

    # export the forward at the DSEC eval geometry, for the CPU and CUDA
    python -m cmda_tpu_torch.tools.export_model export out.cmda \\
        --config cs2dsec [--checkpoint iter_40000.pth] --verify
    # reload the artifact and run it on seeded random inputs
    python -m cmda_tpu_torch.tools.export_model run out.cmda

The exported function is the port's ``Segmentor.__call__`` path at a fixed
batch and geometry: (image, second) NHWC float32 -> (logits at the input
size [B, H, W, C] float32, prediction [B, H, W] int32). The prediction
comes from the stride-4 logits through the custom op
``cmda_tpu_torch::fused_resize_argmax`` (the CUDA kernel on the card, its
plain version on the CPU), which is the argmax of the input-size logits.

Artifact layout: ``<name>/fn_<platform>.pt2`` (``torch.export.save``), one
program per platform of ``--platforms`` (default ``cpu,cuda``), and
``<name>/meta.json``. A program holds its weights on its own device: the
CUDA program needs a GPU to load. Unlike the JAX artifact, it needs the
port to load: ``import cmda_tpu_torch.ops`` registers the custom ops it
calls (``meta.json`` lists them under ``custom_ops``); no model code runs.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

from ..apis import init_segmentor, resolve_device, select_logits
from ..ops.fused_resize import fused_resize_argmax
from ..ops.resize import resize_bilinear
from ..train.loop import CLASS_NAMES

OPS_MODULE = "cmda_tpu_torch.ops"
RUN_REPS = 3    # the timed calls of ``run``


class ServingForward(torch.nn.Module):
    """The exported function: the ``output`` stream's logits at the input
    size and its prediction through the fused upsample+argmax op."""

    def __init__(self, model, output: str, with_second: bool):
        super().__init__()
        self.model = model
        self.output = output
        self.with_second = with_second

    def forward(self, image, second):
        size = tuple(image.shape[1:3])
        logits = select_logits(self.model, image,
                               second if self.with_second else None,
                               self.output)
        label, _ = fused_resize_argmax(logits.contiguous(), size,
                                       with_prob=False)
        return resize_bilinear(logits, size), label


def program_path(artifact: str, platform: str) -> str:
    return os.path.join(artifact, f"fn_{platform}.pt2")


def _inputs(shape, device, seed: int = 0):
    g = np.random.default_rng(seed)
    return tuple(torch.from_numpy(g.normal(size=shape).astype(np.float32))
                 .to(device) for _ in range(2))


def _custom_ops(program) -> list[str]:
    """The ``cmda_tpu_torch`` ops that an exported program calls."""
    names = set()
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith(
                "cmda_tpu_torch."):
            names.add(str(node.target).rsplit(".", 1)[0])
    return sorted(names)


def export_artifact(args) -> dict:
    """Export one program per platform of ``args.platforms`` into
    ``args.artifact``, write ``meta.json``; with ``args.verify`` reload the
    program of ``args.device`` and hold it against the eager forward
    (logits to 1e-4, labels equal)."""
    platforms = args.platforms.split(",")
    seg = init_segmentor(args.config, args.checkpoint or args.torch_checkpoint,
                         device=args.device, output=args.output,
                         overrides=args.set or ())
    cfg = seg.cfg
    with_second = not args.image_only
    fwd = ServingForward(seg.model, seg.output, with_second).eval()
    shape = (args.batch, args.height, args.width, 3)
    os.makedirs(args.artifact, exist_ok=True)
    export_s, ops = {}, []
    for platform in platforms:
        dev = resolve_device(platform)
        mod = fwd if dev == seg.device else copy.deepcopy(fwd).to(dev)
        example = _inputs(shape, dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            program = torch.export.export(mod, example)
        export_s[platform] = time.perf_counter() - t0
        ops = _custom_ops(program)
        torch.export.save(program, program_path(args.artifact, platform))
    meta = {
        "framework": "cmda_tpu_torch",
        "train_type": cfg.model.train_type,
        "backbone": cfg.model.backbone,
        "dtype": cfg.dtype,
        "output_stream": seg.output,
        "with_second": with_second,
        "input_shape": list(shape),
        "platforms": platforms,
        "files": {p: os.path.basename(program_path(args.artifact, p))
                  for p in platforms},
        "num_classes": cfg.data.num_classes,
        "classes": list(CLASS_NAMES[:cfg.data.num_classes]),
        "custom_ops": ops,
        "load_requires": f"import {OPS_MODULE}",
    }
    with open(os.path.join(args.artifact, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    report = {"artifact": args.artifact, **meta, "export_s": export_s}
    print(json.dumps(report), flush=True)
    if args.verify:
        report["verify"] = verify(args.artifact, fwd, seg.device)
        print(json.dumps({"verified": True, **report["verify"]}), flush=True)
    return report


def load_program(artifact: str, device) -> torch.nn.Module:
    """The artifact's program for ``device`` as a callable module."""
    dev = torch.device(device)
    path = program_path(artifact, dev.type)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{artifact} holds no program for {dev.type} "
                                f"(no {os.path.basename(path)})")
    return torch.export.load(path).module()


@torch.no_grad()
def verify(artifact: str, fwd: torch.nn.Module, device) -> dict:
    """Reload ``artifact``'s program for ``device`` and hold it against the
    eager ``fwd`` on seeded inputs: logits to 1e-4, labels equal."""
    with open(os.path.join(artifact, "meta.json")) as f:
        meta = json.load(f)
    inputs = _inputs(tuple(meta["input_shape"]), device, seed=1)
    logits_live, pred_live = fwd(*inputs)
    logits_art, pred_art = load_program(artifact, device)(*inputs)
    err = float((logits_live - logits_art).abs().max())
    np.testing.assert_allclose(logits_art.cpu().numpy(),
                               logits_live.cpu().numpy(), atol=1e-4)
    np.testing.assert_array_equal(pred_art.cpu().numpy(),
                                  pred_live.cpu().numpy())
    return {"device": str(device), "max_abs_logit_diff": err}


@torch.no_grad()
def run_artifact(args) -> dict:
    """Call the artifact's program for ``args.device`` on seeded random
    inputs: shapes, the classes predicted, the custom ops its graph calls,
    the argmax kernel's launches in each call, and the median of RUN_REPS
    timed calls (each ended by a synchronise) after the first."""
    with open(os.path.join(args.artifact, "meta.json")) as f:
        meta = json.load(f)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    fn = load_program(args.artifact, dev)
    load_s = time.perf_counter() - t0
    inputs = _inputs(tuple(meta["input_shape"]), dev)
    launches, times = [], []
    for rep in range(1 + RUN_REPS):
        before = fused_resize_argmax.launches
        t0 = time.perf_counter()
        logits, pred = fn(*inputs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if rep:
            times.append((time.perf_counter() - t0) * 1e3)
        launches.append(fused_resize_argmax.launches - before)
    report = {
        "artifact": args.artifact, "device": str(dev),
        "custom_ops": _custom_ops(fn),
        "logits_shape": list(logits.shape), "pred_shape": list(pred.shape),
        "pred_dtype": str(pred.dtype).replace("torch.", ""),
        "logits_finite": bool(torch.isfinite(logits).all()),
        "pred_classes": sorted(set(pred.cpu().numpy().ravel().tolist()))[:10],
        "argmax_launches_per_call": launches,
        "load_s": load_s,
        "call_ms": float(np.median(times)) if times else None,
    }
    print(json.dumps(report), flush=True)
    return report


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("export", help="export the inference forward")
    ex.add_argument("artifact")
    ex.add_argument("--config", default="cs2dsec",
                    choices=["cs2dsec", "cs2dz", "tiny", "micro"])
    ex.add_argument("--checkpoint", help="an iter_<n>.pth of the port")
    ex.add_argument("--torch-checkpoint", help="reference iter_40000.pth")
    ex.add_argument("--output", default=None,
                    help="logit stream (fusion/image/events/isr)")
    ex.add_argument("--image-only", action="store_true",
                    help="export the image-stream-only forward")
    ex.add_argument("--batch", type=int, default=1)
    ex.add_argument("--height", type=int, default=440)
    ex.add_argument("--width", type=int, default=640)
    ex.add_argument("--platforms", default="cpu,cuda",
                    help="comma-separated devices, one program each")
    ex.add_argument("--set", nargs="*", help="config dotted overrides")
    ex.add_argument("--verify", action="store_true",
                    help="reload the program of --device and compare it "
                         "with the eager model")
    ex.add_argument("--device", default="cuda",
                    help="where the model is built and --verify runs")
    ex.set_defaults(func=export_artifact)
    rn = sub.add_parser("run", help="load and run an artifact")
    rn.add_argument("artifact")
    rn.add_argument("--device", default="cuda")
    rn.set_defaults(func=run_artifact)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    main()
