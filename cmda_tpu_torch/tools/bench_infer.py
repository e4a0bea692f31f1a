"""Inference throughput of the port's whole-inference serving path (mirrors
tools/bench_infer.py of the JAX package).

Times ``FusionEncoderDecoder`` whole inference as the test CLI and the
serving API run it: the fusion stream's stride-4 logits, then
``predict_labels`` (the fused upsample+argmax kernel), at the DSEC eval
geometry (440x640) for batch 1 and ``--batch``; with ``--slide`` also the
sliding-window inference at the DarkZurich submission geometry (1080x1920,
512 crops, stride 341). The model is the b5 cs2dsec preset in bfloat16
with random weights (seed 0) and no CycleGAN. Each timed run ends in a
synchronise; the mean over ``--steps`` runs after 2 warm-up runs.

    python -m cmda_tpu_torch.tools.bench_infer [--batch 8] [--steps 20] \\
        [--slide] [--config cs2dsec] [--device cuda]

Prints one JSON line: ``batch{b}_ms``, ``batch{b}_samples_per_s``,
``slide_1080x1920_ms`` / ``_fps``, the device (name and power limit) and
the argmax kernel's launches per whole-inference call.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import config as C
from ..apis import build_model, predict_labels, resolve_device, select_logits
from ..models.segmentor import slide_inference
from ..ops.fused_resize import fused_resize_argmax
from ..ops.resize import resize_bilinear
from ..utils.profiling import device_info, timed

# the slide geometry (reference encoder_decoder.py:175-218): DarkZurich's
# submission frames, the reference's crop and stride
SLIDE = {"frame": (1080, 1920), "crop": (512, 512), "stride": (341, 341)}


def bench_config(name: str) -> C.RunConfig:
    """The preset in bfloat16, the CycleGAN off."""
    cfg = C.PRESETS[name]()
    return C.replace(cfg, dtype="bfloat16", uda=C.replace(
        cfg.uda, use_cyclegan_day_events=False))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--height", type=int, default=440)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--slide", action="store_true",
                    help="also time slide inference at 1080x1920")
    ap.add_argument("--config", default="cs2dsec",
                    choices=sorted(C.PRESETS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = bench_config(args.config)
    model = build_model(cfg, dev, seed=0)
    g = np.random.default_rng(0)

    def normal(*shape):
        return torch.from_numpy(g.normal(size=shape).astype(np.float32)).to(dev)

    @torch.no_grad()
    def infer(img, ev):
        logits = select_logits(model, img, ev, "fusion")
        return predict_labels(logits, img.shape[1:3])

    report = {}
    calls, launches = 0, 0
    for b in sorted({1, args.batch}):
        img = normal(b, args.height, args.width, 3)
        ev = normal(b, args.height, args.width, 3)
        before = fused_resize_argmax.launches
        timer = timed(infer, img, ev, steps=args.steps)
        launches += fused_resize_argmax.launches - before
        calls += args.steps + 2
        dt = timer.summary()["mean_s"]
        report[f"batch{b}_ms"] = dt * 1e3
        report[f"batch{b}_samples_per_s"] = b / dt
    if args.slide:
        num_classes = cfg.data.num_classes

        def crop_logits(x):
            return resize_bilinear(select_logits(model, x[..., :3], x[..., 3:],
                                                 "fusion"), x.shape[1:3])

        @torch.no_grad()
        def slide(both):
            return slide_inference(crop_logits, both, crop_size=SLIDE["crop"],
                                   stride=SLIDE["stride"],
                                   num_classes=num_classes).argmax(dim=-1)

        both = normal(1, *SLIDE["frame"], 6)
        dt = timed(slide, both, steps=4, warmup=1).summary()["mean_s"]
        h, w = SLIDE["frame"]
        report[f"slide_{h}x{w}_ms"] = dt * 1e3
        report[f"slide_{h}x{w}_fps"] = 1.0 / dt
    out = {"metric": "fusion_whole_inference",
           "unit": f"MiT {cfg.model.backbone} fusion whole inference, "
                   f"{args.height}x{args.width}, {cfg.dtype}",
           **report, "device": device_info(dev),
           "argmax_launches_per_call": launches / calls}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
