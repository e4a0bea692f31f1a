"""Single-image inference CLI of the port (mirrors tools/infer.py of the
JAX package): a preset + checkpoint + image file(s) -> prediction PNGs and
optional image|second|pred panels.

    python -m cmda_tpu_torch.tools.infer --config cs2dz \\
        --checkpoint work_dirs/dz/iter_40000.pth night1.png night2.png \\
        --out-dir preds/ [--output-type fusion] [--panel] [--use-teacher]

Writes ``<stem>_pred.png`` (uint8 trainIds), ``<stem>_color.png`` and with
``--panel`` ``<stem>_panel.png`` per image, and prints one JSON line each;
``main(argv)`` returns the predictions by path.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..apis import inference_segmentor, init_segmentor
from ..utils.visualization import colorize_label


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="cmda_tpu_torch single-image inference",
        allow_abbrev=False)
    p.add_argument("images", nargs="+", help="image file(s) to segment")
    p.add_argument("--config", default="cs2dz",
                   choices=["cs2dsec", "cs2dz", "tiny"])
    p.add_argument("--checkpoint", default=None,
                   help="an iter_<n>.pth of the port's train CLI")
    p.add_argument("--torch-checkpoint", default=None,
                   help="reference iter_40000.pth")
    p.add_argument("--output-type", default=None,
                   choices=["fusion", "image", "events", "isr"])
    p.add_argument("--use-teacher", action="store_true")
    p.add_argument("--out-dir", default="inference_out")
    p.add_argument("--panel", action="store_true",
                   help="also write image|second|pred panels")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VAL")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from PIL import Image
    args = parse_args(argv)
    seg = init_segmentor(args.config, args.checkpoint or args.torch_checkpoint,
                         device=args.device, output=args.output_type,
                         use_teacher=args.use_teacher,
                         overrides=args.overrides)
    os.makedirs(args.out_dir, exist_ok=True)
    preds = {}
    for path in args.images:
        stem = os.path.splitext(os.path.basename(path))[0]
        panel = (os.path.join(args.out_dir, f"{stem}_panel.png")
                 if args.panel else None)
        pred = inference_segmentor(seg, path, out_file=panel)
        Image.fromarray(pred.astype(np.uint8)).save(
            os.path.join(args.out_dir, f"{stem}_pred.png"))
        Image.fromarray(colorize_label(pred)).save(
            os.path.join(args.out_dir, f"{stem}_color.png"))
        print(json.dumps({"image": path, "pred": f"{stem}_pred.png",
                          "classes": sorted(set(pred.reshape(-1).tolist()))}),
              flush=True)
        preds[path] = pred
    return preds


if __name__ == "__main__":
    main()
