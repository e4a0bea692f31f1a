"""Test CLI of the port: evaluate a checkpoint on the target's test split
(mIoU with the 18-class conversion), or write the DarkZurich
evaluation-server submission (mirrors tools/test.py of the JAX package;
reference tools/test.py).

    python -m cmda_tpu_torch.tools.test --config cs2dsec \\
        --checkpoint work_dirs/b5/iter_40000.pth \\
        --target-txt data/dsec/night_test_dataset_warp.txt
    python -m cmda_tpu_torch.tools.test --config tiny --synthetic \\
        --device cpu --max-samples 2
    python -m cmda_tpu_torch.tools.test --config cs2dz \\
        --checkpoint work_dirs/dz/iter_40000.pth \\
        --target-root data/dark_zurich [--inference slide] [--aug-test] \\
        [--use-teacher] [--show-dir panels/]
    python -m cmda_tpu_torch.tools.test --config cs2dz \\
        --checkpoint work_dirs/dz/iter_40000.pth \\
        --target-root data/dark_zurich --submit-to-website --show-dir sub/

``--checkpoint`` takes the port's ``iter_<n>.pth``, ``--torch-checkpoint``
a reference ``iter_40000.pth``. Evaluation prints the summary as JSON and
renames ``--show-dir`` with the score; ``main(argv)`` returns the summary
(or the submission's record). The test set follows the config's target:
DSEC-Night's (``--target-txt``, which only a DSEC target takes) is scored
at 440x640 with the train target's events bins, window and clip;
DarkZurich's val split (``--target-root``) at 540x960.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import config as C
from ..apis import init_segmentor, predict_labels, select_logits
from ..data.dark_zurich import DarkZurichDataset
from ..data.dsec import DSECDataset
from ..data.loader import host_tensor
from ..data.synthetic import SyntheticTarget
from ..train.loop import evaluate_fusion


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="cmda_tpu_torch tester",
                                allow_abbrev=False)
    p.add_argument("--config", default="cs2dsec",
                   choices=["cs2dsec", "cs2dz", "tiny"])
    p.add_argument("--checkpoint", default=None,
                   help="an iter_<n>.pth of the port's train CLI")
    p.add_argument("--torch-checkpoint", default=None,
                   help="reference iter_40000.pth (prefixes stripped as in "
                        "reference tools/test.py:165-169)")
    p.add_argument("--target-txt", default=None,
                   help="DSEC-Night test list "
                        "(night_test_dataset_warp.txt)")
    p.add_argument("--target-root", default=None,
                   help="DarkZurich root (default: the config's)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--output-type", default=None,
                   choices=["fusion", "image", "events", "isr"],
                   help="evaluation defaults to 'fusion'; the submission "
                        "for cs2dz to 'image' (reference my_test.py "
                        "test_output_type, encoder_decoder.py:914-918)")
    p.add_argument("--use-teacher", action="store_true",
                   help="the EMA teacher's parameters with the student's "
                        "BatchNorm statistics")
    p.add_argument("--show-dir", default=None)
    p.add_argument("--inference", default="whole", choices=["whole", "slide"],
                   help="slide = overlapping-crop logit accumulation "
                        "(reference encoder_decoder.py:175-218)")
    p.add_argument("--slide-crop", type=int, nargs=2, default=(512, 512))
    p.add_argument("--slide-stride", type=int, nargs=2, default=(341, 341))
    p.add_argument("--slide-crop-chunk", type=int, default=None,
                   help="max crops per forward in slide mode (default: the "
                        "whole grid in one batched forward)")
    p.add_argument("--opacity", type=float, default=None,
                   help="blend the pred colours over the image at this "
                        "opacity in --show-dir panels (reference "
                        "tools/test.py:81)")
    p.add_argument("--aug-test", action="store_true",
                   help="multi-scale (0.5..1.75) + horizontal-flip TTA, "
                        "softmax-averaged (reference tools/test.py:118-123); "
                        "whole mode only")
    p.add_argument("--submit-to-website", action="store_true")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--backbone", default="",
                   choices=["", "mit_b0", "mit_b1", "mit_b2", "mit_b3",
                            "mit_b4", "mit_b5"])
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VAL",
                   help="dotted config override (as the train CLI's)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def build_config(args) -> C.RunConfig:
    cfg = C.PRESETS[args.config]()
    if args.backbone:
        cfg = C.replace(cfg, model=C.replace(cfg.model,
                                             backbone=args.backbone))
    return C.apply_overrides(cfg, args.overrides)


def build_dataset(cfg: C.RunConfig, args):
    """8 synthetic test samples, DSEC-Night's test list, or DarkZurich's
    val split (test split for the submission) at 960x540."""
    if args.synthetic:
        return SyntheticTarget(
            crop_size=cfg.data.crop_size, length=8, test_mode=True,
            with_events=cfg.model.train_type.startswith("cs2dsec"))
    d = cfg.data
    if args.target_txt and d.target != "dsec":
        raise ValueError(f"--target-txt is the DSEC test list, and the "
                         f"{cfg.name} config's target is {d.target}")
    if d.target == "dsec":
        if not args.target_txt or args.submit_to_website:
            raise ValueError("the DSEC test set takes --target-txt, and "
                             "has no submission")
        # the train target's window, bins and clip (reference
        # my_run_experiments.py:232-238, 248-255, 352-360)
        return DSECDataset(args.target_txt, events_bins=d.events_bins,
                           isr_params=d.target_isr, test_mode=True,
                           image_change_range=d.image_change_range,
                           events_clip_range=d.events_clip_range,
                           outputs=("image", "events", "label"))
    return DarkZurichDataset(
        args.target_root or d.target_root,
        split="test" if args.submit_to_website else "val",
        isr_params=d.target_isr_3 if d.shift_3_channel else d.target_isr,
        shift_3_channel=d.shift_3_channel, auto_threshold=d.dz_auto_threshold,
        outputs=(("image", "isr") if args.submit_to_website
                 else ("image", "isr", "label")))


def main(argv=None):
    args = parse_args(argv)
    cfg = build_config(args)
    dataset = build_dataset(cfg, args)
    seg = init_segmentor(cfg, args.checkpoint or args.torch_checkpoint,
                         device=args.device, use_teacher=args.use_teacher)
    if args.submit_to_website:
        if args.output_type is None:
            args.output_type = ("fusion"
                                if cfg.model.train_type.startswith("cs2dsec")
                                else "image")
        return export_submission(seg, dataset, args, cfg)
    summary = evaluate_fusion(seg, dataset,
                              output=args.output_type or "fusion",
                              num_classes=cfg.data.num_classes,
                              max_samples=args.max_samples,
                              show_dir=args.show_dir,
                              inference=args.inference,
                              slide_crop=tuple(args.slide_crop),
                              slide_stride=tuple(args.slide_stride),
                              slide_crop_chunk=args.slide_crop_chunk,
                              aug_test=args.aug_test, opacity=args.opacity)
    print(json.dumps(summary, indent=2), flush=True)
    if args.show_dir and os.path.isdir(args.show_dir):
        # the score in the dir name (reference tools/test.py:232-233)
        scored = f"{args.show_dir.rstrip('/')}_{summary['mIoU'] * 100:.2f}"
        os.rename(args.show_dir, scored)
        summary["show_dir"] = scored
        print(json.dumps({"show_dir": scored}), flush=True)
    return summary


def export_submission(seg, dataset, args, cfg, batch_size: int = 4) -> dict:
    """The DarkZurich evaluation server's tree (reference
    tools/test.py:198-219) under ``args.show_dir`` (default
    ``submission``):
      labelTrainIds/<name>          uint8 trainIds
      labelTrainIds_invalid/<name>  the same file
      confidence/<name>             uint16, all 65535
    each resized to 1920x1080 NEAREST by PIL, ``<name>`` the frame's
    rgb_anon basename. The stream: image+events fusion for cs2dsec; for
    cs2dz the image stream, or image+ISR fusion with ``--output-type
    fusion`` (reference encoder_decoder.py:895-920). The record it prints
    and returns holds the seconds spent loading, in the model (to the
    labels on the host) and writing PNGs."""
    from PIL import Image
    out_dir = args.show_dir or "submission"
    dirs = {k: os.path.join(out_dir, k)
            for k in ("labelTrainIds", "labelTrainIds_invalid", "confidence")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    is_dsec = cfg.model.train_type.startswith("cs2dsec")
    use_fusion = is_dsec or args.output_type == "fusion"
    second_key = "events" if is_dsec else "isr"
    dev = seg.device
    seconds = {"load": 0.0, "model": 0.0, "png": 0.0}
    n = len(dataset) if args.max_samples is None else min(len(dataset),
                                                          args.max_samples)
    for start in range(0, n, batch_size):
        t0 = time.perf_counter()
        idxs = list(range(start, min(start + batch_size, n)))
        samples = [dataset[i] for i in idxs]
        image = host_tensor(np.stack([s["image"] for s in samples]))
        second = (host_tensor(np.stack([s[second_key] for s in samples]))
                  if use_fusion else None)
        t1 = time.perf_counter()
        with torch.no_grad():
            image = image.to(dev, torch.float32)
            if second is not None:
                second = second.to(dev, torch.float32)
            logits = select_logits(seg.model, image, second,
                                   "fusion" if use_fusion else "image")
            pred = predict_labels(logits, image.shape[1:3]).cpu().numpy()
        t2 = time.perf_counter()
        for j, i in enumerate(idxs):
            label = Image.fromarray(pred[j].astype(np.uint8)).resize(
                (1920, 1080), Image.NEAREST)
            conf = Image.fromarray(
                np.full(pred[j].shape, 65535, np.uint16)).resize(
                (1920, 1080), Image.NEAREST)
            name = os.path.basename(dataset.files[i])
            label.save(os.path.join(dirs["labelTrainIds"], name))
            label.save(os.path.join(dirs["labelTrainIds_invalid"], name))
            conf.save(os.path.join(dirs["confidence"], name))
        t3 = time.perf_counter()
        seconds["load"] += t1 - t0
        seconds["model"] += t2 - t1
        seconds["png"] += t3 - t2
    info = {"submitted": n, "dir": out_dir,
            "stream": "fusion" if use_fusion else "image",
            "seconds": seconds}
    print(json.dumps(info), flush=True)
    return info


if __name__ == "__main__":
    main()
