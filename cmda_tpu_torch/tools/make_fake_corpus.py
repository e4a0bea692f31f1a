"""Write a Cityscapes, DSEC-Night and DarkZurich corpus on disk, in the real
trees' layouts (mirrors the JAX package's tools/make_fake_corpus.py and
tools/bench_ingest.py writers: the same files from the same seeds at their
default sizes), so the train and test CLIs can run on real files without a
download:

    python -m cmda_tpu_torch.tools.make_fake_corpus --root /tmp/corpus \\
        [--images 6] [--cityscapes-size 2048 1024] [--frames 8] \\
        [--events-per-window 500000] [--dark-zurich-size 1920 1080]

It prints one JSON line with the roots and list files the CLIs take:
``--source-root`` and ``--rcs-json-dir`` (cityscapes), ``--target-txt``
and ``--val-txt`` (DSEC), ``--target-root`` (dark_zurich).

* cityscapes: ``leftImg8bit/train/faketown/*_leftImg8bit.png``, the
  ``leftImg8bit_IC1`` temporal-difference PNGs, ``gtFine`` labelTrainIds
  and the two Rare Class Sampling JSONs (``sample_class_stats_dict.json``,
  ``samples_with_class.json``); labels are 64-pixel blocks.
* dsec: one sequence ``zurich_city_09_x`` at the sensor's 640x480: rectified
  and warped frames, a gzip-chunked ``events/left/events.h5`` (t, x, y, p),
  ``rectify_map.h5``, ``images_to_events_index.txt``, labels, the train
  list ``night_dataset_warp.txt`` and the test list
  ``night_test_dataset_warp.txt``.
* dark_zurich: ``rgb_anon/{train,val,test}/night/seq01`` and the val
  labels under ``gt/val/night/seq01``.

A frame's colour is a noisy function of its label: bright for the day
source, dimmed with a blue cast at night.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
from PIL import Image

DSEC_SIZE = (640, 480)   # (W, H), the DSEC event camera's frame
DSEC_CHUNK = 65536

# class-keyed colours: the day source and the night targets render the
# same labels, so a source-trained model has something to adapt
_PALETTE = np.stack([
    np.array([(50 + 11 * c) % 256, (210 - 9 * c) % 256, (37 * c + 20) % 256],
             np.float64) for c in range(19)])


def _day_image(g, lbl):
    img = _PALETTE[lbl] + g.normal(0.0, 18.0, lbl.shape + (3,))
    return np.clip(img, 0, 255).astype(np.uint8)


def _night_image(g, lbl):
    img = 0.35 * _PALETTE[lbl] + np.array([0.0, 0.0, 40.0])
    img = img + g.normal(0.0, 12.0, lbl.shape + (3,))
    return np.clip(img, 0, 255).astype(np.uint8)


def _blocks(g, rows, cols, block):
    """A [rows * block, cols * block] label map of uniform class blocks."""
    return np.repeat(np.repeat(
        g.integers(0, 19, (rows, cols)).astype(np.uint8), block, axis=0),
        block, axis=1)


def fabricate_cityscapes(root: str, n_images: int = 6,
                         size=(512, 256)) -> str:
    """leftImg8bit/train + leftImg8bit_IC1 + gtFine + the RCS JSONs of
    ``n_images`` frames of ``size`` (W, H); returns ``root``."""
    g = np.random.default_rng(0)
    img_dir = os.path.join(root, "leftImg8bit", "train", "faketown")
    ic_dir = os.path.join(root, "leftImg8bit_IC1", "train", "faketown")
    gt_dir = os.path.join(root, "gtFine", "train", "faketown")
    for d in (img_dir, ic_dir, gt_dir):
        os.makedirs(d, exist_ok=True)
    w, h = size
    stats_dict, with_class = {}, {}
    for i in range(n_images):
        name = f"faketown_{i:06d}_000019_leftImg8bit.png"
        path = os.path.join(img_dir, name)
        lbl = _blocks(g, h // 64, w // 64, 64)[:h, :w]
        Image.fromarray(_day_image(g, lbl)).save(path)
        ic_name = name.replace("leftImg8bit", "leftImg8bit_IC1")[:-8] + ".png"
        Image.fromarray(g.integers(0, 255, (h, w), np.uint8)
                        .astype(np.uint8)).save(os.path.join(ic_dir, ic_name))
        lbl_name = name.replace("leftImg8bit", "gtFine")[:-4] \
            + "_labelTrainIds.png"
        Image.fromarray(lbl).save(os.path.join(gt_dir, lbl_name))
        classes, counts = np.unique(lbl, return_counts=True)
        stats_dict[path] = {str(int(c)): int(n)
                            for c, n in zip(classes, counts)}
        for c, n in zip(classes, counts):
            with_class.setdefault(str(int(c)), []).append([path, int(n)])
    with open(os.path.join(root, "sample_class_stats_dict.json"), "w") as f:
        json.dump(stats_dict, f)
    with open(os.path.join(root, "samples_with_class.json"), "w") as f:
        json.dump(with_class, f)
    return root


def fabricate_dsec(root: str, n_frames: int, events_per_window: int) -> str:
    """One DSEC sequence of ``n_frames`` noise frames and
    ``events_per_window`` events per frame; returns the train list (frames
    1 to n - 1: frame 0 has no previous window)."""
    import h5py
    seq = os.path.join(root, "zurich_city_09_x")
    img_dir = os.path.join(seq, "images", "left", "rectified")
    warp_dir = os.path.join(seq, "warp_images")
    ev_dir = os.path.join(seq, "events", "left")
    for d in (img_dir, warp_dir, ev_dir):
        os.makedirs(d, exist_ok=True)
    g = np.random.default_rng(0)
    w, h = DSEC_SIZE
    n_events = events_per_window * n_frames
    gz = dict(chunks=(min(DSEC_CHUNK, n_events),), compression="gzip",
              compression_opts=1)
    with h5py.File(os.path.join(ev_dir, "events.h5"), "w") as f:
        f.create_dataset("events/t", data=np.sort(
            g.integers(0, 10 ** 8, n_events)).astype(np.int64), **gz)
        f.create_dataset("events/x", data=g.integers(
            0, w, n_events).astype(np.uint16), **gz)
        f.create_dataset("events/y", data=g.integers(
            0, h, n_events).astype(np.uint16), **gz)
        f.create_dataset("events/p", data=g.integers(
            0, 2, n_events).astype(np.uint8), **gz)
    with h5py.File(os.path.join(ev_dir, "rectify_map.h5"), "w") as f:
        yy, xx = np.mgrid[0:h, 0:w]
        f["rectify_map"] = np.stack([xx, yy], -1).astype(np.float32)
    for i in range(n_frames):
        arr = g.integers(0, 255, (h, w, 3), np.uint8).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(img_dir, f"{i:06d}.png"))
        Image.fromarray(arr).save(os.path.join(warp_dir, f"{i:06d}.png"))
    np.savetxt(os.path.join(seq, "images", "images_to_events_index.txt"),
               np.arange(1, n_frames + 1) * events_per_window - 1, fmt="%d")
    txt = os.path.join(root, "night_dataset_warp.txt")
    with open(txt, "w") as f:
        f.write("\n".join(f"{img_dir}/{i:06d}.png 0"
                          for i in range(1, n_frames)))
    return txt


def fabricate_dsec_with_labels(root: str, n_frames: int = 8,
                               events_per_window: int = 20000):
    """``fabricate_dsec`` plus labels (32-pixel blocks) and the test list
    (the last quarter of the train list, at least 2 frames); the frames are
    re-rendered as the night view of their labels. Returns (train list,
    test list)."""
    g = np.random.default_rng(1)
    txt = fabricate_dsec(root, n_frames, events_per_window)
    seq_dir = os.path.join(root, "zurich_city_09_x")
    lbl_dir = os.path.join(seq_dir, "labels")
    os.makedirs(lbl_dir, exist_ok=True)
    w, h = DSEC_SIZE
    for i in range(n_frames):
        lbl = _blocks(g, h // 32, w // 32, 32)
        img = Image.fromarray(_night_image(g, lbl))
        img.save(os.path.join(seq_dir, "warp_images", f"{i:06d}.png"))
        img.save(os.path.join(seq_dir, "images", "left", "rectified",
                              f"{i:06d}.png"))
        if i >= 1:
            Image.fromarray(lbl).save(os.path.join(
                lbl_dir,
                f"zurich_city_09_x_{i:06d}_grey_gtFine_labelTrainIds.png"))
    with open(txt) as f:
        rows = f.read().splitlines()
    test_txt = os.path.join(root, "night_test_dataset_warp.txt")
    with open(test_txt, "w") as f:
        f.write("\n".join(rows[-max(2, len(rows) // 4):]))
    return txt, test_txt


def fabricate_dark_zurich(root: str, n_images: int = 4, size=(480, 270),
                          splits=("train", "val", "test")) -> str:
    """``rgb_anon/<split>/night/seq01`` frames of ``size`` (W, H) and the
    val split's ``gt`` labelTrainIds (reference dark_zurich_ic.py
    layout); returns ``root``."""
    g = np.random.default_rng(2)
    w, h = size
    for split in splits:
        img_dir = os.path.join(root, "rgb_anon", split, "night", "seq01")
        os.makedirs(img_dir, exist_ok=True)
        for i in range(n_images):
            name = f"seq01_frame_{i:06d}_rgb_anon.png"
            lbl = _blocks(g, h // 32 + 1, w // 32 + 1, 32)[:h, :w]
            Image.fromarray(_night_image(g, lbl)).save(
                os.path.join(img_dir, name))
            if split == "val":
                gt_dir = os.path.join(root, "gt", "val", "night", "seq01")
                os.makedirs(gt_dir, exist_ok=True)
                Image.fromarray(lbl).save(os.path.join(
                    gt_dir,
                    name.replace("_rgb_anon.png", "_gt_labelTrainIds.png")))
    return root


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="write a Cityscapes, DSEC and "
                                 "DarkZurich corpus")
    ap.add_argument("--root", required=True)
    ap.add_argument("--images", type=int, default=6,
                    help="Cityscapes frames")
    ap.add_argument("--cityscapes-size", type=int, nargs=2, default=(512, 256),
                    metavar=("W", "H"), help="the real frames: 2048 1024")
    ap.add_argument("--frames", type=int, default=8, help="DSEC frames")
    ap.add_argument("--events-per-window", type=int, default=20000)
    ap.add_argument("--dark-zurich-size", type=int, nargs=2,
                    default=(480, 270), metavar=("W", "H"),
                    help="the real frames: 1920 1080")
    args = ap.parse_args(argv)
    cs = fabricate_cityscapes(os.path.join(args.root, "cityscapes"),
                              args.images, tuple(args.cityscapes_size))
    train_txt, test_txt = fabricate_dsec_with_labels(
        os.path.join(args.root, "dsec"), args.frames,
        args.events_per_window)
    dz = fabricate_dark_zurich(os.path.join(args.root, "dark_zurich"),
                               size=tuple(args.dark_zurich_size))
    out = {"cityscapes": cs, "target_txt": train_txt, "val_txt": test_txt,
           "dark_zurich": dz}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
