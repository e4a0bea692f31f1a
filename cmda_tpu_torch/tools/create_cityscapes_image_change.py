"""Offline Cityscapes temporal image change (IC1), the CycleGAN EN frames
and the CycleGAN training crops (the port of the JAX package's
``tools/create_cityscapes_image_change.py``; ``image_change`` and the crops
are bitwise equal to it):

  * ``--mode ic``: the log difference (log(x + 50), dead zone 0.1, clip
    0.8, per-sign global renorm) between each train frame and the sequence
    frame ``--image_change_range`` steps earlier, saved as uint8 L PNGs
    ((ic + 1) / 2 * 255 rounded);
  * ``--mode en``: the frozen ICD -> EN CycleGAN on every IC1 frame
    ((v / 255 - 0.5) * 2 in, (v + 1) / 2 * 255 out) on the GPU (``--device
    cpu`` for a small run), from a reference ``.pth`` or a CycleGAN
    trainer's ``.npz`` (either package's);
  * ``--mode crops``: random ``--crop_size`` crops of every frame under
    ``--src`` into a flat folder of L PNGs, the training corpus of
    ``cmda_tpu_torch.tools.train_cyclegan``.

    python -m cmda_tpu_torch.tools.create_cityscapes_image_change \
        --mode en --root_dir data/cityscapes --cyclegan cyclegan_final.npz
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np
from PIL import Image

LOG_ADD = 50
THRESHOLD = 0.1
CLIP_RANGE = 0.8


def _norm_range(x, lo, hi):
    mn, mx = x.min(), x.max()
    return (x - mn) / (mx - mn + 1e-8) * (hi - lo) + lo


def image_change(now_gray: np.ndarray, front_gray: np.ndarray) -> np.ndarray:
    d = (np.log(now_gray.astype(np.float32) + LOG_ADD)
         - np.log(front_gray.astype(np.float32) + LOG_ADD))
    d[np.abs(d) <= THRESHOLD] = 0.0
    pos = _norm_range(np.clip(np.maximum(d, 0), 0, CLIP_RANGE), 0, 1)
    neg = _norm_range(np.clip(np.minimum(d, 0), -CLIP_RANGE, 0), -1, 0)
    ic = pos + neg
    return np.uint8(np.around((ic + 1) / 2 * 255))


def create_ic(sequence_dir: str, frames_dir: str, out_dir: str,
              image_change_range: int = 1):
    """frames_dir: leftImg8bit/train; sequence_dir: leftImg8bit_sequence/train."""
    for city in sorted(os.listdir(frames_dir)):
        src_seq = osp.join(sequence_dir, city)
        src = osp.join(frames_dir, city)
        dst = osp.join(out_dir, city)
        os.makedirs(dst, exist_ok=True)
        for name in sorted(os.listdir(src)):
            index = int(name.split("_")[2])
            front_name = name[:-22] + f"{index - image_change_range:06d}_leftImg8bit.png"
            out_name = osp.join(dst, name[:-8] + ".png")
            if osp.exists(out_name):
                continue
            now = np.asarray(Image.open(osp.join(src, name)).convert("L"))
            front = np.asarray(Image.open(osp.join(src_seq, front_name)).convert("L"))
            Image.fromarray(image_change(now, front), mode="L").save(out_name)


def load_generator_state_dict(path: str) -> dict:
    """The ICD -> EN generator's reference state_dict from a torch ``.pth``
    (a DataParallel ``module.`` prefix stripped) or a CycleGAN trainer's
    ``.npz`` (its ``g_a``)."""
    from ..utils.weights import (cyclegan_to_state_dict, load_torch_file,
                                 strip_prefix)
    if path.endswith(".npz"):
        from ..uda.cyclegan_train import load_generator_npz
        return cyclegan_to_state_dict(load_generator_npz(path, "g_a"))
    return strip_prefix(load_torch_file(path), prefixes=("module.",))


def load_generator(path: str, device="cuda"):
    """The frozen generator of ``path`` (sized from its weights) on
    ``device``, in eval mode."""
    from ..apis import resolve_device
    from ..models.cyclegan import frozen_generator
    return frozen_generator(load_generator_state_dict(path),
                            device=resolve_device(device))


def en_frame(gen, ic) -> np.ndarray:
    """One IC PIL image -> its EN frame, uint8 [512, 1024]: resized to
    1024x512 (PIL bilinear), (v / 255 - 0.5) * 2 through ``gen``, then
    (y + 1) / 2 * 255 truncated to uint8."""
    import torch
    ic = ic.convert("L").resize((1024, 512), resample=Image.BILINEAR)
    x = (np.asarray(ic, np.float32) / 255.0 - 0.5) * 2.0
    dev = next(gen.parameters()).device
    with torch.no_grad():
        y = gen(torch.from_numpy(x).to(dev)[None, None])[0, 0]
    return np.uint8((y.cpu().numpy() + 1) / 2 * 255)


def create_en(ic_dir: str, out_dir: str, cyclegan_pth: str, device="cuda"):
    """Apply the frozen ICD -> EN generator to every IC PNG."""
    gen = load_generator(cyclegan_pth, device)
    for city in sorted(os.listdir(ic_dir)):
        src = osp.join(ic_dir, city)
        dst = osp.join(out_dir, city)
        os.makedirs(dst, exist_ok=True)
        for name in sorted(os.listdir(src)):
            out_name = osp.join(dst, name)
            if osp.exists(out_name):
                continue
            with Image.open(osp.join(src, name)) as ic:
                Image.fromarray(en_frame(gen, ic), mode="L").save(out_name)


def _frame_to_uint8(a: np.ndarray) -> np.ndarray:
    """Array frame -> uint8 L image. Floats in [-1,1] (IC / event-frame
    convention) map via (v+1)/2*255; [0,1] via v*255; wider ranges are
    assumed to already be 0..255."""
    a = np.asarray(a)
    if a.ndim == 3:
        a = a.mean(axis=-1)  # HWC -> gray
    if a.dtype == np.uint8:
        return a
    a = a.astype(np.float32)
    if a.min() < -1e-6:
        a = (a + 1.0) / 2.0 * 255.0
    elif a.max() <= 1.5:
        a = a * 255.0
    return np.uint8(np.clip(np.around(a), 0, 255))


def _iter_frames(path: str):
    """Yield (stem, uint8 HxW) frames from one source file: PNG/JPG images
    (grayscale-converted) or .npy/.npz stacks ([H,W], [H,W,C] with C<=4,
    or [N,H,W])."""
    stem = osp.splitext(osp.basename(path))[0]
    low = path.lower()
    if low.endswith((".png", ".jpg", ".jpeg", ".bmp")):
        yield stem, np.asarray(Image.open(path).convert("L"))
        return
    arrays = []
    if low.endswith(".npy"):
        arrays = [("", np.load(path))]
    elif low.endswith(".npz"):
        with np.load(path) as z:
            arrays = [(k, z[k]) for k in sorted(z.files)]
    for key, arr in arrays:
        tag = f"{stem}_{key}" if key else stem
        if arr.ndim == 2 or (arr.ndim == 3 and arr.shape[-1] <= 4):
            yield tag, _frame_to_uint8(arr)
        elif arr.ndim == 3:  # [N, H, W] frame stack
            for i in range(arr.shape[0]):
                yield f"{tag}_f{i:04d}", _frame_to_uint8(arr[i])


def create_crops(src_dir: str, dst_dir: str, *, crop_size: int = 256,
                 per_image: int = 4, seed: int = 0, limit: int | None = None):
    """Random ``crop_size`` crops from every frame under ``src_dir``
    (recursive) into a flat ``dst_dir`` of L PNGs — the unpaired training
    corpus for ``tools/train_cyclegan.py``. Frames smaller than the crop
    are skipped. Returns the number of crops written."""
    import random
    rng = random.Random(seed)
    os.makedirs(dst_dir, exist_ok=True)
    files = []
    for root, _, names in sorted(os.walk(src_dir)):
        files += [osp.join(root, n) for n in sorted(names)]
    written = 0
    for path in files:
        for stem, frame in _iter_frames(path):
            h, w = frame.shape
            if h < crop_size or w < crop_size:
                continue
            for k in range(per_image):
                if limit is not None and written >= limit:
                    return written
                y = rng.randint(0, h - crop_size)
                x = rng.randint(0, w - crop_size)
                tile = frame[y:y + crop_size, x:x + crop_size]
                Image.fromarray(tile, mode="L").save(
                    osp.join(dst_dir, f"{stem}_c{k:02d}.png"))
                written += 1
    return written


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root_dir", default=None,
                    help="cityscapes root (ic/en modes)")
    ap.add_argument("--mode", choices=["ic", "en", "crops"], default="ic")
    ap.add_argument("--cyclegan", default="pretrained/cityscapes_ICD_to_dsec_EN.pth")
    ap.add_argument("--image_change_range", type=int, default=1)
    ap.add_argument("--src", default=None, help="crops mode: source tree")
    ap.add_argument("--dst", default=None, help="crops mode: flat output dir")
    ap.add_argument("--crop_size", type=int, default=256)
    ap.add_argument("--per_image", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="en mode: torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.mode == "crops":
        if not (args.src and args.dst):
            ap.error("--mode crops requires --src and --dst")
        n = create_crops(args.src, args.dst, crop_size=args.crop_size,
                         per_image=args.per_image, seed=args.seed,
                         limit=args.limit)
        print(f"wrote {n} crops to {args.dst}")
        return
    if not args.root_dir:
        ap.error(f"--mode {args.mode} requires --root_dir")
    if args.mode == "ic":
        create_ic(osp.join(args.root_dir, "leftImg8bit_sequence", "train"),
                  osp.join(args.root_dir, "leftImg8bit", "train"),
                  osp.join(args.root_dir, "leftImg8bit_IC1", "train"),
                  args.image_change_range)
    else:
        create_en(osp.join(args.root_dir, "leftImg8bit_IC1", "train"),
                  osp.join(args.root_dir, "leftImg8bit_EN1", "train"),
                  args.cyclegan, args.device)


if __name__ == "__main__":
    main()
