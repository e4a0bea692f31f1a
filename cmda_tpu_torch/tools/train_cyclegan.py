"""Train the CycleGAN Image Content-Extractor (ICD -> EN) on the GPU (the
port of the JAX package's ``tools/train_cyclegan.py``), on the crop folders
of ``cmda_tpu_torch.tools.create_cityscapes_image_change --mode crops``:

  python -m cmda_tpu_torch.tools.create_cityscapes_image_change --mode crops \
      --src data/cityscapes/leftImg8bit_IC1/train --dst /tmp/cg/trainA
  python -m cmda_tpu_torch.tools.create_cityscapes_image_change --mode crops \
      --src data/dsec_en_frames --dst /tmp/cg/trainB
  python -m cmda_tpu_torch.tools.train_cyclegan --data-a /tmp/cg/trainA \
      --data-b /tmp/cg/trainB --work-dir work_dirs/cyclegan_icd2en

It writes the same log JSON (``cyclegan.log.json``), sample strips
(real_a | fake_b | rec_a) and ``cyclegan_final.npz`` as the JAX CLI, and
the same final line. The npz plugs into ``cmda_tpu_torch.tools.train
--cyclegan`` (and the JAX package's). The flags are the JAX CLI's, with
``--device`` (default ``cuda``; ``cpu`` for a small run here) in place of
``--eager`` and ``--platform``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="cmda_tpu_torch CycleGAN trainer")
    p.add_argument("--data-a", required=True, help="domain-A image folder "
                   "(day IC crops for the ICD->EN recipe)")
    p.add_argument("--data-b", required=True, help="domain-B image folder "
                   "(night event-frame crops)")
    p.add_argument("--work-dir", default="work_dirs/cyclegan")
    p.add_argument("--steps", type=int, default=None,
                   help="total steps (default: epochs * steps-per-epoch)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--load-size", type=int, default=286)
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--rgb", action="store_true",
                   help="3-channel nets/data (default 1-channel grayscale)")
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--n-blocks", type=int, default=9)
    p.add_argument("--n-layers-d", type=int, default=3,
                   help="PatchGAN depth (use 2 for crops < 48px; an empty "
                        "patch map raises at init)")
    p.add_argument("--netd", default="patch", choices=["patch", "pixel"])
    p.add_argument("--gan-mode", default="lsgan", choices=["lsgan", "vanilla"])
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--pool-size", type=int, default=50)
    p.add_argument("--lambda-a", type=float, default=10.0)
    p.add_argument("--lambda-b", type=float, default=10.0)
    p.add_argument("--lambda-identity", type=float, default=0.5)
    p.add_argument("--epochs", type=int, default=100,
                   help="constant-lr epochs (then --epochs-decay to 0)")
    p.add_argument("--epochs-decay", type=int, default=100)
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="default: len(domain A) / batch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-workers", type=int, default=2)
    p.add_argument("--save-interval", type=int, default=5000)
    p.add_argument("--sample-interval", type=int, default=1000,
                   help="dump a real_a|fake_b|rec_a sample strip every N steps")
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for a small run)")
    return p.parse_args(argv)


def save_sample(path, trainer, state, batch):
    """real_a | fake_b | rec_a of the batch's first image as one uint8
    strip."""
    from PIL import Image
    a = np.asarray(batch["a"][:1])
    fake_b = trainer.generate(state, a, "a2b")
    rec_a = trainer.generate(state, fake_b, "b2a")
    strip = np.concatenate(
        [a[0], fake_b[0].cpu().numpy(), rec_a[0].cpu().numpy()], axis=1)
    strip = np.clip((strip * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    if strip.shape[-1] == 1:
        strip = strip[..., 0]
    Image.fromarray(strip).save(path)


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.work_dir, exist_ok=True)
    from ..data.loader import PrefetchLoader
    from ..data.unpaired import UnpairedFolderDataset
    from ..uda.cyclegan_train import (CycleGANConfig, CycleGANTrainer,
                                      save_checkpoint)

    dataset = UnpairedFolderDataset(
        args.data_a, args.data_b,
        load_size=(args.load_size, args.load_size),
        crop_size=(args.crop, args.crop), grayscale=not args.rgb)
    spe = args.steps_per_epoch or max(1, len(dataset) // args.batch)
    cfg = CycleGANConfig(
        input_nc=3 if args.rgb else 1, ngf=args.ngf, ndf=args.ndf,
        n_blocks=args.n_blocks, n_layers_d=args.n_layers_d,
        netd=args.netd, gan_mode=args.gan_mode,
        lambda_a=args.lambda_a, lambda_b=args.lambda_b,
        lambda_identity=args.lambda_identity, pool_size=args.pool_size,
        lr=args.lr, n_epochs=args.epochs, n_epochs_decay=args.epochs_decay,
        steps_per_epoch=spe)
    steps = args.steps or spe * (args.epochs + args.epochs_decay)

    trainer = CycleGANTrainer(cfg, device=args.device, seed=args.seed + 1)
    state = trainer.init_state(args.seed, (args.crop, args.crop))
    loader = PrefetchLoader(dataset, args.batch,
                            num_workers=args.num_workers, seed=args.seed)
    log_path = os.path.join(args.work_dir, "cyclegan.log.json")
    ckpt = os.path.join(args.work_dir, "cyclegan_final.npz")
    n_params = sum(p.numel() for net in (state.g_a, state.g_b)
                   for p in net.parameters())
    print(f"[cyclegan] {len(dataset)} A-images, {steps} steps, "
          f"{n_params / 1e6:.1f}M generator params", flush=True)

    t0 = time.perf_counter()
    try:
        with open(log_path, "a") as log:
            for it in range(1, steps + 1):
                batch = next(loader)
                state, logs = trainer.train_step(state, batch["a"],
                                                 batch["b"])
                if it % args.log_interval == 0 or it == steps:
                    rec = {k: round(float(v), 4) for k, v in logs.items()}
                    rec.update(iter=it,
                               time=round(time.perf_counter() - t0, 1))
                    log.write(json.dumps(rec) + "\n")
                    log.flush()
                    print(f"[cyclegan] it {it}/{steps} "
                          f"G {rec['loss_g']:.3f} D {rec['loss_d']:.3f}",
                          flush=True)
                if args.sample_interval and it % args.sample_interval == 0:
                    save_sample(os.path.join(args.work_dir,
                                             f"sample_{it:06d}.png"),
                                trainer, state, batch)
                if it % args.save_interval == 0 or it == steps:
                    save_checkpoint(ckpt, state)
    finally:
        loader.close()
    print(json.dumps({"done": True, "steps": steps, "checkpoint": ckpt}),
          flush=True)
    return trainer, state


if __name__ == "__main__":
    main()
