"""Train CLI of the port: the DACS run of a preset on one device, on the
real corpora's files or on synthetic data (mirrors tools/train.py of the
JAX package).

    python -m cmda_tpu_torch.tools.train --config cs2dsec \\
        --source-root data/cityscapes --rcs-json-dir data/cityscapes \\
        --target-txt data/dsec/night_dataset_warp.txt \\
        --val-txt data/dsec/night_test_dataset_warp.txt --work-dir work_dirs/b5
    python -m cmda_tpu_torch.tools.train --config cs2dz \\
        --source-root data/cityscapes --rcs-json-dir data/cityscapes \\
        --target-root data/dark_zurich --work-dir work_dirs/dz
    python -m cmda_tpu_torch.tools.train --config tiny --synthetic \\
        --device cpu --max-iters 2 [--dtype bfloat16]
    python -m cmda_tpu_torch.tools.train --config cs2dsec --synthetic \\
        --work-dir work_dirs/b5 --pretrained-backbone mit_b5.pth \\
        --cyclegan cityscapes_ICD_to_dsec_EN.pth
    python -m cmda_tpu_torch.tools.train --config cs2dz --synthetic \\
        --work-dir work_dirs/dz [--teacher-bf16] [--set uda.alpha=0.99]

The source is Cityscapes-IC (``--source-root``), with Rare Class Sampling
from ``--rcs-json-dir`` when ``data.rcs_enabled``; the target is DSEC-Night
(``--target-txt``, evaluated on ``--val-txt``) for cs2dsec, DarkZurich
(``--target-root``, evaluated on its val split) for cs2dz.
``python -m cmda_tpu_torch.tools.make_fake_corpus`` writes such a corpus.
Prints ``{"done": true, "step": N, "work_dir": ...}`` at the end;
``main(argv)`` returns the ``TrainLoop`` (its final state in ``.state``).
A flag of the JAX CLI whose code is not ported raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import argparse
import json
import os

from .. import config as C
from ..data.cityscapes_ic import CityscapesICDataset
from ..data.dark_zurich import DarkZurichDataset
from ..data.dsec import DSECDataset
from ..data.synthetic import SyntheticSource, SyntheticTarget
from ..data.uda import UDAPairDataset
from ..train.loop import TrainLoop, load_checkpoint
from ..utils.weights import (load_pretrained_backbone, load_torch_file,
                             strip_prefix)

# the JAX CLI's flags that lead to code the port does not have, by ROADMAP
# queue A item: 3 the ablation surface, 5 other UDA variants, 7 parallelism
_UNPORTED = {
    **dict.fromkeys(("--multi-host", "--coordinator", "--data-parallel",
                     "--shard-opt-state", "--tensor-parallel"), 7),
    "--imnet": 5,
    **dict.fromkeys((
        "--fused-resize", "--pallas-ce", "--no-pallas-ce",
        "--backbone", "--fusion", "--fusion_isr", "--train_size",
        "--day_events_generate", "--events_clip_range",
        "--events_bins_5_avg_1", "--image_change_range", "--feature_dist",
        "--no_plcrop", "--cs_isr_noise", "--cs_cow_mask",
        "--high_resolution_isr", "--random_flare", "--sky_mask",
        "--deflare_aug", "--isr_edge", "--isr_edge_class_weight",
        "--isr_mix_aug", "--img_self_res_reg", "--cs_isr_data_type",
        "--dz_isr_data_type", "--dz_auto_threshold", "--shift_3_channel",
        "--share_decoder", "--half_share_decoder", "--no_share_decoder",
        "--mixed_image_to_mixed_isr", "--isr_noise_dacs_type",
        "--source_isr_parms", "--target_isr_parms", "--dacs_isr_parms",
        "--without_events", "--without_isd", "--isr_no_fusion",
        "--fuse_both_ice_and_e", "--random_choice_thres", "--isd_shift_type",
        "--loss_weight_image", "--loss_weight_events", "--loss_weight_fusion",
        "--loss_weight_img_self_res", "--lambda_feature_consistency",
        "--test_mode"), 3),
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="cmda_tpu_torch trainer",
                                allow_abbrev=False)
    p.add_argument("--config", default="cs2dsec",
                   choices=["cs2dsec", "cs2dz", "tiny"])
    p.add_argument("--work-dir", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data instead of the corpus files")
    p.add_argument("--source-root", default=None,
                   help="Cityscapes root (default: the config's)")
    p.add_argument("--target-root", default=None,
                   help="DarkZurich root for cs2dz (default: the config's)")
    p.add_argument("--target-txt", default=None,
                   help="DSEC-Night train list (night_dataset_warp.txt)")
    p.add_argument("--val-txt", default=None,
                   help="DSEC-Night list evaluated every eval_interval")
    p.add_argument("--rcs-json-dir", default=None,
                   help="the dir of samples_with_class.json and "
                        "sample_class_stats_dict.json (Rare Class Sampling)")
    p.add_argument("--max-iters", type=int, default=None,
                   help="sets optim.max_iters, the schedule's horizon")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resume-from", default=None,
                   help="an iter_<n>.pth of this CLI")
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--pretrained-backbone", default=None,
                   help="NVlabs mit_bX.pth loaded into both backbones "
                        "(reference mix_transformer.py:339-357)")
    p.add_argument("--cyclegan", default=None,
                   help="frozen day-events generator state_dict "
                        "(reference dacs.py:96-103)")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="model compute dtype (parameters stay float32)")
    p.add_argument("--teacher-bf16", action="store_true",
                   help="the teacher reads a bfloat16 cast of the EMA "
                        "weights (uda.teacher_bf16); the EMA stays float32")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VAL",
                   help="dotted config override, e.g. uda.pseudo_threshold"
                        "=0.9 (repeatable); an option the port lacks raises "
                        "when the trainer is built")
    p.add_argument("--device", default="cuda")
    args, extra = p.parse_known_args(argv)
    for token in extra:
        flag = token.split("=", 1)[0]
        if flag in _UNPORTED:
            raise NotImplementedError(f"{flag} is not ported (ROADMAP queue "
                                      f"A item {_UNPORTED[flag]})")
    if extra:
        p.error(f"unrecognized arguments: {' '.join(extra)}")
    return args


def build_config(args) -> C.RunConfig:
    cfg = C.PRESETS[args.config]()
    if args.seed is not None:
        cfg = C.replace(cfg, seed=args.seed)
    if args.dtype:
        cfg = C.replace(cfg, dtype=args.dtype)
    data = cfg.data
    if args.batch_size:
        data = C.replace(data, batch_size=args.batch_size)
    if args.source_root:
        data = C.replace(data, source_root=args.source_root)
    if args.target_root:
        data = C.replace(data, target_root=args.target_root)
    cfg = C.replace(cfg, data=data)
    if args.max_iters:
        cfg = C.replace(cfg, optim=C.replace(cfg.optim,
                                             max_iters=args.max_iters))
    cfg = C.apply_overrides(cfg, args.overrides)
    if args.teacher_bf16:   # after --set, as the JAX CLI appends it
        cfg = C.replace(cfg, uda=C.replace(cfg.uda, teacher_bf16=True))
    return cfg


def build_datasets(cfg: C.RunConfig, args):
    """The UDA pair dataset and the val set: synthetic with
    ``--synthetic`` (8 test-mode val samples), else CityscapesIC and
    DSEC-Night (val from ``--val-txt``, None without it) or DarkZurich
    (its val split), with Rare Class Sampling from ``--rcs-json-dir``
    when ``data.rcs_enabled``."""
    d = cfg.data
    if args.synthetic:
        with_events = cfg.model.train_type.startswith("cs2dsec")
        src = SyntheticSource(crop_size=d.crop_size,
                              with_time_res=with_events)
        tgt = SyntheticTarget(crop_size=d.crop_size, with_events=with_events)
        val = SyntheticTarget(crop_size=d.crop_size, length=8,
                              with_events=with_events, test_mode=True)
        return UDAPairDataset(src, tgt, seed=cfg.seed), val

    src = CityscapesICDataset(
        d.source_root, isr_params=d.source_isr_3 if d.shift_3_channel
        else d.source_isr, image_crop_size=d.crop_size,
        shift_type=d.shift_type, isr_noise=d.isr_noise,
        isr_cow_mask=d.isr_cow_mask, flare_dir=d.flare_dir,
        sky_noise_dir=d.sky_noise_dir, sky_mask=d.sky_mask,
        shift_3_channel=d.shift_3_channel,
        high_resolution_isr=d.high_resolution_isr,
        return_gi_or_ic=d.return_gi_or_ic, decode_cache=d.decode_cache)
    if d.target == "dsec":
        if not args.target_txt:
            raise ValueError("a DSEC target needs --target-txt (or "
                             "--synthetic)")
        # the window, bins and clip apply to train and val alike (reference
        # my_run_experiments.py:232-238, 248-255, 352-360)
        tgt = DSECDataset(args.target_txt, events_bins=d.events_bins,
                          isr_params=d.target_isr,
                          crop_size=d.target_crop_size,
                          after_crop_resize_size=d.crop_size,
                          image_change_range=d.image_change_range,
                          events_clip_range=d.events_clip_range,
                          shift_type=d.shift_type,
                          decode_cache=d.decode_cache)
        val = (DSECDataset(args.val_txt, events_bins=d.events_bins,
                           isr_params=d.target_isr, test_mode=True,
                           image_change_range=d.image_change_range,
                           events_clip_range=d.events_clip_range,
                           outputs=("image", "events", "label"))
               if args.val_txt else None)
    else:
        target_isr = d.target_isr_3 if d.shift_3_channel else d.target_isr
        tgt = DarkZurichDataset(d.target_root, split="train",
                                isr_params=target_isr,
                                image_crop_size=d.crop_size,
                                shift_type=d.shift_type,
                                shift_3_channel=d.shift_3_channel,
                                auto_threshold=d.dz_auto_threshold)
        val = DarkZurichDataset(d.target_root, split="val",
                                isr_params=target_isr,
                                shift_3_channel=d.shift_3_channel,
                                auto_threshold=d.dz_auto_threshold,
                                outputs=("image", "isr", "label"))
    rcs = {}
    if d.rcs_enabled and args.rcs_json_dir:
        rcs = dict(
            rcs=True,
            samples_with_class=os.path.join(args.rcs_json_dir,
                                            "samples_with_class.json"),
            sample_class_stats=os.path.join(args.rcs_json_dir,
                                            "sample_class_stats_dict.json"),
            class_temp=d.rcs_class_temp, min_pixels=d.rcs_min_pixels,
            min_crop_ratio=d.rcs_min_crop_ratio)
    return UDAPairDataset(src, tgt, seed=cfg.seed, **rcs), val


def init_state(trainer, cfg: C.RunConfig, args):
    """The initial train state: the CycleGAN from ``--cyclegan`` (a
    DataParallel ``module.`` prefix stripped), the MiT weights of
    ``--pretrained-backbone`` in both encoders and the teacher a copy of
    the student; random from the config's seed otherwise."""
    cyclegan = None
    if args.cyclegan:
        if args.cyclegan.endswith(".npz"):
            raise NotImplementedError("the JAX CycleGAN trainer's .npz "
                                      "generators are not ported (ROADMAP "
                                      "queue A item 5)")
        cyclegan = strip_prefix(load_torch_file(args.cyclegan),
                                prefixes=("module.",))
    state = trainer.init_state(cfg.seed, cyclegan_state_dict=cyclegan)
    if args.pretrained_backbone:
        sd = load_torch_file(args.pretrained_backbone)
        for backbone in (state.model.backbone_image,
                         state.model.backbone_events):
            load_pretrained_backbone(backbone, sd)
        state.ema_model.load_state_dict(state.model.state_dict())
    return state


def main(argv=None) -> TrainLoop:
    args = parse_args(argv)
    cfg = build_config(args)
    dataset, val = build_datasets(cfg, args)
    loop = TrainLoop(cfg, dataset=dataset, val_dataset=val,
                     work_dir=args.work_dir, num_workers=args.num_workers,
                     device=args.device)
    state = init_state(loop.trainer, cfg, args)
    if args.resume_from:
        # the checkpoint holds no CycleGAN: it comes from --cyclegan or the
        # seed, as at the start of the run
        state = load_checkpoint(state, args.resume_from)
    final = loop.run(max_iters=args.max_iters, state=state)
    print(json.dumps({"done": True, "step": final.step,
                      "work_dir": loop.work_dir}), flush=True)
    return loop


if __name__ == "__main__":
    main()
