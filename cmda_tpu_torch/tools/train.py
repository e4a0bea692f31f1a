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
        --cyclegan cityscapes_ICD_to_dsec_EN.pth   # or cyclegan_final.npz
    python -m cmda_tpu_torch.tools.train --config cs2dz --synthetic \\
        --work-dir work_dirs/dz [--teacher-bf16] [--set uda.alpha=0.99]
    python -m cmda_tpu_torch.tools.train --config cs2dz \\
        --source-root data/cityscapes --target-root data/dark_zurich \\
        --set model.train_type=cs2dz_image+raw-isr_no-fusion \\
        --set model.fusion= --set model.split_cls=true \\
        --set model.events_classes=2 --isr_edge 1 \\
        --feature_dist 0.005 --imnet mit_b5.pth

The source is Cityscapes-IC (``--source-root``), with Rare Class Sampling
from ``--rcs-json-dir`` when ``data.rcs_enabled``; the target is DSEC-Night
(``--target-txt``, evaluated on ``--val-txt``) for cs2dsec, DarkZurich
(``--target-root``, evaluated on its val split) for cs2dz.
``python -m cmda_tpu_torch.tools.make_fake_corpus`` writes such a corpus.
Prints ``{"done": true, "step": N, "work_dir": ...}`` at the end;
``main(argv)`` returns the ``TrainLoop`` (its final state in ``.state``).

The JAX CLI's ablation flags (the reference launcher's,
my_run_experiments.py:28-90) map onto config overrides as there, e.g.

    python -m cmda_tpu_torch.tools.train --config cs2dz \
        --source-root data/cityscapes --target-root data/dark_zurich \
        --shift_3_channel --cs_isr_noise --cs_cow_mask --sky_mask \
        --random_flare data/flares --isr_noise_dacs_type noise+blur

A flag whose option the port does not train yet raises
``NotImplementedError`` naming its ROADMAP item from the check that owns
the option (the trainer's, a dataset's, the fusion module's or the
head's) when that is built; the JAX CLI's flags whose code is not ported
at all raise when they are parsed. ``--pallas-ce`` sets
``uda.pallas_ce=true``; ``--no-pallas-ce`` is refused by the trainer: the
port always runs its CUDA kernels.
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
from ..ops.resize import set_fused_int_upsample
from ..train.loop import TrainLoop, load_checkpoint
from ..uda.cyclegan_train import load_generator_npz
from ..utils.weights import (cyclegan_to_state_dict,
                             load_pretrained_backbone, load_torch_file,
                             strip_prefix)

# the JAX CLI's flags that lead to code the port does not have, by ROADMAP
# queue A item: 7 parallelism
_UNPORTED = dict.fromkeys(("--multi-host", "--coordinator", "--data-parallel",
                           "--shard-opt-state", "--tensor-parallel"), 7)


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
    p.add_argument("--imnet", default=None,
                   help="NVlabs mit_bX.pth of the frozen ImageNet encoder "
                        "of the feature distance (default with "
                        "--feature_dist: --pretrained-backbone)")
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
    p.add_argument("--pallas-ce", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="uda.pallas_ce: the fused upsample+CE and argmax "
                        "kernels, always on in the port (--no-pallas-ce "
                        "is refused)")
    p.add_argument("--fused-resize", action="store_true",
                   help="integer-factor bilinear upsamples as fixed-phase "
                        "weighted adds (ops/resize.py "
                        "set_fused_int_upsample), for the whole process")
    p.add_argument("--device", default="cuda")
    add_ablation_flags(p)
    args, extra = p.parse_known_args(argv)
    for token in extra:
        flag = token.split("=", 1)[0]
        if flag in _UNPORTED:
            raise NotImplementedError(f"{flag} is not ported (ROADMAP queue "
                                      f"A item {_UNPORTED[flag]})")
    if extra:
        p.error(f"unrecognized arguments: {' '.join(extra)}")
    return args


def add_ablation_flags(p):
    """The reference launcher's ablation surface (my_run_experiments.py:
    28-90) as named flags, as the JAX CLI has them; ``ablation_overrides``
    maps them onto the config tree."""
    g = p.add_argument_group("ablation flags (reference my_run_experiments.py)")
    g.add_argument("--backbone", default="",
                   choices=["", "mit_b0", "mit_b1", "mit_b2", "mit_b3",
                            "mit_b4", "mit_b5"])
    g.add_argument("--fusion", default="",
                   choices=["", "caf", "af", "attf", "attfavg"])
    g.add_argument("--fusion_isr", default="",
                   choices=["", "caf", "af", "attf", "attfavg", "none"])
    g.add_argument("--train_size", default="", help="e.g. 512-512")
    g.add_argument("--day_events_generate", default="",
                   choices=["", "image_change", "gray_image", "ic_wo_cyclegan",
                            "gi_wo_cyclegan", "events_gan", "events_esim"])
    g.add_argument("--events_clip_range", type=float, default=-1)
    g.add_argument("--events_bins_5_avg_1", action="store_true")
    g.add_argument("--image_change_range", type=int, default=-1)
    g.add_argument("--feature_dist", type=float, default=-1)
    g.add_argument("--no_plcrop", action="store_true")
    g.add_argument("--cs_isr_noise", action="store_true")
    g.add_argument("--cs_cow_mask", action="store_true")
    g.add_argument("--high_resolution_isr", action="store_true")
    g.add_argument("--random_flare", default="",
                   metavar="FLARE_DIR", help="lens-flare PNG dir")
    g.add_argument("--sky_mask", action="store_true")
    g.add_argument("--deflare_aug", action="store_true")
    g.add_argument("--isr_edge", type=float, default=-1,
                   help="edge-label the ISR stream; the value is "
                        "lambda_isr_features (reference "
                        "my_run_experiments.py:320-322)")
    g.add_argument("--isr_edge_class_weight", type=float, default=-1,
                   help="edge-class CE weight w -> [1-w, w] "
                        "(reference my_run_experiments.py:327-330)")
    g.add_argument("--isr_mix_aug", action="store_true",
                   help="jitter+blur the class-mixed ISR "
                        "(reference my_run_experiments.py:285-288)")
    g.add_argument("--img_self_res_reg", default="",
                   choices=["", "no", "only_isr", "mixed", "average"],
                   help="validated but functionally dead in the reference "
                        "(dacs.py:684-699 is commented out)")
    g.add_argument("--cs_isr_data_type", default="",
                   choices=["", "day", "new_day"],
                   help="source ISR default-table selector "
                        "(reference cityscapes_ic.py:100-116)")
    g.add_argument("--dz_isr_data_type", default="",
                   choices=["", "night", "new_night"],
                   help="target ISR default-table selector "
                        "(reference dark_zurich_ic.py:110-127)")
    g.add_argument("--dz_auto_threshold", action="store_true",
                   help="unimplemented in the reference (raises in "
                        "utils.py:124-125); rejected at dataset build")
    g.add_argument("--shift_3_channel", action="store_true")
    g.add_argument("--share_decoder", action="store_true")
    g.add_argument("--half_share_decoder", action="store_true")
    g.add_argument("--no_share_decoder", action="store_true")
    g.add_argument("--mixed_image_to_mixed_isr", action="store_true")
    g.add_argument("--isr_noise_dacs_type", default="",
                   choices=["", "noise", "blur", "noise+blur"])
    g.add_argument("--source_isr_parms", default="",
                   help="lo-hi-threshold-clip-shift (5 dash-separated floats)")
    g.add_argument("--target_isr_parms", default="")
    g.add_argument("--dacs_isr_parms", default="")
    g.add_argument("--without_events", action="store_true")
    g.add_argument("--without_isd", action="store_true")
    g.add_argument("--isr_no_fusion", action="store_true")
    g.add_argument("--fuse_both_ice_and_e", action="store_true")
    g.add_argument("--random_choice_thres", default="",
                   help="float or 'a-b' linear schedule")
    g.add_argument("--isd_shift_type", default="",
                   choices=["", "all", "random", "rightdown"])
    g.add_argument("--loss_weight_image", type=float, default=-1)
    g.add_argument("--loss_weight_events", type=float, default=-1)
    g.add_argument("--loss_weight_fusion", type=float, default=-1)
    g.add_argument("--loss_weight_img_self_res", type=float, default=-1)
    g.add_argument("--lambda_feature_consistency", type=float, default=-1)
    g.add_argument("--test_mode", action="store_true",
                   help="shrink eval/log/debug intervals for smoke runs "
                        "(reference my_run_experiments.py:177-180)")


_FUSION_NAMES = {"caf": "convert_avg", "af": "average",
                 "attf": "attention", "attfavg": "attention_avg",
                 "none": ""}


def ablation_overrides(args) -> list:
    """The ablation flags of ``args`` as (dotted path, value) overrides, in
    the JAX CLI's order."""
    ov = []

    def add(path, val):
        ov.append((path, val))

    if args.backbone:
        add("model.backbone", args.backbone)
    if args.fusion:
        add("model.fusion", _FUSION_NAMES[args.fusion])
    if args.fusion_isr:
        add("model.fusion_isr", _FUSION_NAMES[args.fusion_isr])
    if args.train_size:
        # the reference's table (my_run_experiments.py:212-224): the 512
        # setting keeps the DSEC pre-resize crop at 440
        w, h = args.train_size.split("-")
        add("data.crop_size", f"{w},{h}")
        tgt = "440,440" if args.train_size == "512-512" else f"{w},{h}"
        add("data.target_crop_size", tgt)
    if args.day_events_generate:
        mode = {"gi_wo_cyclegan": "gray_image"}.get(
            args.day_events_generate, args.day_events_generate)
        add("data.return_gi_or_ic", mode)
        add("uda.use_cyclegan_day_events",
            args.day_events_generate in ("image_change", "gray_image"))
    if args.events_clip_range != -1:
        add("data.events_clip_range",
            (args.events_clip_range, args.events_clip_range))
    if args.events_bins_5_avg_1:
        # train and val alike: DSECDataset averages the 5 normed bins to 1
        # in both modes (reference dsec.py:145-147, 304-305)
        add("data.events_bins", 5)
    if args.image_change_range != -1:
        add("data.image_change_range", args.image_change_range)
    if args.feature_dist != -1:
        add("uda.imnet_feature_dist_lambda", args.feature_dist)
    if args.no_plcrop:
        add("uda.pseudo_weight_ignore_top", 0)
        add("uda.pseudo_weight_ignore_bottom", 0)
    if args.cs_isr_noise:
        add("data.isr_noise", True)
    if args.cs_cow_mask:
        add("data.isr_cow_mask", True)
    if args.high_resolution_isr:
        add("data.high_resolution_isr", True)
    if args.random_flare:
        add("data.flare_dir", args.random_flare)
    if args.sky_mask:
        add("data.sky_mask", True)
    if args.deflare_aug:
        add("uda.deflare_aug", True)
    if args.isr_edge != -1:
        add("uda.isr_edge", True)
        add("uda.lambda_isr_features", args.isr_edge)
    if args.isr_edge_class_weight != -1:
        if not 0 <= args.isr_edge_class_weight <= 1:
            raise ValueError("--isr_edge_class_weight must lie in [0, 1], "
                             f"got {args.isr_edge_class_weight}")
        add("uda.isr_edge_class_weight", args.isr_edge_class_weight)
    if args.isr_mix_aug:
        add("uda.isr_mix_aug", True)
    if args.img_self_res_reg:
        add("uda.img_self_res_reg", args.img_self_res_reg)
    if args.cs_isr_data_type:
        add("data.cs_isr_data_type", args.cs_isr_data_type)
        add("data.source_isr", C.CS_ISR_PRESETS[args.cs_isr_data_type])
        add("data.source_isr_3", C.CS_ISR_PRESETS_3[args.cs_isr_data_type])
    if args.dz_isr_data_type:
        add("data.dz_isr_data_type", args.dz_isr_data_type)
        add("data.target_isr", C.DZ_ISR_PRESETS[args.dz_isr_data_type])
        add("data.target_isr_3", C.DZ_ISR_PRESETS_3[args.dz_isr_data_type])
    if args.dz_auto_threshold:
        add("data.dz_auto_threshold", True)
    if args.shift_3_channel:
        add("uda.shift_3_channel", True)
        add("data.shift_3_channel", True)
    if args.share_decoder:
        add("model.share_decoder", "full")
    if args.half_share_decoder:
        add("model.share_decoder", "half")
    if args.no_share_decoder:
        add("model.share_decoder", "none")
    if args.mixed_image_to_mixed_isr:
        add("uda.mixed_image_to_mixed_isr", True)
    if args.isr_noise_dacs_type:
        add("uda.isr_noise_dacs_type", args.isr_noise_dacs_type)
    if args.source_isr_parms:
        add("data.source_isr", args.source_isr_parms)
    if args.target_isr_parms:
        add("data.target_isr", args.target_isr_parms)
    if args.dacs_isr_parms:
        add("uda.isr_params", args.dacs_isr_parms)
    if args.without_events:
        add("uda.without_events", True)
    if args.without_isd:
        add("uda.without_isd", True)
    if args.isr_no_fusion:
        add("uda.isr_no_fusion", True)
    if args.fuse_both_ice_and_e:
        add("uda.fuse_both_ice_and_e", True)
    if args.random_choice_thres:
        add("uda.random_choice_thres", args.random_choice_thres)
    if args.isd_shift_type:
        add("uda.shift_type", args.isd_shift_type)
        add("data.shift_type", args.isd_shift_type)
    for k in ("image", "events", "fusion"):
        v = getattr(args, f"loss_weight_{k}")
        if v != -1:
            add(f"uda.loss_weight_{k}", v)
    if args.loss_weight_img_self_res != -1:
        add("uda.loss_weight_isr", args.loss_weight_img_self_res)
    if args.lambda_feature_consistency != -1:
        add("uda.lambda_feature_consistency", args.lambda_feature_consistency)
    if args.test_mode:
        add("eval_interval", 5)
        add("log_interval", 1)
        add("debug_img_interval", 3)
    return ov


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
    for path, val in ablation_overrides(args):
        cfg = C.set_by_path(cfg, path, val)
    cfg = C.apply_overrides(cfg, args.overrides)
    # after --set, as the JAX CLI appends them to it
    if args.pallas_ce is not None:
        cfg = C.replace(cfg, uda=C.replace(cfg.uda, pallas_ce=args.pallas_ce))
    if args.teacher_bf16:
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
    reference ``.pth``, a DataParallel ``module.`` prefix stripped, or a
    CycleGAN trainer's ``.npz``, its ``g_a``), the MiT weights of
    ``--pretrained-backbone`` in both encoders and the teacher a copy of
    the student; random from the config's seed otherwise. With the
    ImageNet feature distance (``uda.imnet_feature_dist_lambda`` > 0) the
    frozen encoder's MiT from ``--imnet``, else from
    ``--pretrained-backbone`` (without either the step raises)."""
    cyclegan = None
    if args.cyclegan:
        if args.cyclegan.endswith(".npz"):
            # a CycleGAN trainer's checkpoint (either package's): its A -> B
            # generator
            cyclegan = cyclegan_to_state_dict(
                load_generator_npz(args.cyclegan, "g_a"))
        else:
            cyclegan = strip_prefix(load_torch_file(args.cyclegan),
                                    prefixes=("module.",))
    imnet_src = args.imnet or args.pretrained_backbone
    imnet = (load_torch_file(imnet_src)
             if imnet_src and cfg.uda.imnet_feature_dist_lambda > 0 else None)
    state = trainer.init_state(cfg.seed, cyclegan_state_dict=cyclegan,
                               imnet_state_dict=imnet)
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
    if args.fused_resize:
        set_fused_int_upsample(True)
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
