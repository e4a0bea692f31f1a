"""Experiment grid launcher of the port (mirrors tools/run_experiments.py of
the JAX package):

    python -m cmda_tpu_torch.tools.run_experiments --exp 100 [--device cpu]
    python -m cmda_tpu_torch.tools.run_experiments --exp 5 --only dlv2red

``--exp 100`` the architecture startup test: 2 DACS iterations of each
fusion-framework combo (fusion module, decoder sharing, backbone) on the
tiny config, then 2 supervised iterations of each (architecture, backbone)
pair of the reference's architecture table on smoke-sized models. ``--exp
101`` 2 DACS iterations of each UDA variant; ``--exp 102`` 2 OrgDACS
iterations of each legacy UDA variant; ``--exp 3..8`` the DAFormer
ablation-table grids in smoke mode (3 encoder study, 4 no-warmup schedule,
5 RCS and feature distance, 6 decoder study, 7 SYNTHIA with 16 classes,
8 further targets): OrgDACS for the 'dacs*' ids, a supervised step for
source-/target-only. ``--exp 1|2`` hand over to the train CLI (cs2dsec /
cs2dz). Every run is on synthetic data, on ``--device`` (default cuda).
Each combo prints ``[OK]`` or ``[FAIL]``, then the results as JSON; the
exit code is 1 if any combo failed.

Two deliberate differences from the JAX launcher: its ``architecture_grid``
returns (name, config, None) triples that its own ``main`` cannot unpack,
and its ``fusion_concatenate`` / ``fusion_convert_avg`` combos run those
modules at the tiny config's MiT-b0 widths, which they do not take (their
widths are fixed at MiT-b1..b5's); here the grid gives pairs and runs those
two combos on MiT-b1.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import traceback

import numpy as np
import torch

from .. import config as C
from ..models.daformer import DAFormerHeadConfig

# reference backbone id -> RESNET_VARIANTS key; s200 has no variant of its
# own and maps to the deepest ResNeSt, as in the JAX launcher
_LEGACY_RESNET_MAP = {
    "r50v1c": "resnet50_d8",
    "r101v1c": "resnet101_d8",
    "s50": "resnest50",
    "s101": "resnest101_d8",
    "s200": "resnest101_d8",
    "x50-32": "resnext50",
    "x101-32": "resnext101_d8",
}
# the DAFormer 'things' classes of dacs_fdthings
_FD_THINGS = (6, 7, 11, 12, 13, 14, 15, 16, 17, 18)


def architecture_grid():
    """(name, config) pairs of the fusion framework's combos on the tiny
    config: every fusion module, decoder sharing 'full' and 'none', and
    the MiT-b0 and -b1 backbones (the fixed-width fusions on MiT-b1)."""
    base = C.tiny_test_config()
    b1_head = DAFormerHeadConfig(in_channels=(64, 128, 320, 512),
                                 embed_dim=64, channels=64)
    combos = []
    for fusion in ["attention_avg", "attention", "average", "concatenate",
                   "convert_avg"]:
        model = C.replace(base.model, fusion=fusion)
        if fusion in ("concatenate", "convert_avg"):
            model = C.replace(model, backbone="mit_b1", head=b1_head)
        combos.append((f"fusion_{fusion}", C.replace(base, model=model)))
    for share in ["full", "none"]:
        combos.append((f"share_{share}", C.replace(
            base, model=C.replace(base.model, share_decoder=share))))
    for backbone in ["mit_b0", "mit_b1"]:
        combos.append((f"backbone_{backbone}", C.replace(
            base, model=C.replace(base.model, backbone=backbone,
                                  head=DAFormerHeadConfig(
                                      in_channels=(32, 64, 160, 256)
                                      if backbone == "mit_b0"
                                      else (64, 128, 320, 512),
                                      embed_dim=64, channels=64)))))
    return combos


def _legacy_model_builder(arch: str, backbone: str, num_classes: int = 19):
    """A zero-argument builder of the GenericEncoderDecoder of a reference
    (architecture, backbone) id pair. Smoke-sized, as in the JAX launcher:
    a ResNet at depths (1, 1, 1, 1), every MiT as mit_b0, heads at 64
    channels (ISA at 32 / (2, 2)). The 'sfa_' prefix adds the
    SegFormerAdapter neck; the '_nodbn' suffix is ignored, as in the JAX
    launcher."""
    from ..models.daformer import DAFormerHead
    from ..models.heads import (ASPPHead, DAHead, DLV2Head, HeadConfig,
                                ISAHead, SegFormerAdapter, SegFormerHead,
                                UPerHead)
    from ..models.mit import MIT_VARIANTS, MixVisionTransformer
    from ..models.resnet import (OUT_CHANNELS, RESNET_VARIANTS, ResNetConfig,
                                 ResNetV1c)
    from ..models.segmentor import GenericEncoderDecoder

    is_mit = "mit" in backbone

    def build():
        if is_mit:
            cfg = MIT_VARIANTS["mit_b0"]
            bb, ch = MixVisionTransformer(cfg), tuple(cfg.embed_dims)
        else:
            cfg = ResNetConfig(**{
                **RESNET_VARIANTS[_LEGACY_RESNET_MAP[backbone]].__dict__,
                "depths": (1, 1, 1, 1)})
            bb, ch = ResNetV1c(cfg), OUT_CHANNELS
        hc = HeadConfig(in_channels=ch, channels=64, num_classes=num_classes)
        a = arch
        neck = None
        if a.startswith("sfa_"):
            neck = SegFormerAdapter()
            a = a[len("sfa_"):]
        a = a.replace("_nodbn", "")

        def daformer(fusion_type):
            return DAFormerHead(DAFormerHeadConfig(
                in_channels=ch, num_classes=num_classes, embed_dim=64,
                channels=64, fusion_type=fusion_type))

        head = {
            "dlv2red": lambda: DLV2Head(hc),
            "dlv2": lambda: DLV2Head(hc),
            "dlv3p": lambda: ASPPHead(hc, dilations=(1, 12, 24), sep=True,
                                      c1_channels=48),
            "da": lambda: DAHead(hc),
            "isa": lambda: ISAHead(hc, isa_channels=32, down_factor=(2, 2)),
            "segformer": lambda: SegFormerHead(hc),
            "daformer_conv1": lambda: daformer("conv"),
            "daformer_isa": lambda: daformer("isa"),
            "daformer_sepaspp_bottleneck": lambda: daformer(
                "rawconv_and_aspp"),
            "daformer_aspp": lambda: daformer("aspp_nonsep"),
            "daformer_sepaspp": lambda: daformer("aspp"),
            "upernet": lambda: UPerHead(hc),
            "upernet_ch256": lambda: UPerHead(hc, pool_scales=(1, 2)),
        }[a]()
        return GenericEncoderDecoder(bb, head, neck=neck)

    return build


LEGACY_ARCHITECTURES = (
    ("dlv2red", "r101v1c"), ("dlv3p_nodbn", "r101v1c"),
    ("da_nodbn", "r101v1c"), ("segformer", "mitb5"),
    ("isa_nodbn", "r101v1c"), ("dlv2red", "r50v1c"),
    ("dlv2red", "s50"), ("dlv2red", "s101"), ("dlv2red", "s200"),
    ("dlv2red", "x50-32"), ("dlv2red", "x101-32"),
    ("segformer", "mitb4"), ("segformer", "mitb3"),
    ("sfa_dlv3p_nodbn", "mitb5-del"), ("segformer", "r101v1c"),
    ("daformer_conv1", "mitb5"), ("daformer_isa", "mitb5"),
    ("daformer_sepaspp_bottleneck", "mitb5"), ("daformer_aspp", "mitb5"),
    ("daformer_sepaspp", "mitb5"), ("upernet", "mitb5"),
    ("upernet_ch256", "mitb5"),
)


def legacy_architecture_grid():
    """(name, builder) of the reference's architecture table, smoke-sized;
    each is trained for 2 supervised iterations."""
    return [(f"{a}_{b}", _legacy_model_builder(a, b))
            for a, b in LEGACY_ARCHITECTURES]


def supervised_batch(hw: int = 48, num_classes: int = 19, batch: int = 1):
    """The supervised smoke's image [batch, hw, hw, 3] and labels, from
    numpy's default_rng(0) as the JAX launcher draws them."""
    g = np.random.default_rng(0)
    img = g.normal(size=(batch, hw, hw, 3)).astype(np.float32)
    lbl = g.integers(0, num_classes, size=(batch, hw, hw)).astype(np.int32)
    return img, lbl


def supervised_step(model, optimizer, img, lbl, draws=None):
    """One supervised training step: the training forward (BatchNorm on
    batch statistics, ``draws``' drop-path and Dropout2d), the CE of the
    input-size logits, its backward and ``optimizer``'s update; returns
    the loss (a 0-dim tensor)."""
    from ..ops.losses import weighted_cross_entropy
    optimizer.zero_grad(set_to_none=True)
    logits, _ = model.forward_with_features(img, True, draws)
    loss = weighted_cross_entropy(logits, lbl)
    loss.backward()
    optimizer.step()
    return loss.detach()


def supervised_smoke(name, model_builder, iters: int = 2, hw: int = 48,
                     num_classes: int = 19, device="cuda", batch: int = 1):
    """The architecture table's smoke (the reference runs each architecture
    ``iters`` iterations with uda='target-only'): the model with the
    reference random init from seed 0, SGD at lr 1e-3, ``iters`` steps on
    one random batch with the same draws each step (the JAX smoke reuses
    its rngs); the last loss."""
    from ..apis import resolve_device
    from ..models.common import init_weights
    dev = resolve_device(device)
    model = model_builder().to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    init_weights(model, gen)
    img, lbl = supervised_batch(hw, num_classes, batch)
    img, lbl = torch.from_numpy(img).to(dev), torch.from_numpy(lbl).to(dev)
    draws = model.new_draws(batch, generator=gen, device=dev)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    loss = None
    for _ in range(iters):
        loss = supervised_step(model, opt, img, lbl, draws)
    return float(loss)


def uda_grid():
    """(name, config) of the DACS train types and ablation knobs on the
    tiny config."""
    base = C.tiny_test_config()
    variants = []
    for tt in ["cs2dsec_image+events_together", "cs2dsec_image+events",
               "cs2dz_image+raw-isr"]:
        variants.append((tt, C.replace(base, model=C.replace(
            base.model, train_type=tt))))
    variants.append(("cs2dz_image+raw-isr_split", C.replace(
        base, model=C.replace(base.model,
                              train_type="cs2dz_image+raw-isr_split",
                              fusion="", fusion_isr="", split_cls=True))))
    variants.append(("cs2dz_image+raw-isr_no-fusion", C.replace(
        base, model=C.replace(base.model,
                              train_type="cs2dz_image+raw-isr_no-fusion",
                              fusion="", fusion_isr="", split_cls=True,
                              events_classes=2),
        uda=C.replace(base.uda, isr_edge=True))))
    variants.append(("cs2dz_image+d2n-isr", C.replace(
        base, model=C.replace(base.model, train_type="cs2dz_image+d2n-isr",
                              fusion="", fusion_isr=""))))
    events = C.replace(base.model, train_type="cs2dsec_image+events")
    variants.append(("isr_another_fusion", C.replace(
        base, uda=C.replace(base.uda, isr_another_fusion=True))))
    variants.append(("isr_another_fusion_image+events", C.replace(
        base, model=events,
        uda=C.replace(base.uda, isr_another_fusion=True))))
    variants.append(("isr_no_fusion", C.replace(
        base, model=events, uda=C.replace(base.uda, isr_no_fusion=True))))
    variants.append(("shift_3_channel+isr_noise", C.replace(
        base, uda=C.replace(base.uda, shift_3_channel=True,
                            isr_noise_dacs_type="noise+blur"))))
    variants.append(("fuse_both_ice_and_e", C.replace(
        base, uda=C.replace(base.uda, fuse_both_ice_and_e=True))))
    variants.append(("without_events", C.replace(
        base, uda=C.replace(base.uda, without_events=True))))
    variants.append(("without_isd", C.replace(
        base, uda=C.replace(base.uda, without_isd=True))))
    return variants


def _org_base():
    base = C.tiny_test_config()
    return C.replace(base, model=C.replace(base.model,
                                           train_type="cs2dz_image",
                                           fusion="", fusion_isr=""))


def legacy_uda_grid():
    """(name, config) of OrgDACS's variant axes (dacs, the feature
    distance, alpha 0.999 with the thing classes, the cropped pseudo
    weight) on the tiny config."""
    base = _org_base()
    return [
        ("org_dacs", base),
        ("org_dacs_fd", C.replace(base, uda=C.replace(
            base.uda, imnet_feature_dist_lambda=0.005))),
        ("org_dacs_a999_fdthings", C.replace(base, uda=C.replace(
            base.uda, alpha=0.999, imnet_feature_dist_lambda=0.005,
            imnet_feature_dist_classes=_FD_THINGS,
            imnet_feature_dist_scale_min_ratio=0.75))),
        ("org_dacs_plcrop", C.replace(base, uda=C.replace(
            base.uda, pseudo_weight_ignore_top=15,
            pseudo_weight_ignore_bottom=120))),
    ]


def _legacy_uda_cfg(base, uda: str, rcs_T, plcrop: bool, num_classes=19,
                    warmup=True):
    """A reference legacy uda id (dacs / dacs_fd / dacs_fdthings /
    dacs_a999_fdthings) with the RCS temperature, plcrop and schedule
    knobs, as a RunConfig."""
    u = C.replace(base.uda, alpha=0.999 if "a999" in uda else 0.99)
    if "fdthings" in uda:
        u = C.replace(u, imnet_feature_dist_lambda=0.005,
                      imnet_feature_dist_classes=_FD_THINGS,
                      imnet_feature_dist_scale_min_ratio=0.75)
    elif "fd" in uda:
        u = C.replace(u, imnet_feature_dist_lambda=0.005,
                      imnet_feature_dist_classes=tuple(range(num_classes)),
                      imnet_feature_dist_scale_min_ratio=0.75)
    else:
        u = C.replace(u, imnet_feature_dist_lambda=0.0)
    if plcrop:
        u = C.replace(u, pseudo_weight_ignore_top=15,
                      pseudo_weight_ignore_bottom=120)
    data = C.replace(base.data, num_classes=num_classes,
                     rcs_enabled=rcs_T is not None,
                     rcs_class_temp=rcs_T if rcs_T is not None else 0.01)
    optim = base.optim if warmup else C.replace(base.optim, warmup_iters=0)
    return C.replace(base, uda=u, data=data, optim=optim)


def legacy_table_grid(exp_id: int):
    """The ablation-table grids 3-8 as combo dicts, seeds collapsed to one;
    names follow the reference's source2target_uda_arch_backbone_schedule
    scheme."""
    combos = []

    def add(arch, backbone, uda, rcs_T=None, plcrop=False, warmup=True,
            nc=19, source="gta", target="cs"):
        if "dacs" not in uda:   # rcs and plcrop apply to dacs only
            rcs_T, plcrop = None, False
        uda_mod = uda
        if rcs_T is not None:
            uda_mod += "_rcsinf" if rcs_T == math.inf else f"_rcs{rcs_T}"
        if plcrop:
            uda_mod += "_cpl"
        sched = "poly10warm" if warmup else "poly10"
        combos.append(dict(
            name=f"{source}2{target}_{uda_mod}_{arch}_{backbone}_{sched}"
                 .replace(".", ""),
            arch=arch, backbone=backbone, uda=uda, rcs_T=rcs_T,
            plcrop=plcrop, warmup=warmup, num_classes=nc))

    if exp_id == 3:    # encoder study
        for arch, bb in [("dlv2red", "r50v1c"), ("dlv2red", "s50"),
                         ("dlv2red", "s101"), ("dlv2red", "s200"),
                         ("segformer", "mitb3"), ("segformer", "mitb4")]:
            for uda in ["source-only", "dacs", "target-only"]:
                add(arch, bb, uda)
    elif exp_id == 4:  # LR warmup ablation: poly10 without warmup
        for arch, bb in [("dlv2red", "r101v1c"), ("segformer", "mitb5")]:
            for uda in ["dacs", "target-only"]:
                add(arch, bb, uda, warmup=False)
    elif exp_id == 5:  # RCS and the feature distance
        for arch, bb, uda, rcs_T, plcrop in [
                ("segformer", "mitb5", "dacs", math.inf, False),
                ("segformer", "mitb5", "dacs", 0.01, False),
                ("segformer", "mitb5", "dacs_fd", None, False),
                ("segformer", "mitb5", "dacs_fdthings", None, False),
                ("segformer", "mitb5", "dacs_fdthings", 0.01, False),
                ("segformer", "mitb5", "dacs_a999_fdthings", 0.01, True),
                ("dlv2red", "r101v1c", "dacs_a999_fdthings", 0.01, True)]:
            add(arch, bb, uda, rcs_T, plcrop)
    elif exp_id == 6:  # decoder study
        for arch in ["daformer_conv1", "upernet", "upernet_ch256",
                     "daformer_isa", "daformer_sepaspp_bottleneck",
                     "daformer_aspp", "daformer_sepaspp"]:
            for uda in ["dacs_a999_fdthings", "target-only"]:
                add(arch, "mitb5", uda, 0.01, True)
    elif exp_id == 7:  # the final DAFormer on SYNTHIA, 16 classes
        add("daformer_sepaspp", "mitb5", "dacs_a999_fdthings", 0.01, True,
            nc=16, source="syn")
    elif exp_id == 8:  # further datasets
        for target in ["acdc", "dzur"]:
            add("daformer_sepaspp", "mitb5", "dacs_a999_fdthings", 0.01,
                True, source="cs", target=target)
    else:
        raise ValueError(f"unknown legacy grid id {exp_id}")
    return combos


def legacy_combo_run(combo, iters: int = 2, device="cuda"):
    """One combo of grids 3-8 for ``iters`` steps: its RCS temperature
    through ``rcs_class_probs`` on synthetic class statistics, then OrgDACS
    for the 'dacs*' ids and the supervised smoke for source-/target-only."""
    nc = combo["num_classes"]
    builder = _legacy_model_builder(combo["arch"], combo["backbone"], nc)
    out = {}
    if combo["rcs_T"] is not None:
        from ..data.uda import rcs_class_probs
        stats = {f"f{i}": {str(c): (c + 1) * 100 for c in range(nc)}
                 for i in range(3)}
        _, probs = rcs_class_probs(stats, combo["rcs_T"], nc)
        if abs(float(np.sum(probs)) - 1.0) >= 1e-6:
            raise ValueError(f"RCS probabilities sum to {np.sum(probs)}")
        out["rcs_prob_max"] = round(float(np.max(probs)), 4)
    if combo["uda"] in ("source-only", "target-only"):
        out["loss"] = supervised_smoke(combo["name"], builder, iters,
                                       num_classes=nc, device=device)
        return out
    cfg = _legacy_uda_cfg(_org_base(), combo["uda"], combo["rcs_T"],
                          combo["plcrop"], num_classes=nc,
                          warmup=combo["warmup"])
    out["loss"] = org_smoke_run(combo["name"], cfg, iters, device=device,
                                model_builder=builder)
    return out


def _synthetic_pair(cfg, with_events: bool):
    from ..data.synthetic import SyntheticSource, SyntheticTarget
    from ..data.uda import UDAPairDataset
    src = SyntheticSource(crop_size=cfg.data.crop_size,
                          with_time_res=with_events,
                          num_classes=cfg.data.num_classes)
    tgt = SyntheticTarget(crop_size=cfg.data.crop_size,
                          with_events=with_events,
                          num_classes=cfg.data.num_classes)
    return UDAPairDataset(src, tgt, seed=0)


def org_smoke_run(name, cfg, iters: int = 2, device="cuda",
                  model_builder=None):
    """``iters`` OrgDACS steps; ``model_builder`` swaps the MiT
    EncoderDecoder for a legacy combo (built twice with the feature
    distance: its frozen ImageNet twin is random from the seed). Without
    one, the frozen MiT of the distance is random from the seed too (real
    runs load ImageNet weights through the train CLI's ``--imnet``)."""
    from ..models.common import init_weights
    from ..models.mit import MIT_VARIANTS, MixVisionTransformer
    from ..uda.org_dacs import OrgDACSTrainer
    fdist = cfg.uda.imnet_feature_dist_lambda > 0
    trainer = OrgDACSTrainer(
        cfg, device,
        model=model_builder() if model_builder else None,
        imnet_model=model_builder() if (model_builder and fdist) else None)
    imnet_sd = None
    if fdist and model_builder is None:
        mit = MixVisionTransformer(MIT_VARIANTS[cfg.model.backbone]).to(
            trainer.device)
        gen = torch.Generator(device=trainer.device)
        gen.manual_seed(7)
        init_weights(mit, gen)
        imnet_sd = mit.state_dict()
    state = trainer.init_state(seed=0, imnet_state_dict=imnet_sd)
    return _run_iters(cfg, _synthetic_pair(cfg, False), trainer, state,
                      iters)


def smoke_run(name, cfg, iters: int = 2, device="cuda"):
    """``iters`` DACS steps of ``cfg`` on synthetic data."""
    from ..uda.dacs import DACSTrainer
    trainer = DACSTrainer(cfg, device=device)
    state = trainer.init_state(seed=0)
    return _run_iters(cfg, _synthetic_pair(
        cfg, cfg.model.train_type.startswith("cs2dsec")), trainer, state,
        iters)


def _run_iters(cfg, pair, trainer, state, iters):
    from ..data.loader import collate
    logs = None
    for i in range(iters):
        batch = collate([pair[j] for j in range(cfg.data.batch_size)])
        if cfg.model.train_type == "cs2dz_image+d2n-isr":
            g = np.random.default_rng(i)
            b, (h, w) = cfg.data.batch_size, cfg.data.crop_size
            batch["target"]["day_image"] = g.normal(
                size=(b, h, w, 3)).astype(np.float32)
            batch["target"]["day_isr"] = g.normal(
                size=(b, h, w, 3)).astype(np.float32)
        state, logs = trainer.train_step(state, batch)
    return float(logs["loss"])


def _run(results, name, fn):
    try:
        r = fn()
        r = r if isinstance(r, dict) else {"loss": r}
        results[name] = {"ok": True, **r}
        print(f"[OK]   {name}: loss={r['loss']:.3f}", flush=True)
    except Exception as e:   # noqa: BLE001 - every combo is reported
        results[name] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        print(f"[FAIL] {name}: {e}", flush=True)
        traceback.print_exc()


def main(argv=None):
    """Run the grid; returns the results dict (exits 1 if any combo
    failed)."""
    ap = argparse.ArgumentParser(description="cmda_tpu_torch experiment "
                                             "grids")
    ap.add_argument("--exp", type=int, required=True,
                    help="1=cs2dsec 2=cs2dz 3..8=the ablation-table grids "
                         "(smoke mode) 100=architecture grid 101=UDA grid "
                         "102=legacy OrgDACS grid")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--only", default=None,
                    help="substring filter on combo names (grids 3-8)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.exp in (1, 2):
        from .train import main as train_main
        return train_main(["--config", "cs2dsec" if args.exp == 1
                           else "cs2dz", "--device", args.device])

    results = {}
    it, dev = args.iters, args.device
    if args.exp == 100:
        for name, cfg in architecture_grid():
            _run(results, name, lambda: smoke_run(name, cfg, it, dev))
        for name, builder in legacy_architecture_grid():
            _run(results, name,
                 lambda: supervised_smoke(name, builder, it, device=dev))
    elif args.exp in (3, 4, 5, 6, 7, 8):
        for combo in legacy_table_grid(args.exp):
            if args.only and args.only not in combo["name"]:
                continue
            _run(results, combo["name"],
                 lambda: legacy_combo_run(combo, it, dev))
    elif args.exp == 102:
        for name, cfg in legacy_uda_grid():
            _run(results, name, lambda: org_smoke_run(name, cfg, it, dev))
    elif args.exp == 101:
        for name, cfg in uda_grid():
            _run(results, name, lambda: smoke_run(name, cfg, it, dev))
    else:
        raise SystemExit(f"unknown --exp {args.exp}")
    print(json.dumps(results, indent=2))
    if not all(r["ok"] for r in results.values()):
        sys.exit(1)
    return results


if __name__ == "__main__":
    main()
