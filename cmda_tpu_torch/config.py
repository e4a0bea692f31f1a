"""Typed configuration tree of the PyTorch port (mirrors ``cmda_tpu.config``).

Plain frozen dataclasses, copied field for field from the JAX package so a
preset means the same run in both packages (``tests/test_torch_package.py``
holds the field sets and defaults equal). Presets:
  * ``cs2dsec_image_events_b5`` == configs/fusion/cs2dsec_image+events_together_b5.py
  * ``cs2dz_image_rawisr_b5``   == configs/fusion/cs2dz_image+raw-isr_b5.py
  * ``tiny_test_config`` / ``micro_test_config``: CPU-testable miniatures.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Sequence

from .models.daformer import DAFormerHeadConfig
from .models.segmentor import SegmentorConfig


@dataclass(frozen=True)
class IsrParams:
    """Image Self-Residual parameters (per domain / per use)."""
    val_range: tuple[float, float] = (0.01, 1.01)
    threshold: float = 0.005
    clip_range: float = 0.1
    shift_pixel: int = 1

    @staticmethod
    def from_string(s: str) -> "IsrParams":
        """Parse the dash string ``lo-hi-threshold-clip-shift``."""
        v = [float(x) for x in s.split("-")]
        if len(v) != 5:
            raise ValueError(f"expected lo-hi-threshold-clip-shift, got {s!r}")
        return IsrParams((v[0], v[1]), v[2], v[3], int(v[4]))


# Per-domain ISR default tables keyed by *_isr_data_type ('day'/'night' for
# raw frames, 'new_day'/'new_night' for style-transferred frames).
CS_ISR_PRESETS = {
    "day": IsrParams((1.0, 10.0), 0.03, 0.2, 3),
    "new_day": IsrParams((1e-5, 255 + 1e-5), 0.0, 0.040, 3),
}
CS_ISR_PRESETS_3 = {
    "day": (IsrParams((1.0, 10.0), 0.025, 0.05, 1),
            IsrParams((1.0, 10.0), 0.030, 0.20, 3),
            IsrParams((1.0, 10.0), 0.040, 0.32, 5)),
    "new_day": (IsrParams((1e-5, 255 + 1e-5), 0.0, 0.015, 1),
                IsrParams((1e-5, 255 + 1e-5), 0.0, 0.040, 3),
                IsrParams((1e-5, 255 + 1e-5), 0.0, 0.070, 5)),
}
DZ_ISR_PRESETS = {
    "night": IsrParams((1.0, 100.0), 0.04, 0.2, 3),
    "new_night": IsrParams((500.0, 1000.0), 0.02, 0.12, 3),
}
DZ_ISR_PRESETS_3 = {
    "night": (IsrParams((9.0, 255 + 9.0), 0.012, 0.04, 1),
              IsrParams((9.0, 255 + 9.0), 0.012, 0.12, 3),
              IsrParams((9.0, 255 + 9.0), 0.012, 0.20, 5)),
    "new_night": (IsrParams((500.0, 1000.0), 0.015, 0.05, 1),
                  IsrParams((500.0, 1000.0), 0.020, 0.12, 3),
                  IsrParams((500.0, 1000.0), 0.025, 0.20, 5)),
}


@dataclass(frozen=True)
class UDAConfig:
    """DACS self-training hyperparameters. Only the serving path reads any
    of them in this package so far; the rest wait for the trainer."""
    alpha: float = 0.999
    pseudo_threshold: float = 0.968
    pseudo_weight_ignore_top: int = 0
    pseudo_weight_ignore_bottom: int = 0
    blur: bool = True
    color_jitter_strength: float = 0.2
    color_jitter_probability: float = 0.2
    source_only: bool = False
    loss_weight_image: float = 0.5
    loss_weight_events: float = 0.5
    loss_weight_fusion: float = 0.5
    loss_weight_isr: float = 0.25
    stacked_stream_ce: bool = False
    pallas_ce: bool = True
    teacher_bf16: bool = False
    random_choice_thres: float | str = 0.5
    mixed_image_to_mixed_isr: bool = True
    isr_params: IsrParams = field(default_factory=IsrParams)
    shift_type: str = "random"
    imnet_feature_dist_lambda: float = 0.0
    imnet_feature_dist_classes: Sequence[int] = (6, 7, 11, 12, 13, 14, 15, 16, 17, 18)
    imnet_feature_dist_scale_min_ratio: float = 0.75
    isr_another_fusion: bool = False
    isr_no_fusion: bool = False
    isr_edge: bool = False
    lambda_isr_features: float = 1.0
    isr_edge_class_weight: float = -1.0
    isr_mix_aug: bool = False
    img_self_res_reg: str = "no"
    fuse_both_ice_and_e: bool = False
    without_events: bool = False
    without_isd: bool = False
    lambda_feature_consistency: float = 0.25
    use_cyclegan_day_events: bool = True
    use_pallas_isr: bool = True
    shift_3_channel: bool = False
    isr_params_3: tuple[IsrParams, ...] = (
        IsrParams((1.0, 10.0), 0.025, 0.05, 1),
        IsrParams((1.0, 10.0), 0.030, 0.20, 3),
        IsrParams((1.0, 10.0), 0.040, 0.32, 5))
    isr_noise_dacs_type: str = ""
    deflare_aug: bool = False


@dataclass(frozen=True)
class OptimConfig:
    """AdamW + poly-with-warmup (head lr x10, no decay for norm params)."""
    lr: float = 6e-5
    betas: tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.01
    head_lr_mult: float = 10.0
    warmup_iters: int = 1500
    warmup_ratio: float = 1e-6
    power: float = 1.0
    min_lr: float = 0.0
    max_iters: int = 40000
    grad_clip: float | None = None
    moment_dtype: str = "float32"


@dataclass(frozen=True)
class DataConfig:
    batch_size: int = 2
    crop_size: tuple[int, int] = (512, 512)
    target_crop_size: tuple[int, int] = (400, 400)
    num_classes: int = 19
    source: str = "cityscapes_ic"
    target: str = "dsec"
    source_root: str = "data/cityscapes"
    target_root: str = "data/dsec"
    events_bins: int = 1
    events_clip_scale: float = 1.5 / 500000.0
    rcs_enabled: bool = True
    rcs_class_temp: float = 0.01
    rcs_min_pixels: int = 3000
    rcs_min_crop_ratio: float = 0.5
    source_isr: IsrParams = field(default_factory=IsrParams)
    target_isr: IsrParams = field(default_factory=IsrParams)
    source_isr_3: tuple[IsrParams, ...] = CS_ISR_PRESETS_3["day"]
    target_isr_3: tuple[IsrParams, ...] = DZ_ISR_PRESETS_3["night"]
    cs_isr_data_type: str = "day"
    dz_isr_data_type: str = "night"
    dz_auto_threshold: bool = False
    shift_type: str = "random"
    workers: int = 4
    decode_cache: int = 0
    device_prefetch: int = 1
    wire_bf16: bool = True
    isr_noise: bool = False
    isr_cow_mask: bool = False
    flare_dir: str | None = None
    sky_noise_dir: str | None = None
    sky_mask: bool = False
    shift_3_channel: bool = False
    high_resolution_isr: bool = False
    events_clip_range: tuple[float, float] | None = None
    image_change_range: int = 1
    return_gi_or_ic: str = "image_change"


@dataclass(frozen=True)
class RunConfig:
    name: str = "cs2dsec_image+events_b5"
    seed: int = 0
    work_dir: str = "work_dirs"
    model: SegmentorConfig = field(default_factory=SegmentorConfig)
    uda: UDAConfig = field(default_factory=UDAConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    eval_interval: int = 4000
    checkpoint_interval: int = 40000
    checkpoint_max_keep: int = 1
    log_interval: int = 50
    debug_img_interval: int = 500
    dtype: str = "float32"  # model compute dtype: 'float32' | 'bfloat16'


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def _coerce(value, template, annotation: str = ""):
    """A string override coerced to the type of the field's current value
    (``template``). ``annotation`` is the field's declared type as a
    string: a union with ``str`` keeps the raw string when a numeric cast
    fails, a union with ``None`` takes 'none'; anything else that does not
    cast raises instead of putting a str into an int field."""
    if not isinstance(value, str):
        return value
    s = value.strip()
    if s.lower() in ("none", "null") and (template is None
                                          or "None" in annotation):
        return None
    if isinstance(template, bool):
        return s.lower() in ("1", "true", "yes", "on")
    if isinstance(template, (int, float)):
        try:
            return type(template)(s)
        except ValueError:
            if isinstance(template, int):
                try:            # ints written 1e4 / 4e4
                    f = float(s)
                    if f == int(f):
                        return int(f)
                except ValueError:
                    pass
            if "str" in annotation:
                return s   # a union field (random_choice_thres 'a-b')
            raise ValueError(
                f"cannot coerce {s!r} to {type(template).__name__} "
                f"(field type {annotation or type(template).__name__})")
    if isinstance(template, IsrParams):
        return IsrParams.from_string(s)
    if isinstance(template, (tuple, list)):
        elem = template[0] if len(template) else None
        parts = [p for p in s.replace(",", " ").split() if p]
        return type(template)(_coerce(p, elem) for p in parts)
    if isinstance(template, str):
        return s
    if s.lower() in ("none", "null"):
        return None
    if template is None:
        # an untyped slot: a scalar, a tuple of them, or the string
        if "," in s:
            return tuple(_coerce(p, None) for p in s.split(",") if p.strip())
        for cast in (int, float):
            try:
                return cast(s)
            except ValueError:
                pass
        if s.lower() in ("true", "false"):
            return s.lower() == "true"
        return s
    return s


def set_by_path(cfg, path: str, value):
    """A copy of the frozen config tree with the dotted ``path`` (e.g.
    ``uda.pseudo_threshold``) set to ``value``, a string coerced against
    the field's current value. An unknown field raises KeyError."""
    head, _, rest = path.partition(".")
    if not hasattr(cfg, head):
        raise KeyError(f"no config field {head!r} on {type(cfg).__name__} "
                       f"(path {path!r})")
    cur = getattr(cfg, head)
    if rest:
        new = set_by_path(cur, rest, value)
    else:
        ann = ""
        for f in dataclasses.fields(cfg):
            if f.name == head:
                ann = f.type if isinstance(f.type, str) else str(f.type)
        new = _coerce(value, cur, ann)
    return dataclasses.replace(cfg, **{head: new})


def apply_overrides(cfg, overrides):
    """``["a.b.c=value", ...]`` (the CLIs' ``--set``) applied in order."""
    for ov in overrides or ():
        path, eq, val = ov.partition("=")
        if not eq:
            raise ValueError(f"override {ov!r} is not KEY=VALUE")
        cfg = set_by_path(cfg, path.strip(), val)
    return cfg


def cs2dsec_image_events_b5(**overrides) -> RunConfig:
    """Flagship: Cityscapes(image+IC) -> DSEC-Night image+events fusion UDA."""
    cfg = RunConfig(
        name="cs2dsec_image+events_b5",
        model=SegmentorConfig(
            backbone="mit_b5",
            train_type="cs2dsec_image+events_together",
            fusion="attention_avg",
            fusion_isr="attention",
            share_decoder="full",
            remat=True,
            head=DAFormerHeadConfig()),
        uda=UDAConfig(),
        optim=OptimConfig(),
        data=DataConfig(),
    )
    return replace(cfg, **overrides) if overrides else cfg


def cs2dz_image_rawisr_b5(**overrides) -> RunConfig:
    """Cityscapes -> DarkZurich image+raw-ISR fusion UDA
    (configs/fusion/cs2dz_image+raw-isr_b5.py)."""
    cfg = RunConfig(
        name="cs2dz_image+raw-isr_b5",
        model=SegmentorConfig(
            backbone="mit_b5",
            train_type="cs2dz_image+raw-isr",
            fusion="attention",
            fusion_isr="",
            share_decoder="full",
            remat=True,
            head=DAFormerHeadConfig()),
        uda=UDAConfig(
            mixed_image_to_mixed_isr=True,
            loss_weight_image=0.7, loss_weight_events=0.7,
            loss_weight_fusion=0.7, loss_weight_isr=0.25,
            pseudo_weight_ignore_top=15, pseudo_weight_ignore_bottom=120,
            shift_type="rightdown",
            isr_params=IsrParams(val_range=(1.0, 100.0), threshold=0.01,
                                 clip_range=0.1, shift_pixel=3),
            use_cyclegan_day_events=False),
        optim=OptimConfig(),
        data=DataConfig(source="cityscapes_ic", target="dark_zurich",
                        target_root="data/dark_zurich",
                        source_isr=IsrParams(val_range=(1.0, 100.0),
                                             threshold=0.01, clip_range=0.1,
                                             shift_pixel=3),
                        target_isr=IsrParams(val_range=(1.0, 100.0),
                                             threshold=0.01, clip_range=0.1,
                                             shift_pixel=3),
                        shift_type="rightdown"),
    )
    return replace(cfg, **overrides) if overrides else cfg


def tiny_test_config(**overrides) -> RunConfig:
    """CPU-testable miniature (mit_b0, small crops)."""
    cfg = RunConfig(
        name="tiny",
        model=SegmentorConfig(
            backbone="mit_b0",
            train_type="cs2dsec_image+events_together",
            fusion="attention_avg",
            fusion_isr="attention",
            share_decoder="full",
            head=DAFormerHeadConfig(in_channels=(32, 64, 160, 256),
                                    embed_dim=64, channels=64)),
        uda=UDAConfig(use_cyclegan_day_events=False),
        optim=OptimConfig(warmup_iters=10, max_iters=100),
        data=DataConfig(batch_size=2, crop_size=(64, 64)),
    )
    return replace(cfg, **overrides) if overrides else cfg


def micro_test_config(**overrides) -> RunConfig:
    """Smallest full-machinery config (mit_micro: 1 block/stage, 32x32)."""
    cfg = tiny_test_config()
    cfg = replace(
        cfg, name="micro",
        model=replace(cfg.model, backbone="mit_micro",
                      head=DAFormerHeadConfig(
                          in_channels=(16, 32, 64, 128),
                          embed_dim=32, channels=32)),
        data=replace(cfg.data, batch_size=2, crop_size=(32, 32)))
    return replace(cfg, **overrides) if overrides else cfg


PRESETS = {"cs2dsec": cs2dsec_image_events_b5,
           "cs2dz": cs2dz_image_rawisr_b5,
           "tiny": tiny_test_config,
           "micro": micro_test_config}
