"""OrgDACS, the image-only DAFormer self-training step (mirrors
cmda_tpu.uda.org_dacs.OrgDACSTrainer): one MiT ``EncoderDecoder`` student
and its EMA teacher, no events and no ISR. One ``train_step``:

  1. with ``use_cyclegan_day2night``, the frozen 3-channel CycleGAN on the
     source image (denormalised to [-1, 1], G, renormalised; no grad);
  2. the EMA update, alpha = min(1 - 1/(t+1), uda.alpha), over the
     parameters;
  3. the teacher: the EMA parameters on the student's BatchNorm running
     statistics, in eval mode, on the night image; its input-size logits
     give the pseudo-label (argmax) and the confidence-ratio weight, the
     rows ``uda.pseudo_weight_ignore_top`` / ``_bottom`` zeroed; plain
     torch, as the JAX step's softmax and argmax are XLA;
  4. ClassMix of the source into the night image with color jitter and
     Gaussian blur, the mixed label and weight;
  5. the source and the mixed training forward with the same drop-path and
     Dropout2d draws, BatchNorm's running statistics chained source ->
     mixed; the CE of each on its input-size logits (plain, no kernel: the
     JAX step's ``weighted_cross_entropy`` is XLA); with
     ``uda.imnet_feature_dist_lambda`` > 0 the ImageNet feature distance
     of the source features; ONE backward of l_src + l_mix (+ fdist), as
     the JAX step takes one ``value_and_grad`` over both forwards;
  6. ``optim.grad_clip``, then AdamW with the poly schedule and warmup.

Its random values are an ``OrgDACSDraws``, handed in or drawn from a
``torch.Generator`` on the device seeded from (cfg.seed, step). The step
launches none of the port's CUDA kernels.

``model=`` / ``imnet_model=`` swap the MiT ``EncoderDecoder`` for any
module with ``forward_with_features`` / ``extract_feat`` / ``new_draws``
(a ``GenericEncoderDecoder``: the legacy grids' DeepLabV2 on ResNet-101 and
the like), as the JAX trainer takes them; ``init_state`` moves them to the
trainer's device and gives them the reference random init from the seed.
A frozen ImageNet twin with BatchNorm runs on its running statistics, its
buffers loaded whole with its weights.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import torch

from ..apis import resolve_device
from ..config import RunConfig
from ..data.wire import decode_wire
from ..models.common import init_weights
from ..models.cyclegan import frozen_generator
from ..models.mit import MIT_VARIANTS
from ..models.segmentor import EncoderDecoder, ForwardDraws
from ..ops.augment import (class_mix_mask, jitter_factors,
                           maybe_color_jitter_normalized, maybe_gaussian_blur,
                           one_mix, sample_class_half)
from ..ops.losses import pixel_accuracy, weighted_cross_entropy
from ..ops.normalize import IMAGENET_MEAN, IMAGENET_STD
from ..train.optim import (clip_grad_global_norm_, make_optimizer,
                           make_schedules, set_lr, zero_missing_grads)
from ..utils.weights import load_pretrained_backbone
from .dacs import (DACSTrainState, _to_device, ema_update, frozen_imnet,
                   imnet_feature_distance)
from .transforms import pseudo_label_and_weight


@dataclass
class OrgDACSDraws:
    """Every random value of one OrgDACS step: mix_scores [B, C+1] (the
    ClassMix ranking); jitter_gate []; jitter (brightness, contrast,
    saturation [B, 1, 1, 1] in U[1-s, 1+s), hue [B, 1, 1] in U[-s, s));
    blur_gate []; sigma [] in U[0.15, 1.15); fwd: the drop-path uniforms
    and Dropout2d masks of both training forwards."""
    mix_scores: torch.Tensor
    jitter_gate: torch.Tensor
    jitter: tuple
    blur_gate: torch.Tensor
    sigma: torch.Tensor
    fwd: ForwardDraws

    def to(self, device) -> "OrgDACSDraws":
        return OrgDACSDraws(
            mix_scores=self.mix_scores.to(device),
            jitter_gate=self.jitter_gate.to(device),
            jitter=tuple(t.to(device) for t in self.jitter),
            blur_gate=self.blur_gate.to(device),
            sigma=self.sigma.to(device), fwd=self.fwd.to(device))


def _seeded(model: torch.nn.Module, device, seed: int) -> torch.nn.Module:
    """``model`` on ``device`` with the reference random init from
    ``seed``, in eval mode."""
    model = model.to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init_weights(model, gen)
    return model.eval()


def build_encoder_decoder(cfg: RunConfig, device, seed: int) -> EncoderDecoder:
    """The config's ``EncoderDecoder`` on ``device`` with the reference
    random init from ``seed``, in eval mode."""
    with torch.device(device):
        model = EncoderDecoder(cfg.model, dtype=cfg.dtype)
    return _seeded(model, device, seed)


def optimizer_step(cfg: RunConfig, state: DACSTrainState):
    """Zero gradients for parameters without one (optax decays them),
    ``optim.grad_clip``, then AdamW at the schedules' lr for update
    ``state.step``."""
    zero_missing_grads(state.model.parameters())
    if cfg.optim.grad_clip is not None:
        clip_grad_global_norm_(state.model.parameters(), cfg.optim.grad_clip)
    set_lr(state.optimizer, state.schedules, state.step)
    state.optimizer.step()
    state.step += 1


class OrgDACSTrainer:
    """The OrgDACS step of a RunConfig on ``device`` (cuda unless the caller
    asks for the CPU)."""

    def __init__(self, cfg: RunConfig, device="cuda", *,
                 use_cyclegan_day2night: bool = False, model=None,
                 imnet_model=None):
        """``model`` / ``imnet_model``: modules to train and to take the
        feature distance from in place of the config's MiT
        ``EncoderDecoder`` (``imnet_model`` only with the distance on, as
        the JAX trainer builds it)."""
        if model is None and cfg.model.backbone not in MIT_VARIANTS:
            raise ValueError(
                f"model.backbone {cfg.model.backbone!r} is not a MiT: pass "
                "model= (a GenericEncoderDecoder) for another backbone")
        for what, m in (("model", model), ("imnet_model", imnet_model)):
            if m is not None and not all(hasattr(m, a) for a in (
                    "forward_with_features", "extract_feat", "new_draws")):
                raise TypeError(f"{what}= needs forward_with_features, "
                                f"extract_feat and new_draws; got "
                                f"{type(m).__name__}")
        if cfg.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype={cfg.dtype!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model, self.imnet_model = model, imnet_model
        self.use_cyclegan_day2night = use_cyclegan_day2night
        self.enable_fdist = cfg.uda.imnet_feature_dist_lambda > 0
        # set to a list to collect (name, CUDA event, peak bytes, live
        # bytes) at the step's section boundaries, as DACSTrainer.marks
        self.marks = None

    def init_state(self, seed: int | None = None,
                   cyclegan_state_dict: dict | None = None,
                   imnet_state_dict: dict | None = None) -> DACSTrainState:
        """The student (reference random init from ``seed``, default
        ``cfg.seed``), the teacher as its copy, AdamW; with
        ``use_cyclegan_day2night`` the frozen 3-channel day -> night
        generator from ``cyclegan_state_dict`` or random from seed + 1; with
        the feature distance the frozen ImageNet encoder from
        ``imnet_state_dict`` (without it the step raises). With ``model=``
        the student is that module, seeded; with ``imnet_model=`` the
        frozen encoder is that module, random from seed + 2, its backbone
        (parameters and BatchNorm buffers) from ``imnet_state_dict`` when
        given (an mmcv ``resnet*_v1c`` state_dict for a ResNet)."""
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        model = (_seeded(copy.deepcopy(self.model), self.device, seed)
                 if self.model is not None
                 else build_encoder_decoder(cfg, self.device, seed))
        ema = copy.deepcopy(model).requires_grad_(False)
        cyclegan = (frozen_generator(cyclegan_state_dict, channels=3,
                                     device=self.device, seed=seed + 1)
                    if self.use_cyclegan_day2night else None)
        if not self.enable_fdist:
            imnet = None
        elif self.imnet_model is not None:
            imnet = _seeded(copy.deepcopy(self.imnet_model), self.device,
                            seed + 2)
            if imnet_state_dict is not None:
                load_pretrained_backbone(imnet.backbone, imnet_state_dict)
            imnet.requires_grad_(False)
        else:
            imnet = (frozen_imnet(cfg, self.device, seed, imnet_state_dict)
                     if imnet_state_dict is not None else None)
        return DACSTrainState(model=model, ema_model=ema,
                              optimizer=make_optimizer(
                                  model, cfg.optim,
                                  head=self.model is None),
                              cyclegan=cyclegan,
                              schedules=make_schedules(cfg.optim),
                              imnet=imnet)

    def new_draws(self, state: DACSTrainState, batch: int) -> OrgDACSDraws:
        """The draws of step ``state.step`` from a generator on the device
        seeded with (cfg.seed, step)."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed * 1_000_003 + state.step)

        def uniform(*shape, lo=0.0, hi=1.0):
            return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                               device=dev)
        jitter_gate, blur_gate = uniform(), uniform()
        sigma = uniform(lo=0.15, hi=1.15)
        mix_scores = uniform(batch, cfg.data.num_classes + 1)
        jitter = jitter_factors(batch, cfg.uda.color_jitter_strength, gen,
                                dev)
        fwd = state.model.new_draws(batch, generator=gen, device=dev)
        return OrgDACSDraws(mix_scores=mix_scores, jitter_gate=jitter_gate,
                            jitter=jitter, blur_gate=blur_gate, sigma=sigma,
                            fwd=fwd)

    def _mark(self, name):
        if self.marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev, torch.cuda.max_memory_allocated(),
                               torch.cuda.memory_allocated()))
            torch.cuda.reset_peak_memory_stats()

    @torch.no_grad()
    def _day2night(self, state: DACSTrainState, day_image):
        """The frozen day -> night CycleGAN on the normalized source image
        (reference dacs.py:368-372): to [-1, 1], G, back."""
        if state.cyclegan is None:
            return day_image
        mean = torch.tensor(IMAGENET_MEAN, device=day_image.device) / 255.0
        std = torch.tensor(IMAGENET_STD, device=day_image.device) / 255.0
        x = (day_image * std + mean - 0.5) / 0.5
        y = state.cyclegan(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return (y / 2.0 + 0.5 - mean) / std

    @torch.no_grad()
    def _prepare(self, state: DACSTrainState, batch: dict,
                 draws: OrgDACSDraws) -> dict:
        """Steps 1-4: the EMA update (in place), the teacher's pseudo-label
        and weight, and the mixed image, label and weight."""
        cfg, u = self.cfg, self.cfg.uda
        self._mark("start")
        day_image = self._day2night(state, batch["source"]["image"])
        day_label = batch["source"]["label"]
        night_image = batch["target"]["image"]
        self._mark("cyclegan")
        ema_update(state.ema_model, state.model, state.step, u.alpha)
        self._mark("ema")
        # the teacher reads the student's BatchNorm statistics
        torch._foreach_copy_(list(state.ema_model.buffers()),
                             list(state.model.buffers()))
        pseudo_label, pseudo_weight = pseudo_label_and_weight(
            state.ema_model(night_image), threshold=u.pseudo_threshold,
            ignore_top=u.pseudo_weight_ignore_top,
            ignore_bottom=u.pseudo_weight_ignore_bottom)
        self._mark("teacher")
        apply_jitter = draws.jitter_gate > u.color_jitter_probability
        apply_blur = (draws.blur_gate > 0.5 if u.blur
                      else torch.zeros((), dtype=torch.bool,
                                       device=self.device))
        selected = sample_class_half(draws.mix_scores, day_label,
                                     cfg.data.num_classes)
        masks = class_mix_mask(day_label, selected, cfg.data.num_classes)
        mixed_img = one_mix(masks, day_image, night_image)
        mixed_img = maybe_color_jitter_normalized(mixed_img, apply_jitter,
                                                  draws.jitter)
        mixed_img = maybe_gaussian_blur(mixed_img, draws.sigma, apply_blur)
        mixed_lbl = torch.where(masks, day_label, pseudo_label)
        mixed_weight = one_mix(masks, torch.ones_like(pseudo_weight),
                               pseudo_weight)
        self._mark("mix")
        return dict(day_image=day_image, day_label=day_label,
                    night_image=night_image, pseudo_label=pseudo_label,
                    pseudo_weight=pseudo_weight, masks=masks,
                    mixed_img=mixed_img, mixed_lbl=mixed_lbl,
                    mixed_weight=mixed_weight)

    def train_step(self, state: DACSTrainState, batch: dict,
                   draws: OrgDACSDraws | None = None):
        """One OrgDACS iteration on ``batch`` ({'source': {image, label},
        'target': {image}}: normalized NHWC float32 images, int32 labels;
        numpy arrays or tensors, or the wire dict of such a batch). Updates
        ``state`` in place; returns (state, logs), the logs 0-dim tensors on
        the device."""
        batch = decode_wire(_to_device(batch, self.device))
        if draws is None:
            draws = self.new_draws(state, batch["source"]["image"].shape[0])
        P = self._prepare(state, batch, draws)
        model, u = state.model, self.cfg.uda
        state.optimizer.zero_grad(set_to_none=True)
        logits_src, feats_src = model.forward_with_features(
            P["day_image"], True, draws.fwd)
        l_src = weighted_cross_entropy(logits_src, P["day_label"])
        logs = {"src/loss_seg": l_src,
                "src/acc_seg": pixel_accuracy(logits_src.detach(),
                                              P["day_label"])}
        del logits_src
        logits_mix, _ = model.forward_with_features(P["mixed_img"], True,
                                                    draws.fwd)
        l_mix = weighted_cross_entropy(logits_mix, P["mixed_lbl"],
                                       P["mixed_weight"])
        logs["mix/loss_seg"] = l_mix
        logs["mix/acc_seg"] = pixel_accuracy(logits_mix.detach(),
                                             P["mixed_lbl"])
        del logits_mix
        total = l_src + l_mix
        if self.enable_fdist:
            fd = imnet_feature_distance(self.cfg, state.imnet, feats_src[-1],
                                        P["day_image"], P["day_label"])
            logs["src/loss_imnet_feat_dist"] = fd
            total = total + fd
        logs["loss"] = total
        self._mark("forward")
        total.backward()
        del feats_src
        self._mark("backward")
        optimizer_step(self.cfg, state)
        self._mark("optimizer")
        logs["pseudo_weight"] = P["pseudo_weight"].mean()
        return state, {k: v.detach() for k, v in logs.items()}
