"""DACS, the CMDA self-training step (mirrors cmda_tpu.uda.dacs for every
train type of its ``DACSTrainer``: ``cs2dsec_image+events_together`` (the
flagship), ``cs2dsec_image+events``, ``cs2dz_image+raw-isr`` and the
DarkZurich ablations ``cs2dz_image+raw-isr_split``,
``cs2dz_image+raw-isr_no-fusion`` and ``cs2dz_image+d2n-isr``).

One ``train_step``:
  1. day events (the cs2dsec types): the frozen CycleGAN on the mean of the
     source temporal difference, repeated to 3 channels (no grad);
  2. the events-vs-ISR coin (False with ``uda.without_events``, True with
     ``uda.without_isd``, in every train type);
  3. the EMA teacher update BEFORE the pseudo-labels,
     alpha = min(1 - 1/(t+1), uda.alpha), over the parameters only;
     with ``uda.teacher_bf16`` the teacher's bfloat16 copy is refreshed
     from it;
  4. the teacher (dropout and drop-path off, BN on batch statistics that
     are not kept) on the night image and a second input, decoding only
     the fusion stream at stride 4: where(coin, events, ISR) for the
     cs2dsec types, the night ISR for cs2dz; with ``uda.fuse_both_ice_and_e``
     (events_together) the events+ISR double batch in mode ``fusion_all``,
     with ``uda.isr_no_fusion`` (cs2dsec_image+events) always the events,
     with ``uda.isr_another_fusion`` the events, or on an ISR coin the ISR
     in mode ``fusion_isr``; pseudo-labels and the
     confidence-ratio weight (top and bottom rows zeroed as the config
     says) through the fused upsample+argmax kernel;
  5. ClassMix of source into target with color jitter and Gaussian blur
     (and of the events, for the cs2dsec types); the mixed ISR recomputed
     from the mixed image (PIL-exact grayscale, then the batched ISR
     kernel, one random direction per image, or the config's fixed
     ``shift_type``; under ``shift_type='all'`` no kernel: the mean of the
     four directions' ISRs in plain torch (``ops/isr.py``), because the JAX
     step takes its Pallas ISR only for one direction per image
     (cmda_tpu/uda/dacs.py:197) and runs ``image_to_isr(...,
     shift_direction='all')`` otherwise, so this is its route, not a
     fall-back; with ``uda.shift_3_channel`` three launches, rightdown,
     one for each of ``uda.isr_params_3``, as the three channels), then
     with ``uda.isr_noise_dacs_type`` channel 0 blurred and noised
     (``add_noise_on_isr``) and repeated; or, with
     ``uda.mixed_image_to_mixed_isr=False``, the ClassMix of the source and
     target ISRs, with ``uda.isr_mix_aug`` given the mixed image's jitter
     and blur in the (x + 1) / 2 domain;
  6. the source forward and backward, then the mixed forward and backward,
     the gradients summed by accumulation (the source activations are freed
     before the mixed forward starts), each stream's CE through the fused
     upsample+CE kernels (with ``uda.stacked_stream_ce`` and four streams,
     one plain checkpointed resize+CE over the stack, as the JAX package's
     is XLA); both forwards take the same drop-path and
     Dropout2d draws, as the JAX step hands both the same rngs. The
     student's inputs: (image, events, ISR), four streams, for
     ``events_together``; (image, where(coin, events, ISR)) for
     ``cs2dsec_image+events`` and (image, ISR) for cs2dz, a single batch
     through the events backbone and three streams. Its mode: ``fusion_all``
     with ``uda.fuse_both_ice_and_e``; with ``uda.isr_another_fusion`` on an
     ISR coin ``fusion_isr`` (cs2dsec_image+events then takes the ISR); else
     ``default``. The JAX step compiles both coin graphs into a
     ``lax.cond``; the port reads the coin on the host once per step and
     runs the one graph. ``uda.isr_no_fusion`` (cs2dsec_image+events) weighs
     the fusion CE by ``loss_weight_fusion * coin`` in both passes.
     ``uda.source_only`` keeps steps 1-5 and the source pass only: no mixed
     forward, its gradients and BatchNorm statistics the source's;
  7. ``optim.grad_clip`` (the global norm of the summed gradient), then
     AdamW (head lr x10, no decay on norms; bfloat16 moments with
     ``optim.moment_dtype``), parameters without a gradient given zeros as
     optax would.

The DarkZurich ablations (cmda_tpu/uda/dacs.py:380-444, 581-662), each a
two-stream loss (``split_stream_loss``: image and events streams, each with
its own labels and pixel weights):
  * ``_split``: the teacher decodes the image and events streams on (night
    image, night ISR), each giving its own pseudo-label through the argmax
    kernel; both streams' losses x2, the events stream's mixed label and
    weight from its own pseudo-label;
  * ``_no-fusion``: teacher and student in mode ``no_fusion`` (no fusion
    stream), the image stream's pseudo-label for both; with
    ``uda.isr_edge`` the events (ISR) stream learns the labels' edge map
    (``seg_label_to_edge_label``), class-weighted [1 - w, w] when
    ``uda.isr_edge_class_weight`` w lies in [0, 1] (a plain checkpointed
    resize + CE, as it is XLA in the JAX step), and the mixed pass adds the
    ISR-feature consistency: ``lambda_isr_features`` x
    ``feature_consistency_loss`` of the student's image features against
    its own eval-mode features of the mixed ISR, detached;
  * ``d2n-isr``: the teacher's image stream on the target's day image gives
    the day pseudo-label (a plain argmax of the resized logits) that the
    events stream learns on the source pass; the night pseudo-label is the
    argmax of the mean of the image and events streams' softmaxes, with
    the confidence-ratio weight (no rows zeroed), all plain torch as it is
    XLA in JAX; a second ClassMix mask set drawn from the day pseudo-label
    (``StepDraws.mix_scores2``) mixes the day and night ISRs and the events
    stream's mixed label; no ISR kernel.
``uda.deflare_aug``: the teacher of the cs2dz types but d2n reads the
target's deflared pair (``image_deflare``, ``isr_deflare``). The ImageNet
feature distance (``uda.imnet_feature_dist_lambda`` > 0): the source pass
adds lambda x ``masked_feat_dist`` between the student's last image
feature map and the frozen ``EncoderDecoder``'s (``DACSTrainState.imnet``)
on the thing classes of the 32x-downscaled source label. A batch without a
key the train type or option reads (the day pair, the deflared pair)
raises ``KeyError`` naming it.

Randomness is injectable: ``train_step(state, batch, draws)`` takes a
``StepDraws``; without it the trainer draws one from its own
``torch.Generator`` on the device, seeded from the config's seed and the
step. ``jax.random`` streams cannot be reproduced in torch, so the tests
hand both packages the same numbers this way.

The batch may come in the compact wire format (``data/wire.py``): the step
decodes it on the device first, as the JAX step does inside its jit.
``debug_tensors`` is the snapshot of steps 1-5 for the ``class_mix_debug``
grids, with the draws of the step about to run; it applies the EMA to a
copy of the teacher, so it leaves the state as it was.

``cfg.dtype='bfloat16'`` is the JAX package's bfloat16 training (its
``bench.py`` step): float32 parameters, EMA, AdamW state and gradients;
the student and the teacher compute in bfloat16 with the qk softmax, the
norm statistics and the classifier in float32 (``models/common.py``), so
the stream logits, the losses and the pseudo-labels are float32 as there;
the CycleGAN, ClassMix, jitter, blur and the mixed ISR work on the float32
images.

``uda.teacher_bf16``: the teacher reads a bfloat16 cast of the EMA
parameters; the EMA itself stays float32. The JAX modules promote their
parameters to the module's ``dtype``, so with ``dtype='float32'`` that is a
float32 forward on bfloat16-rounded weights, and with ``'bfloat16'`` the
bfloat16 forward. The port keeps one copy of the teacher holding those
values (``DACSTrainState.teacher``), refreshed once per step after the EMA
update: the weights of the layers that compute in the model's dtype
(``Linear``, ``Conv2d``) in that dtype, the rest (norms, classifier) as
bfloat16-rounded float32, so no layer casts per call.

``model.head_batched_train`` decodes the head's streams as one stacked batch
in training too (``models/daformer.py``).

Any other train type raises ``NotImplementedError`` naming it and its
ROADMAP item. So does ``uda.pallas_ce=False`` or
``uda.use_pallas_isr=False``: in the JAX package they choose XLA's chain
over a Pallas kernel; the port always runs its CUDA kernels, and their
plain PyTorch versions are the tests' reference, on no path of the card.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field

import torch

from ..apis import build_model, resolve_device
from ..config import RunConfig
from ..data.loader import host_tensor
from ..data.wire import decode_wire
from ..models.common import Conv2d, Linear
from ..models.cyclegan import ResnetGenerator, frozen_generator
from ..models.common import init_weights
from ..models.segmentor import (EncoderDecoder, FusionEncoderDecoder,
                                ForwardDraws, check_model_options)
from ..ops.augment import (IsrNoiseDraws, add_noise_on_isr, class_mix_mask,
                           isr_noise_draws, jitter_factors,
                           maybe_color_jitter_normalized, maybe_gaussian_blur,
                           one_mix, sample_class_half)
from ..ops.isr import SHIFT_DIRECTIONS, image_change_from_gray, pil_grayscale
from ..ops.isr_kernel import batched_isr
from ..ops.normalize import denorm_image
from ..train.optim import (clip_grad_global_norm_, make_optimizer,
                           make_schedules, set_lr, zero_missing_grads)
from ..utils.weights import load_pretrained_backbone
from .transforms import (downscale_label_ratio, feature_consistency_loss,
                         masked_feat_dist, multi_stream_loss,
                         pseudo_label_and_weight_coarse,
                         seg_label_to_edge_label, split_stream_loss)

TOGETHER = "cs2dsec_image+events_together"
SPLIT = "cs2dz_image+raw-isr_split"
NO_FUSION = "cs2dz_image+raw-isr_no-fusion"
D2N = "cs2dz_image+d2n-isr"
TRAIN_TYPES = (TOGETHER, "cs2dsec_image+events", "cs2dz_image+raw-isr",
               SPLIT, NO_FUSION, D2N)
ISR_NOISE_TYPES = ("", "noise", "blur", "noise+blur")


@dataclass
class StepDraws:
    """Every random value of one step. Uniforms are U[0, 1) unless noted.

    coin []; mix_scores [B, C+1] (ClassMix ranking); jitter_gate [];
    jitter: (brightness, contrast, saturation [B, 1, 1, 1] in
    U[1-s, 1+s), hue [B, 1, 1] in U[-s, s)); blur_gate []; sigma [] in
    U[0.15, 1.15); isr_dirs [B] int32 in [0, 4); fwd: the drop-path
    uniforms and Dropout2d masks of the source and the mixed forward (one
    set for both, as the JAX step passes both forwards the same rngs);
    isr_noise: the ``add_noise_on_isr`` draws of the mixed ISR's channel 0
    [B, H, W, 1] with ``uda.isr_noise_dacs_type`` (None without it);
    mix_scores2 [B, C+1]: the d2n type's second ClassMix ranking, over the
    day pseudo-label (None for the other types)."""
    coin: torch.Tensor
    mix_scores: torch.Tensor
    jitter_gate: torch.Tensor
    jitter: tuple
    blur_gate: torch.Tensor
    sigma: torch.Tensor
    isr_dirs: torch.Tensor
    fwd: ForwardDraws
    isr_noise: IsrNoiseDraws | None = None
    mix_scores2: torch.Tensor | None = None

    def to(self, device) -> "StepDraws":
        """The same draws on ``device``."""
        def move(v):
            if v is None:
                return None
            if isinstance(v, (torch.Tensor, ForwardDraws)):
                return v.to(device)
            moved = tuple(t.to(device) for t in v)
            return v._make(moved) if isinstance(v, IsrNoiseDraws) else moved
        return StepDraws(**{k: move(v) for k, v in self.__dict__.items()})


@dataclass
class DACSTrainState:
    """The student, its EMA teacher, AdamW, the frozen CycleGAN and the
    number of steps taken; with ``uda.teacher_bf16``, ``teacher``, the
    bfloat16 copy of the EMA teacher that its forward reads (derived from
    ``ema_model`` each step, so no checkpoint holds it); with the ImageNet
    feature distance, ``imnet``, the frozen ImageNet ``EncoderDecoder``.
    ``train_step`` updates the state in place."""
    model: FusionEncoderDecoder
    ema_model: FusionEncoderDecoder
    optimizer: torch.optim.Optimizer
    cyclegan: ResnetGenerator | None = None
    step: int = 0
    schedules: dict = field(default_factory=dict)
    teacher: FusionEncoderDecoder | None = None
    imnet: EncoderDecoder | None = None


def _to_device(tree, device):
    """Numpy arrays or tensors -> contiguous tensors on ``device`` (no copy
    for a contiguous tensor already there)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return host_tensor(tree).to(device)


class DACSTrainer:
    """Builds the DACS step of a RunConfig on ``device`` (cuda unless the
    caller asks for the CPU)."""

    def __init__(self, cfg: RunConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._check_supported(cfg)
        train_type = cfg.model.train_type
        self.has_events = train_type.startswith("cs2dsec")
        # the events+ISR double batch and the four-stream loss
        self.together = train_type == TOGETHER
        u = cfg.uda
        # the step's graph depends on the coin: read it on the host
        self.coin_graph = (u.isr_another_fusion and self.has_events
                           and not (self.together and u.fuse_both_ice_and_e))
        # a graph of the step runs the ISR fusion module
        self.isr_fusion = self.coin_graph or (self.together
                                              and u.fuse_both_ice_and_e)
        # the DarkZurich ablations' two-stream losses
        self.split = train_type == SPLIT
        self.nofusion = train_type == NO_FUSION
        self.d2n = train_type == D2N
        self.two_stream = self.split or self.nofusion or self.d2n
        self.enable_fdist = u.imnet_feature_dist_lambda > 0
        # the [1 - w, w] class weight of no-fusion's edge stream
        self.edge_cw = None
        if u.isr_edge and 0.0 <= u.isr_edge_class_weight <= 1.0:
            self.edge_cw = torch.tensor([1.0 - u.isr_edge_class_weight,
                                         u.isr_edge_class_weight],
                                        dtype=torch.float32,
                                        device=self.device)
        # set to a list to collect (name, CUDA event, peak bytes since the
        # last mark, live bytes) at the step's section boundaries: a
        # device-time and memory breakdown
        self.marks = None

    @staticmethod
    def _check_supported(cfg):
        check_model_options(cfg.model)
        if cfg.model.train_type not in TRAIN_TYPES:
            raise NotImplementedError(
                f"model.train_type={cfg.model.train_type!r} is not ported "
                f"(ROADMAP queue A item 5; ported: {', '.join(TRAIN_TYPES)})")
        if cfg.uda.isr_edge and cfg.model.train_type != NO_FUSION:
            # edge labels live on the no-fusion ISR decoder only (reference
            # dacs.py:136-139)
            raise ValueError(f"uda.isr_edge needs model.train_type="
                             f"{NO_FUSION!r}")
        for name in ("pallas_ce", "use_pallas_isr"):
            if not getattr(cfg.uda, name):
                raise NotImplementedError(
                    f"uda.{name}=False is not supported: the port always "
                    "runs its CUDA kernels, and their plain PyTorch "
                    "versions are for the tests only")
        if cfg.uda.isr_noise_dacs_type not in ISR_NOISE_TYPES:
            raise ValueError(f"uda.isr_noise_dacs_type="
                             f"{cfg.uda.isr_noise_dacs_type!r} is not one of "
                             f"{ISR_NOISE_TYPES}")
        if cfg.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype={cfg.dtype!r}")
        if (cfg.model.train_type.startswith("cs2dsec")
                and (cfg.uda.isr_another_fusion
                     or cfg.uda.fuse_both_ice_and_e
                     and cfg.model.train_type == TOGETHER)
                and not cfg.model.fusion_isr):
            raise ValueError("uda.isr_another_fusion and "
                             "uda.fuse_both_ice_and_e need model.fusion_isr")
        if cfg.uda.img_self_res_reg not in {"no", "only_isr", "mixed",
                                            "average"}:
            raise ValueError(f"uda.img_self_res_reg="
                             f"{cfg.uda.img_self_res_reg!r}")

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_state(self, seed: int | None = None,
                   cyclegan_state_dict: dict | None = None,
                   imnet_state_dict: dict | None = None) -> DACSTrainState:
        """Student with the reference random init from ``seed`` (default
        ``cfg.seed``), the teacher as its copy, AdamW, the CycleGAN (from
        ``cyclegan_state_dict`` in reference keys, sized from it, or
        random) and, with the ImageNet feature distance, the frozen
        ImageNet encoder: an ``EncoderDecoder`` whose backbone holds
        ``imnet_state_dict`` (an NVlabs ``mit_bX.pth`` state_dict; its head,
        which the distance does not read, random from ``seed``). Without
        those weights ``imnet`` is None and the step raises, as the JAX
        step fails on its missing ``imnet_params``."""
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        model = build_model(cfg, self.device, seed)
        ema = copy.deepcopy(model).requires_grad_(False)
        cyclegan = None
        if self.has_events and cfg.uda.use_cyclegan_day_events:
            cyclegan = frozen_generator(cyclegan_state_dict,
                                        device=self.device, seed=seed + 1)
        imnet = None
        if self.enable_fdist and imnet_state_dict is not None:
            imnet = frozen_imnet(cfg, self.device, seed, imnet_state_dict)
        return DACSTrainState(model=model, ema_model=ema,
                              optimizer=make_optimizer(model, cfg.optim),
                              cyclegan=cyclegan,
                              schedules=make_schedules(cfg.optim),
                              teacher=self._teacher_copy(ema), imnet=imnet)

    def _teacher_copy(self, ema: FusionEncoderDecoder):
        """With ``uda.teacher_bf16``, a copy of ``ema`` whose parameters
        hold their bfloat16 rounding: in bfloat16 where the layer computes
        in the model's dtype and that dtype is bfloat16 (``Linear``,
        ``Conv2d``), in float32 otherwise; filled by ``_refresh_teacher``.
        None without the option."""
        if not self.cfg.uda.teacher_bf16:
            return None
        teacher = copy.deepcopy(ema)
        if teacher.dtype == torch.bfloat16:
            for mod in teacher.modules():
                if isinstance(mod, (Linear, Conv2d)):
                    for p in mod.parameters(recurse=False):
                        p.data = p.data.to(torch.bfloat16)
        _refresh_teacher(teacher, ema)
        return teacher

    def new_draws(self, state: DACSTrainState, batch: int,
                  hw: tuple[int, int] | None = None) -> StepDraws:
        """The draws of step ``state.step`` for ``batch`` images of size
        ``hw`` (default: ``data.crop_size``, which is (W, H)) from a
        generator on the device seeded with (cfg.seed, step). The ISR
        noise's come last, then d2n's second ClassMix ranking, so the
        other draws do not depend on them."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed * 1_000_003 + state.step)

        def uniform(*shape, lo=0.0, hi=1.0):
            return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                               device=dev)
        coin, jitter_gate, blur_gate = uniform(), uniform(), uniform()
        sigma = uniform(lo=0.15, hi=1.15)
        mix_scores = uniform(batch, cfg.data.num_classes + 1)
        jitter = jitter_factors(batch, cfg.uda.color_jitter_strength, gen,
                                dev)
        isr_dirs = torch.randint(0, 4, (batch,), generator=gen, device=dev,
                                 dtype=torch.int32)
        fwd = state.model.new_draws(batch, generator=gen, device=dev,
                                    with_isr=self.together,
                                    fusion_isr=self.isr_fusion)
        isr_noise = None
        if cfg.uda.isr_noise_dacs_type and cfg.uda.mixed_image_to_mixed_isr:
            h, w = hw if hw is not None else cfg.data.crop_size[::-1]
            isr_noise = isr_noise_draws((batch, h, w, 1), gen, dev)
        mix_scores2 = (uniform(batch, cfg.data.num_classes + 1) if self.d2n
                       else None)
        return StepDraws(
            coin=coin, mix_scores=mix_scores, jitter_gate=jitter_gate,
            jitter=jitter, blur_gate=blur_gate, sigma=sigma,
            isr_dirs=isr_dirs, fwd=fwd, isr_noise=isr_noise,
            mix_scores2=mix_scores2)

    # ------------------------------------------------------------------
    # pieces
    # ------------------------------------------------------------------
    def _mark(self, name):
        if self.marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev, torch.cuda.max_memory_allocated(),
                               torch.cuda.memory_allocated()))
            torch.cuda.reset_peak_memory_stats()

    @torch.no_grad()
    def _day_events(self, state, src):
        """CycleGAN(mean(img_time_res)) -> 3-channel day events."""
        if state.cyclegan is None:
            return src["img_time_res"]
        x = src["img_time_res"].mean(dim=-1, keepdim=True)
        y = state.cyclegan(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return y.expand(-1, -1, -1, 3)

    def _choice_thres(self, step: int) -> float:
        rc = self.cfg.uda.random_choice_thres
        if isinstance(rc, str):
            a, b = (float(s) for s in rc.split("-"))
            return a + (b - a) * (step / self.cfg.optim.max_iters)
        return float(rc)

    @staticmethod
    def _gray(mixed_img):
        """The mixed image as uint8 RGB, then PIL-exact grayscale, float32
        [B, H, W]."""
        rgb_u8 = (denorm_image(mixed_img) * 255.0).clamp(0, 255).to(
            torch.uint8)
        return pil_grayscale(rgb_u8).float().contiguous()

    @staticmethod
    def _isr_of_gray(gray, dir_idx, p, direction=None):
        """One batched ISR kernel launch on ``gray`` with the parameters
        ``p``, every image in ``direction`` when one is given, else in its
        own of ``dir_idx``; [B, H, W]."""
        if direction is not None:
            dir_idx = torch.full((gray.shape[0],),
                                 SHIFT_DIRECTIONS.index(direction),
                                 dtype=torch.int32, device=gray.device)
        return batched_isr(gray, dir_idx.to(torch.int32), val_range=tuple(
            p.val_range), threshold=p.threshold, clip_range=p.clip_range,
            shift_pixel=p.shift_pixel)

    def _mixed_isr(self, mixed_img, dir_idx):
        """The mixed image's ISR with ``uda.isr_params``, in the config's
        fixed ``shift_type``, else in each image's of ``dir_idx``;
        [B, H, W, 3]. ``shift_type='all'`` is the mean of the four single-
        axis ICs of each image, plain torch and no kernel launch, as the
        JAX step runs ``image_to_isr(..., shift_direction='all')`` there and
        its Pallas ISR only for one direction (cmda_tpu/uda/dacs.py:197)."""
        u = self.cfg.uda
        p = u.isr_params
        gray = self._gray(mixed_img)
        if u.shift_type == "all":
            isr = torch.stack([image_change_from_gray(
                g, val_range=tuple(p.val_range), threshold=p.threshold,
                clip_range=p.clip_range, shift_pixel=p.shift_pixel,
                shift_direction="all") for g in gray])
        else:
            direction = None if u.shift_type == "random" else u.shift_type
            isr = self._isr_of_gray(gray, dir_idx, p, direction)
        return isr[..., None].expand(-1, -1, -1, 3)

    def _mixed_isr_3ch(self, mixed_img):
        """The 3-channel mixed ISR (``uda.shift_3_channel``): one kernel
        launch for each of ``uda.isr_params_3``, rightdown, on one
        grayscale, stacked as the channels; [B, H, W, 3]."""
        gray = self._gray(mixed_img)
        return torch.stack([self._isr_of_gray(gray, None, p, "rightdown")
                            for p in self.cfg.uda.isr_params_3], dim=-1)

    def _loss_weights(self):
        u = self.cfg.uda
        return dict(w_image=u.loss_weight_image, w_events=u.loss_weight_events,
                    w_fusion=u.loss_weight_fusion, w_isr=u.loss_weight_isr)

    @torch.no_grad()
    def _prepare(self, state: DACSTrainState, batch: dict, draws: StepDraws,
                 ema_model: FusionEncoderDecoder,
                 teacher: FusionEncoderDecoder | None = None) -> dict:
        """Steps 1-5: the EMA update of ``ema_model`` (in place; the step
        passes ``state.ema_model``), the refresh of its bfloat16 copy
        ``teacher`` (``uda.teacher_bf16``, else None) and every tensor the
        two losses and the debug grids need (None where the train type has
        no such input)."""
        cfg, u = self.cfg, self.cfg.uda
        src, tgt = batch["source"], batch["target"]
        day_image, day_label = src["image"], src["label"]
        night_image, night_isr = tgt["image"], tgt["isr"]
        self._mark("start")
        day_events = night_events = None
        if self.has_events:
            day_events = self._day_events(state, src)
            night_events = tgt["events"]
        self._mark("cyclegan")

        apply_jitter = draws.jitter_gate > u.color_jitter_probability
        apply_blur = (draws.blur_gate > 0.5 if u.blur
                      else torch.zeros((), dtype=torch.bool,
                                       device=self.device))
        if u.without_events:
            use_events = torch.zeros((), dtype=torch.bool, device=self.device)
        elif u.without_isd:
            use_events = torch.ones((), dtype=torch.bool, device=self.device)
        else:
            use_events = draws.coin > self._choice_thres(state.step)
        # the one host read of the coin, where it picks the step's graph
        events_graph = bool(use_events) if self.coin_graph else None

        ema_update(ema_model, state.model, state.step, u.alpha)
        if teacher is not None:
            _refresh_teacher(teacher, ema_model)
        self._mark("ema")

        teacher_model = ema_model if teacher is None else teacher
        pl_kw = dict(threshold=u.pseudo_threshold,
                     ignore_top=u.pseudo_weight_ignore_top,
                     ignore_bottom=u.pseudo_weight_ignore_bottom)

        def teacher_out(*inputs, streams, resize=False):
            return teacher_model.forward_logits(
                *inputs, resize_to_input=resize, streams=streams, train=False,
                bn_train=True, bn_update=False)

        def coarse(logits):
            return pseudo_label_and_weight_coarse(
                logits, night_image.shape[1:3], **pl_kw)
        # the deflare ablation: the teacher of the cs2dz types reads the
        # flare-removed night pair (cmda_tpu/uda/dacs.py:316-319)
        pl_image, pl_isr = night_image, night_isr
        if u.deflare_aug:
            _require(tgt, ("image_deflare", "isr_deflare"), "uda.deflare_aug")
            pl_image, pl_isr = tgt["image_deflare"], tgt["isr_deflare"]
        pl2 = pw2 = target_day_pl = day_pair_isr = None
        if self.split:
            out = teacher_out(pl_image, pl_isr, None, "default",
                              streams=("image", "events"))
            pseudo_label, pseudo_weight = coarse(out["image_output"])
            pl2, pw2 = coarse(out["events_output"])
        elif self.nofusion:
            out = teacher_out(pl_image, pl_isr, None, "no_fusion",
                              streams=("image",))
            pseudo_label, pseudo_weight = coarse(out["image_output"])
        elif self.d2n:
            _require(tgt, ("day_image", "day_isr"), f"{D2N!r}")
            day_pair_isr = tgt["day_isr"].float()
            out = teacher_out(tgt["day_image"], None, None, "no_fusion",
                              streams=("image",), resize=True)
            target_day_pl = out["image_output"].argmax(dim=-1).to(
                torch.int32)
            out = teacher_out(night_image, night_isr, None, "default",
                              streams=("image", "events"), resize=True)
            avg = (0.5 * torch.softmax(out["image_output"].float(), dim=-1)
                   + 0.5 * torch.softmax(out["events_output"].float(),
                                         dim=-1))
            pseudo_label = avg.argmax(dim=-1).to(torch.int32)
            ratio = (avg.amax(dim=-1) >= u.pseudo_threshold).float().mean()
            pseudo_weight = torch.ones_like(avg[..., 0]) * ratio
        else:
            image, isr = ((night_image, night_isr) if self.has_events
                          else (pl_image, pl_isr))
            out = teacher_out(*self._teacher_inputs(
                image, night_events, isr, use_events, events_graph),
                streams=("fusion",))
            pseudo_label, pseudo_weight = coarse(out["fusion_output"])
        del out
        self._mark("teacher")

        selected = sample_class_half(draws.mix_scores, day_label,
                                     cfg.data.num_classes)
        masks = class_mix_mask(day_label, selected, cfg.data.num_classes)
        mixed_img = one_mix(masks, day_image, night_image)
        mixed_img = maybe_color_jitter_normalized(mixed_img, apply_jitter,
                                                  draws.jitter)
        mixed_img = maybe_gaussian_blur(mixed_img, draws.sigma, apply_blur)
        mixed_lbl = torch.where(masks, day_label, pseudo_label)
        ones = torch.ones_like(pseudo_weight)
        mixed_weight = one_mix(masks, ones, pseudo_weight)
        mixed_events = (one_mix(masks, day_events, night_events)
                        if self.has_events else None)
        mixed_lbl2 = mixed_weight2 = None
        if self.split:
            mixed_lbl2 = torch.where(masks, day_label, pl2)
            mixed_weight2 = one_mix(masks, ones, pw2)
        if self.d2n:
            # the second mask set, drawn from the day pseudo-label
            if draws.mix_scores2 is None:
                raise ValueError(f"{D2N!r} needs StepDraws.mix_scores2")
            sel2 = sample_class_half(draws.mix_scores2, target_day_pl,
                                     cfg.data.num_classes)
            masks2 = class_mix_mask(target_day_pl, sel2, cfg.data.num_classes)
            mixed_lbl2 = torch.where(masks2, target_day_pl, pseudo_label)
            mixed_isr = one_mix(masks2, day_pair_isr, night_isr.float())
        elif u.mixed_image_to_mixed_isr:
            mixed_isr = (self._mixed_isr_3ch(mixed_img) if u.shift_3_channel
                         else self._mixed_isr(mixed_img, draws.isr_dirs))
            if u.isr_noise_dacs_type:
                if draws.isr_noise is None:
                    raise ValueError("uda.isr_noise_dacs_type needs "
                                     "StepDraws.isr_noise")
                noisy = add_noise_on_isr(mixed_isr[..., :1], draws.isr_noise,
                                         u.isr_noise_dacs_type)
                mixed_isr = noisy.expand(-1, -1, -1, mixed_isr.shape[-1])
        else:
            # float32, as the JAX step holds the batch: the host ISR of the
            # DarkZurich loader comes as float64
            mixed_isr = one_mix(masks, src["img_self_res"].float(),
                                night_isr.float())
            if u.isr_mix_aug:
                # the reference's strong_transform with isr_flag
                # (dacs.py:757-758, dacs_transforms.py:11-35)
                isr_ms = (127.5,) * 3
                mixed_isr = maybe_color_jitter_normalized(
                    mixed_isr, apply_jitter, draws.jitter, mean=isr_ms,
                    std=isr_ms)
                mixed_isr = maybe_gaussian_blur(mixed_isr, draws.sigma,
                                                apply_blur)
        self._mark("mix")
        return dict(day_image=day_image, day_label=day_label,
                    day_isr=src["img_self_res"], day_events=day_events,
                    night_image=night_image, night_isr=night_isr,
                    night_events=night_events, use_events=use_events,
                    events_graph=events_graph,
                    pseudo_label=pseudo_label, pseudo_weight=pseudo_weight,
                    masks=masks,
                    mixed_img=mixed_img, mixed_lbl=mixed_lbl,
                    mixed_weight=mixed_weight, mixed_events=mixed_events,
                    mixed_isr=mixed_isr, mixed_lbl2=mixed_lbl2,
                    mixed_weight2=mixed_weight2, target_day_pl=target_day_pl,
                    day_pair_isr=day_pair_isr)

    def _teacher_inputs(self, image, events, isr, use_events, events_graph):
        """(image, second input, ISR, mode) of the teacher's forward
        (cmda_tpu/uda/dacs.py:338-366)."""
        u = self.cfg.uda
        if not self.has_events:
            return image, isr, None, "default"
        if self.together and u.fuse_both_ice_and_e:
            return image, events, isr, "fusion_all"
        if not self.together and u.isr_no_fusion:
            return image, events, None, "default"
        if self.coin_graph:
            return ((image, events, None, "default") if events_graph
                    else (image, isr, None, "fusion_isr"))
        return image, torch.where(use_events, events, isr), None, "default"

    def _student_inputs(self, P: dict):
        """(image, events, ISR) of the source and of the mixed forward, and
        the mode of both (cmda_tpu/uda/dacs.py:560-601)."""
        u = self.cfg.uda
        isr_graph = P["events_graph"] is False
        if self.together:
            mode = ("fusion_all" if u.fuse_both_ice_and_e
                    else "fusion_isr" if isr_graph else "default")
            return ((P["day_image"], P["day_events"], P["day_isr"]),
                    (P["mixed_img"], P["mixed_events"], P["mixed_isr"]), mode)
        if isr_graph:   # cs2dsec_image+events, the ISR fusion module
            return ((P["day_image"], P["day_isr"], None),
                    (P["mixed_img"], P["mixed_isr"], None), "fusion_isr")
        if self.has_events:   # cs2dsec_image+events: the coin picks one
            pick = P["use_events"]
            return ((P["day_image"], torch.where(
                        pick, P["day_events"], P["day_isr"]), None),
                    (P["mixed_img"], torch.where(
                        pick, P["mixed_events"], P["mixed_isr"]), None),
                    "default")
        if self.d2n:   # the source pass takes the target's day ISR
            return ((P["day_image"], P["day_pair_isr"], None),
                    (P["mixed_img"], P["mixed_isr"], None), "default")
        return ((P["day_image"], P["day_isr"], None),
                (P["mixed_img"], P["mixed_isr"], None),
                "no_fusion" if self.nofusion else "default")

    def _stream_losses(self, logits: dict, P: dict, mixed: bool, weights):
        """(loss, logs) of one pass's stream logits: the two-stream loss of
        the DarkZurich ablations, ``multi_stream_loss`` otherwise."""
        u = self.cfg.uda
        if not self.two_stream:
            if mixed:
                return multi_stream_loss(
                    logits, P["mixed_lbl"], P["mixed_weight"],
                    stacked=u.stacked_stream_ce, **weights)
            return multi_stream_loss(logits, P["day_label"], None,
                                     stacked=u.stacked_stream_ce, **weights)
        if mixed:
            label = P["mixed_lbl"]
            events = P["mixed_lbl2"] if P["mixed_lbl2"] is not None else label
            pixel = {"image": P["mixed_weight"],
                     "events": (P["mixed_weight2"] if self.split
                                else P["mixed_weight"])}
        else:
            label, pixel = P["day_label"], {}
            events = P["target_day_pl"] if self.d2n else label
        if u.isr_edge:
            events = seg_label_to_edge_label(events)
        return split_stream_loss(
            logits, {"image": label, "events": events}, pixel,
            w_image=u.loss_weight_image, w_events=u.loss_weight_events,
            factor=2.0 if self.split else 1.0,
            events_class_weight=self.edge_cw)

    @staticmethod
    def _batch_hw(batch: dict):
        """(B, (H, W)) of the batch's source images."""
        b, h, w = batch["source"]["image"].shape[:3]
        return b, (h, w)

    def _device_batch(self, batch: dict) -> dict:
        """The batch on the device, wire-decoded (labels int32)."""
        return decode_wire(_to_device(batch, self.device))

    @torch.no_grad()
    def debug_tensors(self, state: DACSTrainState, batch: dict,
                      draws: StepDraws | None = None) -> dict:
        """The mix construction of the step about to run on (state, batch)
        with the same draws (default: the step's own), for the
        class_mix_debug grids (reference dacs.py:882-1097). The EMA is
        applied to a copy of the teacher: ``state`` is left unchanged."""
        batch = self._device_batch(batch)
        if draws is None:
            draws = self.new_draws(state, *self._batch_hw(batch))
        ema = copy.deepcopy(state.ema_model)
        P = self._prepare(state, batch, draws, ema, self._teacher_copy(ema))
        keys = ("day_image", "day_label", "day_isr", "day_events",
                "night_image", "night_isr", "night_events", "pseudo_label",
                "pseudo_weight", "masks", "mixed_img", "mixed_lbl",
                "mixed_weight", "mixed_events", "mixed_isr", "use_events")
        return {k: P[k] for k in keys if P[k] is not None}

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def train_step(self, state: DACSTrainState, batch: dict,
                   draws: StepDraws | None = None):
        """One UDA iteration on ``batch`` ({'source': {image, img_self_res,
        label[, img_time_res]}, 'target': {image, isr[, events]}}, the
        bracketed keys for the cs2dsec types: normalized NHWC float32
        images, int32 labels; numpy arrays or tensors; or the wire dict of
        such a batch). Updates ``state`` in place; returns (state, logs)
        with the logs as 0-dim tensors on the device."""
        batch = self._device_batch(batch)
        if draws is None:
            draws = self.new_draws(state, *self._batch_hw(batch))
        P = self._prepare(state, batch, draws, state.ema_model, state.teacher)
        src_in, mix_in, mode = self._student_inputs(P)
        u = self.cfg.uda
        weights = self._loss_weights()
        if u.isr_no_fusion and self.has_events and not self.together:
            # no fusion loss on ISR coins: the same graph, a gated weight
            weights["w_fusion"] = weights["w_fusion"] * P["use_events"].float()
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)

        logits, feats = model.forward_train(*src_in, mode, draws.fwd)
        loss_src, logs_src = self._stream_losses(logits, P, False, weights)
        if self.enable_fdist:
            fd = imnet_feature_distance(self.cfg, state.imnet,
                                        feats["f_image"][-1], P["day_image"],
                                        P["day_label"])
            logs_src["loss_imnet_feat_dist"] = fd.detach()
            loss_src = loss_src + fd
        self._mark("src_fwd")
        loss_src.backward()
        del logits, feats
        self._mark("src_bwd")
        loss, logs_mix = loss_src.detach(), {}
        if not u.source_only:
            logits, feats = model.forward_train(*mix_in, mode, draws.fwd)
            loss_mix, logs_mix = self._stream_losses(logits, P, True, weights)
            if self.nofusion:
                # the ISR-feature consistency (reference dacs.py:807-819,
                # encoder_decoder.py:833-848): the student's eval-mode
                # features of the mixed ISR are the detached target
                with torch.no_grad():
                    f_isr = model.extract_feat(
                        None, P["mixed_isr"].permute(0, 3, 1, 2).to(
                            model.dtype), None, "no_fusion")["f_events"]
                consistency = feature_consistency_loss(
                    feats["f_image"], f_isr,
                    u.lambda_feature_consistency) * u.lambda_isr_features
                logs_mix["loss_feat_consis"] = consistency.detach()
                loss_mix = loss_mix + consistency
            self._mark("mix_fwd")
            loss_mix.backward()
            del logits, feats
            self._mark("mix_bwd")
            loss = loss + loss_mix.detach()

        zero_missing_grads(model.parameters())
        if self.cfg.optim.grad_clip is not None:
            clip_grad_global_norm_(model.parameters(),
                                   self.cfg.optim.grad_clip)
        set_lr(opt, state.schedules, state.step)
        opt.step()
        state.step += 1
        self._mark("optimizer")
        logs = {**{f"src/{k}": v for k, v in logs_src.items()},
                **{f"mix/{k}": v for k, v in logs_mix.items()},
                "loss": loss,
                "pseudo_weight": P["pseudo_weight"].mean(),
                "use_events": P["use_events"].float()}
        return state, logs


def frozen_imnet(cfg: RunConfig, device, seed: int,
                 imnet_state_dict: dict) -> EncoderDecoder:
    """The frozen ImageNet ``EncoderDecoder`` of the feature distance: its
    backbone from ``imnet_state_dict`` (an NVlabs ``mit_bX.pth``
    state_dict), its head (which the distance does not read) random from
    ``seed + 2``; eval mode, no gradients."""
    with torch.device(device):
        imnet = EncoderDecoder(cfg.model, dtype=cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 2)
    init_weights(imnet, gen)
    load_pretrained_backbone(imnet.backbone, imnet_state_dict)
    return imnet.eval().requires_grad_(False)


@torch.no_grad()
def ema_update(teacher, student, step: int, alpha_max: float):
    """teacher <- alpha * teacher + (1 - alpha) * student (parameters, in
    place), alpha = min(1 - 1/(step+1), alpha_max) in float32."""
    t = torch.tensor(float(step), dtype=torch.float32)
    alpha_t = torch.clamp(1.0 - 1.0 / (t + 1.0), max=alpha_max)
    alpha, beta = float(alpha_t), float(1.0 - alpha_t)
    ema = list(teacher.parameters())
    params = [p.detach() for p in student.parameters()]
    torch._foreach_mul_(ema, alpha)
    torch._foreach_add_(ema, params, alpha=beta)


def imnet_feature_distance(cfg: RunConfig, imnet, f_last: torch.Tensor,
                           day_image, day_label) -> torch.Tensor:
    """The ImageNet feature distance on the thing classes
    (cmda_tpu/uda/dacs.py:243-258, org_dacs.py:136-148): lambda x
    ``masked_feat_dist`` of the student's last feature map ``f_last``
    [B, C, h, w] against the frozen encoder ``imnet``'s on ``day_image``,
    over the cells whose 32x-downscaled source label is one of
    ``uda.imnet_feature_dist_classes``."""
    u = cfg.uda
    if imnet is None:
        raise ValueError(
            "uda.imnet_feature_dist_lambda > 0 needs the frozen ImageNet "
            "encoder's weights: pass init_state(imnet_state_dict=...) "
            "(the train CLI's --imnet, or --pretrained-backbone)")
    with torch.no_grad():
        f_imnet = imnet.extract_feat(day_image)[-1]
    scale = day_label.shape[-1] // f_imnet.shape[-1]
    gt_small = downscale_label_ratio(
        day_label, scale, u.imnet_feature_dist_scale_min_ratio,
        cfg.data.num_classes)
    mask = torch.isin(gt_small, torch.tensor(
        list(u.imnet_feature_dist_classes), dtype=gt_small.dtype,
        device=gt_small.device))
    return u.imnet_feature_dist_lambda * masked_feat_dist(f_last, f_imnet,
                                                          mask)


def _require(target: dict, keys, what: str):
    """Raise KeyError naming the keys of ``keys`` the target batch lacks."""
    missing = [k for k in keys if k not in target]
    if missing:
        raise KeyError(
            f"{what} reads the target batch's {missing}, which it lacks: "
            "DarkZurichDataset gives the day pair with with_day_pair=True "
            "and the deflared pair with outputs image_deflare / "
            "isr_deflare; the train CLI asks for neither, as the JAX CLI "
            "does not")


@torch.no_grad()
def _refresh_teacher(teacher: FusionEncoderDecoder,
                     ema: FusionEncoderDecoder):
    """``teacher``'s parameters <- the bfloat16 rounding of ``ema``'s, in
    the dtype each is kept in (``DACSTrainer._teacher_copy``): bfloat16 ones
    by one multi-tensor copy, float32 ones through a bfloat16 staging
    buffer and a second copy."""
    pairs = list(zip(teacher.parameters(), ema.parameters(), strict=True))
    direct = [(t, e) for t, e in pairs if t.dtype == torch.bfloat16]
    staged = [(t, e) for t, e in pairs if t.dtype != torch.bfloat16]
    if direct:
        torch._foreach_copy_([t for t, _ in direct], [e for _, e in direct])
    if staged:
        flat = torch.empty(sum(e.numel() for _, e in staged),
                           dtype=torch.bfloat16, device=staged[0][1].device)
        views = [v.view_as(e) for v, (_, e) in zip(
            flat.split([e.numel() for _, e in staged]), staged)]
        torch._foreach_copy_(views, [e for _, e in staged])
        torch._foreach_copy_([t for t, _ in staged], views)
