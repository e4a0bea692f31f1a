"""DACSImage, the supervised source-only ISR trainer (mirrors
cmda_tpu.uda.dacs_image.DACSImageTrainer): one MiT ``EncoderDecoder``
trained with plain CE on the source ISR. With ``transfer_direction``
(``isrd2isrn`` or ``isrn2isrd``) the ISR first goes through a frozen
1-channel CycleGAN: its channel mean, G, repeated to 3 channels (no grad).
The step's only random values are the training forward's drop-path
uniforms and Dropout2d masks (``ForwardDraws``), handed in or drawn from a
``torch.Generator`` on the device seeded from (cfg.seed, step). It launches
none of the port's CUDA kernels: its CE is XLA in the JAX step, plain here.
The contrast machinery of the reference's ``ContrastCELoss`` is in
``uda/prototype.py``, outside the step, as in the JAX package.
"""
from __future__ import annotations

import copy

import torch

from ..apis import resolve_device
from ..config import RunConfig
from ..data.wire import decode_wire
from ..models.cyclegan import frozen_generator
from ..models.mit import MIT_VARIANTS
from ..models.segmentor import ForwardDraws
from ..ops.losses import pixel_accuracy, weighted_cross_entropy
from ..train.optim import make_optimizer, make_schedules
from .dacs import DACSTrainState, _to_device
from .org_dacs import build_encoder_decoder, optimizer_step

TRANSFER_DIRECTIONS = (None, "isrd2isrn", "isrn2isrd")


class DACSImageTrainer:
    """The DACSImage step of a RunConfig on ``device`` (cuda unless the
    caller asks for the CPU)."""

    def __init__(self, cfg: RunConfig, device="cuda", *,
                 transfer_direction: str | None = None):
        if transfer_direction not in TRANSFER_DIRECTIONS:
            raise ValueError(f"transfer_direction={transfer_direction!r} is "
                             f"not one of {TRANSFER_DIRECTIONS}")
        if cfg.model.backbone not in MIT_VARIANTS:
            raise ValueError(
                f"DACSImage runs the MiT EncoderDecoder of model.backbone, "
                f"not {cfg.model.backbone!r} (the JAX DACSImageTrainer "
                "builds that model only)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.transfer_direction = transfer_direction

    def init_state(self, seed: int | None = None,
                   cyclegan_state_dict: dict | None = None) -> DACSTrainState:
        """The model (reference random init from ``seed``, default
        ``cfg.seed``), an unused EMA copy as in the JAX state, AdamW; with
        ``transfer_direction`` the frozen 1-channel generator from
        ``cyclegan_state_dict`` or random from seed + 1."""
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        model = build_encoder_decoder(cfg, self.device, seed)
        cyclegan = (frozen_generator(cyclegan_state_dict, device=self.device,
                                     seed=seed + 1)
                    if self.transfer_direction else None)
        return DACSTrainState(
            model=model, ema_model=copy.deepcopy(model).requires_grad_(False),
            optimizer=make_optimizer(model, cfg.optim), cyclegan=cyclegan,
            schedules=make_schedules(cfg.optim))

    def new_draws(self, state: DACSTrainState, batch: int) -> ForwardDraws:
        """The training forward's draws of step ``state.step``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.seed * 1_000_003 + state.step)
        return state.model.new_draws(batch, generator=gen, device=self.device)

    @torch.no_grad()
    def _transfer(self, state: DACSTrainState, isr):
        """The frozen 1-channel CycleGAN on the [-1, 1] ISR (reference
        dacs_image.py:225-230): channel mean, G, repeated to 3 channels."""
        if state.cyclegan is None:
            return isr
        x = isr.float().mean(dim=-1, keepdim=True)
        y = state.cyclegan(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return y.expand(-1, -1, -1, 3)

    def train_step(self, state: DACSTrainState, batch: dict,
                   draws: ForwardDraws | None = None):
        """One iteration on ``batch`` ({'source': {img_self_res, label}},
        NHWC float32 and int32; numpy arrays or tensors, or the wire dict).
        Updates ``state`` in place; returns (state, logs)."""
        batch = decode_wire(_to_device(batch, self.device))
        src = batch["source"]
        isr, label = self._transfer(state, src["img_self_res"]), src["label"]
        if draws is None:
            draws = self.new_draws(state, isr.shape[0])
        state.optimizer.zero_grad(set_to_none=True)
        logits, _ = state.model.forward_with_features(isr, True, draws)
        loss = weighted_cross_entropy(logits, label)
        loss.backward()
        optimizer_step(self.cfg, state)
        logs = {"loss": loss, "src/loss_seg": loss,
                "src/acc_seg": pixel_accuracy(logits.detach(), label)}
        return state, {k: v.detach() for k, v in logs.items()}
