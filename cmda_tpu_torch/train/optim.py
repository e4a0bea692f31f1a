"""Optimizer + LR schedule (mirrors cmda_tpu.train.optim).

* ``poly_warmup_schedule``: mmcv's poly decay (power 1, min_lr 0) with a
  linear warmup that multiplies the regular lr by a factor ramping from
  ``warmup_ratio`` to 1 over ``warmup_iters``.
* ``make_optimizer``: ``torch.optim.AdamW`` with the JAX package's param
  groups: decode-head parameters at lr x ``head_lr_mult``, no weight decay
  on norm parameters (LayerNorm / BN weight and bias). Four torch groups
  carry the (head, backbone) x (decay, no decay) split. As in optax's
  ``adamw``, the bias-correction count starts at 1 and eps is outside the
  square root; ``set_lr(optimizer, schedules, step)`` gives update
  ``step`` (0-based) the schedule's value at ``step``, so the first update
  uses sched(0).

optax updates every parameter whose gradient is 0, weight decay included;
``torch.optim.AdamW`` skips a parameter whose ``.grad`` is None, so the
caller gives such parameters zero gradients (``zero_missing_grads``).
bfloat16 moments (``moment_dtype``) are not ported.
"""
from __future__ import annotations

import torch


def poly_warmup_schedule(base_lr: float, max_iters: int,
                         warmup_iters: int = 1500, warmup_ratio: float = 1e-6,
                         power: float = 1.0, min_lr: float = 0.0):
    """step -> lr, in float32 like the JAX schedule."""

    def schedule(step):
        step = torch.tensor(float(step), dtype=torch.float32)
        coeff = (1.0 - step / max_iters) ** power
        regular = (base_lr - min_lr) * coeff + min_lr
        k = (1.0 - step / warmup_iters) * (1.0 - warmup_ratio)
        warmup_lr = regular * (1.0 - k)
        return float(torch.where(step < warmup_iters, warmup_lr, regular))

    return schedule


def is_norm_param(name: str) -> bool:
    """A LayerNorm / BN parameter: a name segment contains 'norm' or is
    'bn' (the JAX rule on the flax path)."""
    return any("norm" in seg.lower() or seg == "bn"
               for seg in name.split(".")[:-1])


def is_head_param(name: str) -> bool:
    return name.split(".")[0] == "decode_head"


def make_schedules(cfg) -> dict:
    """{'backbone', 'head'} -> schedule, for an OptimConfig."""
    return {
        "backbone": poly_warmup_schedule(
            cfg.lr, cfg.max_iters, cfg.warmup_iters, cfg.warmup_ratio,
            cfg.power, cfg.min_lr),
        "head": poly_warmup_schedule(
            cfg.lr * cfg.head_lr_mult, cfg.max_iters, cfg.warmup_iters,
            cfg.warmup_ratio, cfg.power, cfg.min_lr)}


def make_optimizer(model: torch.nn.Module, cfg) -> torch.optim.AdamW:
    """AdamW over ``model``'s parameters; ``cfg`` is an OptimConfig. Each
    group names its schedule under ``'part'`` ('backbone' or 'head')."""
    if cfg.moment_dtype not in (None, "float32"):
        raise NotImplementedError(
            f"moment_dtype={cfg.moment_dtype!r} is not ported yet")
    if cfg.grad_clip is not None:
        raise NotImplementedError("grad_clip is not ported yet")
    groups = {}
    for name, p in model.named_parameters():
        key = ("head" if is_head_param(name) else "backbone",
               not is_norm_param(name))
        groups.setdefault(key, []).append(p)
    return torch.optim.AdamW(
        [{"params": params, "part": part,
          "weight_decay": cfg.weight_decay if decay else 0.0}
         for (part, decay), params in sorted(groups.items())],
        lr=cfg.lr, betas=tuple(cfg.betas), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, schedules: dict, step: int):
    """Give every group its schedule's lr for update ``step`` (0-based)."""
    for group in optimizer.param_groups:
        group["lr"] = schedules[group["part"]](step)


def zero_missing_grads(params):
    """Zero gradients for parameters that got none (optax would still
    decay them)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
