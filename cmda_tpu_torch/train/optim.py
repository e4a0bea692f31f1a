"""Optimizer + LR schedule (mirrors cmda_tpu.train.optim).

* ``poly_warmup_schedule``: mmcv's poly decay (power 1, min_lr 0) with a
  linear warmup that multiplies the regular lr by a factor ramping from
  ``warmup_ratio`` to 1 over ``warmup_iters``.
* ``make_optimizer``: ``torch.optim.AdamW`` with the JAX package's param
  groups, decided by module: the parameters of the model's ``decode_head``
  at lr x ``head_lr_mult`` (unless ``head=False``: OrgDACS's legacy
  GenericEncoderDecoder, whose JAX head is named ``head`` and so takes the
  backbone's lr), no weight decay on norm parameters: those of norm
  modules (LayerNorm / BatchNorm / GroupNorm weight and bias) and those
  the JAX rule picks by name on the flax path. Four torch groups
  carry the (head, backbone) x (decay, no decay) split. As in optax's
  ``adamw``, the bias-correction count starts at 1 and eps is outside the
  square root; ``set_lr(optimizer, schedules, step)`` gives update
  ``step`` (0-based) the schedule's value at ``step``, so the first update
  uses sched(0).

optax updates every parameter whose gradient is 0, weight decay included;
``torch.optim.AdamW`` skips a parameter whose ``.grad`` is None, so the
caller gives such parameters zero gradients (``zero_missing_grads``).

* ``moment_dtype='bfloat16'``: ``LowPrecisionAdamW``, the JAX package's
  ``scale_by_adam_lp`` chain (moments stored in bfloat16, the update in
  float32 from the unrounded moments), since ``torch.optim.AdamW`` keeps its
  state in the parameter's dtype.
* ``grad_clip``: ``clip_grad_global_norm_``, optax's
  ``clip_by_global_norm`` over every gradient before both groups' update.
"""
from __future__ import annotations

import numpy as np
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


# the JAX name rule picks the parameters of these modules, whatever the
# port names them (mmcv's ``bn1``, ``stem.1``, ``downsample.1``)
_NORMS = (torch.nn.modules.batchnorm._NormBase, torch.nn.LayerNorm,
          torch.nn.GroupNorm)


def make_schedules(cfg) -> dict:
    """{'backbone', 'head'} -> schedule, for an OptimConfig."""
    return {
        "backbone": poly_warmup_schedule(
            cfg.lr, cfg.max_iters, cfg.warmup_iters, cfg.warmup_ratio,
            cfg.power, cfg.min_lr),
        "head": poly_warmup_schedule(
            cfg.lr * cfg.head_lr_mult, cfg.max_iters, cfg.warmup_iters,
            cfg.warmup_ratio, cfg.power, cfg.min_lr)}


class LowPrecisionAdamW(torch.optim.Optimizer):
    """AdamW with both moments stored in ``moment_dtype``: the JAX
    package's ``optax.chain(scale_by_adam_lp, add_decayed_weights,
    scale_by_learning_rate)`` per group. Per step, in float32:
    ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g g``, the update
    ``-lr ((mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p)``
    from these unrounded moments (``t`` the group's count, the bias
    correction in float32); only what is stored for the next step is
    rounded to ``moment_dtype``. The state keys are ``torch.optim.AdamW``'s
    (``step``, a float32 CPU tensor; ``exp_avg``; ``exp_avg_sq``).
    Multi-tensor ``torch._foreach_*`` ops over chunks of at most
    ``CHUNK_NUMEL`` elements, which bounds the float32 temporaries."""

    CHUNK_NUMEL = 1 << 25

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 moment_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        self.moment_dtype = moment_dtype

    def _chunks(self, params):
        chunk, numel = [], 0
        for p in params:
            if chunk and numel + p.numel() > self.CHUNK_NUMEL:
                yield chunk
                chunk, numel = [], 0
            chunk.append(p)
            numel += p.numel()
        if chunk:
            yield chunk

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("LowPrecisionAdamW takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0, dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(
                        p, dtype=self.moment_dtype,
                        memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(
                        st["exp_avg"], memory_format=torch.preserve_format)
            steps = [self.state[p]["step"] for p in params]
            torch._foreach_add_(steps, 1.0)
            t = np.float32(float(steps[0]))
            b1, b2 = group["betas"]
            b1c = float(np.float32(1.0) - np.float32(b1) ** t)
            b2c = float(np.float32(1.0) - np.float32(b2) ** t)
            for chunk in self._chunks(params):
                self._update(chunk, group, b1c, b2c)

    def _update(self, params, group, b1c, b2c):
        b1, b2 = group["betas"]
        grads = [p.grad for p in params]
        mus = [self.state[p]["exp_avg"] for p in params]
        nus = [self.state[p]["exp_avg_sq"] for p in params]
        mu32 = [torch.empty_like(p) for p in params]
        nu32 = [torch.empty_like(p) for p in params]
        torch._foreach_copy_(mu32, mus)
        torch._foreach_copy_(nu32, nus)
        # mu = b1 * mu + (1 - b1) * g; nu = b2 * nu + ((1 - b2) * g) * g
        torch._foreach_mul_(mu32, b1)
        torch._foreach_add_(mu32, torch._foreach_mul(grads, 1.0 - b1))
        sq = torch._foreach_mul(grads, 1.0 - b2)
        torch._foreach_mul_(sq, grads)
        torch._foreach_mul_(nu32, b2)
        torch._foreach_add_(nu32, sq)
        # (mu / b1c) / (sqrt(nu / b2c) + eps)
        den = torch._foreach_div(nu32, b2c)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        upd = torch._foreach_div(mu32, b1c)
        torch._foreach_div_(upd, den)
        if group["weight_decay"]:
            torch._foreach_add_(upd, torch._foreach_mul(
                params, group["weight_decay"]))
        torch._foreach_mul_(upd, -group["lr"])
        torch._foreach_add_(params, upd)
        torch._foreach_copy_(mus, mu32)
        torch._foreach_copy_(nus, nu32)

    def load_state_dict(self, state_dict):
        """``Optimizer.load_state_dict`` casts the moments to the parameter's
        dtype; they go back to ``moment_dtype`` here, bitwise (the float32
        values it made hold the stored ones exactly)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st:
                    st[k] = st[k].to(self.moment_dtype)


def make_optimizer(model: torch.nn.Module, cfg, *,
                   head: bool = True) -> torch.optim.Optimizer:
    """AdamW over ``model``'s parameters; ``cfg`` is an OptimConfig:
    ``torch.optim.AdamW`` with float32 moments, ``LowPrecisionAdamW`` with
    ``moment_dtype='bfloat16'``. Each group names its schedule under
    ``'part'`` ('backbone' or 'head'; with ``head=False`` the decode head
    is in 'backbone'). ``cfg.grad_clip`` is applied by the caller
    (``clip_grad_global_norm_``)."""
    if cfg.moment_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"moment_dtype={cfg.moment_dtype!r}")
    norm = {id(p) for m in model.modules() if isinstance(m, _NORMS)
            for p in m.parameters(recurse=False)}
    heads = ({id(p) for p in model.decode_head.parameters()} if head
             else set())
    groups = {}
    for name, p in model.named_parameters():
        key = ("head" if id(p) in heads else "backbone",
               id(p) not in norm and not is_norm_param(name))
        groups.setdefault(key, []).append(p)
    param_groups = [{"params": params, "part": part,
                     "weight_decay": cfg.weight_decay if decay else 0.0}
                    for (part, decay), params in sorted(groups.items())]
    if cfg.moment_dtype == "bfloat16":
        return LowPrecisionAdamW(param_groups, lr=cfg.lr, betas=cfg.betas,
                                 eps=1e-8, moment_dtype=torch.bfloat16)
    return torch.optim.AdamW(param_groups, lr=cfg.lr,
                             betas=tuple(cfg.betas), eps=1e-8)


@torch.no_grad()
def clip_grad_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm(max_norm)`` on the gradients of
    ``params``, in place: the global norm ``sqrt(sum_i ||g_i||^2)`` over
    every gradient, and where it is at least ``max_norm`` each gradient
    becomes ``(g / norm) * max_norm``; below it the gradients are left as
    they are, bitwise (divided and multiplied by 1). The choice stays on the
    device (no host synchronisation). Returns the norm, a 0-dim tensor.
    (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` and
    scales below the threshold too.)"""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads)).float())
    clip = norm >= max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(grads, torch.where(clip, norm, one))
    torch._foreach_mul_(grads, torch.where(clip, max_norm, one))
    return norm


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
