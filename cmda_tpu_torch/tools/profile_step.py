"""Per-component timing of the port's DACS step (mirrors tools/profile_step.py
of the JAX package).

Builds the b5 cs2dsec step in bfloat16 with ``model.remat=True`` at
``--batch`` (random weights, seed 0) and times each of its pieces on its
own, each call ended by a synchronise: the frozen CycleGAN's day events,
the EMA teacher's forward with its pseudo-labels (the argmax kernel), the
mixed-ISR recompute (the ISR kernel), the student's source forward plus
backward (the CE kernels), the mixed forward plus backward, and the whole
step. The pieces run apart, so their sum exceeds the step; their ratios
name the largest. The source and mixed passes read the step's own inputs
(``DACSTrainer._prepare`` on a copy of the teacher).

    python -m cmda_tpu_torch.tools.profile_step [--batch 8] [--steps 5] \\
        [--trace DIR] [--config cs2dsec] [--device cuda]

``--trace DIR`` also records one more step under ``torch.profiler`` into
``DIR/trace.json`` (``utils/profiling.trace``), which
``python -m cmda_tpu_torch.tools.analyze_trace DIR`` summarises. Prints
one JSON object, times in seconds.
"""
from __future__ import annotations

import argparse
import copy
import json

import numpy as np
import torch

from .. import config as C
from ..apis import resolve_device
from ..ops.fused_ce import fused_resize_ce, fused_resize_ce_dx
from ..ops.fused_resize import fused_resize_argmax
from ..ops.isr_kernel import batched_isr
from ..uda.dacs import DACSTrainer
from ..uda.transforms import pseudo_label_and_weight_coarse
from ..utils.profiling import (device_info, device_memory_stats, timed,
                               trace)

KERNELS = {"fused_resize_ce": fused_resize_ce,
           "fused_resize_ce_dx": fused_resize_ce_dx,
           "fused_resize_argmax": fused_resize_argmax,
           "batched_isr": batched_isr}


def make_batch(b: int, h: int, w: int, seed: int = 0) -> dict:
    """A cs2dsec batch of seeded N(0, 1) images, events and ISRs and
    uniform labels in [0, 19), NHWC float32 numpy (the JAX bench's)."""
    g = np.random.default_rng(seed)

    def img():
        return g.normal(size=(b, h, w, 3)).astype(np.float32)

    label = g.integers(0, 19, size=(b, h, w)).astype(np.int32)
    return {
        "source": {"image": img(), "img_self_res": img(),
                   "img_time_res": img(), "label": label},
        "target": {"image": img(), "isr": img(), "events": img()},
    }


def profile_config(name: str, batch: int) -> C.RunConfig:
    cfg = C.PRESETS[name]()
    return C.replace(cfg, dtype="bfloat16",
                     model=C.replace(cfg.model, remat=True),
                     data=C.replace(cfg.data, batch_size=batch))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default=None,
                    help="also record one step under torch.profiler "
                         "into DIR/trace.json")
    ap.add_argument("--config", default="cs2dsec",
                    choices=["cs2dsec", "tiny", "micro"],
                    help="a cs2dsec-type preset")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = profile_config(args.config, args.batch)
    trainer = DACSTrainer(cfg, dev)
    state = trainer.init_state(0)
    w, h = cfg.data.crop_size
    batch = trainer._device_batch(make_batch(args.batch, h, w))
    src, tgt = batch["source"], batch["target"]
    u = cfg.uda
    draws = trainer.new_draws(state, args.batch, (h, w))
    P = trainer._prepare(state, batch, draws,
                         copy.deepcopy(state.ema_model))
    src_in, mix_in, mode = trainer._student_inputs(P)
    weights = trainer._loss_weights()
    model = state.model
    steps = args.steps
    report = {"batch": args.batch, "config": cfg.name, "dtype": cfg.dtype}

    def seconds(fn):
        return timed(fn, steps=steps).summary()["mean_s"]

    @torch.no_grad()
    def day_events():
        return trainer._day_events(state, src)

    @torch.no_grad()
    def teacher():
        out = state.ema_model.forward_logits(
            tgt["image"], tgt["events"], None, "default",
            resize_to_input=False, streams=("fusion",), train=False,
            bn_train=True, bn_update=False)
        return pseudo_label_and_weight_coarse(
            out["fusion_output"], tgt["image"].shape[1:3],
            threshold=u.pseudo_threshold,
            ignore_top=u.pseudo_weight_ignore_top,
            ignore_bottom=u.pseudo_weight_ignore_bottom)

    @torch.no_grad()
    def mixed_isr():
        return trainer._mixed_isr(P["mixed_img"], draws.isr_dirs)

    def fwd_bwd(inputs, mixed):
        def run():
            model.zero_grad(set_to_none=True)
            logits, _ = model.forward_train(*inputs, mode, draws.fwd)
            loss, _ = trainer._stream_losses(logits, P, mixed, weights)
            loss.backward()
            return loss.detach()
        return run

    report["cyclegan_day_events_s"] = seconds(day_events)
    report["teacher_forward_s"] = seconds(teacher)
    report["mixed_isr_s"] = seconds(mixed_isr)
    report["student_fwd_bwd_s"] = seconds(fwd_bwd(src_in, False))
    report["mixed_fwd_bwd_s"] = seconds(fwd_bwd(mix_in, True))
    model.zero_grad(set_to_none=True)

    def step():
        return trainer.train_step(state, batch)[1]["loss"]

    before = {k: fn.launches for k, fn in KERNELS.items()}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    report["step_s"] = seconds(step)
    report["step_launches"] = {k: (fn.launches - before[k]) / (steps + 2)
                               for k, fn in KERNELS.items()}
    report["samples_per_s"] = args.batch / report["step_s"]
    report["sum_components_s"] = (
        report["cyclegan_day_events_s"] + report["teacher_forward_s"]
        + report["mixed_isr_s"] + report["student_fwd_bwd_s"]
        + report["mixed_fwd_bwd_s"])
    mem = device_memory_stats(dev)
    report["peak_gib"] = (mem["peak_bytes_in_use"] / 2 ** 30 if mem
                          else None)
    if args.trace:
        with trace(args.trace):
            step()
        report["trace_dir"] = args.trace
    report["device"] = device_info(dev)
    print(json.dumps(report, indent=2), flush=True)
    return report


if __name__ == "__main__":
    main()
