#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cmda_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, any failure exits non-zero:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ with nvcc (sm_90a), print build times
     and ptxas register/spill reports;
  3. hold each kernel against its plain PyTorch version on the card, at the
     serving shapes, and time both with CUDA events beside the bound;
  4. the main path at full width: the cs2dsec MiT-b5 FusionEncoderDecoder
     (random weights from a seed) through ``inference_segmentor`` on a
     440x640 PNG, image-only (on-the-fly ISR kernel + fused upsample+argmax
     kernel), and ``evaluate_fusion`` on 8 synthetic 440x640 samples at
     batch 8; launch counters must grow, outputs must be finite and agree
     with the plain argmax; then whole-frame inference times at batch 1 and
     8 in float32 and bfloat16;
  5. one JSON line of per-kernel results, the nvidia-smi line, and last
     ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM data-sheet peaks (dense): device memory and fp32 outside the
# tensor cores; the bounds below are computed from these and the shapes
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
# operations per (output pixel, class) of the fused upsample+argmax: a
# 3-flop two-tap blend at 2 column taps and 1 for the columns (9), max
# compare, subtract, exp, add (4)
ARGMAX_OPS_PER_PIXEL_CLASS = 13
# operations per pixel of the ISR: two directions x (2 x (mul, add, log),
# sub, abs-compare, 2 clamps, 2 x (sub, div, add)) + the average (3)
ISR_OPS_PER_PIXEL = 2 * (2 * 3 + 1 + 1 + 2 + 2 * 3) + 3
ARGMAX_TOL = 1e-5       # prob, absolute; labels may differ only at ties
ISR_TOL = 1e-5          # absolute, values in [-1, 1]


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=3, reps=20):
    """Median device time of ``fn()`` in ms, CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, warmup=2, reps=5):
    """Median host time of ``fn()`` in ms, each call ending in a sync."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes, nops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, nops / PEAK_FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_labels(label, ref_label, z, what):
    """Labels equal except where the top-2 margin of z is below the tol."""
    import torch
    bad = label != ref_label
    n_bad = int(bad.sum())
    if n_bad:
        top2 = torch.topk(z, 2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1])[bad]
        if float(gap.max()) >= ARGMAX_TOL:
            fail(f"{what}: {n_bad} labels differ, margins up to "
                 f"{float(gap.max())}")
    return n_bad


def phase_argmax(gen):
    import torch
    from cmda_tpu_torch.ops.fused_resize import (fused_resize_argmax,
                                                 resize_argmax)
    from cmda_tpu_torch.ops.resize import resize_bilinear
    dev = torch.device("cuda")
    cases = {"serving": ((8, 110, 160, 19), (440, 640), torch.float32),
             "nonsquare": ((2, 28, 40, 19), (84, 160), torch.float32),
             "serving_bf16": ((8, 110, 160, 19), (440, 640), torch.bfloat16)}
    worst = 0.0
    for name, (shape, size, dtype) in cases.items():
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        label, prob = fused_resize_argmax(x, size)
        ref_label, ref_prob = resize_argmax(x, size)
        torch.cuda.synchronize()
        z = resize_bilinear(x.float(), size)
        n_bad = check_labels(label, ref_label, z, f"argmax {name}")
        err = float((prob - ref_prob).abs().max())
        print(f"argmax {name} {shape}->{size} {dtype}: max|dprob| {err:.3g}, "
              f"label mismatches {n_bad} (all at near ties)", flush=True)
        if not err <= ARGMAX_TOL:
            fail(f"argmax {name}: prob error {err}")
        worst = max(worst, err)
    tie = torch.full((2, 6, 10, 19), 0.5, device=dev)
    label, prob = fused_resize_argmax(tie, (24, 40))
    if int(label.abs().sum()) != 0 or float((prob - 1 / 19).abs().max()) > 1e-6:
        fail("argmax tie case: ties must go to class 0 with prob 1/C")
    print("argmax tie case: all labels 0, prob 1/19", flush=True)

    b, h, w, c = cases["serving"][0]
    hh, ww = cases["serving"][1]
    x = torch.randn((b, h, w, c), generator=gen, device=dev)
    ms = cuda_ms(lambda: fused_resize_argmax(x, (hh, ww)))
    plain_ms = cuda_ms(lambda: resize_argmax(x, (hh, ww)))
    bound_ms, bound_by = bound(b * h * w * c * 4 + b * hh * ww * (4 + 4),
                               b * hh * ww * c * ARGMAX_OPS_PER_PIXEL_CLASS)
    print(f"argmax timing [8,110,160,19]->[8,440,640] f32: kernel {ms:.4f} ms,"
          f" plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    return {"name": "fused_resize_argmax", "route": "cuda",
            "source": "cmda_tpu_torch/csrc/fused_resize_argmax.cu",
            "replaces": "cmda_tpu/ops/pallas_ce.py:428",
            "max_abs_err": worst, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def _smooth_gray(gen, b, h, w, dev):
    """Integer gray frames (0..255) with smooth regions and edges."""
    import torch
    base = torch.randint(0, 256, (b, 1, 1), generator=gen, device=dev)
    steps = torch.randint(-3, 4, (b, h, w), generator=gen, device=dev)
    return (base + steps.cumsum(dim=2)).clamp(0, 255).float()


def phase_isr(gen):
    import torch
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.ops.isr_kernel import batched_isr, batched_isr_plain
    dev = torch.device("cuda")
    b, h, w = 8, 440, 640
    gray = _smooth_gray(gen, b, h, w, dev)
    dirs = torch.tensor([0, 1, 2, 3] * 2, dtype=torch.int32, device=dev)
    worst = 0.0
    presets = {"cs2dsec": C.cs2dsec_image_events_b5().data.target_isr,
               "cs2dz": C.cs2dz_image_rawisr_b5().data.target_isr}
    for name, p in presets.items():
        kw = dict(val_range=tuple(p.val_range), threshold=p.threshold,
                  clip_range=p.clip_range, shift_pixel=p.shift_pixel)
        out = batched_isr(gray, dirs, **kw)
        ref = batched_isr_plain(gray, dirs, **kw)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        err = float(diff.max())
        flagged = (diff > ISR_TOL).nonzero().tolist()
        print(f"isr {name} [8,440,640] dirs 0-3 x2 shift {p.shift_pixel}: "
              f"max|d| {err:.3g}, pixels over {ISR_TOL}: {len(flagged)}",
              flush=True)
        for bi, y, x in flagged[:10]:   # a dead-zone flip shows here
            print(f"  isr {name} pixel (b={bi}, y={y}, x={x}): kernel "
                  f"{float(out[bi, y, x]):.6f} plain {float(ref[bi, y, x]):.6f}"
                  f" gray {float(gray[bi, y, x])}", flush=True)
        if flagged:
            fail(f"isr {name}: {len(flagged)} pixels differ by more than "
                 f"{ISR_TOL}")
        worst = max(worst, err)
    p = presets["cs2dsec"]
    kw = dict(val_range=tuple(p.val_range), threshold=p.threshold,
              clip_range=p.clip_range, shift_pixel=p.shift_pixel)
    ms = cuda_ms(lambda: batched_isr(gray, dirs, **kw))
    plain_ms = cuda_ms(lambda: batched_isr_plain(gray, dirs, **kw), reps=20)
    bound_ms, bound_by = bound(2 * b * h * w * 4 + b * 4,
                               b * h * w * ISR_OPS_PER_PIXEL)
    print(f"isr timing [8,440,640]: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
          f" ms, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return {"name": "batched_isr", "route": "cuda",
            "source": "cmda_tpu_torch/csrc/batched_isr.cu",
            "replaces": "cmda_tpu/ops/pallas_kernels.py:55",
            "max_abs_err": worst, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def phase_main_path(results):
    import torch
    from PIL import Image
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.apis import (init_segmentor, inference_segmentor,
                                     predict_labels, select_logits)
    from cmda_tpu_torch.data.synthetic import SyntheticTarget, collate
    from cmda_tpu_torch.ops.fused_resize import (fused_resize_argmax,
                                                 resize_argmax)
    from cmda_tpu_torch.ops.isr_kernel import batched_isr
    from cmda_tpu_torch.ops.resize import resize_bilinear
    from cmda_tpu_torch.train.loop import evaluate_fusion

    t0 = time.perf_counter()
    cfg = C.cs2dsec_image_events_b5()
    seg = init_segmentor(cfg, device="cuda")
    n_params = sum(p.numel() for p in seg.model.parameters())
    torch.cuda.synchronize()
    print(f"main: cs2dsec MiT-b5 FusionEncoderDecoder, {n_params} params, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:440, 0:640]
    rgb = np.stack([(yy * 255 // 439), (xx * 255 // 639),
                    rng.integers(0, 256, (440, 640))], -1).astype(np.uint8)
    dataset = SyntheticTarget(crop_size=(640, 440), length=8, test_mode=True)

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "frame.png")
        Image.fromarray(rgb).save(png)
        # --- the main path, counted -------------------------------------
        fused_resize_argmax.launches = 0
        batched_isr.launches = 0
        t0 = time.perf_counter()
        pred = inference_segmentor(seg, png)
        t_first = time.perf_counter() - t0
        summary = evaluate_fusion(seg, dataset, batch_size=8)
        torch.cuda.synchronize()
        launches = {"fused_resize_argmax": fused_resize_argmax.launches,
                    "batched_isr": batched_isr.launches}
        # -----------------------------------------------------------------
        print(f"main: launches {launches}; inference_segmentor first call "
              f"{t_first:.2f} s; evaluate_fusion mIoU {summary['mIoU']:.5f}",
              flush=True)
        if min(launches.values()) == 0:
            fail(f"a kernel of the main path never launched: {launches}")
        if pred.shape != (440, 640) or pred.dtype != np.int32 or not (
                0 <= pred.min() and pred.max() < 19):
            fail(f"inference_segmentor pred {pred.shape} {pred.dtype}")
        if not all(math.isfinite(summary[k]) for k in ("mIoU", "aAcc")):
            fail(f"evaluate_fusion summary not finite: {summary}")
        infer_ms = wall_ms(lambda: inference_segmentor(seg, png))
    for r in results:
        r["launches"] = launches[r["name"]]

    batch = collate([dataset[i] for i in range(8)])
    image = torch.from_numpy(batch["image"]).cuda()
    events = torch.from_numpy(batch["events"]).cuda()
    with torch.no_grad():
        logits = select_logits(seg.model, image, events, "fusion")
        if not bool(torch.isfinite(logits).all()):
            fail("fusion logits not finite")
        kern = predict_labels(logits, (440, 640))
        plain = resize_argmax(logits, (440, 640), with_prob=False)[0]
        n_bad = check_labels(kern, plain,
                             resize_bilinear(logits, (440, 640)),
                             "main-path argmax")
    print(f"main: batch-8 fusion logits {tuple(logits.shape)} finite; kernel "
          f"vs plain argmax mismatches {n_bad} (near ties only)", flush=True)

    timings = {"inference_segmentor_image_only_ms": infer_ms}
    # where the batch-8 float32 time goes: each stage of select_logits +
    # predict_labels alone, device time by CUDA events
    m = seg.model
    x, e = image.permute(0, 3, 1, 2), events.permute(0, 3, 1, 2)
    with torch.no_grad():
        fi, fe = m.backbone_image(x), m.backbone_events(e)
        ff = m.fusion_module(fi, fe)
        stages = {
            "backbone_image": lambda: m.backbone_image(x),
            "backbone_events": lambda: m.backbone_events(e),
            "fusion_module": lambda: m.fusion_module(fi, fe),
            "decode_head": lambda: m.decode_head({"f_fusion": ff}),
            "fused_resize_argmax": lambda: predict_labels(logits, (440, 640)),
        }
        for name, fn in stages.items():
            timings[f"stage_b8_{name}_ms"] = cuda_ms(fn, warmup=2, reps=5)
    print("main: batch-8 float32 stage device ms " + ", ".join(
        f"{k[9:-3]} {v:.2f}" for k, v in timings.items()
        if k.startswith("stage_")), flush=True)
    preds = {}
    for dtype in ("float32", "bfloat16"):
        seg.model.dtype = getattr(torch, dtype)
        for b in (1, 8):
            img, ev = image[:b].contiguous(), events[:b].contiguous()

            def run():
                with torch.no_grad():
                    return predict_labels(select_logits(
                        seg.model, img, ev, "fusion"), (440, 640))
            ms = wall_ms(run)
            timings[f"{dtype}_b{b}_ms"] = ms
            timings[f"{dtype}_b{b}_samples_per_s"] = b / (ms / 1e3)
            print(f"main: whole-frame 440x640 fusion inference {dtype} batch "
                  f"{b}: {ms:.2f} ms/batch, {b / (ms / 1e3):.2f} samples/s",
                  flush=True)
        preds[dtype] = run()
    seg.model.dtype = torch.float32
    agree = float((preds["float32"] == preds["bfloat16"]).float().mean())
    print(f"main: bf16 vs fp32 batch-8 pred agreement {agree:.5f}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    print("timings " + json.dumps(timings), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from cmda_tpu_torch.ops import _build
    smi = smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)

    t0 = time.perf_counter()
    log = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(_build.SOURCES)}", flush=True)
    for name, entry in log.items():
        print(f"build {name}: {entry['seconds']:.1f} s", flush=True)
        for line in entry["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = [phase_argmax(gen), phase_isr(gen)]
    phase_main_path(results)

    print(json.dumps({"kernels": results}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
