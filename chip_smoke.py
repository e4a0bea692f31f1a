#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cmda_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one GPU
    python3 chip_smoke.py --device-time ROOT
        # only the device and per-call times of every port kernel of the
        # checkout at ROOT, at the points the main paths launch them
    python3 chip_smoke.py --phases isr,ce,train_types,image_trainers,model_zoo,tools
        # some phases alone (isr, ce: the kernel times and phase_isr,
        # phase_ce; train_types, image_trainers, model_zoo, tools:
        # phase_train_types, phase_image_trainers, phase_model_zoo,
        # phase_tools); prints each phase's launches as a JSON line, and no
        # result line

Phases, any failure exits non-zero:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ with nvcc (sm_90a), print build times
     and ptxas register/spill reports;
  3. time every port kernel at the shapes and flags the main paths launch
     it (``port_kernel_times``): per call with CUDA events (the wrapper's
     host work and the gaps between a call's launches included) and the
     kernels' own device time, the sum of their durations in a
     ``torch.profiler`` trace, median of 20 calls (``device_ms``); then hold
     the argmax and ISR kernels against their plain PyTorch versions on the
     card, at those shapes and at the tiles' edge geometries (h or w of 1,
     sizes off the tile, factors 1, 2x3 and 3x4, B = 1, C = 7 and 150, bf16,
     with and without the prob; ISR shifts 1-3, both presets, H = 1,
     W = shift + 1, a frame larger than the resident threads hold), each
     run twice giving the same bits, and time the plain versions beside
     the bound;
  4. the main path at full width: the cs2dsec MiT-b5 FusionEncoderDecoder
     (random weights from a seed) through ``inference_segmentor`` on a
     440x640 PNG, image-only (on-the-fly ISR kernel + fused upsample+argmax
     kernel), and ``evaluate_fusion`` on 8 synthetic 440x640 samples at
     batch 8; launch counters must grow, outputs must be finite and agree
     with the plain argmax; then whole-frame inference times at batch 1 and
     8 in float32 and bfloat16;
  5. the fused upsample+CE kernels (forward, dx, dweight) against the plain
     resize + weighted CE and its autograd gradients: the flagship loss
     shape [2,128,128,19] -> [2,512,512] and the bfloat16 step's
     [8,128,128,19] -> [8,512,512] in float32 and bfloat16, non-square
     factors, all labels ignored, no weight, and the tiles' edge geometries
     (h or w of 1, sizes not multiples of the tile, factors 1, 2x3 and 3x4,
     B = 1, C = 7 and 150); each run twice must give the same bits; the
     dweight from labels off a 16-byte boundary; timed at both loss shapes
     beside the bound, the forward and dx with warm and cold L2;
  6. training: one DACS step of the micro config on the card through the
     kernels, against the same step on the card through their plain
     versions and on the CPU (losses and AdamW's first moments), then the
     flagship cs2dsec MiT-b5
     DACS step at 512x512 batch 2 (random weights from seed 0, random
     CycleGAN): 2 counted steps (finite logs, parameters move, the EMA
     teacher after step 0 is the pre-update student, each step launches CE
     forward 8, CE dx 8, argmax 3, ISR 1), the median step time, a device
     time and memory breakdown of one step by CUDA events and allocator
     counters, the peak memory of the timed steps, and the device-busy
     time of one step under ``torch.profiler`` with each port kernel's
     launches and device time in it; then the same for the JAX package's
     ``bench.py`` step, bfloat16 at batch 8: the micro step in bfloat16
     through the kernels against through their plain versions on the card,
     and the b5 step at 512x512 batch 8 (launches, the dtype of the logits
     the CE kernels take, step time, samples/s, peak memory, sections,
     busy share), and the same b8 step with ``bench.py``'s
     ``--teacher-bf16 --moments bfloat16`` (the AdamW state's and the
     teacher copy's bytes beside the step's);
  7. the training run: ``cmda_tpu_torch.tools.train.main`` in-process on
     the same preset, synthetic data, bf16 wire feed, device prefetch 1,
     4 loader threads, 6 iterations logged each, a checkpoint, an
     evaluation of 8 val samples and debug grids every 3: the records,
     PNGs and checkpoints it writes, the launches of every step (as in 6),
     debug snapshot (argmax 1, ISR 1) and evaluation (argmax 8), the
     iteration-3 checkpoint loaded in a fresh trainer equal to the state
     it was written from and stepping as it does, the last checkpoint
     served by ``init_segmentor``; the steady iteration time, data_time
     and its host parts, checkpoint bytes and seconds, evaluation seconds
     and the device-busy share of 2 profiled iterations;
  8. the other train types: the micro ``cs2dz`` and ``cs2dsec_image+events``
     (with grad_clip) steps through the kernels against their plain
     versions and the CPU, each run again with deterministic cuDNN (the
     forward bitwise); then the DarkZurich preset (cs2dz, MiT-b5, 512x512,
     batch 2, float32) as in 6 (launches CE 6 / dx 6 / argmax 3 / ISR 1 a
     step) and as in 7 through ``--config cs2dz`` at CUT_BACKBONE's
     depth (b5's widths, 2 blocks a stage); the kernels' cs2dz
     points (the CE with the pseudo weight's cropped rows, the ISR
     rightdown with the DarkZurich parameters) are held and timed in 3 and
     5;
  9. the test path of the cs2dz MiT-b5 model (``phase_test``): a port
     checkpoint (student and EMA teacher) and a DarkZurich tree of four
     1920x1080 val and test frames written on the spot, driven through
     ``cmda_tpu_torch.tools.test.main`` (whole mode on the image and the
     fusion stream, slide, aug-test, ``--use-teacher``, the submission of
     both streams) and ``tools.infer.main`` (two 1080x1920 PNGs, fusion),
     each run's launches counted; slide against a crop-by-crop loop, the
     teacher against the EMA parameters with the student's BN buffers, the
     submission PNGs against the whole-mode prediction; the path's times
     and peak memory; the argmax and ISR kernels at its points are held
     and timed in 3;
 10. the cs2dz recipe on corpus files (``phase_real_corpus``): Cityscapes
     (8 frames at 2048x1024 with IC1 PNGs, labels and the Rare Class
     Sampling JSONs) and DarkZurich (4 train + 4 val frames at 1920x1080)
     written by ``cmda_tpu_torch.tools.make_fake_corpus``, then
     ``tools.train.main --config cs2dz --source-root --target-root
     --rcs-json-dir`` for 4 iterations with a checkpoint and an evaluation
     of the val frames: launches per step (CE 6 / dx 6 / argmax 3 / ISR 1)
     and per evaluation (argmax 1 a frame), finite losses, every RCS source
     load from a file listed for the class drawn; the iteration time beside
     the bare cs2dz step, data_time and its host
     parts, evaluation seconds a frame, the busy share of 3 profiled
     iterations. The DSEC-Night corpus (``events.h5``) needs h5py, which
     the card's machine lacks, so its run is held on the CPU only
     (``tests/test_torch_data.py``);
 11. the ISR ablation path on the same corpus files
     (``phase_isr_options``): ``tools.train.main --config cs2dz`` at
     MiT-b5, 512x512, batch 2, float32, 3 iterations with the source
     options (lens flare, ISR noise, CowMix erase, the 3-channel ISR; sky
     splice and sky-noise PNGs) and the 3-channel, noised mixed ISR
     (launches CE 6 / dx 6 / argmax 3 / ISR 3 a step), and 2 iterations with
     the high-resolution source ISR and the ClassMix-ed, jittered ISRs (ISR
     0 a step); one step of the first run's config on its loader's batch
     held against its plain-version twin on the card; the source options'
     and the DSEC target's host parts (a 500,000-event voxel grid and its
     norm) on one thread; the 3-channel ISR's kernel points (shifts 1, 3,
     5) are held and timed in 3;
 12. C2 (``phase_pseudo_weight``): one cs2dz b5 step with
     ``uda.pseudo_threshold`` 0 through ``apply_overrides``, against its
     plain-version twin, with the share of pixels whose pseudo weight is
     above 0;
 13. the flagship recipe's UDA ablations (``phase_uda_options``): the
     cs2dsec MiT-b5 step at 512x512, batch 2, float32 with
     ``isr_another_fusion`` on an events and on an ISR coin,
     ``fuse_both_ice_and_e``, ``cs2dsec_image+events`` with
     ``isr_no_fusion`` on either coin, ``source_only`` and
     ``without_events``, each at CUT_BACKBONE's depth from one state
     against its plain-version twin with its launches checked (CE 8 / 6 /
     4 by train type and passes, argmax 3 or 2 under source_only, ISR 1);
     the coin's host read timed at b5; the JAX package's step levers
     together
     (``stacked_stream_ce``, ``head_batched_train``, ``shift_type='all'``
     and the fused resize: CE 0, argmax 3, ISR 0) against their twin and
     timed beside phase 6's flagship step; and ``tools.train.main
     --config cs2dsec --synthetic --fused-resize --set
     uda.isr_another_fusion=true`` at CUT_BACKBONE for 1 iteration;
 14. the DACS trainer's DarkZurich ablations (``phase_train_types``): the
     cs2dz step at CUT_BACKBONE's depth, 512x512, batch 2, float32 with
     the JAX grid's
     model settings (no fusion module; split classifiers, 2 events classes
     for no-fusion): ``cs2dz_image+raw-isr_split`` with ``deflare_aug``,
     ``_no-fusion`` with edge labels (the CE kernel at C = 2), ``_no-fusion``
     with the [0.1, 0.9] edge class weight and the ImageNet feature
     distance (a frozen ``EncoderDecoder`` from a seeded ``.pth``), and
     ``cs2dz_image+d2n-isr``, each against its plain-version twin with its
     launches checked, on DarkZurich frames written on the spot (deflared
     and day pairs), timed; then the no-fusion type through
     ``tools.train.main --imnet`` for 1 iteration and one evaluation; the CE kernels' C = 2 point is held and timed in
     3 and 5;
 15. the CycleGAN workflow and the image-only trainers
     (``phase_image_trainers``): ``create_cityscapes_image_change --mode
     crops`` on two 2048x1024 grayscale PNGs per domain written on the
     spot, ``tools.train_cyclegan.main`` at the JAX CLI's defaults (1
     channel, ngf 64, 9 blocks, ndf 64, a 3-layer PatchGAN, lsgan, pool 50,
     load 286, crop 256, batch 1) for 4 steps (finite logs, the generators
     move, the npz's ``g_a`` reads back equal), 2 steps at pool 1 on the
     card against the CPU from those weights (losses, parameters within
     2 lr a step, the pool's choices), ``--mode en`` with that npz on two
     2048x1024 IC frames against the generator applied in-process; OrgDACS
     at MiT-b5 (cs2dz 512x512 batch 2, no fusion module, the ImageNet
     feature distance, rows 15 / 120 cropped, a random 3-channel day ->
     night generator) for 3 steps with its step time, sections and peak
     memory, its micro step on the card against the CPU; DACSImage with
     ``isrd2isrn`` at MiT-b5 for 2 steps; the prototype functions at
     [2,128,128,256], 19 classes, memory 5000 on the card against the CPU,
     timed. None of the five kernels is on these paths: their counters
     must not move (``launches_image_trainers``);
 16. the model zoo (``phase_model_zoo``): CMDA's fusion and decoder-sharing
     ablations through the train CLI's flags (``--fusion af``, ``--fusion
     caf``, ``--no_share_decoder``, ``--half_share_decoder``) on the
     cs2dsec step at CUT_BACKBONE's depth (``--backbone``), 512x512, batch
     2, float32, each against its
     plain-version twin with the flagship's launches (CE 8 / dx 8 / argmax
     3 / ISR 1, the kernels line's ``launches_model_zoo``) and one timed
     step; OrgDACS on DeepLabV2 / ResNet-101 at full depth
     (``dacs_a999_fdthings``, rcs 0.01, plcrop, the frozen R101 twin for
     the distance) for 3 steps with its times, sections and peak memory;
     one supervised step at 512x512 batch 2 of DeepLabV3+, DANet and ISANet
     on ResNet-101, DeepLabV2 on ResNeXt-101 and ResNeSt-101, SegFormer,
     UPerNet and DAFormer-ISA on MiT-b5; ``tools.run_experiments`` in
     process (``--exp 100`` and ``--exp 102`` whole, a combo of each of
     grids 3-8), every combo [OK]; two supervised micro ResNet steps on the
     card and the CPU against a float64 CPU run, and a TF32 control step
     on the card that must fail the card's tolerance. The legacy paths
     launch none of the kernels;
 17. the run-operations tools (``phase_tools``): the custom ops'
     dispatch against the wrappers' direct call (argmax, ISR; per call);
     ``export_model`` of the cs2dsec fusion model at CUT_BACKBONE's depth
     for CUDA (batch 1, 440x640, float32) with ``--verify``, then ``run``
     on the artifact (the graph names the argmax op, each call launches
     the kernel once); ``bench_infer``
     (batch 1 and 8, slide), ``profile_step`` (batch 2, a traced step
     read by ``analyze_trace``), ``bench_ce``, ``bench_scan`` (remat
     none / full / dots); one b5 step with ``remat_policy='dots'``
     against ``'full'`` from one state and draws (C4), then three timed
     steps of each, alternating; a micro
     4-iteration ``train_chunked`` run in 2 segment processes, merged,
     its LR against an unbroken run's, its checkpoint through
     ``checkpoint_tools`` publish / convert;
 18. one JSON line of per-kernel results, the nvidia-smi line, and last
     ``{"ok": true, "device": {...}}``.

The phases run one after another, each with the card to itself; a
process a phase starts (17's segmented run) is waited for, stays in the
script's process group and is killed when the script exits, a SIGTERM
included. To stay inside the time limit, the repeated full-width checks
run at CUT_BACKBONE's depth (b5's widths, 2 blocks a stage): 8's cs2dz
run, 13's and 14's twins and CLI runs, 16's ablations and 17's export.
"""
import atexit
import contextlib
import gc
import io
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): device memory and fp32 outside the
# tensor cores; the bounds below are computed from these and the shapes
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
# operations per (output pixel, class) of the fused upsample+argmax, as
# the function needs them: a 3-flop two-tap column blend, the 3-flop row
# blend shared by the fw pixels of a coarse column, and a compare; the prob
# adds a subtract, an exp and an add
ARGMAX_OPS_PER_PIXEL_CLASS = 4
ARGMAX_ROW_BLEND_OPS = 3
ARGMAX_PROB_OPS_PER_PIXEL_CLASS = 3
# operations per pixel of the ISR: two directions x (2 x (mul, add, log),
# sub, abs-compare, 2 clamps, 2 x (sub, div, add)) + the average (3)
ISR_OPS_PER_PIXEL = 2 * (2 * 3 + 1 + 1 + 2 + 2 * 3) + 3
# operations per (output pixel, class) of the fused upsample+CE: the
# argmax's blend and online max/sum-exp (13); the dx adds the softmax,
# the one-hot and the coefficient (4) and the transposed row and column
# blends (8)
CE_FWD_OPS_PER_PIXEL_CLASS = 13
CE_DX_OPS_PER_PIXEL_CLASS = 25
ARGMAX_TOL = 1e-5       # prob, absolute; labels may differ only at ties
ISR_TOL = 1e-5          # absolute, values in [-1, 1]
# fused CE: the loss to 1e-5 relative; dx and dweight, which are O(1/N),
# to 1e-4 of their largest magnitude in float32; in bfloat16 the outputs
# round to 8 bits, so 2 units of the last place (2^-7) of the largest
CE_LOSS_RTOL = 1e-5
CE_REL_TOL = 1e-4
CE_BF16_REL_TOL = 2.0 ** -7


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# the processes this script starts (each waited for before the script
# goes on): in its process group, so a signal to the group (a time limit's)
# reaches them with their own children, and killed when it exits
_CHILDREN = []


def spawn(cmd, log_path):
    """Start ``cmd`` from the repository root in this script's process
    group, its output to ``log_path``."""
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=ROOT)
    _CHILDREN.append(proc)
    return proc


def _stop_children():
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


atexit.register(_stop_children)


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


# the kernels each wrapper launches, as the profiler names them; a call's
# device time is the sum of these kernels' durations in a trace
KERNEL_NAMES = {
    "fused_resize_argmax": ("argmax_tile_kernel",),
    "batched_isr": ("isr_grid_kernel",),
    "fused_resize_ce": ("ce_fwd_kernel",),
    "fused_resize_ce_dx": ("ce_dx_kernel",),
    "fused_resize_ce_dweight": ("ce_dweight_kernel",),
}
# the kernels of earlier designs, matched only when --device-time times an
# older checkout: a second launch of the CE forward, the one-thread-per-pixel
# argmax and the three-launch ISR
EARLIER_KERNEL_NAMES = {
    "fused_resize_argmax": ("resize_argmax_kernel",),
    "batched_isr": ("init_extrema", "isr_reduce", "isr_write"),
    "fused_resize_ce": ("sum_partials_kernel",),
}
# bytes written between calls for a cold-L2 reading (the H100's L2 is 50 MB)
L2_FLUSH_BYTES = 256 * 2**20
# traces device_ms takes at most before it fails: a trace that dropped a
# kernel's events is taken again, and the count taken goes into the results
DEVICE_MS_TRACES = 3


def kernel_spans(prof, names):
    """(start, end) in us of the traced device kernels whose name holds one
    of ``names``, in start order."""
    import torch
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and any(n in e.name for n in names))


def device_ms(fn, names, calls=20, warmup=3, cold=False):
    """(device time of one call of ``fn()`` in ms, traces taken), the
    wrapper's host work and launch gaps left out: over ``calls`` calls in a
    ``torch.profiler`` trace, the median duration of each of the call's own
    kernels (``names``) times its launches per call, summed. Taken per
    kernel, so an event the trace drops shifts no kernel onto another call;
    a trace that dropped more than 2 of a kernel's events, or all of them,
    is taken again, up to DEVICE_MS_TRACES traces. ``cold`` writes
    L2_FLUSH_BYTES between calls, so each call finds its inputs outside
    L2."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = (torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if cold
             else None)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(DEVICE_MS_TRACES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if flush is not None:
                    flush.fill_(1.0)
                fn()
                torch.cuda.synchronize()
        total, seen, short = 0.0, 0, None
        for name in names:
            spans = kernel_spans(prof, (name,))
            if not spans:   # not a kernel of this checkout
                continue
            per = round(len(spans) / calls)
            if per == 0 or abs(len(spans) - per * calls) > 2:
                short = f"{len(spans)} traced {name} over {calls} calls"
                break
            total += per * statistics.median(e - s for s, e in spans)
            seen += 1
        if short is None and not seen:
            short = f"no traced kernel named {names}"
        if short is None:
            break
        print(f"device_ms: trace {attempt + 1} of {DEVICE_MS_TRACES} holds "
              f"{short}; tracing again", flush=True)
    if short is not None:
        fail(f"device_ms: {short} in each of {DEVICE_MS_TRACES} traces")
    return total / 1e3, attempt + 1


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


def argmax_bound(shape, size, with_prob):
    """(bound ms, bound_by) of the upsample+argmax: the float32 logits read
    once, labels (and prob) written once, against ARGMAX_* operations."""
    b, h, w, c = shape
    n = b * size[0] * size[1]
    nbytes = b * h * w * c * 4 + n * 4 * (2 if with_prob else 1)
    per = (ARGMAX_OPS_PER_PIXEL_CLASS + ARGMAX_ROW_BLEND_OPS / (size[1] // w)
           + (ARGMAX_PROB_OPS_PER_PIXEL_CLASS if with_prob else 0))
    return bound(nbytes, n * c * per)


def isr_bound(b, h, w):
    """(bound ms, bound_by) of the ISR: gray read and the output written
    once, the directions read once."""
    return bound(2 * b * h * w * 4 + b * 4, b * h * w * ISR_OPS_PER_PIXEL)


# the upsample+argmax where the main paths launch it: name -> (logits shape,
# output size, with_prob)
ARGMAX_POINTS = {
    # evaluate_fusion at batch 8 and inference_segmentor: labels only
    "serving_b8": ((8, 110, 160, 19), (440, 640), False),
    "serving_b1": ((1, 110, 160, 19), (440, 640), False),
    # the DACS step: the teacher's pseudo-labels with the prob, the two
    # stream accuracies without
    "step_prob": ((2, 128, 128, 19), (512, 512), True),
    "step": ((2, 128, 128, 19), (512, 512), False),
    # the serving shape with the prob, timed by earlier checkouts
    "serving_b8_prob": ((8, 110, 160, 19), (440, 640), True),
    # the bfloat16 DACS step at batch 8: float32 logits (its classifier
    # runs in float32), the teacher with the prob, the accuracies without
    "step_b8_prob": ((8, 128, 128, 19), (512, 512), True),
    "step_b8": ((8, 128, 128, 19), (512, 512), False),
    # the test path (cs2dz): whole-mode evaluation of a 540x960 frame, the
    # submission's batch of 4, and infer's 1080x1920 frame padded to 1088
    "test_whole": ((1, 135, 240, 19), (540, 960), False),
    "test_submit_b4": ((4, 135, 240, 19), (540, 960), False),
    "test_infer": ((1, 272, 480, 19), (1088, 1920), False),
}
# the points drawn after every other input of port_kernel_times, so that
# the older points keep the inputs earlier runs timed
LATE_ARGMAX_POINTS = ("test_whole", "test_submit_b4", "test_infer")
# the ISR where the main paths launch it: name -> [B, H, W]
ISR_POINTS = {
    "serving_b1": (1, 440, 640),     # image-only inference_segmentor
    "serving_all": (2, 440, 640),    # the same with shift_type='all'
    "step": (2, 512, 512),           # the DACS step's mixed ISR
    "b8": (8, 440, 640),             # timed by earlier checkouts
    "step_b8": (8, 512, 512),        # the bfloat16 step's, at batch 8
}
# the cs2dz step's mixed ISR: [2, 512, 512], every image in the preset's
# fixed direction (rightdown, index 2) with its uda.isr_params (the
# DarkZurich values: range 1-100, threshold 0.01, clip 0.1, shift 3)
ISR_DZ_STEP = (2, 512, 512)
# infer's image-only ISR of a 1080x1920 frame with cs2dz --output-type
# fusion: rightdown, the preset's data.target_isr (the DarkZurich values)
ISR_TEST_INFER = (1, 1080, 1920)
# the 3-channel mixed ISR of the step (uda.shift_3_channel): three
# launches at [2, 512, 512], every image rightdown, one for each of
# uda.isr_params_3 (the Cityscapes source_isr_3 values, shifts 1, 3, 5)
ISR_3CH_STEP = (2, 512, 512)
ISR_3CH_POINTS = ("step_3ch_shift1", "step_3ch_shift3", "step_3ch_shift5")
# the points whose numbers the kernels line gives at its top level: those
# earlier runs reported there
ARGMAX_REPORTED_POINT = "serving_b8_prob"
ISR_REPORTED_POINT = "b8"


def _smooth_gray(gen, b, h, w, dev):
    """Integer gray frames (0..255) with smooth regions and edges."""
    import torch
    base = torch.randint(0, 256, (b, 1, 1), generator=gen, device=dev)
    steps = torch.randint(-3, 4, (b, h, w), generator=gen, device=dev)
    return (base + steps.cumsum(dim=2)).clamp(0, 255).float()


def _isr_kw(p, shift=None):
    return dict(val_range=tuple(p.val_range), threshold=p.threshold,
                clip_range=p.clip_range,
                shift_pixel=p.shift_pixel if shift is None else shift)


def _isr_3ch_kws():
    """{ISR_3CH_POINTS name: batched_isr keywords} of the 3-channel mixed
    ISR."""
    from cmda_tpu_torch import config as C
    return {name: _isr_kw(p) for name, p in zip(
        ISR_3CH_POINTS, C.cs2dz_image_rawisr_b5().uda.isr_params_3,
        strict=True)}


def port_kernel_times(earlier=False):
    """Device time (``device_ms``) and per-call time (``cuda_ms``) of every
    port kernel at the points the main paths launch it: the CE forward
    (also with cold L2) and dx at the flagship loss and at the bfloat16
    step's batch 8 (CE_POINTS), the dweight at those points in float32 and
    bfloat16, ARGMAX_POINTS and ISR_POINTS (the cs2dsec ISR preset). Inputs
    come from seed 1234, the same in every checkout, so two checkouts
    compare on one card; ``earlier`` also matches EARLIER_KERNEL_NAMES.
    Returns {point: {"device_ms", "traces", "ms", "args"}}, ``traces`` the
    profiler traces device_ms took and ``args`` the inputs timed."""
    import torch
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.ops.fused_ce import (fused_resize_ce_dweight,
                                             fused_resize_ce_dx,
                                             fused_resize_ce_forward)
    from cmda_tpu_torch.ops.fused_resize import fused_resize_argmax
    from cmda_tpu_torch.ops.isr_kernel import batched_isr
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)

    def names(kernel):
        return KERNEL_NAMES[kernel] + (EARLIER_KERNEL_NAMES.get(kernel, ())
                                       if earlier else ())
    x, lbl, wgt = _ce_case(gen, *CE_FLAGSHIP, torch.float32, dev)
    g = torch.ones((), device=dev)
    _, lse = fused_resize_ce_forward(x, lbl, wgt)
    calls = {
        "ce_fwd": (lambda: fused_resize_ce_forward(x, lbl, wgt),
                   names("fused_resize_ce"), (x, lbl, wgt)),
        "ce_dx": (lambda: fused_resize_ce_dx(g, x, lbl, wgt, lse),
                  names("fused_resize_ce_dx"), (g, x, lbl, wgt, lse)),
    }
    def argmax_call(shape, size, with_prob):
        xa = torch.randn(shape, generator=gen, device=dev)
        return (
            lambda: fused_resize_argmax(xa, size, with_prob=with_prob),
            names("fused_resize_argmax"), (xa, size, with_prob))
    for name, (shape, size, with_prob) in ARGMAX_POINTS.items():
        if name not in LATE_ARGMAX_POINTS:
            calls[f"argmax_{name}"] = argmax_call(shape, size, with_prob)
    kw = _isr_kw(C.cs2dsec_image_events_b5().data.target_isr)
    for name, (b, h, w) in ISR_POINTS.items():
        gray = _smooth_gray(gen, b, h, w, dev)
        dirs = torch.arange(b, dtype=torch.int32, device=dev) % 4
        calls[f"isr_{name}"] = (
            lambda gray=gray, dirs=dirs: batched_isr(gray, dirs, **kw),
            names("batched_isr"), (gray, dirs, kw))
    # drawn after the points above, which keep the inputs earlier runs timed
    cases = {"flagship": (x, lbl, wgt)}
    cases["step_b8"] = _ce_case(gen, *CE_POINTS["step_b8"], torch.float32,
                                dev)
    cases["dz_step"] = _dz_ce_case(gen, dev)
    gray, dirs, kw_dz = _dz_isr_case(gen, dev)
    calls["isr_dz_step"] = (
        lambda: batched_isr(gray, dirs, **kw_dz), names("batched_isr"),
        (gray, dirs, kw_dz))
    for point, (xp, lp, wp) in cases.items():
        if point != "flagship":
            _, lse_p = fused_resize_ce_forward(xp, lp, wp)
            calls[f"ce_fwd_{point}"] = (
                lambda xp=xp, lp=lp, wp=wp: fused_resize_ce_forward(
                    xp, lp, wp), names("fused_resize_ce"), (xp, lp, wp))
            calls[f"ce_dx_{point}"] = (
                lambda xp=xp, lp=lp, wp=wp, lse_p=lse_p: fused_resize_ce_dx(
                    g, xp, lp, wp, lse_p), names("fused_resize_ce_dx"),
                (g, xp, lp, wp, lse_p))
        for dtype in (torch.float32, torch.bfloat16):
            if point in CE_NO_DWEIGHT:
                break
            xd = xp.to(dtype)
            _, lse_d = fused_resize_ce_forward(xd, lp, wp)
            calls[f"ce_dweight_{point}_{_dtype_tag(dtype)}"] = (
                lambda xd=xd, lp=lp, lse_d=lse_d: fused_resize_ce_dweight(
                    g, xd, lp, lse_d), names("fused_resize_ce_dweight"),
                (g, xd, lp, wp, lse_d))
    # the test path's points, drawn last
    for name in LATE_ARGMAX_POINTS:
        calls[f"argmax_{name}"] = argmax_call(*ARGMAX_POINTS[name])
    gray_t = _smooth_gray(gen, *ISR_TEST_INFER, dev)
    dirs_t = torch.full((ISR_TEST_INFER[0],), 2, dtype=torch.int32,
                        device=dev)   # rightdown
    kw_t = _isr_kw(C.cs2dz_image_rawisr_b5().data.target_isr)
    calls["isr_test_infer"] = (
        lambda: batched_isr(gray_t, dirs_t, **kw_t), names("batched_isr"),
        (gray_t, dirs_t, kw_t))
    # the 3-channel mixed ISR's points, drawn after all of the above
    for name, kw3 in _isr_3ch_kws().items():
        gray3 = _smooth_gray(gen, *ISR_3CH_STEP, dev)
        dirs3 = torch.full((ISR_3CH_STEP[0],), 2, dtype=torch.int32,
                           device=dev)   # rightdown
        calls[f"isr_{name}"] = (
            lambda gray3=gray3, dirs3=dirs3, kw3=kw3: batched_isr(
                gray3, dirs3, **kw3), names("batched_isr"),
            (gray3, dirs3, kw3))
    # the no-fusion edge stream's C = 2 point, drawn after all of the above
    xe, le, we = _ce_case(gen, *CE_POINTS["edge_c2"], torch.float32, dev,
                          ignored=0.0)
    _, lse_e = fused_resize_ce_forward(xe, le, we)
    calls["ce_fwd_edge_c2"] = (
        lambda: fused_resize_ce_forward(xe, le, we), names("fused_resize_ce"),
        (xe, le, we))
    calls["ce_dx_edge_c2"] = (
        lambda: fused_resize_ce_dx(g, xe, le, we, lse_e),
        names("fused_resize_ce_dx"), (g, xe, le, we, lse_e))
    out = {}
    for k, (fn, nm, args) in calls.items():
        dev_ms, traces = device_ms(fn, nm)
        out[k] = {"device_ms": dev_ms, "traces": traces, "ms": cuda_ms(fn),
                  "args": args}
    for k in ("ce_fwd", "ce_dx"):
        fn, nm, _ = calls[k]
        (out[k]["device_ms_cold_l2"],
         out[k]["traces_cold_l2"]) = device_ms(fn, nm, cold=True)
    return out


def _dtype_tag(dtype):
    return {"torch.float32": "f32", "torch.bfloat16": "bf16"}[str(dtype)]


def _bitwise_repeat(fn, what):
    """fn() twice on the same inputs: the same bits, or fail."""
    import torch
    a, b = fn(), fn()
    torch.cuda.synchronize()
    for u, v in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        if (u is None) != (v is None) or (u is not None
                                          and not torch.equal(u, v)):
            fail(f"{what}: a second run on the same inputs differs")
    return a


def phase_argmax(gen, times):
    """The upsample+argmax kernel against ``resize_argmax`` with and without
    the prob, at the main paths' shapes and the tiles' edge geometries,
    each run twice giving the same bits; then its times at ARGMAX_POINTS
    beside the plain version's and the bound."""
    import torch
    from cmda_tpu_torch.ops.fused_resize import (fused_resize_argmax,
                                                 resize_argmax)
    from cmda_tpu_torch.ops.resize import resize_bilinear
    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    cases = {  # name: (shape, size, dtype)
        "serving_b8": ((8, 110, 160, 19), (440, 640), f32),
        "serving_b8_bf16": ((8, 110, 160, 19), (440, 640), bf16),
        "serving_b1": ((1, 110, 160, 19), (440, 640), f32),
        "step": ((2, 128, 128, 19), (512, 512), f32),
        "nonsquare": ((2, 28, 40, 19), (84, 160), f32),
        # both clamps on one coarse pixel; one of them
        "h1_w1": ((2, 1, 1, 19), (4, 4), f32),
        "h1": ((2, 1, 9, 19), (4, 36), f32),
        "w1": ((2, 7, 1, 19), (28, 4), f32),
        # h and w not multiples of the tile
        "ragged": ((2, 37, 45, 19), (148, 180), f32),
        "factor_1": ((2, 24, 40, 19), (24, 40), f32),
        "fh2_fw3": ((2, 20, 30, 19), (40, 90), f32),
        "fh3_fw4": ((2, 21, 33, 19), (63, 132), f32),
        "c7": ((2, 32, 40, 7), (128, 160), f32),
        # a large C forces a smaller tile and over 48 KB of shared memory
        "c150": ((2, 16, 24, 150), (64, 96), f32),
        "c150_bf16": ((2, 16, 24, 150), (64, 96), bf16),
    }
    worst = 0.0
    for name, (shape, size, dtype) in cases.items():
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        z = resize_bilinear(x.float(), size)
        for with_prob in (True, False):
            label, prob = _bitwise_repeat(
                lambda: fused_resize_argmax(x, size, with_prob=with_prob),
                f"argmax {name} with_prob={with_prob}")
            ref_label, ref_prob = resize_argmax(x, size, with_prob=with_prob)
            n_bad = check_labels(label, ref_label, z,
                                 f"argmax {name} with_prob={with_prob}")
            if with_prob:
                err = float((prob - ref_prob).abs().max())
                if not err <= ARGMAX_TOL:
                    fail(f"argmax {name}: prob error {err}")
                worst = max(worst, err)
            elif prob is not None:
                fail(f"argmax {name}: a prob without with_prob")
            print(f"argmax {name} {shape}->{size} {dtype} with_prob="
                  f"{with_prob}: "
                  + (f"max|dprob| {err:.3g}, " if with_prob else "")
                  + f"label mismatches {n_bad} (all at near ties); "
                  "bitwise equal on a second run", flush=True)
        del z
    tie = torch.full((2, 6, 10, 19), 0.5, device=dev)
    for with_prob in (True, False):
        label, prob = fused_resize_argmax(tie, (24, 40), with_prob=with_prob)
        if int(label.abs().sum()) != 0 or (
                with_prob and float((prob - 1 / 19).abs().max()) > 1e-6):
            fail("argmax tie case: ties must go to class 0 with prob 1/C")
    print("argmax tie case: all labels 0, prob 1/19", flush=True)

    points = {}
    for name, (shape, size, with_prob) in ARGMAX_POINTS.items():
        t = times[f"argmax_{name}"]
        xa = t["args"][0]
        if name in LATE_ARGMAX_POINTS:   # held here, on the timed inputs
            label, _ = _bitwise_repeat(
                lambda: fused_resize_argmax(xa, size, with_prob=with_prob),
                f"argmax {name}")
            n_bad = check_labels(
                label, resize_argmax(xa, size, with_prob=False)[0],
                resize_bilinear(xa, size), f"argmax {name}")
            print(f"argmax {name} {shape}->{size} f32: label mismatches "
                  f"{n_bad} (all at near ties); bitwise equal on a second "
                  "run", flush=True)
        bound_ms, bound_by = argmax_bound(shape, size, with_prob)
        points[name] = {
            "device_ms": t["device_ms"], "traces": t["traces"], "ms": t["ms"],
            "plain_ms": cuda_ms(lambda: resize_argmax(
                xa, size, with_prob=with_prob)),
            "bound_ms": bound_ms, "bound_by": bound_by}
        q = points[name]
        print(f"argmax timing {name} {list(shape)}->{list(size)} f32 "
              f"with_prob={with_prob}: device {q['device_ms']:.4f} ms, per "
              f"call {q['ms']:.4f} ms, plain {q['plain_ms']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    # the top-level numbers stay at the point earlier runs reported, so
    # two runs' lines compare; each main-path point is read in "points"
    return {"name": "fused_resize_argmax", "route": "cuda",
            "source": "cmda_tpu_torch/csrc/fused_resize_argmax.cu",
            "replaces": "cmda_tpu/ops/pallas_ce.py:428",
            "max_abs_err": worst, **points[ARGMAX_REPORTED_POINT],
            "library_ms": None, "point": ARGMAX_REPORTED_POINT,
            "points": points}


def phase_isr(gen, times):
    """The ISR kernel against ``batched_isr_plain`` at the main paths'
    shapes, both presets and shifts 1-3, and at H = 1, W = shift + 1 and a
    frame larger than the resident threads hold, each run twice giving the
    same bits; then its times at ISR_POINTS (and the cs2dz, test-path and
    3-channel points, held there on the timed inputs) beside the plain
    version's and the bound."""
    import torch
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.ops.isr_kernel import batched_isr, batched_isr_plain
    dev = torch.device("cuda")
    presets = {"cs2dsec": C.cs2dsec_image_events_b5().data.target_isr,
               "cs2dz": C.cs2dz_image_rawisr_b5().data.target_isr}
    shapes = dict(ISR_POINTS)
    shapes["large"] = (8, 1080, 1920)
    cases = [(name, shape, preset, shift) for name, shape in shapes.items()
             for preset in presets for shift in (1, 2, 3)]
    # W = shift + 1: one column of each kind; one row (the shift may not
    # exceed H)
    cases += [(f"w_shift{shift}+1", (2, 440, shift + 1), preset, shift)
              for preset in presets for shift in (1, 2, 3)]
    cases += [("h1", (2, 1, 640), preset, 1) for preset in presets]
    # the cs2dz step's: every image rightdown with the preset's
    # uda.isr_params, as _dz_isr_case draws it; and on a dark night frame,
    # most of it in the dead zone
    cases.append(("dz_step", ISR_DZ_STEP, "cs2dz_uda", None))
    cases.append(("dark", ISR_DZ_STEP, "cs2dz_uda", None))
    worst = 0.0
    for name, (b, h, w), preset, shift in cases:
        if name in ("dz_step", "dark"):
            gray, dirs, kw = _dz_isr_case(gen, dev)
            if name == "dark":
                gray = _dark_gray(gen, b, h, w, dev)
            shift = kw["shift_pixel"]
        else:
            gray = _smooth_gray(gen, b, h, w, dev)
            dirs = (torch.arange(b, dtype=torch.int32, device=dev)
                    + shift) % 4
            kw = _isr_kw(presets[preset], shift)
        out = _bitwise_repeat(lambda: batched_isr(gray, dirs, **kw),
                              f"isr {name} {preset} shift {shift}")
        ref = batched_isr_plain(gray, dirs, **kw)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        err = float(diff.max())
        flagged = (diff > ISR_TOL).nonzero().tolist()
        # the dead zone exactly 0 in both, as the reference divides
        zeros = int((ref == 0).sum())
        zero_mismatch = int(((out == 0) != (ref == 0)).sum())
        print(f"isr {name} [{b},{h},{w}] {preset} shift {shift} dirs "
              f"{dirs.tolist()[:4]}: max|d| {err:.3g}, pixels over "
              f"{ISR_TOL}: {len(flagged)}; exactly 0 in the plain version "
              f"{zeros}, in one of the two only {zero_mismatch}; bitwise "
              "equal on a second run", flush=True)
        if zero_mismatch:
            fail(f"isr {name} {preset} shift {shift}: {zero_mismatch} pixels "
                 "exactly 0 in one of the kernel and its plain version only")
        for bi, y, x in flagged[:10]:   # a dead-zone flip shows here
            print(f"  isr {name} pixel (b={bi}, y={y}, x={x}): kernel "
                  f"{float(out[bi, y, x]):.6f} plain {float(ref[bi, y, x]):.6f}"
                  f" gray {float(gray[bi, y, x])}", flush=True)
        if flagged:
            fail(f"isr {name} {preset} shift {shift}: {len(flagged)} pixels "
                 f"differ by more than {ISR_TOL}")
        worst = max(worst, err)

    points = {}
    for name, (b, h, w) in {**ISR_POINTS, "dz_step": ISR_DZ_STEP,
                            "test_infer": ISR_TEST_INFER,
                            **dict.fromkeys(ISR_3CH_POINTS,
                                            ISR_3CH_STEP)}.items():
        t = times[f"isr_{name}"]
        gray, dirs, kw = t["args"]
        if name == "test_infer" or name in ISR_3CH_POINTS:
            # held here, on the timed inputs
            out = _bitwise_repeat(lambda: batched_isr(gray, dirs, **kw),
                                  f"isr {name}")
            err = float((out - batched_isr_plain(gray, dirs, **kw)).abs()
                        .max())
            print(f"isr {name} [{b},{h},{w}] rightdown, shift "
                  f"{kw['shift_pixel']}, range {kw['val_range']}, threshold "
                  f"{kw['threshold']}, clip {kw['clip_range']}: max|d| "
                  f"{err:.3g}; bitwise equal on a second run", flush=True)
            if not err <= ISR_TOL:
                fail(f"isr {name}: error {err} over {ISR_TOL}")
            worst = max(worst, err)
        bound_ms, bound_by = isr_bound(b, h, w)
        points[name] = {
            "device_ms": t["device_ms"], "traces": t["traces"], "ms": t["ms"],
            "plain_ms": cuda_ms(lambda: batched_isr_plain(gray, dirs, **kw)),
            "bound_ms": bound_ms, "bound_by": bound_by}
        q = points[name]
        print(f"isr timing {name} [{b},{h},{w}]: device {q['device_ms']:.4f} "
              f"ms, per call {q['ms']:.4f} ms, plain {q['plain_ms']:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return {"name": "batched_isr", "route": "cuda",
            "source": "cmda_tpu_torch/csrc/batched_isr.cu",
            "replaces": "cmda_tpu/ops/pallas_kernels.py:55",
            "max_abs_err": worst, **points[ISR_REPORTED_POINT],
            "library_ms": None, "point": ISR_REPORTED_POINT, "points": points}


def _ce_case(gen, shape, size, dtype, dev, *, weighted=True, ignored=0.05):
    """Logits, int32 labels with a share ``ignored`` set to 255, and pixel
    weights in [0.2, 1.5) (or None)."""
    import torch
    b, c = shape[0], shape[-1]
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    lbl = torch.randint(0, c, (b,) + tuple(size), generator=gen, device=dev,
                        dtype=torch.int32)
    drop = torch.rand(lbl.shape, generator=gen, device=dev) < ignored
    lbl = torch.where(drop, 255, lbl).to(torch.int32)
    wgt = (0.2 + 1.3 * torch.rand(lbl.shape, generator=gen, device=dev)
           if weighted else None)
    return x, lbl, wgt


def _grads(fn, x, lbl, wgt):
    """(loss, d loss / d x, d loss / d weight or None) of ``fn``."""
    import torch
    xg = x.detach().clone().requires_grad_(True)
    wg = wgt.detach().clone().requires_grad_(True) if wgt is not None else None
    loss = fn(xg, lbl, wg)
    loss.backward()
    torch.cuda.synchronize()
    return loss.detach(), xg.grad, (wg.grad if wg is not None else None)


CE_FLAGSHIP = ((2, 128, 128, 19), (512, 512))
# the CE kernels where the main paths launch them: the float32 step's loss
# at batch 2 and the bfloat16 step's at batch 8 (float32 logits there too:
# the classifier runs in float32)
CE_POINTS = {"flagship": CE_FLAGSHIP,
             "step_b8": ((8, 128, 128, 19), (512, 512)),
             "dz_step": CE_FLAGSHIP,
             "edge_c2": ((2, 128, 128, 2), (512, 512))}
# the points whose path launches no dweight (every step's: the pixel
# weights take no gradient; phase_ce holds it at the others)
CE_NO_DWEIGHT = ("dz_step", "edge_c2")
# edge_c2: the cs2dz no-fusion step's edge stream (uda.isr_edge, no class
# weight): 2 classes, the generic-C loop of the kernels; its labels are 0 or
# 1, none ignored
# the cs2dz step's mixed loss: the pixel weight is 1 on the pasted source
# classes and the pseudo weight elsewhere, which is its confidence ratio
# with rows 0-14 and the last 120 zeroed (uda.pseudo_weight_ignore_top /
# _bottom)
DZ_IGNORE_TOP, DZ_IGNORE_BOTTOM = 15, 120


def _dz_ce_case(gen, dev):
    """Logits and labels as ``_ce_case`` at CE_FLAGSHIP, and the cs2dz
    mixed pixel weight: 1 on a random half of the pixels, 0.6 on the rest
    except the cropped rows, 0 there."""
    import torch
    x, lbl, _ = _ce_case(gen, *CE_FLAGSHIP, torch.float32, dev)
    pasted = torch.rand(lbl.shape, generator=gen, device=dev) < 0.5
    pseudo = torch.full(lbl.shape, 0.6, device=dev)
    pseudo[:, :DZ_IGNORE_TOP] = 0.0
    pseudo[:, -DZ_IGNORE_BOTTOM:] = 0.0
    return x, lbl, torch.where(pasted, torch.ones_like(pseudo), pseudo)


def _dark_gray(gen, b, h, w, dev):
    """A dark night frame's gray levels: 32x32 blocks of levels 5-40 with
    noise of 0-3 levels, so most pixels fall in the ISR's dead zone."""
    import torch
    blocks = torch.randint(5, 41, (b, h // 32 + 1, w // 32 + 1),
                           generator=gen, device=dev)
    base = blocks.repeat_interleave(32, 1).repeat_interleave(32, 2)
    noise = torch.randint(0, 4, (b, h, w), generator=gen, device=dev)
    return (base[:, :h, :w] + noise).float()


def _dz_isr_case(gen, dev):
    """(gray, dirs, kw) of the cs2dz step's mixed ISR (ISR_DZ_STEP)."""
    import torch
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.ops.isr import SHIFT_DIRECTIONS
    cfg = C.cs2dz_image_rawisr_b5()
    b, h, w = ISR_DZ_STEP
    dirs = torch.full((b,), SHIFT_DIRECTIONS.index(cfg.uda.shift_type),
                      dtype=torch.int32, device=dev)
    return _smooth_gray(gen, b, h, w, dev), dirs, _isr_kw(cfg.uda.isr_params)


def ce_bounds(shape, size, elt):
    """{kernel: (bound ms, bound_by)} of the three CE kernels at logits
    ``shape`` of ``elt`` bytes an element and labels of ``size``."""
    (b, h, w, c), (hh, ww) = shape, size
    n_fine = b * hh * ww
    logits_b, pix_b = b * h * w * c * elt, n_fine * 4
    return {
        # logits, labels, weights in; the scalar out
        "fwd": bound(logits_b + 2 * pix_b + 4,
                     n_fine * c * CE_FWD_OPS_PER_PIXEL_CLASS),
        # logits, labels, weights in; dx out
        "dx": bound(2 * logits_b + 2 * pix_b,
                    n_fine * c * CE_DX_OPS_PER_PIXEL_CLASS),
        # logits, labels in; dweight out. The function's own bytes: it
        # could recompute lse from the logits it reads (the forward's
        # operations), so the lse the kernel is handed is not counted
        "dweight": bound(logits_b + 2 * pix_b,
                         n_fine * c * CE_FWD_OPS_PER_PIXEL_CLASS),
    }


def phase_ce(gen, times):
    """Kernels 1-3 (fused upsample+CE forward, dx, dweight) against the
    plain resize + weighted CE and its autograd gradients, on the card, at
    the main paths' shapes (CE_POINTS) and at edge geometries of the tiles;
    each kernel run twice must give the same bits; the dweight also from
    labels at an address off 16 bytes (its per-pixel instantiation). Then
    their times at CE_POINTS beside the plain version's and the bound."""
    import torch
    import torch.nn.functional as F
    from cmda_tpu_torch.ops.fused_ce import (
        fused_resize_ce, fused_resize_ce_dweight, fused_resize_ce_forward,
        resize_ce)
    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    flagship, b8 = CE_POINTS["flagship"], CE_POINTS["step_b8"]
    cases = {  # name: (shape, size, dtype, weighted, ignored share)
        "flagship_f32": (*flagship, f32, True, 0.05),
        "flagship_bf16": (*flagship, bf16, True, 0.05),
        "step_b8_f32": (*b8, f32, True, 0.05),
        "step_b8_bf16": (*b8, bf16, True, 0.05),
        # the cs2dz mixed loss: cropped rows of zero weight (_dz_ce_case)
        "dz_step": (*flagship, f32, True, 0.05),
        "nonsquare_3x4": ((2, 32, 40, 19), (96, 160), f32, True, 0.05),
        "all_ignored": ((2, 32, 40, 19), (128, 160), f32, True, 1.0),
        "no_weight": (*flagship, f32, False, 0.05),
        # both clamps on one coarse pixel; one of them
        "h1_w1": ((2, 1, 1, 19), (4, 4), f32, True, 0.05),
        "h1": ((2, 1, 9, 19), (4, 36), f32, True, 0.05),
        "w1": ((2, 7, 1, 19), (28, 4), f32, True, 0.05),
        # h and w not multiples of the tiles
        "ragged": ((2, 37, 45, 19), (148, 180), f32, True, 0.05),
        "ragged_bf16": ((2, 37, 45, 19), (148, 180), bf16, True, 0.05),
        "factor_1": ((2, 24, 40, 19), (24, 40), f32, True, 0.05),
        "fh2_fw3": ((2, 20, 30, 19), (40, 90), f32, True, 0.05),
        "fh3_fw4": ((2, 21, 33, 19), (63, 132), f32, True, 0.05),
        "b1": ((1, 64, 64, 19), (256, 256), f32, True, 0.05),
        "c7": ((2, 32, 40, 7), (128, 160), f32, True, 0.05),
        # a large C forces the smaller tiles (and over 48 KB of shared
        # memory for the dx)
        "c150": ((2, 16, 24, 150), (64, 96), f32, True, 0.05),
        "c150_bf16": ((2, 16, 24, 150), (64, 96), bf16, True, 0.05),
        # the no-fusion edge stream: 2 classes, no label ignored
        "edge_c2": (*CE_POINTS["edge_c2"], f32, True, 0.0),
    }
    worst = {"loss": 0.0, "dx": 0.0, "dweight": 0.0}
    for name, (shape, size, dtype, weighted, ignored) in cases.items():
        if name == "dz_step":
            x, lbl, wgt = _dz_ce_case(gen, dev)
        else:
            x, lbl, wgt = _ce_case(gen, shape, size, dtype, dev,
                                   weighted=weighted, ignored=ignored)
        loss, dx, dw = _grads(fused_resize_ce, x, lbl, wgt)
        again = _grads(fused_resize_ce, x, lbl, wgt)
        if not all(torch.equal(a, b) for a, b in zip((loss, dx, dw), again)
                   if a is not None):
            fail(f"ce {name}: a second run on the same inputs differs")
        ref, ref_dx, ref_dw = _grads(resize_ce, x, lbl, wgt)
        if name == "all_ignored":
            zeros = (float(loss) == 0.0 and float(dx.abs().max()) == 0.0
                     and float(dw.abs().max()) == 0.0)
            print(f"ce {name}: loss {float(loss)}, max|dx| "
                  f"{float(dx.abs().max())}, max|dweight| "
                  f"{float(dw.abs().max())}", flush=True)
            if not zeros:
                fail("ce all_ignored: loss, dx and dweight must be exactly 0")
            continue
        tol = CE_REL_TOL if dtype == f32 else CE_BF16_REL_TOL
        diffs = {"loss": (loss - ref).abs(),
                 "dx": (dx.float() - ref_dx.float()).abs().max()}
        scale = {"loss": ref.abs(), "dx": ref_dx.float().abs().max()}
        if dw is not None:
            diffs["dweight"] = (dw - ref_dw).abs().max()
            scale["dweight"] = ref_dw.abs().max()
        errs = {k: float(diffs[k] / scale[k]) for k in diffs}
        print(f"ce {name} {shape}->{size} {dtype}: loss {float(loss):.7f} vs "
              f"{float(ref):.7f}; errors relative to max|ref| "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f" (tolerance loss {CE_LOSS_RTOL:g}, grads {tol:g}); "
              "bitwise equal on a second run", flush=True)
        if not errs["loss"] <= CE_LOSS_RTOL:
            fail(f"ce {name}: loss relative error {errs['loss']}")
        for k in ("dx", "dweight"):
            if k in errs and not errs[k] <= tol:
                fail(f"ce {name}: {k} error {errs[k]} of max|ref|")
        if dtype == f32:
            for k, v in diffs.items():
                worst[k] = max(worst[k], float(v))

    # labels 4 bytes past a 16-byte boundary: the dweight's per-pixel
    # instantiation, against the vectorised one on the same values
    x, lbl, wgt = _ce_case(gen, *flagship, f32, dev)
    g = torch.ones((), device=dev)
    _, lse = fused_resize_ce_forward(x, lbl, wgt)
    buf = torch.empty(lbl.numel() + 1, dtype=torch.int32, device=dev)
    lbl_off = buf[1:].view(lbl.shape)
    lbl_off.copy_(lbl)
    if lbl_off.data_ptr() % 16 == 0:
        fail("ce dweight: the offset labels are 16-byte aligned")
    a = fused_resize_ce_dweight(g, x, lbl, lse)
    b = _bitwise_repeat(lambda: fused_resize_ce_dweight(g, x, lbl_off, lse),
                        "ce dweight, offset labels")
    err = float((a - b).abs().max() / a.abs().max())
    print(f"ce dweight with labels off 16 bytes (per-pixel kernel) vs "
          f"aligned (4 pixels a thread): {err:.3g} of max|dweight| "
          f"(tolerance {CE_REL_TOL:g}); bitwise equal on a second run",
          flush=True)
    if not err <= CE_REL_TOL:
        fail(f"ce dweight: offset labels give {err} of max|dweight|")

    # timing at CE_POINTS (the forward and dx in float32, as both steps
    # launch them; the dweight also in bfloat16), with pixel weights, on the
    # inputs port_kernel_times timed
    def plain_fwd_bwd(x, lbl, wgt, wrt_weight):
        xg = x.detach().requires_grad_(not wrt_weight)
        wg = wgt.detach().requires_grad_(wrt_weight)
        resize_ce(xg, lbl, wg).backward()

    points = {"fwd": {}, "dx": {}, "dweight": {}}
    pair_ms = None
    for point, (shape, size) in CE_POINTS.items():
        sfx = "" if point == "flagship" else f"_{point}"
        _, x, lbl, wgt, _ = times[f"ce_dx{sfx}"]["args"]
        with torch.no_grad():
            plain_fwd = cuda_ms(lambda: resize_ce(x, lbl, wgt))
        plain = {"fwd": plain_fwd,
                 "dx": cuda_ms(lambda: plain_fwd_bwd(x, lbl, wgt, False))}
        bounds = ce_bounds(shape, size, 4)
        for k in ("fwd", "dx"):
            t = times[f"ce_{k}{sfx}"]
            points[k][point] = {
                "device_ms": t["device_ms"], "traces": t["traces"],
                "ms": t["ms"], "plain_ms": plain[k],
                "bound_ms": bounds[k][0], "bound_by": bounds[k][1]}
            if "device_ms_cold_l2" in t:
                points[k][point].update(
                    device_ms_cold_l2=t["device_ms_cold_l2"],
                    traces_cold_l2=t["traces_cold_l2"])
        for dtype in (f32, bf16):
            if point in CE_NO_DWEIGHT:
                break
            t = times[f"ce_dweight_{point}_{_dtype_tag(dtype)}"]
            xd = t["args"][1]
            bd = ce_bounds(shape, size, xd.element_size())["dweight"]
            points["dweight"][f"{point}_{_dtype_tag(dtype)}"] = {
                "device_ms": t["device_ms"], "traces": t["traces"],
                "ms": t["ms"], "plain_ms": cuda_ms(
                    lambda: plain_fwd_bwd(xd, lbl, wgt, True)),
                "bound_ms": bd[0], "bound_by": bd[1]}
        if point == "flagship":
            (hh, ww), lbl64 = size, lbl.long()

            def library_pair():
                z = F.interpolate(x.permute(0, 3, 1, 2), size=(hh, ww),
                                  mode="bilinear", align_corners=False)
                return (F.cross_entropy(z, lbl64, ignore_index=255,
                                        reduction="none") * wgt).mean()
            with torch.no_grad():
                pair_ms = cuda_ms(library_pair)
    for k, pts in points.items():
        for point, q in pts.items():
            print(f"ce timing {k} {point}: device {q['device_ms']:.4f} ms"
                  + (f" warm L2, {q['device_ms_cold_l2']:.4f} ms cold L2"
                     if "device_ms_cold_l2" in q else "")
                  + f"; per call {q['ms']:.4f} ms, plain {q['plain_ms']:.4f} "
                  f"ms ({'forward' if k == 'fwd' else 'forward+backward'}), "
                  f"bound {q['bound_ms']:.4f} ms ({q['bound_by']})",
                  flush=True)
    names = {"fwd": ("fused_resize_ce", "cmda_tpu/ops/pallas_ce.py:114"),
             "dx": ("fused_resize_ce_dx", "cmda_tpu/ops/pallas_ce.py:141"),
             "dweight": ("fused_resize_ce_dweight",
                         "cmda_tpu/ops/pallas_ce.py:196")}
    # the top-level numbers stay at the flagship float32 point, as earlier
    # runs reported them; every point is under "points"
    top = {"fwd": "flagship", "dx": "flagship", "dweight": "flagship_f32"}
    out = []
    for k, (kname, replaces) in names.items():
        q = points[k][top[k]]
        out.append({"name": kname, "route": "cuda",
                    "source": "cmda_tpu_torch/csrc/fused_resize_ce.cu",
                    "replaces": replaces, "max_abs_err": worst[
                        "loss" if k == "fwd" else k],
                    "ms": q["ms"], "device_ms": q["device_ms"],
                    "traces": q["traces"],
                    "device_ms_cold_l2": q.get("device_ms_cold_l2"),
                    "traces_cold_l2": q.get("traces_cold_l2"),
                    "plain_ms": q["plain_ms"], "bound_ms": q["bound_ms"],
                    "bound_by": q["bound_by"], "library_ms": None,
                    "library_pair_ms": pair_ms, "point": top[k],
                    "points": points[k]})
    q = {k: points[k]["flagship"]["ms"] for k in ("fwd", "dx")}
    print(f"ce timing: kernels fwd+dx {q['fwd'] + q['dx']:.4f} ms per call "
          f"vs plain fwd+bwd {points['dx']['flagship']['plain_ms']:.4f} ms; "
          f"F.interpolate + F.cross_entropy (two calls, forward only) "
          f"{pair_ms:.4f} ms", flush=True)
    return out


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


TRAIN_COUNTED = ("fused_resize_ce", "fused_resize_ce_dx",
                 "fused_resize_ce_dweight", "fused_resize_argmax",
                 "batched_isr")
# launches per DACS step: 4 streams x (source, mixed) CEs and their dx; the
# teacher's pseudo-labels and the two acc_seg; the mixed ISR. The pixel
# weights carry no gradient, so the dweight kernel never runs in a step.
TRAIN_LAUNCHES_PER_STEP = {"fused_resize_ce": 8, "fused_resize_ce_dx": 8,
                           "fused_resize_ce_dweight": 0,
                           "fused_resize_argmax": 3, "batched_isr": 1}
# the single-batch train types (cs2dz_image+raw-isr, cs2dsec_image+events):
# 3 streams (image, events, fusion) x (source, mixed)
TRAIN_LAUNCHES_PER_STEP_3 = {**TRAIN_LAUNCHES_PER_STEP,
                             "fused_resize_ce": 6, "fused_resize_ce_dx": 6}


def step_launches(trainer):
    """The launches per step of ``trainer``'s train type, mixed ISR and
    options: the ISR kernel once, three times with ``uda.shift_3_channel``
    (one for each of ``uda.isr_params_3``), never when
    ``uda.mixed_image_to_mixed_isr`` is off (the mixed ISR is then the
    ClassMix of the two ISRs) or under ``uda.shift_type='all'`` (the mean
    of four directions in plain torch, where the JAX step takes no Pallas
    ISR either); with ``uda.source_only`` only the source pass's CE and
    accuracy; with ``uda.stacked_stream_ce`` and four streams no CE kernel
    (one plain checkpointed resize+CE over the stack, XLA's in the JAX
    step); for the DarkZurich ablations (split, no-fusion, d2n) two CEs a
    pass, one when the edge stream is class-weighted."""
    u = trainer.cfg.uda
    isr = (0 if not u.mixed_image_to_mixed_isr
           else len(u.isr_params_3) if u.shift_3_channel
           else 0 if u.shift_type == "all" else 1)
    passes = 1 if u.source_only else 2
    if trainer.two_stream:
        # the DarkZurich ablations: the image and events streams' CEs, the
        # class-weighted edge stream (isr_edge_class_weight) a plain one;
        # the teacher's pseudo-labels (two for the split type, none through
        # the kernel for d2n); no ISR kernel for d2n (a ClassMix of ISRs)
        ce = (1 if trainer.edge_cw is not None else 2) * passes
        teacher = 2 if trainer.split else 0 if trainer.d2n else 1
        return {"fused_resize_ce": ce, "fused_resize_ce_dx": ce,
                "fused_resize_ce_dweight": 0,
                "fused_resize_argmax": teacher + passes,
                "batched_isr": 0 if trainer.d2n else isr}
    base = (TRAIN_LAUNCHES_PER_STEP if trainer.together
            else TRAIN_LAUNCHES_PER_STEP_3)
    ce = (0 if trainer.together and u.stacked_stream_ce
          else base["fused_resize_ce"] // 2 * passes)
    return {**base, "fused_resize_ce": ce, "fused_resize_ce_dx": ce,
            "fused_resize_argmax": 1 + passes, "batched_isr": isr}
# the micro step at 64x64 (at 32x32 the micro model's dilated ASPP
# BatchNorm amplifies float32 noise) three ways: on the card through the
# kernels, on the card through their plain versions, and on the CPU.
# Losses to 1e-4 relative; acc_seg in percent may move by a few near-tie
# pixels of the 2 x 64 x 64 labels. AdamW's first moments (0.1 x the summed
# gradient after one step), per tensor, relative to the largest first moment
# over all tensors: kernels vs plain versions on the card, where nothing
# else differs, to 1e-5; the card vs the CPU, whose convolutions and
# reductions round differently, to 5e-4 (behind train-mode BatchNorm some
# gradients are sums that nearly cancel, so rounding moves them by up to
# 1e-3 of their own largest value).
TRAIN_MICRO_HW = (64, 64)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_ACC_ATOL = 100.0 * 8 / (2 * 64 * 64)
TRAIN_KERNEL_MOMENT_RTOL = 1e-5
TRAIN_MOMENT_RTOL = 5e-4
# the same micro step in bfloat16, through the kernels against through the
# plain versions on the card: the forwards are the same ops until the float32
# losses, which agree to ~1e-7, and the backward rounds the gradients to
# bfloat16 at every activation, where a difference that small can move a
# value by a unit of its last place (2^-8 relative) now and then; the first
# moments to 2^-6 of the largest
TRAIN_BF16_KERNEL_MOMENT_RTOL = 2.0 ** -6


# phase_train's counted steps before its one timed step (the step its
# CUDA-event sections are taken from): few, so the whole script,
# phase_model_zoo included, stays well inside its time limit
TRAIN_COUNTED_STEPS = 1
# the depth cut of the repeated full-width checks, to keep the script in
# its time: MiT at b5's widths (64, 128, 320, 512; heads 1, 2, 5, 8) with 2
# blocks a stage instead of 3, 6, 40, 3, the ``mit_b1`` variant. It runs
# the cs2dz training run, the UDA options' and the train types' twins and
# CLI runs, the zoo's ablation twins and the exported model; the flagship
# and cs2dz steps, the flagship's run, the test path, the corpus runs and
# every timed comparison stay at b5
CUT_BACKBONE = "mit_b1"
# the bare step's median by phase tag ("train_cs2dz", ...), for the runs
# timed beside it
STEP_MS_MEDIAN = {}
STEP_PROFILED = {}     # tag: (profiled step's host ms, its device-busy ms)


def _kernel_counters():
    from cmda_tpu_torch.ops import fused_ce, fused_resize, isr_kernel
    fns = {"fused_resize_ce": fused_ce.fused_resize_ce,
           "fused_resize_ce_dx": fused_ce.fused_resize_ce_dx,
           "fused_resize_ce_dweight": fused_ce.fused_resize_ce_dweight,
           "fused_resize_argmax": fused_resize.fused_resize_argmax,
           "batched_isr": isr_kernel.batched_isr}
    return {k: fns[k] for k in TRAIN_COUNTED}


def _counted_step(trainer, state, batch, draws=None):
    """One train_step with the launch counters set to 0 just before it and
    read just after: (logs, launches)."""
    import torch
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    state, logs = trainer.train_step(state, batch, draws)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    if launches != step_launches(trainer):
        fail(f"train step launches {launches}, expected "
             f"{step_launches(trainer)}")
    logs = {k: float(v) for k, v in logs.items()}
    bad = [k for k, v in logs.items() if not math.isfinite(v)]
    if bad:
        fail(f"train step logs not finite: {bad}")
    return logs, launches


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms inside, its default ones after."""
    import torch
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


@contextlib.contextmanager
def _tf32(on):
    """TF32 convolutions and matmuls inside when ``on``; off after, as the
    script runs everything else."""
    import torch
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def _plain_versions(isr=True):
    """Route the DACS step's kernel wrappers to their plain PyTorch
    versions, on whatever device the tensors are: the CE and argmax, and
    the ISR unless ``isr`` is False."""
    from cmda_tpu_torch.ops.fused_ce import resize_ce
    from cmda_tpu_torch.ops.fused_resize import resize_argmax
    from cmda_tpu_torch.ops.isr_kernel import batched_isr, batched_isr_plain
    from cmda_tpu_torch.uda import dacs, transforms

    def plain_ce(x, label, weight=None, *, ignore_index=255):
        return resize_ce(x, label, weight, ignore_index)
    with mock.patch.object(transforms, "fused_resize_ce", plain_ce), \
            mock.patch.object(transforms, "fused_resize_argmax",
                              resize_argmax), \
            mock.patch.object(dacs, "batched_isr",
                              batched_isr_plain if isr else batched_isr):
        yield


def _check_logs(logs, ref, what):
    """Losses to TRAIN_LOSS_RTOL, acc_seg to TRAIN_ACC_ATOL; returns the
    largest relative loss error."""
    worst = 0.0
    for k, r in sorted(ref.items()):
        r = float(r)
        if k.endswith("acc_seg"):
            ok = abs(logs[k] - r) <= TRAIN_ACC_ATOL
        else:
            err = abs(logs[k] - r) / max(abs(r), 1e-12)
            worst = max(worst, err if r else abs(logs[k]))
            ok = abs(logs[k] - r) <= TRAIN_LOSS_RTOL * abs(r)
        if not ok:
            fail(f"{what}: {k} {logs[k]} vs {r}")
    return worst


def _check_moments(state, ref_state, rtol, what):
    """AdamW's first moments of ``state`` against ``ref_state``'s, each
    tensor's largest difference within ``rtol`` of the largest first moment
    over all tensors (``rtol`` None: reported only); returns that relative
    difference."""
    names = {p: k for k, p in ref_state.model.named_parameters()}
    got, ref, keys = [], [], []
    for g, g_ref in zip(state.optimizer.param_groups,
                        ref_state.optimizer.param_groups, strict=True):
        for p, p_ref in zip(g["params"], g_ref["params"], strict=True):
            got.append(state.optimizer.state[p]["exp_avg"].cpu())
            ref.append(ref_state.optimizer.state[p_ref]["exp_avg"].cpu())
            keys.append(names[p_ref])
    scale = max(float(r.abs().max()) for r in ref)
    diff = sorted(((float((a - r).abs().max()), float(r.abs().max()), k)
                   for a, r, k in zip(got, ref, keys)), reverse=True)
    print(f"{what}: AdamW first moments of {len(keys)} tensors, "
          f"largest max|ref| {scale:.3g}; the 3 largest differences: "
          + "; ".join(f"{k} {e:.3g} (its max|ref| {sc:.3g})"
                      for e, sc, k in diff[:3]), flush=True)
    bad = [k for e, _, k in diff if rtol is not None and not e <= rtol * scale]
    if bad:
        fail(f"{what}: AdamW first moments differ in {bad}")
    return diff[0][0] / scale


# the micro step's other train types and options (float32): the DarkZurich
# preset's (``cs2dz``: image + ISR, attention fusion, no CycleGAN, the ISR
# rightdown with its parameters, the pseudo weight's rows cropped), and
# ``cs2dsec_image+events`` with grad_clip at a norm every step exceeds
TRAIN_MICRO_VARIANTS = ("cs2dz", "events_clip")
TRAIN_MICRO_CLIP = 1e-3


def _micro_cfg(dtype="float32", variant=None):
    from cmda_tpu_torch import config as C
    cfg = C.micro_test_config()
    cfg = C.replace(cfg, uda=C.replace(cfg.uda, use_cyclegan_day_events=True),
                    data=C.replace(cfg.data, crop_size=TRAIN_MICRO_HW),
                    dtype=dtype)
    if variant == "cs2dz":
        dz = C.cs2dz_image_rawisr_b5()
        cfg = C.replace(cfg, uda=dz.uda, model=C.replace(
            cfg.model, train_type=dz.model.train_type,
            fusion=dz.model.fusion, fusion_isr=dz.model.fusion_isr))
    elif variant == "events_clip":
        cfg = C.replace(
            cfg, model=C.replace(cfg.model, train_type="cs2dsec_image+events"),
            optim=C.replace(cfg.optim, grad_clip=TRAIN_MICRO_CLIP))
    return cfg


def _moments_spread(a, b):
    """The largest difference between two train states' AdamW first
    moments, relative to the largest first moment."""
    pairs = [(a.optimizer.state[p]["exp_avg"], b.optimizer.state[q]["exp_avg"])
             for p, q in zip(a.model.parameters(), b.model.parameters())]
    scale = max(float(u.abs().max()) for u, _ in pairs)
    return max(float((u - v).abs().max()) for u, v in pairs) / scale


def phase_train_micro(dtype="float32", variant=None):
    """One DACS step of the micro config (CycleGAN on; or a
    TRAIN_MICRO_VARIANTS train type) from one state, batch and draws: on
    the card through the kernels, on the card through their plain
    versions, and (float32) on the CPU; held by the losses and by the
    gradients each hands AdamW (the first moments after the step). A
    variant's step also runs twice more through the kernels with
    deterministic cuDNN algorithms: its forward (every loss, through the
    CE and argmax kernels) must give the same bits, and the run-to-run
    spread of its gradients (the bilinear upsample's backward adds with
    atomics) is reported; so are its card-vs-CPU first moments, not held
    (a train type other than the flagship's has no such bound yet)."""
    import copy
    import torch
    from cmda_tpu_torch.data.synthetic import (SyntheticSource,
                                               SyntheticTarget, uda_batch)
    from cmda_tpu_torch.uda.dacs import DACSTrainer
    cfg = _micro_cfg(dtype, variant)
    tag = "train micro" + (f" {variant}" if variant else "")
    cpu, gpu = DACSTrainer(cfg, device="cpu"), DACSTrainer(cfg, device="cuda")
    s_cpu, s_gpu, s_plain = cpu.init_state(), gpu.init_state(), gpu.init_state()
    for s in (s_gpu, s_plain):
        pairs = [(s_cpu.model, s.model), (s_cpu.ema_model, s.ema_model)]
        if s.cyclegan is not None:
            pairs.append((s_cpu.cyclegan, s.cyclegan))
        for a, b in pairs:
            b.load_state_dict(a.state_dict())
    start = copy.deepcopy(s_gpu) if variant else None
    events = cpu.has_events
    batch = uda_batch(SyntheticSource(crop_size=TRAIN_MICRO_HW,
                                      with_time_res=events),
                      SyntheticTarget(crop_size=TRAIN_MICRO_HW,
                                      with_events=events), [0, 1])
    draws = cpu.new_draws(s_cpu, 2)
    if dtype == "float32":
        _, ref = cpu.train_step(s_cpu, batch, draws)
    logs, _ = _counted_step(gpu, s_gpu, batch, draws.to("cuda"))
    counters = _kernel_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    with _plain_versions():
        _, plain = gpu.train_step(s_plain, batch, draws.to("cuda"))
    if any(fn.launches != before[k] for k, fn in counters.items()):
        fail(f"{tag}: the plain-version step launched a kernel")
    plain = {k: float(v) for k, v in plain.items()}
    loss_plain = _check_logs(logs, plain, f"{tag}, kernels vs plain on cuda")
    if dtype != "float32":
        m_plain = _check_moments(s_gpu, s_plain,
                                 TRAIN_BF16_KERNEL_MOMENT_RTOL,
                                 f"{tag}, bfloat16, kernels vs plain on cuda")
        print(f"train micro bfloat16: one step, losses max relative error "
              f"{loss_plain:.3g} (kernels vs plain on cuda), tolerance "
              f"{TRAIN_LOSS_RTOL:g}; AdamW first moments within "
              f"{m_plain:.3g} of the largest (tolerance "
              f"{TRAIN_BF16_KERNEL_MOMENT_RTOL:g}); acc_seg "
              f"{logs['src/acc_seg']:.3f}/{logs['mix/acc_seg']:.3f} vs plain "
              f"{plain['src/acc_seg']:.3f}/{plain['mix/acc_seg']:.3f}",
              flush=True)
        return
    loss_cpu = _check_logs(logs, ref, f"{tag}, cuda vs cpu")
    m_plain = _check_moments(s_gpu, s_plain, TRAIN_KERNEL_MOMENT_RTOL,
                             f"{tag}, kernels vs plain on cuda")
    m_cpu = _check_moments(s_gpu, s_cpu, None if variant else
                           TRAIN_MOMENT_RTOL, f"{tag}, cuda vs cpu")
    extra = ""
    if variant:
        runs = []
        with _deterministic_cudnn():
            for _ in range(2):
                s = copy.deepcopy(start)
                _, lg = gpu.train_step(s, batch, draws.to("cuda"))
                runs.append(({k: float(v) for k, v in lg.items()}, s))
        if runs[0][0] != runs[1][0]:
            fail(f"{tag}: a second run from the same state gives other "
                 f"logs: {runs[0][0]} vs {runs[1][0]}")
        extra = ("; a second run with deterministic cuDNN: logs bitwise "
                 "equal, first moments within "
                 f"{_moments_spread(runs[0][1], runs[1][1]):.3g} of the "
                 "largest")
        if cfg.optim.grad_clip is not None:
            norm = float(torch.linalg.vector_norm(torch.stack([
                p.grad.norm() for p in runs[0][1].model.parameters()])))
            if abs(norm - cfg.optim.grad_clip) > 1e-3 * cfg.optim.grad_clip:
                fail(f"{tag}: the clipped gradient's norm is {norm}, not "
                     f"{cfg.optim.grad_clip}")
            extra += (f"; gradients clipped to global norm {norm:.6g} "
                      f"(grad_clip {cfg.optim.grad_clip:g})")
        extra += (f"; use_events {logs['use_events']:.0f}, streams "
                  + ",".join(sorted(k[4:] for k in logs
                                    if k.startswith("src/loss_"))))
    print(f"{tag}: one step, losses max relative error {loss_plain:.3g} "
          f"(kernels vs plain on cuda) and {loss_cpu:.3g} (cuda vs cpu), "
          f"tolerance {TRAIN_LOSS_RTOL:g}; AdamW first moments within "
          f"{m_plain:.3g} (tolerance {TRAIN_KERNEL_MOMENT_RTOL:g}) and "
          f"{m_cpu:.3g} ("
          + ("reported" if variant else f"tolerance {TRAIN_MOMENT_RTOL:g}")
          + f") of the largest; "
          f"acc_seg {logs['src/acc_seg']:.3f}/{logs['mix/acc_seg']:.3f} vs "
          f"cpu {float(ref['src/acc_seg']):.3f}/"
          f"{float(ref['mix/acc_seg']):.3f}{extra}", flush=True)


def _device_busy(trainer, state, batch):
    """One step under ``torch.profiler`` (device activity only): (host ms
    of the profiled step, device-busy ms = the union of its kernels' and
    copies' intervals, number of device events, {kernel name: [launches,
    device ms]} of the port's kernels in the step); busy is None when the
    trace holds no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for names in KERNEL_NAMES.values():
        for n in names:
            spans = kernel_spans(prof, (n,))
            kernels[n] = [len(spans), sum(e - s for s, e in spans) / 1e3]
    busy, n_events = _busy_ms(prof)
    return host_ms, busy, n_events, kernels


def _busy_ms(prof):
    """(device-busy ms = the union of a trace's kernel and copy intervals,
    or None when it holds no device event; the number of device events)."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None, 0
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    return busy / 1e3, len(spans)


_SECTION_NAMES = {"cyclegan": "cyclegan", "ema": "ema_update",
                  "teacher": "teacher_and_pseudo_labels",
                  "mix": "classmix_jitter_blur_mixed_isr",
                  "src_fwd": "source_fwd", "src_bwd": "source_bwd",
                  "mix_fwd": "mixed_fwd", "mix_bwd": "mixed_bwd",
                  "optimizer": "optimizer"}


def _step_sections(trainer, state, batch, draws=None):
    """One step with the trainer's section marks on: ({section: device ms
    by CUDA events}, {section: [peak allocated GiB within it, live GiB at
    its end]}, live GiB at the step's start)."""
    import torch
    trainer.marks = []
    trainer.train_step(state, batch, draws)
    torch.cuda.synchronize()
    marks, trainer.marks = trainer.marks, None
    breakdown = {_SECTION_NAMES[n]: a.elapsed_time(e)
                 for (_, a, _, _), (n, e, _, _) in zip(marks, marks[1:])}
    memory = {_SECTION_NAMES[n]: [top / 2**30, live / 2**30]
              for n, _, top, live in marks[1:]}
    return breakdown, memory, marks[0][3] / 2**30


def _state_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_train(dtype="float32", batch=None, preset="cs2dsec", options=False):
    """The DACS training step of a MiT-b5 preset at 512x512 (the flagship
    cs2dsec, or cs2dz): float32 at the preset's batch 2, or the JAX
    package's ``bench.py`` step (bfloat16 at batch 8), with ``options`` its
    ``--teacher-bf16 --moments bfloat16`` (``uda.teacher_bf16``,
    ``optim.moment_dtype='bfloat16'``). TRAIN_COUNTED_STEPS counted steps
    (launches, the dtype of the logits each CE launch takes), then the step
    time, its device-time breakdown, the peak memory and the bytes of
    AdamW's state (and of the teacher's bfloat16 copy). Returns the
    launches of the counted steps by kernel."""
    import torch
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.data.synthetic import (SyntheticSource,
                                               SyntheticTarget, uda_batch)
    from cmda_tpu_torch.uda import transforms
    from cmda_tpu_torch.uda.dacs import DACSTrainer
    cfg = C.PRESETS[preset]()
    cfg = C.replace(cfg, dtype=dtype, data=C.replace(
        cfg.data, batch_size=batch or cfg.data.batch_size))
    if options:
        cfg = C.replace(cfg, uda=C.replace(cfg.uda, teacher_bf16=True),
                        optim=C.replace(cfg.optim, moment_dtype="bfloat16"))
    tag = ("train" + ("" if dtype == "float32" else "_bf16")
           + ("" if preset == "cs2dsec" else f"_{preset}")
           + ("_opts" if options else ""))
    b, (w, h) = cfg.data.batch_size, cfg.data.crop_size
    t0 = time.perf_counter()
    trainer = DACSTrainer(cfg, device="cuda")
    state = trainer.init_state(seed=0)
    n_params = sum(p.numel() for p in state.model.parameters())
    torch.cuda.synchronize()
    print(f"{tag}: {preset} ({cfg.model.train_type}) MiT-b5 DACS, {n_params} "
          f"params, {h}x{w} batch {b} {dtype}, remat {cfg.model.remat}, "
          f"teacher_bf16 {cfg.uda.teacher_bf16}, moments "
          f"{cfg.optim.moment_dtype}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    events = trainer.has_events
    src = SyntheticSource(crop_size=(w, h), with_time_res=events)
    tgt = SyntheticTarget(crop_size=(w, h), with_events=events)
    batches = [uda_batch(src, tgt, [b * i + j for j in range(b)])
               for i in range(TRAIN_COUNTED_STEPS + 2)]
    student0 = [p.detach().clone() for p in state.model.parameters()]
    totals = dict.fromkeys(TRAIN_COUNTED, 0)
    ce_dtypes = set()
    real_ce = transforms.fused_resize_ce

    def recorded_ce(x, *args, **kwargs):
        ce_dtypes.add(str(x.dtype))
        return real_ce(x, *args, **kwargs)
    for i in range(TRAIN_COUNTED_STEPS):
        t0 = time.perf_counter()
        with mock.patch.object(transforms, "fused_resize_ce", recorded_ce):
            logs, launches = _counted_step(trainer, state, batches[i])
        for k, v in launches.items():
            totals[k] += v
        print(f"{tag} step {i}: {time.perf_counter() - t0:.2f} s, launches "
              f"{launches}, loss {logs['loss']:.5f}, src/loss_seg "
              f"{logs['src/loss_seg']:.5f}, mix/loss_seg "
              f"{logs['mix/loss_seg']:.5f}, pseudo_weight "
              f"{logs['pseudo_weight']:.5f}, use_events "
              f"{logs['use_events']:.0f}", flush=True)
        if i == 0:
            same = all(torch.equal(e, p) for e, p in
                       zip(state.ema_model.parameters(), student0))
            if not same:
                fail(f"{tag}: after step 0 the EMA teacher is not the "
                     "pre-update student")
    moved = sum(int(not torch.equal(p, q)) for p, q in
                zip(state.model.parameters(), student0))
    print(f"{tag}: after {TRAIN_COUNTED_STEPS} steps {moved} of "
          f"{len(student0)} parameter "
          f"tensors moved; EMA teacher after step 0 == the pre-update "
          f"student; the CE kernels took logits of {sorted(ce_dtypes)}",
          flush=True)
    if moved == 0:
        fail(f"{tag}: no parameter moved")
    del student0

    # the timed step carries the section marks; its peak is the largest of
    # its sections' (without the copy of the student above)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    breakdown, memory, start_gib = _step_sections(trainer, state,
                                                  batches[-2])
    step_ms = [(time.perf_counter() - t0) * 1e3]
    peak = max(top for top, _ in memory.values())
    total = sum(breakdown.values())
    prof_ms, busy_ms, n_events, step_kernels = _device_busy(
        trainer, state, batches[-1])
    adamw_bytes = _state_bytes(t for st in state.optimizer.state.values()
                               for k, t in st.items() if k != "step")
    teacher_bytes = (_state_bytes(state.teacher.parameters())
                     if state.teacher is not None else 0)
    timings = {"train_step_ms_median": statistics.median(step_ms),
               "train_samples_per_s": b / statistics.median(step_ms) * 1e3,
               "train_adamw_state_bytes": adamw_bytes,
               "train_teacher_copy_bytes": teacher_bytes,
               "train_ce_logits_dtypes": sorted(ce_dtypes),
               "train_step_ms": step_ms, "train_peak_gib": peak,
               "train_breakdown_ms": breakdown,
               "train_start_live_gib": start_gib,
               "train_section_peak_live_gib": memory,
               "train_profiled_step_ms": prof_ms,
               "train_device_busy_ms": busy_ms,
               "train_device_events": n_events,
               "train_step_kernels": step_kernels}
    print(f"{tag}: profiled step " + (
        f"{prof_ms:.2f} ms host, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / prof_ms:.1f}%) over {n_events} device events"
        if busy_ms is not None else
        f"{prof_ms:.2f} ms host, device busy not measured (the trace holds "
        "no device event)"), flush=True)
    print(f"{tag}: the port's kernels in the profiled step (launches, device "
          "ms): " + ", ".join(f"{n} {k} x {t:.4f} ms"
                              for n, (k, t) in step_kernels.items()),
          flush=True)
    print(f"{tag}: step time median {statistics.median(step_ms):.2f} ms over "
          f"{len(step_ms)} steps "
          f"({', '.join(f'{t:.2f}' for t in step_ms)}), "
          f"{b / statistics.median(step_ms) * 1e3:.3f} samples/s; peak device "
          f"memory {peak:.2f} GiB; AdamW state {adamw_bytes} bytes "
          f"({adamw_bytes / 2**30:.3f} GiB), teacher bfloat16 copy "
          f"{teacher_bytes} bytes", flush=True)
    print(f"{tag}: step device ms " + ", ".join(
        f"{k} {v:.2f} ({100 * v / total:.1f}%)" for k, v in breakdown.items())
        + f"; sum {total:.2f}", flush=True)
    print(f"{tag}: step memory GiB, live at its start {start_gib:.2f}; per "
          "section peak / live at its end: " + ", ".join(
              f"{k} {p:.2f} / {lv:.2f}" for k, (p, lv) in memory.items()),
          flush=True)
    print(f"{tag} timings " + json.dumps(timings), flush=True)
    STEP_MS_MEDIAN[tag] = statistics.median(step_ms)
    STEP_PROFILED[tag] = (prof_ms, busy_ms)
    return totals


# the training run through its CLI: the flagship at 512x512 batch 2 for 8
# iterations, logging each, with a checkpoint, an evaluation of the
# 8-sample val set (batch 1) and debug grids every 3. A debug snapshot runs
# steps 1-5 of the step (the teacher's pseudo-labels, the mixed ISR); an
# evaluation one argmax per val sample. The iterations timed as steady are
# those whose record holds no debug snapshot, checkpoint or evaluation
# (a record's time runs from the previous record, so iteration 4's holds
# iteration 3's checkpoint and evaluation); iterations 4-5 are profiled.
LOOP_ITERS = 6
LOOP_INTERVAL = 3
LOOP_VAL = 8
LOOP_DEBUG_LAUNCHES = {"fused_resize_ce": 0, "fused_resize_ce_dx": 0,
                       "fused_resize_ce_dweight": 0,
                       "fused_resize_argmax": 1, "batched_isr": 1}
LOOP_EVAL_LAUNCHES = {"fused_resize_ce": 0, "fused_resize_ce_dx": 0,
                      "fused_resize_ce_dweight": 0,
                      "fused_resize_argmax": LOOP_VAL, "batched_isr": 0}
LOOP_STEADY = (2, 5)
LOOP_PROFILED = (4, 5)
LOOP_LOG_RTOL = 1e-6


def _state_tensors(state):
    """Every tensor of a train state by name (student and teacher
    parameters and buffers, AdamW's state) and its step."""
    import torch
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"ema/{k}": v
                for k, v in state.ema_model.state_dict().items()})
    names = {p: k for k, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        out.update({f"opt/{names[p]}/{k}": v for k, v in st.items()})
    out["step"] = torch.tensor(state.step)
    return out


def _feed_ms(cfg):
    """The host parts of the loop's ``data_time`` outside the loop, on
    flagship batches, in ms: ``encode_wire`` of one batch again and again
    and of 5 fresh batches, with no loader thread running; ``encode_wire``
    of a batch just taken from a ``PrefetchLoader`` of 4 workers with full
    queues (its worker starts refilling, as in the loop), 5 times 0.5 s
    apart, with torch's intra-op threads and with one; the device feed's
    ``next()`` (pinned fill, copy issue); and one batch of the loader's
    work on one thread. Medians."""
    import random
    import torch
    from cmda_tpu_torch.data.loader import (PrefetchLoader, collate,
                                            device_prefetch)
    from cmda_tpu_torch.data.uda import UDAPairDataset
    from cmda_tpu_torch.data.synthetic import SyntheticSource, SyntheticTarget
    from cmda_tpu_torch.data.wire import encode_wire

    def ms(fn):
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out

    (w, h), b = cfg.data.crop_size, cfg.data.batch_size
    pairs = UDAPairDataset(SyntheticSource(crop_size=(w, h)),
                           SyntheticTarget(crop_size=(w, h)), seed=cfg.seed)
    rng = random.Random(0)

    def one_batch():
        return collate([pairs.load(rng.randrange(len(pairs)), rng=rng)
                        for _ in range(b)])
    loads = [ms(one_batch) for _ in range(5)]
    fresh = [ms(lambda: encode_wire(batch))[0] for _, batch in loads]
    batch = loads[0][1]
    again = [ms(lambda: encode_wire(batch))[0] for _ in range(5)]

    def under_loader():
        loader = PrefetchLoader(pairs, b, num_workers=4, seed=cfg.seed)
        out = []
        try:
            deadline = time.perf_counter() + 60
            while (not all(q.full() for q in loader.queues)
                   and time.perf_counter() < deadline):
                time.sleep(0.1)
            for _ in range(5):
                time.sleep(0.5)
                taken = next(loader)
                out.append(ms(lambda: encode_wire(taken))[0])
        finally:
            loader.close()
        return statistics.median(out)
    under = under_loader()
    # the same with one intra-op thread: whether the workers contend with
    # the GIL or with the intra-op thread pool for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        under_1 = under_loader()
        fresh_1 = statistics.median(ms(lambda: encode_wire(batch))[0]
                                    for _, batch in loads)
    finally:
        torch.set_num_threads(threads)
    wire = encode_wire(batch)
    feed = device_prefetch(iter([wire] * 8), "cuda", cfg.data.device_prefetch)
    place = []
    for _ in range(7):
        torch.cuda.synchronize()
        place.append(ms(lambda: next(feed))[0])
    torch.cuda.synchronize()

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()
    return {"loader_batch_ms": statistics.median(t for t, _ in loads),
            "feed_encode_ms": statistics.median(again),
            "feed_encode_fresh_ms": statistics.median(fresh),
            "feed_encode_under_loader_ms": under,
            "feed_encode_fresh_1_thread_ms": fresh_1,
            "feed_encode_under_loader_1_thread_ms": under_1,
            "intra_op_threads": threads,
            "feed_next_ms": statistics.median(place[2:]),
            "feed_wire_bytes": nbytes(wire)}


def phase_loop(preset="cs2dsec", backbone=None):
    """The DACS training run of a preset (the flagship cs2dsec, or cs2dz),
    with ``backbone`` its MiT variant if given,
    through ``cmda_tpu_torch.tools.train.main --config <preset>`` (loader
    threads, bf16 wire feed, device prefetch, TrainLoop, checkpoints,
    periodic evaluation, debug grids), with its launch counts per step,
    debug snapshot and evaluation; then a checkpoint loaded in a fresh
    trainer against the state it was written from (the resume), stepping as
    it does, and the last checkpoint served; for cs2dsec also the host
    parts of ``data_time`` (``_feed_ms``)."""
    import copy
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.apis import Segmentor, init_segmentor
    from cmda_tpu_torch.data.synthetic import (SyntheticSource,
                                               SyntheticTarget, uda_batch)
    from cmda_tpu_torch.tools import train as cli
    from cmda_tpu_torch.train import loop as loop_mod
    from cmda_tpu_torch.uda.dacs import DACSTrainer
    gc.collect()
    torch.cuda.empty_cache()
    counters = _kernel_counters()
    tag = "loop" if preset == "cs2dsec" else f"loop_{preset}"
    cfg = C.replace(C.PRESETS[preset](), log_interval=1,
                    checkpoint_interval=LOOP_INTERVAL,
                    eval_interval=LOOP_INTERVAL,
                    debug_img_interval=LOOP_INTERVAL)
    if backbone:
        cfg = C.replace(cfg, model=C.replace(cfg.model, backbone=backbone))
    if not (cfg.data.wire_bf16 and cfg.data.device_prefetch == 1
            and cfg.data.workers == 4 and cfg.checkpoint_max_keep == 1):
        fail(f"{tag}: the preset's data settings changed: {cfg.data}")
    launches = {"step": [], "debug": [], "eval": []}
    timings = {"checkpoint_write_s": [], "eval_s": []}
    saved, prof = {}, {}

    def counted(kind, fn):
        def wrapper(*args, **kwargs):
            before = {k: f.launches for k, f in counters.items()}
            out = fn(*args, **kwargs)
            launches[kind].append({k: f.launches - before[k]
                                   for k, f in counters.items()})
            return out
        return wrapper

    real_step = DACSTrainer.train_step
    step_fn = counted("step", real_step)

    def train_step(trainer, state, batch, draws=None):
        if state.step == LOOP_PROFILED[0] - 1:
            torch.cuda.synchronize()
            prof["p"] = profile(activities=[ProfilerActivity.CUDA])
            prof["p"].start()
            prof["t0"] = time.perf_counter()
        return step_fn(trainer, state, batch, draws)

    real_log = loop_mod.TrainLoop.log

    def log(loop, record):
        real_log(loop, record)
        if record.get("iter") == LOOP_PROFILED[-1] and "loss" in record:
            torch.cuda.synchronize()
            prof["host_ms"] = (time.perf_counter() - prof["t0"]) * 1e3
            prof["p"].stop()

    real_save = loop_mod.save_checkpoint

    def save_checkpoint(state, path, meta=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_save(state, path, meta)
        timings["checkpoint_write_s"].append(time.perf_counter() - t0)
        timings["checkpoint_bytes"] = os.path.getsize(path)
        if meta["iter"] == LOOP_INTERVAL:
            # kept past the pruning, with the state it was written from
            saved["path"] = os.path.join(tmp, "kept.pth")
            os.link(path, saved["path"])
            saved["state"] = copy.deepcopy(state)

    real_eval = loop_mod.evaluate_fusion
    split = {"queue": [], "encode": []}

    def timed(kind, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            split[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    def evaluate_fusion(*args, **kwargs):
        t0 = time.perf_counter()
        out = counted("eval", real_eval)(*args, **kwargs)
        timings["eval_s"].append(time.perf_counter() - t0)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        work = os.path.join(tmp, "work")
        argv = ["--config", preset, "--synthetic", "--work-dir", work,
                "--max-iters", str(LOOP_ITERS), "--num-workers", "4",
                "--seed", "0"]
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with mock.patch.dict(C.PRESETS, {preset: lambda: cfg}), \
                mock.patch.object(DACSTrainer, "train_step", train_step), \
                mock.patch.object(DACSTrainer, "debug_tensors", counted(
                    "debug", DACSTrainer.debug_tensors)), \
                mock.patch.object(loop_mod.TrainLoop, "log", log), \
                mock.patch.object(loop_mod, "save_checkpoint",
                                  save_checkpoint), \
                mock.patch.object(loop_mod, "evaluate_fusion",
                                  evaluate_fusion), \
                mock.patch.object(loop_mod.PrefetchLoader, "__next__", timed(
                    "queue", loop_mod.PrefetchLoader.__next__)), \
                mock.patch.object(loop_mod, "encode_wire", timed(
                    "encode", loop_mod.encode_wire)):
            loop = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        totals = {k: f.launches for k, f in counters.items()}
        state = loop.state
        per_step = step_launches(loop.trainer)

        # --- what the run wrote ------------------------------------------
        with open(loop.log_path) as f:
            records = [json.loads(line) for line in f]
        steps = [r for r in records if "loss" in r]
        if [r["iter"] for r in steps] != list(range(1, LOOP_ITERS + 1)):
            fail(f"{tag}: step records {[r['iter'] for r in steps]}")
        bad = [(r["iter"], k) for r in steps for k, v in r.items()
               if not math.isfinite(v)]
        if bad:
            fail(f"{tag}: log values not finite: {bad}")
        files = sorted(os.listdir(work))
        ckpts = [f for f in files if f.startswith("iter_")]
        if ckpts != [f"iter_{LOOP_ITERS}.pth"]:
            fail(f"{tag}: checkpoints {ckpts}, expected only "
                 f"iter_{LOOP_ITERS}.pth (iter_{LOOP_INTERVAL}.pth pruned)")
        evals = [f for f in files if f.startswith("test_results_")]
        scores = {r["iter"]: r["eval"]["mIoU"] for r in records
                  if "eval" in r}
        want = sorted(f"test_results_{it}_{m * 100:.2f}"
                      for it, m in scores.items())
        if sorted(scores) != [LOOP_INTERVAL, LOOP_ITERS] or sorted(
                evals) != want:
            fail(f"{tag}: evaluation dirs {evals}, expected {want}")
        for e in evals:
            panels = sorted(os.listdir(os.path.join(work, e)))
            if panels != [f"{i:06d}.png" for i in range(LOOP_VAL)]:
                fail(f"{tag}: {e} holds {panels}")
        grids = sorted(os.listdir(os.path.join(work, "class_mix_debug")))
        if grids != [f"{it:06d}_{i}.png" for it in (LOOP_INTERVAL, LOOP_ITERS)
                     for i in range(2)]:
            fail(f"{tag}: class_mix_debug holds {grids}")
        if "code.tar.gz" not in files:
            fail(f"{tag}: no code.tar.gz")

        # --- launches ----------------------------------------------------
        n_evals = LOOP_ITERS // LOOP_INTERVAL
        if (launches["step"] != [per_step] * LOOP_ITERS
                or launches["debug"] != [LOOP_DEBUG_LAUNCHES] * n_evals
                or launches["eval"] != [LOOP_EVAL_LAUNCHES] * n_evals):
            fail(f"{tag}: launches per step {launches['step']}, per debug "
                 f"snapshot {launches['debug']}, per evaluation "
                 f"{launches['eval']}")
        expect = {k: LOOP_ITERS * per_step[k]
                  + n_evals * (LOOP_DEBUG_LAUNCHES[k]
                               + LOOP_EVAL_LAUNCHES[k]) for k in totals}
        if totals != expect:
            fail(f"{tag}: launches {totals}, expected {expect}")
        print(f"{tag}: {cfg.model.backbone}, {LOOP_ITERS} iterations "
              f"through tools.train.main in "
              f"{run_s:.1f} s; launches {totals} (per step "
              f"{per_step}, per debug snapshot argmax 1 ISR "
              f"1, per evaluation argmax {LOOP_VAL}); final loss "
              f"{steps[-1]['loss']:.5f}; mIoU {scores}", flush=True)

        # --- a checkpoint loads back and steps as the state it holds -----
        # resume: init_state from the config's seed (which also makes the
        # CycleGAN, not part of a checkpoint), then the load
        trainer = DACSTrainer(cfg, device="cuda")
        fresh = trainer.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = loop_mod.load_checkpoint(fresh, saved["path"])
        torch.cuda.synchronize()
        timings["checkpoint_read_s"] = time.perf_counter() - t0
        ref, got = _state_tensors(saved["state"]), _state_tensors(loaded)
        diff = sorted(set(ref) ^ set(got)) + [
            k for k in ref if k in got and not (
                ref[k].dtype == got[k].dtype
                and ref[k].device == got[k].device
                and torch.equal(ref[k], got[k]))]
        if diff or got["step"] != LOOP_INTERVAL:
            fail(f"{tag}: iter_{LOOP_INTERVAL}.pth loads back different "
                 f"tensors: {diff[:8]}")
        (w, h) = cfg.data.crop_size
        events = loop.trainer.has_events
        batch = uda_batch(SyntheticSource(crop_size=(w, h),
                                          with_time_res=events),
                          SyntheticTarget(crop_size=(w, h),
                                          with_events=events), [0, 1])
        draws = trainer.new_draws(loaded, cfg.data.batch_size)

        def step_logs(state):
            return {k: float(v) for k, v in
                    trainer.train_step(state, batch, draws)[1].items()}

        def worst(a, b):
            return max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-12) for k in a)
        # with deterministic algorithms: cuDNN's default ones (the
        # CycleGAN's transposed convolutions among them) need not give the
        # same bits on two calls (8.5e-8 relative on cs2dsec on an H100;
        # those reported steps are no longer run, to keep the script inside
        # its time)
        with _deterministic_cudnn():
            a, b = step_logs(saved["state"]), step_logs(loaded)
        timings["resume_step_rel_diff_deterministic"] = worst(a, b)
        if worst(a, b) > LOOP_LOG_RTOL:
            fail(f"{tag}: a step from the loaded state differs by "
                 f"{worst(a, b):.3g} relative: {a} vs {b}")
        print(f"{tag}: iter_{LOOP_INTERVAL}.pth in a fresh trainer equals the "
              f"state it was written from in all {len(ref)} tensors and the "
              f"step; one step from each on one batch and draws, with "
              f"deterministic cuDNN algorithms: logs "
              + ("bitwise equal" if a == b else
                 f"within {worst(a, b):.3g} relative") + ", tolerance "
              f"{LOOP_LOG_RTOL:g}", flush=True)
        del saved["state"], loaded, fresh, trainer

        # --- the last checkpoint serves --------------------------------
        seg = init_segmentor(cfg, os.path.join(work, ckpts[0]),
                             device="cuda")
        sample = SyntheticTarget(crop_size=(w, h), length=LOOP_VAL,
                                 with_events=loop.trainer.has_events,
                                 test_mode=True)[0]
        second = sample.get("events", sample["isr"])
        ours = seg.predict(sample["image"], second)
        student = Segmentor(cfg, state.model, seg.output).predict(
            sample["image"], second)
        if not torch.equal(ours, student):
            fail(f"{tag}: init_segmentor(iter_{LOOP_ITERS}.pth) predicts "
                 "other labels "
                 "than the student")
        del seg

    feed = _feed_ms(cfg) if preset == "cs2dsec" else {}
    iter_ms = {r["iter"]: r["time"] * 1e3 for r in steps}
    busy_ms, n_events = _busy_ms(prof["p"])
    timings.update({
        "loop_iter_ms": iter_ms,
        "loop_iter_ms_median_steady": statistics.median(
            iter_ms[i] for i in LOOP_STEADY),
        "loop_iter_ms_median_unprofiled": statistics.median(
            iter_ms[i] for i in LOOP_STEADY if i not in LOOP_PROFILED),
        "loop_data_ms": {r["iter"]: r["data_time"] * 1e3 for r in steps},
        "loop_data_ms_median": statistics.median(
            r["data_time"] * 1e3 for r in steps[1:]),
        "loop_profiled_ms": prof["host_ms"],
        "loop_profiled_busy_ms": busy_ms,
        "loop_profiled_events": n_events,
        # the feed pulls batch i + 1 while handing out batch i
        "loop_queue_ms": split["queue"][2:LOOP_ITERS + 1],
        "loop_encode_ms": split["encode"][2:LOOP_ITERS + 1],
        "loop_run_s": run_s, **feed})
    print(f"{tag}: iteration ms " + ", ".join(
        f"{i} {t:.2f}" for i, t in iter_ms.items())
        + f"; steady median (iterations {LOOP_STEADY}) "
        f"{timings['loop_iter_ms_median_steady']:.2f} ms, of the unprofiled "
        f"ones {timings['loop_iter_ms_median_unprofiled']:.2f} ms", flush=True)
    print(f"{tag}: data_time ms " + ", ".join(
        f"{i} {t:.3f}" for i, t in timings["loop_data_ms"].items())
        + f"; median after the first {timings['loop_data_ms_median']:.3f}; "
        f"of it, in the loop (iterations 2-{LOOP_ITERS}, median): the "
        f"loader queue "
        f"{statistics.median(timings['loop_queue_ms']):.3f} ms, encode_wire "
        f"{statistics.median(timings['loop_encode_ms']):.3f} ms" + (
        "" if not feed else
        f"; outside the loop: encode_wire of one batch again "
        f"{feed['feed_encode_ms']:.3f} ms, of fresh batches "
        f"{feed['feed_encode_fresh_ms']:.3f} ms, of a batch just taken from "
        f"a running loader {feed['feed_encode_under_loader_ms']:.3f} ms "
        f"({feed['intra_op_threads']} intra-op threads; with 1: fresh "
        f"{feed['feed_encode_fresh_1_thread_ms']:.3f} ms, from the loader "
        f"{feed['feed_encode_under_loader_1_thread_ms']:.3f} ms); the "
        f"feed's next() (pinned fill, copy issued) "
        f"{feed['feed_next_ms']:.3f} ms; one loader batch on one thread "
        f"{feed['loader_batch_ms']:.1f} ms"), flush=True)
    print(f"{tag}: checkpoint {timings['checkpoint_bytes']} bytes, written in "
          + ", ".join(f"{t:.2f}" for t in timings["checkpoint_write_s"])
          + f" s, read in {timings['checkpoint_read_s']:.2f} s; evaluation "
          f"of {LOOP_VAL} samples " + ", ".join(
              f"{t:.2f}" for t in timings["eval_s"]) + " s", flush=True)
    print(f"{tag}: profiled iterations {LOOP_PROFILED}: " + (
        f"{prof['host_ms']:.2f} ms host, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / prof['host_ms']:.1f}%) over {n_events} device "
        "events" if busy_ms is not None else
        f"{prof['host_ms']:.2f} ms host, device busy not measured (the trace "
        "holds no device event)"), flush=True)
    print(f"{tag} timings " + json.dumps(timings), flush=True)
    return totals


TEST_FRAMES = 4
TEST_FRAME = (1080, 1920)    # DarkZurich's frames, resized to 540x960
TEST_SIZE = (540, 960)
SLIDE_TOL = 1e-5             # of max|logit|: the batched vs the crop loop
TEST_TIMED_REPS = 1          # timed calls after the warm-up
# whole-mode launches of the test path: argmax per evaluation batch (batch
# 1), per submission batch (4 frames) and per infer image; ISR per infer
# image (evaluation's ISR is the dataset's, on the host)
TEST_EVAL_LAUNCHES = {"fused_resize_argmax": TEST_FRAMES, "batched_isr": 0}


def _write_dark_zurich(root):
    """A DarkZurich tree of TEST_FRAMES night frames at 1920x1080 in the
    val split (with ``_gt_labelTrainIds`` labels) and in the test split:
    dark class-keyed blocks with noise, from a seed."""
    from PIL import Image
    g = np.random.default_rng(9)
    h, w = TEST_FRAME
    palette = g.integers(5, 70, (19, 3))
    for split in ("val", "test"):
        img_dir = os.path.join(root, "rgb_anon", split, "night", "seq01")
        os.makedirs(img_dir)
        for i in range(TEST_FRAMES):
            name = f"seq01_frame_{i:06d}_rgb_anon.png"
            blocks = g.integers(0, 19, (h // 120 + 1, w // 120 + 1))
            lbl = np.repeat(np.repeat(blocks, 120, 0), 120, 1)[:h, :w]
            img = palette[lbl] + g.integers(0, 12, (h, w, 3))
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(img_dir, name))
            if split == "val":
                gt_dir = os.path.join(root, "gt", "val", "night", "seq01")
                os.makedirs(gt_dir, exist_ok=True)
                Image.fromarray(lbl.astype(np.uint8)).save(os.path.join(
                    gt_dir, name.replace("_rgb_anon", "_gt_labelTrainIds")))
    return root


def phase_test():
    """The test path of the cs2dz MiT-b5 model at full width: a port
    checkpoint (student from seed 0 with BN statistics moved off their
    init, teacher from seed 1) and a DarkZurich tree written here, driven
    through ``cmda_tpu_torch.tools.test.main`` (whole mode on the image and
    the fusion stream, slide, aug-test, the teacher, the submission of
    both streams) and ``cmda_tpu_torch.tools.infer.main`` (two 1080x1920
    PNGs, fusion) on cuda, each with the launch counters set to 0 just
    before it; checks of each against a version built here; then the
    path's times and peak memory. Returns the launches of all the runs."""
    import torch
    from PIL import Image
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.apis import (build_model, init_segmentor,
                                     inference_segmentor, predict_labels,
                                     select_logits)
    from cmda_tpu_torch.data.dark_zurich import DarkZurichDataset
    from cmda_tpu_torch.models.segmentor import slide_inference
    from cmda_tpu_torch.ops.resize import resize_bilinear
    from cmda_tpu_torch.tools import infer as infer_cli
    from cmda_tpu_torch.tools import test as test_cli
    from cmda_tpu_torch.train import loop as loop_mod
    from cmda_tpu_torch.train.loop import TTA_SCALES, evaluate_fusion
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    counters = _kernel_counters()
    totals = {k: 0 for k in counters}
    cfg = C.cs2dz_image_rawisr_b5()
    timings = {}

    def counted(what, fn, expect=None):
        """fn() with the launch counters set to 0 just before it and read
        just after; the argmax and ISR counts must equal ``expect``."""
        for f in counters.values():
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: f.launches for k, f in counters.items()}
        for k, v in got.items():
            totals[k] += v
        short = {k: got[k] for k in ("fused_resize_argmax", "batched_isr")}
        if expect is not None and short != expect:
            fail(f"test {what}: launches {short}, expected {expect}")
        print(f"test {what}: launches {short}", flush=True)
        return out

    def recorded(fn):
        """fn() and the predictions evaluate_fusion scored in it."""
        preds = []
        real = loop_mod.intersect_and_union

        def rec(pred, label, num_classes):
            preds.append(np.array(pred))
            return real(pred, label, num_classes)
        with mock.patch.object(loop_mod, "intersect_and_union", rec):
            out = fn()
        return out, preds

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = _write_dark_zurich(os.path.join(tmp, "dz"))
        student = build_model(cfg, "cuda", seed=0)
        teacher = build_model(cfg, "cuda", seed=1)
        bn_gen = torch.Generator(device="cuda")
        bn_gen.manual_seed(2)
        with torch.no_grad():   # student statistics off the teacher's
            for name, buf in student.named_buffers():
                if name.endswith("running_mean"):
                    buf.add_(0.1 * torch.randn(buf.shape, generator=bn_gen,
                                               device="cuda"))
                elif name.endswith("running_var"):
                    buf.mul_(0.5 + torch.rand(buf.shape, generator=bn_gen,
                                              device="cuda"))
        ckpt = os.path.join(tmp, "iter_test.pth")
        torch.save({"state_dict": student.state_dict(),
                    "ema_state_dict": teacher.state_dict()}, ckpt)
        del student
        timings["setup_s"] = time.perf_counter() - t0
        base = ["--config", "cs2dz", "--checkpoint", ckpt, "--target-root",
                root, "--device", "cuda"]

        def test_main(*extra):
            # the summaries it prints go to chiprun_out/, the checks here
            # print one line each
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                got = test_cli.main(base + list(extra))
            log_dir = os.path.join(os.path.dirname(os.path.abspath(
                __file__)), "chiprun_out")
            os.makedirs(log_dir, exist_ok=True)
            with open(os.path.join(log_dir, "test_cli.log"), "a") as f:
                f.write(" ".join(extra) + "\n" + out.getvalue())
            return got

        # --- whole mode, the image and the fusion stream ------------------
        whole = {}
        for stream in ("image", "fusion"):
            summary, whole[stream] = recorded(lambda: counted(
                f"whole {stream}", lambda: test_main("--output-type", stream),
                TEST_EVAL_LAUNCHES))
            if not math.isfinite(summary["mIoU"]) or len(whole[stream]) != (
                    TEST_FRAMES):
                fail(f"test whole {stream}: {summary['mIoU']}, "
                     f"{len(whole[stream])} predictions")
            print(f"test whole {stream}: mIoU {summary['mIoU']:.5f}",
                  flush=True)

        # --- slide ----------------------------------------------------------
        summary, slide_preds = recorded(lambda: counted(
            "slide", lambda: test_main("--inference", "slide"),
            {"fused_resize_argmax": 0, "batched_isr": 0}))
        if not math.isfinite(summary["mIoU"]):
            fail(f"test slide: mIoU {summary['mIoU']}")
        seg = init_segmentor(cfg, ckpt, device="cuda", output="fusion")
        val = DarkZurichDataset(root, split="val",
                                isr_params=cfg.data.target_isr,
                                outputs=("image", "isr", "label"))

        def frame(dataset, i):
            s = dataset[i]
            return torch.cat([torch.from_numpy(np.asarray(s[k], np.float32))
                              for k in ("image", "isr")], -1)[None].cuda()

        def crop_logits(x):
            return resize_bilinear(select_logits(
                seg.model, x[..., :3], x[..., 3:], "fusion"), x.shape[1:3])

        def slide(x):
            with torch.no_grad():
                return slide_inference(crop_logits, x, crop_size=(512, 512),
                                       stride=(341, 341), num_classes=19)

        both = frame(val, 0)
        got = _bitwise_repeat(lambda: slide(both), "test slide logits")
        h, w = TEST_SIZE
        ref = torch.zeros_like(got)
        count = torch.zeros_like(got[..., :1])
        n_crops = 0
        with torch.no_grad():   # reference encoder_decoder.py:175-218
            for hi in range((h - 512 + 340) // 341 + 1):
                for wi in range((w - 512 + 340) // 341 + 1):
                    y2, x2 = min(hi * 341 + 512, h), min(wi * 341 + 512, w)
                    y1, x1 = max(y2 - 512, 0), max(x2 - 512, 0)
                    ref[:, y1:y2, x1:x2] += crop_logits(
                        both[:, y1:y2, x1:x2])
                    count[:, y1:y2, x1:x2] += 1
                    n_crops += 1
        ref /= count
        err = float((got - ref).abs().max() / ref.abs().max())
        print(f"test slide: {n_crops} crops at 540x960; logits within "
              f"{err:.3g} of max|logit| of the crop-by-crop loop (tolerance "
              f"{SLIDE_TOL:g}); bitwise equal on a second run", flush=True)
        if n_crops != 6 or not err <= SLIDE_TOL:
            fail(f"test slide: {n_crops} crops, error {err}")
        if not np.array_equal(got.argmax(-1)[0].cpu().numpy(),
                              slide_preds[0]):
            n_bad = int((got.argmax(-1)[0].cpu().numpy()
                         != slide_preds[0]).sum())
            print(f"test slide: {n_bad} labels of frame 0 differ between "
                  "tools.test and this run's slide", flush=True)
        timings["slide_err_rel"] = err

        # --- aug-test -------------------------------------------------------
        summary, aug_preds = recorded(lambda: counted(
            "aug-test", lambda: test_main("--aug-test"),
            {"fused_resize_argmax": 0, "batched_isr": 0}))
        if not math.isfinite(summary["mIoU"]):
            fail(f"test aug-test: mIoU {summary['mIoU']}")
        agree = float(np.mean([np.mean(a == b) for a, b in
                               zip(aug_preds, whole["fusion"])]))
        timings["aug_test_whole_agreement"] = agree
        print(f"test aug-test: mIoU {summary['mIoU']:.5f}; labels equal to "
              f"whole mode's on {agree:.4f} of the pixels (predicted 0.5-0.9"
              ", not gated at random weights)", flush=True)

        # --- the teacher on the student's BN statistics --------------------
        summary, teacher_preds = recorded(lambda: counted(
            "use-teacher", lambda: test_main("--use-teacher"),
            TEST_EVAL_LAUNCHES))
        sd = torch.load(ckpt, map_location="cuda", weights_only=True)
        ref_teacher = build_model(cfg, "cuda", seed=3)
        ref_teacher.load_state_dict(sd["ema_state_dict"])
        with torch.no_grad():
            students = dict(seg.model.named_buffers())
            for name, buf in ref_teacher.named_buffers():
                buf.copy_(students[name])
        del sd
        _, ref_preds = recorded(lambda: evaluate_fusion(ref_teacher, val))
        same = all(np.array_equal(a, b)
                   for a, b in zip(teacher_preds, ref_preds))
        differs = not all(np.array_equal(a, b)
                          for a, b in zip(teacher_preds, whole["fusion"]))
        print(f"test use-teacher: predictions equal to the EMA parameters "
              f"with the student's BN buffers: {same}; differ from the "
              f"student's: {differs}", flush=True)
        if not (same and differs):
            fail("test use-teacher: the teacher's predictions")
        del ref_teacher

        # --- the submission, image and fusion -------------------------------
        test_set = DarkZurichDataset(root, split="test",
                                     isr_params=cfg.data.target_isr)
        batch = [test_set[i] for i in range(TEST_FRAMES)]
        img4 = torch.from_numpy(np.stack([b["image"] for b in batch])).cuda()
        isr4 = torch.from_numpy(np.stack([b["isr"] for b in batch]).astype(
            np.float32)).cuda()
        for stream in ("image", "fusion"):
            sub = os.path.join(tmp, f"sub_{stream}")
            info = counted(f"submission {stream}", lambda: test_main(
                "--submit-to-website", "--show-dir", sub,
                *(("--output-type", "fusion") if stream == "fusion" else ())),
                {"fused_resize_argmax": 1, "batched_isr": 0})
            if info["stream"] != stream:
                fail(f"test submission: stream {info['stream']}")
            with torch.no_grad():
                pred = predict_labels(select_logits(
                    seg.model, img4, isr4 if stream == "fusion" else None,
                    stream), TEST_SIZE).cpu().numpy()
            for j, path in enumerate(test_set.files):
                name = os.path.basename(path)
                arrs = {}
                for d in ("labelTrainIds", "labelTrainIds_invalid",
                          "confidence"):
                    if sorted(os.listdir(os.path.join(sub, d))) != sorted(
                            os.path.basename(f) for f in test_set.files):
                        fail(f"test submission {stream}: {d} holds "
                             f"{os.listdir(os.path.join(sub, d))}")
                    with Image.open(os.path.join(sub, d, name)) as im:
                        if im.size != (1920, 1080):
                            fail(f"test submission {d}/{name}: {im.size}")
                        arrs[d] = np.asarray(im)
                lab, conf = arrs["labelTrainIds"], arrs["confidence"]
                want = np.repeat(np.repeat(pred[j], 2, 0), 2, 1)
                if not (lab.dtype == np.uint8 and lab.max() < 19
                        and np.array_equal(lab, want)
                        and np.array_equal(arrs["labelTrainIds_invalid"], lab)
                        and conf.dtype == np.uint16 and conf.min() == 65535
                        and conf.max() == 65535):
                    fail(f"test submission {stream} {name}: labels "
                         f"{lab.dtype} max {lab.max()}, equal to the NEAREST"
                         f" whole-mode prediction: {np.array_equal(lab, want)}"
                         f", confidence {conf.dtype} {conf.min()}-"
                         f"{conf.max()}")
            sec = info["seconds"]
            timings[f"submission_{stream}_frame_ms"] = {
                k: v / TEST_FRAMES * 1e3 for k, v in sec.items()}
            print(f"test submission {stream}: 3 dirs x {TEST_FRAMES} "
                  "1920x1080 PNGs, labels equal to the whole-mode prediction"
                  " upsampled NEAREST, confidence all 65535; a frame: "
                  + ", ".join(f"{k} {v / TEST_FRAMES * 1e3:.2f} ms"
                              for k, v in sec.items()), flush=True)

        # --- infer: two 1080x1920 PNGs, fusion ------------------------------
        pngs = [os.path.join(root, "rgb_anon", "val", "night", "seq01",
                             os.path.basename(f)) for f in val.files[:2]]
        out_dir = os.path.join(tmp, "infer")
        preds = counted("infer", lambda: infer_cli.main(
            pngs + ["--config", "cs2dz", "--checkpoint", ckpt,
                    "--output-type", "fusion", "--out-dir", out_dir,
                    "--device", "cuda"]),
            {"fused_resize_argmax": 2, "batched_isr": 2})
        for path in pngs:
            stem = os.path.splitext(os.path.basename(path))[0]
            with Image.open(os.path.join(out_dir, f"{stem}_pred.png")) as im:
                png = np.asarray(im)
            if not (png.shape == TEST_FRAME and png.max() < 19
                    and np.array_equal(png, preds[path])):
                fail(f"test infer {stem}: {png.shape} max {png.max()}")
        print("test infer: two 1080x1920 predictions written", flush=True)

        # --- times ----------------------------------------------------------
        x = frame(val, 0)
        img, isr = x[..., :3].contiguous(), x[..., 3:].contiguous()
        for stream in ("image", "fusion"):
            def whole_fn():
                with torch.no_grad():
                    return predict_labels(select_logits(
                        seg.model, img, isr, stream), TEST_SIZE)
            timings[f"whole_{stream}_ms"] = wall_ms(whole_fn)
        timings["slide_540x960_ms"] = wall_ms(
            lambda: slide(x).argmax(-1), warmup=1, reps=TEST_TIMED_REPS)
        big = DarkZurichDataset(root, split="val", image_resize_size=(1920,
                                                                      1080),
                                isr_params=cfg.data.target_isr)
        xb = frame(big, 0)
        timings["slide_1080x1920_ms"] = wall_ms(
            lambda: slide(xb).argmax(-1), warmup=1, reps=TEST_TIMED_REPS)
        del xb

        def aug():
            from cmda_tpu_torch.models.segmentor import (
                multi_scale_flip_inference)
            with torch.no_grad():
                return multi_scale_flip_inference(
                    crop_logits, x, scales=TTA_SCALES, flip=True).argmax(-1)
        timings["aug_test_540x960_ms"] = wall_ms(aug, warmup=1,
                                                 reps=TEST_TIMED_REPS)
        timings["infer_1080x1920_ms"] = wall_ms(
            lambda: inference_segmentor(seg, pngs[0]), warmup=1,
            reps=TEST_TIMED_REPS)
        del seg
    timings["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    timings["phase_s"] = time.perf_counter() - t_phase
    smi = smi_line()
    for k in ("whole_image_ms", "whole_fusion_ms", "slide_540x960_ms",
              "slide_1080x1920_ms", "aug_test_540x960_ms",
              "infer_1080x1920_ms"):
        print(f"test timing {k}: {timings[k]:.2f} ms a frame ({smi})",
              flush=True)
    for stream in ("image", "fusion"):
        t = timings[f"submission_{stream}_frame_ms"]
        print(f"test timing submission {stream}: {t['model']:.2f} ms device"
              f" (to the labels on the host), {t['png']:.2f} ms host PNGs, "
              f"{t['load']:.2f} ms loading, a frame ({smi})", flush=True)
    print(f"test: peak {timings['peak_gib']:.2f} GiB, phase "
          f"{timings['phase_s']:.1f} s, launches {totals} ({smi})",
          flush=True)
    if min(totals["fused_resize_argmax"], totals["batched_isr"]) == 0:
        fail(f"test: a kernel of the test path never launched: {totals}")
    print("test timings " + json.dumps(timings), flush=True)
    return totals


# the cs2dz recipe on corpus files written here at the real frame sizes:
# Cityscapes' 2048x1024 frames (with IC1 PNGs, labels and the Rare Class
# Sampling JSONs) and DarkZurich's 1920x1080 train and val frames, cut to 8
# and 4 + 4 frames. The DSEC-Night part (events.h5) needs h5py, which the
# card's machine lacks; it is held on the CPU (tests/test_torch_data.py).
REAL_CS_FRAMES = 8
REAL_CS_SIZE = (2048, 1024)
REAL_DZ_FRAMES = 4
REAL_DZ_SIZE = (1920, 1080)
REAL_ITERS = 4
REAL_PROFILED = (2, 3, 4)
REAL_EVAL_LAUNCHES = {"fused_resize_ce": 0, "fused_resize_ce_dx": 0,
                      "fused_resize_ce_dweight": 0,
                      "fused_resize_argmax": REAL_DZ_FRAMES, "batched_isr": 0}


def _tree_bytes(root):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def _median_ms(fn, reps=2):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _real_host_ms(args, cfg):
    """The host parts of a real cs2dz iteration's loader work on one
    thread, on the corpus of ``args`` (medians of 5, ms): a Cityscapes
    frame's PNG decode and resize to 1024x512 (image, IC1, label), the host
    ISR of a 512x512 crop, a DarkZurich frame's decode and resize to
    960x540 and its ISR, one source and one target sample, one RCS pair,
    collate of a batch and ``encode_wire`` of it."""
    import random
    from PIL import Image
    from cmda_tpu_torch.data.host_isr import host_image_change, open_rgb
    from cmda_tpu_torch.data.loader import collate
    from cmda_tpu_torch.data.wire import encode_wire
    from cmda_tpu_torch.tools import train as cli
    pairs, _ = cli.build_datasets(cfg, args)
    src, tgt = pairs.source, pairs.target
    path, dz_path = src.files[0], tgt.files[0]
    isr_kw = src.isr_kw
    crop = open_rgb(path).resize(src.resize, Image.BILINEAR).crop(
        (0, 0) + src.crop)
    dz = open_rgb(dz_path).resize(tgt.resize, Image.BILINEAR)
    rng = random.Random(0)
    samples = [pairs.load(i, rng=rng) for i in range(cfg.data.batch_size)]
    batch = collate(samples)
    return {
        "cityscapes_png_decode_resize_ms": _median_ms(lambda: open_rgb(
            path).resize(src.resize, Image.BILINEAR)),
        "cityscapes_ic1_decode_resize_ms": _median_ms(lambda: src._load_ic(
            path)),
        "cityscapes_label_decode_resize_ms": _median_ms(lambda: Image.open(
            src._label_path(path)).resize(src.resize, Image.NEAREST)),
        "cityscapes_isr_512_ms": _median_ms(lambda: host_image_change(
            crop, shift_direction="rightdown", **isr_kw)),
        "dark_zurich_png_decode_resize_ms": _median_ms(lambda: open_rgb(
            dz_path).resize(tgt.resize, Image.BILINEAR)),
        "dark_zurich_isr_960x540_ms": _median_ms(lambda: host_image_change(
            dz, shift_direction="rightdown", **tgt.isr_kw)),
        "source_sample_ms": _median_ms(lambda: src.load(0, rng=rng)),
        "target_sample_ms": _median_ms(lambda: tgt.load(0, rng=rng)),
        "rcs_pair_ms": _median_ms(lambda: pairs.load(0, rng=rng)),
        "collate_ms": _median_ms(lambda: collate(samples)),
        "encode_wire_ms": _median_ms(lambda: encode_wire(batch)),
    }


def write_real_corpus(root):
    """Cityscapes (REAL_CS_FRAMES frames at REAL_CS_SIZE with IC1, labels
    and the RCS JSONs) and DarkZurich (REAL_DZ_FRAMES train + val frames at
    REAL_DZ_SIZE) under ``root`` by ``cmda_tpu_torch.tools.
    make_fake_corpus``: {"cs", "dz", "timings"}."""
    from cmda_tpu_torch.tools import make_fake_corpus as corpus
    timings = {}
    t0 = time.perf_counter()
    cs = corpus.fabricate_cityscapes(os.path.join(root, "cityscapes"),
                                     REAL_CS_FRAMES, REAL_CS_SIZE)
    timings["write_cityscapes_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dz = corpus.fabricate_dark_zurich(os.path.join(root, "dark_zurich"),
                                      REAL_DZ_FRAMES, REAL_DZ_SIZE,
                                      splits=("train", "val"))
    timings["write_dark_zurich_s"] = time.perf_counter() - t0
    timings["cityscapes_bytes"] = _tree_bytes(cs)
    timings["dark_zurich_bytes"] = _tree_bytes(dz)
    print(f"corpus: wrote Cityscapes ({REAL_CS_FRAMES} frames at "
          f"{REAL_CS_SIZE[0]}x{REAL_CS_SIZE[1]} with IC1, labels and the "
          f"RCS JSONs) {timings['cityscapes_bytes']} bytes in "
          f"{timings['write_cityscapes_s']:.2f} s, DarkZurich "
          f"({REAL_DZ_FRAMES} train + {REAL_DZ_FRAMES} val frames at "
          f"{REAL_DZ_SIZE[0]}x{REAL_DZ_SIZE[1]}) "
          f"{timings['dark_zurich_bytes']} bytes in "
          f"{timings['write_dark_zurich_s']:.2f} s", flush=True)
    return {"cs": cs, "dz": dz, "timings": timings}


def phase_real_corpus(corpus):
    """The cs2dz recipe on corpus files at the real frame sizes, written
    by ``write_real_corpus`` (``corpus``), through
    ``cmda_tpu_torch.tools.train.main --config cs2dz --source-root
    --target-root --rcs-json-dir`` on cuda (MiT-b5, 512x512, batch 2,
    float32, 4 loader threads): 4 iterations, a checkpoint and an
    evaluation of the 4 val frames at iteration 4, the launch counters set
    to 0 just before the run; every source sample of Rare Class Sampling
    drawn from a file that samples_with_class.json lists for the class
    drawn. Then the iteration time beside the bare step, data_time and
    its host parts, evaluation
    seconds a frame and the busy share of 3 profiled iterations. Returns
    the run's launches."""
    import collections
    import threading
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cmda_tpu_torch.data.cityscapes_ic import CityscapesICDataset
    from cmda_tpu_torch.data.uda import UDAPairDataset
    from cmda_tpu_torch.tools import train as cli
    from cmda_tpu_torch.train import loop as loop_mod
    from cmda_tpu_torch.uda.dacs import DACSTrainer
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    counters = _kernel_counters()
    tag = "real_cs2dz"
    timings = dict(corpus["timings"])
    cs, dz = corpus["cs"], corpus["dz"]
    launches = {"step": [], "eval": []}
    prof = {}
    split = {"queue": [], "encode": []}
    local = threading.local()
    picks = []     # (class drawn, file loaded), from the loader's threads

    class RecordingDict(dict):
        """samples_with_class: records the class of each RCS draw."""

        def get(self, c, default=None):
            local.c = c
            return super().get(c, default)

    real_init = UDAPairDataset.__init__

    def pair_init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        if self.rcs:
            self.samples_with_class = RecordingDict(self.samples_with_class)
            prof["pairs"] = self

    real_load = CityscapesICDataset.load

    def source_load(self, idx, crop_xy=None, flip=None, rng=None):
        picks.append((getattr(local, "c", None),
                      os.path.basename(self.files[idx])))
        return real_load(self, idx, crop_xy, flip, rng)

    def counted(kind, fn):
        def wrapper(*args, **kwargs):
            before = {k: f.launches for k, f in counters.items()}
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            launches[kind].append({k: f.launches - before[k]
                                   for k, f in counters.items()})
            return out
        return wrapper

    step_fn = counted("step", DACSTrainer.train_step)

    def train_step(trainer, state, batch, draws=None):
        if state.step == REAL_PROFILED[0] - 1:
            torch.cuda.synchronize()
            prof["p"] = profile(activities=[ProfilerActivity.CUDA])
            prof["p"].start()
            prof["t0"] = time.perf_counter()
        return step_fn(trainer, state, batch, draws)

    real_log = loop_mod.TrainLoop.log

    def log(loop, record):
        real_log(loop, record)
        if record.get("iter") == REAL_PROFILED[-1] and "loss" in record:
            torch.cuda.synchronize()
            prof["host_ms"] = (time.perf_counter() - prof["t0"]) * 1e3
            prof["p"].stop()

    eval_fn = counted("eval", loop_mod.evaluate_fusion)

    def evaluate_fusion(*args, **kwargs):
        t0 = time.perf_counter()
        out = eval_fn(*args, **kwargs)
        timings["eval_s"] = time.perf_counter() - t0
        return out

    def timed(kind, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            split[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    with tempfile.TemporaryDirectory() as tmp:
        work = os.path.join(tmp, "work")
        argv = ["--config", "cs2dz", "--source-root", cs, "--target-root",
                dz, "--rcs-json-dir", cs, "--max-iters", str(REAL_ITERS),
                "--num-workers", "4", "--seed", "0", "--work-dir", work,
                "--set", "log_interval=1",
                "--set", f"checkpoint_interval={REAL_ITERS}",
                "--set", f"eval_interval={REAL_ITERS}",
                "--set", "debug_img_interval=0", "--device", "cuda"]
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(UDAPairDataset, "__init__", pair_init), \
                mock.patch.object(CityscapesICDataset, "load", source_load), \
                mock.patch.object(DACSTrainer, "train_step", train_step), \
                mock.patch.object(loop_mod.TrainLoop, "log", log), \
                mock.patch.object(loop_mod, "evaluate_fusion",
                                  evaluate_fusion), \
                mock.patch.object(loop_mod.PrefetchLoader, "__next__", timed(
                    "queue", loop_mod.PrefetchLoader.__next__)), \
                mock.patch.object(loop_mod, "encode_wire", timed(
                    "encode", loop_mod.encode_wire)):
            loop = cli.main(argv)
        torch.cuda.synchronize()
        timings["run_s"] = time.perf_counter() - t0
        totals = {k: f.launches for k, f in counters.items()}
        n_picks = len(picks)

        # --- what the run wrote -----------------------------------------
        with open(loop.log_path) as f:
            records = [json.loads(line) for line in f]
        steps = [r for r in records if "loss" in r]
        if [r["iter"] for r in steps] != list(range(1, REAL_ITERS + 1)):
            fail(f"{tag}: step records {[r['iter'] for r in steps]}")
        bad = [(r["iter"], k) for r in steps for k, v in r.items()
               if not math.isfinite(v)]
        if bad:
            fail(f"{tag}: log values not finite: {bad}")
        files = sorted(os.listdir(work))
        evals = [r["eval"] for r in records if "eval" in r]
        if (f"iter_{REAL_ITERS}.pth" not in files or len(evals) != 1
                or not math.isfinite(evals[0]["mIoU"])):
            fail(f"{tag}: the run wrote {files}, evaluations {evals}")
        panels = [f for f in files if f.startswith("test_results_")]
        if len(panels) != 1 or len(os.listdir(os.path.join(
                work, panels[0]))) != REAL_DZ_FRAMES:
            fail(f"{tag}: evaluation panels {panels}")

        # --- launches ---------------------------------------------------
        per_step = step_launches(loop.trainer)
        expect = {k: REAL_ITERS * per_step[k] + REAL_EVAL_LAUNCHES[k]
                  for k in totals}
        if (launches["step"] != [per_step] * REAL_ITERS
                or launches["eval"] != [REAL_EVAL_LAUNCHES]
                or totals != expect):
            fail(f"{tag}: launches {totals} (per step {launches['step']}, "
                 f"evaluation {launches['eval']}), expected {expect}")

        # --- Rare Class Sampling ------------------------------------------
        pairs = prof["pairs"]
        wrong = [(c, f) for c, f in picks[:n_picks]
                 if c is None or f not in {
                     os.path.basename(n) for n, _ in
                     dict.get(pairs.samples_with_class, c, [])}]
        if not picks or wrong:
            fail(f"{tag}: {len(wrong)} of {len(picks)} source loads outside "
                 f"samples_with_class.json: {wrong[:5]}")
        drawn = collections.Counter(c for c, _ in picks[:n_picks])
        print(f"{tag}: {REAL_ITERS} iterations through tools.train.main on "
              f"the corpus files in {timings['run_s']:.1f} s; launches "
              f"{totals} (per step {per_step}, evaluation of "
              f"{REAL_DZ_FRAMES} val frames argmax {REAL_DZ_FRAMES}); final "
              f"loss {steps[-1]['loss']:.5f}; mIoU {evals[0]['mIoU']:.5f}; "
              f"RCS: {n_picks} source loads by the loader's threads (the "
              f"queues run ahead of the steps; a draw reloads its file up to "
              f"10 times for a crop that keeps the class), each from a file "
              f"samples_with_class.json lists for the class drawn; loads by "
              f"class drawn {dict(sorted(drawn.items()))}", flush=True)
        host = _real_host_ms(cli.parse_args(argv), loop.cfg)
        del loop

    iter_ms = {r["iter"]: r["time"] * 1e3 for r in steps}
    data_ms = {r["iter"]: r["data_time"] * 1e3 for r in steps}
    busy_ms, n_events = _busy_ms(prof["p"])
    steady = statistics.median(iter_ms[i] for i in REAL_PROFILED)
    bare = STEP_MS_MEDIAN.get("train_cs2dz")
    timings.update({
        "iter_ms": iter_ms, "iter_ms_median_steady": steady,
        "bare_step_ms_median": bare,
        "data_ms": data_ms,
        "data_ms_median_after_first": statistics.median(
            data_ms[i] for i in range(2, REAL_ITERS + 1)),
        "queue_ms": split["queue"][:REAL_ITERS + 1],
        "encode_ms": split["encode"][:REAL_ITERS + 1],
        "eval_s_per_frame": timings["eval_s"] / REAL_DZ_FRAMES,
        "profiled_ms": prof["host_ms"], "profiled_busy_ms": busy_ms,
        "profiled_events": n_events, "rcs_loads_by_class": dict(drawn),
        "host_ms": host, "phase_s": time.perf_counter() - t_phase})
    smi = smi_line()
    print(f"{tag}: iteration ms " + ", ".join(
        f"{i} {t:.2f}" for i, t in iter_ms.items())
        + f"; steady median (iterations {REAL_PROFILED}, profiled) "
        f"{steady:.2f} ms, the bare cs2dz step {bare:.2f} ms "
        f"({100 * (steady / bare - 1):+.1f}%) ({smi})", flush=True)
    print(f"{tag}: data_time ms " + ", ".join(
        f"{i} {t:.3f}" for i, t in data_ms.items())
        + f"; median after the first "
        f"{timings['data_ms_median_after_first']:.3f}; in the loop: the "
        "loader queue " + ", ".join(f"{t:.2f}" for t in timings["queue_ms"])
        + " ms, encode_wire " + ", ".join(
            f"{t:.2f}" for t in timings["encode_ms"]) + " ms; host parts on "
        "one thread outside the loop: " + ", ".join(
            f"{k} {v:.2f}" for k, v in host.items()) + f" ({smi})",
        flush=True)
    print(f"{tag}: evaluation of {REAL_DZ_FRAMES} DarkZurich val frames "
          f"(1920x1080 decoded, 540x960 scored) {timings['eval_s']:.2f} s, "
          f"{timings['eval_s_per_frame']:.3f} s a frame ({smi})", flush=True)
    print(f"{tag}: profiled iterations {REAL_PROFILED}: " + (
        f"{prof['host_ms']:.2f} ms host, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / prof['host_ms']:.1f}%) over {n_events} device "
        "events" if busy_ms is not None else
        f"{prof['host_ms']:.2f} ms host, device busy not measured (the trace "
        "holds no device event)") + f"; phase {timings['phase_s']:.1f} s "
        f"({smi})", flush=True)
    print(f"{tag} timings " + json.dumps(timings), flush=True)
    return totals


# the ISR ablation path (phase_isr_options) on the corpus files: run 1 the
# source options and the 3-channel, noised mixed ISR, run 2 the
# high-resolution source ISR (and the sky splice, which needs a one-channel
# ISR) with the ISRs ClassMix-ed and jittered; lens-flare PNGs at the size
# of Flare7K's scattering flares and gray sky-noise textures, written here;
# run 1 took 3 iterations until PR 12 (cut to keep the script inside its
# time with phase_train_types)
ISR_RUN_ITERS = (1, 1)
ISR_ALONE_STEPS = 1   # 3 until PR 12
ISR_FLARES, ISR_FLARE_SIZE = 4, (1440, 1440)
ISR_SKY_NOISE, ISR_SKY_NOISE_SIZE = 2, (1024, 512)
# C2: the cs2dz b5 step with the pseudo threshold at 0 (as
# tests/test_torch_train_variants.py sets it), so the pseudo weight is the
# confidence ratio 1 outside the cropped rows
PSEUDO_THRESHOLD = 0.0
# the DSEC host parts on one thread: a 500,000-event window into 5 bins at
# the event camera's 640x480, and a 640x440 frame's decode and ISR
DSEC_EVENTS, DSEC_BINS = 500_000, 5


def _write_isr_files(root):
    """ISR_FLARES lens-flare PNGs (a glow and a ring on black) and
    ISR_SKY_NOISE gray noise PNGs under ``root``: (flare dir, sky-noise
    dir)."""
    from PIL import Image
    g = np.random.default_rng(11)
    flares = os.path.join(root, "flares")
    noise = os.path.join(root, "sky_noise")
    os.makedirs(flares)
    os.makedirs(noise)
    w, h = ISR_FLARE_SIZE
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    for i in range(ISR_FLARES):
        cx, cy = g.uniform(0.3, 0.7) * w, g.uniform(0.3, 0.7) * h
        r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        glow = np.exp(-0.5 * (r / (w * g.uniform(0.03, 0.1))) ** 2)
        ring = np.exp(-0.5 * ((r - 0.2 * w) / (0.01 * w)) ** 2)
        rgb = (glow + 0.3 * ring)[..., None] * g.uniform(150, 255, 3)
        Image.fromarray(np.clip(rgb, 0, 255).astype(np.uint8)).save(
            os.path.join(flares, f"flare_{i:02d}.png"))
    nw, nh = ISR_SKY_NOISE_SIZE
    for i in range(ISR_SKY_NOISE):
        Image.fromarray(g.integers(0, 256, (nh, nw), np.uint8)).save(
            os.path.join(noise, f"noise_{i:02d}.png"))
    return flares, noise


def _run_counted(argv, iters):
    """``tools.train.main(argv)`` for ``iters`` iterations with the launch
    counters set to 0 just before it, its last iteration profiled from
    its step's start to its log record, as phase_real_corpus profiles
    its: (loop, launches of the run, launches of each step, seconds, step
    records, (the profiled iteration's host ms, its device-busy ms, its
    device events))."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cmda_tpu_torch.tools import train as cli
    from cmda_tpu_torch.train import loop as loop_mod
    from cmda_tpu_torch.uda.dacs import DACSTrainer
    counters = _kernel_counters()
    per_step, prof = [], {}
    real_step, real_log = DACSTrainer.train_step, loop_mod.TrainLoop.log

    def train_step(trainer, state, batch, draws=None):
        if state.step == iters - 1:
            torch.cuda.synchronize()
            prof["p"] = profile(activities=[ProfilerActivity.CUDA])
            prof["p"].start()
            prof["t0"] = time.perf_counter()
        before = {k: f.launches for k, f in counters.items()}
        out = real_step(trainer, state, batch, draws)
        torch.cuda.synchronize()
        per_step.append({k: f.launches - before[k]
                         for k, f in counters.items()})
        return out

    def log(loop, record):
        real_log(loop, record)
        if record.get("iter") == iters and "loss" in record:
            torch.cuda.synchronize()
            prof["host_ms"] = (time.perf_counter() - prof["t0"]) * 1e3
            prof["p"].stop()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(DACSTrainer, "train_step", train_step), \
            mock.patch.object(loop_mod.TrainLoop, "log", log):
        loop = cli.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    totals = {k: f.launches for k, f in counters.items()}
    with open(loop.log_path) as f:
        steps = [r for r in map(json.loads, f) if "loss" in r]
    if "host_ms" not in prof:
        fail(f"the run of {iters} iterations profiled no iteration")
    return (loop, totals, per_step, run_s, steps,
            (prof["host_ms"],) + _busy_ms(prof["p"]))


def _twin_step(cfg, batch, tag, timed_steps=0, state=None, coin=None,
               measure=False, profile=True):
    """One MiT-b5 step of ``cfg`` on ``batch`` through the kernels
    (launches counted and checked), and the same step from copies of the
    state with the same draws through their plain versions on the card,
    all three with cuDNN's deterministic algorithms:
    (a) the CE and argmax plain, the ISR kernel kept: losses to
    TRAIN_LOSS_RTOL, AdamW's first moments to TRAIN_KERNEL_MOMENT_RTOL of
    the largest, as the micro step's check; (b) the ISR kernel against its
    plain version on the grays the kernel step gave it, to ISR_TOL; (c)
    all three plain: losses to TRAIN_LOSS_RTOL, moments to
    TRAIN_MOMENT_RTOL, the card-vs-CPU tolerance of two steps whose
    inputs round differently. The two ISRs differ by up to ISR_TOL; on an
    H100 80GB HBM3 the ISR alone moved a cs2dz b5 step's moments by
    3.9e-5 of the largest, the CE and argmax together by 2.1e-7, and the
    largest differences sit in the events encoder's first patch
    embedding (its projection's bias, whose moment is the model's
    largest, and the LayerNorm after it): a 7x7 patch of the ISR's dead
    zone is a token of exact zeros, which that LayerNorm and the next
    scale up by ~1000 each (eps 1e-6), so the ISR's rounding there moves
    the whole step (measured: the kernel's dead zone at +-6e-8 against
    the plain version's 0 moved the split type's moments by 92% of the
    largest on dark DarkZurich frames, before the kernel's normalisation
    divided as the reference does). The teacher's pseudo weights within
    ARGMAX_TOL in all three (each
    pseudo-label call of a step against the same call of the others; d2n's
    pseudo weight, plain torch in all three, by its logged mean). Then
    ``timed_steps`` more kernel steps on ``batch`` alone, with no loader
    running, with ``measure`` the last of them with its CUDA-event sections
    and, with ``profile``, one profiled step. The steps start from ``state`` (stepped in place), or
    from ``init_state(seed=0)``; ``coin`` forces every step's events-vs-ISR
    coin. Returns (logs, the kernel step's pseudo weight [B, H, W],
    launches, {check: largest error}, {"step_ms": the timed steps' ms, the
    peak GiB over them, and with ``measure`` "sections", "memory",
    "start_gib", "profiled": (host ms, busy ms, device events, the port's
    kernels)})."""
    import copy
    import torch
    from cmda_tpu_torch.ops.isr_kernel import batched_isr_plain
    from cmda_tpu_torch.uda import dacs
    trainer = dacs.DACSTrainer(cfg, device="cuda")
    if state is None:
        state = trainer.init_state(seed=0)
    twins = {"ce_argmax": copy.deepcopy(state), "all": copy.deepcopy(state)}
    b, h, w = batch["source"]["image"].shape[:3]

    def new_draws():
        d = trainer.new_draws(state, b, (h, w))
        if coin is not None:
            d.coin = torch.tensor(coin, device=d.coin.device)
        return d
    draws = new_draws()
    weights, grays = [], []
    real_pl, real_isr = dacs.pseudo_label_and_weight_coarse, dacs.batched_isr

    def pl(*args, **kwargs):
        label, weight = real_pl(*args, **kwargs)
        weights.append(weight)
        return label, weight

    def isr(gray, dirs, **kwargs):
        grays.append((gray.clone(), dirs.clone(), kwargs))
        return real_isr(gray, dirs, **kwargs)
    counters = _kernel_counters()
    errors, plain = {}, {}
    # deterministic cuDNN algorithms for the three steps: with the default
    # ones two runs of the kernel step itself differ by 8.8e-6 (flagship)
    # and 1.9e-5 (source_only) of the largest first moment, and by 1.4e-8
    # and 2.6e-8 with these (NVIDIA H100 80GB HBM3), so the kernels' own
    # effect shows above that
    with mock.patch.object(dacs, "pseudo_label_and_weight_coarse", pl), \
            _deterministic_cudnn():
        with mock.patch.object(dacs, "batched_isr", isr):
            logs, launches = _counted_step(trainer, state, batch, draws)
        for name, keep_isr in (("ce_argmax", True), ("all", False)):
            before = {k: fn.launches for k, fn in counters.items()}
            with _plain_versions(isr=not keep_isr):
                _, lg = trainer.train_step(twins[name], batch, draws)
            torch.cuda.synchronize()
            moved = [k for k, fn in counters.items()
                     if fn.launches != before[k]
                     and not (keep_isr and k == "batched_isr")]
            if moved:
                fail(f"{tag}: the plain-version step ({name}) launched "
                     f"{moved}")
            plain[name] = {k: float(v) for k, v in lg.items()}
    # the ISR first: the all-plain twin's moments follow from it
    errors["isr"] = 0.0
    for gray, dirs, kw in grays:
        got, ref = (real_isr(gray, dirs, **kw),
                    batched_isr_plain(gray, dirs, **kw))
        diff = (got - ref).abs()
        errors["isr"] = max(errors["isr"], float(diff.max()))
        print(f"{tag}: the ISR kernel on the step's grays vs its plain "
              f"version: max|d| {float(diff.max()):.3g}, pixels over 0 "
              f"{int((diff > 0).sum())}, zero in exactly one "
              f"{int(((got == 0) != (ref == 0)).sum())}, zero in both "
              f"{int(((got == 0) & (ref == 0)).sum())} of {diff.numel()}",
              flush=True)
        if not errors["isr"] <= ISR_TOL:
            fail(f"{tag}: the ISR kernel on the step's grays is "
                 f"{errors['isr']} from its plain version (shift "
                 f"{kw['shift_pixel']}), over {ISR_TOL}; "
                 f"{int((diff > ISR_TOL).sum())} pixels over")
    for name, rtol in (("ce_argmax", TRAIN_KERNEL_MOMENT_RTOL),
                       ("all", TRAIN_MOMENT_RTOL)):
        what = f"{tag}, kernels vs plain ({name}) on cuda"
        errors[f"loss_{name}"] = _check_logs(logs, plain[name], what)
        errors[f"moments_{name}"] = _check_moments(state, twins[name], rtol,
                                                   what)
    if weights:   # the same pseudo-label call of each of the three steps
        n = len(weights) // 3
        errors["pseudo_weight"] = max(
            float((weights[i] - weights[i + n * j]).abs().max())
            for i in range(n) for j in (1, 2))
    else:
        errors["pseudo_weight"] = max(abs(logs["pseudo_weight"]
                                          - p["pseudo_weight"])
                                      for p in plain.values())
    if not errors["pseudo_weight"] <= ARGMAX_TOL:
        fail(f"{tag}: the pseudo weights of the kernel and the plain steps "
             f"differ by {errors['pseudo_weight']}")
    del twins
    torch.cuda.reset_peak_memory_stats()
    timing = {"step_ms": []}
    # with ``measure`` the last timed step carries the section marks
    for _ in range(timed_steps - 1 if measure and timed_steps else
                   timed_steps):
        d = new_draws()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(state, batch, d)
        torch.cuda.synchronize()
        timing["step_ms"].append((time.perf_counter() - t0) * 1e3)
    timing["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if measure:
        d = new_draws()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (timing["sections"], timing["memory"],
         timing["start_gib"]) = _step_sections(trainer, state, batch, d)
        if timed_steps:
            timing["step_ms"].append((time.perf_counter() - t0) * 1e3)
        timing["peak_gib"] = max([timing["peak_gib"]] + [
            top for top, _ in timing["memory"].values()])
        if profile:
            timing["profiled"] = _device_busy(trainer, state, batch)
    return (logs, weights[0] if weights else None, launches, errors,
            timing)


def _profiled_summary(iters, profiled, bare=True):
    """The profiled iteration of a run, with ``bare`` beside the bare cs2dz
    step's profiled step (phase_train)."""
    host, busy, n = profiled
    bare_host, bare_busy = STEP_PROFILED.get("train_cs2dz", (None, None))

    def share(h, b):
        return (f"host {h:.2f} ms, device busy {b:.2f} ms "
                f"({100 * b / h:.1f}%)" if b is not None else
                f"host {h:.2f} ms, device busy not measured")
    text = (f"iteration {iters} profiled: {share(host, busy)} over {n} "
            "device events")
    if not bare:
        return text
    return text + "; the bare cs2dz step's: " + (
        share(bare_host, bare_busy) if bare_host is not None else "not run")


def _twin_summary(errors):
    return (f"kernels vs plain on cuda: CE and argmax plain, losses max "
            f"relative error {errors['loss_ce_argmax']:.3g} (tolerance "
            f"{TRAIN_LOSS_RTOL:g}), AdamW first moments within "
            f"{errors['moments_ce_argmax']:.3g} of the largest (tolerance "
            f"{TRAIN_KERNEL_MOMENT_RTOL:g}); the ISR on the step's grays "
            f"max|d| {errors['isr']:.3g} (tolerance {ISR_TOL:g}); all plain, "
            f"losses {errors['loss_all']:.3g}, first moments "
            f"{errors['moments_all']:.3g} (tolerance {TRAIN_MOMENT_RTOL:g}); "
            f"pseudo weights max|d| {errors['pseudo_weight']:.3g}")


def _isr_host_ms(cfg, cs, flares, noise):
    """The source options' host parts on one thread (medians of 5, ms): the
    high-resolution ISR of a raw REAL_CS_SIZE frame (the preset's source
    shift doubled), the three host ISRs of a 512x512 crop
    (``shift_3_channel``), the flare composite onto the crop, the sky
    splice of its ISR (with a noise PNG), ``isr_noise_np`` and
    ``cow_mask_np`` at 512x512, and one source sample of the cs2dsec
    preset without options."""
    import random
    from PIL import Image
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.data.cityscapes_ic import CityscapesICDataset
    from cmda_tpu_torch.data.host_isr import host_image_change, open_rgb
    from cmda_tpu_torch.data import source_augs as sa
    d = cfg.data
    plain = CityscapesICDataset(cs, isr_params=d.source_isr)
    path = plain.files[0]
    raw = open_rgb(path)
    box = (0, 0) + plain.crop
    crop = raw.resize(plain.resize, Image.BILINEAR).crop(box)
    label = np.asarray(Image.open(plain._label_path(path)).resize(
        plain.resize, Image.NEAREST).crop(box)).astype(np.int32)
    kw = plain.isr_kw
    isr = host_image_change(crop, shift_direction="rightdown", **kw)
    rng = random.Random(0)
    p = d.source_isr
    kw2 = dict(kw, shift_pixel=2 * p.shift_pixel)
    dsec = C.cs2dsec_image_events_b5().data
    dsec_src = CityscapesICDataset(cs, isr_params=dsec.source_isr)
    return {
        "high_resolution_isr_ms": _median_ms(lambda: host_image_change(
            raw, shift_direction="rightdown", **kw2)),
        "isr_3_channel_512_ms": _median_ms(lambda: [host_image_change(
            crop, shift_direction="rightdown", **_isr_kw(q))
            for q in d.source_isr_3]),
        "flare_composite_ms": _median_ms(lambda: sa.flare_transform_np(
            crop, flares, rng)),
        "sky_splice_ms": _median_ms(lambda: sa.sky_mask_transform_np(
            isr, label, rng, noise_dir=noise)),
        "isr_noise_np_ms": _median_ms(lambda: sa.isr_noise_np(isr, rng)),
        "cow_mask_np_ms": _median_ms(lambda: sa.cow_mask_np(isr.shape, rng)),
        "cs2dsec_source_sample_ms": _median_ms(lambda: dsec_src.load(
            0, rng=rng)),
    }


def _dsec_host_ms():
    """The DSEC-Night target's host parts on one thread that need no h5py
    (medians of 3, ms), on a window of DSEC_EVENTS events held in memory
    (times in [0, 1], rectified float coordinates, polarities 0/1, as
    ``DSECDataset._splat_grid`` hands them on): ``host_voxel_grid`` into
    DSEC_BINS bins at 640x480, ``host_events_norm`` of that grid with the
    window's clip (1.5), and a 640x480 PNG's decode and the host ISR of its
    640x440 crop."""
    import io as _io
    from PIL import Image
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.data.dsec import (DSECDataset, host_events_norm,
                                          host_voxel_grid)
    from cmda_tpu_torch.data.host_isr import host_image_change
    g = np.random.default_rng(3)
    n, w, h = DSEC_EVENTS, DSECDataset.WIDTH, DSECDataset.HEIGHT
    t = np.sort(g.uniform(0.0, 1.0, n)).astype(np.float32)
    t[0], t[-1] = 0.0, 1.0
    x = g.uniform(0, w - 1, n).astype(np.float32)
    y = g.uniform(0, h - 1, n).astype(np.float32)
    p = g.integers(0, 2, n).astype(np.float32)
    grid = host_voxel_grid(t, x, y, p, w, h, DSEC_BINS)
    buf = _io.BytesIO()
    Image.fromarray(g.integers(0, 256, (h, w, 3), np.uint8)).save(
        buf, format="PNG")
    png = buf.getvalue()
    frame = Image.open(_io.BytesIO(png)).convert("RGB").crop(
        (0, 0, w, DSECDataset.TEST_ROWS))
    kw = _isr_kw(C.cs2dsec_image_events_b5().data.target_isr)
    return {
        "voxel_grid_ms": _median_ms(lambda: host_voxel_grid(
            t, x, y, p, w, h, DSEC_BINS), reps=2),
        "events_norm_ms": _median_ms(lambda: host_events_norm(
            grid.copy(), 1.5), reps=2),
        "frame_png_decode_ms": _median_ms(lambda: Image.open(
            _io.BytesIO(png)).convert("RGB"), reps=2),
        "frame_isr_640x440_ms": _median_ms(lambda: host_image_change(
            frame, shift_direction="rightdown", **kw), reps=2),
    }


def phase_isr_options(corpus):
    """The ISR ablation path at MiT-b5, 512x512, batch 2, float32 on the
    corpus files (``corpus``), through ``cmda_tpu_torch.tools.train.main
    --config cs2dz``:
    run 1, ISR_RUN_ITERS[0] iterations with ``--shift_3_channel
    --cs_isr_noise --cs_cow_mask --random_flare --sky_mask
    --isr_noise_dacs_type noise+blur`` (the ISR kernel 3 a step, CE 6, dx
    6, argmax 3); run 2, ISR_RUN_ITERS[1] iterations with
    ``--high_resolution_isr --sky_mask --set
    uda.mixed_image_to_mixed_isr=false --isr_mix_aug`` (the ISR kernel 0 a
    step); the sky-noise PNGs through ``--set data.sky_noise_dir``; finite
    losses; each run's last iteration profiled (host ms against device-busy
    ms, beside the bare cs2dz step's). Then one step of run 1's config on
    a batch of its loader's samples held against its plain-version twin
    (``_twin_step``) and ISR_ALONE_STEPS more of its steps timed with no
    loader running, the source options' and the DSEC target's host parts
    on one thread. Returns the two runs' launches."""
    import random
    import torch
    from cmda_tpu_torch.data.loader import collate
    from cmda_tpu_torch.tools import train as cli
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag = "isr_options"
    cs, dz = corpus["cs"], corpus["dz"]
    smi = smi_line()
    results, timings = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        flares, noise = _write_isr_files(tmp)
        base = ["--config", "cs2dz", "--source-root", cs, "--target-root",
                dz, "--rcs-json-dir", cs, "--num-workers", "4", "--seed",
                "0", "--set", "log_interval=1",
                "--set", "checkpoint_interval=1000",
                "--set", "eval_interval=1000",
                "--set", "debug_img_interval=0", "--device", "cuda",
                "--sky_mask", "--set", f"data.sky_noise_dir={noise}"]
        runs = (
            ["--shift_3_channel", "--cs_isr_noise", "--cs_cow_mask",
             "--random_flare", flares, "--isr_noise_dacs_type",
             "noise+blur"],
            ["--high_resolution_isr", "--set",
             "uda.mixed_image_to_mixed_isr=false", "--isr_mix_aug"])
        for i, (flags, iters) in enumerate(zip(runs, ISR_RUN_ITERS)):
            argv = base + flags + ["--max-iters", str(iters), "--work-dir",
                                   os.path.join(tmp, f"work{i}")]
            loop, totals, per_step, run_s, steps, profiled = _run_counted(
                argv, iters)
            expect = step_launches(loop.trainer)
            want_isr = 3 if i == 0 else 0
            if (expect["batched_isr"] != want_isr
                    or per_step != [expect] * iters
                    or totals != {k: iters * v for k, v in expect.items()}):
                fail(f"{tag} run {i + 1}: launches {totals} (per step "
                     f"{per_step}), expected {expect} a step with ISR "
                     f"{want_isr}")
            if [r["iter"] for r in steps] != list(range(1, iters + 1)):
                fail(f"{tag} run {i + 1}: step records "
                     f"{[r['iter'] for r in steps]}")
            bad = [(r["iter"], k) for r in steps for k, v in r.items()
                   if not math.isfinite(v)]
            if bad:
                fail(f"{tag} run {i + 1}: log values not finite: {bad}")
            src = loop.dataset.source
            sample = src.load(0, rng=random.Random(0))["img_self_res"]
            print(f"{tag} run {i + 1}: {' '.join(flags)}: {iters} iterations "
                  f"in {run_s:.1f} s; launches {totals} ({expect} a step); "
                  f"losses " + ", ".join(f"{r['loss']:.5f}" for r in steps)
                  + "; iteration ms " + ", ".join(
                      f"{r['time'] * 1e3:.2f}" for r in steps)
                  + "; data_time ms " + ", ".join(
                      f"{r['data_time'] * 1e3:.2f}" for r in steps)
                  + f"; a source sample's ISR {sample.shape}, its channels "
                  f"{'differ' if np.ptp(sample, axis=-1).max() > 0 else 'equal'}"
                  f"; " + _profiled_summary(iters, profiled) + f" ({smi})",
                  flush=True)
            timings[f"run{i + 1}"] = {
                "iter_ms": [r["time"] * 1e3 for r in steps],
                "data_ms": [r["data_time"] * 1e3 for r in steps],
                "run_s": run_s, "profiled_host_ms": profiled[0],
                "profiled_busy_ms": profiled[1],
                "profiled_events": profiled[2]}
            results.append(totals)
            if i == 0:
                args = cli.parse_args(argv)
                cfg = loop.cfg
                pairs, _ = cli.build_datasets(cfg, args)
                rng = random.Random(1)
                batch = collate([pairs.load(j, rng=rng)
                                 for j in range(cfg.data.batch_size)])
            del loop
            gc.collect()
            torch.cuda.empty_cache()

        # --- one optioned step against its plain-version twin ------------
        logs, _, launches, errors, timing = _twin_step(
            cfg, batch, f"{tag} twin", timed_steps=ISR_ALONE_STEPS)
        alone = timing["step_ms"]
        print(f"{tag} twin: one b5 step of run 1's config on its loader's "
              f"batch, launches {launches}, loss {logs['loss']:.5f}; "
              + _twin_summary(errors), flush=True)
        print(f"{tag}: run 1's step alone, with no loader running, ms "
              + ", ".join(f"{t:.2f}" for t in alone) + f", median "
              f"{statistics.median(alone):.2f}; the bare cs2dz step's median "
              f"{STEP_MS_MEDIAN.get('train_cs2dz', float('nan')):.2f} ms "
              f"({smi})", flush=True)
        timings["twin_errors"] = errors
        timings["alone_step_ms"] = alone
        gc.collect()
        torch.cuda.empty_cache()
        timings["host_ms"] = _isr_host_ms(cfg, cs, flares, noise)
    timings["dsec_host_ms"] = dsec = _dsec_host_ms()
    src_ms = timings["host_ms"]["cs2dsec_source_sample_ms"]
    target_ms = (dsec["voxel_grid_ms"] + dsec["events_norm_ms"]
                 + dsec["frame_png_decode_ms"] + dsec["frame_isr_640x440_ms"])
    timings["cs2dsec_batch_host_s_without_h5"] = 2 * (src_ms + target_ms) / 1e3
    timings["phase_s"] = time.perf_counter() - t_phase
    print(f"{tag}: host parts on one thread (ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in timings["host_ms"].items()) + f" ({smi})",
        flush=True)
    print(f"{tag}: DSEC host parts on one thread (ms), {DSEC_EVENTS} events "
          f"into {DSEC_BINS} bins at 640x480: " + ", ".join(
              f"{k} {v:.2f}" for k, v in dsec.items())
          + f"; a cs2dsec batch of 2 on one worker, without the h5 slice "
          f"(no h5py here): {timings['cs2dsec_batch_host_s_without_h5']:.3f} "
          f"s ({smi})", flush=True)
    print(f"{tag} timings " + json.dumps(timings), flush=True)
    return results


def phase_pseudo_weight():
    """One cs2dz MiT-b5 step at 512x512 (synthetic batch 2) with
    ``uda.pseudo_threshold`` set to PSEUDO_THRESHOLD through
    ``apply_overrides``, held against its plain-version twin
    (``_twin_step``); the share of pixels with a non-zero pseudo weight
    must be above 0."""
    import torch
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.data.synthetic import (SyntheticSource,
                                               SyntheticTarget, uda_batch)
    gc.collect()
    torch.cuda.empty_cache()
    tag = "pseudo_weight"
    cfg = C.apply_overrides(C.cs2dz_image_rawisr_b5(),
                            [f"uda.pseudo_threshold={PSEUDO_THRESHOLD}"])
    w, h = cfg.data.crop_size
    batch = uda_batch(SyntheticSource(crop_size=(w, h), with_time_res=False),
                      SyntheticTarget(crop_size=(w, h), with_events=False),
                      [0, 1])
    logs, weight, launches, errors, _ = _twin_step(cfg, batch, tag)
    share = float((weight > 0).float().mean())
    print(f"{tag}: cs2dz b5 step, uda.pseudo_threshold {PSEUDO_THRESHOLD}, "
          f"launches {launches}; pixels with a non-zero pseudo weight "
          f"{share:.6f} (rows {cfg.uda.pseudo_weight_ignore_top} at the top "
          f"and {cfg.uda.pseudo_weight_ignore_bottom} at the bottom zeroed), "
          f"mean pseudo weight {logs['pseudo_weight']:.6f}, mix/loss_seg "
          f"{logs['mix/loss_seg']:.5f}; " + _twin_summary(errors)
          + f" ({smi_line()})", flush=True)
    if not share > 0:
        fail(f"{tag}: no pixel has a non-zero pseudo weight")


# the flagship recipe's UDA ablations at MiT-b5 (cs2dsec, 512x512, batch 2,
# float32), one step each against its plain-version twin, from one b5
# state: (tag, train type, UDA options, the coin forced: 0.9 an events
# coin, 0.1 an ISR coin, against random_choice_thres 0.5)
TOGETHER = "cs2dsec_image+events_together"
UDA_OPTION_STEPS = (
    ("isr_another_fusion_events", TOGETHER, {"isr_another_fusion": True},
     0.9),
    ("isr_another_fusion_isr", TOGETHER, {"isr_another_fusion": True}, 0.1),
    ("fuse_both_ice_and_e", TOGETHER, {"fuse_both_ice_and_e": True}, None),
    ("isr_no_fusion_events", "cs2dsec_image+events", {"isr_no_fusion": True},
     0.9),
    ("isr_no_fusion_isr", "cs2dsec_image+events", {"isr_no_fusion": True},
     0.1),
    ("source_only", TOGETHER, {"source_only": True}, None),
    ("without_events", TOGETHER, {"without_events": True}, None))
# the JAX package's step levers together on the flagship (with the fused
# resize), timed beside phase_train's flagship f32 step
UDA_LEVERS = {"stacked_stream_ce": True, "shift_type": "all"}
UDA_LEVER_STEPS = 1
# the coin's host read: the events-coin isr_another_fusion step (the
# default graph plus the read), beside phase_train's flagship step; few
# steps, to keep the script inside its time
UDA_COIN_READ_STEPS = 1
UDA_CLI_ITERS = 1


def phase_uda_options():
    """The UDA ablations and the step levers at full width (cs2dsec 512x512,
    batch 2, float32, synthetic, random weights from seed 0): each of
    UDA_OPTION_STEPS at CUT_BACKBONE's depth held against its plain-version
    twin (``_twin_step``) with its launches checked; at MiT-b5 the coin's
    host read timed;
    the levers (``uda.stacked_stream_ce``, ``model.head_batched_train``,
    ``uda.shift_type='all'`` and the fused resize) held the same way and
    timed (UDA_LEVER_STEPS steps, sections, peak and live GiB, one
    profiled step) beside the flagship step of phase_train; then
    ``tools.train.main --config cs2dsec --synthetic --fused-resize --set
    uda.isr_another_fusion=true`` at CUT_BACKBONE for UDA_CLI_ITERS
    iterations. Returns
    the launches of the optioned steps and the CLI run, and the levers'
    step's."""
    import copy
    import torch
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.data.synthetic import (SyntheticSource,
                                               SyntheticTarget, uda_batch)
    from cmda_tpu_torch.ops.resize import set_fused_int_upsample
    from cmda_tpu_torch.uda.dacs import DACSTrainer
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag, smi = "uda_options", smi_line()
    base = C.cs2dsec_image_events_b5()
    w, h = base.data.crop_size
    batch = uda_batch(SyntheticSource(crop_size=(w, h)),
                      SyntheticTarget(crop_size=(w, h)), [0, 1])
    t0 = time.perf_counter()
    cut = C.replace(base, model=C.replace(base.model, backbone=CUT_BACKBONE))
    state0 = DACSTrainer(cut, device="cuda").init_state(seed=0)
    torch.cuda.synchronize()
    print(f"{tag}: one {CUT_BACKBONE} state built in "
          f"{time.perf_counter() - t0:.1f} s for every optioned step",
          flush=True)
    totals = dict.fromkeys(TRAIN_COUNTED, 0)
    timings = {}

    def cfg_of(train_type, uda, at=base):
        return C.replace(at, model=C.replace(at.model,
                                             train_type=train_type),
                         uda=C.replace(at.uda, **uda))
    for name, train_type, uda, coin in UDA_OPTION_STEPS:
        cfg = cfg_of(train_type, uda, cut)
        logs, _, launches, errors, _ = _twin_step(
            cfg, batch, f"{tag} {name}", state=copy.deepcopy(state0),
            coin=coin)
        for k, v in launches.items():
            totals[k] += v
        want_events = {0.9: 1.0, 0.1: 0.0}.get(coin)
        if uda.get("without_events"):
            want_events = 0.0
        if want_events is not None and logs["use_events"] != want_events:
            fail(f"{tag} {name}: use_events {logs['use_events']}, expected "
                 f"{want_events}")
        if uda.get("source_only") and any(k.startswith("mix/") for k in logs):
            fail(f"{tag} {name}: a source_only step logged the mixed pass")
        print(f"{tag} {name}: {CUT_BACKBONE} {train_type} {uda} coin {coin}, "
              f"launches {launches}, loss {logs['loss']:.5f}, use_events "
              f"{logs['use_events']:.0f}; " + _twin_summary(errors)
              + f" ({smi})", flush=True)
        timings[name] = errors
        gc.collect()
        torch.cuda.empty_cache()

    # the coin's host read: the events-coin step with isr_another_fusion
    # runs the default graph plus the read; beside phase_train's flagship
    # step, at b5 from its seed, after one step untimed
    del state0
    gc.collect()
    torch.cuda.empty_cache()
    reads = []
    tr = DACSTrainer(cfg_of(TOGETHER, {"isr_another_fusion": True}),
                     device="cuda")
    st = tr.init_state(seed=0)
    for i in range(UDA_COIN_READ_STEPS + 1):
        d = tr.new_draws(st, 2, (h, w))
        d.coin = torch.tensor(0.9, device=d.coin.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(st, batch, d)
        torch.cuda.synchronize()
        if i:
            reads.append((time.perf_counter() - t0) * 1e3)
    del tr, st
    gc.collect()
    torch.cuda.empty_cache()
    timings["coin_read_ms"] = reads
    print(f"{tag}: the events-coin step with isr_another_fusion (one host "
          f"read of the coin) ms " + ", ".join(f"{t:.2f}" for t in reads)
          + f"; the flagship step's median (phase_train) "
          f"{STEP_MS_MEDIAN.get('train', float('nan')):.2f} ({smi})",
          flush=True)

    # the levers, with the fused resize
    cfg = C.replace(cfg_of(TOGETHER, UDA_LEVERS), model=C.replace(
        base.model, head_batched_train=True))
    set_fused_int_upsample(True)
    try:
        logs, _, levers, errors, timing = _twin_step(
            cfg, batch, f"{tag} levers", timed_steps=UDA_LEVER_STEPS,
            measure=True)
    finally:
        set_fused_int_upsample(False)
    host, busy, n_events, kernels = timing["profiled"]
    flagship = STEP_MS_MEDIAN.get("train", float("nan"))
    f_host, f_busy = STEP_PROFILED.get("train", (None, None))
    timings["levers"] = {**{k: v for k, v in timing.items()
                            if k != "profiled"},
                         "twin_errors": errors, "profiled_host_ms": host,
                         "profiled_busy_ms": busy,
                         "profiled_events": n_events,
                         "profiled_kernels": kernels}
    med = statistics.median(timing["step_ms"])
    print(f"{tag} levers: stacked_stream_ce, head_batched_train, "
          f"shift_type='all', fused resize: launches {levers}, loss "
          f"{logs['loss']:.5f}; " + _twin_summary(errors) + f"; step ms "
          + ", ".join(f"{t:.2f}" for t in timing["step_ms"])
          + f", median {med:.2f} against the flagship f32 step's "
          f"{flagship:.2f} ({100 * (med / flagship - 1):+.1f}%); peak "
          f"{timing['peak_gib']:.2f} GiB; profiled step host {host:.2f} ms, "
          + (f"busy {busy:.2f} ms ({100 * busy / host:.1f}%)"
             if busy is not None else "busy not measured")
          + (f", the flagship's host {f_host:.2f} ms, busy {f_busy:.2f} ms"
             if f_busy is not None else "") + f" ({smi})", flush=True)
    print(f"{tag} levers: step device ms " + ", ".join(
        f"{k} {v:.2f}" for k, v in timing["sections"].items())
        + f"; memory GiB, live at its start {timing['start_gib']:.2f}; per "
        "section peak / live at its end: " + ", ".join(
            f"{k} {p:.2f} / {lv:.2f}" for k, (p, lv)
            in timing["memory"].items()), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # through the train CLI
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--config", "cs2dsec", "--synthetic", "--max-iters",
                str(UDA_CLI_ITERS), "--fused-resize", "--set",
                "uda.isr_another_fusion=true", "--backbone", CUT_BACKBONE,
                "--num-workers", "2",
                "--seed", "0", "--set", "log_interval=1",
                "--set", "checkpoint_interval=1000",
                "--set", "eval_interval=1000",
                "--set", "debug_img_interval=0", "--work-dir", tmp]
        try:
            loop, cli, per_step, run_s, steps, profiled = _run_counted(
                argv, UDA_CLI_ITERS)
        finally:
            set_fused_int_upsample(False)
        expect = step_launches(loop.trainer)
        if (not loop.cfg.uda.isr_another_fusion
                or per_step != [expect] * UDA_CLI_ITERS):
            fail(f"{tag} cli: launches per step {per_step}, expected "
                 f"{expect}")
        bad = [(r["iter"], k) for r in steps for k, v in r.items()
               if not math.isfinite(v)]
        if bad or len(steps) != UDA_CLI_ITERS:
            fail(f"{tag} cli: records {steps}")
        print(f"{tag} cli: tools.train.main {' '.join(argv[:10])}: "
              f"{UDA_CLI_ITERS} iterations in {run_s:.1f} s, launches {cli}, "
              "losses " + ", ".join(f"{r['loss']:.5f}" for r in steps)
              + ", use_events " + ", ".join(
                  f"{r['use_events']:.0f}" for r in steps)
              + ", iteration ms " + ", ".join(
                  f"{r['time'] * 1e3:.2f}" for r in steps) + f" ({smi})",
              flush=True)
        del loop
    for k, v in cli.items():
        totals[k] += v
    timings["phase_s"] = time.perf_counter() - t_phase
    print(f"{tag} timings " + json.dumps(timings), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return totals, levers


# the DarkZurich ablation train types at MiT-b5 (the cs2dz preset, 512x512,
# batch 2, float32) with the JAX experiment grid's model settings (no
# fusion module; split classifiers for split and no-fusion, 2 events
# classes for no-fusion), one step each against its plain-version twin:
# (tag, train type, model settings, UDA options). One b5 state per model
# shape: no-fusion's two steps share one.
SPLIT, NO_FUSION, D2N = ("cs2dz_image+raw-isr_split",
                         "cs2dz_image+raw-isr_no-fusion",
                         "cs2dz_image+d2n-isr")
TYPES_MODEL = {SPLIT: {"split_cls": True},
               NO_FUSION: {"split_cls": True, "events_classes": 2},
               D2N: {}}
# the ImageNet feature distance's lambda (the DAFormer default)
TYPES_FDIST = 0.005
TYPES_STEPS = (
    ("split_deflare", SPLIT, {"deflare_aug": True}),
    ("nofusion_edge", NO_FUSION, {"isr_edge": True}),
    ("nofusion_cw_fdist", NO_FUSION,
     {"isr_edge": True, "isr_edge_class_weight": 0.9,
      "imnet_feature_dist_lambda": TYPES_FDIST}),
    ("d2n", D2N, {}))
TYPES_TIMED_STEPS = 1
TYPES_CLI_ITERS = 1
# the DarkZurich frames the phase writes: 2 train nights (and their
# deflared copies) and 2 days at 1920x1080, the days' transferred ISRs as
# 1920x540 side-by-side PNGs; the source labels in 64x64 squares, so the
# feature distance's 32x32 cells are mostly pure
TYPES_FRAMES, TYPES_LABEL_BLOCK = 2, 64


def _write_dz_pairs(root):
    """TYPES_FRAMES train night frames at 1920x1080 (dark class-keyed
    blocks with noise and a bright glow, a flare), the same frames without
    the glow under ``night_deflare``, TYPES_FRAMES day frames and their
    transferred-ISR PNGs (1920x540, the ISR in the right half)."""
    from PIL import Image
    g = np.random.default_rng(13)
    h, w = TEST_FRAME
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    palette = g.integers(5, 70, (19, 3))
    for i in range(TYPES_FRAMES):
        name = f"seq01_frame_{i:06d}_rgb_anon.png"
        blocks = g.integers(0, 19, (h // 120 + 1, w // 120 + 1))
        lbl = np.repeat(np.repeat(blocks, 120, 0), 120, 1)[:h, :w]
        base = palette[lbl] + g.integers(0, 12, (h, w, 3))
        r = np.hypot(xx - g.uniform(0.2, 0.8) * w, yy - g.uniform(0.2, 0.8) * h)
        glow = 180.0 * np.exp(-0.5 * (r / 150.0) ** 2)[..., None]
        for sub, img in (("night", base + glow), ("night_deflare", base)):
            d = os.path.join(root, "rgb_anon", "train", sub, "seq01")
            os.makedirs(d, exist_ok=True)
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(d, name))
        d = os.path.join(root, "rgb_anon", "train", "day", "seq02")
        os.makedirs(d, exist_ok=True)
        day = 4 * palette[lbl[:, ::-1]] + g.integers(0, 20, (h, w, 3))
        Image.fromarray(np.clip(day, 0, 255).astype(np.uint8)).save(
            os.path.join(d, name))
        d = os.path.join(root, "rgb_anon", "train", "day_t_isr", "seq02")
        os.makedirs(d, exist_ok=True)
        t_isr = np.concatenate([day[::2, ::2, 0], 127 + 8 * np.sign(
            np.diff(day[::2, ::2, 0], axis=1, prepend=0))], axis=1)
        Image.fromarray(np.clip(t_isr, 0, 255).astype(np.uint8)).save(
            os.path.join(d, name))


def _types_batch(cfg, root):
    """The phase's batch: 2 synthetic Cityscapes-IC samples with their
    labels in TYPES_LABEL_BLOCK squares of random classes, and 2 DarkZurich
    train samples of ``root`` with the deflared pair and the day pair
    (``DarkZurichDataset(with_day_pair=True)``), crops from a seeded
    ``random.Random``."""
    import random
    from cmda_tpu_torch.data.dark_zurich import DarkZurichDataset
    from cmda_tpu_torch.data.loader import collate
    from cmda_tpu_torch.data.synthetic import SyntheticSource
    d = cfg.data
    w, h = d.crop_size
    src = [SyntheticSource(crop_size=(w, h), with_time_res=False)[i]
           for i in range(2)]
    g = np.random.default_rng(7)
    k = TYPES_LABEL_BLOCK
    for s in src:
        s["label"] = np.repeat(np.repeat(g.integers(
            0, 19, (h // k, w // k)), k, 0), k, 1).astype(np.int32)
    tgt = DarkZurichDataset(root, split="train", isr_params=d.target_isr,
                            image_crop_size=d.crop_size,
                            shift_type=d.shift_type, with_day_pair=True,
                            outputs=("image", "isr", "image_deflare",
                                     "isr_deflare"))
    rng = random.Random(0)
    samples = [tgt.load(i, rng) for i in range(2)]
    want = {"image", "isr", "image_deflare", "isr_deflare", "day_image",
            "day_isr"}
    if any(set(x) != want for x in samples):
        fail(f"train_types: DarkZurich samples hold "
             f"{[sorted(x) for x in samples]}, expected {sorted(want)}")
    return {"source": collate(src), "target": collate(samples)}


def phase_train_types():
    """The DACS trainer's DarkZurich ablations at full width and
    CUT_BACKBONE's depth (cs2dz 512x512, batch 2, float32, random weights
    from seed 0, the JAX grid's model settings): each of TYPES_STEPS from
    its model shape's state against its plain-version twin
    (``_twin_step``, launches checked, then TYPES_TIMED_STEPS timed steps
    and one step's CUDA-event sections), on a batch of synthetic source
    samples and DarkZurich frames this phase writes (deflared and day
    pairs); the feature distance's frozen ``EncoderDecoder`` loads a seeded
    MiT it saves as an NVlabs-keyed ``.pth``. Then ``tools.train.main
    --config cs2dz --synthetic --backbone CUT_BACKBONE`` as the no-fusion
    type with ``--isr_edge 1 --feature_dist --imnet`` for TYPES_CLI_ITERS
    iterations and one evaluation (the fusion-less model's image stream).
    Returns the launches of the counted steps and the CLI run."""
    import copy
    import torch
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.models.common import init_weights
    from cmda_tpu_torch.models.mit import MIT_VARIANTS, MixVisionTransformer
    from cmda_tpu_torch.uda.dacs import DACSTrainer
    from cmda_tpu_torch.utils.weights import load_torch_file
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag, smi = "train_types", smi_line()
    base = C.cs2dz_image_rawisr_b5()
    base = C.replace(base, model=C.replace(base.model, backbone=CUT_BACKBONE))
    totals = dict.fromkeys(TRAIN_COUNTED, 0)
    timings = {}

    def cfg_of(train_type, uda):
        model = C.replace(base.model, train_type=train_type, fusion="",
                          fusion_isr="", **TYPES_MODEL[train_type])
        return C.replace(base, model=model, uda=C.replace(base.uda, **uda))
    with tempfile.TemporaryDirectory(prefix="dz_") as root:
        if "day" in root or "night" in root:
            fail(f"{tag}: the temporary directory {root} holds 'day' or "
                 "'night', which DarkZurich's path rules replace")
        t0 = time.perf_counter()
        _write_dz_pairs(root)
        mit = MixVisionTransformer(MIT_VARIANTS[base.model.backbone]).to(
            "cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(3)
        init_weights(mit, gen)
        imnet_pth = os.path.join(root, f"{CUT_BACKBONE}_seeded.pth")
        torch.save(mit.state_dict(), imnet_pth)
        del mit
        batch = _types_batch(base, root)
        timings["setup_s"] = time.perf_counter() - t0
        print(f"{tag}: DarkZurich frames, deflared and day pairs written, "
              f"a seeded {CUT_BACKBONE} saved "
              f"({os.path.getsize(imnet_pth)} bytes) "
              f"and the batch loaded in {timings['setup_s']:.1f} s",
              flush=True)
        states = {}
        for name, train_type, uda in TYPES_STEPS:
            cfg = cfg_of(train_type, uda)
            if train_type not in states:
                t0 = time.perf_counter()
                states.clear()
                gc.collect()
                torch.cuda.empty_cache()
                fd = dict(uda, imnet_feature_dist_lambda=TYPES_FDIST)
                # no-fusion's state carries the frozen encoder for both
                # of its steps (the one without the distance leaves it)
                states[train_type] = DACSTrainer(
                    cfg_of(train_type, fd), device="cuda").init_state(
                    seed=0, imnet_state_dict=load_torch_file(imnet_pth)
                    if train_type == NO_FUSION else None)
                print(f"{tag}: one {CUT_BACKBONE} {train_type} state built in "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
            logs, _, launches, errors, timing = _twin_step(
                cfg, batch, f"{tag} {name}", timed_steps=TYPES_TIMED_STEPS,
                state=copy.deepcopy(states[train_type]), measure=True,
                profile=False)
            for k, v in launches.items():
                totals[k] += v
            for key in ("mix/loss_feat_consis", "src/loss_imnet_feat_dist"):
                want = bool(key.startswith("mix") and train_type == NO_FUSION
                            or key.startswith("src")
                            and uda.get("imnet_feature_dist_lambda"))
                if want != (key in logs) or want and not logs[key] > 0:
                    fail(f"{tag} {name}: {key} {logs.get(key)}")
            med = statistics.median(timing["step_ms"])
            timings[name] = {**timing, "twin_errors": errors,
                             "launches": launches, "logs": logs}
            print(f"{tag} {name}: {CUT_BACKBONE} {train_type} "
                  f"{TYPES_MODEL[train_type]} {uda}, launches {launches}, "
                  f"loss {logs['loss']:.5f}; " + _twin_summary(errors)
                  + "; step ms " + ", ".join(
                      f"{t:.2f}" for t in timing["step_ms"])
                  + f", median {med:.2f}; peak "
                  f"{timing['peak_gib']:.2f} GiB ({smi})", flush=True)
            print(f"{tag} {name}: step device ms "
                  + ", ".join(f"{k} {v:.2f}"
                              for k, v in timing["sections"].items())
                  + f"; memory GiB, live at its start "
                  f"{timing['start_gib']:.2f}; per section peak / live at "
                  "its end: " + ", ".join(
                      f"{k} {p:.2f} / {lv:.2f}" for k, (p, lv)
                      in timing["memory"].items()), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
        states.clear()
        gc.collect()
        torch.cuda.empty_cache()

        # through the train CLI: no-fusion with edge labels and the
        # feature distance, one evaluation of the synthetic val set
        with tempfile.TemporaryDirectory() as work:
            argv = ["--config", "cs2dz", "--synthetic", "--max-iters",
                    str(TYPES_CLI_ITERS), "--set",
                    f"model.train_type={NO_FUSION}", "--set", "model.fusion=",
                    "--set", "model.fusion_isr=", "--set",
                    "model.split_cls=true", "--set", "model.events_classes=2",
                    "--isr_edge", "1", "--feature_dist", str(TYPES_FDIST),
                    "--imnet", imnet_pth, "--backbone", CUT_BACKBONE,
                    "--num-workers", "2", "--seed",
                    "0", "--set", "log_interval=1",
                    "--set", "checkpoint_interval=1000",
                    "--set", f"eval_interval={TYPES_CLI_ITERS}",
                    "--set", "debug_img_interval=0", "--work-dir", work]
            loop, cli, per_step, run_s, steps, profiled = _run_counted(
                argv, TYPES_CLI_ITERS)
            expect = step_launches(loop.trainer)
            evals = {k: cli[k] - sum(p[k] for p in per_step) for k in cli}
            want_eval = {**dict.fromkeys(TRAIN_COUNTED, 0),
                         "fused_resize_argmax": LOOP_VAL}
            if (per_step != [expect] * TYPES_CLI_ITERS or evals != want_eval
                    or loop.state.imnet is None):
                fail(f"{tag} cli: launches per step {per_step}, expected "
                     f"{expect}; evaluation {evals}, expected {want_eval}")
            bad = [(r["iter"], k) for r in steps for k, v in r.items()
                   if not math.isfinite(v)]
            keys = {"mix/loss_feat_consis", "src/loss_imnet_feat_dist"}
            if (bad or len(steps) != TYPES_CLI_ITERS
                    or not keys <= set(steps[0])):
                fail(f"{tag} cli: records {steps}")
            with open(loop.log_path) as f:
                miou = [r["eval"]["mIoU"] for r in map(json.loads, f)
                        if "eval" in r]
            if len(miou) != 1 or not math.isfinite(miou[0]):
                fail(f"{tag} cli: evaluations {miou}")
            timings["cli"] = {"run_s": run_s, "launches": cli,
                              "eval_launches": evals, "miou": miou[0],
                              "iter_ms": [r["time"] * 1e3 for r in steps]}
            print(f"{tag} cli: tools.train.main {' '.join(argv[:22])}: "
                  f"{TYPES_CLI_ITERS} iterations and one evaluation of "
                  f"{LOOP_VAL} frames in {run_s:.1f} s, launches {cli} "
                  f"(evaluation {evals}), losses " + ", ".join(
                      f"{r['loss']:.5f}" for r in steps) + ", feature "
                  "distance " + ", ".join(
                      f"{r['src/loss_imnet_feat_dist']:.5f}" for r in steps)
                  + f", mIoU {miou[0]:.4f}, iteration ms " + ", ".join(
                      f"{r['time'] * 1e3:.2f}" for r in steps)
                  + "; " + _profiled_summary(TYPES_CLI_ITERS, profiled,
                                             bare=False) + f" "
                  f"({smi})", flush=True)
            del loop
    for k, v in cli.items():
        totals[k] += v
    timings["phase_s"] = time.perf_counter() - t_phase
    print(f"{tag}: launches {totals}; phase {timings['phase_s']:.1f} s "
          f"({smi})", flush=True)
    print(f"{tag} timings " + json.dumps(timings, default=float), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return totals


# the CycleGAN workflow and the image-only trainers (phase_image_trainers):
# the JAX CLI's defaults (1 channel, ngf 64, 9 blocks, ndf 64, a 3-layer
# PatchGAN, lsgan, pool 50, load 286, crop 256, batch 1) on 256 px crops of
# IMG_CG_FRAMES grayscale 2048x1024 PNGs per domain written on the spot,
# IMG_CG_STEPS CLI steps and IMG_CG_TIMED more timed; then the card against
# the CPU from the CLI's weights at pool 1 on IMG_CG_TWIN_CROP crops (the
# CPU's full-width step at 256 px takes about 25 s), fill then play back;
# then the EN tool on IMG_CG_FRAMES 2048x1024 IC frames. OrgDACS and
# DACSImage at MiT-b5, cs2dz 512x512, batch 2; the prototype functions at
# the b5 head's features.
IMG_CG_FRAMES = 2
IMG_CG_SIZE = (2048, 1024)
IMG_CG_STEPS = 4
IMG_CG_TIMED = 3
IMG_CG_TWIN_CROP = 128
IMG_CG_TWIN_STEPS = 2
IMG_CG_POOL_TOL = 1e-4        # the pools' fakes, tanh outputs in [-1, 1]
# the largest update of Adam(0.5, 0.999) at its first and second step, in
# units of lr: |m_hat| / sqrt(v_hat) is g / |g| at the first; at the second
# it peaks at 1.0540 lr (a second gradient about twice the first, same
# sign). A parameter whose gradient is noise (a conv bias before an
# instance norm has no gradient) may move either way on each device, so
# after a step from one state the twins' parameters are held to 2 lr times
# that step's largest update.
IMG_CG_ADAM_STEPS = (1.0, 1.0540)
IMG_ORG_STEPS = 3
IMG_DI_STEPS = 2
IMG_PROTO = dict(b=2, hw=128, dim=256, classes=19, memory=5000, freq=10,
                 n_view=32)
IMG_PROTO_TOL = 1e-5          # means, prototypes, queue rows (unit vectors)
IMG_PROTO_LOSS_RTOL = 1e-4
IMG_ORG_NAMES = {"cyclegan": "day2night", "ema": "ema_update",
                 "teacher": "teacher", "mix": "classmix", "forward":
                 "forward_src_mix", "backward": "backward", "optimizer":
                 "adamw"}


def _image_frames(root, n, size, seed):
    """``n`` grayscale frames of ``size`` (w, h) under ``root``: smooth
    waves of random periods with noise."""
    from PIL import Image
    g = np.random.default_rng(seed)
    w, h = size
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        img = (127.0 + 60.0 * np.sin(xx / g.uniform(20, 80))
               * np.cos(yy / g.uniform(20, 80))
               + g.normal(0.0, 12.0, (h, w)))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), mode="L").save(
            os.path.join(root, f"frame{i:02d}.png"))


def _params_apart(nets_a, nets_b):
    return max(float((p.detach().cpu() - q.detach().cpu()).abs().max())
               for a, b in zip(nets_a, nets_b)
               for p, q in zip(a.parameters(), b.parameters(), strict=True))


def _cyclegan_part(root, tag, smi, timings):
    """The crops tool, the CycleGAN CLI, its card-vs-CPU twin and the EN
    tool."""
    import copy
    import dataclasses
    import random
    import torch
    from PIL import Image
    from cmda_tpu_torch.data.unpaired import UnpairedFolderDataset
    from cmda_tpu_torch.tools import create_cityscapes_image_change as ic_tool
    from cmda_tpu_torch.tools import train_cyclegan
    from cmda_tpu_torch.uda import cyclegan_train as cg
    from cmda_tpu_torch.utils.weights import cyclegan_to_tree
    t0 = time.perf_counter()
    crops = {}
    for i, dom in enumerate("ab"):
        _image_frames(os.path.join(root, "frames", dom), IMG_CG_FRAMES,
                      IMG_CG_SIZE, seed=21 + i)
        crops[dom] = os.path.join(root, "crops", dom)
        with contextlib.redirect_stdout(io.StringIO()):
            ic_tool.main(["--mode", "crops", "--src",
                          os.path.join(root, "frames", dom), "--dst",
                          crops[dom], "--crop_size", "256"])
        names = sorted(os.listdir(crops[dom]))
        sizes = {Image.open(os.path.join(crops[dom], n)).size for n in names}
        if len(names) != 4 * IMG_CG_FRAMES or sizes != {(256, 256)}:
            fail(f"{tag}: crops of domain {dom}: {len(names)} at {sizes}")
    timings["cyclegan_data_s"] = time.perf_counter() - t0

    # the CLI at the JAX CLI's defaults
    work = os.path.join(root, "work")
    argv = ["--data-a", crops["a"], "--data-b", crops["b"], "--work-dir",
            work, "--steps", str(IMG_CG_STEPS), "--log-interval", "1",
            "--sample-interval", "2", "--save-interval", str(IMG_CG_STEPS),
            "--num-workers", "2", "--seed", "0"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        trainer, state = train_cyclegan.main(argv)
    torch.cuda.synchronize()
    timings["cyclegan_cli_s"] = time.perf_counter() - t0
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    with open(os.path.join(work, "cyclegan.log.json")) as f:
        recs = [json.loads(line) for line in f]
    bad = [(r["iter"], k) for r in recs for k, v in r.items()
           if not math.isfinite(v)]
    if (last.get("done") is not True or len(recs) != IMG_CG_STEPS or bad
            or not os.path.exists(os.path.join(work, "sample_000004.png"))):
        fail(f"{tag}: the CycleGAN CLI: {last}, records {recs}")
    start = trainer.init_state(0, (256, 256))
    moved = {n: sum(int(not torch.equal(p, q)) for p, q in zip(
        getattr(state, n).parameters(), getattr(start, n).parameters()))
        for n in ("g_a", "g_b", "d_a", "d_b")}
    if not all(moved.values()):
        fail(f"{tag}: the CycleGAN CLI moved no parameter of some nets: "
             f"{moved}")
    npz = last["checkpoint"]
    want = cyclegan_to_tree(state.g_a.state_dict())
    got = cg.load_generator_npz(npz, "g_a")
    flat_w, flat_g = {}, {}
    for tree, flat in ((want, flat_w), (got, flat_g)):
        stack = [("", tree)]
        while stack:
            pre, node = stack.pop()
            for k, v in node.items():
                if isinstance(v, dict):
                    stack.append((f"{pre}{k}/", v))
                else:
                    flat[pre + k] = np.asarray(v)
    if flat_w.keys() != flat_g.keys() or not all(
            np.array_equal(flat_w[k], flat_g[k]) for k in flat_w):
        fail(f"{tag}: the npz's g_a differs from the CLI's final g_a")
    n_gen = sum(p.numel() for p in state.g_a.parameters())
    g_a_npz = copy.deepcopy(state.g_a).eval()   # the weights the npz holds
    # the step time at the CLI's settings, on one loader batch
    ds = UnpairedFolderDataset(crops["a"], crops["b"])
    one = ds.load(0, random.Random(0))
    a, b = one["a"][None], one["b"][None]
    step_ms = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(IMG_CG_TIMED):
        t0 = time.perf_counter()
        trainer.train_step(state, a, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    timings["cyclegan_step_ms"] = step_ms
    timings["cyclegan_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag} cyclegan: crops tool {4 * IMG_CG_FRAMES} 256 px crops a "
          f"domain from {IMG_CG_FRAMES} {IMG_CG_SIZE[0]}x{IMG_CG_SIZE[1]} "
          f"PNGs ({timings['cyclegan_data_s']:.1f} s); train_cyclegan.main "
          f"{IMG_CG_STEPS} steps at ngf 64, 9 blocks, ndf 64, 3-layer "
          f"PatchGAN, lsgan, pool 50, 286 -> 256, batch 1 in "
          f"{timings['cyclegan_cli_s']:.1f} s, losses G "
          + ", ".join(f"{r['loss_g']:.4f}" for r in recs) + ", D "
          + ", ".join(f"{r['loss_d']:.4f}" for r in recs)
          + f"; tensors moved {moved}; the npz's g_a ({n_gen} params) "
          "equal to the final state's; step ms " + ", ".join(
              f"{t:.2f}" for t in step_ms)
          + f", median {statistics.median(step_ms):.2f}, peak "
          f"{timings['cyclegan_peak_gib']:.2f} GiB ({smi})", flush=True)

    # the card against the CPU from the CLI's weights at pool 1: fill, then
    # play back (pool a) and pass through (pool b), draws handed in. Adam's
    # first update is about +-lr for every parameter, so a gradient near 0
    # whose sign differs moves a weight 2 lr apart, and at full width such
    # weights move the next step's losses by ~1e-4: before each step the
    # card's nets, Adam state and pools are set to the CPU's, so every step
    # starts from the same state
    crop = IMG_CG_TWIN_CROP
    cfg1 = dataclasses.replace(trainer.cfg, pool_size=1)
    twins = {}
    for dev in ("cuda", "cpu"):
        tr = cg.CycleGANTrainer(cfg1, device=dev)
        nets = [copy.deepcopy(getattr(state, n)).to(dev)
                for n in ("g_a", "g_b", "d_a", "d_b")]
        twins[dev] = (tr, tr.state_from(*nets, pool=torch.zeros(
            (1, cfg1.input_nc, crop, crop), device=dev)))
    ds = UnpairedFolderDataset(crops["a"], crops["b"],
                               load_size=(crop + 16, crop + 16),
                               crop_size=(crop, crop))
    worst, apart_all, pools_all, cpu_s = 0.0, [], [], 0.0
    s_gpu, s_cpu = twins["cuda"][1], twins["cpu"][1]
    for step in range(IMG_CG_TWIN_STEPS):
        for n in ("g_a", "g_b", "d_a", "d_b", "g_opt", "d_opt"):
            getattr(s_gpu, n).load_state_dict(getattr(s_cpu, n).state_dict())
        for n in ("pool_a", "pool_b"):
            getattr(s_gpu, n).copy_(getattr(s_cpu, n))
        s_gpu.pool_n, s_gpu.step = s_cpu.pool_n, s_cpu.step
        one = ds.load(step, random.Random(step))
        a, b = one["a"][None], one["b"][None]
        draws = cg.CycleGANDraws(
            use_old_a=torch.tensor([True]), idx_a=torch.zeros(
                1, dtype=torch.int64), use_old_b=torch.tensor([False]),
            idx_b=torch.zeros(1, dtype=torch.int64))
        logs, picked = {}, {}
        for dev, (tr, st) in twins.items():
            t0 = time.perf_counter()
            _, lg = tr.train_step(st, a, b, draws.to(dev))
            logs[dev] = {k: float(v) for k, v in lg.items()}
            picked[dev] = {k: v.cpu().tolist()
                           for k, v in tr.last_picked.items()}
            if dev == "cpu":
                cpu_s += time.perf_counter() - t0
        want = ({"a": [-1], "b": [-1]} if step == 0
                else {"a": [0], "b": [-1]})
        if not picked["cuda"] == picked["cpu"] == want:
            fail(f"{tag} cyclegan twin step {step}: the pool's choices "
                 f"{picked}, expected {want}")
        for k, r in logs["cpu"].items():
            err = abs(logs["cuda"][k] - r) / max(abs(r), 1e-12)
            worst = max(worst, err)
            if not err <= TRAIN_LOSS_RTOL:
                fail(f"{tag} cyclegan twin step {step}: {k} "
                     f"{logs['cuda'][k]} on cuda vs {r} on cpu")
        nets = [[getattr(st, n) for n in ("g_a", "g_b", "d_a", "d_b")]
                for st in (s_gpu, s_cpu)]
        apart = _params_apart(*nets)
        # float32 cannot hold p +- lr exactly: a few ulps of the largest
        # parameter on top
        ulps = 8 * float(np.finfo(np.float32).eps) * max(
            float(p.detach().abs().max()) for net in nets[1]
            for p in net.parameters())
        lr_bound = 2 * cfg1.lr * IMG_CG_ADAM_STEPS[step] + ulps
        pools = max(float((getattr(s_gpu, p).cpu()
                           - getattr(s_cpu, p)).abs().max())
                    for p in ("pool_a", "pool_b"))
        if not apart <= lr_bound or not pools <= IMG_CG_POOL_TOL:
            fail(f"{tag} cyclegan twin step {step}: parameters {apart} "
                 f"apart (bound {lr_bound}), pools {pools} apart "
                 f"(tolerance {IMG_CG_POOL_TOL})")
        apart_all.append(apart)
        pools_all.append(pools)
    timings["cyclegan_twin"] = {"loss_rel": worst, "params_apart": apart_all,
                                "pools_apart": pools_all, "cpu_s": cpu_s}
    print(f"{tag} cyclegan twin: {IMG_CG_TWIN_STEPS} steps at pool 1 on "
          f"{crop} px crops from the CLI's weights, cuda vs cpu, each from "
          f"the CPU's state: losses within {worst:.3g} (rtol "
          f"{TRAIN_LOSS_RTOL:g}), the pool's choices equal (fill; then a "
          f"plays back, b passes through), parameters after each step "
          + ", ".join(f"{x:.3g}" for x in apart_all) + " apart (bounds "
          + ", ".join(f"{2 * cfg1.lr * r:g}" for r in
                      IMG_CG_ADAM_STEPS[:IMG_CG_TWIN_STEPS])
          + ": 2 lr x Adam's largest update, and 8 float32 ulps of the "
          "largest parameter), pools " + ", ".join(
              f"{x:.3g}" for x in pools_all)
          + f" apart (tolerance {IMG_CG_POOL_TOL:g}); the CPU took "
          f"{cpu_s:.1f} s", flush=True)
    del twins, nets, s_gpu, s_cpu

    # the EN tool on IC frames, from the CLI's npz
    cs_root = os.path.join(root, "cityscapes")
    ic_dir = os.path.join(cs_root, "leftImg8bit_IC1", "train", "aachen")
    _image_frames(ic_dir, IMG_CG_FRAMES, IMG_CG_SIZE, seed=31)
    t0 = time.perf_counter()
    with _deterministic_cudnn():
        ic_tool.main(["--root_dir", cs_root, "--mode", "en", "--cyclegan",
                      npz])
        torch.cuda.synchronize()
        timings["en_s"] = time.perf_counter() - t0
        en_dir = os.path.join(cs_root, "leftImg8bit_EN1", "train", "aachen")
        names = sorted(os.listdir(ic_dir))
        for name in names:
            got = np.asarray(Image.open(os.path.join(en_dir, name)))
            with Image.open(os.path.join(ic_dir, name)) as ic:
                ref = ic_tool.en_frame(g_a_npz, ic)
            if got.shape != (512, 1024) or not np.array_equal(got, ref):
                fail(f"{tag} en: {name} {got.shape} differs from the "
                     "generator applied in-process by up to "
                     f"{np.abs(got.astype(int) - ref).max()} levels")
    print(f"{tag} en: --mode en with the CLI's npz on {len(names)} "
          f"{IMG_CG_SIZE[0]}x{IMG_CG_SIZE[1]} IC frames in "
          f"{timings['en_s']:.1f} s, each PNG equal to the trained g_a "
          f"applied in-process ({smi})", flush=True)


def _image_batch(cfg, n, seed, isr=False):
    """``n`` batches of 2 synthetic source samples (labels in 64x64 squares
    of random classes, so the feature distance has pure 32x32 cells) and
    target images at the config's crop."""
    from cmda_tpu_torch.data.synthetic import (SyntheticSource,
                                               SyntheticTarget, uda_batch)
    w, h = cfg.data.crop_size
    src = SyntheticSource(crop_size=(w, h), with_time_res=False)
    tgt = SyntheticTarget(crop_size=(w, h), with_events=False)
    g = np.random.default_rng(seed)
    out = []
    for i in range(n):
        batch = uda_batch(src, tgt, [2 * i, 2 * i + 1])
        k = min(TYPES_LABEL_BLOCK, h)
        batch["source"]["label"] = np.repeat(np.repeat(g.integers(
            0, 19, (2, h // k, w // k)), k, 1), k, 2).astype(np.int32)
        out.append(batch)
    return out


def _org_cfg(cfg):
    """OrgDACS's settings on a config: the image-only train type, no fusion
    module, the ImageNet feature distance at TYPES_FDIST over the thing
    classes; the pseudo weight's rows as the config crops them."""
    from cmda_tpu_torch import config as C
    return C.replace(cfg, model=C.replace(cfg.model, train_type="cs2dz_image",
                                          fusion="", fusion_isr=""),
                     uda=C.replace(cfg.uda,
                                   imnet_feature_dist_lambda=TYPES_FDIST))


def _seeded_mit(cfg, device):
    """A seeded MiT state_dict of the config's backbone (NVlabs keys)."""
    import torch
    from cmda_tpu_torch.models.common import init_weights
    from cmda_tpu_torch.models.mit import MIT_VARIANTS, MixVisionTransformer
    mit = MixVisionTransformer(MIT_VARIANTS[cfg.model.backbone]).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    init_weights(mit, gen)
    return mit.state_dict()


def _org_micro(tag):
    """One OrgDACS step of the micro config at 64x64 (the feature
    distance, rows 2 / 15 cropped, the 3-channel day -> night generator)
    on the card and on the CPU from one state, batch and draws: losses
    and AdamW's first moments, as phase_train_micro holds them."""
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.uda.org_dacs import OrgDACSTrainer
    cfg = C.micro_test_config()
    cfg = _org_cfg(C.replace(cfg, data=C.replace(
        cfg.data, crop_size=TRAIN_MICRO_HW), uda=C.replace(
        cfg.uda, pseudo_weight_ignore_top=2, pseudo_weight_ignore_bottom=15)))
    mit = _seeded_mit(cfg, "cpu")
    cpu = OrgDACSTrainer(cfg, "cpu", use_cyclegan_day2night=True)
    gpu = OrgDACSTrainer(cfg, "cuda", use_cyclegan_day2night=True)
    s_cpu = cpu.init_state(seed=0, imnet_state_dict=mit)
    s_gpu = gpu.init_state(seed=0, imnet_state_dict=mit)
    for name in ("model", "ema_model", "cyclegan", "imnet"):
        getattr(s_gpu, name).load_state_dict(getattr(s_cpu, name).state_dict())
    batch = _image_batch(cfg, 1, seed=8)[0]
    draws = cpu.new_draws(s_cpu, 2)
    _, ref = cpu.train_step(s_cpu, batch, draws)
    _, logs = gpu.train_step(s_gpu, batch, draws.to("cuda"))
    logs = {k: float(v) for k, v in logs.items()}
    loss = _check_logs(logs, ref, f"{tag} org micro, cuda vs cpu")
    mom = _check_moments(s_gpu, s_cpu, TRAIN_MOMENT_RTOL,
                         f"{tag} org micro, cuda vs cpu")
    print(f"{tag} org micro: one OrgDACS step at 64x64 (feature distance, "
          "day -> night generator, rows 2 / 15 cropped), cuda vs cpu: losses "
          f"within {loss:.3g} (rtol {TRAIN_LOSS_RTOL:g}), AdamW first "
          f"moments within {mom:.3g} of the largest (tolerance "
          f"{TRAIN_MOMENT_RTOL:g}); feature distance "
          f"{logs['src/loss_imnet_feat_dist']:.5f}", flush=True)
    return {"loss_rel": loss, "moments_rel": mom}


def _org_b5(tag, smi, timings):
    """OrgDACS at MiT-b5, cs2dz 512x512, batch 2: IMG_ORG_STEPS steps
    (finite logs, parameters move, the EMA teacher after step 0 is the
    pre-update student), their times, one step's CUDA-event sections and
    the peak memory."""
    import torch
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.uda.org_dacs import OrgDACSTrainer
    cfg = _org_cfg(C.cs2dz_image_rawisr_b5())
    t0 = time.perf_counter()
    trainer = OrgDACSTrainer(cfg, "cuda", use_cyclegan_day2night=True)
    state = trainer.init_state(seed=0, imnet_state_dict=_seeded_mit(
        cfg, "cuda"))
    batches = _image_batch(cfg, IMG_ORG_STEPS + 1, seed=9)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    student0 = [p.detach().clone() for p in state.model.parameters()]
    step_ms, records = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(IMG_ORG_STEPS):
        t0 = time.perf_counter()
        _, logs = trainer.train_step(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        logs = {k: float(v) for k, v in logs.items()}
        records.append(logs)
        if not all(math.isfinite(v) for v in logs.values()):
            fail(f"{tag} org b5 step {i}: logs {logs}")
        if i == 0 and not all(torch.equal(e, p) for e, p in zip(
                state.ema_model.parameters(), student0)):
            fail(f"{tag} org b5: after step 0 the EMA teacher is not the "
                 "pre-update student")
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = sum(int(not torch.equal(p, q)) for p, q in
                zip(state.model.parameters(), student0))
    if not moved or not records[-1]["src/loss_imnet_feat_dist"] > 0:
        fail(f"{tag} org b5: {moved} tensors moved, logs {records[-1]}")
    del student0
    trainer.marks = []
    trainer.train_step(state, batches[-1])
    torch.cuda.synchronize()
    marks, trainer.marks = trainer.marks, None
    sections = {IMG_ORG_NAMES[n]: a.elapsed_time(e)
                for (_, a, _, _), (n, e, _, _) in zip(marks, marks[1:])}
    med = statistics.median(step_ms)
    timings["org_b5"] = {"build_s": build_s, "step_ms": step_ms,
                         "step_ms_median": med, "peak_gib": peak,
                         "sections_ms": sections, "logs": records}
    print(f"{tag} org b5: OrgDACS MiT-b5 cs2dz 512x512 batch 2 (feature "
          f"distance {TYPES_FDIST}, rows 15 / 120 cropped, a random 3-channel"
          f" ngf-64 9-block day -> night generator), built in {build_s:.1f} "
          f"s; {IMG_ORG_STEPS} steps: loss " + ", ".join(
              f"{r['loss']:.5f}" for r in records) + ", feature distance "
          + ", ".join(f"{r['src/loss_imnet_feat_dist']:.5f}" for r in records)
          + f", pseudo_weight {records[-1]['pseudo_weight']:.5f}; {moved} "
          f"parameter tensors moved; EMA teacher after step 0 == the "
          f"pre-update student; step ms " + ", ".join(
              f"{t:.2f}" for t in step_ms) + f", median {med:.2f}; peak "
          f"{peak:.2f} GiB; one step's device ms " + ", ".join(
              f"{k} {v:.2f}" for k, v in sections.items()) + f" ({smi})",
          flush=True)
    return state


def _dacs_image_b5(tag, smi, timings):
    """DACSImage with isrd2isrn (a random 1-channel generator) at MiT-b5,
    512x512, batch 2: IMG_DI_STEPS steps, finite, parameters moving."""
    import torch
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.uda.dacs_image import DACSImageTrainer
    cfg = _org_cfg(C.cs2dz_image_rawisr_b5())
    t0 = time.perf_counter()
    trainer = DACSImageTrainer(cfg, "cuda", transfer_direction="isrd2isrn")
    state = trainer.init_state(seed=0)
    batches = _image_batch(cfg, IMG_DI_STEPS, seed=10)
    build_s = time.perf_counter() - t0
    student0 = [p.detach().clone() for p in state.model.parameters()]
    step_ms, records = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(IMG_DI_STEPS):
        t0 = time.perf_counter()
        _, logs = trainer.train_step(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        records.append({k: float(v) for k, v in logs.items()})
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = sum(int(not torch.equal(p, q)) for p, q in
                zip(state.model.parameters(), student0))
    if not moved or not all(math.isfinite(v) for r in records
                            for v in r.values()):
        fail(f"{tag} dacs_image b5: {moved} tensors moved, logs {records}")
    timings["dacs_image_b5"] = {"build_s": build_s, "step_ms": step_ms,
                                "peak_gib": peak, "logs": records}
    print(f"{tag} dacs_image b5: DACSImage isrd2isrn (random 1-channel "
          f"ngf-64 9-block generator) MiT-b5 512x512 batch 2, built in "
          f"{build_s:.1f} s; {IMG_DI_STEPS} steps: loss " + ", ".join(
              f"{r['loss']:.5f}" for r in records) + f"; {moved} parameter "
          "tensors moved; step ms " + ", ".join(f"{t:.2f}" for t in step_ms)
          + f"; peak {peak:.2f} GiB ({smi})", flush=True)


def _prototype_part(tag, smi, timings):
    """The prototype functions at the b5 head's features, on the card and
    on the CPU with the same inputs and random scores, each timed on the
    card."""
    import torch
    from cmda_tpu_torch.uda import prototype as P
    p = IMG_PROTO
    b, hw, d, k = p["b"], p["hw"], p["dim"], p["classes"]
    g = torch.Generator().manual_seed(5)
    feats = torch.randn((b, hw, hw, d), generator=g)
    logits = torch.randn((b, hw, hw, k), generator=g)
    labels = torch.randint(0, k, (b, 4 * hw, 4 * hw), generator=g,
                           dtype=torch.int32)
    labels[:, :16] = 255
    noise = tuple(torch.randn((k, p["memory"], d), generator=g)
                  for _ in range(2))
    s_enq = torch.rand((b, hw * hw), generator=g)
    s_pcl = torch.rand((b, k, hw * hw), generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        f, z, lbl = feats.to(dev), logits.to(dev), labels.to(dev)
        means, valid = P.class_mean_features(f, z, lbl[:, ::4, ::4],
                                             num_classes=k)
        bank = P.update_prototypes(P.PrototypeBank.create(k, d, dev), means,
                                   valid)
        q = P.ContrastQueues.create(tuple(n.to(dev) for n in noise))
        q = P.enqueue(q, f, lbl, s_enq.to(dev),
                      pixel_update_freq=p["freq"])
        loss = P.pixel_contrast_loss(s_pcl.to(dev), f, lbl, z.argmax(-1),
                                     q.pixel_queue, n_view=p["n_view"],
                                     num_classes=k)
        out[dev] = {"means": means.cpu(), "valid": valid.cpu(),
                    "protos": bank.protos.cpu(), "counts": bank.counts.cpu(),
                    "segment_queue": q.segment_queue.cpu(),
                    "pixel_queue": q.pixel_queue.cpu(),
                    "segment_ptr": q.segment_ptr.cpu(),
                    "pixel_ptr": q.pixel_ptr.cpu(), "loss": float(loss)}
        out[dev]["s"] = time.perf_counter() - t0
    c, r = out["cuda"], out["cpu"]
    errs = {n: float((c[n] - r[n]).abs().max()) / max(
        float(r[n].abs().max()), 1e-30) for n in
        ("means", "protos", "segment_queue", "pixel_queue")}
    loss_rel = abs(c["loss"] - r["loss"]) / abs(r["loss"])
    same = all(torch.equal(c[n], r[n]) for n in
               ("valid", "counts", "segment_ptr", "pixel_ptr"))
    if (not same or any(not e <= IMG_PROTO_TOL for e in errs.values())
            or not loss_rel <= IMG_PROTO_LOSS_RTOL):
        fail(f"{tag} prototype: cuda vs cpu {errs}, loss {c['loss']} vs "
             f"{r['loss']}, masks and pointers equal {same}")
    dev = "cuda"
    f, z, lbl = feats.to(dev), logits.to(dev), labels.to(dev)
    means, valid = P.class_mean_features(f, z, lbl[:, ::4, ::4],
                                         num_classes=k)
    q = P.ContrastQueues.create(tuple(n.to(dev) for n in noise))
    s_enq, s_pcl, pred = s_enq.to(dev), s_pcl.to(dev), z.argmax(-1)
    ms = {
        "class_mean_features": cuda_ms(lambda: P.class_mean_features(
            f, z, lbl[:, ::4, ::4], num_classes=k), 1, 5),
        "update_prototypes": cuda_ms(lambda: P.update_prototypes(
            P.PrototypeBank.create(k, d, dev), means, valid), 1, 5),
        "enqueue": cuda_ms(lambda: P.enqueue(q, f, lbl, s_enq,
                                             pixel_update_freq=p["freq"]),
                           1, 5),
        "pixel_contrast_loss": cuda_ms(lambda: P.pixel_contrast_loss(
            s_pcl, f, lbl, pred, q.pixel_queue, n_view=p["n_view"],
            num_classes=k), 1, 5)}
    timings["prototype"] = {"cuda_vs_cpu": errs, "loss_rel": loss_rel,
                            "ms": ms, "cpu_s": r["s"], "loss": c["loss"]}
    print(f"{tag} prototype: features [{b},{hw},{hw},{d}], {k} classes, "
          f"memory {p['memory']}, pixel_update_freq {p['freq']}, n_view "
          f"{p['n_view']}: cuda vs cpu " + ", ".join(
              f"{n} {e:.3g}" for n, e in errs.items())
          + f" of the largest (tolerance {IMG_PROTO_TOL:g}), loss "
          f"{c['loss']:.6f} within {loss_rel:.3g} (rtol "
          f"{IMG_PROTO_LOSS_RTOL:g}), valid classes, counts and pointers "
          "equal; ms on the card " + ", ".join(
              f"{n} {t:.3f}" for n, t in ms.items())
          + f" (the CPU's pass {r['s']:.1f} s) ({smi})", flush=True)


def phase_image_trainers():
    """The CycleGAN workflow and the image-only trainers at full width:
    ``create_cityscapes_image_change --mode crops``, ``train_cyclegan.main``
    in-process at the JAX CLI's defaults (its log, samples and npz), the
    CycleGAN step on the card against the CPU at pool 1 (fill, then play
    back), ``--mode en`` from the CLI's npz against the generator applied
    in-process; OrgDACS at MiT-b5 (cs2dz 512x512 batch 2, the feature
    distance, the rows cropped, a random day -> night generator) and its
    micro step on the card against the CPU; DACSImage with isrd2isrn at
    MiT-b5; the prototype functions at the b5 head's features on the card
    against the CPU. None of the port's kernels is on these paths: the
    launch counters are set to 0 at the start and must read 0 at the end.
    Returns those counts."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag, smi = "image_trainers", smi_line()
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    timings = {}
    with tempfile.TemporaryDirectory(prefix="cg_") as root:
        _cyclegan_part(root, tag, smi, timings)
    gc.collect()
    torch.cuda.empty_cache()
    timings["org_micro"] = _org_micro(tag)
    _org_b5(tag, smi, timings)
    gc.collect()
    torch.cuda.empty_cache()
    _dacs_image_b5(tag, smi, timings)
    gc.collect()
    torch.cuda.empty_cache()
    _prototype_part(tag, smi, timings)
    launches = {k: fn.launches for k, fn in counters.items()}
    if any(launches.values()):
        fail(f"{tag}: the phase launched port kernels {launches}; none is "
             "on these paths")
    timings["phase_s"] = time.perf_counter() - t_phase
    print(f"{tag}: launches {launches}; phase {timings['phase_s']:.1f} s "
          f"({smi})", flush=True)
    print(f"{tag} timings " + json.dumps(timings, default=float), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# the model zoo (phase_model_zoo): CMDA's fusion and decoder-sharing
# ablations through the train CLI's own flags on the flagship b5 step, each
# one step against its plain-version twin and one timed
ZOO_ABLATIONS = (("fusion_af", ["--fusion", "af"]),
                 ("fusion_caf", ["--fusion", "caf"]),
                 ("no_share_decoder", ["--no_share_decoder"]),
                 ("half_share_decoder", ["--half_share_decoder"]))
ZOO_ORG_STEPS = 3
# one supervised step of every other head and block type at full width
# (the grid's names; backbones at full depth, heads at the JAX package's
# own HeadConfig defaults and head arguments), 512x512, batch 2
ZOO_SUPERVISED = (("dlv3p_nodbn", "r101v1c"), ("da_nodbn", "r101v1c"),
                  ("isa_nodbn", "r101v1c"), ("dlv2red", "x101-32"),
                  ("dlv2red", "s101"), ("segformer", "mitb5"),
                  ("upernet", "mitb5"), ("daformer_isa", "mitb5"))
ZOO_SUPERVISED_HW = 512
ZOO_GRIDS = (3, 4, 5, 6, 7, 8)
# the micro supervised twin: each step from the CPU's float32 state, on the
# card (float32, TF32 off) and on the CPU in float32, each held against a
# float64 run of the same step on the CPU: every tensor's parameter change
# within ZOO_MICRO_F64_RTOL[device] of the float64 run's largest change.
# The gradient of the ResNet's stem, behind four stages of train-mode
# BatchNorm, is the largest and the least resolved in float32: the CPU's
# float32 steps are 2.2e-3 and 1.1e-2 of the largest apart from float64
# (steps 1 and 2), the card's 1.3e-3 (NVIDIA H100 80GB HBM3), so
# phase_train_micro's 5e-4 cannot hold. A control step on the card with
# TF32 on (0.165 there) must land outside the card's tolerance, or the
# check could not tell a lower-precision card step from a float32 one
ZOO_MICRO_HW = 64
ZOO_MICRO_F64_RTOL = {"cuda": 5e-3, "cpu": 2.5e-2}


def _zoo_ablations(tag, smi, timings, totals):
    """The four ablation steps: each config from ``tools.train``'s parser
    and ``build_config`` (``--config cs2dsec --synthetic --backbone
    CUT_BACKBONE`` plus the flag),
    one step against its plain-version twin (``_twin_step``) with the
    flagship's launches checked, then one timed step."""
    import torch
    from cmda_tpu_torch.data.synthetic import (SyntheticSource,
                                               SyntheticTarget, uda_batch)
    from cmda_tpu_torch.tools import train as ttrain
    batch = None
    for name, flags in ZOO_ABLATIONS:
        cfg = ttrain.build_config(ttrain.parse_args(
            ["--config", "cs2dsec", "--synthetic", "--backbone",
             CUT_BACKBONE] + flags))
        if batch is None:
            w, h = cfg.data.crop_size
            batch = uda_batch(SyntheticSource(crop_size=(w, h)),
                              SyntheticTarget(crop_size=(w, h)), [0, 1])
        t0 = time.perf_counter()
        logs, _, launches, errors, timing = _twin_step(
            cfg, batch, f"{tag} {name}", timed_steps=1)
        for k, v in launches.items():
            totals[k] += v
        if launches != TRAIN_LAUNCHES_PER_STEP:
            fail(f"{tag} {name}: launches {launches}, expected the "
                 f"flagship's {TRAIN_LAUNCHES_PER_STEP}")
        m = cfg.model
        timings[name] = {"twin_errors": errors, **timing,
                         "wall_s": time.perf_counter() - t0}
        print(f"{tag} {name}: cs2dsec {m.backbone} 512x512 batch 2, fusion "
              f"{m.fusion!r}, fusion_isr {m.fusion_isr!r}, share "
              f"{m.share_decoder!r}: launches {launches}, loss "
              f"{logs['loss']:.5f}; " + _twin_summary(errors) + "; step ms "
              + ", ".join(f"{t:.2f}" for t in timing["step_ms"])
              + f"; peak {timing['peak_gib']:.2f} GiB ({smi})", flush=True)
        gc.collect()
        torch.cuda.empty_cache()


def _zoo_org_r101(tag, smi, timings):
    """OrgDACS on DeepLabV2 / ResNet-101 (``dlv2red_r101v1c`` at full
    depth, 19 classes) with ``_legacy_uda_cfg(.., 'dacs_a999_fdthings',
    0.01, plcrop=True)`` on the cs2dz preset's 512x512 batch 2, the frozen
    R101 twin for the distance: ZOO_ORG_STEPS steps (finite logs,
    parameters move, the EMA teacher after step 0 is the pre-update
    student), their times, one step's sections, the peak memory."""
    import torch
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.tools import run_experiments as trun
    from cmda_tpu_torch.uda.org_dacs import OrgDACSTrainer
    base = C.cs2dz_image_rawisr_b5()
    base = C.replace(base, model=C.replace(base.model,
                                           train_type="cs2dz_image",
                                           fusion="", fusion_isr=""))
    cfg = trun._legacy_uda_cfg(base, "dacs_a999_fdthings", 0.01, True)
    t0 = time.perf_counter()
    trainer = OrgDACSTrainer(cfg, "cuda",
                             model=_zoo_model("dlv2red", "r101v1c"),
                             imnet_model=_zoo_model("dlv2red", "r101v1c"))
    state = trainer.init_state(seed=0)
    batches = _image_batch(cfg, ZOO_ORG_STEPS + 1, seed=11)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    student0 = [p.detach().clone() for p in state.model.parameters()]
    step_ms, records = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(ZOO_ORG_STEPS):
        t0 = time.perf_counter()
        _, logs = trainer.train_step(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        logs = {k: float(v) for k, v in logs.items()}
        records.append(logs)
        if not all(math.isfinite(v) for v in logs.values()):
            fail(f"{tag} org r101 step {i}: logs {logs}")
        if i == 0 and not all(torch.equal(e, p) for e, p in zip(
                state.ema_model.parameters(), student0)):
            fail(f"{tag} org r101: after step 0 the EMA teacher is not the "
                 "pre-update student")
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = sum(int(not torch.equal(p, q)) for p, q in
                zip(state.model.parameters(), student0))
    if not moved or not records[-1]["src/loss_imnet_feat_dist"] > 0:
        fail(f"{tag} org r101: {moved} tensors moved, logs {records[-1]}")
    parts = {g["part"] for g in state.optimizer.param_groups}
    del student0
    trainer.marks = []
    trainer.train_step(state, batches[-1])
    torch.cuda.synchronize()
    marks, trainer.marks = trainer.marks, None
    sections = {IMG_ORG_NAMES[n]: a.elapsed_time(e)
                for (_, a, _, _), (n, e, _, _) in zip(marks, marks[1:])}
    med = statistics.median(step_ms)
    n_params = sum(p.numel() for p in state.model.parameters())
    timings["org_r101"] = {"build_s": build_s, "step_ms": step_ms,
                           "step_ms_median": med, "peak_gib": peak,
                           "sections_ms": sections, "logs": records,
                           "params": n_params}
    print(f"{tag} org r101: OrgDACS DeepLabV2 ResNet-101 d8 (3, 4, 23, 3), "
          f"{n_params} parameters, dacs_a999_fdthings rcs 0.01 plcrop, "
          f"512x512 batch 2, the frozen R101 twin for the distance, built "
          f"in {build_s:.1f} s; optimizer groups {sorted(parts)}; "
          f"{ZOO_ORG_STEPS} steps: loss " + ", ".join(
              f"{r['loss']:.5f}" for r in records) + ", feature distance "
          + ", ".join(f"{r['src/loss_imnet_feat_dist']:.5f}" for r in records)
          + f"; {moved} parameter tensors moved; EMA teacher after step 0 =="
          f" the pre-update student; step ms " + ", ".join(
              f"{t:.2f}" for t in step_ms) + f", median {med:.2f}; peak "
          f"{peak:.2f} GiB; one step's device ms " + ", ".join(
              f"{k} {v:.2f}" for k, v in sections.items()) + f" ({smi})",
          flush=True)


def _zoo_model(arch, backbone):
    """The GenericEncoderDecoder of a grid (arch, backbone) pair at full
    width, 19 classes: the backbone at its full RESNET_VARIANTS /
    MIT_VARIANTS depth, the head at the JAX package's own ``HeadConfig`` /
    ``DAFormerHeadConfig`` defaults and the launcher's head arguments."""
    from cmda_tpu_torch.models.daformer import DAFormerHead, DAFormerHeadConfig
    from cmda_tpu_torch.models.heads import (ASPPHead, DAHead, DLV2Head,
                                             HeadConfig, ISAHead,
                                             SegFormerHead, UPerHead)
    from cmda_tpu_torch.models.mit import MIT_VARIANTS, MixVisionTransformer
    from cmda_tpu_torch.models.resnet import (OUT_CHANNELS, RESNET_VARIANTS,
                                              ResNetV1c)
    from cmda_tpu_torch.models.segmentor import GenericEncoderDecoder
    from cmda_tpu_torch.tools.run_experiments import _LEGACY_RESNET_MAP
    if backbone.startswith("mitb"):
        cfg = MIT_VARIANTS["mit_b" + backbone[len("mitb")]]
        bb, ch = MixVisionTransformer(cfg), tuple(cfg.embed_dims)
    else:
        bb = ResNetV1c(RESNET_VARIANTS[_LEGACY_RESNET_MAP[backbone]])
        ch = OUT_CHANNELS
    hc = HeadConfig(in_channels=ch, num_classes=19)
    head = {
        "dlv2red": lambda: DLV2Head(hc),
        "dlv3p_nodbn": lambda: ASPPHead(hc, dilations=(1, 12, 24), sep=True,
                                        c1_channels=48),
        "da_nodbn": lambda: DAHead(hc),
        "isa_nodbn": lambda: ISAHead(hc),
        "segformer": lambda: SegFormerHead(hc),
        "upernet": lambda: UPerHead(hc),
        "daformer_isa": lambda: DAFormerHead(DAFormerHeadConfig(
            in_channels=ch, num_classes=19, fusion_type="isa")),
    }[arch]()
    return GenericEncoderDecoder(bb, head)


def _zoo_supervised(tag, smi, timings):
    """One supervised step of each ZOO_SUPERVISED combo at full width:
    finite loss, parameters moving, the step's ms (its first, so cuDNN's
    algorithm choice and the allocator's growth are in it)."""
    import torch
    from cmda_tpu_torch.models.common import init_weights
    from cmda_tpu_torch.tools import run_experiments as trun
    hw = ZOO_SUPERVISED_HW
    img, lbl = trun.supervised_batch(hw, 19, batch=2)
    img, lbl = torch.from_numpy(img).cuda(), torch.from_numpy(lbl).cuda()
    out = {}
    for arch, bb in ZOO_SUPERVISED:
        name = f"{arch}_{bb}"
        t0 = time.perf_counter()
        model = _zoo_model(arch, bb).cuda()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        init_weights(model, gen)
        draws = model.new_draws(2, generator=gen, device=img.device)
        opt = torch.optim.SGD(model.parameters(), lr=1e-3)
        before = [p.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = float(trun.supervised_step(model, opt, img, lbl, draws))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        moved = sum(int(not torch.equal(p, q)) for p, q in
                    zip(model.parameters(), before))
        if not math.isfinite(loss) or not moved:
            fail(f"{tag} supervised {name}: loss {loss}, {moved} tensors "
                 "moved")
        n_params = sum(p.numel() for p in model.parameters())
        out[name] = {"step_ms": ms, "loss": loss, "build_s": build_s,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "params": n_params}
        print(f"{tag} supervised {name}: {type(model.backbone).__name__} "
              f"{type(model.decode_head).__name__}, {n_params} parameters, "
              f"512x512 batch 2: loss {loss:.5f}; {moved} tensors moved; "
              f"step ms {ms:.2f} (the first step); peak "
              f"{out[name]['peak_gib']:.2f} GiB ({smi})", flush=True)
        del model, opt, before
        gc.collect()
        torch.cuda.empty_cache()
    timings["supervised"] = out


def _zoo_launcher(tag, smi, timings):
    """``run_experiments`` in-process on the card: ``--exp 100`` and
    ``--exp 102`` whole, one combo of each of grids 3-8 (``--only`` its
    first); every combo must be [OK]."""
    from cmda_tpu_torch.tools import run_experiments as trun
    runs = [["--exp", "100"], ["--exp", "102"]] + [
        ["--exp", str(e), "--only", trun.legacy_table_grid(e)[0]["name"]]
        for e in ZOO_GRIDS]
    out = {}
    for argv in runs:
        t0 = time.perf_counter()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                results = trun.main(argv + ["--device", "cuda"])
        except SystemExit as e:
            print(buf.getvalue()[-4000:], flush=True)
            fail(f"{tag} run_experiments {' '.join(argv)}: exit {e.code}")
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith(("[OK]", "[FAIL]"))]
        bad = [n for n, r in results.items() if not r["ok"]]
        if bad or not results or len(lines) != len(results):
            print(buf.getvalue()[-4000:], flush=True)
            fail(f"{tag} run_experiments {' '.join(argv)}: failed {bad}")
        key = " ".join(argv[:2])
        out[key] = {"combos": len(results),
                    "seconds": time.perf_counter() - t0,
                    "losses": {n: r["loss"] for n, r in results.items()}}
        print(f"{tag} run_experiments {' '.join(argv)} --device cuda: "
              f"{len(results)} combos [OK] in {out[key]['seconds']:.1f} s: "
              + "; ".join(lines[:3]) + (" ..." if len(lines) > 3 else "")
              + f" ({smi})", flush=True)
    timings["launcher"] = out


def _zoo_micro(tag):
    """Two supervised steps of ``dlv2red`` on ResNetV1c at depths
    (1, 1, 1, 1), 64x64 batch 2, each from the CPU's float32 state
    (deterministic cuDNN): on the card in float32, on the CPU in float32
    and in float64. Each float32 step's loss to TRAIN_LOSS_RTOL of the
    float64 one, each tensor's parameter change to the device's
    ZOO_MICRO_F64_RTOL of the float64 step's largest change; then the
    card's step again with TF32 on, which must land outside the card's
    tolerance."""
    import copy
    import torch
    from cmda_tpu_torch.models.common import init_weights
    from cmda_tpu_torch.tools import run_experiments as trun
    cpu = trun._legacy_model_builder("dlv2red", "r101v1c")()
    init_weights(cpu, torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).cuda()
    f64 = copy.deepcopy(cpu).double()
    f64.dtype = torch.float64
    img, lbl = trun.supervised_batch(ZOO_MICRO_HW, 19, batch=2)
    img, lbl = torch.from_numpy(img), torch.from_numpy(lbl)
    worst = {"cuda": 0.0, "cpu": 0.0, "cuda_tf32": 0.0}
    loss_rel = 0.0

    def step(model, x, y, state, tf32=False):
        """One SGD step of ``model`` from ``state``: (loss, the changes of
        its parameters, in float64 on the CPU)."""
        model.load_state_dict(state)
        p0 = [p.detach().to("cpu", torch.float64, copy=True)
              for p in model.parameters()]
        opt = torch.optim.SGD(model.parameters(), lr=1e-3)
        with _tf32(tf32):
            loss = float(trun.supervised_step(model, opt, x, y))
        return loss, [p.detach().double().cpu() - a
                      for p, a in zip(model.parameters(), p0)]
    with _deterministic_cudnn():
        for i in range(2):
            state = {k: v.clone() for k, v in cpu.state_dict().items()}
            with mock.patch.object(torch.Tensor, "float",
                                   lambda t: t.double()):
                ref_loss, ref = step(f64, img.double(), lbl, state)
            scale = max(float(r.abs().max()) for r in ref)
            runs = {"cuda_tf32": step(gpu, img.cuda(), lbl.cuda(), state,
                                      tf32=True),
                    "cuda": step(gpu, img.cuda(), lbl.cuda(), state),
                    "cpu": step(cpu, img, lbl, state)}
            for name, (loss, changes) in runs.items():
                d = max(float((c - r).abs().max())
                        for c, r in zip(changes, ref)) / scale
                worst[name] = max(worst[name], d)
                if name == "cuda_tf32":
                    continue
                err = abs(loss - ref_loss) / abs(ref_loss)
                loss_rel = max(loss_rel, err)
                tol = ZOO_MICRO_F64_RTOL[name]
                if not err <= TRAIN_LOSS_RTOL or not d <= tol:
                    fail(f"{tag} micro: step {i} on {name}: loss {loss} vs "
                         f"{ref_loss} in float64; parameter changes {d:.3g}"
                         f" of the largest apart (tolerance {tol:g})")
    tol = ZOO_MICRO_F64_RTOL["cuda"]
    if not worst["cuda_tf32"] > tol:
        fail(f"{tag} micro: the TF32 control step is within "
             f"{worst['cuda_tf32']:.3g} of float64, inside the card's "
             f"tolerance {tol:g}: the check cannot tell it from float32")
    print(f"{tag} micro: 2 supervised dlv2red ResNetV1c (1, 1, 1, 1) steps "
          f"at 64x64, each from the cpu's float32 state, against a float64 "
          f"cpu run of the step: losses within {loss_rel:.3g} (rtol "
          f"{TRAIN_LOSS_RTOL:g}); parameter changes within "
          f"{worst['cuda']:.3g} (cuda, tolerance {tol:g}) and "
          f"{worst['cpu']:.3g} (cpu, tolerance "
          f"{ZOO_MICRO_F64_RTOL['cpu']:g}) of the largest; the TF32 control "
          f"on cuda {worst['cuda_tf32']:.3g} (must be over {tol:g})",
          flush=True)
    return {"loss_rel": loss_rel, **{f"delta_rel_{k}": v
                                     for k, v in worst.items()}}


def phase_model_zoo():
    """The model zoo at full width: CMDA's fusion (``--fusion af``,
    ``--fusion caf``) and decoder-sharing (``--no_share_decoder``,
    ``--half_share_decoder``) ablations on the cs2dsec step at
    CUT_BACKBONE's depth, 512x512 batch 2, each against its plain-version
    twin with the
    flagship's launches (CE 8 / dx 8 / argmax 3 / ISR 1) and timed; OrgDACS
    on DeepLabV2 / ResNet-101 (DAFormer's DACS baseline) for ZOO_ORG_STEPS
    steps; one supervised step of every other head and block type
    (ZOO_SUPERVISED); ``run_experiments`` in-process (``--exp 100``,
    ``--exp 102``, a combo of each of grids 3-8); the micro supervised
    steps on the card and the CPU against float64 (``_zoo_micro``). The
    kernel counters are set to 0
    at the start: the ablation steps' launches are the phase's, and the
    legacy paths, plain torch in the JAX package too, must launch none.
    Returns those launches."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag, smi = "model_zoo", smi_line()
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    totals = dict.fromkeys(TRAIN_COUNTED, 0)
    timings = {}
    _zoo_ablations(tag, smi, timings, totals)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    _zoo_org_r101(tag, smi, timings)
    gc.collect()
    torch.cuda.empty_cache()
    _zoo_supervised(tag, smi, timings)
    timings["micro"] = _zoo_micro(tag)
    legacy_s = time.perf_counter() - t0
    legacy = {k: fn.launches for k, fn in counters.items()}
    if any(legacy.values()):
        fail(f"{tag}: the legacy paths launched port kernels {legacy}; none "
             "is on them")
    _zoo_launcher(tag, smi, timings)
    gc.collect()
    torch.cuda.empty_cache()
    timings["phase_s"] = time.perf_counter() - t_phase
    print(f"{tag}: launches {totals} (the four ablation steps), legacy "
          f"paths {legacy} in {legacy_s:.1f} s; phase "
          f"{timings['phase_s']:.1f} s ({smi})", flush=True)
    print(f"{tag} timings " + json.dumps(timings, default=float), flush=True)
    return totals


TOOLS_EXPORT_HW = (440, 640)
# the exported model: the cs2dsec fusion model at b5's widths with its MiTs
# cut to CUT_BACKBONE's depth; at full depth the export traced in 57.6-90.0
# s and each load of the artifact took 26.3-43.5 s on the card's host
# (PERF.md, PR 16), more than the script's time holds
TOOLS_EXPORT_SET = (f"model.backbone={CUT_BACKBONE}",)
TOOLS_INFER_STEPS = 5
TOOLS_PROFILE = ("--batch", "2", "--steps", "2")
TOOLS_TRACE_TOP = 10
TOOLS_CE_ITERS = 20
TOOLS_SCAN_STEPS = 3
# the C4 twin's timed steps after its compared (untimed) step of each
# policy: three of each, alternating which runs first
TOOLS_C4_ORDER = ("full", "dots", "dots", "full", "full", "dots")
# where the custom ops' dispatch is timed against the wrappers' direct
# call: the argmax at the serving and the step's pseudo-label points, the
# ISR at the step's
TOOLS_DISPATCH_ARGMAX = ("serving_b1", "step_prob")
TOOLS_DISPATCH_ISR = "step"
TOOLS_CHUNKED_ITERS = 4
TOOLS_SEGMENT_ITERS = 2
TOOLS_LR_RTOL = 1e-12
# the train CLI's tiny preset cut to the micro model (1 block a stage) at
# 32x32, logging every iteration, with a random_choice_thres ramp: the
# segmented run's micro size
TOOLS_MICRO_ARGV = ("--config", "tiny", "--synthetic", "--num-workers", "1",
                    "--set", "model.backbone=mit_micro",
                    "--set", "model.head.in_channels=16,32,64,128",
                    "--set", "model.head.embed_dim=32",
                    "--set", "model.head.channels=32",
                    "--set", "data.crop_size=32,32", "--set", "log_interval=1",
                    "--set", "uda.random_choice_thres=0.2-0.8")


def _tools_dispatch(tag, smi, timings):
    """The custom ops' dispatch cost on the card: each serving kernel at
    its TOOLS_DISPATCH points through ``torch.ops.cmda_tpu_torch`` and
    through its wrapper, which calls the same implementation directly in
    eager mode (the same outputs, bitwise), per call with ``cuda_ms`` (the
    host's work included). These launches compare two routes to one
    kernel: phase_tools runs this before it sets its counters to 0."""
    import torch
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.ops.fused_resize import fused_resize_argmax
    from cmda_tpu_torch.ops.isr_kernel import batched_isr
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    ops = torch.ops.cmda_tpu_torch
    calls = {}
    for point in TOOLS_DISPATCH_ARGMAX:
        shape, (hh, ww), prob = ARGMAX_POINTS[point]
        x = torch.randn(shape, generator=gen, device="cuda")
        calls[f"argmax_{point}"] = (
            lambda x=x, hh=hh, ww=ww, prob=prob: ops.fused_resize_argmax(
                x, hh, ww, prob),
            lambda x=x, hh=hh, ww=ww, prob=prob: fused_resize_argmax(
                x, (hh, ww), with_prob=prob))
    b, h, w = ISR_POINTS[TOOLS_DISPATCH_ISR]
    gray = _smooth_gray(gen, b, h, w, "cuda")
    dirs = torch.arange(b, dtype=torch.int32, device="cuda") % 4
    kw = _isr_kw(C.cs2dsec_image_events_b5().data.target_isr)
    lo, hi = kw["val_range"]
    calls[f"isr_{TOOLS_DISPATCH_ISR}"] = (
        lambda: ops.batched_isr(gray, dirs, float(lo), float(hi),
                                float(kw["threshold"]),
                                float(kw["clip_range"]),
                                int(kw["shift_pixel"])),
        lambda: batched_isr(gray, dirs, **kw))
    out = {}
    for name, (op, wrapper) in calls.items():
        a, b_ = op(), wrapper()
        a = a if isinstance(a, tuple) else (a,)
        b_ = b_ if isinstance(b_, tuple) else (b_,)
        if not all(y is None or torch.equal(x, y) for x, y in zip(a, b_)):
            fail(f"{tag} dispatch {name}: the op and the wrapper differ")
        out[name] = {"op_ms": cuda_ms(op), "wrapper_ms": cuda_ms(wrapper)}
    timings["dispatch"] = out
    print(f"{tag} dispatch: per call ms through the custom op / the "
          "wrapper's direct call: " + ", ".join(
              f"{k} {v['op_ms']:.4f} / {v['wrapper_ms']:.4f}"
              for k, v in out.items()) + f" ({smi})", flush=True)


def _tools_export(tag, work, timings):
    """``export_model export --platforms cuda --verify`` of the cs2dsec
    fusion model (seeded random weights, TOOLS_EXPORT_SET) at batch 1 and
    TOOLS_EXPORT_HW float32, then ``export_model run`` on the artifact,
    each through the tool's ``main``: the artifact verified against the
    eager model, its graph naming the argmax op, each call launching the
    kernel exactly once, the outputs' shapes, dtype and finiteness."""
    import torch
    from cmda_tpu_torch.tools import export_model
    art = os.path.join(work, "serve.cmda")
    h, w = TOOLS_EXPORT_HW
    reports, seconds = [], []
    for argv in (["export", art, "--config", "cs2dsec", "--batch", "1",
                  "--height", str(h), "--width", str(w), "--platforms",
                  "cuda", "--verify", "--set", *TOOLS_EXPORT_SET],
                 ["run", art]):
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                reports.append(export_model.main(argv))
        except AssertionError as e:     # --verify's comparison
            fail(f"{tag} export_model {argv[0]}: {e}")
        seconds.append(time.perf_counter() - t0)
        gc.collect()
        torch.cuda.empty_cache()
    export, run = reports
    verified = export["verify"]
    for what in (export, run):
        if what["custom_ops"] != ["cmda_tpu_torch.fused_resize_argmax"]:
            fail(f"{tag} export: the program calls {what['custom_ops']}")
    if (export["backbone"] != CUT_BACKBONE
            or run["argmax_launches_per_call"] != [1] * len(
                run["argmax_launches_per_call"])
            or run["logits_shape"] != [1, h, w, 19]
            or run["pred_dtype"] != "int32" or not run["logits_finite"]):
        fail(f"{tag} export run: {run}")
    nbytes = os.path.getsize(export_model.program_path(art, "cuda"))
    timings["export"] = {
        "export_s": seconds[0], "run_s": seconds[1],
        "trace_s": export["export_s"]["cuda"], "bytes": nbytes,
        "verify_max_abs_logit_diff": verified["max_abs_logit_diff"],
        "load_s": run["load_s"], "call_ms": run["call_ms"],
        "launches_per_call": run["argmax_launches_per_call"]}
    print(f"{tag} export: MiT {CUT_BACKBONE} (b5's widths) cs2dsec fusion, "
          f"{seconds[0]:.1f} s, traced in {export['export_s']['cuda']:.1f} "
          f"s, {nbytes} bytes, verified (logits "
          f"{verified['max_abs_logit_diff']} from the eager model, labels "
          f"equal); run: {seconds[1]:.1f} s, loaded in {run['load_s']:.1f} "
          f"s, a call {run['call_ms']:.2f} ms, argmax launches per call "
          f"{run['argmax_launches_per_call']}", flush=True)


def _tools_c4_twin(tag, smi, timings):
    """One b5 cs2dsec float32 DACS step with model.remat_policy 'dots'
    against the same step with 'full' (both remat on), from one seeded
    state and the same draws: losses to TRAIN_LOSS_RTOL, AdamW's first
    moments to TRAIN_MOMENT_RTOL of the largest. That step of each is the
    warm-up; then TOOLS_C4_ORDER's steps, timed one by one (each ended by
    a synchronise): each policy's median ms, and its peak GiB over its
    steps, absolute (both states live) and above the step's start."""
    import torch
    from cmda_tpu_torch import config as C
    from cmda_tpu_torch.tools.profile_step import make_batch
    from cmda_tpu_torch.uda.dacs import DACSTrainer
    base = C.PRESETS["cs2dsec"]()
    b, (w, h) = base.data.batch_size, base.data.crop_size
    batch = make_batch(b, h, w, seed=3)
    trainers, states, logs = {}, {}, {}
    for policy in ("dots", "full"):
        cfg = C.replace(base, model=C.replace(base.model, remat=True,
                                              remat_policy=policy))
        trainers[policy] = DACSTrainer(cfg, device="cuda")
        states[policy] = trainers[policy].init_state(seed=0)
        if states[policy].model.backbone_image.remat_policy != policy:
            fail(f"{tag} c4: the encoder's remat policy is "
                 f"{states[policy].model.backbone_image.remat_policy}, not "
                 f"{policy}")
    draws = trainers["dots"].new_draws(states["dots"], b, (h, w))
    for policy in ("dots", "full"):
        states[policy], lg = trainers[policy].train_step(states[policy],
                                                         batch, draws)
        logs[policy] = {k: float(v) for k, v in lg.items()}
    loss_err = _check_logs(logs["dots"], logs["full"],
                           f"{tag} c4 dots vs full")
    mom_err = _check_moments(states["dots"], states["full"],
                             TRAIN_MOMENT_RTOL, f"{tag} c4 dots vs full")
    ms = {"dots": [], "full": []}
    peak = {k: [0.0, 0.0] for k in ms}    # absolute, above the start
    for policy in TOOLS_C4_ORDER:
        d = trainers[policy].new_draws(states[policy], b, (h, w))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        states[policy], _ = trainers[policy].train_step(states[policy],
                                                        batch, d)
        torch.cuda.synchronize()
        ms[policy].append((time.perf_counter() - t0) * 1e3)
        top = torch.cuda.max_memory_allocated()
        peak[policy] = [max(peak[policy][0], top / 2**30),
                        max(peak[policy][1], (top - start) / 2**30)]
    med = {k: statistics.median(v) for k, v in ms.items()}
    timings["c4"] = {"dots_ms": ms["dots"], "full_ms": ms["full"],
                     "dots_ms_median": med["dots"],
                     "full_ms_median": med["full"],
                     "order": list(TOOLS_C4_ORDER),
                     "dots_peak_gib": peak["dots"][0],
                     "full_peak_gib": peak["full"][0],
                     "dots_step_peak_gib": peak["dots"][1],
                     "full_step_peak_gib": peak["full"][1],
                     "loss_rel_err": loss_err, "moment_rel_err": mom_err}
    print(f"{tag} c4: losses {loss_err:.2e}, first moments {mom_err:.2e} of "
          f"the largest apart (tolerance {TRAIN_MOMENT_RTOL}); steps in the "
          f"order {', '.join(TOOLS_C4_ORDER)} after one of each: dots ms "
          + ", ".join(f"{t:.1f}" for t in ms["dots"])
          + f" (median {med['dots']:.1f}), full ms "
          + ", ".join(f"{t:.1f}" for t in ms["full"])
          + f" (median {med['full']:.1f}); peak GiB dots {peak['dots'][0]:.2f}"
          f" ({peak['dots'][1]:.2f} above the step's start), full "
          f"{peak['full'][0]:.2f} ({peak['full'][1]:.2f}) ({smi})",
          flush=True)
    del trainers, states


def _tools_chunked(tag, work, timings):
    """``train_chunked`` over TOOLS_CHUNKED_ITERS micro iterations in
    segments of TOOLS_SEGMENT_ITERS, in a process of its own whose
    segments are processes on the card; merged by ``merge_segment_logs``,
    the LR and random_choice_thres at every iteration equal an unbroken
    run's (in this process) to TOOLS_LR_RTOL; then ``checkpoint_tools
    publish`` / ``convert`` of its last checkpoint, each reloaded equal to
    the run's student."""
    import torch
    from cmda_tpu_torch.apis import init_segmentor
    from cmda_tpu_torch.tools import (checkpoint_tools, merge_segment_logs,
                                      train)
    log = os.path.join(work, "chunked.log")
    t0 = time.perf_counter()
    rc = spawn([sys.executable, "-m", "cmda_tpu_torch.tools.train_chunked",
                "--segment-iters", str(TOOLS_SEGMENT_ITERS), "--max-iters",
                str(TOOLS_CHUNKED_ITERS), "--work-dir",
                os.path.join(work, "seg"), "--seed", "3", "--stall-timeout",
                "300", "--max-stuck-retries", "0"] + list(TOOLS_MICRO_ARGV),
               log).wait()
    timings["chunked_s"] = time.perf_counter() - t0
    with open(log) as f:
        output = f.read()
    print("\n".join(line for line in output.splitlines()
                    if line.startswith("[chunked]")), flush=True)
    if rc != 0:
        fail(f"{tag} chunked: train_chunked returned {rc}:\n"
             f"{output[-4000:]}")
    seg_dir, one_dir = os.path.join(work, "seg"), os.path.join(work, "one")
    logs = sorted(f for f in os.listdir(seg_dir) if f.endswith(".log.json"))
    if len(logs) != TOOLS_CHUNKED_ITERS // TOOLS_SEGMENT_ITERS:
        fail(f"{tag} chunked: {len(logs)} segment logs")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train.main(["--max-iters", str(TOOLS_CHUNKED_ITERS), "--seed", "3",
                    "--work-dir", one_dir] + list(TOOLS_MICRO_ARGV))
    timings["unbroken_s"] = time.perf_counter() - t0
    merged = merge_segment_logs.main(
        [seg_dir, os.path.join(work, "merged.log.json")])
    steps = [r for r in merged if "loss" in r]
    ref = [r for r in merge_segment_logs.merge(one_dir) if "loss" in r]
    if ([r["iter"] for r in steps] != list(range(1, TOOLS_CHUNKED_ITERS + 1))
            or len(ref) != len(steps)):
        fail(f"{tag} chunked: iterations {[r['iter'] for r in steps]} "
             f"against {[r['iter'] for r in ref]}")
    worst = 0.0
    for a, r in zip(steps, ref):
        for k in ("lr", "random_choice_thres"):
            err = abs(a[k] - r[k]) / max(abs(r[k]), 1e-30)
            worst = max(worst, err)
            if err > TOOLS_LR_RTOL:
                fail(f"{tag} chunked: iteration {a['iter']} {k} {a[k]} "
                     f"against the unbroken run's {r[k]}")
    timings["chunked_lr_rel_err"] = worst
    print(f"{tag} chunked: {len(logs)} segment logs, "
          f"{TOOLS_CHUNKED_ITERS} iterations in {timings['chunked_s']:.1f} s "
          f"(unbroken {timings['unbroken_s']:.1f} s); lr "
          f"{[r['lr'] for r in steps]} and random_choice_thres equal the "
          f"unbroken run's to {worst:.1e}", flush=True)
    last = os.path.join(seg_dir, f"iter_{TOOLS_CHUNKED_ITERS}.pth")
    ckpt = torch.load(last, map_location="cpu", weights_only=True)
    with contextlib.redirect_stdout(io.StringIO()):
        pub = checkpoint_tools.main(["publish", last,
                                     os.path.join(work, "pub.pth")])
        conv = checkpoint_tools.main(["convert", last,
                                      os.path.join(work, "student.pth")])
    cfg = train.build_config(train.parse_args(list(TOOLS_MICRO_ARGV)))
    for path in (pub, conv):
        seg = init_segmentor(cfg, path, device="cuda")
        bad = [k for k, t in seg.model.state_dict().items()
               if not torch.equal(t.cpu(), ckpt["state_dict"][k])]
        if bad:
            fail(f"{tag} checkpoint_tools: {path} reloads {bad[:3]} unequal")
    if set(torch.load(pub, weights_only=True)) != {"state_dict", "step",
                                                   "meta"}:
        fail(f"{tag} checkpoint_tools publish: {pub}")
    print(f"{tag} checkpoint_tools: {os.path.basename(pub)} and "
          f"{os.path.basename(conv)} reload equal to the run's student",
          flush=True)


def phase_tools():
    """The run-operations tools, one after another on the card: the
    custom ops' dispatch against the wrappers' direct call
    (``_tools_dispatch``); then, with the kernel counters set to 0,
    ``export_model`` (export --verify, then run), ``bench_infer``,
    ``profile_step`` + ``analyze_trace``, ``bench_ce``, ``bench_scan``, the
    C4 twin (remat_policy 'dots' against 'full') and the micro segmented
    run (``train_chunked``: 2 segment processes) with
    ``merge_segment_logs`` and ``checkpoint_tools``. Returns this
    process's launches over the phase (the segments' are their
    processes')."""
    import torch
    from cmda_tpu_torch.tools import (analyze_trace, bench_ce, bench_infer,
                                      bench_scan, profile_step)
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag, smi = "tools", smi_line()
    timings = {}
    _tools_dispatch(tag, smi, timings)
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        _tools_export(tag, work, timings)
        timings["export_phase_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        infer = bench_infer.main(["--batch", "8", "--steps",
                                  str(TOOLS_INFER_STEPS), "--slide"])
        timings["bench_infer_s"] = time.perf_counter() - t0
        if infer["argmax_launches_per_call"] != 1:
            fail(f"{tag} bench_infer: {infer}")
        timings["bench_infer"] = {k: v for k, v in infer.items()
                                  if k.endswith(("_ms", "_per_s", "_fps"))}
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        trace_dir = os.path.join(work, "trace")
        prof = profile_step.main(list(TOOLS_PROFILE)
                                 + ["--trace", trace_dir])
        timings["profile_step_s"] = time.perf_counter() - t0
        want = {k: float(v) for k, v in TRAIN_LAUNCHES_PER_STEP.items()
                if k in prof["step_launches"]}
        if prof["step_launches"] != want:
            fail(f"{tag} profile_step: launches {prof['step_launches']}, "
                 f"expected {want}")
        timings["profile_step"] = {k: v for k, v in prof.items()
                                   if k.endswith("_s") or k == "peak_gib"}
        t0 = time.perf_counter()
        summary = analyze_trace.main([trace_dir, "--top",
                                      str(TOOLS_TRACE_TOP)])
        timings["analyze_trace_s"] = time.perf_counter() - t0
        if summary["lane"] != "device" or not 0 < summary["busy_share"] <= 1:
            fail(f"{tag} analyze_trace: {summary['lane']} lane, busy share "
                 f"{summary['busy_share']}")
        timings["trace"] = {"busy_share": summary["busy_share"],
                            "busy_ms": summary["busy_ms"],
                            "window_ms": summary["window_ms"],
                            "bytes": os.path.getsize(os.path.join(
                                trace_dir, "trace.json")),
                            "top": [(r["name"][:60], r["total_ms"], r["count"])
                                    for r in summary["top"]]}
        del prof, summary
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ce = bench_ce.main(["--iters", str(TOOLS_CE_ITERS)])
        timings["bench_ce_s"] = time.perf_counter() - t0
        calls = TOOLS_CE_ITERS + 2     # the timed iterations and warm-ups
        if (ce["launches"]["fused_resize_ce"] != calls
                or ce["launches"]["fused_resize_ce_dx"] != calls
                or not ce["max_abs_dx_diff"] <= CE_REL_TOL * ce["max_abs_dx"]
                or not ce["loss_diff"] <= CE_LOSS_RTOL * ce["loss"]):
            fail(f"{tag} bench_ce: {ce}")
        timings["bench_ce"] = {k: ce[k] for k in (
            "plain_ms", "fused_ms", "plain_over_fused", "max_abs_dx_diff",
            "max_abs_dx")}

        t0 = time.perf_counter()
        scan = bench_scan.main(["--steps", str(TOOLS_SCAN_STEPS)])
        timings["bench_scan_s"] = time.perf_counter() - t0
        timings["bench_scan"] = {k: v for k, v in scan.items()
                                 if k.startswith(("fwd", "grad"))}
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        _tools_c4_twin(tag, smi, timings)
        timings["c4_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()

        _tools_chunked(tag, work, timings)
        launches = {k: fn.launches for k, fn in counters.items()}
    timings["phase_s"] = time.perf_counter() - t_phase
    print(f"{tag}: launches {launches} in this process; phase "
          f"{timings['phase_s']:.1f} s ({smi})", flush=True)
    print(f"{tag} timings " + json.dumps(timings, default=float), flush=True)
    return launches


def device_time_only(root):
    """``--device-time ROOT``: build the kernels of the checkout at ROOT
    (another commit unpacked beside this one, say) and print one JSON line
    of every port kernel's device and per-call times at the points the main
    paths launch it, by the same method and on the same inputs as the full
    run, for a before/after on one card."""
    sys.path.insert(0, os.path.abspath(root))
    import cmda_tpu_torch
    from cmda_tpu_torch.ops import _build
    _build.build()
    times = port_kernel_times(earlier=True)
    print(json.dumps({
        "root": root, "package": cmda_tpu_torch.__file__, "smi": smi_line(),
        "device_ms": {k: t["device_ms"] for k, t in times.items()},
        "ms": {k: t["ms"] for k, t in times.items()},
        "traces": {k: t["traces"] for k, t in times.items()},
        "device_ms_cold_l2": {k: t["device_ms_cold_l2"] for k, t in
                              times.items() if "device_ms_cold_l2" in t}}),
        flush=True)


def phases_only(names):
    """``--phases``: build the kernels and run the named phases alone; each
    phase's launches go out as a JSON line ``{name: launches}``."""
    import torch
    from cmda_tpu_torch.ops import _build
    unknown = set(names) - {"isr", "ce", "train_types", "image_trainers",
                            "model_zoo", "tools"}
    if unknown:
        fail(f"unknown phases {sorted(unknown)}")
    print(smi_line(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    if {"isr", "ce"} & set(names):
        times = port_kernel_times()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        if "isr" in names:
            phase_isr(gen, times)
        if "ce" in names:
            phase_ce(gen, times)
    if "train_types" in names:
        print(json.dumps({"train_types": phase_train_types()}), flush=True)
    if "image_trainers" in names:
        print(json.dumps({"image_trainers": phase_image_trainers()}),
              flush=True)
    if "model_zoo" in names:
        print(json.dumps({"model_zoo": phase_model_zoo()}), flush=True)
    if "tools" in names:
        print(json.dumps({"tools": phase_tools()}), flush=True)


def main():
    # a SIGTERM (a time limit) exits through atexit, which stops the
    # children
    signal.signal(signal.SIGTERM, lambda signum, _: sys.exit(128 + signum))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if sys.argv[1:2] == ["--device-time"] and len(sys.argv) == 3:
        device_time_only(sys.argv[2])
        return
    if sys.argv[1:2] == ["--phases"] and len(sys.argv) == 3:
        phases_only(sys.argv[2].split(","))
        return
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}")
    from cmda_tpu_torch.ops import _build
    t_main = time.perf_counter()

    def elapsed(what):
        print(f"elapsed: {time.perf_counter() - t_main:.1f} s after {what}",
              flush=True)
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
    elapsed("_build.build")
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(_build.SOURCES)}", flush=True)
    for name, entry in log.items():
        print(f"build {name}: {entry['seconds']:.1f} s", flush=True)
        for line in entry["log"].splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    times = port_kernel_times()
    elapsed("port_kernel_times")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = [phase_argmax(gen, times), phase_isr(gen, times)]
    phase_main_path(results)
    elapsed("phase_main_path(results)")
    results += phase_ce(gen, times)
    phase_train_micro()
    elapsed("phase_train_micro")
    launches = phase_train()
    elapsed("phase_train")
    # the JAX package's bench.py step: bfloat16 at batch 8
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_micro("bfloat16")
    elapsed('phase_train_micro("bfloat16")')
    bf16_launches = phase_train("bfloat16", batch=8)
    elapsed('phase_train("bfloat16", batch=8)')
    # the same with bench.py's --teacher-bf16 --moments bfloat16
    gc.collect()
    torch.cuda.empty_cache()
    opts_launches = phase_train("bfloat16", batch=8, options=True)
    elapsed('phase_train("bfloat16", batch=8, options=True)')
    gc.collect()
    torch.cuda.empty_cache()
    loop_launches = phase_loop()
    elapsed("phase_loop")
    # the other train types at the micro size (cs2dz; cs2dsec_image+events
    # with grad_clip), then the DarkZurich preset's step and run
    for variant in TRAIN_MICRO_VARIANTS:
        phase_train_micro(variant=variant)
        elapsed("phase_train_micro(variant=variant)")
    gc.collect()
    torch.cuda.empty_cache()
    dz_launches = phase_train(preset="cs2dz")
    elapsed('phase_train(preset="cs2dz")')
    gc.collect()
    torch.cuda.empty_cache()
    dz_loop_launches = phase_loop("cs2dz", backbone=CUT_BACKBONE)
    elapsed('phase_loop("cs2dz", backbone=CUT_BACKBONE)')
    gc.collect()
    torch.cuda.empty_cache()
    test_launches = phase_test()
    elapsed("phase_test")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as corpus_root:
        corpus = write_real_corpus(corpus_root)
        real_launches = phase_real_corpus(corpus)
        elapsed("phase_real_corpus(corpus)")
        isr_launches, isr_mix_launches = phase_isr_options(corpus)
        elapsed("phase_isr_options(corpus)")
    phase_pseudo_weight()
    elapsed("phase_pseudo_weight")
    uda_launches, lever_launches = phase_uda_options()
    elapsed("phase_uda_options")
    types_launches = phase_train_types()
    elapsed("phase_train_types")
    image_launches = phase_image_trainers()
    elapsed("phase_image_trainers")
    zoo_launches = phase_model_zoo()
    elapsed("phase_model_zoo")
    tools_launches = phase_tools()
    elapsed("phase_tools")
    for r in results:
        # the serving kernels keep their serving-path count under
        # "launches"; the training path's count goes beside it, and the
        # bfloat16 step's (3 steps, without and with the options) and the
        # training run's (8 iterations, 2 debug snapshots, 2 evaluations),
        # each also for cs2dz
        key = ("launches" if r["name"].startswith("fused_resize_ce")
               else "launches_train")
        r[key] = launches[r["name"]]
        r["launches_train_bf16"] = bf16_launches[r["name"]]
        r["launches_train_bf16_opts"] = opts_launches[r["name"]]
        r["launches_loop"] = loop_launches[r["name"]]
        r["launches_train_cs2dz"] = dz_launches[r["name"]]
        r["launches_loop_cs2dz"] = dz_loop_launches[r["name"]]
        r["launches_test"] = test_launches[r["name"]]
        r["launches_real_cs2dz"] = real_launches[r["name"]]
        r["launches_isr_options"] = isr_launches[r["name"]]
        r["launches_isr_options_mix"] = isr_mix_launches[r["name"]]
        r["launches_uda_options"] = uda_launches[r["name"]]
        r["launches_uda_levers"] = lever_launches[r["name"]]
        r["launches_train_types"] = types_launches[r["name"]]
        r["launches_image_trainers"] = image_launches[r["name"]]
        r["launches_model_zoo"] = zoo_launches[r["name"]]
        r["launches_tools"] = tools_launches[r["name"]]

    print(json.dumps({"kernels": results}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
