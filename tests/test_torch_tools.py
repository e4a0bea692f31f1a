"""The port's run-operations tools against the JAX package's, and the
model options of ROADMAP C4, on the CPU at micro sizes.

* C4: ``remat_policy='dots'`` gives the values of no remat and of full
  remat (loss and every gradient, 1e-6 of the largest; they come out
  bitwise), saves the linears' outputs (no ``mm`` / ``addmm`` recomputed in
  the backward, the attention's ``bmm`` recomputed), and the two
  ``lax.scan`` options raise from the trainer's check, the model build and
  the train CLI's ``--set``;
* the custom ops: ``torch.library.opcheck`` and ``torch.export`` of a small
  module that calls each;
* the tools: ``merge_segment_logs``, ``checkpoint_tools param-count``,
  ``print_config``, ``analyze_logs`` and ``analyze_trace`` against the JAX
  tools on the same inputs; ``train_chunked``'s horizon, seeds, watchdog
  and retries; the profiling utilities; each timing tool's ``main`` at
  one step; the exported CPU program against the JAX ``export_model``'s
  function on the same seeded weights (last: one JAX export compile).
"""
import argparse
import collections
import gzip
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax

from cmda_tpu import apis as japis
from cmda_tpu import config as JC
from cmda_tpu.models.segmentor import FusionEncoderDecoder as JFED
from cmda_tpu.uda import dacs as jdacs
from cmda_tpu_torch import apis as tapis
from cmda_tpu_torch import config as TC
from cmda_tpu_torch.models.common import init_weights
from cmda_tpu_torch.models.mit import MiTConfig, MixVisionTransformer
from cmda_tpu_torch.models.segmentor import (EncoderDecoder,
                                             FusionEncoderDecoder)
from cmda_tpu_torch.ops.fused_resize import fused_resize_argmax
from cmda_tpu_torch.ops.isr_kernel import batched_isr
from cmda_tpu_torch.tools import analyze_logs as tlogs
from cmda_tpu_torch.tools import analyze_trace as ttrace
from cmda_tpu_torch.tools import bench_ce, bench_infer, bench_scan
from cmda_tpu_torch.tools import checkpoint_tools as tckpt
from cmda_tpu_torch.tools import export_model as texport
from cmda_tpu_torch.tools import merge_segment_logs as tmerge
from cmda_tpu_torch.tools import print_config as tprint
from cmda_tpu_torch.tools import profile_step
from cmda_tpu_torch.tools import train as ttrain
from cmda_tpu_torch.tools import train_chunked as tchunk
from cmda_tpu_torch.uda.dacs import DACSTrainer
from cmda_tpu_torch.utils import profiling
from cmda_tpu_torch.utils.weights import load_jax_variables

from torch_port_util import assert_labels_match, random_variables

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tools import analyze_logs as jlogs  # noqa: E402
from tools import checkpoint_tools as jckpt  # noqa: E402
from tools import export_model as jexport  # noqa: E402
from tools import merge_segment_logs as jmerge  # noqa: E402
from tools import print_config as jprint  # noqa: E402
from tools.analyze_trace import (device_events_from_chrome,  # noqa: E402
                                 find_artifacts)

# the train CLI's tiny preset cut to the micro model (1 block a stage,
# 32x32 crops), logging every iteration, with a random_choice_thres ramp
MICRO_ARGV = ["--config", "tiny", "--synthetic", "--device", "cpu",
              "--num-workers", "1",
              "--set", "model.backbone=mit_micro",
              "--set", "model.head.in_channels=16,32,64,128",
              "--set", "model.head.embed_dim=32",
              "--set", "model.head.channels=32",
              "--set", "data.crop_size=32,32", "--set", "log_interval=1",
              "--set", "uda.random_choice_thres=0.2-0.8"]


# ---------------------------------------------------------------------------
# C4: remat_policy='dots' and the scan options
# ---------------------------------------------------------------------------

def _micro_fusion_grads(remat, policy):
    """Loss and gradients of one training forward of the micro fusion
    model at drop-path 0.3, from seeded weights, inputs and draws."""
    cfg = TC.micro_test_config()
    model = FusionEncoderDecoder(TC.replace(
        cfg.model, remat=remat, remat_policy=policy, drop_path_rate=0.3))
    init_weights(model, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    image = torch.randn(2, 32, 32, 3, generator=g)
    events = torch.randn(2, 32, 32, 3, generator=g)
    draws = model.new_draws(2, generator=torch.Generator().manual_seed(3),
                            device="cpu", with_isr=False)
    logits, _ = model.forward_train(image, events, None, "default", draws)
    loss = sum(v.float().square().mean() for v in logits.values()
               if v is not None)
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in model.named_parameters()
                           if p.grad is not None}


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_policy_keeps_loss_and_gradients(policy):
    """Drop-path's injected uniforms make the recompute see the same draws:
    the remat step equals the one without remat (and the dots one the full
    one) to 1e-6 of each gradient's largest."""
    loss0, g0 = _micro_fusion_grads(False, "full")
    loss1, g1 = _micro_fusion_grads(True, policy)
    assert g0.keys() == g1.keys() and len(g0) > 50
    assert float((loss1 - loss0).abs()) <= 1e-6 * float(loss0.abs())
    for k in g0:
        scale = float(g0[k].abs().max()) or 1.0
        assert float((g1[k] - g0[k]).abs().max()) <= 1e-6 * scale, k


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


def _backward_products(remat, policy):
    """{mm, addmm, bmm: calls in the backward} of a micro MiT encoder with
    bias-free q/kv (so its linears give both mm and addmm)."""
    mit = MixVisionTransformer(
        MiTConfig(embed_dims=(16, 32, 64, 128), num_heads=(1, 2, 4, 8),
                  depths=(1, 1, 1, 1), qkv_bias=False),
        remat=remat, remat_policy=policy)
    init_weights(mit, torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    u = [torch.rand(1, 2, 2, generator=torch.Generator().manual_seed(s))
         for s in range(4)]
    loss = sum(f.square().mean() for f in mit(x, u))
    with _OpCount() as count:
        loss.backward()
    aten = torch.ops.aten
    return {name: count.n[op] for name, op in (
        ("mm", aten.mm.default), ("addmm", aten.addmm.default),
        ("bmm", aten.bmm.default))}


def test_dots_policy_saves_the_linears_and_recomputes_bmm():
    """Against the backward without remat: 'dots' recomputes no mm / addmm
    (their outputs are saved) but recomputes the attention's bmm; 'full'
    recomputes all three."""
    base = _backward_products(False, "full")
    dots = {k: v - base[k] for k, v in _backward_products(True,
                                                          "dots").items()}
    full = {k: v - base[k] for k, v in _backward_products(True,
                                                          "full").items()}
    assert dots["mm"] == 0 and dots["addmm"] == 0 and dots["bmm"] > 0
    assert full["mm"] > 0 and full["addmm"] > 0 and full["bmm"] > 0


def test_fusion_encoders_take_the_policy():
    model = FusionEncoderDecoder(TC.replace(
        TC.micro_test_config().model, remat=True, remat_policy="dots"))
    assert model.backbone_image.remat_policy == "dots"
    assert model.backbone_events.remat_policy == "dots"
    # the JAX EncoderDecoder passes its encoder remat alone: full blocks
    single = EncoderDecoder(TC.replace(
        TC.micro_test_config().model, remat=True, remat_policy="dots"))
    assert single.backbone.remat_policy == "full"


@pytest.mark.parametrize("option", ["scan_split_transpose",
                                    "scan_unroll_short"])
def test_scan_options_raise(option, tmp_path):
    cfg = TC.micro_test_config()
    bad = TC.replace(cfg, model=TC.replace(cfg.model, **{option: True}))
    with pytest.raises(NotImplementedError, match=option):
        DACSTrainer._check_supported(bad)
    with pytest.raises(NotImplementedError, match=option):
        FusionEncoderDecoder(bad.model)
    with pytest.raises(NotImplementedError, match=option):
        ttrain.main(MICRO_ARGV + ["--max-iters", "1", "--work-dir",
                                  str(tmp_path), "--set",
                                  f"model.{option}=true"])


# ---------------------------------------------------------------------------
# the custom ops
# ---------------------------------------------------------------------------

OPCHECK_CASES = {
    "argmax_prob": (torch.ops.cmda_tpu_torch.fused_resize_argmax.default,
                    lambda g: (torch.randn(2, 4, 5, 7, generator=g), 8, 10,
                               True)),
    "argmax_no_prob": (torch.ops.cmda_tpu_torch.fused_resize_argmax.default,
                       lambda g: (torch.randn(1, 3, 3, 19, generator=g), 12,
                                  6, False)),
    "isr": (torch.ops.cmda_tpu_torch.batched_isr.default,
            lambda g: (torch.rand(2, 9, 11, generator=g) * 255,
                       torch.tensor([0, 3], dtype=torch.int32), 1.0, 256.0,
                       0.1, 0.5, 1)),
}


@pytest.mark.parametrize("case", sorted(OPCHECK_CASES))
def test_custom_op_opcheck(case):
    op, make = OPCHECK_CASES[case]
    result = torch.library.opcheck(op, make(torch.Generator().manual_seed(0)))
    assert all(v == "SUCCESS" for v in result.values()), result


class _ArgmaxNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(8, 8)
        self.b = torch.nn.Linear(8, 5)

    def forward(self, x):
        logits = self.b(torch.relu(self.a(x)))
        return fused_resize_argmax(logits, (8, 12))


class _IsrNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Conv2d(1, 4, 3, padding=1)
        self.b = torch.nn.Conv2d(4, 1, 1)

    def forward(self, x, d):
        gray = torch.sigmoid(self.b(torch.relu(self.a(x))))[:, 0] * 255
        return batched_isr(gray.contiguous(), d, val_range=(1, 256),
                           threshold=0.1, clip_range=0.5)


@pytest.mark.parametrize("which", ["fused_resize_argmax", "batched_isr"])
def test_export_keeps_the_custom_op(which):
    g = torch.Generator().manual_seed(4)
    if which == "fused_resize_argmax":
        mod, args = _ArgmaxNet(), (torch.randn(2, 4, 4, 8, generator=g),)
    else:
        mod, args = _IsrNet(), (torch.randn(2, 1, 10, 12, generator=g),
                                torch.tensor([1, 2], dtype=torch.int32))
    with torch.no_grad():
        program = torch.export.export(mod.eval(), args)
        want = mod(*args)
        got = program.module()(*args)
    assert f"cmda_tpu_torch.{which}" in str(program.graph)
    for a, b in zip(torch.utils._pytree.tree_leaves(want),
                    torch.utils._pytree.tree_leaves(got)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["fused_resize_argmax", "batched_isr"])
def test_eager_calls_skip_the_op_dispatch(which, monkeypatch):
    """An eager call on a plain tensor runs the op's implementation
    directly; under a dispatch mode (as under tracing) the wrapper calls
    the op, which gives the same outputs."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from cmda_tpu_torch.ops import fused_resize, isr_kernel
    g = torch.Generator().manual_seed(6)
    if which == "fused_resize_argmax":
        table = fused_resize._ARGMAX_IMPLS
        x = torch.randn(1, 3, 3, 5, generator=g)

        def run():
            return fused_resize_argmax(x, (6, 6))
    else:
        table = isr_kernel._ISR_IMPLS
        x = torch.rand(1, 6, 7, generator=g) * 255

        def run():
            return batched_isr(x, torch.tensor([2], dtype=torch.int32),
                               val_range=(1, 256), threshold=0.1,
                               clip_range=0.5)
    direct, real = [], table["cpu"]
    monkeypatch.setitem(table, "cpu",
                        lambda *a: direct.append(1) or real(*a))
    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))
    eager = run()
    assert direct == [1] and not seen
    with Ops():
        dispatched = run()
    assert direct == [1]
    assert f"cmda_tpu_torch.{which}.default" in seen
    for a, b in zip(torch.utils._pytree.tree_leaves(eager),
                    torch.utils._pytree.tree_leaves(dispatched)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# logs, configs, checkpoints and traces against the JAX tools
# ---------------------------------------------------------------------------

def _write_jsonl(path, records):
    path.write_text("".join(json.dumps(r) + "\n" for r in records))


def test_merge_segment_logs_matches_jax(tmp_path):
    """Two segments, the second a replay from iteration 2 that goes on to
    4, an evaluation at 2 in both: the port merges as the JAX tool does."""
    wd = tmp_path / "run"
    wd.mkdir()
    head = {"env": {"torch": "x"}, "config": "micro", "max_iters": 4}
    _write_jsonl(wd / "20260101_000000.log.json", [
        head, {"loss": 3.0, "lr": 1e-5, "iter": 1, "time": 1.0},
        {"loss": 2.5, "lr": 2e-5, "iter": 2, "time": 1.0},
        {"iter": 2, "eval": {"mIoU": 0.1}},
        {"loss": 9.9, "lr": 3e-5, "iter": 3, "time": 1.0}])
    _write_jsonl(wd / "20260101_000100.log.json", [
        {**head, "env": {"torch": "y"}},
        {"loss": 2.4, "lr": 3e-5, "iter": 3, "time": 1.1},
        {"iter": 2, "eval": {"mIoU": 0.2}},
        {"loss": 2.2, "lr": 4e-5, "iter": 4, "time": 1.2}])
    ours = tmerge.merge(str(wd))
    assert ours == jmerge.merge(str(wd))
    assert ours[0]["env"] == {"torch": "x"}
    assert [r.get("loss") for r in ours[1:]] == [3.0, 2.5, None, 2.4, 2.2]
    out = tmp_path / "merged.log.json"
    tmerge.main([str(wd), str(out)])
    assert [json.loads(line) for line in out.read_text().splitlines()] == ours


def test_param_count_matches_jax(monkeypatch):
    """The JAX tool's per-module counts of the micro preset (its
    ``init_state`` replaced by the variables' shapes: the counting is the
    tool's, nothing is compiled) equal the port's."""
    micro = JC.micro_test_config()
    monkeypatch.setattr(JC, "tiny_test_config", lambda: micro)

    def shapes_only(self, rng):
        x = np.zeros((1, 32, 32, 3), np.float32)
        jm = JFED(micro.model)
        return SimpleNamespace(params=jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), x, x, x, mode="fusion_all",
            method=jm.forward_logits))["params"])
    monkeypatch.setattr(jdacs.DACSTrainer, "init_state", shapes_only)
    assert tckpt.param_count("micro") == jckpt.param_count("tiny")


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = json.loads(json.dumps(v, default=str))
    return out


# argv -> the fields whose values differ, and why: the JAX CLI applies
# --teacher-bf16 in its main, after build_config, so the JAX print_config
# does not show it; the port's build_config applies it
PRINT_CONFIG_ARGV = {
    "cs2dsec": (["--config", "cs2dsec"], set()),
    "cs2dz_set": (["--config", "cs2dz", "--set", "optim.lr=1e-4",
                   "--set", "uda.alpha=0.99"], set()),
    "ablations": (["--config", "cs2dsec", "--events_bins_5_avg_1",
                   "--fusion", "caf", "--no_share_decoder",
                   "--random_choice_thres", "0.2-0.8", "--without_isd"],
                  set()),
    "tiny_bf16": (["--config", "tiny", "--max-iters", "7", "--dtype",
                   "bfloat16", "--shift_3_channel", "--isr_noise_dacs_type",
                   "noise+blur", "--teacher-bf16"], {"uda.teacher_bf16"}),
}


@pytest.mark.parametrize("case", sorted(PRINT_CONFIG_ARGV))
def test_print_config_matches_jax(case, tmp_path, capsys):
    argv, differ = PRINT_CONFIG_ARGV[case]
    ours = _flat(tprint.resolved_config_dict(argv)[0])
    theirs = _flat(jprint.resolved_config_dict(argv)[0])
    common = set(ours) & set(theirs)
    assert len(common) > 100 and common == set(ours) == set(theirs)
    assert {k for k in common if ours[k] != theirs[k]} == differ
    dump = tmp_path / "cfg.json"
    text = tprint.main(argv + ["--dump", str(dump)])
    assert json.loads(dump.read_text()) == json.loads(text)


@pytest.fixture()
def fake_log(tmp_path):
    path = tmp_path / "x.log.json"
    _write_jsonl(path, [
        {"env": {}, "config": "micro", "max_iters": 10},
        {"loss": 5.0, "lr": 1e-6, "iter": 1, "time": 30.0,
         "data_time": 0.2},
        {"loss": 4.0, "lr": 2e-6, "iter": 2, "time": 1.0, "data_time": 0.1},
        {"loss": 3.5, "lr": 3e-6, "iter": 3, "time": 1.2, "data_time": 0.1},
        {"iter": 4, "eval": {"mIoU": 0.42, "aAcc": 0.8}}])
    return str(path)


def test_analyze_logs_matches_jax(fake_log, capsys):
    ours, theirs = tlogs.load_log(fake_log), jlogs.load_log(fake_log)
    assert ours == theirs
    for key in ("loss", "lr", "mIoU", "aAcc", "missing"):
        assert tlogs.series(ours, key) == jlogs.series(theirs, key)
    assert tlogs.cal_train_time(fake_log) == jlogs.cal_train_time(fake_log)
    assert tlogs.main(["cal_train_time", fake_log])["n_records"] == 3


def test_plot_curve_needs_matplotlib_only_when_called(fake_log, tmp_path,
                                                      monkeypatch):
    out = tlogs.plot_curve([fake_log], ["loss", "mIoU"],
                           out=str(tmp_path / "c.png"))
    assert os.path.getsize(out) > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tlogs.plot_curve([fake_log], ["loss"], out=str(tmp_path / "d.png"))
    assert tlogs.series(tlogs.load_log(fake_log), "loss")[0] == [1, 2, 3]


def test_analyze_trace_groups_as_the_jax_tool(tmp_path, capsys):
    """The JAX test's synthetic trace (tests/test_misc_utils.py): device
    lane kept, host thread dropped, fusion.1 / fusion.2 grouped."""
    run = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    run.mkdir(parents=True)
    events = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 2,
         "args": {"name": "python host thread"}},
        {"ph": "X", "pid": 1, "name": "fusion.1", "dur": 100.0, "ts": 0},
        {"ph": "X", "pid": 1, "name": "fusion.2", "dur": 50.0, "ts": 1},
        {"ph": "X", "pid": 1, "name": "while", "dur": 400.0, "ts": 2},
        {"ph": "X", "pid": 2, "name": "python_call", "dur": 999.0, "ts": 3},
    ]
    with gzip.open(run / "vm.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    theirs = list(device_events_from_chrome(events))
    ours = ttrace.device_events(ttrace.load_chrome_events(
        ttrace.find_traces(str(tmp_path))[0]))
    assert [(n, d) for n, _, d in ours] == theirs
    assert find_artifacts(str(tmp_path))[0]
    groups = ttrace.group(ours)
    assert groups == {"while": (400.0, 1), "fusion": (150.0, 2)}
    s = ttrace.main([str(tmp_path), "--top", "5"])
    assert s["lane"] == "device" and s["top"][0]["name"] == "while"
    # 0-100, 1-51 and 2-402 overlap into 0-402 of the 0-1002 window
    assert s["busy_ms"] == pytest.approx(0.402)
    assert s["busy_share"] == pytest.approx(402 / 1002)


def test_analyze_trace_reads_a_profiler_trace(tmp_path, capsys):
    """``utils.profiling.trace`` on the CPU: a chrome trace that
    analyze_trace reads (CPU ops, no device lane), and a kernel-category
    event added to it counts as device time."""
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            a = torch.tanh(a @ a)
    path = tmp_path / profiling.TRACE_FILE
    s = ttrace.main([str(path), "--top", "3"])
    assert s["lane"] == "host" and s["top"] and 0 < s["busy_share"] <= 1
    data = json.loads(path.read_text())
    start = min(e["ts"] for e in data["traceEvents"] if e.get("ph") == "X")
    data["traceEvents"].append({"ph": "X", "cat": "kernel", "pid": 0,
                                "name": "gemm_kernel", "ts": start,
                                "dur": 5.0})
    (tmp_path / "gz").mkdir()
    with gzip.open(tmp_path / "gz" / "t.json.gz", "wt") as f:
        json.dump(data, f)
    s = ttrace.main([str(tmp_path / "gz")])
    assert s["lane"] == "device" and s["top"][0]["name"] == "gemm_kernel"
    assert s["busy_ms"] == pytest.approx(0.005)


def test_profiling_utilities():
    timer = profiling.timed(lambda: {"x": torch.ones(3)}, steps=3, warmup=1)
    s = timer.summary()
    assert s["steps"] == 3 and s["min_s"] <= s["p50_s"] <= s["max_s"]
    assert profiling.StepTimer().summary() == {}
    assert profiling.device_memory_stats("cpu") == {}
    assert profiling.device_info("cpu")["power_limit"] is None


# ---------------------------------------------------------------------------
# the segmented run
# ---------------------------------------------------------------------------

def _in_process(calls):
    """A ``run_segment`` that runs the segment's train CLI in this process
    and records its command line."""
    def run(cmd, work_dir, stall_timeout):
        calls.append(cmd)
        assert cmd[1:3] == ["-m", tchunk.TRAIN_MODULE]
        ttrain.main(cmd[3:])
        return 0
    return run


def _steps(work_dir):
    return [r for r in tmerge.merge(str(work_dir)) if "loss" in r]


SCHEDULE_KEYS = ("lr", "random_choice_thres")


@pytest.fixture(scope="module")
def chunked_runs(tmp_path_factory):
    """A 4-iteration micro run unbroken, in 2 segments, and in 2 segments
    with the JAX launcher's horizon (no optim.max_iters pinned)."""
    root = tmp_path_factory.mktemp("chunked")
    mp = pytest.MonkeyPatch()
    try:
        ttrain.main(MICRO_ARGV + ["--max-iters", "4", "--seed", "3",
                                  "--work-dir", str(root / "unbroken")])
        calls = []
        mp.setattr(tchunk, "run_segment", _in_process(calls))
        assert tchunk.main(["--segment-iters", "2", "--max-iters", "4",
                            "--seed", "3", "--work-dir", str(root / "seg")]
                           + MICRO_ARGV) == 0
        jax_calls = []
        port_command = tchunk.segment_command

        def jax_horizon(args, passthrough, start, ckpt):
            cmd = port_command(args, passthrough, start, ckpt)
            i = cmd.index(f"optim.max_iters={args.max_iters}")
            return cmd[:i - 1] + cmd[i + 1:]
        mp.setattr(tchunk, "segment_command", jax_horizon)
        mp.setattr(tchunk, "run_segment", _in_process(jax_calls))
        assert tchunk.main(["--segment-iters", "2", "--max-iters", "4",
                            "--seed", "3", "--work-dir", str(root / "jax")]
                           + MICRO_ARGV) == 0
    finally:
        mp.undo()
    return root, calls, jax_calls


def test_chunked_run_keeps_one_horizon(chunked_runs):
    """The LR (its warmup too: the tiny preset warms up over 10 of its
    iterations) and the random_choice_thres ramp of the 2-segment run equal
    the unbroken run's at every iteration; under the JAX launcher's
    horizon they do not (the sawtooth), so the check can see it."""
    root, _, _ = chunked_runs
    unbroken, seg, jax_seg = (_steps(root / d)
                              for d in ("unbroken", "seg", "jax"))
    assert [r["iter"] for r in unbroken] == [1, 2, 3, 4]
    assert [r["iter"] for r in seg] == [1, 2, 3, 4]
    for a, b in zip(unbroken, seg, strict=True):
        assert {k: a[k] for k in SCHEDULE_KEYS} == {
            k: b[k] for k in SCHEDULE_KEYS}, a["iter"]
    assert unbroken[1]["lr"] > 0 and unbroken[2]["random_choice_thres"] == 0.5
    assert any(a[k] != b[k] for a, b in zip(unbroken, jax_seg)
               for k in SCHEDULE_KEYS)


def test_chunked_run_seeds_and_resumes_as_the_jax_launcher(chunked_runs):
    """Segment i gets --seed (the run's seed + i), as the JAX launcher's
    ``--seed args.seed + seg_idx`` (tools/train_chunked.py:111): each
    segment's loader draws a fresh sample stream. The second resumes from
    the first's last checkpoint, an ``iter_<n>.pth``."""
    root, calls, _ = chunked_runs

    def flag(cmd, name):
        return cmd[cmd.index(name) + 1]
    assert [flag(c, "--seed") for c in calls] == ["3", "4"]
    assert [flag(c, "--max-iters") for c in calls] == ["2", "4"]
    assert "--resume-from" not in calls[0]
    assert flag(calls[1], "--resume-from") == str(root / "seg" / "iter_2.pth")
    assert all(c[-2:] == ["--set", "optim.max_iters=4"]
               or c[-4:-2] == ["--set", "optim.max_iters=4"] for c in calls)
    assert tchunk.latest_checkpoint(str(root / "seg")) == (
        str(root / "seg" / "iter_4.pth"), 4)
    assert tchunk.latest_checkpoint(str(root / "missing")) == (None, 0)


def test_watchdog_kills_a_stalled_segment(tmp_path):
    sleeper = [sys.executable, "-c", "import time; time.sleep(60)"]
    assert tchunk.run_segment(sleeper, str(tmp_path), 0.5) == 99
    writer = [sys.executable, "-c", (
        "import time\n"
        "for i in range(6):\n"
        f"    open({str(tmp_path / 'a.log.json')!r}, 'a').write('x')\n"
        "    time.sleep(0.2)\n")]
    assert tchunk.run_segment(writer, str(tmp_path), 1.0) == 0


def test_chunked_retries_and_gives_up(tmp_path, monkeypatch):
    """A segment that fails without checkpoint progress is retried
    --max-stuck-retries times, then its rc is returned; one that fails
    after writing a checkpoint goes on from it."""
    calls, sleeps = [], []

    def failing(cmd, work_dir, stall_timeout):
        calls.append(cmd)
        return 3
    monkeypatch.setattr(tchunk, "run_segment", failing)
    monkeypatch.setattr(tchunk.time, "sleep", sleeps.append)
    rc = tchunk.main(["--segment-iters", "2", "--max-iters", "4",
                      "--work-dir", str(tmp_path / "a"),
                      "--max-stuck-retries", "2"])
    assert rc == 3 and len(calls) == 3
    assert sleeps == [tchunk.RETRY_BACKOFF_S] * 2
    wd = tmp_path / "b"
    wd.mkdir()

    def progress(cmd, work_dir, stall_timeout):
        end = int(cmd[cmd.index("--max-iters") + 1])
        (wd / f"iter_{end}.pth").write_bytes(b"")
        return 1 if end == 2 else 0
    monkeypatch.setattr(tchunk, "run_segment", progress)
    assert tchunk.main(["--segment-iters", "2", "--max-iters", "4",
                        "--work-dir", str(wd)]) == 0


def test_checkpoint_tools_on_a_run_checkpoint(chunked_runs, tmp_path):
    """publish drops AdamW, the teacher and nothing of the student; convert
    keeps the student alone; both load into a segmentor equal to the run's
    student. rename-work-dirs scores a work dir."""
    root, _, _ = chunked_runs
    src = str(root / "seg" / "iter_4.pth")
    ckpt = torch.load(src, weights_only=True)
    pub = tckpt.publish(src, str(tmp_path / "pub.pth"))
    assert Path(pub).name.startswith("pub-") and pub.endswith(".pth")
    assert tckpt.publish(src, str(tmp_path / "pub.pth")) == pub
    got = torch.load(pub, weights_only=True)
    assert set(got) == {"state_dict", "step", "meta"} and got["step"] == 4
    conv = tckpt.convert(src, str(tmp_path / "student.pth"))
    assert set(torch.load(conv, weights_only=True)) == {"state_dict"}
    cfg = ttrain.build_config(ttrain.parse_args(MICRO_ARGV))
    for path in (pub, conv):
        seg = tapis.init_segmentor(cfg, path, device="cpu")
        for k, t in seg.model.state_dict().items():
            assert torch.equal(t, ckpt["state_dict"][k]), k
    runs = tmp_path / "work_dirs"
    (runs / "r1" / "test_results_2_10.50").mkdir(parents=True)
    (runs / "r1" / "test_results_40_61.25").mkdir()
    assert tckpt.main(["rename-work-dirs", "--root", str(runs)]) == [
        str(runs / "r1[61.25]")]


# ---------------------------------------------------------------------------
# the timing tools' main at one step
# ---------------------------------------------------------------------------

def test_bench_infer_main(monkeypatch, capsys):
    monkeypatch.setitem(bench_infer.SLIDE, "frame", (48, 80))
    monkeypatch.setitem(bench_infer.SLIDE, "crop", (32, 32))
    monkeypatch.setitem(bench_infer.SLIDE, "stride", (21, 21))
    out = bench_infer.main(["--config", "micro", "--device", "cpu",
                            "--batch", "2", "--steps", "1", "--height",
                            "32", "--width", "32", "--slide"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("batch1_ms", "batch2_ms", "batch1_samples_per_s",
              "batch2_samples_per_s", "slide_48x80_ms", "slide_48x80_fps",
              "device", "argmax_launches_per_call"):
        assert k in printed and k in out
    assert printed["argmax_launches_per_call"] == 0   # the CPU: no kernel


def test_bench_ce_main(capsys):
    out = bench_ce.main(["--device", "cpu", "--batch", "1", "--h", "8",
                         "--w", "6", "--iters", "1"])
    assert json.loads(capsys.readouterr().out.strip()) == json.loads(
        json.dumps(out))
    assert out["loss_diff"] == 0 and out["max_abs_dx_diff"] == 0
    assert out["launches"] == dict.fromkeys(bench_ce.KERNELS, 0)
    assert out["plain_ms"] > 0 and out["fused_ms"] > 0


def test_bench_scan_main_and_refusals(capsys):
    out = bench_scan.main(["--device", "cpu", "--batch", "1", "--tokens",
                           "64", "--dim", "16", "--depth", "2", "--heads",
                           "2", "--steps", "1"])
    for k in ("fwd_ms", "grad_none_ms", "grad_full_ms", "grad_dots_ms",
              "grad_dots_peak_gib"):
        assert k in out
    for flag in (["--unrolls", "1,2"], ["--split-transpose", "1"]):
        with pytest.raises(SystemExit):
            bench_scan.main(["--device", "cpu"] + flag)
        assert "C4" in capsys.readouterr().err


def test_profile_step_main(tmp_path, capsys):
    out = profile_step.main(["--config", "micro", "--device", "cpu",
                             "--batch", "2", "--steps", "1", "--trace",
                             str(tmp_path)])
    for k in ("cyclegan_day_events_s", "teacher_forward_s", "mixed_isr_s",
              "student_fwd_bwd_s", "mixed_fwd_bwd_s", "step_s",
              "sum_components_s", "step_launches"):
        assert k in out
    assert out["dtype"] == "bfloat16"
    assert (tmp_path / profiling.TRACE_FILE).exists()


# ---------------------------------------------------------------------------
# the serving artifact (last: one JAX export compile)
# ---------------------------------------------------------------------------

def test_export_refuses_cuda_without_a_gpu(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        texport.main(["export", str(tmp_path / "a"), "--config", "micro",
                      "--height", "32", "--width", "32", "--platforms",
                      "cuda", "--device", "cpu"])


def test_exported_program_matches_jax_export(tmp_path, monkeypatch,
                                             capsys):
    """The port's CPU artifact (exported from a checkpoint of seeded
    weights, --verify against the eager model) against the JAX
    export_model's artifact of the same weights: logits to 1e-4, labels
    equal except where the top-2 logits are within 1e-5."""
    jcfg = JC.micro_test_config()
    jm = JFED(jcfg.model)
    x = np.zeros((1, 64, 64, 3), np.float32)
    v = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), x, x, x, mode="fusion_all",
        method=jm.forward_logits), seed=13)
    jseg = japis.Segmentor(jcfg, SimpleNamespace(
        params=v["params"], ema_params=v["params"],
        batch_stats=v["batch_stats"]), output="fusion")
    monkeypatch.setattr(japis, "init_segmentor", lambda *a, **k: jseg)
    jart = str(tmp_path / "jax_artifact")
    jexport.build_export(argparse.Namespace(
        artifact=jart, config="micro", checkpoint=None,
        torch_checkpoint=None, output=None, image_only=False, batch=1,
        height=64, width=64, platforms="cpu", set=None, verify=False))

    model = tapis.build_model(TC.micro_test_config(), "cpu")
    load_jax_variables(model, v)
    ckpt = str(tmp_path / "iter_1.pth")
    torch.save({"state_dict": model.state_dict()}, ckpt)
    art = str(tmp_path / "artifact")
    report = texport.main(["export", art, "--config", "micro",
                           "--checkpoint", ckpt, "--height", "64",
                           "--width", "64", "--platforms", "cpu",
                           "--device", "cpu", "--verify"])
    assert report["verify"]["max_abs_logit_diff"] <= 1e-4
    meta = json.loads((Path(art) / "meta.json").read_text())
    assert meta["framework"] == "cmda_tpu_torch"
    assert meta["custom_ops"] == ["cmda_tpu_torch.fused_resize_argmax"]
    assert meta["input_shape"] == [1, 64, 64, 3] and meta["num_classes"] == 19
    assert "cmda_tpu_torch.fused_resize_argmax" in str(
        torch.export.load(texport.program_path(art, "cpu")).graph)

    g = np.random.default_rng(21)
    image, second = (g.normal(size=(1, 64, 64, 3)).astype(np.float32)
                     for _ in range(2))
    jlogits, jpred = (np.asarray(a) for a in jexport.load_and_call(
        jart, image, second))
    with torch.no_grad():
        logits, pred = texport.load_program(art, "cpu")(
            torch.from_numpy(image), torch.from_numpy(second))
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4, rtol=0)
    assert pred.dtype == torch.int32
    assert_labels_match(pred.numpy(), jpred, jlogits, 1e-5)
    run = texport.main(["run", art, "--device", "cpu"])
    assert run["logits_shape"] == [1, 64, 64, 19] and run["logits_finite"]
    assert run["custom_ops"] == ["cmda_tpu_torch.fused_resize_argmax"]
    # the CPU program runs the plain version: no kernel launch
    assert run["argmax_launches_per_call"] == [0] * (1 + texport.RUN_REPS)
