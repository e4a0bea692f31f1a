"""The port's training run on the CPU: loader, wire format, debug snapshot,
visualization, TrainLoop, checkpoints and the train CLI.

Against the JAX package (bitwise, from the same seeded numpy data):
``collate`` and ``PrefetchLoader`` over the same ``UDAPairDataset`` (with a
stride-0 mono stream, and with Rare Class Sampling), ``encode_wire`` /
``decode_wire`` packed and unpacked, and the visualization helpers. The
rest holds the port against itself: ``debug_tensors`` leaves the state
bitwise unchanged and equals ``_prepare`` on a deep copy; a 4-iteration
``TrainLoop`` logs exactly the losses of ``train_step`` called on the same
loader batches (so its debug snapshots and evaluations change nothing);
a checkpoint loads back bitwise and steps as the live state does.

No JAX DACS step is compiled. The step runs the micro config at 64x64 (at
32x32 the dilated ASPP's BatchNorm amplifies float32 noise), the CLI the
tiny config.
"""
import copy
import json
import os
import random

import numpy as np
import pytest
import torch

from cmda_tpu.data import loader as jloader
from cmda_tpu.data import synthetic as jsyn
from cmda_tpu.data import uda as juda
from cmda_tpu.data import wire as jwire
from cmda_tpu.utils import visualization as jvis
from cmda_tpu_torch import config as TC
from cmda_tpu_torch.data import loader as tloader
from cmda_tpu_torch.data import synthetic as tsyn
from cmda_tpu_torch.data import uda as tuda
from cmda_tpu_torch.data import wire as twire
from cmda_tpu_torch.data.synthetic import uda_batch
from cmda_tpu_torch.models.cyclegan import ResnetGenerator, init_generator
from cmda_tpu_torch.models.mit import MIT_VARIANTS, MixVisionTransformer
from cmda_tpu_torch.tools import train as tcli
from cmda_tpu_torch.train.loop import (TrainLoop, evaluate_fusion,
                                       load_checkpoint, save_checkpoint)
from cmda_tpu_torch.uda.dacs import DACSTrainer
from cmda_tpu_torch.utils import visualization as tvis

HW = (64, 64)


class MonoSource:
    """A source whose ``img_self_res`` is a stride-0 broadcast of one
    channel, as the real datasets ship mono streams."""

    def __init__(self, base):
        self.base = base
        self.files = base.files

    def __len__(self):
        return len(self.base)

    def load(self, idx, rng=None):
        out = self.base.load(idx, rng=rng)
        isr = out["img_self_res"]
        out["img_self_res"] = np.broadcast_to(isr[..., :1], isr.shape)
        return out


def _pairs(pkg_uda, rcs=None):
    src = MonoSource(jsyn.SyntheticSource(crop_size=(16, 12), length=12))
    tgt = jsyn.SyntheticTarget(crop_size=(16, 12), length=9)
    return pkg_uda.UDAPairDataset(src, tgt, seed=3, **(rcs or {}))


def _assert_tree_equal(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _assert_tree_equal(got[k], ref[k], f"{path}/{k}")
        return
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, path
    np.testing.assert_array_equal(got, ref, err_msg=path)


def test_collate_keeps_mono_streams_mono():
    ds = _pairs(tuda)
    samples = [ds.load(i, rng=random.Random(i)) for i in range(3)]
    got = tloader.collate(samples)
    ref = jloader.collate(samples)
    _assert_tree_equal(got, ref)
    assert got["source"]["img_self_res"].strides[-1] == 0
    assert got["source"]["image"].flags.c_contiguous


@pytest.mark.parametrize("rcs", [False, True], ids=["plain", "rcs"])
def test_prefetch_loader_same_batches_as_jax(rcs, tmp_path):
    """The first 6 batches of both loaders at num_workers=2, bitwise; with
    RCS from the two JSON files of the reference's preprocessing."""
    kw = None
    if rcs:
        src = jsyn.SyntheticSource(crop_size=(16, 12), length=12)
        swc = {str(c): [[src.files[i].replace("_leftImg8bit.png",
                                              "_gtFine_labelTrainIds.png"),
                         5000]
                        for i in range(12) if (i + c) % 3 == 0]
               for c in range(19)}
        stats = {f: {str(c): 100 * (c + 1) for c in range(i % 19)}
                 for i, f in enumerate(src.files)}
        (tmp_path / "swc.json").write_text(json.dumps(swc))
        (tmp_path / "stats.json").write_text(json.dumps(stats))
        kw = dict(rcs=True, samples_with_class=str(tmp_path / "swc.json"),
                  sample_class_stats=str(tmp_path / "stats.json"),
                  min_pixels=3000)
        classes, probs = tuda.rcs_class_probs(str(tmp_path / "stats.json"))
        jc, jp = juda.rcs_class_probs(str(tmp_path / "stats.json"))
        np.testing.assert_array_equal(classes, jc)
        np.testing.assert_array_equal(probs, jp)
    loaders = [pkg.PrefetchLoader(_pairs(u, kw), 2, num_workers=2, seed=5)
               for pkg, u in ((tloader, tuda), (jloader, juda))]
    try:
        for _ in range(6):
            got, ref = (next(ld) for ld in loaders)
            _assert_tree_equal(got, ref)
            assert got["source"]["img_self_res"].strides[-1] == 0
    finally:
        for ld in loaders:
            ld.close()
    assert not any(w.is_alive() for w in loaders[0].workers)


def test_prefetch_loader_raises_a_failed_sample():
    class Broken:
        def __len__(self):
            return 4

        def load(self, idx, rng=None):
            raise OSError(f"sample {idx} unreadable")

    ld = tloader.PrefetchLoader(Broken(), 2, num_workers=1, seed=0)
    try:
        with pytest.raises(OSError, match="unreadable"):
            next(ld)
    finally:
        ld.close()


def _wire_batch():
    ds = _pairs(tuda)
    return tloader.collate([ds.load(i, rng=random.Random(i))
                            for i in range(2)])


def _bits(x):
    """bf16 leaves as their 16-bit patterns, everything else as is."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16).numpy().view(np.uint16)
                if x.dtype == torch.bfloat16 else x.numpy())
    x = np.asarray(x)
    return x.view(np.uint16) if str(x.dtype) == "bfloat16" else x


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "unpacked"])
def test_wire_encode_decode_bitwise_as_jax(pack):
    batch = _wire_batch()
    got, ref = twire.encode_wire(batch, pack), jwire.encode_wire(batch, pack)
    flat = {}

    def walk(g, r, path):
        assert set(g) == set(r), path
        for k in r:
            if isinstance(r[k], dict):
                walk(g[k], r[k], f"{path}/{k}")
            else:
                flat[f"{path}/{k}"] = (_bits(g[k]), _bits(r[k]))
    walk(got, ref, "")
    assert any("mono::3::img_self_res" in k or ">3" in k for k in flat)
    for k, (g, r) in flat.items():
        assert g.dtype == r.dtype and g.shape == r.shape, k
        np.testing.assert_array_equal(g, r, err_msg=k)

    dec = twire.decode_wire(got)
    jdec = jwire.decode_wire(ref)
    _assert_tree_equal({k: {n: t.numpy() for n, t in v.items()}
                        for k, v in dec.items()},
                       {k: {n: np.asarray(t) for n, t in v.items()}
                        for k, v in jdec.items()})
    for part in dec.values():
        assert all(t.is_contiguous() for t in part.values())
    lbl = dec["source"]["label"]
    assert lbl.dtype == torch.int32
    np.testing.assert_array_equal(lbl.numpy(), batch["source"]["label"])
    assert (lbl == 255).any()


def test_decode_passes_an_unencoded_batch_through():
    batch = {k: {n: torch.from_numpy(np.ascontiguousarray(v))
                 for n, v in part.items()}
             for k, part in _wire_batch().items()}
    out = twire.decode_wire(batch)
    for k, part in batch.items():
        for n, t in part.items():
            assert out[k][n] is t, (k, n)


def test_visualization_helpers_match_jax(tmp_path):
    g = np.random.default_rng(4)
    label = g.integers(0, 19, (12, 16)).astype(np.int32)
    label[:2] = 255
    img = g.normal(size=(12, 16, 3)).astype(np.float32)
    sig = np.clip(g.normal(size=(12, 16, 3)), -1, 1).astype(np.float32)
    for f, args in (("colorize_label", (label,)),
                    ("denorm_to_uint8", (img,)),
                    ("signed_to_uint8", (sig,)),
                    ("signed_to_uint8", (sig[..., 0],))):
        np.testing.assert_array_equal(getattr(tvis, f)(*args),
                                      getattr(jvis, f)(*args), err_msg=f)
    np.testing.assert_array_equal(tvis.CITYSCAPES_PALETTE,
                                  jvis.CITYSCAPES_PALETTE)
    rows = [[tvis.colorize_label(label), tvis.denorm_to_uint8(img[:8])],
            [tvis.signed_to_uint8(sig[..., 0]), tvis.colorize_label(label)]]
    np.testing.assert_array_equal(tvis.grid_panel(rows), jvis.grid_panel(rows))
    out = str(tmp_path / "p" / "000000.png")
    panel = tvis.show_result(img, label, gt=label, events=sig, out_path=out)
    np.testing.assert_array_equal(
        panel, jvis.show_result(img, label, gt=label, events=sig))
    from PIL import Image
    np.testing.assert_array_equal(np.asarray(Image.open(out)), panel)


# ---------------------------------------------------------------------------
# the step's debug snapshot, the loop, checkpoints
# ---------------------------------------------------------------------------

def _micro_cfg(**kw):
    cfg = TC.micro_test_config()
    return TC.replace(
        cfg, data=TC.replace(cfg.data, crop_size=HW, workers=2),
        optim=TC.replace(cfg.optim, max_iters=4, warmup_iters=2), **kw)


def _state_arrays(state):
    """Every tensor of a train state (student, teacher, AdamW) and the
    step, cloned."""
    out = {f"model/{k}": v.clone()
           for k, v in state.model.state_dict().items()}
    out.update({f"ema/{k}": v.clone()
                for k, v in state.ema_model.state_dict().items()})
    names = {p: k for k, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            out[f"opt/{names[p]}/{k}"] = v.clone()
    out["step"] = torch.tensor(state.step)
    return out


def _assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].device == b[k].device, k
        assert torch.equal(a[k], b[k]), k


def _uda(cfg, length=16):
    src = tsyn.SyntheticSource(crop_size=cfg.data.crop_size, length=length)
    tgt = tsyn.SyntheticTarget(crop_size=cfg.data.crop_size, length=length)
    return src, tgt


def test_debug_tensors_leaves_state_unchanged():
    cfg = _micro_cfg()
    trainer = DACSTrainer(cfg, device="cpu")
    state = trainer.init_state()
    src, tgt = _uda(cfg)
    # one step first, so that the EMA moves the teacher
    trainer.train_step(state, uda_batch(src, tgt, [0, 1]))
    batch = twire.encode_wire(uda_batch(src, tgt, [2, 3]))
    before = _state_arrays(state)
    ref_state = copy.deepcopy(state)
    dbg = trainer.debug_tensors(state, batch)
    _assert_states_equal(_state_arrays(state), before)
    draws = trainer.new_draws(ref_state, 2)
    P = trainer._prepare(ref_state, trainer._device_batch(batch), draws,
                         ref_state.ema_model)
    assert set(dbg) <= set(P)
    for k, v in dbg.items():
        assert torch.equal(v, P[k]), k
    assert not torch.equal(dbg["mixed_img"], dbg["day_image"])


@pytest.fixture(scope="module")
def loop_run(tmp_path_factory):
    """A 4-iteration TrainLoop of the micro config on the CPU: log every
    iteration, checkpoint, evaluate and dump debug grids every 2, keep one
    checkpoint; wire format and device prefetch as the flagship."""
    cfg = _micro_cfg(log_interval=1, checkpoint_interval=2, eval_interval=2,
                     debug_img_interval=2, checkpoint_max_keep=1)
    assert cfg.data.wire_bf16 and cfg.data.device_prefetch == 1
    src, tgt = _uda(cfg)
    dataset = tuda.UDAPairDataset(src, tgt, seed=cfg.seed)
    val = tsyn.SyntheticTarget(crop_size=HW, length=3, test_mode=True)
    work = str(tmp_path_factory.mktemp("loop"))
    loop = TrainLoop(cfg, dataset=dataset, val_dataset=val, work_dir=work,
                     num_workers=2, device="cpu")
    state = loop.run()
    return cfg, loop, state, dataset


def test_train_loop_writes_records_grids_and_checkpoints(loop_run):
    cfg, loop, state, _ = loop_run
    assert state.step == 4 and loop.state is state
    files = sorted(os.listdir(loop.work_dir))
    assert "code.tar.gz" in files
    assert [f for f in files if f.startswith("iter_")] == ["iter_4.pth"]
    grids = sorted(os.listdir(os.path.join(loop.work_dir, "class_mix_debug")))
    assert grids == ["000002_0.png", "000002_1.png", "000004_0.png",
                     "000004_1.png"]
    evals = sorted(f for f in files if f.startswith("test_results_"))
    assert [e.split("_")[2] for e in evals] == ["2", "4"]
    for e in evals:
        assert sorted(os.listdir(os.path.join(loop.work_dir, e))) == [
            f"{i:06d}.png" for i in range(3)]
    with open(loop.log_path) as f:
        records = [json.loads(line) for line in f]
    assert records[0]["config"] == "micro" and "env" in records[0]
    steps = [r for r in records if "loss" in r]
    assert [r["iter"] for r in steps] == [1, 2, 3, 4]
    for r in steps:
        keys = list(r)
        assert keys[-3:] == ["iter", "time", "data_time"]
        assert keys[:-3] == sorted(keys[:-3]) and "loss" in keys
        assert all(np.isfinite(v) for v in r.values())
    scores = [r for r in records if "eval" in r]
    assert [r["iter"] for r in scores] == [2, 4]
    for r, e in zip(scores, evals):
        assert e == f"test_results_{r['iter']}_{r['eval']['mIoU'] * 100:.2f}"


def test_train_loop_logs_the_steps_of_its_loader_batches(loop_run):
    """The logged values equal, bitwise, those of ``train_step`` on the
    same loader batches from the same initial state: the debug snapshots
    and evaluations between the steps change nothing."""
    cfg, loop, _, dataset = loop_run
    ld = tloader.PrefetchLoader(dataset, cfg.data.batch_size, num_workers=2,
                                seed=cfg.seed)
    try:
        batches = [twire.encode_wire(next(ld)) for _ in range(4)]
    finally:
        ld.close()
    trainer = DACSTrainer(cfg, device="cpu")
    state = trainer.init_state(cfg.seed)
    with open(loop.log_path) as f:
        logged = [json.loads(line) for line in f]
    logged = [r for r in logged if "loss" in r]
    for batch, rec in zip(batches, logged, strict=True):
        state, logs = trainer.train_step(state, batch)
        for k, v in logs.items():
            assert rec[k] == float(v), (rec["iter"], k)


def test_evaluate_fusion_changes_nothing(loop_run):
    cfg, loop, state, _ = loop_run
    val = tsyn.SyntheticTarget(crop_size=HW, length=2, test_mode=True)
    before = _state_arrays(state)
    summary = evaluate_fusion(state.model, val)
    assert np.isfinite(summary["mIoU"])
    assert not state.model.training
    _assert_states_equal(_state_arrays(state), before)


def test_checkpoint_round_trip_and_next_step(loop_run):
    cfg, loop, state, _ = loop_run
    live = copy.deepcopy(state)
    trainer = DACSTrainer(cfg, device="cpu")
    loaded = load_checkpoint(trainer.init_state(cfg.seed + 1),
                             os.path.join(loop.work_dir, "iter_4.pth"))
    _assert_states_equal(_state_arrays(loaded), _state_arrays(live))
    ckpt = torch.load(os.path.join(loop.work_dir, "iter_4.pth"),
                      weights_only=True)
    assert ckpt["meta"]["iter"] == 4 and len(ckpt["meta"]["classes"]) == 19
    src, tgt = _uda(cfg)
    batch = uda_batch(src, tgt, [5, 6])
    draws = trainer.new_draws(live, 2)
    _, a = trainer.train_step(live, batch, draws)
    _, b = trainer.train_step(loaded, batch, draws)
    assert {k: float(v) for k, v in a.items()} == {
        k: float(v) for k, v in b.items()}
    from cmda_tpu_torch.apis import init_segmentor
    seg = init_segmentor(cfg, os.path.join(loop.work_dir, "iter_4.pth"),
                         device="cpu")
    _assert_states_equal({k: v for k, v in seg.model.state_dict().items()},
                         {k: v for k, v in state.model.state_dict().items()})


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _write_pretrained(tmp_path, cfg):
    """An NVlabs-style MiT state_dict (with its ImageNet head) and a small
    CycleGAN generator state_dict, from seeded weights."""
    gen = torch.Generator().manual_seed(7)
    mit = MixVisionTransformer(MIT_VARIANTS[cfg.model.backbone])
    with torch.no_grad():
        for p in mit.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    sd = {**mit.state_dict(), "head.weight": torch.zeros(1000, 256),
          "head.bias": torch.zeros(1000)}
    torch.save(sd, tmp_path / "mit.pth")
    cyc = init_generator(ResnetGenerator(ngf=8, n_blocks=2),
                         torch.Generator().manual_seed(8))
    torch.save({f"module.{k}": v for k, v in cyc.state_dict().items()},
               tmp_path / "cyclegan.pth")
    return mit.state_dict(), cyc.state_dict()


def test_cli_pretrained_backbone_and_cyclegan(tmp_path):
    cfg = TC.micro_test_config()
    cfg = TC.replace(cfg, uda=TC.replace(cfg.uda,
                                         use_cyclegan_day_events=True))
    mit, cyc = _write_pretrained(tmp_path, cfg)
    args = tcli.parse_args(["--synthetic", "--device", "cpu",
                            "--pretrained-backbone", str(tmp_path / "mit.pth"),
                            "--cyclegan", str(tmp_path / "cyclegan.pth")])
    state = tcli.init_state(DACSTrainer(cfg, device="cpu"), cfg, args)
    for bb in (state.model.backbone_image, state.model.backbone_events,
               state.ema_model.backbone_image):
        _assert_states_equal(bb.state_dict(), mit)
    _assert_states_equal(state.cyclegan.state_dict(), cyc)
    _assert_states_equal(state.ema_model.state_dict(),
                         state.model.state_dict())


def test_cli_runs_resumes_and_refuses_unported_flags(tmp_path, capsys):
    cfg = TC.tiny_test_config()
    _write_pretrained(tmp_path, cfg)
    base = ["--config", "tiny", "--synthetic", "--device", "cpu",
            "--num-workers", "2"]
    loop = tcli.main(base + ["--max-iters", "2", "--work-dir",
                             str(tmp_path / "a"), "--pretrained-backbone",
                             str(tmp_path / "mit.pth")])
    done = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert done == {"done": True, "step": 2, "work_dir": str(tmp_path / "a")}
    assert loop.cfg.optim.max_iters == 2 and loop.state.step == 2
    assert os.path.exists(tmp_path / "a" / "iter_2.pth")
    loop = tcli.main(base + ["--max-iters", "3", "--work-dir",
                             str(tmp_path / "b"), "--resume-from",
                             str(tmp_path / "a" / "iter_2.pth")])
    assert loop.state.step == 3
    assert os.path.exists(tmp_path / "b" / "iter_3.pth")

    for flag, item in (("--shard-opt-state", 7), ("--multi-host", 7)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            tcli.parse_args(["--synthetic", flag, "x"])
    assert tcli.parse_args(["--synthetic", "--fused-resize"]).fused_resize
    # an ablation flag of the JAX CLI reaches the config
    args = tcli.parse_args(["--synthetic", "--backbone", "mit_b0"])
    assert tcli.build_config(args).model.backbone == "mit_b0"
    # the corpus flags reach the config and build_datasets, which
    # needs the DSEC list without --synthetic
    args = tcli.parse_args(["--config", "tiny", "--source-root", "cs",
                            "--target-root", "dz", "--target-txt", "t.txt",
                            "--val-txt", "v.txt", "--rcs-json-dir", "rcs"])
    cfg = tcli.build_config(args)
    assert (cfg.data.source_root, cfg.data.target_root, args.target_txt,
            args.val_txt, args.rcs_json_dir) == ("cs", "dz", "t.txt",
                                                 "v.txt", "rcs")
    args = tcli.parse_args(["--config", "tiny"])
    with pytest.raises(ValueError, match="--target-txt"):
        tcli.build_datasets(tcli.build_config(args), args)
    with pytest.raises(SystemExit):
        tcli.parse_args(["--synthetic", "--no-such-flag"])
    args = tcli.parse_args(["--synthetic", "--config", "cs2dz",
                            "--teacher-bf16"])
    cfg = tcli.build_config(args)
    assert cfg.model.train_type == "cs2dz_image+raw-isr"
    assert cfg.uda.teacher_bf16


def test_checkpoint_round_trip_bf16_moments(tmp_path):
    """With bfloat16 AdamW moments (and grad_clip, teacher_bf16) a
    checkpoint loads back bitwise, the moments still bfloat16 (torch's
    ``Optimizer.load_state_dict`` casts them to the parameter's dtype on
    the way in), and the loaded state steps as the live one does."""
    cfg = _micro_cfg()
    cfg = TC.replace(cfg, optim=TC.replace(cfg.optim, moment_dtype="bfloat16",
                                           grad_clip=1.0),
                     uda=TC.replace(cfg.uda, teacher_bf16=True))
    trainer = DACSTrainer(cfg, device="cpu")
    live = trainer.init_state()
    src, tgt = _uda(cfg)
    trainer.train_step(live, uda_batch(src, tgt, [0, 1]))
    moments = [st[k] for st in live.optimizer.state.values()
               for k in ("exp_avg", "exp_avg_sq")]
    assert moments and all(m.dtype == torch.bfloat16 for m in moments)
    path = str(tmp_path / "iter_1.pth")
    save_checkpoint(live, path)
    loaded = load_checkpoint(trainer.init_state(seed=1), path)
    _assert_states_equal(_state_arrays(loaded), _state_arrays(live))
    batch = uda_batch(src, tgt, [2, 3])
    draws = trainer.new_draws(live, 2)
    _, a = trainer.train_step(live, batch, draws)
    _, b = trainer.train_step(loaded, batch, draws)
    assert {k: float(v) for k, v in a.items()} == {
        k: float(v) for k, v in b.items()}
    _assert_states_equal(_state_arrays(loaded), _state_arrays(live))


def _micro_dz():
    """The cs2dz preset (train type, attention fusion, its UDA settings)
    cut to the micro model at 64x64: what ``--config cs2dz`` runs here."""
    cfg, dz = _micro_cfg(), TC.cs2dz_image_rawisr_b5()
    return TC.replace(
        cfg, name="micro_dz", uda=dz.uda,
        model=TC.replace(cfg.model, train_type=dz.model.train_type,
                         fusion=dz.model.fusion,
                         fusion_isr=dz.model.fusion_isr),
        data=TC.replace(cfg.data, target=dz.data.target),
        log_interval=1, checkpoint_interval=2, eval_interval=2,
        debug_img_interval=2)


def test_cli_cs2dz_two_iterations(tmp_path, capsys, monkeypatch):
    """``--config cs2dz --teacher-bf16`` for 2 iterations on the CPU (the
    preset cut to the micro model): event-less synthetic data, the same
    samples key for key as the JAX package's, finite losses, a checkpoint,
    debug grids with the ISR as the second modality and an evaluation on
    the target's ISR."""
    cfg = _micro_dz()
    monkeypatch.setitem(TC.PRESETS, "cs2dz", lambda: cfg)
    dataset, val = tcli.build_datasets(cfg,
                                       tcli.parse_args(["--synthetic"]))
    (w, h) = cfg.data.crop_size
    jsrc = jsyn.SyntheticSource(crop_size=(w, h), with_time_res=False)
    jtgt = jsyn.SyntheticTarget(crop_size=(w, h), with_events=False)
    jval = jsyn.SyntheticTarget(crop_size=(w, h), length=8,
                                with_events=False, test_mode=True)
    for ours, ref in ((dataset.source, jsrc), (dataset.target, jtgt),
                      (val, jval)):
        assert len(ours) == len(ref)
        for i in (0, 5):
            _assert_tree_equal(ours[i], ref[i])
    assert set(dataset.source[0]) == {"image", "img_self_res", "label"}
    assert set(dataset.target[0]) == {"image", "isr"}

    work = tmp_path / "dz"
    loop = tcli.main(["--config", "cs2dz", "--synthetic", "--device", "cpu",
                      "--num-workers", "2", "--max-iters", "2",
                      "--work-dir", str(work), "--teacher-bf16"])
    done = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert done == {"done": True, "step": 2, "work_dir": str(work)}
    assert loop.cfg.uda.teacher_bf16 and loop.state.teacher is not None
    assert loop.state.cyclegan is None
    with open(loop.log_path) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "loss" in r]
    assert [r["iter"] for r in steps] == [1, 2]
    assert "src/loss_isr" not in steps[0] and "src/loss_events" in steps[0]
    assert all(np.isfinite(v) for r in steps for v in r.values()
               if isinstance(v, float))
    files = sorted(os.listdir(work))
    assert "iter_2.pth" in files
    assert [f for f in files if f.startswith("test_results_2_")]
    assert sorted(os.listdir(work / "class_mix_debug")) == [
        "000002_0.png", "000002_1.png"]
