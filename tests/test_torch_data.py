"""The port's real-corpus data path against the JAX package on the CPU:
the corpus writers, ``CityscapesICDataset``, the h5 slice, the voxel grid
and its norm, ``DSECDataset``, Rare Class Sampling, the train CLI's
``build_datasets`` and runs of the train and test CLIs on written corpora.

Both packages' writers write one small corpus each from the same seeds
(Cityscapes 256x128, DSEC at its 640x480 with 20,000 events a window, so
the 65,536-event gzip chunks are crossed, DarkZurich 96x64); each
package's datasets read its own. The JAX data paths run on their numpy
host code (``cmda_tpu.native.available`` patched to False) where the port
is held bitwise; with the JAX package's C++ ingest on, its splat and norm
are held to the tolerances ``tests/test_native.py`` holds them to its
numpy twins: 1e-3 for the splat, 1e-5 for the norm. The voxel grid is
also held to ``cmda_tpu.ops.voxel.events_to_voxel_grid`` at
``tests/test_voxel.py``'s 1e-3. The test CLI's mIoU is held as
``tests/test_torch_inference.py`` holds ``evaluate_fusion``: equal when
every prediction is, else labels equal except at near ties (top-2 logit
margin below 2e-4). No JAX DACS step is compiled; one micro forward is
jitted at 440x640.
"""
import json
import math
import os
import random
import sys
from types import SimpleNamespace

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

import jax

from cmda_tpu import config as JC
from cmda_tpu import native as jnative
from cmda_tpu.data import cityscapes_ic as jcs
from cmda_tpu.data import dsec as jdsec
from cmda_tpu.data import loader as jloader
from cmda_tpu.data import native_h5 as jh5
from cmda_tpu.data import synthetic as jsyn
from cmda_tpu.data import uda as juda
from cmda_tpu.models.segmentor import FusionEncoderDecoder as JFED
from cmda_tpu.ops.voxel import events_to_voxel_grid
from cmda_tpu.train import loop as jloop
from cmda_tpu_torch import apis as tapis
from cmda_tpu_torch import config as TC
from cmda_tpu_torch.data import cityscapes_ic as tcs
from cmda_tpu_torch.data import dsec as tdsec
from cmda_tpu_torch.data import h5 as th5
from cmda_tpu_torch.data import loader as tloader
from cmda_tpu_torch.data import synthetic as tsyn
from cmda_tpu_torch.data import uda as tuda
from cmda_tpu_torch.tools import make_fake_corpus as tcorpus
from cmda_tpu_torch.tools import test as ttest
from cmda_tpu_torch.tools import train as ttrain
from cmda_tpu_torch.train import loop as tloop
from cmda_tpu_torch.utils.weights import load_jax_variables
from tools import make_fake_corpus as jcorpus
from tools import train as jtrain

from torch_port_util import assert_labels_match, random_variables

MARGIN = 2e-4
SPLAT_ATOL = 1e-3      # tests/test_native.py:35, tests/test_voxel.py:73
NORM_ATOL = 1e-5       # tests/test_native.py:44
CS_SIZE = (256, 128)
DZ_SIZE = (96, 64)
CS_IMAGES, DSEC_FRAMES, DZ_IMAGES = 3, 4, 2
EVENTS = 20000
CS_GEOM = dict(image_resize_size=(128, 64), image_crop_size=(64, 48))


def _write(corpus, root):
    os.makedirs(root)
    cs = corpus.fabricate_cityscapes(os.path.join(root, "cityscapes"),
                                     CS_IMAGES, size=CS_SIZE)
    train_txt, test_txt = corpus.fabricate_dsec_with_labels(
        os.path.join(root, "dsec"), DSEC_FRAMES, EVENTS)
    dz = corpus.fabricate_dark_zurich(os.path.join(root, "dark_zurich"),
                                      DZ_IMAGES, size=DZ_SIZE)
    # the simulated-events PNGs of return_gi_or_ic 'events_gan' (resized
    # like the frame) and 'events_esim' (at crop size), written alike
    g = np.random.default_rng(7)
    for path in sorted(tcs.CityscapesICDataset(
            cs, isr_params=TC.IsrParams()).files):
        for sub, size in (("leftImg8bit_EventGAN", CS_SIZE),
                          ("leftImg8bit_esim", CS_GEOM["image_crop_size"])):
            out = path.replace("leftImg8bit", sub)[:-13] + ".png"
            os.makedirs(os.path.dirname(out), exist_ok=True)
            Image.fromarray(g.integers(0, 256, size[::-1], np.uint8)).save(out)
    return SimpleNamespace(root=root, cs=cs, train_txt=train_txt,
                           test_txt=test_txt, dz=dz)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    base = tmp_path_factory.mktemp("corpora")
    return SimpleNamespace(ours=_write(tcorpus, str(base / "ours")),
                           ref=_write(jcorpus, str(base / "ref")))


@pytest.fixture()
def numpy_host(monkeypatch):
    """The JAX package's data paths on their numpy host code."""
    monkeypatch.setattr(jnative, "available", lambda: False)


def _tree_equal(ours, ref, what=""):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), what
        for k in ref:
            _tree_equal(ours[k], ref[k], f"{what}/{k}")
        return
    a, b = np.asarray(ours), np.asarray(ref)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _h5_arrays(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj[()], obj.chunks, obj.compression)
        f.visititems(visit)
    return out


# ---------------------------------------------------------------------------
# the writers
# ---------------------------------------------------------------------------

def test_writers_write_the_same_corpus(corpora):
    """Every file of the two corpora: PNG pixels, h5 arrays (with their
    chunking and codec), and the text and JSON files up to the root."""
    ours, ref = corpora.ours.root, corpora.ref.root
    names = _files(ref)
    assert _files(ours) == names and len(names) > 40
    for name in names:
        a, b = os.path.join(ours, name), os.path.join(ref, name)
        if name.endswith(".png"):
            with Image.open(a) as x, Image.open(b) as y:
                assert x.mode == y.mode, name
                assert np.array_equal(np.asarray(x), np.asarray(y)), name
        elif name.endswith(".h5"):
            ha, hb = _h5_arrays(a), _h5_arrays(b)
            assert set(ha) == set(hb), name
            for k in hb:
                assert ha[k][1:] == hb[k][1:], (name, k)
                _tree_equal(ha[k][0], hb[k][0], f"{name}:{k}")
        else:
            with open(a) as x, open(b) as y:
                assert x.read() == y.read().replace(ref, ours), name


def test_corpus_cli_prints_the_roots(tmp_path, capsys):
    got = tcorpus.main(["--root", str(tmp_path), "--images", "2",
                        "--cityscapes-size", "128", "64", "--frames", "3",
                        "--events-per-window", "1000",
                        "--dark-zurich-size", "64", "32"])
    assert json.loads(capsys.readouterr().out.strip()) == got
    assert len(tcs.CityscapesICDataset(
        got["cityscapes"], isr_params=TC.IsrParams())) == 2
    with Image.open(os.path.join(got["dark_zurich"], "rgb_anon", "val",
                                 "night", "seq01",
                                 "seq01_frame_000000_rgb_anon.png")) as im:
        assert im.size == (64, 32)
    with open(got["target_txt"]) as f:
        assert len(f.read().splitlines()) == 2
    with h5py.File(os.path.join(tmp_path, "dsec", "zurich_city_09_x",
                                "events", "left", "events.h5")) as f:
        assert f["events/t"].shape == (3000,)


# ---------------------------------------------------------------------------
# CityscapesIC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decode_cache", [0, 2])
@pytest.mark.parametrize("shift_type", ["random", "rightdown"])
@pytest.mark.parametrize("mode", list(tcs.IC_MODES))
def test_cityscapes_ic_bitwise(corpora, numpy_host, mode, shift_type,
                               decode_cache):
    """Two draws of every sample with one random.Random per package, and
    the RCS re-crop with a forced corner and flip: every key bitwise."""
    kw = dict(CS_GEOM, shift_type=shift_type, return_gi_or_ic=mode,
              decode_cache=decode_cache)
    ours = tcs.CityscapesICDataset(corpora.ours.cs,
                                   isr_params=TC.IsrParams(), **kw)
    ref = jcs.CityscapesICDataset(corpora.ref.cs, isr_params=JC.IsrParams(),
                                  **kw)
    assert [os.path.relpath(f, corpora.ours.cs) for f in ours.files] == [
        os.path.relpath(f, corpora.ref.cs) for f in ref.files]
    assert len(ours) == CS_IMAGES
    r_ours, r_ref = random.Random(3), random.Random(3)
    for i in list(range(CS_IMAGES)) * 2:
        _tree_equal(ours.load(i, rng=r_ours), ref.load(i, rng=r_ref))
    _tree_equal(ours.load(1, crop_xy=(7, 3), flip=True),
                ref.load(1, crop_xy=(7, 3), flip=True))
    sample = ours.load(0, rng=random.Random(0))
    assert sample["img_time_res"].strides[-1] == 0   # mono, for the wire


# ---------------------------------------------------------------------------
# the h5 slice, the voxel grid and its norm
# ---------------------------------------------------------------------------

def test_read_slice_equals_h5py_across_chunks(corpora):
    """Windows inside a chunk, across the 65,536 boundary, the whole file
    and past its end, under the lock; the JAX package's C++ inflate path
    gives the same arrays."""
    import threading
    path = os.path.join(corpora.ours.root, "dsec", "zurich_city_09_x",
                        "events", "left", "events.h5")
    n = EVENTS * DSEC_FRAMES
    lock = threading.Lock()
    with h5py.File(path, "r") as f:
        assert f["events/t"].chunks == (65536,)
        for start, stop in ((0, 10), (65530, 65540), (19999, 40000),
                            (59999, 80000), (0, n), (n - 5, n + 9)):
            for k in "txyp":
                want = f[f"events/{k}"][start:stop]
                got = th5.read_slice(f, f"events/{k}", start, stop, lock)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(
                    jh5.read_slice(f[f"events/{k}"], start, stop), want)
    assert not lock.locked()


def _events(n, w, h, seed):
    g = np.random.default_rng(seed)
    t = np.sort(g.random(n)).astype(np.float32)
    x = (g.random(n) * (w - 1)).astype(np.float32)
    y = (g.random(n) * (h - 1)).astype(np.float32)
    p = g.integers(0, 2, n).astype(np.float32)
    return t, x, y, p


@pytest.mark.parametrize("bins", [1, 5])
def test_voxel_grid_and_norm_match_jax(bins):
    t, x, y, p = _events(3000, 64, 48, seed=bins)
    ours = tdsec.host_voxel_grid(t, x, y, p, 64, 48, bins)
    ref = jdsec.host_voxel_grid(t, x, y, p, 64, 48, bins)
    assert ours.dtype == np.float32 and np.array_equal(ours, ref)
    dev = np.asarray(events_to_voxel_grid(
        t, x, y, p, np.int32(len(t)), width=64, height=48, num_bins=bins))
    np.testing.assert_allclose(ours, dev, atol=SPLAT_ATOL)
    np.testing.assert_allclose(ours, jnative.voxel_grid(
        t, x, y, p, bins=bins, height=48, width=64), atol=SPLAT_ATOL)
    for clip in (0.4, 1.5):
        normed = tdsec.host_events_norm(ours.copy(), clip)
        assert np.array_equal(normed, jdsec.host_events_norm(ours.copy(),
                                                             clip))
        np.testing.assert_allclose(normed, jnative.events_norm(ours, clip),
                                   atol=NORM_ATOL)
    empty = tdsec.host_voxel_grid(t[:0], x[:0], y[:0], p[:0], 8, 4, bins)
    assert empty.shape == (bins, 4, 8) and not empty.any()


# ---------------------------------------------------------------------------
# DSEC-Night
# ---------------------------------------------------------------------------

def _dsec_pair(corpora, test_mode, bins, clip, **kw):
    txt = "test_txt" if test_mode else "train_txt"
    args = dict(events_bins=bins, test_mode=test_mode, events_clip_range=clip,
                outputs=(("image", "events", "label") if test_mode
                         else ("image", "events", "isr")), **kw)
    return (tdsec.DSECDataset(getattr(corpora.ours, txt),
                              isr_params=TC.IsrParams(), **args),
            jdsec.DSECDataset(getattr(corpora.ref, txt),
                              isr_params=JC.IsrParams(), **args))


@pytest.mark.parametrize("clip", [None, (0.5, 1.5)])
@pytest.mark.parametrize("bins", [1, 5])
@pytest.mark.parametrize("test_mode", [False, True])
def test_dsec_dataset_bitwise(corpora, numpy_host, test_mode, bins, clip):
    """Every sample with one random.Random per package (the train crop,
    flip and ISR direction, the uniform clip): every key bitwise; test
    mode the top 440 rows with labels."""
    ours, ref = _dsec_pair(corpora, test_mode, bins, clip)
    assert len(ours) == len(ref) == (2 if test_mode else DSEC_FRAMES - 1)
    r_ours, r_ref = random.Random(1), random.Random(1)
    for i in range(len(ref)):
        a, b = ours.load(i, rng=r_ours), ref.load(i, rng=r_ref)
        _tree_equal(a, b)
        assert a["image"].shape == ((440, 640, 3) if test_mode
                                    else (512, 512, 3))
        ev = a["events"]
        assert ev.strides[-1] == 0 and -1.0 <= ev.min() <= ev.max() <= 1.0


@pytest.mark.parametrize("bins", [1, 5])
def test_dsec_events_match_the_cpp_ingest(corpora, bins):
    """Against the JAX package's C++ splat and norm: the window's grid to
    1e-3, its norm (of the port's grid) to 1e-5."""
    assert jnative.available()
    ours, ref = _dsec_pair(corpora, False, bins, None, decode_cache=2)
    for i in range(len(ref)):
        path_o, path_r = str(ours.rows[i][0]), str(ref.rows[i][0])
        now = int(os.path.basename(path_o).split(".")[0])
        start, finish = ours._window(path_o, now)
        grid = ours._splat_grid(path_o, finish, start)
        np.testing.assert_allclose(grid, ref._splat_grid(path_r, finish,
                                                         start),
                                   atol=SPLAT_ATOL)
        clip = (finish - start) / 500000.0 * 1.5
        np.testing.assert_allclose(
            ours._events_grid(path_o, finish, start, random.Random(0)),
            jnative.events_norm(grid, clip), atol=NORM_ATOL)


def test_dsec_needs_h5py(corpora, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        tdsec.DSECDataset(corpora.ours.train_txt, isr_params=TC.IsrParams())


# ---------------------------------------------------------------------------
# Rare Class Sampling, the CLIs' datasets
# ---------------------------------------------------------------------------

def test_rcs_pairs_like_jax(corpora, numpy_host, monkeypatch):
    """8 pairs of UDAPairDataset with RCS over CityscapesIC: the same
    source files, crops, flips and samples."""
    picks = {"ours": [], "ref": []}

    def recording(cls, tag):
        real = cls.load

        def load(self, idx, crop_xy=None, flip=None, rng=None):
            out = real(self, idx, crop_xy, flip, rng)
            picks[tag].append((os.path.basename(self.files[idx]),
                               out["label"].copy()))
            return out
        monkeypatch.setattr(cls, "load", load)
    recording(tcs.CityscapesICDataset, "ours")
    recording(jcs.CityscapesICDataset, "ref")
    d = TC.DataConfig()
    pairs = {}
    for tag, cs, CS, UDA, SYN, C in (
            ("ours", corpora.ours.cs, tcs, tuda, tsyn, TC),
            ("ref", corpora.ref.cs, jcs, juda, jsyn, JC)):
        src = CS.CityscapesICDataset(
            cs, image_resize_size=(256, 128), image_crop_size=(128, 64),
            isr_params=C.IsrParams())
        pairs[tag] = UDA.UDAPairDataset(
            src, SYN.SyntheticTarget(crop_size=(16, 16)), rcs=True,
            samples_with_class=os.path.join(cs, "samples_with_class.json"),
            sample_class_stats=os.path.join(cs,
                                            "sample_class_stats_dict.json"),
            class_temp=d.rcs_class_temp, min_pixels=d.rcs_min_pixels,
            min_crop_ratio=d.rcs_min_crop_ratio, seed=0)
    assert pairs["ours"].rcs and list(pairs["ours"].rcs_classes) == list(
        pairs["ref"].rcs_classes)
    r_ours, r_ref = random.Random(4), random.Random(4)
    for i in range(8):
        _tree_equal(pairs["ours"].load(i, rng=r_ours),
                    pairs["ref"].load(i, rng=r_ref), f"pair {i}")
    assert [f for f, _ in picks["ours"]] == [f for f, _ in picks["ref"]]
    assert len(picks["ours"]) >= 8 and len({f for f, _ in picks["ours"]}) > 1


def _jax_args(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    return jtrain.parse_args()


def _cli_flags(c, preset):
    flags = ["--config", preset, "--source-root", c.cs, "--rcs-json-dir",
             c.cs]
    if preset == "cs2dsec":
        return flags + ["--target-txt", c.train_txt, "--val-txt", c.test_txt]
    return flags + ["--target-root", c.dz]


@pytest.mark.parametrize("preset", ["cs2dsec", "cs2dz"])
def test_build_datasets_matches_jax_cli(corpora, numpy_host, monkeypatch,
                                        preset):
    """The port CLI's build_datasets against tools/train.py's at the
    preset's sizes: the first two batches of each package's loader (one
    worker, seed 0) and the first val sample equal."""
    args = ttrain.parse_args(_cli_flags(corpora.ours, preset))
    cfg = ttrain.build_config(args)
    dataset, val = ttrain.build_datasets(cfg, args)
    jargs = _jax_args(monkeypatch, _cli_flags(corpora.ref, preset))
    jcfg = jtrain.build_config(jargs)
    jdataset, jval = jtrain.build_datasets(jcfg, jargs)
    assert dataset.rcs and jdataset.rcs
    assert type(dataset.target).__name__ == type(jdataset.target).__name__
    assert cfg.data.source_root == corpora.ours.cs
    batches = []
    for Loader, ds in ((tloader.PrefetchLoader, dataset),
                       (jloader.PrefetchLoader, jdataset)):
        loader = Loader(ds, cfg.data.batch_size, num_workers=1, prefetch=1,
                        seed=cfg.seed)
        try:
            batches.append([next(loader) for _ in range(2)])
        finally:
            loader.close()
    for i, (a, b) in enumerate(zip(*batches)):
        _tree_equal(a, b, f"batch {i}")
    assert batches[0][0]["source"]["image"].shape == (2, 512, 512, 3)
    assert len(val) == len(jval)
    _tree_equal(val[0], jval[0], "val")


def test_train_cli_real_corpus_two_iterations(corpora, tmp_path, capsys):
    """``tools.train.main`` on the written corpus (tiny preset: CityscapesIC
    with RCS, DSEC-Night, evaluation on the DSEC test list) for 2
    iterations on the CPU: finite losses, a checkpoint, an evaluation."""
    c, work = corpora.ours, tmp_path / "work"
    loop = ttrain.main(["--config", "tiny", "--source-root", c.cs,
                        "--rcs-json-dir", c.cs, "--target-txt", c.train_txt,
                        "--val-txt", c.test_txt, "--max-iters", "2",
                        "--num-workers", "2", "--work-dir", str(work),
                        "--set", "eval_interval=2", "--set", "log_interval=1",
                        "--device", "cpu"])
    done = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert done == {"done": True, "step": 2, "work_dir": str(work)}
    assert loop.dataset.rcs and len(loop.val_dataset) == 2
    with open(loop.log_path) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "loss" in r]
    assert [r["iter"] for r in steps] == [1, 2]
    assert all(math.isfinite(v) for r in steps for v in r.values())
    evals = [r["eval"] for r in records if "eval" in r]
    assert len(evals) == 1 and math.isfinite(evals[0]["mIoU"])
    assert "iter_2.pth" in os.listdir(work)


# ---------------------------------------------------------------------------
# the test CLI on the DSEC test list
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def micro_dsec():
    """The micro cs2dsec model in both packages on one set of seeded
    weights; the JAX forward jitted per shape."""
    jcfg = JC.micro_test_config()
    jm = JFED(jcfg.model)
    x = np.zeros((1, 32, 32, 3), np.float32)
    v = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), x, x, x, mode="fusion_all",
        method=jm.forward_logits), seed=12)
    model = load_jax_variables(tapis.build_model(TC.micro_test_config(),
                                                 "cpu"), v)
    apply = jax.jit(jm.apply, static_argnames=("mode", "output"))
    return SimpleNamespace(
        cfg=TC.micro_test_config(), model=model, v=v,
        japply=SimpleNamespace(module=jm, apply=apply),
        jstate=SimpleNamespace(params=v["params"], ema_params=v["params"],
                               batch_stats=v["batch_stats"]))


def test_test_cli_dsec_matches_jax_evaluate(corpora, micro_dsec, numpy_host,
                                            tmp_path, monkeypatch, capsys):
    """``tools.test.main --target-txt`` on the 2 DSEC test frames against
    the JAX package's evaluate_fusion on its own corpus with the same
    weights: every scored prediction, then the summary."""
    m = micro_dsec
    monkeypatch.setitem(TC.PRESETS, "cs2dsec", lambda: m.cfg)
    ckpt = str(tmp_path / "iter_1.pth")
    torch.save({"state_dict": m.model.state_dict(),
                "ema_state_dict": m.model.state_dict()}, ckpt)
    seen = {"jax": [], "torch": []}
    for tag, mod in (("jax", jloop), ("torch", tloop)):
        def wrapped(pred, label, num_classes, tag=tag,
                    fn=mod.intersect_and_union):
            seen[tag].append(np.array(pred))
            return fn(pred, label, num_classes)
        monkeypatch.setattr(mod, "intersect_and_union", wrapped)
    ours = ttest.main(["--config", "cs2dsec", "--checkpoint", ckpt,
                       "--target-txt", corpora.ours.test_txt,
                       "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == ours
    jcfg = JC.micro_test_config()
    d = jcfg.data
    jset = jdsec.DSECDataset(corpora.ref.test_txt,
                             events_bins=d.events_bins,
                             isr_params=d.target_isr, test_mode=True,
                             image_change_range=d.image_change_range,
                             events_clip_range=d.events_clip_range,
                             outputs=("image", "events", "label"))
    monkeypatch.setattr(jloop, "jax", SimpleNamespace(
        jit=lambda f: f, process_count=jax.process_count,
        process_index=jax.process_index, device_get=jax.device_get))
    ref = jloop.evaluate_fusion(SimpleNamespace(model=m.japply), m.jstate,
                                jset)
    monkeypatch.setattr(jloop, "jax", jax)
    assert len(seen["torch"]) == len(seen["jax"]) == 2
    assert seen["torch"][0].shape == (440, 640)
    if all(np.array_equal(a, b) for a, b in zip(seen["torch"], seen["jax"])):
        for k in ("mIoU", "aAcc", "mAcc", "mIoU_18cls"):
            assert ours[k] == pytest.approx(ref[k], abs=1e-12), k
    else:
        ds = ttest.build_dataset(m.cfg, ttest.parse_args(
            ["--target-txt", corpora.ours.test_txt]))
        for i, (a, b) in enumerate(zip(seen["torch"], seen["jax"])):
            s = ds[i]
            with torch.no_grad():
                z = tapis.select_logits(
                    m.model, torch.from_numpy(s["image"])[None],
                    torch.from_numpy(np.ascontiguousarray(s["events"]))[None],
                    "fusion")
                z = tloop.resize_bilinear(z, (440, 640))[0].numpy()
            assert_labels_match(a, b, z, MARGIN)
    assert math.isfinite(ours["mIoU"])


def test_test_cli_dsec_needs_its_list():
    args = ttest.parse_args(["--config", "cs2dsec"])
    cfg = ttest.build_config(args)
    with pytest.raises(ValueError, match="--target-txt"):
        ttest.build_dataset(cfg, args)

