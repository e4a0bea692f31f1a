"""The ISR ablation surface of the port against the JAX package on the CPU:
the source augmentations, ``CityscapesICDataset``'s source options,
``add_noise_on_isr``, the step's 3-channel, noised and ClassMix-ed mixed ISR,
the train CLI's ablation flags and the refusals of what stays unported.

* ``data/source_augs.py``: each function bitwise against the JAX copy for
  several seeds (one ``random.Random`` per package, seeded alike), with
  flare and sky-noise PNGs written here.
* ``CityscapesICDataset`` with each of its six options and with several
  together, bitwise against the JAX dataset (on its numpy host ISR,
  ``cmda_tpu.native.available`` patched to False) on a corpus from
  ``make_fake_corpus``.
* ``add_noise_on_isr`` fed the JAX op's own draws: 1e-6 absolute.
* ``DACSTrainer._mixed_isr_3ch`` on the plain ISR against the JAX method
  (eager): 1e-5 absolute, the tolerance of
  ``test_torch_train.py::test_mixed_isr_on_identical_image``.
* ``DACSTrainer._prepare`` (the teacher's pseudo-labels and the mix, no
  backward) of the micro cs2dz config at 64x64 against the JAX
  ``_prepare`` jitted alone, under ``shift_3_channel`` +
  ``isr_noise_dacs_type='noise+blur'`` and under
  ``mixed_image_to_mixed_isr=False`` + ``isr_mix_aug``, at the tolerances
  of ``test_torch_train_variants.py::
  test_cs2dz_pseudo_labels_and_mixed_image_match_jax``: masks equal,
  labels equal except at near ties of the JAX teacher's logits (1e-4 of
  their largest) and at least 99.9% equal, the mixed image and the mixed
  ISR to 1e-5.
* The train CLI: every flag of the JAX ``add_ablation_flags`` gives the
  JAX ``ablation_overrides`` and the same config; each flag whose option
  is still unported raises naming its ROADMAP item, from the check that
  owns the option; ``uda.pallas_ce`` / ``uda.use_pallas_isr`` False and
  ``--no-pallas-ce`` raise.
* The step's kernel wrapper calls (one launch each on the card): ISR 3
  with ``shift_3_channel``, 1 without, 0 with the ISRs ClassMix-ed.

No JAX DACS step is compiled; the two jitted JAX ``_prepare`` traces come
last in the file.
"""
import argparse
import dataclasses
import functools
import random
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from cmda_tpu import config as JC
from cmda_tpu import native as jnative
from cmda_tpu.data import cityscapes_ic as jcs
from cmda_tpu.data import source_augs as jsa
from cmda_tpu.models import fusion as jfus
from cmda_tpu.ops import augment as jaug
from cmda_tpu.uda import dacs as jdacs
from cmda_tpu.uda.dacs import DACSTrainer as JTrainer
from cmda_tpu_torch import config as TC
from cmda_tpu_torch.data import cityscapes_ic as tcs
from cmda_tpu_torch.data import source_augs as tsa
from cmda_tpu_torch.data.synthetic import (SyntheticSource, SyntheticTarget,
                                           uda_batch)
from cmda_tpu_torch.ops import augment as taug
from cmda_tpu_torch.ops import fused_ce, fused_resize, isr_kernel
from cmda_tpu_torch.tools import make_fake_corpus as tcorpus
from cmda_tpu_torch.tools import train as ttrain
from cmda_tpu_torch.uda import dacs as tdacs
from cmda_tpu_torch.uda import transforms as ttransforms
from cmda_tpu_torch.uda.dacs import DACSTrainer
from tools import train as jtrain

from test_torch_train import _draws, _jax_init_state
from test_torch_train_variants import _configs, _port
from torch_port_util import assert_labels_match

HW = (64, 64)
CS_SIZE = (512, 256)
CS_IMAGES = 3
# resized to 256x128: the corpus's 64-pixel label blocks become 32 pixels,
# so a 128x96 crop holds about 12 of them and the sky (class 10) shows in
# some crops
CS_GEOM = dict(image_resize_size=(256, 128), image_crop_size=(128, 96))
FLARE_SIZES = ((128, 96), (200, 150))   # the crop's size, and another
SKY_NOISE_SIZES = ((128, 96), (64, 40))
SEEDS = (0, 1, 7)
NOISE_ATOL = 1e-6
MIXED_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A Cityscapes corpus from the port's writer (``test_torch_data.py``
    holds the two writers' files equal), four flare PNGs (RGBA among them)
    and two sky-noise PNGs (one RGB)."""
    base = tmp_path_factory.mktemp("isr_corpus")
    cs = tcorpus.fabricate_cityscapes(str(base / "cityscapes"), CS_IMAGES,
                                      size=CS_SIZE)
    g = np.random.default_rng(5)
    flares = base / "flares"
    flares.mkdir()
    for i, (w, h) in enumerate(FLARE_SIZES * 2):
        yy, xx = np.mgrid[:h, :w]
        blob = np.exp(-((xx - w * (0.3 + 0.2 * i)) ** 2 + (yy - h / 2) ** 2)
                      / (2 * (w / 6) ** 2))
        rgb = np.clip(blob[..., None] * g.uniform(100, 255, 3)
                      + g.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)
        mode = "RGBA" if i == 3 else "RGB"
        img = Image.fromarray(rgb).convert(mode)
        img.save(flares / f"flare_{i}.png")
    noise = base / "sky_noise"
    noise.mkdir()
    for i, (w, h) in enumerate(SKY_NOISE_SIZES):
        shape = (h, w, 3) if i else (h, w)
        Image.fromarray(g.integers(0, 256, shape, np.uint8)).save(
            noise / f"noise_{i}.png")
    return SimpleNamespace(cs=cs, flares=str(flares), noise=str(noise))


@pytest.fixture()
def numpy_host(monkeypatch):
    """The JAX package's data paths on their numpy host code."""
    monkeypatch.setattr(jnative, "available", lambda: False)


def _pair_rngs(seed):
    return random.Random(seed), random.Random(seed)


def _isr_and_label(seed, h=96, w=128):
    """A smooth ISR in [-1, 1] and a label with a sky region."""
    g = np.random.default_rng(seed)
    isr = np.tanh(np.cumsum(g.normal(0, 0.2, (h, w)), axis=1)).astype(
        np.float32)
    label = g.integers(0, 19, (h, w)).astype(np.int32)
    label[: h // 3, w // 4:] = 10
    return isr, label


# ---------------------------------------------------------------------------
# the source augmentations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(96, 128), (95, 127)])
def test_isr_noise_np_bitwise(seed, shape):
    """Both blur outcomes come up over the seeds; odd sizes crop the pool."""
    isr, _ = _isr_and_label(seed, *shape)
    r_ours, r_ref = _pair_rngs(seed)
    for _ in range(3):
        np.testing.assert_array_equal(tsa.isr_noise_np(isr, r_ours),
                                      jsa.isr_noise_np(isr, r_ref))
    assert r_ours.random() == r_ref.random()


@pytest.mark.parametrize("seed", SEEDS)
def test_cow_mask_np_bitwise(seed):
    r_ours, r_ref = _pair_rngs(seed)
    ours = tsa.cow_mask_np((96, 128), r_ours)
    np.testing.assert_array_equal(ours, jsa.cow_mask_np((96, 128), r_ref))
    assert 0.3 < ours.mean() < 0.95
    assert tsa._erfinv(0.4) == jsa._erfinv(0.4)


@pytest.mark.parametrize("seed", SEEDS)
def test_flare_transform_np_bitwise(corpus, seed):
    """Every flare PNG is drawn over the seeds' calls, at the crop's size
    and at another (resized to the crop)."""
    g = np.random.default_rng(seed)
    crop = Image.fromarray(g.integers(0, 200, (96, 128, 3), np.uint8))
    r_ours, r_ref = _pair_rngs(seed)
    for _ in range(4):
        ours = tsa.flare_transform_np(crop, corpus.flares, r_ours)
        ref = jsa.flare_transform_np(crop, corpus.flares, r_ref)
        assert ours.size == crop.size
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))
    assert not np.array_equal(np.asarray(ours), np.asarray(crop))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("noise_dir", [False, True])
def test_sky_mask_transform_np_bitwise(corpus, seed, noise_dir):
    isr, label = _isr_and_label(seed)
    kw = dict(noise_dir=corpus.noise if noise_dir else None)
    r_ours, r_ref = _pair_rngs(seed)
    for _ in range(3):
        ours = tsa.sky_mask_transform_np(isr, label, r_ours, **kw)
        np.testing.assert_array_equal(
            ours, jsa.sky_mask_transform_np(isr, label, r_ref, **kw))
    assert not np.array_equal(ours, isr)
    # fewer than 10 sky pixels: the ISR as it was
    np.testing.assert_array_equal(tsa.sky_mask_transform_np(
        isr, np.zeros_like(label), r_ours), isr)


# ---------------------------------------------------------------------------
# CityscapesICDataset's options
# ---------------------------------------------------------------------------

def _options(corpus, name):
    return {
        "flare_dir": dict(flare_dir=corpus.flares),
        "sky_mask": dict(sky_mask=True),
        "sky_noise_dir": dict(sky_noise_dir=corpus.noise),
        "isr_noise": dict(isr_noise=True),
        "isr_cow_mask": dict(isr_cow_mask=True),
        "shift_3_channel": dict(shift_3_channel=True),
        "high_resolution_isr": dict(high_resolution_isr=True),
        "together": dict(isr_noise=True, isr_cow_mask=True, sky_mask=True,
                         flare_dir=corpus.flares),
        "together_3_channel": dict(isr_noise=True, isr_cow_mask=True,
                                   flare_dir=corpus.flares,
                                   shift_3_channel=True, sky_mask=True),
    }[name]


@pytest.mark.parametrize("outputs", ["all", "no_label", "default"])
@pytest.mark.parametrize("name", [
    "flare_dir", "sky_mask", "sky_noise_dir", "isr_noise", "isr_cow_mask",
    "shift_3_channel", "high_resolution_isr", "together",
    "together_3_channel"])
def test_cityscapes_ic_options_bitwise(corpus, numpy_host, name, outputs):
    """Two draws of every sample and a forced crop and flip, one
    random.Random per package: every key bitwise, and the option changes
    the sample (the ISR; the image for the flare). Without ``label`` in
    the outputs the sky mask still reads it; ``default`` is the dataset's
    own outputs (the IC image among them) and its random shift
    direction."""
    opts = _options(corpus, name)
    three = opts.get("shift_3_channel", False)
    out, shift = {
        "all": (("image", "img_self_res", "label"), "rightdown"),
        "no_label": (("image", "img_self_res"), "rightdown"),
        "default": (("image", "img_time_res", "img_self_res", "label"),
                    "random")}[outputs]
    kw = dict(CS_GEOM, shift_type=shift, outputs=out)
    params = {"T": (TC.CS_ISR_PRESETS_3["day"] if three
                    else TC.IsrParams()),
              "J": JC.CS_ISR_PRESETS_3["day"] if three else JC.IsrParams()}
    ours = tcs.CityscapesICDataset(corpus.cs, isr_params=params["T"],
                                   **kw, **opts)
    ref = jcs.CityscapesICDataset(corpus.cs, isr_params=params["J"],
                                  **kw, **opts)
    plain = tcs.CityscapesICDataset(
        corpus.cs, isr_params=params["T"][0] if three else params["T"], **kw)
    r_ours, r_ref = _pair_rngs(3)
    changed = 0
    for i in list(range(CS_IMAGES)) * 2:
        state = r_ours.getstate()
        a, b = ours.load(i, rng=r_ours), ref.load(i, rng=r_ref)
        assert set(a) == set(b) == set(out)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["img_self_res"].shape == CS_GEOM["image_crop_size"][::-1] \
            + (3,)
        r_plain = random.Random()
        r_plain.setstate(state)
        base = plain.load(i, rng=r_plain)
        key = "image" if name == "flare_dir" else "img_self_res"
        changed += not np.array_equal(a[key], base[key])
    assert changed >= (1 if name.startswith("sky") else CS_IMAGES)
    a = ours.load(1, crop_xy=(5, 3), flip=True, rng=random.Random(9))
    b = ref.load(1, crop_xy=(5, 3), flip=True, rng=random.Random(9))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if three and not opts.get("isr_noise"):
        isr = a["img_self_res"]
        assert not np.array_equal(isr[..., 0], isr[..., 2])


def test_cityscapes_ic_option_errors(corpus):
    with pytest.raises(ValueError, match="exclude each other"):
        tcs.CityscapesICDataset(corpus.cs, isr_params=TC.IsrParams(),
                                shift_3_channel=True,
                                high_resolution_isr=True)
    with pytest.raises(ValueError, match="three isr_params"):
        tcs.CityscapesICDataset(corpus.cs, isr_params=TC.IsrParams(),
                                shift_3_channel=True)


# ---------------------------------------------------------------------------
# add_noise_on_isr
# ---------------------------------------------------------------------------

def _jax_noise_draws(key, shape):
    """The draws ``cmda_tpu.ops.augment.add_noise_on_isr`` makes from
    ``key`` (augment.py:231-246), as an ``IsrNoiseDraws``."""
    k_gate, k_d, k_dm, k_r, k_ri, k_rm, k_rn = jax.random.split(key, 7)
    per = (shape[0], 1, 1, 1)
    u, n = jax.random.uniform, jax.random.normal
    return taug.IsrNoiseDraws(
        gate=_t(u(k_gate)), dis_thr=_t(u(k_d, per, minval=1.0, maxval=1.5)),
        dis_normal=_t(n(k_dm, shape)),
        rnd_thr=_t(u(k_r, per, minval=0.4, maxval=0.6)),
        intensity=_t(u(k_ri, per, minval=0.1, maxval=0.3)),
        rnd_normal=_t(n(k_rm, shape)), noise=_t(n(k_rn, shape)))


def _gated_key(blur):
    """The first key whose blur coin comes up ``blur``."""
    for s in range(100):
        key = jax.random.PRNGKey(s)
        if (float(jax.random.uniform(jax.random.split(key, 7)[0])) < 0.5
                ) == blur:
            return key
    raise AssertionError("no key")


@pytest.mark.parametrize("blur", [True, False], ids=["blur_on", "blur_off"])
@pytest.mark.parametrize("kind", ["noise", "blur", "noise+blur"])
@pytest.mark.parametrize("shape", [(2, 64, 64, 1), (3, 33, 20, 3)])
def test_add_noise_on_isr_matches_jax(kind, blur, shape):
    g = np.random.default_rng(len(kind) + shape[1])
    isr = np.tanh(g.normal(0, 1, shape)).astype(np.float32)
    key = _gated_key(blur)
    ref = np.asarray(jaug.add_noise_on_isr(key, jnp.asarray(isr), kind))
    out = taug.add_noise_on_isr(_t(isr), _jax_noise_draws(key, shape), kind)
    np.testing.assert_allclose(out.numpy(), ref, atol=NOISE_ATOL, rtol=0)
    assert (kind == "blur" and not blur) == np.array_equal(ref, isr)


def test_isr_noise_draws_shapes():
    d = taug.isr_noise_draws((2, 8, 6, 1), torch.Generator().manual_seed(0),
                             "cpu")
    assert [tuple(t.shape) for t in d] == [
        (), (2, 1, 1, 1), (2, 8, 6, 1), (2, 1, 1, 1), (2, 1, 1, 1),
        (2, 8, 6, 1), (2, 8, 6, 1)]
    assert 1.0 <= float(d.dis_thr.min()) and float(d.dis_thr.max()) < 1.5


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

def _ablation_actions():
    p = argparse.ArgumentParser()
    jtrain.add_ablation_flags(p)
    return [a for a in p._actions if a.option_strings != ["-h", "--help"]]


def _flag_argv(action, tmp="flares"):
    """A value for each JAX ablation flag that turns it on."""
    flag = action.option_strings[0]
    if action.nargs == 0:
        return [flag]
    if action.choices:
        return [flag, action.choices[-1]]
    return [flag, {
        "--train_size": "384-256", "--random_flare": tmp,
        "--source_isr_parms": "0.5-20-0.02-0.3-2",
        "--target_isr_parms": "2-50-0.01-0.2-3",
        "--dacs_isr_parms": "1-90-0.03-0.1-5",
        "--random_choice_thres": "0.3-0.7",
        "--events_clip_range": "2.5", "--image_change_range": "2",
        "--isr_edge_class_weight": "0.3"}.get(flag, "0.4")]


def _norm(v):
    if dataclasses.is_dataclass(v):
        return {f.name: _norm(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, (tuple, list)):
        return tuple(_norm(x) for x in v)
    return v


@pytest.mark.parametrize("flag", [a.option_strings[0]
                                  for a in _ablation_actions()])
def test_ablation_flags_match_jax(flag, monkeypatch):
    """The (path, value) overrides and the whole config (cs2dz and cs2dsec
    presets) equal the JAX CLI's, field by field."""
    [action] = [a for a in _ablation_actions()
                if a.option_strings[0] == flag]
    argv = _flag_argv(action)
    for preset in ("cs2dz", "cs2dsec"):
        base = ["--config", preset, "--synthetic"]
        monkeypatch.setattr(sys, "argv", ["train.py"] + base + argv)
        jargs = jtrain.parse_args()
        targs = ttrain.parse_args(base + argv)
        ref = jtrain.ablation_overrides(jargs)
        assert ref and _norm(ttrain.ablation_overrides(targs)) == _norm(ref)
        assert (_norm(ttrain.build_config(targs))
                == _norm(jtrain.build_config(jargs)))


def test_pallas_ce_flag_sets_the_config():
    args = ttrain.parse_args(["--config", "tiny", "--pallas-ce",
                              "--set", "uda.pallas_ce=false"])
    assert ttrain.build_config(args).uda.pallas_ce is True
    args = ttrain.parse_args(["--config", "cs2dz", "--backbone", "mit_b0"])
    assert ttrain.build_config(args).model.backbone == "mit_b0"


def _build(argv):
    """What ``tools.train.main`` builds before it trains, on the CPU: the
    config, the datasets, the trainer and its state; returns (args,
    config)."""
    args = ttrain.parse_args(argv + ["--device", "cpu"])
    cfg = ttrain.build_config(args)
    ttrain.build_datasets(cfg, args)
    DACSTrainer(cfg, device="cpu").init_state()
    return args, cfg


@pytest.mark.parametrize("argv,match", [
    (["--no-pallas-ce"], "pallas_ce=False.*for the tests only"),
    (["--set", "uda.pallas_ce=false"], "pallas_ce=False"),
    (["--set", "uda.use_pallas_isr=false"], "use_pallas_isr=False"),
], ids=lambda v: "_".join(v) if isinstance(v, list) else None)
def test_unported_flags_raise_from_their_owner(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        _build(["--config", "tiny", "--synthetic"] + argv)


@pytest.mark.parametrize("argv,reached", [
    (["--without_events"], lambda a, c: c.uda.without_events),
    (["--without_isd"], lambda a, c: c.uda.without_isd),
    (["--isr_no_fusion"], lambda a, c: c.uda.isr_no_fusion),
    (["--fuse_both_ice_and_e"], lambda a, c: c.uda.fuse_both_ice_and_e),
    (["--isd_shift_type", "all"],
     lambda a, c: c.uda.shift_type == c.data.shift_type == "all"),
    (["--fused-resize"], lambda a, c: a.fused_resize),
    (["--isr_edge", "1", "--set",
      "model.train_type=cs2dz_image+raw-isr_no-fusion"],
     lambda a, c: c.uda.isr_edge and c.uda.lambda_isr_features == 1.0),
    (["--feature_dist", "0.5"],
     lambda a, c: c.uda.imnet_feature_dist_lambda == 0.5),
    (["--deflare_aug"], lambda a, c: c.uda.deflare_aug),
    (["--fusion", "af"], lambda a, c: c.model.fusion == "average"),
    (["--fusion", "caf", "--backbone", "mit_b1"],
     lambda a, c: c.model.fusion == "convert_avg"),
    (["--fusion_isr", "af"], lambda a, c: c.model.fusion_isr == "average"),
    (["--fusion_isr", "caf", "--backbone", "mit_b1"],
     lambda a, c: c.model.fusion_isr == "convert_avg"),
    (["--half_share_decoder"], lambda a, c: c.model.share_decoder == "half"),
    (["--no_share_decoder"], lambda a, c: c.model.share_decoder == "none"),
], ids=lambda v: "_".join(v) if isinstance(v, list) else "")
def test_uda_option_flags_build(argv, reached):
    """The flags whose options train since the UDA options slice (and,
    since the train types slice, ``--isr_edge``, ``--feature_dist`` and
    ``--deflare_aug``; since the model zoo slice the fusion modules
    ``af`` / ``caf`` and the decoder sharings, ``caf`` on MiT-b1, the
    smallest backbone of its fixed widths) build the config, the datasets,
    the trainer and its state, and reach the config (``--fused-resize``
    the parsed arguments: ``main`` sets the process's phase upsample from
    it, held in tests/test_torch_uda_options.py)."""
    args, cfg = _build(["--config", "tiny", "--synthetic"] + argv)
    assert reached(args, cfg)


def test_dz_auto_threshold_and_parse_time_refusals():
    with pytest.raises(NotImplementedError, match="unimplemented in the "
                       "reference"):
        _build(["--config", "cs2dz", "--dz_auto_threshold"])
    for flag, item in (("--multi-host", 7), ("--data-parallel", 7)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            ttrain.parse_args(["--synthetic", flag, "x"])
    with pytest.raises(ValueError, match="isr_noise_dacs_type"):
        cfg = TC.micro_test_config()
        DACSTrainer(TC.replace(cfg, uda=TC.replace(
            cfg.uda, isr_noise_dacs_type="speckle")), device="cpu")


# ---------------------------------------------------------------------------
# the step's ISR: kernel wrapper calls, the 3-channel ISR, _prepare
# ---------------------------------------------------------------------------

def _uda_options(C, cfg, option):
    u = {"shift3_noise": dict(shift_3_channel=True,
                              isr_noise_dacs_type="noise+blur"),
         "mixed_isr_off": dict(mixed_image_to_mixed_isr=False,
                               isr_mix_aug=True),
         "none": {}}[option]
    return C.replace(cfg, uda=C.replace(cfg.uda, **u))


@pytest.mark.parametrize("option,isr", [("none", 1), ("shift3_noise", 3),
                                        ("mixed_isr_off", 0)])
def test_step_kernel_calls(option, isr, monkeypatch):
    """A cs2dz micro step's calls of each kernel wrapper (on the card each
    call is one launch, and each CE call's backward one dx launch; on the
    CPU the wrappers run the plain versions and their launch counters stay
    0): CE 6, argmax 3 and the ISR's."""
    _, tcfg = _configs("cs2dz_image+raw-isr")
    tcfg = _uda_options(TC, tcfg, option)
    calls = dict.fromkeys(("ce", "argmax", "isr"), 0)

    def count(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper
    monkeypatch.setattr(ttransforms, "fused_resize_ce",
                        count("ce", ttransforms.fused_resize_ce))
    monkeypatch.setattr(ttransforms, "fused_resize_argmax",
                        count("argmax", ttransforms.fused_resize_argmax))
    monkeypatch.setattr(tdacs, "batched_isr",
                        count("isr", tdacs.batched_isr))
    launches = (isr_kernel.batched_isr.launches,
                fused_resize.fused_resize_argmax.launches,
                fused_ce.fused_resize_ce.launches)
    trainer = DACSTrainer(tcfg, device="cpu")
    state = trainer.init_state()
    src = SyntheticSource(crop_size=HW, with_time_res=False)
    tgt = SyntheticTarget(crop_size=HW, with_events=False)
    _, logs = trainer.train_step(state, uda_batch(src, tgt, [0, 1]))
    assert calls == {"ce": 6, "argmax": 3, "isr": isr}
    assert all(np.isfinite(float(v)) for v in logs.values())
    assert (isr_kernel.batched_isr.launches,
            fused_resize.fused_resize_argmax.launches,
            fused_ce.fused_resize_ce.launches) == launches


def test_new_draws_isr_noise_come_last():
    """The ISR noise's draws exist only with the option and leave the
    step's other draws as they were."""
    _, tcfg = _configs("cs2dz_image+raw-isr")
    plain = DACSTrainer(tcfg, device="cpu")
    noisy = DACSTrainer(_uda_options(TC, tcfg, "shift3_noise"), device="cpu")
    state = plain.init_state()
    a, b = plain.new_draws(state, 2), noisy.new_draws(state, 2, (48, 40))
    assert a.isr_noise is None and b.isr_noise.noise.shape == (2, 48, 40, 1)
    for k in ("coin", "mix_scores", "jitter_gate", "blur_gate", "sigma",
              "isr_dirs"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for x, y in zip(a.jitter + tuple(a.fwd.__dict__.values()),
                    b.jitter + tuple(b.fwd.__dict__.values())):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
    assert b.to("cpu").isr_noise.gate.shape == ()
    assert plain.new_draws(state, 2).to("cpu").isr_noise is None


def test_mixed_isr_3ch_matches_jax():
    jcfg, tcfg = _configs("cs2dz_image+raw-isr")
    g = np.random.default_rng(12)
    img = g.normal(0, 1, (2, 32, 40, 3)).astype(np.float32)
    with jax.disable_jit():
        ref = JTrainer(jcfg)._mixed_isr_3ch(jnp.asarray(img))
    out = DACSTrainer(tcfg, device="cpu")._mixed_isr_3ch(_t(img))
    assert out.shape == (2, 32, 40, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=MIXED_ATOL,
                               rtol=0)
    assert not np.array_equal(out[..., 0].numpy(), out[..., 2].numpy())


def _gates_on(base):
    """True when step 0's draws of ``base`` apply the jitter, the blur and
    the ISR noise's blur (dacs.py:272-290, augment.py:231)."""
    k = jax.random.split(jax.random.fold_in(base, 0), 10)
    u = jax.random.uniform
    return (float(u(k[2])) > 0.2 and float(u(k[4])) > 0.5
            and float(u(jax.random.split(k[9], 7)[0])) < 0.5)


@pytest.fixture(scope="module")
def prepared():
    """{option: (JAX P, port P, JAX teacher logits)} of ``_prepare`` on one
    state, batch and draws; the JAX ``_prepare`` jitted alone, one compile
    an option. The base key is the first whose draws apply the jitter, the
    blur and the noise's blur, so each shows in the result."""
    base = next(jax.random.PRNGKey(s) for s in range(100)
                if _gates_on(jax.random.PRNGKey(s)))
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setitem(jfus.FUSION_REGISTRY, "attention", functools.partial(
        jfus.FUSION_REGISTRY["attention"], drop_path_rate=0.0))
    jlogits, jfn = [], jdacs.pseudo_label_and_weight

    def jpl(logits, **kw):
        jlogits.append(logits)
        return jfn(logits, **kw)
    mp.setattr(jdacs, "pseudo_label_and_weight", jpl)
    keys = ("masks", "mixed_img", "mixed_lbl", "mixed_isr", "pseudo_label")
    try:
        for option in ("shift3_noise", "mixed_isr_off"):
            jcfg, tcfg = (_uda_options(C, c, option) for C, c in zip(
                (JC, TC), _configs("cs2dz_image+raw-isr")))
            jtr = JTrainer(jcfg)
            jstate = _jax_init_state(jtr, jcfg)
            ttr, tstate = _port(tcfg, jstate)
            src = SyntheticSource(crop_size=HW, with_time_res=False)
            tgt = SyntheticTarget(crop_size=HW, with_events=False)
            batch = uda_batch(src, tgt, [4, 5])

            def jprep(state, b, rng):
                jlogits.clear()
                _, P = jtr._prepare(state, b, rng)
                return {k: P[k] for k in keys}, jlogits[0]
            jP, logits = jax.jit(jprep)(
                jstate, jax.tree.map(jnp.asarray, batch), base)
            draws = _draws(base, 0, 2, jcfg, None)
            if option == "shift3_noise":
                k_noise = jax.random.split(jax.random.fold_in(base, 0),
                                           10)[9]
                draws.isr_noise = _jax_noise_draws(k_noise, (2, *HW, 1))
            tbatch = ttr._device_batch(batch)
            tP = ttr._prepare(tstate, tbatch, draws, tstate.ema_model,
                              tstate.teacher)
            out["isr_inputs"] = (tbatch["source"]["img_self_res"].numpy(),
                                 tbatch["target"]["isr"].numpy())
            out[option] = ({k: np.asarray(v) for k, v in jP.items()},
                           {k: tP[k].numpy() for k in keys},
                           np.asarray(logits))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("option", ["shift3_noise", "mixed_isr_off"])
def test_prepare_matches_jax(prepared, option):
    ref, got, logits = prepared[option]
    np.testing.assert_array_equal(got["masks"], ref["masks"])
    margin = 1e-4 * np.abs(logits).max()
    for k in ("pseudo_label", "mixed_lbl"):
        assert_labels_match(got[k], ref[k], logits, margin)
        assert (got[k] == ref[k]).mean() >= 0.999
    for k in ("mixed_img", "mixed_isr"):
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k], ref[k], atol=MIXED_ATOL, rtol=0,
                                   err_msg=k)
    isr = got["mixed_isr"]
    if option == "shift3_noise":
        # channel 0 noised and repeated
        assert np.array_equal(isr[..., 0], isr[..., 2])
    else:
        # the jitter and the blur applied to the ClassMix of the two ISRs
        mix = np.where(got["masks"][..., None], *prepared["isr_inputs"])
        assert np.abs(isr - mix).max() > 1e-3
