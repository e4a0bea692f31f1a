"""The port's test path against the JAX package on the CPU: config
overrides, the host ISR, the DarkZurich dataset, the blended panel, slide
and multi-scale+flip inference, ``evaluate_fusion`` in all its modes (the
EMA teacher on the student's BatchNorm statistics included),
``init_segmentor`` with a port checkpoint, and the test, infer and train
CLIs.

The model is the micro config as the cs2dz preset builds it
(``AttentionFusion``, image + ISR), with seeded numpy weights through
``jax.eval_shape`` (no JAX init compile). The JAX forwards are jitted once
per shape and call signature (``JitApply``), also inside the JAX
package's ``evaluate_fusion``, whose own whole-batch jit of the 12 aug-test
forwards takes about a minute to compile. The JAX data paths run their
numpy ISR (the port has no copy of the JAX package's C++ ingest kernel,
which agrees with it to ~1.5e-6).

Tolerances: the host ISR, the dataset, the panel and the submission PNGs
bitwise; slide logits 1e-5 of max|logit|; aug-test probabilities 1e-6;
labels equal except at near ties (top-2 logit margin below 2e-4, twice
test_torch_models.py's logit tolerance; 1e-5 for averaged probabilities).
The cheap tests come first, the jitted JAX forwards last.
"""
import dataclasses
import functools
import inspect
import json
import math
import os
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import jax
import jax.numpy as jnp

from cmda_tpu import apis as japis
from cmda_tpu import config as JC
from cmda_tpu import native as jnative
from cmda_tpu.data import host_isr as jhost
from cmda_tpu.data.dark_zurich import DarkZurichDataset as JDZ
from cmda_tpu.data.synthetic import SyntheticTarget as JSyntheticTarget
from cmda_tpu.models import segmentor as jseg
from cmda_tpu.models.segmentor import FusionEncoderDecoder as JFED
from cmda_tpu.ops.resize import resize_bilinear as jresize
from cmda_tpu.train import loop as jloop
from cmda_tpu.utils import visualization as jvis
from cmda_tpu_torch import apis as tapis
from cmda_tpu_torch import config as TC
from cmda_tpu_torch.data import host_isr as thost
from cmda_tpu_torch.data.dark_zurich import DarkZurichDataset as TDZ
from cmda_tpu_torch.data.dsec import DSECDataset as TDSEC
from cmda_tpu_torch.data.synthetic import SyntheticTarget
from cmda_tpu_torch.models import segmentor as tseg
from cmda_tpu_torch.ops.resize import resize_bilinear as tresize
from cmda_tpu_torch.tools import infer as tinfer
from cmda_tpu_torch.tools.make_fake_corpus import fabricate_dsec_with_labels
from cmda_tpu_torch.tools import test as ttest
from cmda_tpu_torch.tools import train as ttrain
from cmda_tpu_torch.train import loop as tloop
from cmda_tpu_torch.uda.dacs import DACSTrainState
from cmda_tpu_torch.utils import visualization as tvis
from cmda_tpu_torch.utils.weights import load_jax_variables
from tools.make_fake_corpus import fabricate_dark_zurich
from tools.test import export_submission as jexport_submission

from torch_port_util import assert_labels_match, random_variables

MARGIN = 2e-4          # top-2 logit margin of a near tie
PROB_MARGIN = 1e-5     # the same for averaged softmax probabilities
SLIDE_RTOL = 1e-5      # of max|logit|
PROB_ATOL = 1e-6
HW = (64, 64)
DIRECTIONS = ("leftdown", "leftup", "rightdown", "rightup", "all")
ISR_PARAMS = (
    dict(val_range=(1.0, 100.0), threshold=0.01, clip_range=0.1,
         shift_pixel=3),                       # the cs2dz preset's
    dict(val_range=(0.01, 1.01), threshold=0.005, clip_range=0.1,
         shift_pixel=1))


def _micro_dz(C):
    """The cs2dz preset cut to the micro model at 64x64, in package C."""
    cfg, dz = C.micro_test_config(), C.cs2dz_image_rawisr_b5()
    return C.replace(
        cfg, name="micro_dz", uda=dz.uda,
        model=C.replace(cfg.model, train_type=dz.model.train_type,
                        fusion=dz.model.fusion,
                        fusion_isr=dz.model.fusion_isr),
        data=C.replace(dz.data, crop_size=HW))


@pytest.fixture()
def numpy_isr(monkeypatch):
    """The JAX package's host ISR on its numpy path."""
    monkeypatch.setattr(jnative, "available", lambda: False)


# ---------------------------------------------------------------------------
# config, host ISR, dataset, panel
# ---------------------------------------------------------------------------

OVERRIDES = [
    "seed=7", "uda.pseudo_threshold=0.9", "optim.max_iters=4e4",
    "data.crop_size=256,128", "uda.isr_params=1-100-0.01-0.1-3",
    "data.target_isr_3=1-10-0.02-0.05-1,1-10-0.03-0.2-3,1-10-0.04-0.3-5",
    "optim.grad_clip=none", "optim.grad_clip=1.5", "uda.blur=false",
    "uda.random_choice_thres=0.2-0.8", "data.events_clip_range=0.5,1.5",
    "model.backbone=mit_b0", "model.head.channels=64",
    "data.flare_dir=/tmp/flares", "uda.imnet_feature_dist_classes=1,2",
]


def test_apply_overrides_matches_jax():
    for preset in ("cs2dsec", "cs2dz"):
        ours = TC.apply_overrides(TC.PRESETS[preset](), OVERRIDES)
        ref = JC.apply_overrides(
            {"cs2dsec": JC.cs2dsec_image_events_b5,
             "cs2dz": JC.cs2dz_image_rawisr_b5}[preset](), OVERRIDES)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.optim.max_iters == 40000 and ours.optim.grad_clip == 1.5
    assert ours.uda.random_choice_thres == "0.2-0.8"
    for bad, err in (("uda.no_such=1", KeyError), ("nope.x=1", KeyError),
                     ("optim.max_iters=abc", ValueError), ("seed", ValueError)):
        for C in (TC, JC):
            with pytest.raises(err):
                C.apply_overrides(C.tiny_test_config(), [bad])


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_host_image_change_bitwise(direction, numpy_isr):
    rgb = np.random.default_rng(1).integers(0, 256, (37, 53, 3), np.uint8)
    rgb[:, :20] //= 5                       # a dark region: the dead zone
    pil = Image.fromarray(rgb)
    for p in ISR_PARAMS:
        ours = thost.host_image_change(pil, shift_direction=direction, **p)
        ref = jhost.host_image_change(pil, shift_direction=direction, **p)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


def _tree_equal(ours, ref):
    assert set(ours) == set(ref)
    for k in ref:
        a, b = np.asarray(ours[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture(scope="module")
def dz_root(tmp_path_factory):
    return fabricate_dark_zurich(str(tmp_path_factory.mktemp("dz")),
                                 n_images=3, size=(120, 72))


def test_dark_zurich_dataset_bitwise(dz_root, numpy_isr, tmp_path):
    """val (with labels), test, and train (crop, flip, the crop corner's
    'random' direction) with one random.Random per package, the 3-channel
    ISR, and the d2n day pair (no day frames in this tree: no day keys in
    either) and the deflared outputs (over a copy of the tree with darker
    ``night_deflare`` frames): every key bitwise."""
    p = TC.cs2dz_image_rawisr_b5().data.target_isr
    jp = JC.cs2dz_image_rawisr_b5().data.target_isr
    geo = dict(image_resize_size=(96, 64), image_crop_size=(64, 48))
    cases = [
        dict(split="val", outputs=("image", "isr", "label")),
        dict(split="test", outputs=("image", "isr")),
        dict(split="train", shift_type="random"),
        dict(split="train", shift_3_channel=True)]
    for kw in cases:
        three = kw.get("shift_3_channel")
        ours = TDZ(dz_root, isr_params=(TC.DZ_ISR_PRESETS_3["night"] if three
                                        else p), **geo, **kw)
        ref = JDZ(dz_root, isr_params=(JC.DZ_ISR_PRESETS_3["night"] if three
                                       else jp), **geo, **kw)
        assert ours.files == ref.files and len(ours) == 3
        r_ours, r_ref = random.Random(5), random.Random(5)
        for i in range(len(ref)):
            _tree_equal(ours.load(i, r_ours), ref.load(i, r_ref))
    import shutil
    root = str(tmp_path / "dz")
    shutil.copytree(dz_root, root)
    night = os.path.join(root, "rgb_anon", "train", "night")
    shutil.copytree(night, night + "_deflare")
    for seq in os.listdir(night + "_deflare"):
        for name in os.listdir(os.path.join(night + "_deflare", seq)):
            f = os.path.join(night + "_deflare", seq, name)
            Image.fromarray(np.asarray(Image.open(f)) // 2).save(f)
    for kw in (dict(with_day_pair=True),
               dict(outputs=("image_deflare", "isr_deflare"),
                    shift_type="random")):
        ours, ref = (D(root, isr_params=q, **geo, split="train", **kw)
                     for D, q in ((TDZ, p), (JDZ, jp)))
        r_ours, r_ref = random.Random(6), random.Random(6)
        for i in range(len(ref)):
            got = ours.load(i, r_ours)
            _tree_equal(got, ref.load(i, r_ref))
        assert set(got) == set(kw.get("outputs", ("image", "isr")))
    for D, q in ((TDZ, p), (JDZ, jp)):
        with pytest.raises(NotImplementedError, match="auto_threshold"):
            D(dz_root, isr_params=q, auto_threshold=True)


def test_show_result_opacity_bitwise(tmp_path):
    g = np.random.default_rng(3)
    image = g.normal(size=(20, 24, 3)).astype(np.float32)
    pred = g.integers(0, 19, (20, 24))
    gt = g.integers(0, 19, (20, 24))
    gt[:3] = 255
    isr = np.clip(g.normal(size=(20, 24, 3)), -1, 1).astype(np.float32)
    for opacity in (None, 0.5, 1.0):
        ours = tvis.show_result(image, pred, gt=gt, events=isr,
                                opacity=opacity,
                                out_path=str(tmp_path / "a" / "p.png"))
        ref = jvis.show_result(image, pred, gt=gt, events=isr,
                               opacity=opacity)
        assert np.array_equal(ours, ref)
        assert np.array_equal(np.asarray(Image.open(tmp_path / "a" /
                                                     "p.png")), ref)
    with pytest.raises(ValueError):
        tvis.show_result(image, pred, opacity=0.0)


def _pool_project(pool, conv, resize, weight):
    """The cheap apply function of the aug-test check, one per framework:
    a stride-4 average pool, a 1x1 projection to 19 classes and a
    bilinear resize back to the input's size."""
    def apply(x):
        return resize(conv(pool(x), weight), x.shape[1:3])
    return apply


def test_multi_scale_flip_inference_matches_jax():
    """The six aug-test scales with flips on a 54x90 frame, whose scaled
    sides land on .5 at 0.75, 1.25 and 1.75: Python's round sizes them
    (40.5 -> 40, 67.5 -> 68, 94.5 -> 94; 112.5 -> 112, 157.5 -> 158) in
    both packages; probabilities to 1e-6."""
    g = np.random.default_rng(4)
    img = g.normal(size=(2, 54, 90, 6)).astype(np.float32)
    weight = g.normal(size=(6, 19)).astype(np.float32)
    seen = {"jax": [], "torch": []}

    def jpool(x):
        seen["jax"].append(tuple(x.shape[1:3]))
        return jax.lax.reduce_window(x, 0.0, jax.lax.add, (1, 4, 4, 1),
                                     (1, 4, 4, 1), "VALID") / 16.0

    def tpool(x):
        seen["torch"].append(tuple(x.shape[1:3]))
        return F.avg_pool2d(x.permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1)

    scales = tloop.TTA_SCALES
    ref = jseg.multi_scale_flip_inference(
        _pool_project(jpool, jnp.matmul, jresize, jnp.asarray(weight)),
        jnp.asarray(img), scales=scales, flip=True)
    ours = tseg.multi_scale_flip_inference(
        _pool_project(tpool, torch.matmul, tresize, torch.from_numpy(weight)),
        torch.from_numpy(img), scales=scales, flip=True)
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][2::2] == [(40, 68), (54, 90), (68, 112), (81, 135),
                                   (94, 158)]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=PROB_ATOL)


def test_slide_grid_clamps_the_last_crops():
    assert tseg.slide_grid((80, 112), (64, 64), (43, 43)) == [
        (0, 0), (0, 43), (0, 48), (16, 0), (16, 43), (16, 48)]
    assert tseg.slide_grid((540, 960), (512, 512), (341, 341)) == [
        (0, 0), (0, 341), (0, 448), (28, 0), (28, 341), (28, 448)]
    assert len(tseg.slide_grid((1080, 1920), (512, 512), (341, 341))) == 18
    assert tseg.slide_grid((64, 64), (64, 64), (43, 43)) == [(0, 0)]


# ---------------------------------------------------------------------------
# the micro cs2dz model in both packages
# ---------------------------------------------------------------------------

class JitApply:
    """A JAX module whose ``apply`` is jitted once per shape and call
    signature."""

    def __init__(self, module):
        self.module = module
        self.apply = jax.jit(module.apply, static_argnames=("mode", "output"))


@pytest.fixture(scope="module")
def models():
    """JAX module, its variables (student: seed 3; the EMA teacher's
    parameters: seed 4, with other BN statistics), and the port's student
    and teacher modules loaded from them; the teacher module's BN buffers
    are the seed-4 statistics, not the student's."""
    jcfg, cfg = _micro_dz(JC), _micro_dz(TC)
    jm = JFED(jcfg.model)
    x = np.zeros((1, 32, 32, 3), np.float32)

    def init():
        return jm.init(jax.random.PRNGKey(0), x, x, None, mode="default",
                       method=jm.forward_logits)
    v = random_variables(init, seed=3)
    v_ema = random_variables(init, seed=4)
    student = load_jax_variables(tapis.build_model(cfg, "cpu"), v)
    teacher = load_jax_variables(tapis.build_model(cfg, "cpu"), v_ema)
    jstate = SimpleNamespace(params=v["params"], ema_params=v_ema["params"],
                             batch_stats=v["batch_stats"])
    return SimpleNamespace(jcfg=jcfg, cfg=cfg, jm=jm, japply=JitApply(jm),
                           v=v, v_ema=v_ema, student=student,
                           teacher=teacher, jstate=jstate)


def _port_checkpoint(models, path):
    """A port checkpoint of the pair, as save_checkpoint writes one."""
    torch.save({"state_dict": models.student.state_dict(),
                "ema_state_dict": models.teacher.state_dict(),
                "step": 0}, path)
    return str(path)


def test_teacher_model_shares_ema_params_and_student_bn(models):
    state = DACSTrainState(model=models.student, ema_model=models.teacher,
                           optimizer=None)
    t = tloop.teacher_model(state)
    for (k, p), q in zip(t.named_parameters(), models.teacher.parameters()):
        assert p is q, k
    students = dict(models.student.named_buffers())
    own = dict(models.teacher.named_buffers())
    moved = 0
    for k, b in t.named_buffers():
        assert b is students[k], k
        moved += not torch.equal(own[k], students[k])
    assert moved > 0          # the teacher module's own statistics differ


def test_init_segmentor_port_checkpoint_teacher_and_overrides(models,
                                                              tmp_path):
    assert (inspect.signature(tapis.init_segmentor).parameters["config"]
            .default == inspect.signature(japis.init_segmentor)
            .parameters["config"].default == "cs2dz")
    ckpt = _port_checkpoint(models, tmp_path / "iter_1.pth")
    seg = tapis.init_segmentor(models.cfg, ckpt, device="cpu")
    for k, t in seg.model.state_dict().items():
        assert torch.equal(t, models.student.state_dict()[k]), k
    assert seg.output == "image"
    seg = tapis.init_segmentor(models.cfg, ckpt, device="cpu",
                               use_teacher=True,
                               overrides=["seed=5", "uda.alpha=0.9"])
    assert seg.cfg.seed == 5 and seg.cfg.uda.alpha == 0.9
    params = dict(models.teacher.named_parameters())
    buffers = dict(models.student.named_buffers())
    for k, t in seg.model.state_dict().items():
        assert torch.equal(t, params[k] if k in params else buffers[k]), k
    # a reference checkpoint: mmseg prefixes, its teacher is its student
    ref = {**{f"model.{k}": t for k, t in models.student.state_dict().items()},
           **{f"ema_model.{k}": t + 1
              for k, t in models.teacher.state_dict().items()}}
    torch.save({"state_dict": ref, "meta": {}}, tmp_path / "iter_40000.pth")
    seg = tapis.init_segmentor(models.cfg, str(tmp_path / "iter_40000.pth"),
                               device="cpu", use_teacher=True)
    for k, t in seg.model.state_dict().items():
        assert torch.equal(t, models.student.state_dict()[k]), k


def test_infer_cli_writes_inference_segmentors_prediction(models, tmp_path,
                                                         monkeypatch):
    monkeypatch.setitem(TC.PRESETS, "cs2dz", lambda: models.cfg)
    ckpt = _port_checkpoint(models, tmp_path / "iter_1.pth")
    rgb = np.random.default_rng(6).integers(0, 256, (50, 70, 3), np.uint8)
    png = str(tmp_path / "night.png")
    Image.fromarray(rgb).save(png)
    out = tmp_path / "out"
    got = tinfer.main([png, "--config", "cs2dz", "--checkpoint", ckpt,
                       "--output-type", "fusion", "--use-teacher", "--panel",
                       "--out-dir", str(out), "--device", "cpu"])
    seg = tapis.init_segmentor("cs2dz", ckpt, device="cpu", output="fusion",
                               use_teacher=True)
    ref = tapis.inference_segmentor(seg, png)
    assert np.array_equal(np.asarray(Image.open(out / "night_pred.png")), ref)
    assert np.array_equal(got[png], ref)
    assert np.array_equal(np.asarray(Image.open(out / "night_color.png")),
                          tvis.colorize_label(ref))
    panel = np.asarray(Image.open(out / "night_panel.png"))
    assert panel.shape == (50, 70 * 3, 3)


def test_train_cli_set_round_trip():
    sets = ["--set", "uda.alpha=0.99", "--set", "optim.max_iters=4e4",
            "--set", "data.crop_size=48,48", "--set", "uda.teacher_bf16=false"]
    args = ttrain.parse_args(["--synthetic", "--config", "cs2dz",
                              "--teacher-bf16"] + sets)
    cfg = ttrain.build_config(args)
    ref = JC.apply_overrides(JC.cs2dz_image_rawisr_b5(), sets[1::2]
                             + ["uda.teacher_bf16=true"])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.uda.teacher_bf16        # --teacher-bf16 after --set
    with pytest.raises(KeyError, match="no_such"):
        ttrain.build_config(ttrain.parse_args(
            ["--synthetic", "--set", "uda.no_such=1"]))


def test_clis_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    png = str(tmp_path / "x.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(png)
    for run in (lambda: ttest.main(["--config", "tiny", "--synthetic"]),
                lambda: tinfer.main([png, "--config", "tiny"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()


# ---------------------------------------------------------------------------
# evaluate_fusion, the test CLI and the submission against the JAX package
# ---------------------------------------------------------------------------

def _jax_evaluate(models, monkeypatch, dataset, state=None, **kw):
    """The JAX package's evaluate_fusion with its whole-batch jit taken out
    and the model's forwards jitted per shape (``JitApply``): the same
    code path, compiled in pieces."""
    monkeypatch.setattr(jloop, "jax", SimpleNamespace(
        jit=lambda f: f, process_count=jax.process_count,
        process_index=jax.process_index, device_get=jax.device_get))
    try:
        return jloop.evaluate_fusion(
            SimpleNamespace(model=models.japply), state or models.jstate,
            dataset, **kw)
    finally:
        monkeypatch.setattr(jloop, "jax", jax)


def _recorder(monkeypatch):
    seen = {"jax": [], "torch": []}
    for tag, mod in (("jax", jloop), ("torch", tloop)):
        def wrapped(pred, label, num_classes, tag=tag,
                    fn=mod.intersect_and_union):
            seen[tag].append(np.array(pred))
            return fn(pred, label, num_classes)
        monkeypatch.setattr(mod, "intersect_and_union", wrapped)
    return seen


def _synthetic(size, with_second=True, length=2):
    """Synthetic target test sets of both packages; without the second
    modality an image-only dataset."""
    kw = dict(crop_size=size, length=length, with_events=False,
              test_mode=True)
    ours, ref = SyntheticTarget(**kw), JSyntheticTarget(**kw)
    if with_second:
        return ours, ref

    class ImageOnly:
        def __init__(self, base):
            self.base = base

        def __len__(self):
            return len(self.base)

        def __getitem__(self, i):
            s = self.base[i]
            return {"image": s["image"], "label": s["label"]}
    return ImageOnly(ours), ImageOnly(ref)


EVAL_CASES = {
    "whole_fusion": dict(output="fusion"),
    "whole_image": dict(output="image"),
    "whole_isr": dict(output="isr"),
    "image_only": dict(output="fusion", image_only=True),
    "use_teacher": dict(output="fusion", use_teacher=True),
    "slide": dict(output="fusion", size=(112, 80), inference="slide",
                  slide_crop=(64, 64), slide_stride=(43, 43)),
    "aug_test": dict(output="fusion", aug_test=True),
}


def _scores(model, dataset, case):
    """The port's per-sample scores behind its labels: logits at the input
    size, or the aug-test's averaged probabilities."""
    out = []
    for i in range(len(dataset)):
        s = dataset[i]
        x = torch.from_numpy(s["image"])[None]
        second = (torch.from_numpy(s["isr"])[None] if "isr" in s else None)
        both = x if second is None else torch.cat([x, second], -1)

        def full(y):
            return tresize(tapis.select_logits(
                model, y[..., :3], y[..., 3:] if y.shape[-1] > 3 else None,
                case["output"]), y.shape[1:3])
        with torch.no_grad():
            if case.get("aug_test"):
                z = tseg.multi_scale_flip_inference(
                    full, both, scales=tloop.TTA_SCALES, flip=True)
            elif case.get("inference") == "slide":
                z = tseg.slide_inference(
                    full, both, crop_size=case["slide_crop"],
                    stride=case["slide_stride"], num_classes=19)
            else:
                z = full(both)
        out.append(z[0].numpy())
    return out


@pytest.mark.parametrize("name", list(EVAL_CASES))
def test_evaluate_fusion_matches_jax(name, models, monkeypatch):
    """Every prediction both evaluations score is recorded and compared,
    then the summaries. The teacher: the port's DACSTrainState holds a
    teacher module whose BN buffers are not the student's, and the JAX
    state's teacher runs on the student's batch_stats."""
    case = EVAL_CASES[name]
    ours_set, ref_set = _synthetic(case.get("size", HW),
                                   not case.get("image_only"))
    seen = _recorder(monkeypatch)
    kw = {k: v for k, v in case.items() if k not in ("size", "image_only")}
    ref = _jax_evaluate(models, monkeypatch, ref_set, batch_size=2, **kw)
    state = DACSTrainState(model=models.student, ema_model=models.teacher,
                           optimizer=None)
    ours = tloop.evaluate_fusion(state, ours_set, batch_size=2, **kw)
    assert len(seen["torch"]) == len(seen["jax"]) == 2
    model = tloop.teacher_model(state) if kw.get("use_teacher") else (
        models.student)
    exact = all(np.array_equal(a, b) for a, b in zip(seen["torch"],
                                                     seen["jax"]))
    if not exact:
        for a, b, z in zip(seen["torch"], seen["jax"],
                           _scores(model, ours_set, case)):
            assert_labels_match(a, b, z, PROB_MARGIN
                                if case.get("aug_test") else MARGIN)
    else:
        for k in ("mIoU", "aAcc", "mAcc", "mIoU_18cls"):
            assert ours[k] == pytest.approx(ref[k], abs=1e-12), k
    if name == "use_teacher":
        # the teacher module's own BN buffers give other labels
        alone = tloop.evaluate_fusion(models.teacher, ours_set, batch_size=2)
        assert alone["mIoU"] != ours["mIoU"]


def test_evaluate_fusion_refuses_aug_test_with_slide(models, monkeypatch):
    kw = dict(inference="slide", aug_test=True)
    ours_set, ref_set = _synthetic(HW)
    with pytest.raises(ValueError, match="whole-image"):
        _jax_evaluate(models, monkeypatch, ref_set, **kw)
    with pytest.raises(ValueError, match="whole-image"):
        tloop.evaluate_fusion(models.student, ours_set, **kw)
    with pytest.raises(ValueError, match="DACSTrainState"):
        tloop.evaluate_fusion(models.student, ours_set, use_teacher=True)


@pytest.mark.parametrize("chunk,size", [(None, (112, 80)), (4, (112, 80)),
                                        (None, (64, 64))])
def test_slide_inference_matches_jax(models, chunk, size):
    """80x112 with crop 64 and stride 43 (a 2x3 grid whose last row and
    column are clamped), all crops in one forward or in chunks of 4 (4 +
    2); and a frame the size of the crop. The JAX reference folds all the
    crops into one forward (its chunking is the same sum)."""
    g = np.random.default_rng(7)
    both = g.normal(size=(2, size[1], size[0], 6)).astype(np.float32)

    def japply(x):
        return models.japply.apply(models.v, x[..., :3], x[..., 3:], None,
                                   mode="default", output="fusion")

    def tapply(x):
        return tresize(tapis.select_logits(models.student, x[..., :3],
                                           x[..., 3:], "fusion"),
                       x.shape[1:3])
    kw = dict(crop_size=(64, 64), stride=(43, 43), num_classes=19)
    ref = np.asarray(jseg.slide_inference(japply, jnp.asarray(both), **kw))
    with torch.no_grad():
        ours = tseg.slide_inference(tapply, torch.from_numpy(both),
                                    crop_chunk=chunk, **kw).numpy()
    assert ours.shape == ref.shape == (2, size[1], size[0], 19)
    assert np.abs(ours - ref).max() <= SLIDE_RTOL * np.abs(ref).max()


def _cli_preset(models, monkeypatch):
    monkeypatch.setitem(TC.PRESETS, "cs2dz", lambda: models.cfg)


def test_test_cli_modes_and_show_dir(models, tmp_path, monkeypatch, capsys):
    """``tools.test.main`` on synthetic data: whole, slide, aug-test and the
    teacher give evaluate_fusion's summaries; --show-dir is renamed with
    the score; --target-txt scores the DSEC test list for a DSEC target
    and is refused for a DarkZurich one."""
    _cli_preset(models, monkeypatch)
    ckpt = _port_checkpoint(models, tmp_path / "iter_1.pth")
    base = ["--config", "cs2dz", "--checkpoint", ckpt, "--synthetic",
            "--device", "cpu", "--max-samples", "2"]
    data = SyntheticTarget(crop_size=HW, length=8, with_events=False,
                           test_mode=True)
    student = tapis.init_segmentor(models.cfg, ckpt, device="cpu")
    teacher = tapis.init_segmentor(models.cfg, ckpt, device="cpu",
                                   use_teacher=True)
    runs = {
        "whole": ([], student, {}),
        "slide": (["--inference", "slide", "--slide-crop", "32", "32",
                   "--slide-stride", "21", "21", "--slide-crop-chunk", "4"],
                  student, dict(inference="slide", slide_crop=(32, 32),
                                slide_stride=(21, 21), slide_crop_chunk=4)),
        "aug": (["--aug-test"], student, dict(aug_test=True)),
        "teacher": (["--use-teacher", "--output-type", "isr"], teacher,
                    dict(output="isr")),
    }
    for name, (flags, seg, kw) in runs.items():
        got = ttest.main(base + flags)
        ref = tloop.evaluate_fusion(seg, data, max_samples=2, **kw)
        assert got == ref, name
    show = str(tmp_path / "panels")
    got = ttest.main(base + ["--show-dir", show, "--opacity", "0.5"])
    scored = f"{show}_{got['mIoU'] * 100:.2f}"
    assert got["show_dir"] == scored and not os.path.exists(show)
    assert sorted(os.listdir(scored)) == ["000000.png", "000001.png"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "show_dir": scored}
    # --target-txt: refused for the DarkZurich target; for a DSEC target
    # (the micro cs2dsec preset, random weights) the DSEC-Night test list,
    # scored at 440x640
    _, test_txt = fabricate_dsec_with_labels(str(tmp_path / "dsec"), 3, 1500)
    with pytest.raises(ValueError, match="--target-txt.*dark_zurich"):
        ttest.main(["--config", "cs2dz", "--checkpoint", ckpt,
                    "--target-txt", test_txt, "--device", "cpu"])
    dsec_cfg = TC.micro_test_config()
    monkeypatch.setitem(TC.PRESETS, "cs2dsec", lambda: dsec_cfg)
    dsec = ttest.build_dataset(dsec_cfg, ttest.parse_args(
        ["--config", "cs2dsec", "--target-txt", test_txt]))
    assert isinstance(dsec, TDSEC) and dsec.test_mode and len(dsec) == 2
    assert dsec[0]["events"].shape == (440, 640, 3)
    dsec_ckpt = str(tmp_path / "dsec_iter_1.pth")
    net = tapis.build_model(dsec_cfg, "cpu", seed=5)
    torch.save({"state_dict": net.state_dict(),
                "ema_state_dict": net.state_dict(), "step": 0}, dsec_ckpt)
    got = ttest.main(["--config", "cs2dsec", "--checkpoint", dsec_ckpt,
                      "--target-txt", test_txt, "--device", "cpu"])
    assert got == tloop.evaluate_fusion(
        tapis.init_segmentor(dsec_cfg, dsec_ckpt, device="cpu"), dsec)
    assert math.isfinite(got["mIoU"])


def test_submission_matches_jax_export(models, dz_root, tmp_path, monkeypatch,
                                       numpy_isr):
    """``tools.test.main --submit-to-website`` on a DarkZurich tree resized
    to 96x64 (so 64 -> 1080 is a non-integer factor), image and fusion
    streams: the three PNG trees equal those of the JAX package's
    ``export_submission`` on the same weights, file for file."""
    _cli_preset(models, monkeypatch)
    monkeypatch.setattr(ttest, "DarkZurichDataset", functools.partial(
        TDZ, image_resize_size=(96, 64)))
    ckpt = _port_checkpoint(models, tmp_path / "iter_1.pth")
    jdata = JDZ(dz_root, split="test", image_resize_size=(96, 64),
                isr_params=models.jcfg.data.target_isr,
                outputs=("image", "isr"))
    for stream in ("image", "fusion"):
        ours_dir, ref_dir = tmp_path / f"t_{stream}", tmp_path / f"j_{stream}"
        info = ttest.main(["--config", "cs2dz", "--checkpoint", ckpt,
                           "--target-root", dz_root, "--device", "cpu",
                           "--submit-to-website", "--show-dir",
                           str(ours_dir)]
                          + (["--output-type", "fusion"]
                             if stream == "fusion" else []))
        assert info["stream"] == stream and info["submitted"] == 3
        jexport_submission(
            SimpleNamespace(model=models.japply), models.jstate, jdata,
            SimpleNamespace(show_dir=str(ref_dir), use_teacher=False,
                            max_samples=None, output_type=stream),
            models.jcfg)
        for sub in ("labelTrainIds", "labelTrainIds_invalid", "confidence"):
            names = sorted(os.listdir(ref_dir / sub))
            assert sorted(os.listdir(ours_dir / sub)) == names
            assert len(names) == 3
            for n in names:
                a = Image.open(ours_dir / sub / n)
                b = Image.open(ref_dir / sub / n)
                assert a.size == b.size == (1920, 1080) and a.mode == b.mode
                assert np.array_equal(np.asarray(a), np.asarray(b)), (sub, n)

