"""The port's serving slice against the JAX package on the same weights:
``inference_segmentor`` on a PNG (events given, and image-only through the
on-the-fly ISR), ``evaluate_fusion`` on synthetic samples, and the weight
round trip through the reference state_dict layout.

Labels must agree except at near ties: where the top-2 logit margin is
below 2e-4, twice the model parity tolerance of test_torch_models.py."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from cmda_tpu import apis as japis
from cmda_tpu import config as JC
from cmda_tpu.data.host_isr import host_image_change
from cmda_tpu.data.synthetic import SyntheticTarget as JSyntheticTarget
from cmda_tpu.models.segmentor import FusionEncoderDecoder as JFED
from cmda_tpu.train import loop as jloop
from cmda_tpu.uda.dacs import DACSTrainer
from cmda_tpu.utils.torch_import import convert_fusion_checkpoint
from cmda_tpu_torch import apis as tapis
from cmda_tpu_torch import config as TC
from cmda_tpu_torch.data.synthetic import SyntheticTarget
from cmda_tpu_torch.ops.fused_resize import fused_resize_argmax
from cmda_tpu_torch.ops.isr_kernel import batched_isr
from cmda_tpu_torch.train import loop as tloop
from cmda_tpu_torch.utils.weights import (load_jax_variables,
                                          load_reference_state_dict)

from torch_port_util import assert_labels_match, random_variables

MARGIN = 2e-4


@pytest.fixture(scope="module")
def pair():
    """(JAX Segmentor, port Segmentor, JAX variables) for the micro config
    on one set of seeded weights."""
    jcfg = JC.micro_test_config()
    jm = JFED(jcfg.model)
    x = np.zeros((1, 32, 32, 3), np.float32)
    v = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), x, x, x, mode="fusion_all",
        method=jm.forward_logits), seed=11)
    state = SimpleNamespace(params=v["params"], ema_params=v["params"],
                            batch_stats=v["batch_stats"])
    jseg = japis.Segmentor(jcfg, state, output="fusion")
    tseg = tapis.init_segmentor(TC.micro_test_config(), device="cpu",
                                output="fusion")
    load_jax_variables(tseg.model, v)
    return jseg, tseg, v


@pytest.fixture()
def png(tmp_path):
    rgb = np.random.default_rng(5).integers(0, 256, size=(44, 60, 3),
                                            dtype=np.uint8)
    rgb[:, :20] //= 4            # a dark region, for the ISR dead zone
    path = str(tmp_path / "frame.png")
    Image.fromarray(rgb).save(path)
    return path


def test_inference_segmentor_with_events(pair, png):
    jseg, tseg, _ = pair
    events = np.clip(np.random.default_rng(6).normal(size=(44, 60, 3)), -1,
                     1).astype(np.float32)
    ref = japis.inference_segmentor(jseg, png, second=events)
    ours = tapis.inference_segmentor(tseg, png, second=events)
    assert ours.shape == (44, 60) and ours.dtype == np.int32
    jlogits, _ = jseg(tapis.normalize_image(tapis.open_rgb(png)), events)
    assert_labels_match(ours, ref, jlogits, MARGIN)


def test_inference_segmentor_image_only_runs_isr(pair, png):
    """Image-only input: the port's ISR (PIL-exact gray -> batched_isr)
    equals the JAX package's host ISR, and the prediction its Segmentor's."""
    jseg, tseg, _ = pair
    pil = tapis.open_rgb(png)
    p = jseg.cfg.data.target_isr
    host = host_image_change(pil, val_range=tuple(p.val_range),
                             threshold=p.threshold, clip_range=p.clip_range,
                             shift_pixel=p.shift_pixel,
                             shift_direction="leftdown")
    isr = tapis.image_isr(tseg, pil)
    np.testing.assert_allclose(isr[..., 0].numpy(), host, atol=1e-5)
    ref = japis.inference_segmentor(jseg, png)
    ours = tapis.inference_segmentor(tseg, png)
    jlogits, _ = jseg(tapis.normalize_image(pil),
                      np.repeat(host[..., None], 3, axis=-1))
    assert_labels_match(ours, ref, jlogits, MARGIN)


def test_image_isr_shift_all_matches_host_isr(pair, png):
    """``data.shift_type='all'``: the port's image-only ISR (two kernel
    directions averaged) equals the JAX package's host ISR, the mean of
    the four one-sided terms, to 1e-5."""
    _, tseg, _ = pair
    cfg = TC.replace(tseg.cfg, data=TC.replace(tseg.cfg.data,
                                               shift_type="all"))
    seg = tapis.Segmentor(cfg, tseg.model, output="fusion")
    pil = tapis.open_rgb(png)
    p = cfg.data.target_isr
    host = host_image_change(pil, val_range=tuple(p.val_range),
                             threshold=p.threshold, clip_range=p.clip_range,
                             shift_pixel=p.shift_pixel, shift_direction="all")
    isr = tapis.image_isr(seg, pil)
    assert isr.shape == (44, 60, 3)
    np.testing.assert_allclose(isr[..., 0].numpy(), host, atol=1e-5, rtol=0)


def test_segmentor_call_returns_logits_and_pred(pair):
    jseg, tseg, _ = pair
    img = np.random.default_rng(8).normal(size=(40, 50, 3)).astype(np.float32)
    jl, jp = jseg(img)
    tl, tp = tseg(img)
    assert tl.shape == (40, 50, 19) and tp.dtype == np.int32
    np.testing.assert_allclose(tl, np.asarray(jl), atol=1e-4, rtol=1e-4)
    assert_labels_match(tp, jp, jl, MARGIN)


def test_evaluate_fusion_matches_jax(pair, monkeypatch):
    """Same histograms on 3 synthetic samples: every prediction the two
    evaluations score is recorded and compared, then the summaries."""
    jseg, tseg, v = pair
    seen = {"jax": [], "torch": []}

    def recorder(tag, fn):
        def wrapped(pred, label, num_classes):
            seen[tag].append(np.asarray(pred))
            return fn(pred, label, num_classes)
        return wrapped

    monkeypatch.setattr(jloop, "intersect_and_union",
                        recorder("jax", jloop.intersect_and_union))
    monkeypatch.setattr(tloop, "intersect_and_union",
                        recorder("torch", tloop.intersect_and_union))
    kw = dict(crop_size=(40, 32), length=3, test_mode=True)
    state = SimpleNamespace(params=v["params"], ema_params=v["params"],
                            batch_stats=v["batch_stats"])
    ref = jloop.evaluate_fusion(DACSTrainer(jseg.cfg), state,
                                JSyntheticTarget(**kw), batch_size=3)
    ours = tloop.evaluate_fusion(tseg, SyntheticTarget(**kw), batch_size=2)
    assert len(seen["torch"]) == len(seen["jax"]) == 3
    data = SyntheticTarget(**kw)
    exact = True
    for i, (a, b) in enumerate(zip(seen["torch"], seen["jax"])):
        if not np.array_equal(a, b):
            exact = False
            s = data[i]
            with torch.no_grad():
                logits = tseg.model(torch.from_numpy(s["image"])[None],
                                    torch.from_numpy(s["events"])[None])
            assert_labels_match(a, b, logits[0].numpy(), MARGIN)
    if exact:
        for k in ("mIoU", "aAcc", "mAcc", "mIoU_18cls"):
            assert ours[k] == pytest.approx(ref[k], abs=1e-12), k
        assert ours["per_class_iou"].keys() == ref["per_class_iou"].keys()


def test_evaluate_fusion_uses_the_kernel_wrapper(pair, monkeypatch):
    """Integer-factor geometry goes through fused_resize_argmax; a size
    that is not a multiple of 4 goes to the plain resize+argmax."""
    _, tseg, _ = pair
    calls = []
    real = tapis.fused_resize_argmax

    def spy(*a, **k):
        calls.append(a[1])
        return real(*a, **k)

    monkeypatch.setattr(tapis, "fused_resize_argmax", spy)
    tloop.evaluate_fusion(tseg, SyntheticTarget(crop_size=(40, 32), length=1,
                                                test_mode=True))
    assert calls == [(32, 40)]
    tloop.evaluate_fusion(tseg, SyntheticTarget(crop_size=(42, 30), length=1,
                                                test_mode=True))
    assert calls == [(32, 40)]


def test_state_dict_round_trip_through_reference_layout(pair):
    """The port's state_dict, read by the JAX package's reference-checkpoint
    converter, gives back the JAX variables it was loaded from: the port's
    keys are the reference mmseg keys."""
    _, tseg, v = pair
    sd = {k: t.numpy() for k, t in tseg.model.state_dict().items()}
    conv = convert_fusion_checkpoint(sd, depths=(1, 1, 1, 1),
                                     fusion="attention_avg",
                                     fusion_isr="attention")
    got = jax.tree_util.tree_flatten_with_path(conv)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(
        {"params": v["params"], "batch_stats": v["batch_stats"]})[0])
    assert len(got) == len(want)
    for path, arr in got:
        np.testing.assert_array_equal(np.asarray(arr), want[path],
                                      err_msg=jax.tree_util.keystr(path))


def test_load_reference_state_dict_strips_prefixes(pair):
    _, tseg, _ = pair
    src = tseg.model.state_dict()
    ckpt = {f"module.model.{k}": t + 1 for k, t in src.items()}
    ckpt["ema_model.backbone_image.norm1.weight"] = torch.zeros(1)
    other = tapis.build_model(TC.micro_test_config(), device="cpu", seed=3)
    load_reference_state_dict(other, ckpt)
    for k, t in other.state_dict().items():
        torch.testing.assert_close(t, src[k] + 1, rtol=0, atol=0)
    del ckpt["module.model.decode_head.conv_seg.bias"]
    with pytest.raises(KeyError, match="conv_seg.bias"):
        load_reference_state_dict(other, ckpt)


def test_wrappers_on_cpu_launch_nothing():
    before = (fused_resize_argmax.launches, batched_isr.launches)
    fused_resize_argmax(torch.zeros(1, 2, 3, 4), (4, 6))
    batched_isr(torch.zeros(1, 4, 6), torch.zeros(1, dtype=torch.int32),
                val_range=(1.0, 10.0), threshold=0.01, clip_range=0.1)
    assert (fused_resize_argmax.launches, batched_isr.launches) == before == (
        0, 0)
