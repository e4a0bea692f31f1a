"""The rest of the DACS trainer in the port against the JAX package, on the
CPU, from seeded numpy inputs: the DarkZurich ablation train types
``cs2dz_image+raw-isr_split``, ``cs2dz_image+raw-isr_no-fusion`` (edge
labels, the ISR-feature consistency) and ``cs2dz_image+d2n-isr``, the
deflared teacher input (``uda.deflare_aug``) and the ImageNet feature
distance.

Pieces, each against its JAX function:
* ``seg_label_to_edge_label`` bitwise, with ignored pixels and the image's
  edges; ``downscale_label_ratio`` bitwise; ``feature_consistency_loss`` and
  ``masked_feat_dist`` to 1e-6 relative;
* the class-weighted CE and ``split_stream_loss`` at factor 1 and 2, with no
  edge class weight and with [0.1, 0.9]: the value to 1e-5 relative, the
  logits' gradients to 1e-4 of their largest;
* the head with ``split_cls`` and ``events_classes=2`` in training (the
  Dropout2d masks the JAX head draws recorded) and in eval, and the
  micro segmentor's ``no_fusion`` training forward at non-zero drop-path
  and Dropout2d rates (the JAX forward's uniforms recorded): logits and
  BatchNorm statistics to 1e-5 of each tensor's largest;
* ``EncoderDecoder.extract_feat`` and its logits to 1e-5;
* ``_prepare`` of the split type with ``deflare_aug`` and of d2n against the
  jitted JAX ``_prepare`` (one trace each): masks, labels and weights equal
  but at near ties of the JAX teacher's logits (the existing rule), the
  d2n mixed ISR equal;
* ``DarkZurichDataset`` with the day pair and the deflared outputs, over
  files this test writes, bitwise against the JAX dataset (its numpy host
  ISR);
* the train CLI for two iterations of the no-fusion type with edge labels
  and the feature distance (``--imnet``).

Last, the one jitted JAX DACS step compile of the file: the no-fusion type
with ``isr_edge``, no edge class weight (the C = 2 stream CE) and the
feature distance on, one step of both packages from one seeded state
(``test_torch_train.py``'s tolerances: logs rtol 1e-4, BatchNorm statistics
and EMA 1e-5, AdamW first and second moments 1e-4 of each leaf's largest,
parameters 2 lr head_lr_mult).
"""
import functools
import os
import random
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from cmda_tpu import config as JC
from cmda_tpu import native as jnative
from cmda_tpu.data.dark_zurich import DarkZurichDataset as JDZ
from cmda_tpu.data.synthetic import SyntheticSource, SyntheticTarget
from cmda_tpu.models import daformer as jdaformer
from cmda_tpu.models.segmentor import (EncoderDecoder as JED,
                                       FusionEncoderDecoder as JFED)
from cmda_tpu.ops import losses as jlosses
from cmda_tpu.uda import dacs as jdacs
from cmda_tpu.uda import transforms as jtransforms
from cmda_tpu.uda.dacs import DACSTrainer as JTrainer
from cmda_tpu_torch import config as TC
from cmda_tpu_torch.data.dark_zurich import DarkZurichDataset as TDZ
from cmda_tpu_torch.data.synthetic import uda_batch
from cmda_tpu_torch.models.common import DropPath
from cmda_tpu_torch.models.daformer import Classifier, DAFormerFusionHead
from cmda_tpu_torch.models.segmentor import (EncoderDecoder as TED,
                                             FusionEncoderDecoder as TFED,
                                             ForwardDraws)
from cmda_tpu_torch.ops import losses as tlosses
from cmda_tpu_torch.tools import train as tcli
from cmda_tpu_torch.uda import dacs as tdacs
from cmda_tpu_torch.uda import transforms as ttransforms
from cmda_tpu_torch.uda.dacs import DACSTrainer
from cmda_tpu_torch.utils.weights import (load_jax_train_state,
                                          load_jax_variables,
                                          state_dict_to_tree,
                                          train_state_to_numpy,
                                          tree_to_state_dict)
from tools.make_fake_corpus import fabricate_dark_zurich
from test_torch_train import (_draws, _jax_init_state, _jax_state_numpy,
                              _record_draws)
from test_torch_train_bf16 import _record_pseudo_labels
from test_torch_train_variants import _assert_logs_close, _assert_state_close
from test_torch_uda_options import (_assert_rel_close,
                                    _assert_trees_rel_close, _grad_tree,
                                    _head_feats)
from torch_port_util import assert_labels_match, random_variables

HW = (64, 64)
SPLIT = "cs2dz_image+raw-isr_split"
NO_FUSION = "cs2dz_image+raw-isr_no-fusion"
D2N = "cs2dz_image+d2n-isr"
# the forward tests' rates: the MiT drop-path ramp to 0.6, Dropout2d 0.5
DP_MIT, DROPOUT = 0.6, 0.5


def _t(a):
    return torch.from_numpy(np.array(a))


def _labels(g, shape, c=19, ignored=0.05):
    lbl = g.integers(0, c, size=shape).astype(np.int32)
    lbl[g.random(shape) < ignored] = 255
    return lbl


def _block_labels(g, b, hw, block, classes):
    """[b, H, W] int32 of ``block``-sized squares of ``classes``."""
    h, w = hw
    cells = g.choice(np.asarray(classes), size=(b, h // block, w // block))
    return np.repeat(np.repeat(cells, block, 1), block, 2).astype(np.int32)


# ---------------------------------------------------------------------------
# the loss pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seg_label_to_edge_label_bitwise(seed):
    """Blocky labels with ignored pixels, on and at the image's edge (the
    replicate pad), against the JAX function bitwise."""
    g = np.random.default_rng(seed)
    lbl = _block_labels(g, 2, (24, 40), 4, range(19))
    lbl[g.random(lbl.shape) < 0.03] = 255
    lbl[:, 0, :3] = 255
    lbl[:, -1, -2:] = 255
    ref = np.asarray(jtransforms.seg_label_to_edge_label(jnp.asarray(lbl)))
    got = ttransforms.seg_label_to_edge_label(_t(lbl))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.mean() < 1


@pytest.mark.parametrize("cw", [None, 0.9], ids=["no_cw", "cw0.9"])
def test_class_weighted_ce_matches_jax(cw):
    g = np.random.default_rng(5)
    logits = g.normal(size=(2, 24, 20, 2)).astype(np.float32)
    lbl = _labels(g, (2, 24, 20), c=2)
    weight = g.uniform(size=(2, 24, 20)).astype(np.float32)
    w = None if cw is None else np.array([1 - cw, cw], np.float32)
    ref = jlosses.weighted_cross_entropy(
        jnp.asarray(logits), jnp.asarray(lbl), jnp.asarray(weight),
        class_weight=None if w is None else jnp.asarray(w))
    got = tlosses.weighted_cross_entropy(_t(logits), _t(lbl), _t(weight),
                                         class_weight=None if w is None
                                         else _t(w))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


@pytest.mark.parametrize("factor", [1.0, 2.0])
@pytest.mark.parametrize("cw", [-1.0, 0.9], ids=["cw-1", "cw0.9"])
def test_split_stream_loss_matches_jax(factor, cw):
    """The 19-class image stream and the 2-class edge stream, each with its
    own labels and pixel weights (~5% ignored), at factor 1 (no-fusion, d2n)
    and 2 (split); ``isr_edge_class_weight`` -1 (no class weight: the fused
    CE) and 0.9 (the [0.1, 0.9] class-weighted plain CE): the value and
    logs to 1e-5 relative (acc_seg exactly), the gradients to 1e-4 of their
    largest."""
    g = np.random.default_rng(int(factor * 10) + (cw > 0))
    logits = {"image_output": g.normal(size=(2, 16, 16, 19)),
              "events_output": g.normal(size=(2, 16, 16, 2))}
    logits = {k: v.astype(np.float32) for k, v in logits.items()}
    labels = {"image": _labels(g, (2, 64, 64)),
              "events": _labels(g, (2, 64, 64), c=2)}
    weights = {"image": g.uniform(size=(2, 64, 64)).astype(np.float32),
               "events": g.uniform(size=(2, 64, 64)).astype(np.float32)}
    cwt = None if cw < 0 else np.array([1 - cw, cw], np.float32)
    kw = dict(w_image=0.7, w_events=0.7, factor=factor)

    def jloss(lg):
        return jtransforms.split_stream_loss(
            lg, {k: jnp.asarray(v) for k, v in labels.items()},
            {k: jnp.asarray(v) for k, v in weights.items()},
            events_class_weight=None if cwt is None else jnp.asarray(cwt),
            pallas_ce=False, **kw)
    (ref, jlogs), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in logits.items()})
    lg = {k: _t(v).requires_grad_() for k, v in logits.items()}
    loss, logs = ttransforms.split_stream_loss(
        lg, {k: _t(v) for k, v in labels.items()},
        {k: _t(v) for k, v in weights.items()},
        events_class_weight=None if cwt is None else _t(cwt), **kw)
    loss.backward()
    assert set(logs) == set(jlogs)
    for k, r in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(r), rtol=1e-5,
                                   atol=0 if k == "acc_seg" else 1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    for k in logits:
        _assert_rel_close(lg[k].grad.numpy(), jgrad[k], 1e-4, k)


def test_split_stream_loss_launches_the_ce_only_without_class_weight(
        monkeypatch):
    """The unweighted streams go through ``fused_resize_ce`` (its plain
    version on the CPU), the class-weighted edge stream does not."""
    calls = []
    real = ttransforms.fused_resize_ce
    monkeypatch.setattr(ttransforms, "fused_resize_ce",
                        lambda x, *a, **k: calls.append(x.shape[-1])
                        or real(x, *a, **k))
    g = np.random.default_rng(3)
    lg = {"image_output": _t(g.normal(size=(2, 8, 8, 19)).astype(np.float32)),
          "events_output": _t(g.normal(size=(2, 8, 8, 2)).astype(np.float32))}
    lbl = {"image": _t(_labels(g, (2, 32, 32))),
           "events": _t(_labels(g, (2, 32, 32), c=2))}
    for cw, want in ((None, [19, 2]), (_t(np.array([0.1, 0.9], np.float32)),
                                       [19])):
        calls.clear()
        ttransforms.split_stream_loss(lg, lbl, {}, w_image=1.0, w_events=1.0,
                                      events_class_weight=cw)
        assert calls == want


def test_feature_consistency_and_masked_feat_dist_match_jax():
    g = np.random.default_rng(8)
    shapes = [(2, 8, 16, 16), (2, 16, 8, 8), (2, 24, 4, 4), (2, 32, 2, 2)]
    a = [g.normal(size=s).astype(np.float32) for s in shapes]
    b = [g.normal(size=s).astype(np.float32) for s in shapes]

    def nhwc(xs):
        return [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in xs]
    ref = jtransforms.feature_consistency_loss(nhwc(a), nhwc(b), 0.25)
    ta = [_t(x).requires_grad_() for x in a]
    tb = [_t(x).requires_grad_() for x in b]
    got = ttransforms.feature_consistency_loss(ta, tb, 0.25)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    got.backward()
    assert all(x.grad is None for x in tb)      # the target is detached
    mask = g.random((2, 4, 4)) < 0.4
    ref = jtransforms.masked_feat_dist(nhwc([a[2]])[0], nhwc([b[2]])[0],
                                       jnp.asarray(mask))
    got = ttransforms.masked_feat_dist(_t(a[2]), _t(b[2]), _t(mask))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    none = ttransforms.masked_feat_dist(_t(a[2]), _t(b[2]),
                                        torch.zeros(2, 4, 4, dtype=torch.bool))
    assert none.item() == 0.0


@pytest.mark.parametrize("scale,ratio", [(2, 0.75), (4, 0.5), (32, 0.75)])
def test_downscale_label_ratio_bitwise(scale, ratio):
    g = np.random.default_rng(scale)
    lbl = _block_labels(g, 2, (64, 64), max(scale // 2, 1), range(19))
    lbl[g.random(lbl.shape) < 0.1] = 255
    ref = jtransforms.downscale_label_ratio(jnp.asarray(lbl), scale, ratio,
                                            19)
    got = ttransforms.downscale_label_ratio(_t(lbl), scale, ratio, 19)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# the split head, the no_fusion forward, EncoderDecoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_split_head_matches_jax(train, monkeypatch):
    """The head with ``split_cls`` and a 2-class events classifier over
    four streams (the ISR stream takes the events classifier, the fusion
    stream its own): in training the per-stream loop with one Dropout2d
    mask per stream, recorded from the JAX head, logits, the gradients of
    the parameters and the running statistics to 1e-5 of each tensor's
    largest; in eval, running statistics, the logits to 1e-5.

    The head's gradients are ill-conditioned at some inputs: at seed 51 a
    dilated branch's train-mode BatchNorm amplifies float32 rounding, and
    against a float64 run of the port JAX's float32 gradients came out up
    to 2.6e-2 of a leaf's largest apart (the port's 6e-7); without split
    classifiers at the same seed the port's per-stream loop was the one
    2e-2 apart and JAX within 1e-5. So the test also holds both packages'
    float32 gradients to the port's float64 ones at 1e-5: the seed is one
    where float32 can resolve them, and the comparison is between two
    results that both can be right."""
    b = 2
    jcfg = JC.replace(JC.micro_test_config().model.head,
                      dropout_ratio=DROPOUT)
    tcfg = TC.replace(TC.micro_test_config().model.head,
                      dropout_ratio=DROPOUT)
    g = np.random.default_rng(52)
    feats = _head_feats(g, b, jcfg, 4)
    jm = jdaformer.DAFormerFusionHead(jcfg, split_cls=True, events_classes=2)
    v = random_variables(lambda: jm.init(jax.random.PRNGKey(0), feats),
                         seed=7)
    keys = ("image_output", "events_output", "fusion_output",
            "img_self_res_output")
    width = {"image_output": 19, "events_output": 2, "fusion_output": 19,
             "img_self_res_output": 2}
    cot = {k: g.normal(size=(b, 32, 32, width[k])).astype(np.float32)
           for k in keys}
    rec = _record_draws(monkeypatch)

    def jloss(params, feats):
        out, upd = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, feats,
                            train=train, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(5)})
        return sum(jnp.sum(out[k] * cot[k]) for k in keys), (out, upd)

    @jax.jit
    def jgrad(params, feats):
        rec.clear()
        (_, aux), grads = jax.value_and_grad(jloss, has_aux=True)(params,
                                                                   feats)
        return aux, grads, list(rec)
    (ref, upd), gp, drawn = jgrad(v["params"], feats)
    th = load_jax_variables(DAFormerFusionHead(tcfg, split_cls=True,
                                               events_classes=2), v)
    assert [k for k in th.state_dict() if "conv_seg" in k and
            k.endswith("weight")] == ["conv_seg.weight",
                                      "conv_seg_events.weight",
                                      "conv_seg_fusion.weight"]
    keep = None
    if train:
        drawn = [np.asarray(u) for u in drawn]
        assert [u.shape for u in drawn] == [(b, 1, 1, jcfg.channels)] * 4
        keep = _t(np.stack(drawn)[:, :, 0, 0] < np.float32(1 - DROPOUT))
        assert not keep.all()
    else:
        assert not drawn
    def port(head, dtype):
        tf = {k: [_t(x).permute(0, 3, 1, 2).to(dtype) for x in f]
              for k, f in feats.items()}
        out = head(tf, train=train, bn_train=train, dropout_keep=keep)
        out = {k: o.permute(0, 2, 3, 1) for k, o in out.items()}
        sum((out[k] * _t(cot[k]).to(o.dtype)).sum()
            for k, o in out.items()).backward()
        return out
    out = port(th, torch.float32)
    for k in keys:
        assert out[k].shape[-1] == width[k]
        _assert_rel_close(out[k].detach().numpy(), ref[k], 1e-5, k)
    if train:
        _assert_trees_rel_close(_grad_tree(th, gp), gp, 1e-5, "grad")
        _assert_trees_rel_close(state_dict_to_tree(th.state_dict(),
                                                   upd["batch_stats"]),
                                upd["batch_stats"], 1e-5, "batch_stats")
        # the float64 reference: the classifier in the input's dtype
        monkeypatch.setattr(Classifier, "forward", lambda self, x, keep=None:
                            torch.nn.Conv2d.forward(self, self.dropout(
                                x, keep).to(self.weight.dtype)))
        th64 = load_jax_variables(DAFormerFusionHead(
            tcfg, split_cls=True, events_classes=2), v).double()
        port(th64, torch.float64)
        g64 = _grad_tree(th64, gp)
        _assert_trees_rel_close(_grad_tree(th, gp), g64, 1e-5, "grad f64")
        _assert_trees_rel_close(gp, g64, 1e-5, "JAX grad f64")


def _model_cfg(C, rates=False, **model):
    cfg = C.micro_test_config().model
    return C.replace(cfg, train_type=NO_FUSION, fusion="", fusion_isr="",
                     drop_path_rate=DP_MIT if rates else 0.0,
                     head=C.replace(cfg.head, dropout_ratio=DROPOUT
                                    if rates else 0.0), **model)


def test_no_fusion_forward_train_same_draws_as_jax(monkeypatch):
    """The no-fusion micro segmentor (no fusion module, split classifiers,
    2 events classes) in mode ``no_fusion`` on (image, ISR) at non-zero
    drop-path and Dropout2d rates, 64x64: the uniforms the JAX forward draws
    (4 image stages, 4 events stages [1, 2, B], two Dropout2d masks)
    recorded and handed to the port, whose ``new_draws`` gives those
    shapes: the image and events logits to 1e-5 of each one's largest, the
    BN running statistics to 1e-5."""
    b = 2
    jm = JFED(_model_cfg(JC, rates=True, split_cls=True, events_classes=2))
    g = np.random.default_rng(60)
    image, isr = (g.normal(size=(b, *HW, 3)).astype(np.float32)
                  for _ in range(2))
    v = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), image, isr, None, method=jm.forward_logits),
        seed=21)
    rec = _record_draws(monkeypatch)

    @jax.jit
    def jfwd(v, image, isr):
        rec.clear()
        out = jm.apply(v, image, isr, None, mode="no_fusion",
                       mutable=["batch_stats"],
                       rngs={"droppath": jax.random.PRNGKey(3),
                             "dropout": jax.random.PRNGKey(4)},
                       method=jm.forward_train)
        return out, list(rec)
    ((ref, _), upd), drawn = jfwd(v, image, isr)
    drawn = [np.asarray(u) for u in drawn]
    tm = load_jax_variables(TFED(TC.replace(
        _model_cfg(TC, rates=True, split_cls=True, events_classes=2),
        remat=True)), v)
    new = tm.new_draws(b, generator=torch.Generator().manual_seed(0),
                       device=torch.device("cpu"), with_isr=False)
    assert new.fusion.shape[0] == 0
    assert [u.shape for u in drawn] == (
        [tuple(u.shape) for u in new.image + new.events]
        + [(b, 1, 1, new.dropout_keep.shape[-1])] * 2)
    draws = ForwardDraws(
        image=[_t(u) for u in drawn[:4]], events=[_t(u) for u in drawn[4:8]],
        fusion=new.fusion,
        dropout_keep=_t(np.stack(drawn[-2:] + drawn[-1:])[:, :, 0, 0]
                        < np.float32(1 - DROPOUT)))
    assert not draws.dropout_keep[:2].all()
    with torch.no_grad():
        out, feats = tm.forward_train(_t(image), _t(isr), None, "no_fusion",
                                      draws)
    assert feats["f_fusion"] is None
    assert {k for k, o in out.items() if o is not None} == {
        "image_output", "events_output"}
    assert out["events_output"].shape[-1] == 2
    for k, r in ref.items():
        assert (r is None) == (out[k] is None), k
        if r is not None:
            _assert_rel_close(out[k].numpy(), r, 1e-5, k)
    got = state_dict_to_tree(tm.state_dict(), upd["batch_stats"])
    _assert_trees_rel_close(got, upd["batch_stats"], 1e-5, "batch_stats")


def test_encoder_decoder_matches_jax():
    """The single-backbone segmentor (the frozen ImageNet encoder) filled
    from the JAX variables: ``extract_feat`` per scale and the logits at the
    input size to 1e-5 of their largest; the keys are the reference
    DAFormerHead's."""
    jcfg = JC.micro_test_config().model
    jm = JED(jcfg)
    g = np.random.default_rng(70)
    img = g.normal(size=(2, *HW, 3)).astype(np.float32)
    v = random_variables(lambda: jm.init(jax.random.PRNGKey(0), img), seed=9)
    tm = load_jax_variables(TED(TC.micro_test_config().model), v)
    keys = list(tm.state_dict())
    assert "decode_head.embed_layers.0.proj.weight" in keys
    assert "decode_head.fuse_layer.bottleneck.conv.weight" in keys
    assert "decode_head.conv_seg.weight" in keys
    ref = jm.apply(v, img, method=jm.extract_feat)
    with torch.no_grad():
        got = tm.extract_feat(_t(img))
        logits = tm(_t(img))
    assert len(got) == len(ref) == 4
    for i, (a, r) in enumerate(zip(got, ref)):
        _assert_rel_close(a.permute(0, 2, 3, 1).numpy(), r, 1e-5, f"f{i}")
    _assert_rel_close(logits.numpy(), jm.apply(v, img), 1e-5, "logits")


def test_fusionless_model_falls_back_to_the_image_stream():
    """A model without a fusion module asked for the fusion output serves
    the image stream, as the JAX ``__call__`` does."""
    tm = TFED(_model_cfg(TC, split_cls=True, events_classes=2)).eval()
    g = np.random.default_rng(4)
    image, isr = (_t(g.normal(size=(1, 32, 32, 3)).astype(np.float32))
                  for _ in range(2))
    with torch.no_grad():
        got = tm(image, isr, output="fusion")
        want = tm.forward_logits(image, isr)["image_output"]
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# _prepare of split + deflare_aug and of d2n against the jitted JAX one
# ---------------------------------------------------------------------------

def _configs(train_type, **uda):
    """(JAX config, port config): the micro config at 64x64 with the
    DarkZurich preset's UDA settings cut as test_torch_train_variants.py
    cuts them (pseudo threshold 0, rows 2 / 15 zeroed), the grid's model
    settings of ``train_type`` (no fusion module; split classifiers for
    split and no-fusion, two events classes and edge labels for
    no-fusion), rates 0, warmup 2 of 10 iterations; the port with remat
    on."""
    model = {SPLIT: dict(split_cls=True),
             NO_FUSION: dict(split_cls=True, events_classes=2),
             D2N: {}}[train_type]
    uda = {"isr_edge": train_type == NO_FUSION, **uda}

    def cut(C):
        cfg = C.micro_test_config()
        dz = C.cs2dz_image_rawisr_b5()
        m = C.replace(_model_cfg(C, **model), train_type=train_type,
                      remat=C is TC)
        return C.replace(
            cfg, model=m,
            uda=C.replace(dz.uda, pseudo_threshold=0.0,
                          pseudo_weight_ignore_top=2,
                          pseudo_weight_ignore_bottom=15, **uda),
            data=C.replace(cfg.data, crop_size=HW),
            optim=C.replace(cfg.optim, warmup_iters=2, max_iters=10))
    return cut(JC), cut(TC)


def _port(tcfg, jstate, imnet=None):
    """The port's trainer on the CPU and its state loaded from the JAX
    state (its ``imnet_params`` into a frozen encoder built from ``imnet``,
    a MiT state_dict)."""
    ttr = DACSTrainer(tcfg, device="cpu")
    tstate = ttr.init_state(imnet_state_dict=imnet)
    for m in (tstate.model, tstate.ema_model):
        for mod in m.modules():
            if isinstance(mod, DropPath):
                mod.rate = 0.0
    js = _jax_state_numpy(jstate)
    if jstate.imnet_params is not None:
        js["imnet_params"] = jax.tree.map(np.asarray, jstate.imnet_params)
    return ttr, load_jax_train_state(tstate, js)


def _target_pairs(g, batch):
    """The deflared night pair and the day pair beside a synthetic target
    batch: darker copies of the night frames and random day frames, a day
    ISR in [-1, 1]."""
    tgt = batch["target"]
    shape = tgt["image"].shape
    tgt["image_deflare"] = (0.7 * tgt["image"] - 0.2).astype(np.float32)
    tgt["isr_deflare"] = (0.5 * tgt["isr"]).astype(np.float32)
    tgt["day_image"] = g.normal(size=shape).astype(np.float32)
    tgt["day_isr"] = g.uniform(-1, 1, size=shape).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def prepared():
    """{type: (JAX P, port P, the JAX teacher's logits)} of ``_prepare`` on
    one seeded state, batch and draws; the JAX ``_prepare`` jitted alone,
    one trace a type. The teacher's outputs come out of the jitted function
    beside P."""
    out = {}
    keys = ("masks", "pseudo_label", "pseudo_weight", "mixed_lbl",
            "mixed_weight", "mixed_isr", "mixed_lbl2", "mixed_weight2",
            "target_day_pl")
    base = jax.random.PRNGKey(4)
    for train_type, uda in ((SPLIT, dict(deflare_aug=True)), (D2N, {})):
        jcfg, tcfg = _configs(train_type, **uda)
        jtr = JTrainer(jcfg)
        jstate = _jax_init_state(jtr, jcfg)
        ttr, tstate = _port(tcfg, jstate)
        batch = _target_pairs(np.random.default_rng(9), uda_batch(
            SyntheticSource(crop_size=HW, with_time_res=False),
            SyntheticTarget(crop_size=HW, with_events=False), [4, 5]))
        teacher = []
        real = jtr._teacher_logits

        def recorded(*a, **k):
            o = real(*a, **k)
            teacher.append(o)
            return o
        jtr._teacher_logits = recorded

        def jprep(state, b, rng):
            teacher.clear()
            _, P = jtr._prepare(state, b, rng)
            return ({k: P[k] for k in keys if P.get(k) is not None},
                    [{k: v for k, v in o.items() if v is not None}
                     for o in teacher])
        jP, jteacher = jax.jit(jprep)(
            jstate, jax.tree.map(jnp.asarray, batch), base)
        draws = _draws(base, 0, 2, jcfg, None)
        k_mix = jax.random.split(jax.random.fold_in(base, 0), 10)[1]
        draws.mix_scores2 = _t(jax.random.uniform(
            jax.random.fold_in(k_mix, 1), (2, 20)))
        tbatch = ttr._device_batch(batch)
        tP = ttr._prepare(tstate, tbatch, draws, tstate.ema_model,
                          tstate.teacher)
        out[train_type] = (
            {k: np.asarray(v) for k, v in jP.items()},
            {k: tP[k].numpy() for k in keys if tP.get(k) is not None},
            [{k: np.asarray(v) for k, v in o.items()} for o in jteacher],
            batch)
    return out


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def test_prepare_split_deflare_matches_jax(prepared):
    """Split with ``deflare_aug``: the teacher on the deflared pair decodes
    the image and events streams, one pseudo-label from each; masks,
    labels and weights equal but at near ties of the JAX logits."""
    ref, got, teacher, batch = prepared[SPLIT]
    assert set(got) == set(ref) == {
        "masks", "pseudo_label", "pseudo_weight", "mixed_lbl",
        "mixed_weight", "mixed_isr", "mixed_lbl2", "mixed_weight2"}
    [t] = teacher
    assert set(t) == {"image_output", "events_output"}
    np.testing.assert_array_equal(got["masks"], ref["masks"])
    for k in ("pseudo_weight", "mixed_weight", "mixed_weight2"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k, stream in (("pseudo_label", "image_output"),
                      ("mixed_lbl", "image_output"),
                      ("mixed_lbl2", "events_output")):
        logits = t[stream]
        assert_labels_match(got[k], ref[k], logits,
                            1e-4 * np.abs(logits).max())
    # the events pseudo-label is its own
    assert not np.array_equal(ref["mixed_lbl"], ref["mixed_lbl2"])
    np.testing.assert_allclose(got["mixed_isr"], ref["mixed_isr"], atol=1e-5)


def test_prepare_split_reads_the_deflared_pair(prepared):
    """From one state and draws: with ``deflare_aug`` the pseudo-labels are
    those of the teacher on the deflared pair (equal to the plain step's
    when the deflared pair is the night pair, other ones on the written
    deflared pair); without its keys the step names them."""
    batch = prepared[SPLIT][3]
    plain_tr = DACSTrainer(_configs(SPLIT)[1], device="cpu")
    tr = DACSTrainer(_configs(SPLIT, deflare_aug=True)[1], device="cpu")
    b = tr._device_batch(batch)
    tgt = b["target"]

    def labels(trainer, target):
        st = trainer.init_state(seed=0)
        draws = trainer.new_draws(st, 2, HW)
        return trainer._prepare(st, dict(b, target=target), draws,
                                st.ema_model)["pseudo_label"]
    plain = labels(plain_tr, tgt)
    same = labels(tr, {**tgt, "image_deflare": tgt["image"],
                       "isr_deflare": tgt["isr"]})
    assert torch.equal(plain, same)
    assert not torch.equal(plain, labels(tr, tgt))
    with pytest.raises(KeyError, match="isr_deflare"):
        labels(tr, {k: v for k, v in tgt.items() if k != "isr_deflare"})


def test_prepare_d2n_matches_jax(prepared):
    """d2n: the day pseudo-label (argmax of the teacher's resized image
    logits on the day image), the night label of the two softmaxes'
    mean with its ratio weight, and the second mask set's mixed label
    and ISR; equal but at near ties."""
    ref, got, teacher, _ = prepared[D2N]
    assert set(got) == set(ref) == {
        "masks", "pseudo_label", "pseudo_weight", "mixed_lbl",
        "mixed_weight", "mixed_isr", "mixed_lbl2", "target_day_pl"}
    day, night = teacher
    assert set(day) == {"image_output"}
    assert set(night) == {"image_output", "events_output"}
    np.testing.assert_array_equal(got["masks"], ref["masks"])
    np.testing.assert_array_equal(got["pseudo_weight"], ref["pseudo_weight"])
    np.testing.assert_array_equal(got["mixed_weight"], ref["mixed_weight"])
    avg = 0.5 * _softmax(night["image_output"]) + 0.5 * _softmax(
        night["events_output"])
    day_logits = day["image_output"]
    assert_labels_match(got["target_day_pl"], ref["target_day_pl"],
                        day_logits, 1e-4 * np.abs(day_logits).max())
    for k in ("pseudo_label", "mixed_lbl"):
        assert_labels_match(got[k], ref[k], avg, 1e-4 * avg.max())
    assert_labels_match(got["mixed_lbl2"], ref["mixed_lbl2"],
                        np.maximum(avg, _softmax(day_logits)), 1e-4)
    # the second mask set mixes the day and night ISRs: where the labels
    # agree, so do the masks, and the mixed ISR is one of the two
    np.testing.assert_array_equal(got["mixed_isr"], ref["mixed_isr"])
    assert not np.array_equal(ref["mixed_lbl"], ref["mixed_lbl2"])


def test_d2n_and_deflare_name_the_missing_keys():
    """A batch without the day pair (or the deflared pair) raises KeyError
    naming the keys, where the JAX step raises a bare KeyError."""
    tcfg = _configs(D2N)[1]
    ttr = DACSTrainer(tcfg, device="cpu")
    st = ttr.init_state(seed=0)
    batch = uda_batch(SyntheticSource(crop_size=HW, with_time_res=False),
                      SyntheticTarget(crop_size=HW, with_events=False),
                      [0, 1])
    with pytest.raises(KeyError, match="day_image.*day_isr.*with_day_pair"):
        ttr.train_step(st, batch)
    ttr = DACSTrainer(_configs(NO_FUSION, deflare_aug=True)[1], device="cpu")
    with pytest.raises(KeyError, match="image_deflare"):
        ttr.train_step(ttr.init_state(seed=0), batch)


def test_fdist_without_imnet_weights_raises():
    tcfg = _configs(NO_FUSION, imnet_feature_dist_lambda=0.5)[1]
    ttr = DACSTrainer(tcfg, device="cpu")
    st = ttr.init_state(seed=0)
    assert st.imnet is None
    batch = uda_batch(SyntheticSource(crop_size=HW, with_time_res=False),
                      SyntheticTarget(crop_size=HW, with_events=False),
                      [0, 1])
    with pytest.raises(ValueError, match="ImageNet encoder's weights"):
        ttr.train_step(st, batch)
    with pytest.raises(ValueError, match="isr_edge needs"):
        DACSTrainer(_configs(SPLIT, isr_edge=True)[1], device="cpu")


def test_d2n_draws_and_debug_tensors():
    """``new_draws`` gives d2n the second ranking last (the other draws as
    for the split type), and ``debug_tensors`` on the step's draws leaves
    the state as it was and matches the step's pseudo weight."""
    import copy
    tr = DACSTrainer(_configs(D2N)[1], device="cpu")
    st = tr.init_state(seed=0)
    d = tr.new_draws(st, 2, HW)
    other = DACSTrainer(_configs(SPLIT)[1], device="cpu").new_draws(
        st, 2, HW)
    assert other.mix_scores2 is None and d.mix_scores2.shape == (2, 20)
    assert torch.equal(d.mix_scores, other.mix_scores)
    batch = _target_pairs(np.random.default_rng(1), uda_batch(
        SyntheticSource(crop_size=HW, with_time_res=False),
        SyntheticTarget(crop_size=HW, with_events=False), [2, 3]))
    before = copy.deepcopy(st.ema_model.state_dict())
    dbg = tr.debug_tensors(st, batch, d)
    for k, v in st.ema_model.state_dict().items():
        assert torch.equal(v, before[k]), k
    _, logs = tr.train_step(st, batch, d)
    assert float(dbg["pseudo_weight"].mean()) == pytest.approx(
        float(logs["pseudo_weight"]), rel=1e-6)
    assert set(logs) == {
        "src/loss_image", "src/loss_events", "src/loss_seg", "src/acc_seg",
        "mix/loss_image", "mix/loss_events", "mix/loss_seg", "mix/acc_seg",
        "loss", "pseudo_weight", "use_events"}


# ---------------------------------------------------------------------------
# DarkZurich: the day pair and the deflared outputs
# ---------------------------------------------------------------------------

def write_dz_pairs(root, n_day=2):
    """Beside a DarkZurich tree: the train frames' flare-removed copies
    under ``night_deflare`` and ``n_day`` day frames with their 1920x540
    side-by-side transferred-ISR PNGs under ``day_t_isr``."""
    g = np.random.default_rng(12)
    night = os.path.join(root, "rgb_anon", "train", "night")
    for seq in sorted(os.listdir(night)):
        out = os.path.join(root, "rgb_anon", "train", "night_deflare", seq)
        os.makedirs(out)
        for name in sorted(os.listdir(os.path.join(night, seq))):
            im = np.asarray(Image.open(os.path.join(night, seq, name)))
            Image.fromarray((im // 2 + 10).astype(np.uint8)).save(
                os.path.join(out, name))
    w, h = Image.open(os.path.join(night, seq, name)).size
    for sub, size, ch in (("day", (w, h), 3), ("day_t_isr", (1920, 540), 1)):
        out = os.path.join(root, "rgb_anon", "train", sub, "seq02")
        os.makedirs(out)
        for i in range(n_day):
            px = g.integers(0, 256, (size[1], size[0], ch), np.uint8)
            Image.fromarray(px[..., 0] if ch == 1 else px).save(
                os.path.join(out, f"seq02_frame_{i:06d}_rgb_anon.png"))


@pytest.fixture(scope="module")
def dz_pairs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zurich"))
    fabricate_dark_zurich(root, n_images=3, size=(120, 72))
    write_dz_pairs(root)
    return root


@pytest.mark.parametrize("kw", [
    dict(with_day_pair=True),
    dict(outputs=("image", "isr", "image_deflare", "isr_deflare")),
    dict(with_day_pair=True, shift_type="random",
         outputs=("image", "isr", "image_deflare", "isr_deflare")),
    dict(split="val", with_day_pair=True,
         outputs=("image", "isr", "label"))],
    ids=["day_pair", "deflare", "both_random", "val"])
def test_dark_zurich_pairs_bitwise(dz_pairs, kw, monkeypatch):
    """Train crops with the day pair and the deflared outputs, one
    ``random.Random`` per package, every key bitwise against the JAX
    dataset on its numpy host ISR; val gives no day pair."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    p = TC.cs2dz_image_rawisr_b5().data.target_isr
    jp = JC.cs2dz_image_rawisr_b5().data.target_isr
    geo = dict(image_resize_size=(96, 64), image_crop_size=(64, 48))
    ours, ref = TDZ(dz_pairs, isr_params=p, **geo, **kw), JDZ(
        dz_pairs, isr_params=jp, **geo, **kw)
    assert ours.files == ref.files
    r_ours, r_ref = random.Random(3), random.Random(3)
    for i in range(len(ref)):
        a, b = ours.load(i, r_ours), ref.load(i, r_ref)
        assert set(a) == set(b)
        for k in b:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)
    if kw.get("with_day_pair") and kw.get("split", "train") == "train":
        assert {"day_image", "day_isr"} <= set(a)
    if "image_deflare" in kw.get("outputs", ()):
        assert not np.array_equal(a["image"], a["image_deflare"])


def test_dark_zurich_deflare_refuses_3ch(dz_pairs):
    with pytest.raises(ValueError, match="isr_deflare"):
        TDZ(dz_pairs, isr_params=TC.DZ_ISR_PRESETS_3["night"],
            shift_3_channel=True, outputs=("image", "isr_deflare"))


# ---------------------------------------------------------------------------
# the CLI, checkpoints
# ---------------------------------------------------------------------------

def test_cli_no_fusion_two_iterations(tmp_path, capsys):
    """``tools.train.main --set model.train_type=..._no-fusion --isr_edge 1
    --feature_dist 0.5 --imnet <mit .pth>`` on the tiny config, 2
    iterations on the CPU with an evaluation (the fusion-less model's
    image stream) and a debug snapshot: the new loss keys logged, the
    frozen encoder loaded from the file and checkpointed."""
    import json
    from cmda_tpu_torch.models.mit import MIT_VARIANTS, MixVisionTransformer
    from cmda_tpu_torch.train.loop import load_checkpoint
    cfg = TC.tiny_test_config()
    mit = MixVisionTransformer(MIT_VARIANTS[cfg.model.backbone])
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in mit.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    torch.save(mit.state_dict(), tmp_path / "mit.pth")
    loop = tcli.main([
        "--config", "tiny", "--synthetic", "--device", "cpu",
        "--num-workers", "2", "--max-iters", "2",
        "--set", f"model.train_type={NO_FUSION}", "--set", "model.fusion=",
        "--set", "model.fusion_isr=", "--set", "model.split_cls=true",
        "--set", "model.events_classes=2", "--isr_edge", "1",
        "--feature_dist", "0.5", "--imnet", str(tmp_path / "mit.pth"),
        "--set", "log_interval=1", "--set", "eval_interval=2",
        "--set", "debug_img_interval=2", "--work-dir", str(tmp_path / "w")])
    done = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert done["done"] and done["step"] == 2
    u = loop.cfg.uda
    assert u.isr_edge and u.lambda_isr_features == 1.0
    assert u.imnet_feature_dist_lambda == 0.5
    for k, t in mit.state_dict().items():
        assert torch.equal(loop.state.imnet.backbone.state_dict()[k], t), k
    with open(loop.log_path) as f:
        recs = [json.loads(r) for r in f]
    steps = [r for r in recs if "loss" in r]
    assert len(steps) == 2 and all(np.isfinite(r["loss"]) for r in steps)
    assert {"mix/loss_feat_consis", "src/loss_imnet_feat_dist"} <= set(
        steps[0])
    assert any("eval" in r for r in recs)
    assert os.listdir(tmp_path / "w" / "class_mix_debug")
    # the checkpoint holds the frozen encoder and reloads it
    tr = DACSTrainer(loop.cfg, device="cpu")
    st = tr.init_state(seed=5, imnet_state_dict={
        k: torch.zeros_like(t) for k, t in mit.state_dict().items()})
    load_checkpoint(st, str(tmp_path / "w" / "iter_2.pth"))
    for k, t in loop.state.imnet.state_dict().items():
        assert torch.equal(st.imnet.state_dict()[k], t), k


def test_port_checkpoint_round_trip_split_classifiers(tmp_path):
    """A port checkpoint of the split type (three classifiers) reloads
    bitwise into a fresh trainer."""
    from cmda_tpu_torch.train.loop import load_checkpoint, save_checkpoint
    tcfg = _configs(SPLIT)[1]
    tr = DACSTrainer(tcfg, device="cpu")
    st = tr.init_state(seed=1)
    save_checkpoint(st, str(tmp_path / "c.pth"))
    st2 = load_checkpoint(tr.init_state(seed=2), str(tmp_path / "c.pth"))
    sd = st.model.state_dict()
    assert "decode_head.conv_seg_events.weight" in sd
    for k, v in st2.model.state_dict().items():
        assert torch.equal(v, sd[k]), k


# ---------------------------------------------------------------------------
# the one JAX DACS step compile: no-fusion, edge labels, the C = 2 CE,
# the feature distance
# ---------------------------------------------------------------------------

THINGS = (6, 7, 11, 12, 13, 14, 15, 16, 17, 18)


@pytest.fixture(scope="module")
def nofusion_step():
    """One no-fusion step of both packages from one seeded state, with
    ``isr_edge`` (lambda_isr_features 1), no edge class weight (the
    2-class stream through the fused CE) and the feature distance at
    lambda 0.5 over a seeded frozen encoder; the source labels 32x32
    squares, half of them thing classes, so the distance has cells. One
    jitted JAX compile."""
    jcfg, tcfg = _configs(NO_FUSION, imnet_feature_dist_lambda=0.5)
    b = jcfg.data.batch_size
    mp = pytest.MonkeyPatch()
    jpl_rec, tpl_rec = _record_pseudo_labels(mp)
    try:
        jtr = JTrainer(jcfg)
        img = jnp.zeros((b, *HW, 3))
        iv = random_variables(lambda: jtr.imnet.init(jax.random.PRNGKey(1),
                                                     img), seed=31)
        jstate = _jax_init_state(jtr, jcfg).replace(
            imnet_params=iv["params"])
        # the frozen encoder built on zeros, then filled from the JAX
        # state's imnet_params by load_jax_train_state
        zeros = {k: torch.zeros(v.shape) for k, v in tree_to_state_dict(
            iv["params"]["backbone"]).items()}
        ttr, tstate = _port(tcfg, jstate, zeros)
        for k, v in tree_to_state_dict(iv["params"]["backbone"]).items():
            assert np.array_equal(
                tstate.imnet.backbone.state_dict()[k].numpy(), v), k
        g = np.random.default_rng(17)
        batch = uda_batch(SyntheticSource(crop_size=HW, with_time_res=False),
                          SyntheticTarget(crop_size=HW, with_events=False),
                          [6, 7])
        batch["source"]["label"] = _block_labels(
            g, b, HW, 32, THINGS + (0, 2, 8, 10, 255))
        base = jax.random.PRNGKey(23)

        def jstep_recorded(state, batch, rng):
            jpl_rec.clear()
            return jtr.train_step(state, batch, rng), list(jpl_rec)
        (jstate1, jlogs), [(jlogits, jlabel)] = jax.jit(jstep_recorded)(
            jstate, jax.tree.map(jnp.asarray, batch), base)
        tpl_rec.clear()
        calls = []
        real = ttransforms.fused_resize_ce
        mp.setattr(ttransforms, "fused_resize_ce",
                   lambda x, *a, **k: calls.append(x.shape[-1])
                   or real(x, *a, **k))
        tstate, tlogs = ttr.train_step(tstate, batch, _draws(
            base, 0, b, jcfg, tstate.model.new_draws(
                b, generator=torch.Generator().manual_seed(0),
                device=torch.device("cpu"), with_isr=False)))
        layout = {"params": jstate.params, "batch_stats": jstate.batch_stats}
        return ({k: float(v) for k, v in jlogs.items()},
                {k: float(v) for k, v in tlogs.items()},
                _jax_state_numpy(jstate1),
                train_state_to_numpy(tstate, layout),
                (np.asarray(jlogits), np.asarray(jlabel),
                 tpl_rec[0].numpy()), calls, jcfg)
    finally:
        mp.undo()


def test_nofusion_step_logs_match_jax(nofusion_step):
    jlogs, tlogs, *_ = nofusion_step
    assert {"mix/loss_feat_consis", "src/loss_imnet_feat_dist"} <= set(jlogs)
    assert jlogs["src/loss_imnet_feat_dist"] > 0
    assert jlogs["mix/loss_feat_consis"] > 0
    _assert_logs_close(jlogs, tlogs)


def test_nofusion_step_state_matches_jax(nofusion_step):
    _, _, ref, state, (jlogits, jlabel, tlabel), _, cfg = nofusion_step
    _assert_state_close(state, ref, cfg, 1)
    assert_labels_match(tlabel, jlabel, jlogits, 1e-4 * np.abs(jlogits).max())
    # the 2-class events classifier took a gradient
    mu = ref["opt"]["head"]["mu"]["decode_head"]["cls_events"]["conv_seg"]
    assert np.abs(mu["kernel"]).max() > 0 and mu["kernel"].shape[-1] == 2


def test_nofusion_step_runs_the_edge_stream_through_the_ce(nofusion_step):
    """Without a class weight the 2-class edge stream goes through the
    fused CE wrapper in both passes, beside the 19-class image stream."""
    calls = nofusion_step[5]
    assert sorted(calls) == [2, 2, 19, 19]
