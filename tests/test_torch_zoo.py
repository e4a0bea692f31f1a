"""The port's model zoo against the JAX package on the CPU, from the same
seeded numpy weights (``random_variables``) and inputs:

* the fusion modules AverageFusion, ConcatenateFusion, ConvertAvgFusion and
  FeaturesSplit at (64, 128, 320, 512) pyramids, in train and eval BN, and
  the port's ValueError for the fixed-width ones at MiT-b0 widths;
* every DAFormer fuse type ('isa' where its padding is uneven) and the
  fusion head's share 'half' and 'none' over four streams;
* each legacy head in train and eval (PSP and UPer at 20x20, which leaves
  a remainder at every pool scale; ISA where padding is needed; DA with
  non-zero gammas; DeepLabV3+ with c1), the SegFormerAdapter neck;
* BatchNorm over one value per channel at batch 1: the ASPP image pool and
  ResNeSt's split attention;
* ResNetV1c for each block type at depths (1, 1, 1, 1), and an mmcv-layout
  seeded ResNet state_dict through JAX's ``convert_resnet_backbone`` and
  the port's ``load_pretrained_backbone``;
* EventsEncoderDecoder and GenericEncoderDecoder forward and training
  forward with the JAX forwards' recorded draws;
* the Charbonnier, BCE and OHEM losses and the on-device histograms;
* two supervised smoke steps of ``dlv2red`` and ``sfa_dlv3p_nodbn``;
* the FusionEncoderDecoder training forward and its gradients with
  ``fusion='convert_avg'`` and ``'average'`` and with
  ``share_decoder='none'``, at MiT-b1 widths with depth 1 (a test-only
  MIT_VARIANTS entry in both packages), 64x64;
* every (arch, backbone) of both architecture grids builds in the port and
  gives input-size logits at 32x32;
* last, one jitted JAX compile: three OrgDACS steps on a ``dlv2red``
  ResNet (1, 1, 1, 1) model with the feature distance against the port's.

Tolerances: module outputs atol/rtol 1e-5 (the ResNets' and the segmentors'
logits, deeper chains, 1e-4), losses rtol 1e-4, the histograms and the
OHEM weights bitwise, parameters and BN statistics after steps by
test_torch_train.py's rule; the OrgDACS steps' AdamW moments to 1e-1 of
each leaf's largest and 1e-2 of the group's largest, as far apart as JAX's
float32 gradients through train-mode BatchNorm put them (see
ORG_MOMENT_LEAF_RTOL).
"""
import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from cmda_tpu import config as JC
from cmda_tpu.models import daformer as jdaf
from cmda_tpu.models import fusion as jfus
from cmda_tpu.models import heads as jheads
from cmda_tpu.models import mit as jmit
from cmda_tpu.models import resnet as jres
from cmda_tpu.models import segmentor as jseg
from cmda_tpu.ops import losses as jlosses
from cmda_tpu.ops import metrics as jmetrics
from cmda_tpu.utils.torch_import import convert_resnet_backbone
from cmda_tpu_torch import config as TC
from cmda_tpu_torch.models import daformer as tdaf
from cmda_tpu_torch.models import fusion as tfus
from cmda_tpu_torch.models import heads as theads
from cmda_tpu_torch.models import mit as tmit
from cmda_tpu_torch.models import resnet as tres
from cmda_tpu_torch.models import segmentor as tseg
from cmda_tpu_torch.ops import losses as tlosses
from cmda_tpu_torch.ops import metrics as tmetrics
from cmda_tpu_torch.tools import run_experiments as trun
from cmda_tpu_torch.utils.weights import (load_jax_variables,
                                          load_pretrained_backbone,
                                          state_dict_to_tree)
from test_torch_train import _assert_tree_close, _record_draws
from torch_port_util import random_variables
from tools import run_experiments as jrun

MOD_TOL = dict(atol=1e-5, rtol=1e-5)
DEEP_TOL = dict(atol=1e-4, rtol=1e-4)
WIDTHS = (64, 128, 320, 512)


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2).contiguous()


def _np_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _pyramid(seed, b=2, widths=WIDTHS, sizes=(8, 4, 2, 1)):
    g = np.random.default_rng(seed)
    sizes = [s if isinstance(s, tuple) else (s, s) for s in sizes]
    return [g.normal(size=(b, *hw, c)).astype(np.float32)
            for c, hw in zip(widths, sizes)]


def _vars(jm, *args, seed=0, **kw):
    return random_variables(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                            **kw), seed=seed)


def _japply(jm, v, *args, train, **kw):
    """The JAX module's output and, in train, its updated batch_stats;
    jitted (one compile costs a third of the first eager call's per-op
    ones)."""
    if not train:
        return jax.jit(functools.partial(jm.apply, train=False, **kw))(
            v, *args), None
    out, upd = jax.jit(functools.partial(
        jm.apply, train=True, mutable=["batch_stats"], **kw))(v, *args)
    return out, upd.get("batch_stats")


def _stats_tree(module, layout, root=None):
    """The port module's BN running statistics in the JAX layout."""
    sd = module.state_dict()
    if root is None:
        return state_dict_to_tree(sd, layout)
    return state_dict_to_tree({f"decode_head.{k}": v for k, v in sd.items()},
                              {root: layout})[root]


def _scaled(tol, ref):
    """``tol`` with its atol taken of the largest |ref|: for outputs
    through batch-statistics BatchNorm, where the two packages' float32
    reductions, amplified by the one-pass variance, move small outputs by
    ~1e-5 of the largest (as tests/test_torch_uda_options.py holds the
    batched-train head)."""
    return dict(tol, atol=tol["atol"] * max(float(np.abs(ref).max()), 1.0))


def _close(got, ref, tol=MOD_TOL, train=False, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, err_msg=what,
                               **(_scaled(tol, ref) if train else tol))


def _close_maps(got, ref, tol=MOD_TOL, what="", train=False):
    for i, (g, r) in enumerate(zip(got, ref, strict=True)):
        _close(_np_nhwc(g), r, tol, train, f"{what} {i}")


# ---------------------------------------------------------------------------
# fusion modules
# ---------------------------------------------------------------------------

FUSIONS = {"average": (jfus.AverageFusion, tfus.AverageFusion),
           "concatenate": (jfus.ConcatenateFusion, tfus.ConcatenateFusion),
           "convert_avg": (jfus.ConvertAvgFusion, tfus.ConvertAvgFusion)}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", sorted(FUSIONS) + ["features_split"])
def test_fusion_module_matches_jax(kind, train):
    """At least 32 values per channel at each scale, so train-mode BN is
    not over two samples (where its one-pass variance turns float32
    rounding into O(1e-3))."""
    a, b = _pyramid(1, sizes=(16, 8, 4, 4)), _pyramid(2, sizes=(16, 8, 4, 4))
    if kind == "features_split":
        jm, tm = jfus.FeaturesSplit(), tfus.FeaturesSplit(WIDTHS)
        args, targs = (a,), ([_nchw(x) for x in a],)
    else:
        jm, tm = FUSIONS[kind][0](), FUSIONS[kind][1](WIDTHS)
        args = (a, b)
        targs = ([_nchw(x) for x in a], [_nchw(x) for x in b], None)
    v = _vars(jm, *args, seed=3, train=False)
    load_jax_variables(tm, v)
    ref, upd = _japply(jm, v, *args, train=train)
    with torch.no_grad():
        got = (tm(*targs, bn_train=train) if kind == "features_split"
               else tm(*targs, bn_train=train))
    _close_maps(got, ref, what=kind, train=train)
    assert tfus.num_drop_path_blocks(tm) == 0
    if upd:
        _assert_tree_close(_stats_tree(tm, upd), upd, "batch_stats",
                           **MOD_TOL)


@pytest.mark.parametrize("kind", ["concatenate", "convert_avg"])
def test_fixed_width_fusions_refuse_other_widths(kind):
    with pytest.raises(ValueError, match="64, 128, 320, 512"):
        tfus.build_fusion_module(kind, (32, 64, 160, 256))
    assert tfus.build_fusion_module(kind, WIDTHS) is not None


# ---------------------------------------------------------------------------
# DAFormer fuse types and decoder sharing
# ---------------------------------------------------------------------------

def _daf_cfg(C, fusion_type, dropout=0.0):
    return C.DAFormerHeadConfig(in_channels=(8, 16, 24, 32), embed_dim=16,
                                channels=16, num_classes=5,
                                dropout_ratio=dropout,
                                fusion_type=fusion_type)


def _float64_run(module, fn, monkeypatch):
    """``fn(module64, torch.float64)`` on a float64 copy of ``module``,
    its float32 casts (norm statistics, the classifier, resizes) kept in
    float64."""
    m64 = copy.deepcopy(module).double()
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "float", lambda self: self.double())
        with torch.no_grad():
            return fn(m64, torch.float64)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("fusion_type", tdaf.FUSION_TYPES)
def test_daformer_fuse_types_match_jax(fusion_type, train, monkeypatch):
    """The single-stream head of each fuse type; the stride-4 grid 21x18
    pads unevenly under the 'isa' fuse's 8x8 groups (3 rows: 1 before, 2
    after; 6 columns: 3 and 3). The 'isa' fuse in train mode (its
    attention's projections through batch-statistics BatchNorm) is
    ill-conditioned in float32 at these inputs: against a float64 run of
    the port's head the JAX logits are 1.9e-5 of the largest apart, the
    port's 2.6e-6. So there both packages are held to that float64 run:
    the port at 1e-5 of the largest, JAX at 1e-4 (a port of another
    function would be O(1) apart)."""
    feats = _pyramid(4, widths=(8, 16, 24, 32),
                     sizes=((21, 18), (11, 9), (6, 5), (3, 3)))
    jm = jdaf.DAFormerHead(_daf_cfg(jdaf, fusion_type))
    tm = tdaf.DAFormerHead(_daf_cfg(tdaf, fusion_type))
    v = _vars(jm, feats, seed=5)
    load_jax_variables(tm, v)
    ref, upd = _japply(jm, v, feats, train=train)
    before = copy.deepcopy(tm)
    with torch.no_grad():
        got = tm([_nchw(f) for f in feats], train)
    if fusion_type == "isa" and train:
        f64 = _np_nhwc(_float64_run(before, lambda m, dt: m(
            [_nchw(f).to(dt) for f in feats], True), monkeypatch))
        _close(_np_nhwc(got), f64, train=True, what="port vs float64")
        _close(np.asarray(ref), f64, DEEP_TOL, train=True,
               what="JAX vs the port's float64")
    else:
        _close(_np_nhwc(got), ref, train=train)
    if upd:
        _assert_tree_close(_stats_tree(tm, upd), upd, "batch_stats",
                           **MOD_TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("share", ["half", "none"])
def test_fusion_head_share_matches_jax(share, train):
    """Four streams through the half-shared (one decoder, stream by stream)
    and the unshared head (three decoders, the ISR through the events
    one), in train and eval BN. The stride-4 grid is 16x16: at 8x8 the
    ASPP's dilations 12 and 18 reach past the map, and its train-mode
    BatchNorm amplifies float32 rounding there (both packages up to 3e-5
    of the largest logit from a float64 run of the port's head; at 16x16
    within 3e-6)."""
    names = ("f_image", "f_events", "f_fusion", "f_img_self_res")
    feats = {k: _pyramid(10 + i, widths=(8, 16, 24, 32),
                         sizes=(16, 8, 4, 2)) for i, k in enumerate(names)}
    jm = jdaf.DAFormerFusionHead(_daf_cfg(jdaf, "aspp"), share=share)
    tm = tdaf.DAFormerFusionHead(_daf_cfg(tdaf, "aspp"), share=share)
    v = _vars(jm, feats, seed=6)
    load_jax_variables(tm, v)
    if share == "none":
        assert {"embed_layers_events.0.proj.weight",
                "fuse_layer_fusion.bottleneck.conv.weight"} <= set(
                    tm.state_dict())
    ref, upd = _japply(jm, v, feats, train=train)
    with torch.no_grad():
        got = tm({k: [_nchw(f) for f in fs] for k, fs in feats.items()},
                 train=train)
    for k, r in ref.items():
        _close(_np_nhwc(got[k]), r, train=train, what=k)
    if upd:
        _assert_tree_close(_stats_tree(tm, upd), upd, "batch_stats",
                           **MOD_TOL)


# ---------------------------------------------------------------------------
# the legacy heads
# ---------------------------------------------------------------------------

def _head_cfg(C):
    return C.HeadConfig(in_channels=(8, 16, 24, 32), channels=16,
                        num_classes=5, dropout_ratio=0.0)


HEADS = {
    "segformer": (lambda M, c: M.SegFormerHead(c)),
    "fcn": (lambda M, c: M.FCNHead(c)),
    "aspp": (lambda M, c: M.ASPPHead(c, dilations=(1, 2, 3))),
    "dlv3p": (lambda M, c: M.ASPPHead(c, dilations=(1, 2, 3), sep=True,
                                      c1_channels=6)),
    "psp": (lambda M, c: M.PSPHead(c)),
    "uper": (lambda M, c: M.UPerHead(c)),
    "isa": (lambda M, c: M.ISAHead(c, isa_channels=8)),
    "da": (lambda M, c: M.DAHead(c, pam_channels=8)),
    "dlv2": (lambda M, c: M.DLV2Head(c, dilations=(1, 2, 3, 4))),
}
# 20x20 maps: every PSP / UPer pool scale (2, 3, 6) leaves a remainder, and
# ISA's 8x8 groups pad 4 rows and columns (2 before, 2 after)
HEAD_SIZES = (40, 20, 20, 20)


def _load_head(tm, v):
    """The JAX variables of a head module alone into the port's ``tm``,
    through a parent that holds it as a GenericEncoderDecoder does: the
    bridge's names of the heads' layers depend on the parent's ``head``."""
    parent = torch.nn.Module()
    parent.decode_head = tm
    load_jax_variables(parent, {c: {"head": t} for c, t in v.items()})


def _head_pair(name, batch=2, seed=7):
    feats = _pyramid(seed, b=batch, widths=(8, 16, 24, 32), sizes=HEAD_SIZES)
    jm = HEADS[name](jheads, _head_cfg(jheads))
    tm = HEADS[name](theads, _head_cfg(theads))
    v = _vars(jm, feats, seed=seed + 1)
    _load_head(tm, v)
    return feats, jm, tm, v


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_matches_jax(name, train):
    feats, jm, tm, v = _head_pair(name)
    if name == "da":   # the gammas are non-zero, so both branches show
        assert float(v["params"]["pam_gamma"]) != 0
        assert float(v["params"]["cam_gamma"]) != 0
    ref, upd = _japply(jm, v, feats, train=train)
    with torch.no_grad():
        got = tm([_nchw(f) for f in feats], train)
    _close(_np_nhwc(got), ref, train=train)
    if upd:
        _assert_tree_close(_stats_tree(tm, upd, "head"), upd, "batch_stats",
                           **MOD_TOL)


def test_floor_pool_is_not_adaptive():
    """At 20x20 the floor pools of scale 3 and 6 are not the adaptive
    pool's grid, so the PSP / UPer cases above hold the floor form."""
    x = torch.randn(1, 2, 20, 20)
    for s in (3, 6):
        floor = theads._floor_pool(x, s)
        assert floor.shape[-1] == s
        assert not torch.allclose(floor, torch.nn.functional.
                                  adaptive_avg_pool2d(x, s))


def test_segformer_adapter_matches_jax():
    feats = _pyramid(9, widths=(8, 16, 24, 32), sizes=(16, 8, 4, 2))
    ref = jheads.SegFormerAdapter().apply({}, feats)
    got = theads.SegFormerAdapter()([_nchw(f) for f in feats])
    _close_maps(got, ref, what="neck")
    assert got[-1].shape[2:] == (8, 8)


# ---------------------------------------------------------------------------
# BatchNorm over one value per channel (batch 1)
# ---------------------------------------------------------------------------

def test_batch1_aspp_image_pool_matches_jax():
    """At batch 1 the ASPP image pool's BatchNorm sees one value per
    channel: var 0, so the output is its bias, and the running variance
    moves by the biased variance, 0: var' = 0.9 var, as in JAX (torch's
    F.batch_norm raises there). ResNeSt's fc1 at batch 1 is held in
    ``test_resnet_matches_jax[resnest50-train]``."""
    feats, jm, tm, v = _head_pair("aspp", batch=1, seed=11)
    ref, upd = _japply(jm, v, feats, train=True)
    with torch.no_grad():
        got = tm([_nchw(f) for f in feats], True)
    _close(_np_nhwc(got), ref, train=True)
    got_stats = _stats_tree(tm, upd, "head")
    _assert_tree_close(got_stats, upd, "batch_stats", **MOD_TOL)
    np.testing.assert_allclose(
        got_stats["image_pool"]["bn"]["var"],
        0.9 * np.asarray(v["batch_stats"]["image_pool"]["bn"]["var"]),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# ResNets
# ---------------------------------------------------------------------------

RESNETS = ("resnet50_d8", "resnext50", "resnest50")


def _resnet_cfg(M, variant):
    base = M.RESNET_VARIANTS[variant]
    return M.ResNetConfig(**{**base.__dict__, "depths": (1, 1, 1, 1)})


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("variant", RESNETS)
def test_resnet_matches_jax(variant, train):
    """Each block type at depths (1, 1, 1, 1), 64x64 (at least 8 values a
    channel in the last stage's train-mode BatchNorm): the bottleneck at
    the d8 strides and dilations, ResNeXt's grouped one, ResNeSt's split
    attention with its avd and avg_down pools. ResNeSt's fc1 BatchNorm
    normalises the global pool, two values a channel at batch 2, which
    float32 resolves to ~1e-3 of the output in both packages against a
    float64 run of the port; its cases run at batch 1, where in train that
    BatchNorm sees one value a channel: exact (var 0, the running variance
    0.9 of its own)."""
    b = 1 if variant.startswith("resnest") else 2
    x = np.random.default_rng(14).normal(size=(b, 64, 64, 3)).astype(
        np.float32)
    jm = jres.ResNetV1c(_resnet_cfg(jres, variant))
    tm = tres.ResNetV1c(_resnet_cfg(tres, variant))
    v = _vars(jm, x, seed=15)
    load_jax_variables(tm, v)
    ref, upd = _japply(jm, v, x, train=train)
    with torch.no_grad():
        got = tm(_nchw(x), train)
    _close_maps(got, ref, DEEP_TOL, variant, train)
    if upd:
        got_stats = _stats_tree(tm, upd)
        _assert_tree_close(got_stats, upd, "batch_stats", **MOD_TOL)
    if upd and b == 1:
        path = ("layer4_0", "conv2", "fc1", "bn", "var")
        before, after = v["batch_stats"], got_stats
        for k in path:
            before, after = before[k], after[k]
        np.testing.assert_allclose(after, 0.9 * np.asarray(before),
                                   rtol=1e-6)


def test_mmcv_resnet_state_dict_loads_in_both():
    """A seeded state_dict in mmcv's ResNetV1c layout (BN step counters
    and the ImageNet ``fc`` included, as open-mmlab's files hold them)
    through JAX's ``convert_resnet_backbone`` and the port's
    ``load_pretrained_backbone``: the same features in eval."""
    cfg = _resnet_cfg(tres, "resnet101_d8")
    tm = tres.ResNetV1c(cfg)
    g = np.random.default_rng(16)
    sd = {}
    for k, t in tm.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(5)
        elif k.endswith("running_var"):
            sd[k] = _t(g.uniform(0.5, 1.5, t.shape).astype(np.float32))
        elif k.endswith("weight") and t.ndim == 4:
            fan_in = np.prod(t.shape[1:])
            sd[k] = _t((g.normal(size=t.shape) / np.sqrt(fan_in)).astype(
                np.float32))
        else:
            sd[k] = _t((0.1 * g.normal(size=t.shape) + (
                1.0 if k.endswith("weight") else 0.0)).astype(np.float32))
    sd["fc.weight"] = torch.zeros(1000, 2048)
    assert "stem.0.weight" in sd and "layer3.0.downsample.1.running_mean" in sd
    load_pretrained_backbone(tm, sd)
    jv = convert_resnet_backbone({k: v.numpy() for k, v in sd.items()},
                                 depths=(1, 1, 1, 1))
    x = g.normal(size=(1, 32, 32, 3)).astype(np.float32)
    ref, _ = _japply(jres.ResNetV1c(_resnet_cfg(jres, "resnet101_d8")), jv,
                     x, train=False)
    with torch.no_grad():
        got = tm.eval()(_nchw(x))
    _close_maps(got, ref, DEEP_TOL, "mmcv")


# ---------------------------------------------------------------------------
# losses and histograms
# ---------------------------------------------------------------------------

def _logits_labels(seed=17, b=2, h=9, w=7, c=5):
    g = np.random.default_rng(seed)
    x = (2 * g.normal(size=(b, h, w, c))).astype(np.float32)
    y = g.integers(0, c, (b, h, w)).astype(np.int32)
    y[0, :2] = 255
    wgt = g.uniform(0, 1, (b, h, w)).astype(np.float32)
    return x, y, wgt


@pytest.mark.parametrize("case", ["charbonnier", "bce", "bce_weighted",
                                  "ohem", "ohem_min_kept"])
def test_losses_match_jax(case):
    x, y, wgt = _logits_labels()
    if case == "charbonnier":
        t = np.random.default_rng(18).normal(size=x.shape).astype(np.float32)
        ref = jlosses.charbonnier_loss(jnp.asarray(x), jnp.asarray(t))
        got = tlosses.charbonnier_loss(_t(x), _t(t))
    elif case.startswith("bce"):
        w = wgt if case == "bce_weighted" else None
        ref = jlosses.weighted_binary_cross_entropy(
            jnp.asarray(x), jnp.asarray(y), None if w is None
            else jnp.asarray(w))
        got = tlosses.weighted_binary_cross_entropy(
            _t(x), _t(y), None if w is None else _t(w))
    else:
        kw = (dict(thresh=0.3, min_kept=20) if case == "ohem" else
              dict(thresh=None, min_kept=40))
        ref = np.asarray(jlosses.ohem_weights(jnp.asarray(x), jnp.asarray(y),
                                              **kw))
        got = tlosses.ohem_weights(_t(x), _t(y), **kw).numpy()
        assert 0 < ref.sum() < (y != 255).sum()
        np.testing.assert_array_equal(got, ref)
        return
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-4)


def test_intersect_and_union_torch_bitwise():
    g = np.random.default_rng(19)
    pred = g.integers(0, 6, (2, 11, 13)).astype(np.int64)
    label = g.integers(0, 6, (2, 11, 13)).astype(np.int64)
    label[:, :3] = 255
    label[1, 5, 5] = 3
    pred[1, 5, 5] = 3
    host = tmetrics.intersect_and_union(pred, label, 7)
    jref = jmetrics.intersect_and_union_jnp(jnp.asarray(pred),
                                            jnp.asarray(label), 7)
    got = tmetrics.intersect_and_union_torch(_t(pred), _t(label), 7)
    for g_, h, j in zip(got, host, jref, strict=True):
        assert g_.dtype == torch.int64 and g_.shape == (7,)
        np.testing.assert_array_equal(g_.numpy(), h.astype(np.int64))
        np.testing.assert_array_equal(g_.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# the segmentors
# ---------------------------------------------------------------------------

DP_MIT, DROPOUT = 0.6, 0.5


def _forward_draws(drawn, b, mit=True):
    """The ForwardDraws of one recorded single-backbone training forward:
    with a MiT its 4 stages' uniforms [1, 2, B] first, then (if the head
    has one) the Dropout2d uniforms [B, 1, 1, C]."""
    drawn = [np.asarray(u) for u in drawn]
    image = [_t(u) for u in drawn[:4]] if mit else None
    rest = drawn[4:] if mit else drawn
    keep = (_t(rest[0][None, :, 0, 0] < np.float32(1 - DROPOUT))
            if rest else None)
    assert len(rest) <= 1 and (not rest or rest[0].shape[:3] == (b, 1, 1))
    return tseg.ForwardDraws(image=image, dropout_keep=keep)


def _jax_forwards(jm, rec, v, *x, method=None):
    """The JAX module's eval forward and its recorded training forward
    (droppath / dropout keys 3 / 4) in one jit: (eval output, (train
    output, batch_stats, the recorded uniforms))."""
    kw = {} if method is None else {"method": method}

    @jax.jit
    def forwards(v, *x):
        rec.clear()
        out, upd = jm.apply(v, *x, train=True, mutable=["batch_stats"],
                            rngs={"droppath": jax.random.PRNGKey(3),
                                  "dropout": jax.random.PRNGKey(4)}, **kw)
        drawn = list(rec)
        return (jm.apply(v, *x, train=False, **kw),
                (out, upd["batch_stats"], drawn))
    return forwards(v, *x)


def test_events_encoder_decoder_matches_jax(monkeypatch):
    """Early fusion, the micro config at 64x64 with drop-path (ramp to
    0.6) and Dropout2d (0.5): eval logits, and the training forward with
    the JAX forward's recorded draws (logits, running statistics)."""
    def cfg(C):
        m = C.micro_test_config().model
        return C.replace(m, drop_path_rate=DP_MIT, head=C.replace(
            m.head, dropout_ratio=DROPOUT))
    g = np.random.default_rng(20)
    img, ev = (g.normal(size=(2, 64, 64, 3)).astype(np.float32)
               for _ in range(2))
    jm = jseg.EventsEncoderDecoder(cfg(JC))
    tm = tseg.EventsEncoderDecoder(cfg(TC), in_chans=6)
    v = _vars(jm, img, ev, seed=21)
    load_jax_variables(tm, v)
    rec = _record_draws(monkeypatch)
    ref_eval, (ref, upd, drawn) = _jax_forwards(jm, rec, v, img, ev)
    with torch.no_grad():
        _close(tm(_t(img), _t(ev)).numpy(), ref_eval, DEEP_TOL)
    draws = _forward_draws(drawn, 2)
    assert not draws.dropout_keep.all()
    with torch.no_grad():
        got, feats = tm.forward_with_features(_t(img), _t(ev), True, draws)
    assert [f.shape[1] for f in feats] == [16, 32, 64, 128]
    _close(got.numpy(), ref, DEEP_TOL, train=True)
    _assert_tree_close(_stats_tree(tm, upd), upd, "batch_stats", **MOD_TOL)


GENERIC = (("dlv3p_nodbn", "r101v1c"),)


@pytest.mark.parametrize("arch,backbone", GENERIC)
def test_generic_encoder_decoder_matches_jax(arch, backbone, monkeypatch):
    """The launcher's smoke-sized DeepLabV3+ on the d8 ResNet-101 at
    depths 1, 32x32 (a MiT GenericEncoderDecoder's training forward, with
    the neck, is held by the supervised smoke below): eval
    logits, the training forward with the JAX forward's recorded draws
    (MiT drop-path at the variant's 0.1, Dropout2d 0.1): logits, the last
    feature map and the running statistics."""
    jm = jrun._legacy_model_builder(arch, backbone)()
    tm = trun._legacy_model_builder(arch, backbone)()
    x = np.random.default_rng(22).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    v = _vars(jm, x, seed=23)
    load_jax_variables(tm, v)
    rec = _record_draws(monkeypatch)
    (ref, _), ((tref, rfeats), upd, drawn) = _jax_forwards(
        jm, rec, v, x, method=jseg.GenericEncoderDecoder.forward_with_features)
    with torch.no_grad():
        got, _ = tm.forward_with_features(_t(x))
    _close(got.numpy(), ref, DEEP_TOL)
    ref = tref
    mit = "mit" in backbone
    drawn = [np.asarray(u) for u in drawn]
    global DROPOUT
    try:   # the combos' own dropout rate
        DROPOUT = 0.1
        draws = _forward_draws(drawn, 2, mit)
    finally:
        DROPOUT = 0.5
    with torch.no_grad():
        got, feats = tm.forward_with_features(_t(x), True, draws)
    _close(got.numpy(), ref, DEEP_TOL, train=True)
    _close(_np_nhwc(feats[-1]), rfeats[-1], DEEP_TOL, train=True)
    _assert_tree_close(_stats_tree(tm, upd), upd, "batch_stats",
                       atol=1e-5, rtol=1e-5)


def test_resnet_gradients_match_float64(monkeypatch):
    """The gradients of the launcher's ``dlv2red`` ResNet-101 (depths 1)
    training forward, 64x64, batch 2, of sum(logits * a random cotangent):
    the port's float32 ones to 1e-5 of each leaf's largest from a float64
    run of the port (measured 6.4e-6). JAX's float32 gradients of the same
    function are up to 4.4e-2 of a leaf's largest from that float64 run
    (layer4's conv3 kernel, behind two train-mode BatchNorms), so the port
    is held to float64 here, not to them."""
    from test_torch_uda_options import _assert_rel_close
    tm = trun._legacy_model_builder("dlv2red", "r101v1c")()
    gen = torch.Generator().manual_seed(0)
    from cmda_tpu_torch.models.common import init_weights
    init_weights(tm, gen)
    g = np.random.default_rng(27)
    x = g.normal(size=(2, 64, 64, 3)).astype(np.float32)
    cot = g.normal(size=(2, 64, 64, 19)).astype(np.float32)
    before = copy.deepcopy(tm)
    out, _ = tm.forward_with_features(_t(x), True)
    (out * _t(cot)).sum().backward()

    def run64(m, dt):
        m.dtype = dt
        with torch.enable_grad():
            o, _ = m.forward_with_features(_t(x).to(dt), True)
            (o * _t(cot).to(dt)).sum().backward()
        return dict(m.named_parameters())
    p64 = _float64_run(before, run64, monkeypatch)
    for k, p in tm.named_parameters():
        _assert_rel_close(p.grad.numpy(), p64[k].grad.numpy(), 1e-5, k)


# ---------------------------------------------------------------------------
# the supervised smoke step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,backbone", [("dlv2red", "r101v1c"),
                                           ("sfa_dlv3p_nodbn", "mitb5-del")])
def test_supervised_smoke_matches_jax(arch, backbone, monkeypatch):
    """Two steps of the launcher's supervised smoke (batch 1, 48x48, SGD lr
    1e-3, the same draws each step, as the JAX smoke reuses its keys) from
    one state: the losses, then the parameters and the running statistics
    after the two steps to 1e-5."""
    jm = jrun._legacy_model_builder(arch, backbone)()
    tm = trun._legacy_model_builder(arch, backbone)()
    img, lbl = trun.supervised_batch()
    v = _vars(jm, img, seed=24)
    load_jax_variables(tm, v)
    rec = _record_draws(monkeypatch)
    tx = optax.sgd(1e-3)

    @jax.jit
    def step(params, bstats, opt):
        rec.clear()

        def loss_fn(p):
            out, upd = jm.apply({"params": p, "batch_stats": bstats}, img,
                                train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(1),
                                      "droppath": jax.random.PRNGKey(2)})
            return jlosses.weighted_cross_entropy(out, lbl, None), upd[
                "batch_stats"]
        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        upd, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, upd), bs, opt, loss, list(rec)
    params, bstats, opt = v["params"], v["batch_stats"], tx.init(v["params"])
    topt = torch.optim.SGD(tm.parameters(), lr=1e-3)
    draws = None
    for _ in range(2):
        params, bstats, opt, loss, drawn = step(params, bstats, opt)
        if draws is None:
            global DROPOUT
            try:
                DROPOUT = 0.1
                draws = _forward_draws(drawn, 1, "mit" in backbone)
            finally:
                DROPOUT = 0.5
        tloss = trun.supervised_step(tm, topt, _t(img), _t(lbl), draws)
        np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-4)
    got = state_dict_to_tree(dict(tm.named_parameters()), params)
    _assert_tree_close(got, params, "params", atol=1e-5, rtol=1e-5)
    _assert_tree_close(_stats_tree(tm, bstats), bstats, "batch_stats",
                       atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the fusion segmentor's new modules in its training forward
# ---------------------------------------------------------------------------

B1_D1 = "mit_b1_d1"


@pytest.fixture(scope="module")
def fusion_forward_pair():
    """One FusionEncoderDecoder training forward and its gradients in both
    packages, in mode 'fusion_all' on the events+ISR double batch, so one
    JAX compile runs every new piece: ``fusion='convert_avg'`` (the
    events pyramid), ``fusion_isr='average'`` (the ISR one) and
    ``share_decoder='none'`` (three decoders, the ISR stream through the
    events one); MiT-b1 widths at depth 1 (a test-only MIT_VARIANTS entry
    in both packages), 64x64, rates 0. The gradients are of
    sum(logits * a random cotangent), JAX's in the fusion module's and the
    head's parameters only."""
    mp = pytest.MonkeyPatch()
    mp.setitem(jmit.MIT_VARIANTS, B1_D1,
               jmit.MiTConfig(depths=(1, 1, 1, 1)))
    mp.setitem(tmit.MIT_VARIANTS, B1_D1,
               tmit.MiTConfig(depths=(1, 1, 1, 1)))

    def cfg(C):
        m = C.micro_test_config().model
        return C.replace(m, backbone=B1_D1, fusion="convert_avg",
                         fusion_isr="average", share_decoder="none",
                         drop_path_rate=0.0,
                         head=C.DAFormerHeadConfig(
                             in_channels=WIDTHS, embed_dim=32, channels=32,
                             dropout_ratio=0.0))
    try:
        b, hw = 2, 64
        g = np.random.default_rng(25)
        x = [g.normal(size=(b, hw, hw, 3)).astype(np.float32)
             for _ in range(3)]
        jm = jseg.FusionEncoderDecoder(cfg(JC))
        v = _vars(jm, *x, seed=26, mode="fusion_all",
                  method=jm.forward_logits)
        keys = ("image_output", "events_output", "fusion_output",
                "img_self_res_output")
        cot = {k: g.normal(size=(b, hw // 4, hw // 4, 19)).astype(
            np.float32) for k in keys}

        # the gradients of the new parts only: the encoders' backward (held
        # since the DACS step's slice) would double the JAX compile
        new = ("fusion_module", "decode_head")
        rest = {k: t for k, t in v["params"].items() if k not in new}

        def jloss(params, x):
            (out, _), upd = jm.apply(
                {"params": {**rest, **params},
                 "batch_stats": v["batch_stats"]}, *x,
                mode="fusion_all", mutable=["batch_stats"],
                rngs={"droppath": jax.random.PRNGKey(3),
                      "dropout": jax.random.PRNGKey(4)},
                method=jm.forward_train)
            return sum(jnp.sum(out[k] * cot[k]) for k in keys), (out, upd)
        (_, (ref, upd)), grads = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))({k: v["params"][k] for k in new}, x)
        tm = load_jax_variables(tseg.FusionEncoderDecoder(cfg(TC)), v)
        draws = tm.new_draws(b, generator=torch.Generator().manual_seed(0),
                             device=torch.device("cpu"), fusion_isr=True)
        out, _ = tm.forward_train(*(_t(a) for a in x), "fusion_all", draws)
        sum((out[k] * _t(cot[k])).sum() for k in keys).backward()
    finally:
        mp.undo()
    return ref, upd, grads, tm, out, draws


def test_fusion_segmentor_training_forward_matches_jax(fusion_forward_pair):
    ref, upd, _, tm, out, draws = fusion_forward_pair
    # no MiT block in either fusion module: their drop-path rows are empty
    assert draws.fusion.shape[0] == draws.fusion_isr.shape[0] == 0
    assert isinstance(tm.fusion_module, tfus.ConvertAvgFusion)
    assert isinstance(tm.fusion_isr_module, tfus.AverageFusion)
    for k, r in ref.items():
        _close(out[k].detach().numpy(), r, DEEP_TOL, train=True, what=k)
    _assert_tree_close(state_dict_to_tree(tm.state_dict(), upd[
        "batch_stats"]), upd["batch_stats"], "batch_stats", **MOD_TOL)


@pytest.mark.parametrize("part", ["fusion_module", "decode_head"])
def test_fusion_segmentor_gradients_match_jax(fusion_forward_pair, part):
    """The gradients of ConvertAvgFusion's BasicBlocks and of the three
    unshared decoders, each leaf to 5e-5 of its largest. At 64x64 the fusion's last scale is 2x2, and its BasicBlocks'
    train-mode BatchNorm over 8 values a channel and the dilated ASPP
    amplify float32 rounding in the backward pass: against a float64 run
    of the port both packages' gradients are up to 1.3e-5 (JAX) and 1.0e-5
    (the port) of a leaf's largest apart, so 1e-5 cannot hold; a wrong
    gradient is O(1) apart."""
    from test_torch_uda_options import _assert_trees_rel_close
    _, _, grads, tm, _, _ = fusion_forward_pair
    got = state_dict_to_tree({k: p.grad for k, p in getattr(
        tm, part).named_parameters(prefix=part)}, {part: grads[part]})
    _assert_trees_rel_close(got[part], grads[part], 5e-5, part)
    if part == "decode_head":
        assert {"decoder_image", "decoder_events",
                "decoder_fusion"} <= set(grads[part])


# ---------------------------------------------------------------------------
# the launcher's grids build
# ---------------------------------------------------------------------------

LEGACY = dict(trun.legacy_architecture_grid())
FUSION_GRID = dict(trun.architecture_grid())


@pytest.mark.parametrize("name", sorted(LEGACY))
def test_legacy_architecture_builds(name):
    with torch.no_grad():
        out = LEGACY[name]()(torch.randn(1, 32, 32, 3))
    assert out.shape == (1, 32, 32, 19) and torch.isfinite(out).all()


@pytest.mark.parametrize("name", sorted(FUSION_GRID))
def test_fusion_architecture_builds(name):
    """Every combo of the fusion grid, the fixed-width fusions on MiT-b1
    (the JAX grid's MiT-b0 ones fail in JAX: ConvertAvgFusion's residual
    does not broadcast, ConcatenateFusion's 64-wide output does not fit the
    shared decoder's 32-wide embed)."""
    cfg = FUSION_GRID[name]
    if cfg.model.fusion in ("concatenate", "convert_avg"):
        assert cfg.model.backbone == "mit_b1"
    x = [torch.randn(1, 32, 32, 3) for _ in range(3)]
    with torch.no_grad():
        out = tseg.FusionEncoderDecoder(cfg.model).forward_logits(*x)
    assert all(v.shape == (1, 32, 32, 19) for v in out.values())
    assert {c[0] for c in jrun.architecture_grid()} == set(FUSION_GRID)


# ---------------------------------------------------------------------------
# OrgDACS on a legacy ResNet model (last: one jitted JAX step compile)
# ---------------------------------------------------------------------------

ORG_HW = (64, 64)
# AdamW's moments after each OrgDACS step, JAX against the port. JAX's
# float32 gradients through the ResNet's train-mode BatchNorm are up to
# 4.4e-2 of a leaf's largest from a float64 run of the port (the port's
# 6.4e-6; ``test_resnet_gradients_match_float64``), so the two packages'
# moments are up to 5.0e-2 (first) and 5.1e-2 (second) of a leaf's largest
# apart over the three steps, and 3.4e-3 of the group's largest (measured
# on the CPU). A gradient that is missing or reversed is 1 or 2 of its
# leaf's largest apart.
ORG_MOMENT_LEAF_RTOL = 1e-1
ORG_MOMENT_GROUP_RTOL = 1e-2


@pytest.fixture(scope="module")
def org_resnet_steps():
    """Three OrgDACS steps of both packages from one state on the
    launcher's ``dlv2red`` ResNet-101 (depths 1) GenericEncoderDecoder,
    with the feature distance (lambda 0.5, the thing classes) on its frozen
    BN-bearing twin, rows 2 / 15 of the pseudo weight zeroed, threshold 0.
    The model draws nothing (no drop-path, no dropout), so the port's
    draws are OrgDACS's own, derived from the JAX step's keys."""
    from cmda_tpu.train import optim as joptim
    from cmda_tpu.uda.dacs import DACSTrainState
    from cmda_tpu.uda.org_dacs import OrgDACSTrainer as JOrg
    from cmda_tpu_torch.uda.org_dacs import OrgDACSTrainer as TOrg
    from cmda_tpu_torch.utils.weights import (load_jax_train_state,
                                              train_state_to_numpy)
    from test_torch_image_trainers import _batches, _org_draws
    from test_torch_train import _jax_state_numpy
    uda = dict(imnet_feature_dist_lambda=0.5, pseudo_threshold=0.0,
               pseudo_weight_ignore_top=2, pseudo_weight_ignore_bottom=15,
               imnet_feature_dist_classes=(6, 7, 11, 12, 13, 14, 15, 16, 17,
                                           18))

    def cfg(C):
        c = C.micro_test_config()
        return C.replace(c, model=C.replace(c.model, train_type="cs2dz_image",
                                            fusion="", fusion_isr=""),
                         uda=C.replace(c.uda, **uda),
                         data=C.replace(c.data, crop_size=ORG_HW),
                         optim=C.replace(c.optim, warmup_iters=2,
                                         max_iters=10))
    jcfg, tcfg = cfg(JC), cfg(TC)
    b = jcfg.data.batch_size
    jb = jrun._legacy_model_builder("dlv2red", "r101v1c")
    tb = trun._legacy_model_builder("dlv2red", "r101v1c")
    jtr = JOrg(jcfg, model=jb(), imnet_model=jb())
    img = np.zeros((b, *ORG_HW, 3), np.float32)
    v = _vars(jtr.model, img, seed=81)
    iv = jax.tree.map(np.asarray, _vars(jtr.imnet, img, seed=82))
    jtr.tx = joptim.make_optimizer(v["params"], jcfg.optim)
    opt = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                       jax.eval_shape(jtr.tx.init, v["params"]))
    jstate = DACSTrainState(
        step=np.zeros((), np.int32), params=v["params"],
        batch_stats=v["batch_stats"],
        ema_params=jax.tree.map(np.copy, v["params"]), opt_state=opt,
        cyclegan_params=None, imnet_params=iv)
    ttr = TOrg(tcfg, "cpu", model=tb(), imnet_model=tb())
    tstate = ttr.init_state()
    js = _jax_state_numpy(jstate)
    js["imnet_params"] = iv
    load_jax_train_state(tstate, js)
    layout = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    jstep = jax.jit(jtr.train_step)
    base = jax.random.PRNGKey(83)
    logs, states = [], {}
    for step, batch in enumerate(_batches(3, b, 84)):
        if step == 0:
            student0 = [p.detach().clone() for p in
                        tstate.model.parameters()]
        jstate, jl = jstep(jstate, jax.tree.map(jnp.asarray, batch), base)
        draws = _org_draws(base, step, b, jcfg, tseg.ForwardDraws())
        tstate, tl = ttr.train_step(tstate, batch, draws)
        logs.append(({k: float(v) for k, v in jl.items()},
                     {k: float(v) for k, v in tl.items()}))
        states[step + 1] = (_jax_state_numpy(jstate),
                            train_state_to_numpy(tstate, layout))
        if step == 0:
            teacher0 = [p.detach().clone() for p in
                        tstate.ema_model.parameters()]
    return logs, states, jcfg, tstate, student0, teacher0


def test_org_dacs_resnet_logs_match_jax(org_resnet_steps):
    from test_torch_train_variants import _assert_logs_close
    logs = org_resnet_steps[0]
    for jl, tl in logs:
        assert jl["src/loss_imnet_feat_dist"] > 0
        np.testing.assert_allclose(jl["pseudo_weight"],
                                   (ORG_HW[0] - 17) / ORG_HW[0], rtol=1e-6)
        _assert_logs_close(jl, tl)


def test_org_dacs_resnet_state_matches_jax(org_resnet_steps):
    """The state after each step: the BN statistics to 1e-5 (1e-4 after
    step 3, as the image trainers' test holds them), the parameters and the
    EMA to 2 lr a step, and AdamW's first and second moments, which hold
    the gradients of the mixed loss and of the feature distance through
    the frozen twin: each leaf to ORG_MOMENT_LEAF_RTOL of its own largest
    and to ORG_MOMENT_GROUP_RTOL of the group's largest. JAX's
    GenericEncoderDecoder names its head ``head``, so its optimizer puts
    every parameter in the backbone group (lr x 1): so does the port's."""
    _, states, cfg, tstate = org_resnet_steps[:4]
    assert {g["part"] for g in tstate.optimizer.param_groups} == {
        "backbone"}
    for n in (1, 2, 3):
        ref, got = states[n]
        assert got["step"] == ref["step"] == n
        assert not jax.tree.leaves(ref["opt"]["head"]["mu"])
        assert got["opt"]["backbone"]["count"] == ref["opt"]["backbone"][
            "count"] == n
        tol = 1e-5 if n < 3 else 1e-4
        _assert_tree_close(got["batch_stats"], ref["batch_stats"],
                           f"batch_stats {n}", atol=tol, rtol=tol)
        lr_tol = 2 * cfg.optim.lr * n
        _assert_tree_close(got["params"], ref["params"], f"params {n}",
                           atol=lr_tol, rtol=0)
        _assert_tree_close(got["ema_params"], ref["ema_params"], f"ema {n}",
                           atol=lr_tol, rtol=0)
        for mom in ("mu", "nu"):
            r_tree = ref["opt"]["backbone"][mom]
            g_flat = dict(jax.tree_util.tree_leaves_with_path(
                got["opt"]["backbone"][mom]))
            leaves = jax.tree_util.tree_leaves_with_path(r_tree)
            assert g_flat.keys() == {k for k, _ in leaves}
            top = max(np.abs(np.asarray(r)).max() for _, r in leaves)
            for k, r in leaves:
                r = np.asarray(r)
                diff = np.abs(np.asarray(g_flat[k]) - r).max()
                what = (n, mom, jax.tree_util.keystr(k), diff)
                assert diff <= ORG_MOMENT_LEAF_RTOL * np.abs(r).max(), what
                assert diff <= ORG_MOMENT_GROUP_RTOL * top, what


def test_org_dacs_resnet_teacher_and_twin(org_resnet_steps):
    """The EMA teacher after step 0 is the pre-update student; the frozen
    ImageNet twin runs on its running statistics and takes no gradient."""
    tstate, student0, teacher0 = org_resnet_steps[3:]
    for s, t in zip(student0, teacher0, strict=True):
        assert torch.equal(s, t)
    assert not tstate.imnet.training
    assert not any(p.requires_grad for p in tstate.imnet.parameters())
    assert isinstance(tstate.imnet, tseg.GenericEncoderDecoder)
