"""bfloat16 DACS training of the port against the JAX package's bfloat16
mode (the configuration of its ``bench.py`` step), on the CPU, from seeded
numpy inputs.

In that mode both packages keep float32 parameters, EMA, AdamW state and
gradients, and compute in bfloat16 with the qk softmax, the norm
statistics and the classifier in float32: the stream logits, the losses
and the pseudo-labels are float32 (checked). The frozen CycleGAN, ClassMix,
jitter, blur and the mixed ISR run on the float32 images.

* ``DropPath`` and Dropout2d on bfloat16 inputs, given the uniforms the
  JAX modules draw (recorded), are bitwise equal to them: the kept values
  are divided by 1 - rate rounded to bfloat16.
* One train-mode layer at a time (a MiT block with stochastic depth, a
  conv + BatchNorm + ReLU on batch statistics): the port's bfloat16 output
  lies about as far from float32 as the JAX package's does, and near it.
* Three whole bfloat16 DACS steps against the JAX step (the recipe of
  ``test_torch_train.py``'s ``step_pair``: micro config at 64x64, CycleGAN
  on, one jitted JAX compile), here at non-zero drop-path and dropout
  rates, the uniforms the JAX step draws handed to the port: step 1's
  training forwards (stream logits, losses) and gradients (the first
  AdamW moments), the logs, pseudo-labels and states after 1 and 3 steps.
* The train CLI with ``--dtype bfloat16`` for 2 iterations.

Tolerances. The two packages round to bfloat16 at different places (XLA on
the CPU fuses elementwise chains in float32; PyTorch rounds after each op),
so a bfloat16 value may differ by a unit of its last place (2^-8 relative)
and the layers carry that on; ``test_torch_bf16.py`` measured the serving
logits 1.05e-2 of max|logit| apart, about as far as the JAX package's own
bfloat16 logits are from its float32 ones. Each tolerance below is stated
beside what it holds, with the value measured at this size. Where the
bfloat16 result is held against the JAX one relative to how far JAX's lies
from float32, it is also held to lie at least half as far from float32
itself, which a port that computed in float32 would not.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from cmda_tpu import config as JC
from cmda_tpu.models import common as jcommon
from cmda_tpu.models import daformer as jdaformer
from cmda_tpu.models import fusion as jfus
from cmda_tpu.models import mit as jmit
from cmda_tpu.uda import dacs as jdacs
from cmda_tpu.uda.dacs import DACSTrainer as JTrainer
from cmda_tpu.data.synthetic import SyntheticSource, SyntheticTarget
from cmda_tpu_torch import config as TC
from cmda_tpu_torch.data.synthetic import uda_batch
from cmda_tpu_torch.models.common import ConvBNReLU, DropPath
from cmda_tpu_torch.models.daformer import Classifier
from cmda_tpu_torch.models.mit import MiTBlock
from cmda_tpu_torch.models.segmentor import ForwardDraws
from cmda_tpu_torch.tools import train as tcli
from cmda_tpu_torch.uda import dacs as tdacs
from cmda_tpu_torch.uda.dacs import DACSTrainer
from cmda_tpu_torch.utils.weights import (cyclegan_to_state_dict,
                                          load_jax_train_state,
                                          load_jax_variables,
                                          train_state_to_numpy)
from test_torch_train import (_configs, _draws, _jax_cyclegan,
                              _jax_init_state, _jax_state_numpy,
                              _record_draws)
from torch_port_util import assert_labels_match, random_variables

BF16 = jnp.bfloat16
# logits, as tests/test_torch_bf16.py holds the serving forward
LOGIT_REL = 2.0 ** -6
LOSS_RTOL = 2.0 ** -6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bits(x):
    """The bfloat16 bits of a JAX array or a torch tensor, as uint16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


# ---------------------------------------------------------------------------
# (a) DropPath and Dropout2d, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.05, 0.1, 0.6])
def test_drop_path_and_dropout2d_bf16_bitwise_as_jax(rate, monkeypatch):
    """The port's DropPath against both JAX drop-paths (the MiT stages'
    ``MiTBlockScan._drop_path``, whose rate is a float32 array, and
    ``common.DropPath`` of the fusion blocks, whose rate is a Python
    float), and the classifier's Dropout2d against flax's ``nn.Dropout``
    with ``broadcast_dims=(1, 2)``, on bfloat16 inputs: bitwise, samples
    and channels dropped included."""
    g = np.random.default_rng(int(rate * 100))
    b, c = 64, 24
    y = g.normal(size=(b, 5, c)).astype(np.float32)
    yb = jnp.asarray(y, BF16)
    u = g.random(b).astype(np.float32)
    ty = torch.from_numpy(y).to(torch.bfloat16)

    scan = jmit.MiTBlockScan(dim=c, num_heads=1, mlp_ratio=4, sr_ratio=1,
                             qkv_bias=True, drop_rate=0.0, attn_drop_rate=0.0,
                             hw=(1, 5), deterministic=False, dtype=BF16)
    ref = scan._drop_path(yb, jnp.float32(rate), jnp.asarray(u))
    out = DropPath(rate)(ty, _t(u))
    assert out.dtype == torch.bfloat16 and ref.dtype == BF16
    assert (u >= 1 - rate).any() and (u < 1 - rate).any()
    np.testing.assert_array_equal(_bits(out), _bits(ref))

    rec = _record_draws(monkeypatch)
    ref = jcommon.DropPath(rate).apply({}, yb, deterministic=False,
                                       rngs={"droppath": jax.random.PRNGKey(1)})
    drawn = np.asarray(rec[-1]).reshape(b)
    assert (drawn >= 1 - rate).any()
    out = DropPath(rate)(ty, _t(drawn))
    np.testing.assert_array_equal(_bits(out), _bits(ref))

    x = g.normal(size=(b, 3, 4, c)).astype(np.float32)
    rec.clear()
    ref = fnn.Dropout(rate, broadcast_dims=(1, 2), deterministic=False).apply(
        {}, jnp.asarray(x, BF16), rngs={"dropout": jax.random.PRNGKey(2)})
    keep = _t(np.asarray(rec[-1])[:, 0, 0, :] < np.float32(1 - rate))
    assert not keep.all()
    tx = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    out = Classifier(c, 19, rate).dropout(tx, keep).permute(0, 2, 3, 1)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(out.contiguous()), _bits(ref))


def test_classifier_bf16_input_matches_jax(monkeypatch):
    """The whole classifier on a bfloat16 input: Dropout2d in bfloat16,
    then the conv in float32 (float32 logits); the conv's sums to 1e-6."""
    g = np.random.default_rng(3)
    b, c = 2, 16
    x = g.normal(size=(b, 6, 7, c)).astype(np.float32)
    jm = jdaformer.Classifier(19, 0.1, dtype=BF16)
    v = random_variables(lambda: jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x, BF16)), seed=5)
    rec = _record_draws(monkeypatch)
    ref = jm.apply(v, jnp.asarray(x, BF16), deterministic=False,
                   rngs={"dropout": jax.random.PRNGKey(4)})
    keep = _t(np.asarray(rec[-1])[:, 0, 0, :] < np.float32(0.9))
    tm = Classifier(c, 19, 0.1)
    with torch.no_grad():
        tm.weight.copy_(_t(v["params"]["conv_seg"]["kernel"]).permute(
            3, 2, 0, 1))
        tm.bias.copy_(_t(v["params"]["conv_seg"]["bias"]))
        out = tm(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2),
                 keep).permute(0, 2, 3, 1)
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


def test_stream_batchnorm_bf16_train_matches_jax():
    """Train-mode BatchNorm on a bfloat16 input: statistics in float32
    (biased variance, clamp, momentum 0.9), the output in bfloat16. The
    output to one bfloat16 unit (2^-8 relative, 2^-8 absolute near 0), the
    running statistics to 1e-6."""
    from cmda_tpu_torch.models.common import StreamBatchNorm
    g = np.random.default_rng(6)
    x = g.normal(1.0, 2.0, size=(2, 5, 6, 4)).astype(np.float32)
    xb = jnp.asarray(x, BF16)
    jm = jcommon.StreamBatchNorm(dtype=BF16)
    v = {"params": {"scale": g.uniform(0.5, 1.5, 4).astype(np.float32),
                    "bias": g.normal(size=4).astype(np.float32)},
         "batch_stats": {"mean": g.normal(size=4).astype(np.float32),
                         "var": g.uniform(0.5, 1.5, 4).astype(np.float32)}}
    ref, upd = jm.apply(v, xb, train=True, mutable=["batch_stats"])
    tm = StreamBatchNorm(4)
    with torch.no_grad():
        tm.weight.copy_(_t(v["params"]["scale"]))
        tm.bias.copy_(_t(v["params"]["bias"]))
        tm.running_mean.copy_(_t(v["batch_stats"]["mean"]))
        tm.running_var.copy_(_t(v["batch_stats"]["var"]))
        out = tm(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2),
                 bn_train=True)
    assert out.dtype == torch.bfloat16 and ref.dtype == BF16
    np.testing.assert_allclose(
        out.float().permute(0, 2, 3, 1).numpy(),
        np.asarray(ref.astype(jnp.float32)), rtol=2.0 ** -8, atol=2.0 ** -8)
    for k, t in (("mean", tm.running_mean), ("var", tm.running_var)):
        np.testing.assert_allclose(t.numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# (b) one layer at a time: how far from float32 the bfloat16 result lies
# ---------------------------------------------------------------------------

def _l2(a, b):
    return float(np.linalg.norm((np.asarray(a, np.float32)
                                 - np.asarray(b, np.float32)).ravel()))


# The two packages round to bfloat16 at different places, so their bfloat16
# results are about equally far from float32 without being close to each
# other: one train-mode MiT block lies 1.6-3.2 units of bfloat16's last
# place (2^-8 of max|out|) from the JAX block, and the float32 block (its
# output rounded to bfloat16) 1.5-2.4 units, so a bound in units cannot
# tell the two apart (measured over 4 seeds each). What does tell them
# apart is the distance from float32 itself, in L2: a port that computed in
# float32 lies 0 from it. Held, with n = |jax - f32| (f32: the port's
# float32 run of the same weights, equal to the JAX package's float32 to
# 1e-4, test_torch_train.py):
# |port - jax| <= 1.5 n (measured 0.93-1.10), and 0.5 n <= |port - f32|
# <= 1.5 n (measured 0.89-0.95 for the MiT block, 1.12-1.16 for
# conv+BN+ReLU); the largest difference to 4 units of the last place of
# max|jax| (measured 3.2 at most).
NOISE_RATIO = 1.5
F32_MIN_RATIO = 0.5
LAYER_ULPS = 4


def _layer_pair(kind):
    """(JAX bfloat16 output, the port's bfloat16 output, the port's float32
    output) of one train-mode layer: a MiT block (stochastic depth at rate
    0.5 from recorded uniforms; spatial reduction 2 or 1) or a
    conv+BatchNorm+ReLU on batch statistics."""
    g = np.random.default_rng(0)
    if kind.startswith("mit"):
        sr, dim, heads = (2, 32, 1) if kind == "mit_sr2" else (1, 64, 2)
        b, hw = 4, (8, 8)
        x = g.normal(size=(b, 64, dim)).astype(np.float32)
        u = g.random((2, b)).astype(np.float32)
        scan_in = (jnp.float32(0.5), jnp.asarray(u))
        jm = jmit.MiTBlockScan(dim=dim, num_heads=heads, mlp_ratio=4,
                               sr_ratio=sr, qkv_bias=True, drop_rate=0.0,
                               attn_drop_rate=0.0, hw=hw, deterministic=False,
                               dtype=BF16)
        v = random_variables(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.asarray(x, BF16), scan_in), seed=7)
        ref = jax.jit(lambda v, x: jm.apply(v, x, scan_in)[0])(
            v, jnp.asarray(x, BF16))
        tm = load_jax_variables(MiTBlock(dim, heads, 4, sr, drop_path=0.5), v)
        assert (u < 0.5).any() and (u >= 0.5).any()

        def port(xt):
            return tm(xt, hw, _t(u))
        xt = _t(x)
    else:
        x = g.normal(size=(2, 12, 10, 16)).astype(np.float32)
        jm = jcommon.ConvBNReLU(24, 3, dtype=BF16)
        v = random_variables(lambda: jm.init(jax.random.PRNGKey(0),
                                             jnp.asarray(x, BF16)), seed=7)
        ref = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"])[0])(
            v, jnp.asarray(x, BF16))
        tm = load_jax_variables(ConvBNReLU(16, 24, 3), v)

        def port(xt):
            return tm(xt, bn_train=True, update=False).permute(0, 2, 3, 1)
        xt = _t(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        out, f32 = port(xt.to(torch.bfloat16)), port(xt)
    assert ref.dtype == BF16 and out.dtype == torch.bfloat16
    assert f32.dtype == torch.float32
    return (np.asarray(ref.astype(jnp.float32)), out.float().numpy(),
            f32.numpy())


@pytest.mark.parametrize("kind", ["mit_sr2", "mit_sr1", "conv_bn_relu"])
def test_bf16_layer_lies_from_float32_as_jax(kind):
    ref, out, f32 = _layer_pair(kind)
    n = _l2(ref, f32)
    assert n > 0
    assert _l2(out, ref) <= NOISE_RATIO * n, (_l2(out, ref), n)
    assert (F32_MIN_RATIO * n <= _l2(out, f32) <= NOISE_RATIO * n), (
        _l2(out, f32), n)
    assert (np.abs(out - ref).max()
            <= LAYER_ULPS * 2.0 ** -8 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# (c) three bfloat16 DACS steps, at non-zero drop-path and dropout rates
# ---------------------------------------------------------------------------

# the steps' rates: the MiT drop-path ramp to 0.6, the fusion blocks' 0.5
# (a constructor argument, not a config field, in both packages), Dropout2d
# 0.5
DP_MIT, DP_FUSION, DROPOUT = 0.6, 0.5, 0.5


def _bf16_configs():
    jcfg, tcfg = _configs()

    def train(C, cfg):
        m = cfg.model
        return C.replace(cfg, dtype="bfloat16", model=C.replace(
            m, drop_path_rate=DP_MIT,
            head=C.replace(m.head, dropout_ratio=DROPOUT)))
    return train(JC, jcfg), train(TC, tcfg)


def _record_pseudo_labels(mp):
    """Record (full-size teacher logits, pseudo-labels) of every JAX
    ``pseudo_label_and_weight`` call and the port's pseudo-labels, in call
    order: (jax list, port list)."""
    jrec, trec = [], []
    jfn, tfn = jdacs.pseudo_label_and_weight, tdacs.pseudo_label_and_weight_coarse

    def jpl(logits, **kw):
        label, weight = jfn(logits, **kw)
        jrec.append((logits, label))
        return label, weight

    def tpl(logits, size, **kw):
        label, weight = tfn(logits, size, **kw)
        trec.append(label.clone())
        return label, weight
    mp.setattr(jdacs, "pseudo_label_and_weight", jpl)
    mp.setattr(tdacs, "pseudo_label_and_weight_coarse", tpl)
    return jrec, trec


def _record_stream_logits(mp):
    """Record the stream logits every ``multi_stream_loss`` of either step
    is handed (the source forward's, then the mixed forward's). The JAX
    step's are inside ``value_and_grad``, so they come out through a debug
    callback, tagged with their order in the trace: (jax list of (tag,
    logits), port list of logits)."""
    jrec, trec, traced = [], [], []
    jfn, tfn = jdacs.multi_stream_loss, tdacs.multi_stream_loss

    def jmsl(logits, *a, **k):
        tag = len(traced)
        traced.append(tag)
        jax.debug.callback(lambda lg, tag=tag: jrec.append(
            (tag, {n: np.asarray(t) for n, t in lg.items()})), logits)
        return jfn(logits, *a, **k)

    def tmsl(logits, *a, **k):
        trec.append({n: t.detach().float().numpy().copy()
                     for n, t in logits.items() if t is not None})
        return tfn(logits, *a, **k)
    mp.setattr(jdacs, "multi_stream_loss", jmsl)
    mp.setattr(tdacs, "multi_stream_loss", tmsl)
    return jrec, trec


def _port_trainer(tcfg, jstate, cyclegan):
    """The port's trainer on the CPU and its state loaded from the JAX
    state, the fusion blocks' drop-path rate set as the JAX one is."""
    ttr = DACSTrainer(tcfg, device="cpu")
    tstate = ttr.init_state(cyclegan_state_dict=cyclegan_to_state_dict(
        cyclegan))
    for m in (tstate.model, tstate.ema_model):
        for mod in m.fusion_module.modules():
            if isinstance(mod, DropPath):
                mod.rate = DP_FUSION
    return ttr, load_jax_train_state(tstate, _jax_state_numpy(jstate))


def _forward_draws(drawn, b, n_blocks):
    """The port's ForwardDraws from the uniforms one JAX training forward
    drew, in call order (test_torch_train.py's
    test_forward_train_same_draws_as_jax): 4 image stages, 4 events+ISR
    stages, the fusion blocks' two drop-paths, the 4 streams' Dropout2d."""
    return ForwardDraws(
        image=[_t(d) for d in drawn[:4]], events=[_t(d) for d in drawn[4:8]],
        fusion=_t(np.stack(drawn[8:-4]).reshape(n_blocks, 2, b)),
        dropout_keep=_t(np.stack(drawn[-4:])[:, :, 0, 0]
                        < np.float32(1.0 - DROPOUT)))


@pytest.fixture(scope="module")
def bf16_steps():
    """Three bfloat16 DACS steps of the JAX and the port's trainer from one
    state on the same batches and draws (the ``step_pair`` recipe, here at
    non-zero rates: the uniforms the JAX step's two training forwards draw,
    the same for both, are recorded and handed to the port), and the port's
    float32 steps from the same state on the same draws as the float32
    reference: the logs and states after steps 1 and 3, the stream logits
    of step 1's two forwards, and each step's pseudo-labels (JAX, port,
    port float32) with the JAX teacher's full-size logits. One jitted JAX
    compile."""
    jcfg, tcfg = _bf16_configs()
    b = 2
    n_blocks = 2 * len(jcfg.model.head.in_channels)
    n_fwd = 8 + 2 * n_blocks + 4   # uniforms a training forward draws
    mp = pytest.MonkeyPatch()
    for kind in ("attention_avg", "attention"):
        mp.setitem(jfus.FUSION_REGISTRY, kind, functools.partial(
            jfus.FUSION_REGISTRY[kind], drop_path_rate=DP_FUSION))
    jpl_rec, tpl_rec = _record_pseudo_labels(mp)
    jlg_rec, tlg_rec = _record_stream_logits(mp)
    rec = _record_draws(mp)

    def jstep_recorded(state, batch, rng):
        jpl_rec.clear()
        rec.clear()
        return jtr.train_step(state, batch, rng), list(jpl_rec), list(rec)
    try:
        jtr = JTrainer(jcfg)
        cyclegan = _jax_cyclegan()
        jstate = _jax_init_state(jtr, jcfg, cyclegan)
        jstep = jax.jit(jstep_recorded)
        ttr, tstate = _port_trainer(tcfg, jstate, cyclegan)
        ftr, fstate = _port_trainer(TC.replace(tcfg, dtype="float32"),
                                    jstate, cyclegan)
        src = SyntheticSource(crop_size=jcfg.data.crop_size)
        tgt = SyntheticTarget(crop_size=jcfg.data.crop_size)
        base = jax.random.PRNGKey(11)
        layout = {"params": jstate.params, "batch_stats": jstate.batch_stats}
        results, pls, logits = {}, [], None
        jstate0 = jstate
        for step in range(3):
            batch = uda_batch(src, tgt, [2 * step, 2 * step + 1])
            jlg_rec.clear()
            (jstate, jlogs), jpl, drawn = jstep(
                jstate, jax.tree.map(jnp.asarray, batch), base)
            jax.effects_barrier()
            drawn = [np.asarray(d) for d in drawn[-2 * n_fwd:]]
            for s, m in zip(drawn[:n_fwd], drawn[n_fwd:], strict=True):
                np.testing.assert_array_equal(s, m)
            fwd = _forward_draws(drawn[:n_fwd], b, n_blocks)
            if step == 0:   # the draws do drop
                assert not fwd.dropout_keep.all()
                assert (fwd.fusion >= 1 - DP_FUSION).any()
                assert any((d >= 1 - DP_MIT).any() for d in drawn[:8])
            draws = _draws(base, step, b, jcfg, fwd)
            tpl_rec.clear()
            tlg_rec.clear()
            tstate, tlogs = ttr.train_step(tstate, batch, draws)
            fstate, _ = ftr.train_step(fstate, batch, draws)
            [(jlogits, jlabel)] = jpl
            pls.append((np.asarray(jlogits), np.asarray(jlabel),
                        tpl_rec[0].numpy(), tpl_rec[1].numpy()))
            if step == 0:
                assert sorted(t for t, _ in jlg_rec) == [0, 1]
                logits = ([lg for _, lg in sorted(jlg_rec,
                                                  key=lambda r: r[0])],
                          tlg_rec[:2], tlg_rec[2:])
            if step in (0, 2):
                results[step + 1] = (
                    {k: float(v) for k, v in jlogs.items()},
                    {k: float(v) for k, v in tlogs.items()},
                    _jax_state_numpy(jstate),
                    train_state_to_numpy(tstate, layout),
                    train_state_to_numpy(fstate, layout))
        assert tstate.model.dtype == torch.bfloat16
        # ROADMAP C1: step 0 again from a confident teacher, the start
        # state with the classifier's kernel scaled CONFIDENT_SCALE times in
        # both packages (the state is an input: no new compile)
        params = jax.tree.map(np.array, jstate0.params)
        params["decode_head"]["cls"]["conv_seg"]["kernel"] *= CONFIDENT_SCALE
        conf = jstate0.replace(params=params,
                               ema_params=jax.tree.map(np.copy, params))
        batch = uda_batch(src, tgt, [0, 1])
        _, jpl, drawn = jstep(conf, jax.tree.map(jnp.asarray, batch), base)
        fwd = _forward_draws(
            [np.asarray(d) for d in drawn[-2 * n_fwd:-n_fwd]], b, n_blocks)
        ctr, cstate = _port_trainer(tcfg, conf, cyclegan)
        tpl_rec.clear()
        ctr.train_step(cstate, batch, _draws(base, 0, b, jcfg, fwd))
        [(jlogits, jlabel)] = jpl
        confident = (np.asarray(jlogits), np.asarray(jlabel),
                     tpl_rec[0].numpy())
    finally:
        mp.undo()
    return results, pls, jcfg, logits, confident


def _leaf_errors(got, ref):
    """{path: max|got - ref| / max|ref|} over the leaves of two trees."""
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    out = {}
    for k, r in jax.tree_util.tree_leaves_with_path(ref):
        r = np.asarray(r, np.float32)
        scale = max(float(np.abs(r).max()), 1e-30)
        out[jax.tree_util.keystr(k)] = float(
            np.abs(np.asarray(flat_g[k], np.float32) - r).max()) / scale
    return out


def _flat(tree, keys):
    return np.concatenate([np.asarray(tree[k], np.float32).ravel()
                           for k in keys])


def _moments(state, part):
    return dict(jax.tree_util.tree_leaves_with_path(state["opt"][part]["mu"]))


# The training forward at non-zero rates: train-mode BatchNorm and the
# drop-path scaling carry the packages' different bfloat16 roundings on, so
# the logits and gradients are held against how far the JAX package's own
# bfloat16 result lies from float32 (n = |jax - f32|, as in (b)), from both
# sides. Logits, per forward and stream, max-abs: |port - jax| <= 1.5 n
# (measured 0.76-1.28; n is 1.5-3.6% of max|logit|) and |port - f32| >=
# 0.5 n (measured 0.73-1.26). The gradients are step 1's AdamW first
# moments, 0.1 x the source and the mixed gradient summed; over all
# parameters in L2: |port - jax| <= 1.5 n (measured 1.09; n is 7.1% of
# |f32|) and 0.5 n <= |port - f32| <= 1.5 n (measured 1.07); per tensor,
# each tensor's largest difference to 2^-4 of the largest gradient of all
# (measured 3.1e-2). Relative to a tensor's own largest it is not held: a
# tensor whose gradient is a sum that nearly cancels differs by a large
# share of its small largest in JAX's own bfloat16 run too.
LOGIT_NOISE_RATIO = 1.5
GRAD_NOISE_RATIO = 1.5
GRAD_REL_OF_LARGEST = 2.0 ** -4


def test_bf16_training_forward_losses_and_grads_match_jax(bf16_steps):
    """Step 1's two training forwards (source, then mixed; MiT drop-path
    ramp to 0.6, fusion blocks 0.5, Dropout2d 0.5, the port with remat on):
    the four stream logits (float32 in both packages), each stream's loss
    of both forwards to 2^-6 relative (measured 4.3e-4 at most), and the
    parameter gradients, as stated above."""
    results, _, _, (jlogits, tlogits, flogits), _ = bf16_steps
    jlogs, tlogs = results[1][:2]
    for k, r in jlogs.items():
        if k.startswith(("src/", "mix/")) and not k.endswith("acc_seg"):
            np.testing.assert_allclose(tlogs[k], r, rtol=LOSS_RTOL,
                                       err_msg=k)
    for j, p, f in zip(jlogits, tlogits, flogits, strict=True):
        assert set(j) == set(p) == set(f)
        for k, r in j.items():
            assert r.dtype == np.float32
            err, noise = np.abs(p[k] - r).max(), np.abs(r - f[k]).max()
            assert err <= LOGIT_NOISE_RATIO * noise, (k, err, noise)
            assert np.abs(p[k] - f[k]).max() >= F32_MIN_RATIO * noise, k

    ref, got, f32 = results[1][2:]
    leaves = {(part, k): r for part in ("head", "backbone")
              for k, r in _moments(ref, part).items()}
    j, p, f = (np.concatenate([_flat(_moments(t, part), [k])
                               for part, k in leaves])
               for t in (ref, got, f32))
    noise = np.linalg.norm(j - f)
    assert np.linalg.norm(p - j) <= GRAD_NOISE_RATIO * noise
    assert (F32_MIN_RATIO * noise <= np.linalg.norm(p - f)
            <= GRAD_NOISE_RATIO * noise)
    largest = np.abs(f).max()
    worst = max((float(np.abs(np.asarray(_moments(got, part)[k])
                              - np.asarray(r)).max()),
                 part, jax.tree_util.keystr(k))
                for (part, k), r in leaves.items())
    assert worst[0] <= GRAD_REL_OF_LARGEST * largest, (worst, largest)


# the step's logs: the losses to 2^-6 relative, as the forward above
# (measured 4.3e-4 at most); acc_seg (percent of 2 x 64 x 64 pixels) to 1
# point: near-tie pixels of a stream's argmax flip with the bfloat16
# roundings (measured 0.21 at most)
STEP_LOSS_RTOL = 2.0 ** -6
STEP_ACC_ATOL = 1.0
# pseudo-labels: every disagreement at a near tie of the JAX teacher's
# logits (top-2 margin below 2 x 2^-6 of max|logit|; measured 2.4% of
# max|logit| at most), and at least 97% equal (measured 97.5-98.0%). The
# 99% of the serving test is out of reach at this size for any bfloat16
# that rounds elsewhere than XLA does: the JAX package's own bfloat16
# pseudo-labels equal the float32 step's on 98.0-98.2% of the pixels (the
# port's float32 step, which equals the JAX one), because the micro
# teacher's random weights give nearly flat logits (a quarter to a third
# of the pixels have a top-2 margin under 2 x 2^-6 of max|logit|; not one
# is confident enough for the pseudo weight).
MIN_PL_AGREEMENT = 0.97
# ROADMAP C1's untried check, a teacher with confident logits: the start
# state with the classifier's kernel scaled 10x (mean max-softmax 0.78
# against the random teacher's 0.14) agrees on 97.5% of the pixels, as the
# random one does: scaling the logits scales their top-2 margins and the
# bfloat16 rounding carried into them alike. Held to the same rule and
# bound; 99% would need margins large beside that rounding, a trained
# teacher's.
CONFIDENT_SCALE = 10.0
CONFIDENT_MIN_MAX_SOFTMAX = 0.7
# AdamW first moments, in L2 over each optimizer group: |port - jax| <= 1.5
# n and 0.5 n <= |port - f32| <= 1.5 n, n = |jax - f32| (measured 1.07-1.12
# and 0.95-1.09; n is 3-9% of |f32|); per tensor, the largest difference to
# 2^-2 of the group's largest first moment (measured 11% at most). BN
# running statistics, per tensor, to 2^-5 of the tensor's largest
# (measured 0.64%).
MOMENT_NOISE_RATIO = 1.5
MOMENT_REL = 2.0 ** -2
BN_REL = 2.0 ** -5


@pytest.mark.parametrize("n_steps", [1, 3])
def test_bf16_dacs_step_logs_match_jax(bf16_steps, n_steps):
    jlogs, tlogs = bf16_steps[0][n_steps][:2]
    assert set(tlogs) == set(jlogs)
    for k, ref in jlogs.items():
        if k.endswith("acc_seg"):
            assert abs(tlogs[k] - ref) <= STEP_ACC_ATOL, (k, tlogs[k], ref)
        else:
            np.testing.assert_allclose(tlogs[k], ref, rtol=STEP_LOSS_RTOL,
                                       atol=1e-6, err_msg=k)


def test_bf16_dacs_pseudo_labels_match_jax(bf16_steps):
    jl, jlab, tlab = bf16_steps[4]
    confident = float(jax.nn.softmax(jl, -1).max(-1).mean())
    assert confident >= CONFIDENT_MIN_MAX_SOFTMAX, confident
    for jlogits, jlabel, tlabel in [p[:3] for p in bf16_steps[1]] + [
            (jl, jlab, tlab)]:
        assert jlogits.dtype == np.float32
        assert_labels_match(tlabel, jlabel, jlogits,
                            2 * LOGIT_REL * np.abs(jlogits).max())
        assert (tlabel == jlabel).mean() >= MIN_PL_AGREEMENT


@pytest.mark.parametrize("n_steps", [1, 3])
def test_bf16_dacs_state_matches_jax(bf16_steps, n_steps):
    """AdamW's first moments (the gradients) and the BN running statistics
    as stated above; the parameters and the EMA teacher to 2 lr x
    head_lr_mult per step, as the float32 test holds them: Adam's early
    updates are close to sign(g), so a tiny gradient can flip (measured
    0.0014 after 3 steps, against 0.0036)."""
    results, _, cfg, _, _ = bf16_steps
    _, _, ref, got, f32 = results[n_steps]
    assert got["step"] == ref["step"] == n_steps
    for part in ("head", "backbone"):
        assert got["opt"][part]["count"] == ref["opt"][part]["count"]
        leaves = _moments(ref, part)
        keys = list(leaves)
        j, p, f = (_flat(_moments(t, part), keys) for t in (ref, got, f32))
        noise = np.linalg.norm(j - f)
        assert np.linalg.norm(p - j) <= MOMENT_NOISE_RATIO * noise, part
        assert (F32_MIN_RATIO * noise <= np.linalg.norm(p - f)
                <= MOMENT_NOISE_RATIO * noise), part
        flat = _moments(got, part)
        scale = np.abs(j).max()
        for k, r in leaves.items():
            diff = np.abs(np.asarray(flat[k]) - np.asarray(r)).max()
            assert diff <= MOMENT_REL * scale, (part, jax.tree_util.keystr(k),
                                                diff, scale)
    errs = _leaf_errors(got["batch_stats"], ref["batch_stats"])
    worst = max(errs.items(), key=lambda kv: kv[1])
    assert worst[1] <= BN_REL, worst
    atol = 2 * cfg.optim.lr * cfg.optim.head_lr_mult * n_steps
    for what in ("params", "ema_params"):
        flat = dict(jax.tree_util.tree_leaves_with_path(got[what]))
        for k, r in jax.tree_util.tree_leaves_with_path(ref[what]):
            np.testing.assert_allclose(
                np.asarray(flat[k]), np.asarray(r), atol=atol, rtol=0,
                err_msg=f"{what} {jax.tree_util.keystr(k)}")


# ---------------------------------------------------------------------------
# (d) the CLI
# ---------------------------------------------------------------------------

def test_cli_bf16_two_iterations(tmp_path, capsys):
    import json
    loop = tcli.main(["--config", "tiny", "--synthetic", "--device", "cpu",
                      "--num-workers", "2", "--max-iters", "2", "--dtype",
                      "bfloat16", "--work-dir", str(tmp_path)])
    done = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert done["done"] and done["step"] == 2
    assert loop.cfg.dtype == "bfloat16"
    assert loop.state.model.dtype == torch.bfloat16
    assert loop.state.ema_model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in loop.state.model.parameters())
    with open(loop.log_path) as f:
        records = [json.loads(line) for line in f]
    # the loop logs the first iteration and every log_interval after it
    steps = [r for r in records if "loss" in r]
    assert [r["iter"] for r in steps] == [1] and len(steps[0]) > 10
    assert all(np.isfinite(v) for v in steps[0].values()
               if isinstance(v, float))
    assert loop.state.step == 2
    assert all(bool(torch.isfinite(p).all())
               for p in loop.state.model.parameters())


def test_unported_options_still_raise_in_bf16():
    """bfloat16 builds, and so do the step levers of the JAX package
    (stacked stream CE, the batched-train head, the four-direction mixed
    ISR); float16 is refused."""
    _, tcfg = _bf16_configs()
    DACSTrainer(tcfg, device="cpu")   # bfloat16 itself is ported
    for cfg in (TC.replace(tcfg, uda=TC.replace(tcfg.uda,
                                                stacked_stream_ce=True)),
                TC.replace(tcfg, model=TC.replace(tcfg.model,
                                                  head_batched_train=True)),
                TC.replace(tcfg, uda=TC.replace(tcfg.uda, shift_type="all"))):
        trainer = DACSTrainer(cfg, device="cpu")
        assert trainer.cfg.dtype == "bfloat16"
        assert trainer.init_state().model.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float16"):
        DACSTrainer(TC.replace(tcfg, dtype="float16"), device="cpu")
