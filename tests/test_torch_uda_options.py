"""The flagship recipe's UDA ablations and the JAX package's step levers in
the port, against the JAX package on the CPU, from seeded numpy inputs.

Modules, each against its JAX function:
* ``StreamBatchNorm`` with 1-4 stream groups: values and running
  statistics to 1e-6 (and equal to k calls one after another);
* the DAFormer head's batched training decode (``model.head_batched_train``)
  with 3 and 4 streams, the Dropout2d mask the JAX head draws recorded:
  logits, gradients and running statistics to 1e-5 of each tensor's
  largest;
* the integer-factor phase upsample (``--fused-resize``) at factors 2, 4
  and 8, with h or w of 1: against JAX's ``phase_upsample_bilinear`` and
  ``F.interpolate`` to float roundoff (2e-6), values and gradients;
* the stacked stream CE (``uda.stacked_stream_ce``) with and without the
  pixel weight, with ignored pixels: losses and gradients to 1e-6 relative;
* the step's mixed ISR under ``uda.shift_type='all'`` (no kernel) to 1e-5;
* the training forward in modes ``fusion_isr`` (single and double batch) and
  ``fusion_all`` at non-zero drop-path and Dropout2d rates, the uniforms
  the JAX forward draws recorded: logits and running statistics to 1e-5 of
  each tensor's largest (their gradients: the steps' first moments).

Steps (the micro config at 64x64, rates 0, ``test_torch_train.py``'s
tolerances: logs rtol 1e-4, BN statistics and EMA 1e-5, first moments
1e-4 of each leaf's largest, parameters 2 lr head_lr_mult):
* the port's own ``without_events``, ``without_isd`` and ``source_only``
  steps against its default step (held to JAX in test_torch_train.py):
  equal to it with the coin forced, and to its source half;
* ``debug_tensors`` and the train CLI under the options;
* last, the two jitted JAX DACS step compiles: A, events_together with
  ``fuse_both_ice_and_e``, ``stacked_stream_ce``, ``head_batched_train`` and
  ``shift_type='all'``; B, ``cs2dsec_image+events`` with
  ``isr_another_fusion`` and ``isr_no_fusion`` under both coin outcomes
  (one compile, two calls): logs, pseudo-labels (equal but at near ties of
  the JAX teacher's logits), first moments and BN statistics after one
  step.
"""
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from cmda_tpu import config as JC
from cmda_tpu.models import common as jcommon
from cmda_tpu.models import daformer as jdaformer
from cmda_tpu.models import fusion as jfus
from cmda_tpu.models.segmentor import FusionEncoderDecoder as JFED
from cmda_tpu.ops import resize as jresize
from cmda_tpu.uda import transforms as jtransforms
from cmda_tpu.uda.dacs import DACSTrainer as JTrainer
from cmda_tpu.data.synthetic import SyntheticSource, SyntheticTarget
from cmda_tpu_torch import config as TC
from cmda_tpu_torch.data.synthetic import uda_batch
from cmda_tpu_torch.models.common import DropPath, StreamBatchNorm
from cmda_tpu_torch.models.daformer import DAFormerFusionHead
from cmda_tpu_torch.models.segmentor import (FusionEncoderDecoder as TFED,
                                             ForwardDraws)
from cmda_tpu_torch.ops import resize as tresize
from cmda_tpu_torch.tools import train as tcli
from cmda_tpu_torch.uda import dacs as tdacs
from cmda_tpu_torch.uda import transforms as ttransforms
from cmda_tpu_torch.uda.dacs import DACSTrainer
from cmda_tpu_torch.utils.weights import (load_jax_train_state,
                                          load_jax_variables,
                                          state_dict_to_tree,
                                          train_state_to_numpy)
from test_torch_train import (_draws, _jax_init_state, _jax_state_numpy,
                              _record_draws)
from test_torch_train_bf16 import _record_pseudo_labels
from test_torch_train_variants import (_assert_logs_close,
                                       _assert_state_close, _coin)
from torch_port_util import assert_labels_match, random_variables

HW = (64, 64)
# the forward tests' rates: the MiT drop-path ramp to 0.6, the fusion
# blocks' 0.5 (a constructor argument in both packages), Dropout2d 0.5
DP_MIT, DP_FUSION, DROPOUT = 0.6, 0.5, 0.5


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_rel_close(got, ref, rel, what):
    """max|got - ref| within ``rel`` of max|ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    diff = np.abs(got - ref).max()
    assert diff <= rel * scale, (what, diff, scale)


def _assert_trees_rel_close(got, ref, rel, what):
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert flat.keys() == {k for k, _ in leaves}, what
    for k, r in leaves:
        _assert_rel_close(flat[k], r, rel, f"{what} {jax.tree_util.keystr(k)}")


def _grad_tree(module, layout):
    """The gradients of ``module``'s parameters in the JAX layout of
    ``layout`` (zeros where a parameter took none, as jax.grad gives)."""
    return state_dict_to_tree(
        {k: (p.grad if p.grad is not None else torch.zeros_like(p))
         for k, p in module.named_parameters()}, layout)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2, 3, 4])
def test_stream_batchnorm_groups_match_jax(groups):
    g = np.random.default_rng(groups)
    x = g.normal(1.0, 2.0, size=(2 * groups, 5, 6, 4)).astype(np.float32)
    v = {"params": {"scale": g.uniform(0.5, 1.5, 4).astype(np.float32),
                    "bias": g.normal(size=4).astype(np.float32)},
         "batch_stats": {"mean": g.normal(size=4).astype(np.float32),
                         "var": g.uniform(0.5, 1.5, 4).astype(np.float32)}}
    ref, upd = jcommon.StreamBatchNorm().apply(
        v, x, train=True, stream_groups=groups, mutable=["batch_stats"])

    def port():
        tm = StreamBatchNorm(4)
        with torch.no_grad():
            tm.weight.copy_(_t(v["params"]["scale"]))
            tm.bias.copy_(_t(v["params"]["bias"]))
            tm.running_mean.copy_(_t(v["batch_stats"]["mean"]))
            tm.running_var.copy_(_t(v["batch_stats"]["var"]))
        return tm
    tm = port()
    out = tm(_t(x).permute(0, 3, 1, 2), bn_train=True, groups=groups)
    tol = dict(atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(ref), **tol)
    np.testing.assert_allclose(tm.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), **tol)
    np.testing.assert_allclose(tm.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), **tol)
    # the groups are k calls one after another
    seq = port()
    parts = [seq(p.permute(0, 3, 1, 2), bn_train=True)
             for p in _t(x).chunk(groups)]
    np.testing.assert_allclose(out.detach().numpy(),
                               torch.cat(parts).detach().numpy(), **tol)
    np.testing.assert_allclose(tm.running_var.numpy(),
                               seq.running_var.numpy(), **tol)


def _head_feats(g, b, cfg, n_streams):
    """Seeded NHWC pyramids of the head's streams at a 128x128 input. At
    64x64 the stride-32 map is 2x2, upsampled 8x, and a dilated depthwise
    BatchNorm then sees near-constant channels whose one-pass variance
    cancels: the gradients of its bias and of the stride-32 embedding came
    out 2.6e-3 of their largest apart between the two packages, their
    per-stream heads alike; at 128x128 every tensor agrees within 1e-5."""
    names = ["f_image", "f_events", "f_fusion", "f_img_self_res"]
    feats = {n: None for n in names}
    for n in names[:n_streams]:
        feats[n] = [g.normal(size=(b, 32 >> i, 32 >> i, c)).astype(np.float32)
                    for i, c in enumerate(cfg.in_channels)]
    return feats


@pytest.mark.parametrize("n_streams", [3, 4])
def test_batched_train_head_matches_jax(n_streams, monkeypatch):
    """The head's stacked decode with batch statistics (grouped BN) and
    the Dropout2d mask of the JAX head's one batched draw [S*B, 1, 1, C],
    handed to the port as [S, B, C]: logits, the gradients of the
    parameters and of the pyramids, and the running statistics to 1e-5 of
    each tensor's largest; and the port's batched head equals its
    per-stream loop."""
    b = 2
    jcfg = JC.replace(JC.micro_test_config().model.head,
                      dropout_ratio=DROPOUT)
    tcfg = TC.replace(TC.micro_test_config().model.head,
                      dropout_ratio=DROPOUT)
    g = np.random.default_rng(30 + n_streams)
    feats = _head_feats(g, b, jcfg, n_streams)
    jm = jdaformer.DAFormerFusionHead(jcfg, batched_train=True)
    v = random_variables(lambda: jm.init(jax.random.PRNGKey(0), feats),
                         seed=n_streams)
    keys = [k for k, f in zip(("image_output", "events_output",
                               "fusion_output", "img_self_res_output"),
                              feats.values()) if f is not None]
    cot = {k: g.normal(size=(b, 32, 32, 19)).astype(np.float32) for k in keys}
    rec = _record_draws(monkeypatch)

    def jloss(params, feats):
        out, upd = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, feats,
                            train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(5)})
        return (sum(jnp.sum(out[k] * cot[k]) for k in keys), (out, upd))

    @jax.jit
    def jgrad(params, feats):
        rec.clear()
        (_, aux), grads = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(params, feats)
        return aux, grads, list(rec)
    (ref, upd), (gp, gf), drawn = jgrad(v["params"], feats)
    [u] = [np.asarray(r) for r in drawn]
    assert u.shape == (n_streams * b, 1, 1, jcfg.channels)
    keep = _t(u.reshape(n_streams, b, -1) < np.float32(1 - DROPOUT))
    assert not keep.all()

    def port(batched):
        th = load_jax_variables(DAFormerFusionHead(tcfg,
                                                   batched_train=batched), v)
        tf = {k: ([_t(x).permute(0, 3, 1, 2).requires_grad_()
                   for x in f] if f is not None else None)
              for k, f in feats.items()}
        out = th(tf, train=True, dropout_keep=keep)
        out = {k: o.permute(0, 2, 3, 1) for k, o in out.items()
               if o is not None}
        sum((out[k] * _t(cot[k])).sum() for k in keys).backward()
        return th, tf, out
    th, tf, out = port(True)
    for k in keys:
        _assert_rel_close(out[k].detach().numpy(), ref[k], 1e-5, k)
    _assert_trees_rel_close(_grad_tree(th, gp), gp, 1e-5, "grad")
    for k, f in tf.items():
        if f is not None:
            for i, (x, r) in enumerate(zip(f, gf[k])):
                _assert_rel_close(x.grad.permute(0, 2, 3, 1).numpy(), r,
                                  1e-5, f"grad {k}[{i}]")
    _assert_trees_rel_close(state_dict_to_tree(th.state_dict(),
                                               upd["batch_stats"]),
                            upd["batch_stats"], 1e-5, "batch_stats")
    loop, _, loop_out = port(False)
    for k in keys:
        _assert_rel_close(out[k].detach().numpy(),
                          loop_out[k].detach().numpy(), 1e-5, f"loop {k}")
    for name, buf in loop.named_buffers():
        if "running" in name:
            _assert_rel_close(th.get_buffer(name).numpy(), buf.numpy(), 1e-6,
                              f"loop {name}")


@pytest.mark.parametrize("factor", [2, 4, 8])
@pytest.mark.parametrize("hw", [(3, 5), (1, 4), (4, 1)],
                         ids=["3x5", "h1", "w1"])
def test_phase_upsample_matches_jax_and_interpolate(factor, hw, monkeypatch):
    """Values to 2e-6 and gradients to 2e-6 of the largest against JAX's
    phase form and ``F.interpolate``; under the flag ``resize_bilinear`` and the decoder's
    NCHW upsample take the phase form for integer factors only."""
    g = np.random.default_rng(factor * 10 + hw[0])
    x = g.normal(size=(2,) + hw + (3,)).astype(np.float32)
    size = (hw[0] * factor, hw[1] * factor)
    cot = g.normal(size=(2,) + size + (3,)).astype(np.float32)
    @jax.jit
    def jvjp(a, c):
        y, vjp = jax.vjp(lambda a: jresize.phase_upsample_bilinear(a, size),
                         a)
        return y, vjp(c)[0]
    ref, ref_grad = jvjp(jnp.asarray(x), jnp.asarray(cot))
    xt = _t(x).requires_grad_()
    out = tresize.phase_upsample_bilinear(xt, size)
    (out * _t(cot)).sum().backward()
    xi = _t(x).requires_grad_()
    interp = F.interpolate(xi.permute(0, 3, 1, 2), size=size,
                           mode="bilinear", align_corners=False
                           ).permute(0, 2, 3, 1)
    (interp * _t(cot)).sum().backward()
    tol = dict(atol=2e-6, rtol=2e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(out.detach().numpy(), interp.detach().numpy(),
                               **tol)
    # each gradient sums factor^2 cotangents: to 2e-6 of the largest
    _assert_rel_close(xt.grad.numpy(), ref_grad, 2e-6, "grad vs JAX")
    _assert_rel_close(xt.grad.numpy(), xi.grad.numpy(), 2e-6,
                      "grad vs F.interpolate")

    monkeypatch.setattr(tresize, "_FUSED_INT_UPSAMPLE", True)
    assert torch.equal(tresize.resize_bilinear(_t(x), size), out)
    nchw = tresize.upsample_bilinear_nchw(_t(x).permute(0, 3, 1, 2), size)
    assert torch.equal(nchw.permute(0, 2, 3, 1), out)
    odd = (size[0] + 1, size[1] + 1)
    np.testing.assert_array_equal(
        tresize.resize_bilinear(_t(x), odd).numpy(),
        F.interpolate(_t(x).permute(0, 3, 1, 2), size=odd, mode="bilinear",
                      align_corners=False).permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["no_weight", "pixel_weight"])
def test_stacked_stream_ce_matches_jax(weighted):
    """``multi_stream_loss(stacked=True)`` of four streams with ~5% ignored
    pixels against the JAX function's: the losses and logs to 1e-6
    relative (acc_seg exactly), the gradients of the four streams to 1e-6
    of their largest; and equal to the port's per-stream path."""
    g = np.random.default_rng(7 + weighted)
    b, h, c = 2, 64, 19
    keys = ("image_output", "events_output", "fusion_output",
            "img_self_res_output")
    logits = {k: g.normal(size=(b, 16, 16, c)).astype(np.float32)
              for k in keys}
    label = g.integers(0, c, size=(b, h, h)).astype(np.int32)
    label[g.random(label.shape) < 0.05] = 255
    weight = (g.uniform(0.0, 1.0, size=(b, h, h)).astype(np.float32)
              if weighted else None)
    w = dict(w_image=0.5, w_events=0.5, w_fusion=0.5, w_isr=0.25)

    def jloss(lg):
        return jtransforms.multi_stream_loss(
            lg, jnp.asarray(label), None if weight is None
            else jnp.asarray(weight), stacked=True, pallas_ce=False, **w)
    (ref, jlogs), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in logits.items()})

    def port(stacked):
        lg = {k: _t(v).requires_grad_() for k, v in logits.items()}
        loss, logs = ttransforms.multi_stream_loss(
            lg, _t(label), None if weight is None else _t(weight),
            stacked=stacked, **w)
        loss.backward()
        return loss, logs, lg
    loss, logs, lg = port(True)
    assert set(logs) == set(jlogs)
    for k, r in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(r), rtol=1e-6,
                                   atol=0 if k.endswith("acc_seg") else 1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
    for k in keys:
        _assert_rel_close(lg[k].grad.numpy(), jgrad[k], 1e-6, k)
    loss2, logs2, lg2 = port(False)
    np.testing.assert_allclose(loss2.item(), loss.item(), rtol=1e-6)
    for k in keys:
        _assert_rel_close(lg2[k].grad.numpy(), lg[k].grad.numpy(), 1e-6, k)


def test_mixed_isr_shift_all_matches_jax(monkeypatch):
    """``_mixed_isr`` under ``uda.shift_type='all'``: the mean of the four
    single-axis ICs of each image, to 1e-5 of the JAX step's, with no call
    of the ISR kernel's wrapper (the JAX step takes no Pallas ISR there)."""
    jcfg, tcfg = (C.replace(C.micro_test_config(), uda=C.replace(
        C.micro_test_config().uda, shift_type="all")) for C in (JC, TC))
    g = np.random.default_rng(12)
    img = g.normal(0.0, 1.0, size=(2, 32, 40, 3)).astype(np.float32)
    dirs = np.array([1, 2], np.int32)
    with jax.disable_jit():
        ref = JTrainer(jcfg)._mixed_isr(jnp.asarray(img), jnp.asarray(dirs))

    def no_kernel(*a, **k):
        raise AssertionError("the ISR kernel ran under shift_type='all'")
    monkeypatch.setattr(tdacs, "batched_isr", no_kernel)
    out = DACSTrainer(tcfg, device="cpu")._mixed_isr(_t(img), _t(dirs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _forward_configs(C):
    cfg = C.micro_test_config().model
    return C.replace(cfg, drop_path_rate=DP_MIT,
                     head=C.replace(cfg.head, dropout_ratio=DROPOUT))


@pytest.fixture(scope="module")
def forward_model():
    """The JAX micro segmentor at the forward tests' rates, its seeded
    variables (initialised in mode fusion_all, both fusion modules) and
    three 64x64 inputs."""
    jm = JFED(_forward_configs(JC))
    g = np.random.default_rng(40)
    x = [g.normal(size=(2,) + HW + (3,)).astype(np.float32)
         for _ in range(3)]
    v = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), *x, mode="fusion_all",
        method=jm.forward_logits), seed=19)
    return jm, v, x


@pytest.mark.parametrize("mode,double", [("fusion_isr", False),
                                         ("fusion_isr", True),
                                         ("fusion_all", True)],
                         ids=["fusion_isr_single", "fusion_isr_double",
                              "fusion_all"])
def test_forward_train_modes_same_draws_as_jax(mode, double, forward_model,
                                               monkeypatch):
    """The micro segmentor's training forward in the ISR fusion modes at
    non-zero rates (64x64), the uniforms the jitted JAX forward draws
    recorded in call order (the image stages [1, 2, B], the events stages
    [1, 2, B] or the double batch's [1, 2, 2B], the ISR fusion module's
    blocks and then, in fusion_all, the fusion module's, two [B, 1, 1]
    each, one Dropout2d [B, 1, 1, C] per stream) and handed to the port as
    its ``ForwardDraws``: the logits to 1e-5 of each stream's largest, the
    BN running statistics to 1e-5. The gradients of these modes are held
    by the steps below (A: fusion_all; B: fusion_isr on the single batch),
    whose first moments are the gradients: a jitted JAX gradient here
    would add about 20 s of compile per mode."""
    b = 2
    for kind in ("attention_avg", "attention"):
        monkeypatch.setitem(jfus.FUSION_REGISTRY, kind, functools.partial(
            jfus.FUSION_REGISTRY[kind], drop_path_rate=DP_FUSION))
    jm, v, x = forward_model
    inputs = x if double else x[:2] + [None]
    n_streams = 4 if double else 3
    rec = _record_draws(monkeypatch)

    @jax.jit
    def jfwd(v, *x):
        rec.clear()
        out = jm.apply(v, *x, mode=mode, mutable=["batch_stats"],
                       rngs={"droppath": jax.random.PRNGKey(3),
                             "dropout": jax.random.PRNGKey(4)},
                       method=jm.forward_train)
        return out, list(rec)
    ((ref, _), upd), drawn = jfwd(v, *inputs)
    drawn = [np.asarray(u) for u in drawn]
    head = _forward_configs(JC).head
    n_isr = len(head.in_channels)
    n_avg = 2 * n_isr if mode == "fusion_all" else 0
    ev = 2 * b if double else b
    assert [u.shape for u in drawn] == (
        [(1, 2, b)] * 4 + [(1, 2, ev)] * 4
        + [(b, 1, 1)] * 2 * (n_isr + n_avg)
        + [(b, 1, 1, head.channels)] * n_streams)
    blocks = drawn[8:-n_streams]
    draws = ForwardDraws(
        image=[_t(u) for u in drawn[:4]], events=[_t(u) for u in drawn[4:8]],
        fusion_isr=_t(np.stack(blocks[:2 * n_isr]).reshape(n_isr, 2, b)),
        fusion=(_t(np.stack(blocks[2 * n_isr:]).reshape(n_avg, 2, b))
                if n_avg else None),
        dropout_keep=_t(np.stack(drawn[-n_streams:])[:, :, 0, 0]
                        < np.float32(1 - DROPOUT)))
    assert (draws.fusion_isr >= 1 - DP_FUSION).any()
    assert not draws.dropout_keep.all()

    tm = load_jax_variables(TFED(TC.replace(_forward_configs(TC),
                                            remat=True)), v)
    for fm in (tm.fusion_module, tm.fusion_isr_module):
        for mod in fm.modules():
            if isinstance(mod, DropPath):
                mod.rate = DP_FUSION
    with torch.no_grad():
        out, _ = tm.forward_train(*(None if a is None else _t(a)
                                    for a in inputs), mode, draws)
    assert sorted(k for k, o in out.items() if o is not None) == sorted(
        k for k, r in ref.items() if r is not None)
    assert len([o for o in out.values() if o is not None]) == n_streams
    for k, r in ref.items():
        if r is not None:
            _assert_rel_close(out[k].numpy(), r, 1e-5, k)
    got = state_dict_to_tree(tm.state_dict(), upd["batch_stats"])
    _assert_trees_rel_close(got, upd["batch_stats"], 1e-5, "batch_stats")


# ---------------------------------------------------------------------------
# the step: the port's options against its own default step
# ---------------------------------------------------------------------------

def _micro(C, train_type="cs2dsec_image+events_together", **uda):
    """The micro config at 64x64, rates 0, warmup 2 of 10 iterations; the
    port with remat on (the JAX step runs it off: the same values)."""
    cfg = C.micro_test_config()
    m = C.replace(cfg.model, train_type=train_type, drop_path_rate=0.0,
                  remat=C is TC,
                  head=C.replace(cfg.model.head, dropout_ratio=0.0))
    return C.replace(cfg, model=m, uda=C.replace(cfg.uda, **uda),
                     data=C.replace(cfg.data, crop_size=HW),
                     optim=C.replace(cfg.optim, warmup_iters=2,
                                     max_iters=10))


def _port_step(cfg, coin, state_from=None, batch_ids=(3, 4), snap=None):
    """One port step of ``cfg`` on the CPU from the state of
    ``state_from`` (a trainer state to copy; default the seed's), with the
    coin forced: (state, logs, the trainer). ``snap``: a dict that gets
    the gradients and BN buffers at the end of the source pass."""
    import copy
    tr = DACSTrainer(cfg, device="cpu")
    st = copy.deepcopy(state_from) if state_from is not None \
        else tr.init_state(seed=0)
    for m in (st.model, st.ema_model):
        for mod in m.modules():
            if isinstance(mod, DropPath):
                mod.rate = 0.0
    ev = cfg.model.train_type.startswith("cs2dsec")
    batch = uda_batch(SyntheticSource(crop_size=HW, with_time_res=ev),
                      SyntheticTarget(crop_size=HW, with_events=ev),
                      list(batch_ids))
    draws = tr.new_draws(st, 2, HW)
    draws.coin = torch.tensor(coin)
    if snap is not None:
        def mark(name):   # the step's section marks
            if name == "src_bwd":
                snap["grads"] = {k: p.grad.clone() for k, p
                                 in st.model.named_parameters()
                                 if p.grad is not None}
                snap["buffers"] = {k: b.clone() for k, b
                                   in st.model.named_buffers()}
        tr._mark = mark
    st, logs = tr.train_step(st, batch, draws)
    return st, {k: float(v) for k, v in logs.items()}, tr


@pytest.mark.parametrize("option,coin,like", [
    ("without_events", 0.9, 0.1), ("without_isd", 0.1, 0.9)])
@pytest.mark.parametrize("train_type", ["cs2dsec_image+events_together",
                                        "cs2dsec_image+events"])
def test_coin_overrides_equal_the_forced_coin(option, coin, like,
                                              train_type):
    """``without_events`` (``without_isd``) on an events (ISR) coin gives
    the port's default step on the other coin: the same logs, parameters
    and BN statistics."""
    st, logs, _ = _port_step(_micro(TC, train_type, **{option: True}), coin)
    ref_st, ref_logs, _ = _port_step(_micro(TC, train_type), like)
    assert logs == ref_logs
    assert logs["use_events"] == float(option == "without_isd")
    for (k, a), b in zip(st.model.state_dict().items(),
                         ref_st.model.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("train_type", ["cs2dsec_image+events_together",
                                        "cs2dsec_image+events"])
def test_source_only_is_the_source_half(train_type):
    """``source_only``: the logs of the default step's source pass, and its
    gradients and BN statistics at the end of that pass; no mixed pass."""
    snap = {}
    _, ref_logs, _ = _port_step(_micro(TC, train_type), 0.9, snap=snap)
    st, logs, _ = _port_step(_micro(TC, train_type, source_only=True), 0.9)
    src = {k: v for k, v in ref_logs.items() if k.startswith("src/")}
    assert logs == {**src, "loss": src["src/loss_seg"],
                    "pseudo_weight": ref_logs["pseudo_weight"],
                    "use_events": 1.0}
    grads = {k: p.grad for k, p in st.model.named_parameters()}
    for k, g in snap["grads"].items():
        assert torch.equal(grads[k], g), k
    for k, b in st.model.named_buffers():
        assert torch.equal(b, snap["buffers"][k]), k


@pytest.mark.parametrize("uda", [
    dict(isr_another_fusion=True), dict(fuse_both_ice_and_e=True),
    dict(source_only=True), dict(without_events=True),
    dict(stacked_stream_ce=True, shift_type="all")],
    ids=["isr_another_fusion", "fuse_both", "source_only", "without_events",
         "stacked_all"])
def test_debug_tensors_under_options(uda):
    """``debug_tensors`` with the step's draws: the step's own coin and
    pseudo weight, and the state left as it was."""
    import copy
    cfg = _micro(TC, **uda)
    tr = DACSTrainer(cfg, device="cpu")
    st = tr.init_state(seed=0)
    batch = uda_batch(SyntheticSource(crop_size=HW),
                      SyntheticTarget(crop_size=HW), [5, 6])
    draws = tr.new_draws(st, 2, HW)
    before = copy.deepcopy(st.ema_model.state_dict())
    dbg = tr.debug_tensors(st, batch, draws)
    for k, v in st.ema_model.state_dict().items():
        assert torch.equal(v, before[k]), k
    _, logs = tr.train_step(st, batch, draws)
    assert float(dbg["use_events"]) == float(logs["use_events"])
    assert float(dbg["pseudo_weight"].mean()) == pytest.approx(
        float(logs["pseudo_weight"]), rel=1e-6)
    assert dbg["mixed_isr"].shape == (2,) + HW + (3,)


def test_cli_fused_resize_and_set_option(tmp_path, capsys, monkeypatch):
    """``tools.train.main --fused-resize --set uda.isr_another_fusion=true``
    trains (2 iterations of the tiny config on the CPU), with the phase
    upsample on for the process."""
    import json
    monkeypatch.setattr(tresize, "_FUSED_INT_UPSAMPLE", False)
    calls = []
    real = tresize.phase_upsample_bilinear
    monkeypatch.setattr(tresize, "phase_upsample_bilinear",
                        lambda *a: calls.append(1) or real(*a))
    loop = tcli.main(["--config", "tiny", "--synthetic", "--device", "cpu",
                      "--num-workers", "2", "--max-iters", "2",
                      "--fused-resize", "--set", "uda.isr_another_fusion=true",
                      "--work-dir", str(tmp_path)])
    done = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert done["done"] and done["step"] == 2
    assert loop.cfg.uda.isr_another_fusion and tresize._FUSED_INT_UPSAMPLE
    assert calls, "no upsample took the phase form"
    with open(loop.log_path) as f:
        steps = [r for r in map(json.loads, f) if "loss" in r]
    assert steps and all(np.isfinite(r["loss"]) for r in steps)


# ---------------------------------------------------------------------------
# the steps against the jitted JAX step (two compiles, last in the file)
# ---------------------------------------------------------------------------

def _jax_and_port_step(jcfg, tcfg, bases, batch_ids=(3, 4)):
    """One step of both packages from one seeded state on the same batch,
    for each base key of ``bases``: {key: (JAX logs, port logs, JAX state,
    port state, (JAX teacher logits, JAX pseudo-labels, port
    pseudo-labels))}. One jitted JAX compile."""
    b = jcfg.data.batch_size
    mp = pytest.MonkeyPatch()
    for kind in ("attention_avg", "attention"):
        mp.setitem(jfus.FUSION_REGISTRY, kind, functools.partial(
            jfus.FUSION_REGISTRY[kind], drop_path_rate=0.0))
    jpl_rec, tpl_rec = _record_pseudo_labels(mp)

    def jstep_recorded(state, batch, rng):
        jpl_rec.clear()
        return jtr.train_step(state, batch, rng), list(jpl_rec)
    try:
        jtr = JTrainer(jcfg)
        jstate0 = _jax_init_state(jtr, jcfg)
        jstep = jax.jit(jstep_recorded)
        ev = jcfg.model.train_type.startswith("cs2dsec")
        batch = uda_batch(SyntheticSource(crop_size=HW, with_time_res=ev),
                          SyntheticTarget(crop_size=HW, with_events=ev),
                          list(batch_ids))
        layout = {"params": jstate0.params,
                  "batch_stats": jstate0.batch_stats}
        out = {}
        for name, base in bases.items():
            (jstate, jlogs), [(jlogits, jlabel)] = jstep(
                jstate0, jax.tree.map(jnp.asarray, batch), base)
            ttr = DACSTrainer(tcfg, device="cpu")
            tstate = ttr.init_state()
            for m in (tstate.model, tstate.ema_model):
                for mod in m.modules():
                    if isinstance(mod, DropPath):
                        mod.rate = 0.0
            load_jax_train_state(tstate, _jax_state_numpy(jstate0))
            fwd = tstate.model.new_draws(
                b, generator=torch.Generator().manual_seed(0),
                device=torch.device("cpu"), with_isr=ttr.together,
                fusion_isr=True)   # rates 0: any draws do
            tpl_rec.clear()
            tstate, tlogs = ttr.train_step(tstate, batch,
                                           _draws(base, 0, b, jcfg, fwd))
            out[name] = ({k: float(v) for k, v in jlogs.items()},
                         {k: float(v) for k, v in tlogs.items()},
                         _jax_state_numpy(jstate),
                         train_state_to_numpy(tstate, layout),
                         (np.asarray(jlogits), np.asarray(jlabel),
                          tpl_rec[0].numpy()))
    finally:
        mp.undo()
    return out


def _assert_step_matches(got, cfg):
    jlogs, tlogs, ref, state, (jlogits, jlabel, tlabel) = got
    _assert_logs_close(jlogs, tlogs)
    _assert_state_close(state, ref, cfg, 1)
    assert_labels_match(tlabel, jlabel, jlogits, 1e-4 * np.abs(jlogits).max())


@pytest.fixture(scope="module")
def levers_step():
    """A: events_together with both fusion modules, the stacked CE, the
    batched-train head and the four-direction mixed ISR."""
    opts = dict(fuse_both_ice_and_e=True, stacked_stream_ce=True,
                shift_type="all")
    jcfg, tcfg = (_micro(C, **opts) for C in (JC, TC))
    jcfg, tcfg = (C.replace(c, model=C.replace(c.model,
                                               head_batched_train=True))
                  for C, c in ((JC, jcfg), (TC, tcfg)))
    return _jax_and_port_step(jcfg, tcfg, {"a": jax.random.PRNGKey(11)}), jcfg


def test_levers_step_matches_jax(levers_step):
    out, cfg = levers_step
    jlogs = out["a"][0]
    assert "src/loss_isr" in jlogs and "mix/loss_fusion" in jlogs
    _assert_step_matches(out["a"], cfg)


@pytest.fixture(scope="module")
def isr_fusion_steps():
    """B: cs2dsec_image+events with the ISR fusion module on ISR coins and
    no fusion loss there, one step under each coin outcome (the base keys
    picked by their coin, as test_torch_train_variants.py picks them)."""
    opts = dict(isr_another_fusion=True, isr_no_fusion=True)
    jcfg, tcfg = (_micro(C, "cs2dsec_image+events", **opts)
                  for C in (JC, TC))
    thres = jcfg.uda.random_choice_thres
    bases = {}
    for i in range(64):
        key = jax.random.PRNGKey(200 + i)
        bases.setdefault(_coin(key) > thres, key)
        if len(bases) == 2:
            break
    return _jax_and_port_step(jcfg, tcfg, bases), jcfg


@pytest.mark.parametrize("use_events", [False, True],
                         ids=["isr_coin", "events_coin"])
def test_isr_fusion_step_matches_jax(isr_fusion_steps, use_events):
    out, cfg = isr_fusion_steps
    got = out[use_events]
    assert got[0]["use_events"] == got[1]["use_events"] == float(use_events)
    _assert_step_matches(got, cfg)


def test_isr_no_fusion_gates_the_fusion_loss(isr_fusion_steps):
    """On an ISR coin the loss leaves out the fusion CE, which is still
    computed and logged; on an events coin it counts."""
    out, cfg = isr_fusion_steps
    w = cfg.uda
    for use_events, (_, logs, *_) in out.items():
        for p in ("src", "mix"):
            want = (logs[f"{p}/loss_image"] * w.loss_weight_image
                    + logs[f"{p}/loss_events"] * w.loss_weight_events
                    + use_events * logs[f"{p}/loss_fusion"]
                    * w.loss_weight_fusion)
            assert logs[f"{p}/loss_seg"] == pytest.approx(want, rel=1e-6)
