"""The port's image-only trainers and their helpers against the JAX package,
on the CPU, from seeded numpy weights and inputs:

* ``cow_masks``' mask bitwise on the JAX function's own draws;
  ``rho_edges`` and ``diff_edges`` bitwise on gray-level images (integers,
  so every sum is exact) and to 1e-6 on real-valued ones;
* the prototype functions (``class_mean_features``, ``update_prototypes``
  through both of its phases, ``ContrastQueues.create``, ``enqueue``,
  ``_ring_write``, ``pixel_contrast_loss``) on the JAX functions' own
  random scores: the queues and bank to 1e-6, the pointers equal, the loss
  to 1e-5 relative and its gradient in the features to 1e-4 of the
  largest.

Last, one jitted JAX step compile each: three ``DACSImage`` steps with
``isrd2isrn`` (a one-block ngf-8 1-channel generator), then three OrgDACS
steps of the micro config at 64x64 with the ImageNet feature distance, the
pseudo weight's rows cropped (top 2, bottom 15), a one-block ngf-8
3-channel day -> night generator, at non-zero drop-path (the MiT ramp to
0.6) and Dropout2d (0.5) rates: the uniforms the JAX forwards draw are
recorded and handed to ``EncoderDecoder.forward_with_features`` (as in
``test_torch_train.py::test_forward_train_same_draws_as_jax``), the other
draws derived from OrgDACS's own ``split(fold_in(rng, step), 7)``. The
logs of each step rtol 1e-4; the states as ``_assert_steps_close`` says
(test_torch_train.py's rule where the parameters are still equal, the
parameter rule after step 3).
"""
import copy
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cmda_tpu import config as JC
from cmda_tpu.models import cyclegan as jcyc
from cmda_tpu.ops import augment as jaug
from cmda_tpu.train import optim as joptim
from cmda_tpu.uda import prototype as jproto
from cmda_tpu.uda.dacs import DACSTrainState
from cmda_tpu.uda.dacs_image import DACSImageTrainer as JDACSImage
from cmda_tpu.uda.org_dacs import OrgDACSTrainer as JOrgDACS
from cmda_tpu.utils import misc as jmisc
from cmda_tpu_torch import config as TC
from cmda_tpu_torch.models.common import DropPath
from cmda_tpu_torch.models.segmentor import ForwardDraws
from cmda_tpu_torch.ops import augment as taug
from cmda_tpu_torch.uda import prototype as tproto
from cmda_tpu_torch.uda.dacs_image import DACSImageTrainer
from cmda_tpu_torch.uda.org_dacs import OrgDACSDraws, OrgDACSTrainer
from cmda_tpu_torch.utils import misc as tmisc
from cmda_tpu_torch.utils.weights import (cyclegan_to_state_dict,
                                          load_jax_train_state,
                                          train_state_to_numpy,
                                          tree_to_state_dict)
from test_torch_train import (_assert_tree_close, _jax_state_numpy,
                              _record_draws)
from test_torch_train_variants import _assert_logs_close
from test_torch_uda_options import _assert_rel_close
from torch_port_util import random_variables

HW = (64, 64)
DP_MIT, DROPOUT = 0.6, 0.5
THINGS = (6, 7, 11, 12, 13, 14, 15, 16, 17, 18)


def _t(a):
    return torch.from_numpy(np.array(a))


def _model_cfg(C, rates):
    cfg = C.micro_test_config().model
    return C.replace(cfg, drop_path_rate=DP_MIT if rates else 0.0,
                     remat=C is TC,
                     head=C.replace(cfg.head, dropout_ratio=DROPOUT
                                    if rates else 0.0))


def _forward_draws(drawn, b):
    """The port's ForwardDraws of one recorded EncoderDecoder training
    forward: 4 MiT stages [1, 2, B], then the Dropout2d uniforms
    [B, 1, 1, C]."""
    assert [u.shape[:2] for u in drawn[:4]] == [(1, 2)] * 4
    assert drawn[4].shape[:3] == (b, 1, 1)
    return ForwardDraws(image=[_t(u) for u in drawn[:4]],
                        dropout_keep=_t(drawn[4][None, :, 0, 0]
                                        < np.float32(1 - DROPOUT)))


# ---------------------------------------------------------------------------
# cow masks and the edge operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_cow_masks_bitwise(seed):
    b, h, w = 2, 112, 128
    rng = jax.random.PRNGKey(seed)
    with jax.disable_jit():
        ref = np.asarray(jaug.cow_masks(rng, b, h, w))
    kp, ks, kn = jax.random.split(rng, 3)
    p = jax.random.uniform(kp, (b,), minval=0.25, maxval=1.0)
    sigmas = jnp.exp(jax.random.uniform(ks, (b,), minval=math.log(4),
                                        maxval=math.log(16)))
    noise = jax.random.normal(kn, (b, h, w, 1))
    got = taug.cow_masks(_t(p), _t(sigmas), _t(noise))
    assert got.dtype == torch.bool and got.shape == (b, h, w)
    assert np.array_equal(got.numpy(), ref)
    assert 0 < ref.mean() < 1


@pytest.mark.parametrize("integer", [True, False], ids=["gray", "real"])
def test_rho_and_diff_edges_match_jax(integer):
    g = np.random.default_rng(5)
    x = (g.integers(0, 256, (2, 17, 23, 1)).astype(np.float32) if integer
         else g.normal(size=(2, 17, 23, 1)).astype(np.float32))
    for jf, tf, n in ((jmisc.rho_edges, tmisc.rho_edges, 4),
                      (jmisc.diff_edges, tmisc.diff_edges, 1)):
        ref = np.asarray(jf(jnp.asarray(x)))
        got = tf(_t(x)).numpy()
        assert got.shape == ref.shape == (2, 17, 23, n)
        if integer:
            assert np.array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the prototype functions
# ---------------------------------------------------------------------------

K, D = 5, 8


def _proto_inputs(seed=9, b=2, h=16, w=16):
    g = np.random.default_rng(seed)
    feats = g.normal(size=(b, h, w, D)).astype(np.float32)
    logits = g.normal(size=(b, h, w, K)).astype(np.float32)
    labels = g.integers(0, K, (b, 2 * h, 2 * w)).astype(np.int32)
    labels[:, :4] = 255
    return feats, logits, labels


@pytest.mark.parametrize("with_labels", [False, True])
def test_class_means_and_prototypes_match_jax(with_labels):
    feats, logits, labels = _proto_inputs()
    lbl = labels[:, ::2, ::2] if with_labels else None
    # about 51 pixels a class predicted, 10 also labelled so
    kw = dict(num_classes=K, min_pixels=10 if with_labels else 52)
    jm, jv = jproto.class_mean_features(
        jnp.asarray(feats), jnp.asarray(logits),
        None if lbl is None else jnp.asarray(lbl), **kw)
    tm, tv = tproto.class_mean_features(
        _t(feats), _t(logits), None if lbl is None else _t(lbl), **kw)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6,
                               rtol=1e-6)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.asarray(jv).any() and not np.asarray(jv).all()
    # three updates with the plain average until 2, then the EMA
    jb = jproto.PrototypeBank.create(K, D)
    tb = tproto.PrototypeBank.create(K, D)
    for _ in range(3):
        jb = jproto.update_prototypes(jb, jm, jv, momentum=0.9,
                                      start_mean_until=2)
        tb = tproto.update_prototypes(tb, tm, tv, momentum=0.9,
                                      start_mean_until=2)
        np.testing.assert_allclose(tb.protos.numpy(), np.asarray(jb.protos),
                                   atol=1e-6, rtol=1e-6)
        assert np.array_equal(tb.counts.numpy(), np.asarray(jb.counts))


def test_contrast_queues_and_enqueue_match_jax():
    feats, _, labels = _proto_inputs(seed=10)
    b, h, w, _ = feats.shape
    m = 12
    rng = jax.random.PRNGKey(2)
    jq = jproto.ContrastQueues.create(rng, K, m, D)
    k1, k2 = jax.random.split(rng)
    noise = (_t(jax.random.normal(k1, (K, m, D))),
             _t(jax.random.normal(k2, (K, m, D))))
    tq = tproto.ContrastQueues.create(noise)
    for step in range(2):
        key = jax.random.PRNGKey(20 + step)
        with jax.disable_jit():
            jq = jproto.enqueue(jq, jnp.asarray(feats), jnp.asarray(labels),
                                key, pixel_update_freq=3)
        scores = torch.stack([_t(jax.random.uniform(
            jax.random.fold_in(key, i), (h * w,))) for i in range(b)])
        tq = tproto.enqueue(tq, _t(feats), _t(labels), scores,
                            pixel_update_freq=3)
        for name in ("segment_queue", "pixel_queue"):
            np.testing.assert_allclose(getattr(tq, name).numpy(),
                                       np.asarray(getattr(jq, name)),
                                       atol=1e-6, rtol=1e-6, err_msg=name)
        for name in ("segment_ptr", "pixel_ptr"):
            assert np.array_equal(getattr(tq, name).numpy(),
                                  np.asarray(getattr(jq, name))), name
    assert (np.asarray(jq.pixel_ptr) == (2 * 2 * 3) % m).any()


def test_pixel_contrast_loss_matches_jax():
    feats, logits, labels = _proto_inputs(seed=11)
    b, h, w, _ = feats.shape
    predict = logits.argmax(-1)
    queue = np.asarray(jproto.ContrastQueues.create(
        jax.random.PRNGKey(5), K, 12, D).pixel_queue)
    rng = jax.random.PRNGKey(6)
    kw = dict(n_view=8, num_classes=K)

    def jloss(f):
        return jproto.pixel_contrast_loss(
            rng, f, jnp.asarray(labels), jnp.asarray(predict),
            jnp.asarray(queue), **kw)
    with jax.disable_jit():
        ref, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(feats))
    keys = jax.random.split(rng, b * K).reshape(b, K, 2)
    scores = torch.stack([torch.stack([_t(jax.random.uniform(
        keys[bi, c], (h * w,))) for c in range(K)]) for bi in range(b)])
    f = _t(feats).requires_grad_(True)
    got = tproto.pixel_contrast_loss(scores, f, _t(labels), _t(predict),
                                     _t(queue), **kw)
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    got.backward()
    _assert_rel_close(f.grad.numpy(), ref_grad, 1e-4, "d loss / d feats")
    assert float(ref) > 0 and np.abs(np.asarray(ref_grad)).max() > 0


def test_image_trainers_refuse_other_models():
    """OrgDACS takes a model= with the segmentor interface (a
    GenericEncoderDecoder since the model zoo slice) and refuses other
    modules; DACSImage runs the config's MiT EncoderDecoder only, as the
    JAX DACSImageTrainer builds it."""
    cfg = _cfg(TC)
    with pytest.raises(TypeError, match="forward_with_features"):
        OrgDACSTrainer(cfg, "cpu", model=torch.nn.Identity())
    with pytest.raises(ValueError, match="MiT EncoderDecoder"):
        DACSImageTrainer(TC.replace(cfg, model=TC.replace(
            cfg.model, backbone="resnet50")), "cpu")
    with pytest.raises(ValueError, match="transfer_direction"):
        DACSImageTrainer(cfg, "cpu", transfer_direction="d2n")


# ---------------------------------------------------------------------------
# the steps against the jitted JAX ones
# ---------------------------------------------------------------------------

def _cfg(C, rates=False, **uda):
    cfg = C.micro_test_config()
    return C.replace(cfg, model=_model_cfg(C, rates),
                     uda=C.replace(cfg.uda, **uda),
                     data=C.replace(cfg.data, crop_size=HW),
                     optim=C.replace(cfg.optim, warmup_iters=2, max_iters=10))


def _jax_state(jtr, cfg, cyclegan=None, imnet=None, seed=51):
    """A JAX DACSTrainState of the EncoderDecoder from seeded numpy, the
    teacher a copy, the AdamW moments 0 (no init compile)."""
    img = jnp.zeros((cfg.data.batch_size, *HW, 3))
    v = random_variables(lambda: jtr.model.init(jax.random.PRNGKey(0), img),
                         seed=seed)
    jtr.tx = joptim.make_optimizer(v["params"], cfg.optim)
    if cyclegan is not None:
        jtr.cyclegan = jcyc.generator_from_params(cyclegan)
    opt = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                       jax.eval_shape(jtr.tx.init, v["params"]))
    return DACSTrainState(
        step=np.zeros((), np.int32), params=v["params"],
        batch_stats=v["batch_stats"],
        ema_params=jax.tree.map(np.copy, v["params"]), opt_state=opt,
        cyclegan_params=cyclegan, imnet_params=imnet)


def _tiny_generator(nc, seed):
    jm = jcyc.ResnetGenerator(output_nc=nc, ngf=8, n_blocks=1)
    return random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *HW, nc))), seed)["params"]


def _zero_droppath(*models):
    for m in models:
        for mod in m.modules():
            if isinstance(mod, DropPath):
                mod.rate = 0.0


def _batches(n, b, seed, with_target=True):
    g = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        # 32x32 squares of one class, so the feature distance has pure cells
        blocks = g.choice(THINGS + (0, 2, 8, 10, 255),
                          (b, HW[0] // 32, HW[1] // 32))
        label = np.repeat(np.repeat(blocks, 32, 1), 32, 2).astype(np.int32)
        src = {"image": g.normal(size=(b, *HW, 3)).astype(np.float32),
               "img_self_res": g.uniform(-1, 1, (b, *HW, 3)).astype(
                   np.float32), "label": label}
        batch = {"source": src}
        if with_target:
            batch["target"] = {"image": g.normal(size=(b, *HW, 3)).astype(
                np.float32)}
        out.append(batch)
    return out


def _float64_state(tstate):
    """A float64 copy of a port train state (the student, its teacher,
    the generator and the frozen ImageNet encoder; AdamW follows its
    parameters), each model computing in float64."""
    s64 = copy.deepcopy(tstate)
    for m in (s64.model, s64.ema_model, s64.cyclegan, s64.imnet):
        if m is not None:
            m.double()
            if hasattr(m, "dtype"):
                m.dtype = torch.float64
    for st in s64.optimizer.state.values():
        for k, v in st.items():
            if k != "step" and v.is_floating_point():
                st[k] = v.double()
    return s64


def _float64_steps(trainer, s64, batches, draws, layout):
    """The port's steps on ``s64`` in float64 (its float32 casts, the norm
    statistics, the losses and resizes, kept in float64) -> the state after
    the last step in the JAX layout."""
    def double(tree):
        return {k: double(v) if isinstance(v, dict) else
                v.astype(np.float64) if v.dtype == np.float32 else v
                for k, v in tree.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "float", lambda self: self.double())
        for batch, d in zip(batches, draws, strict=True):
            s64, _ = trainer.train_step(s64, double(batch), d)
    return train_state_to_numpy(s64, layout)


# AdamW's moments after step 3 against a float64 run of the port (ROADMAP
# C3; as test_torch_zoo.py's OrgDACS-on-ResNet test holds the moments):
# each leaf to MOMENT_LEAF_RTOL of its own largest in the float64 run and
# to MOMENT_GROUP_RTOL of its group's largest. A missing or reversed
# gradient is 1 or 2 of its leaf's largest away.
MOMENT_LEAF_RTOL = 1e-1
MOMENT_GROUP_RTOL = 1e-2


def _moment_misses(got, ref, flip=False):
    """The (part, moment, leaf, diff) of ``got``'s AdamW moments outside
    the tolerances from ``ref``'s (states in the JAX layout); ``flip``
    negates ``got``'s first moments (a reversed gradient)."""
    misses = []
    for part in ("head", "backbone"):
        for m in ("mu", "nu"):
            flat = dict(jax.tree_util.tree_leaves_with_path(
                got["opt"][part][m]))
            leaves = jax.tree_util.tree_leaves_with_path(ref["opt"][part][m])
            top = max(float(np.abs(np.asarray(r)).max()) for _, r in leaves)
            for k, r in leaves:
                r = np.asarray(r, np.float64)
                g = np.asarray(flat[k], np.float64)
                if flip and m == "mu":
                    g = -g
                diff = float(np.abs(g - r).max())
                if (diff > MOMENT_LEAF_RTOL * float(np.abs(r).max())
                        or diff > MOMENT_GROUP_RTOL * top):
                    misses.append((part, m, jax.tree_util.keystr(k), diff))
    return misses


def _assert_moments_match_float64(states, f64):
    """Both packages' float32 moments after step 3 against the float64
    run's; the port's with its first moments negated must miss."""
    ref_jax, got = states[3]
    assert f64["step"] == 3
    assert not _moment_misses(got, f64)
    assert not _moment_misses(ref_jax, f64)
    assert len(_moment_misses(got, f64, flip=True)) > 10


@pytest.fixture(scope="module")
def dacs_image_steps():
    """Three DACSImage steps with isrd2isrn of both packages from one state
    (rates 0: the forward draws nothing that matters)."""
    jcfg, tcfg = _cfg(JC), _cfg(TC)
    cyc = _tiny_generator(1, seed=61)
    jtr = JDACSImage(jcfg, transfer_direction="isrd2isrn")
    jstate = _jax_state(jtr, jcfg, cyclegan=cyc)
    ttr = DACSImageTrainer(tcfg, "cpu", transfer_direction="isrd2isrn")
    tstate = ttr.init_state(cyclegan_state_dict=cyclegan_to_state_dict(cyc))
    _zero_droppath(tstate.model)
    load_jax_train_state(tstate, _jax_state_numpy(jstate))
    s64 = _float64_state(tstate)
    jstep = jax.jit(jtr.train_step)
    base = jax.random.PRNGKey(62)
    layout = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    logs, states, all_draws = [], {}, []
    batches = _batches(3, 2, 63, with_target=False)
    for step, batch in enumerate(batches):
        jstate, jl = jstep(jstate, jax.tree.map(jnp.asarray, batch), base)
        draws = tstate.model.new_draws(
            2, generator=torch.Generator().manual_seed(step),
            device=torch.device("cpu"))
        all_draws.append(draws)
        tstate, tl = ttr.train_step(tstate, batch, draws)
        logs.append(({k: float(v) for k, v in jl.items()},
                     {k: float(v) for k, v in tl.items()}))
        states[step + 1] = (_jax_state_numpy(jstate),
                            train_state_to_numpy(tstate, layout))
    f64 = _float64_steps(ttr, s64, batches, all_draws, layout)
    return logs, states, jcfg, f64


def _assert_steps_close(states, cfg):
    """The states after steps 1, 2 and 3 ({n: (JAX, port)} in the JAX
    layout). The warmup's first lr is 6e-11, so the parameters after step 1
    are equal in both packages and what step 2 computes from them is held
    as tightly as step 1: the BN running statistics after steps 1 and 2 to
    1e-5, the EMA after step 1 to 1e-5, the AdamW moments after steps 1
    and 2 to 1e-4 of their group's largest. From step 2 on Adam moves each
    parameter by about +-lr, and a gradient near 0 may take either sign in
    either package: after step 3 the parameters and the EMA (a convex mix
    of them) are held to 2 lr head_lr_mult per step taken, the BN
    statistics to 1e-4 (measured: 3.3e-5 at one element of the dilation-18
    ASPP branch's BN mean, which such a flip in the head moves)."""
    for n in (1, 2, 3):
        ref, got = states[n]
        assert got["step"] == ref["step"] == n
        for part in ("head", "backbone"):
            assert got["opt"][part]["count"] == ref["opt"][part]["count"]
            if n == 3:
                continue
            for m in ("mu", "nu"):
                flat = dict(jax.tree_util.tree_leaves_with_path(
                    got["opt"][part][m]))
                leaves = jax.tree_util.tree_leaves_with_path(
                    ref["opt"][part][m])
                scale = max(float(np.abs(np.asarray(r)).max())
                            for _, r in leaves)
                for k, r in leaves:
                    diff = float(np.abs(np.asarray(flat[k])
                                        - np.asarray(r)).max())
                    assert diff <= 1e-4 * scale, (
                        n, part, m, jax.tree_util.keystr(k), diff, scale)
        bn = 1e-5 if n < 3 else 1e-4
        _assert_tree_close(got["batch_stats"], ref["batch_stats"],
                           f"batch_stats {n}", atol=bn, rtol=bn)
        lr_tol = 2 * cfg.optim.lr * cfg.optim.head_lr_mult * n
        _assert_tree_close(got["ema_params"], ref["ema_params"], f"ema {n}",
                           **(dict(atol=1e-5, rtol=1e-5) if n == 1
                              else dict(atol=lr_tol, rtol=0)))
        _assert_tree_close(got["params"], ref["params"], f"params {n}",
                           atol=lr_tol, rtol=0)


def test_dacs_image_steps_match_jax(dacs_image_steps):
    """The logs of the three steps and the states by
    ``_assert_steps_close``. Against a float64 run of the port on the CPU,
    the float32 runs' moments after step 3 move by 1.4e-4 (JAX) and 2.0e-2
    (the port) of a leaf's largest, from such sign flips at step 2 in
    other leaves in each; after step 1 by 1.8e-5 and 8.1e-6."""
    logs, states, cfg = dacs_image_steps[:3]
    for jl, tl in logs:
        assert set(jl) == {"loss", "src/loss_seg", "src/acc_seg"}
        _assert_logs_close(jl, tl)
    # no EMA in DACSImage: the teacher stays the initial student in both
    _assert_steps_close(states, cfg)


def test_dacs_image_moments_match_float64(dacs_image_steps):
    """AdamW's moments after step 3, JAX's and the port's, against a
    float64 run of the port from the same state, batches and draws: each
    leaf to 1e-1 of its largest, 1e-2 of its group's; reversed first
    moments miss."""
    _, states, _, f64 = dacs_image_steps
    _assert_moments_match_float64(states, f64)


def _org_draws(base, step, batch, cfg, fwd):
    """OrgDACS's draws (org_dacs.py:97): k_mix, k_jg, k_jit, k_bg, k_sig,
    k_drop, k_dp = split(fold_in(rng, step), 7); ``fwd`` the recorded
    forward draws."""
    rng = jax.random.fold_in(base, step)
    k_mix, k_jg, k_jit, k_bg, k_sig, _k_drop, _k_dp = jax.random.split(rng, 7)
    s = cfg.uda.color_jitter_strength
    kb, kc, ks, kh = jax.random.split(k_jit, 4)
    u = jax.random.uniform
    return OrgDACSDraws(
        mix_scores=_t(u(k_mix, (batch, cfg.data.num_classes + 1))),
        jitter_gate=_t(u(k_jg)),
        jitter=(_t(u(kb, (batch, 1, 1, 1), minval=1 - s, maxval=1 + s)),
                _t(u(kc, (batch, 1, 1, 1), minval=1 - s, maxval=1 + s)),
                _t(u(ks, (batch, 1, 1, 1), minval=1 - s, maxval=1 + s)),
                _t(u(kh, (batch, 1, 1), minval=-s, maxval=s))),
        blur_gate=_t(u(k_bg)), sigma=_t(u(k_sig, minval=0.15, maxval=1.15)),
        fwd=fwd)


@pytest.fixture(scope="module")
def org_dacs_steps():
    """Three OrgDACS steps of both packages from one state: the feature
    distance (lambda 0.5, the thing classes), rows 2 / 15 of the pseudo
    weight zeroed, pseudo threshold 0 (every pixel counts), the one-block
    3-channel day -> night generator, drop-path and dropout on. One jitted
    JAX compile; the uniforms its two forwards draw are recorded."""
    uda = dict(imnet_feature_dist_lambda=0.5, pseudo_threshold=0.0,
               pseudo_weight_ignore_top=2, pseudo_weight_ignore_bottom=15)
    jcfg, tcfg = _cfg(JC, True, **uda), _cfg(TC, True, **uda)
    b = jcfg.data.batch_size
    cyc = _tiny_generator(3, seed=71)
    mp = pytest.MonkeyPatch()
    rec = _record_draws(mp)
    try:
        jtr = JOrgDACS(jcfg, use_cyclegan_day2night=True)
        iv = random_variables(lambda: jtr.imnet.init(
            jax.random.PRNGKey(1), jnp.zeros((b, *HW, 3))), seed=72)
        jstate = _jax_state(jtr, jcfg, cyclegan=cyc,
                            imnet=iv["params"])
        ttr = OrgDACSTrainer(tcfg, "cpu", use_cyclegan_day2night=True)
        zeros = {k: torch.zeros(v.shape) for k, v in tree_to_state_dict(
            iv["params"]["backbone"]).items()}
        tstate = ttr.init_state(cyclegan_state_dict=cyclegan_to_state_dict(
            cyc), imnet_state_dict=zeros)
        js = _jax_state_numpy(jstate)
        js["imnet_params"] = jax.tree.map(np.asarray, iv["params"])
        load_jax_train_state(tstate, js)

        def jstep_recorded(state, batch, rng):
            rec.clear()
            return jtr.train_step(state, batch, rng), list(rec)
        s64 = _float64_state(tstate)
        jstep = jax.jit(jstep_recorded)
        base = jax.random.PRNGKey(73)
        layout = {"params": jstate.params, "batch_stats": jstate.batch_stats}
        logs, fwd_draws, states, all_draws = [], [], {}, []
        batches = _batches(3, b, 74)
        for step, batch in enumerate(batches):
            if step == 0:
                student0 = {k: v.detach().clone() for k, v in
                            tstate.model.named_parameters()}
            (jstate, jl), drawn = jstep(jstate,
                                        jax.tree.map(jnp.asarray, batch),
                                        base)
            drawn = [np.asarray(u) for u in drawn[-10:]]
            fwd_draws.append(drawn)
            draws = _org_draws(base, step, b, jcfg,
                               _forward_draws(drawn[:5], b))
            all_draws.append(draws)
            tstate, tl = ttr.train_step(tstate, batch, draws)
            logs.append(({k: float(v) for k, v in jl.items()},
                         {k: float(v) for k, v in tl.items()}))
            states[step + 1] = (_jax_state_numpy(jstate),
                                train_state_to_numpy(tstate, layout))
            if step == 0:
                teacher0 = {k: v.detach().clone() for k, v in
                            tstate.ema_model.named_parameters()}
        new = tstate.model.new_draws(b, generator=torch.Generator(),
                                     device=torch.device("cpu"))
        new_shapes = ([tuple(u.shape) for u in new.image],
                      tuple(new.dropout_keep.shape))
    finally:
        mp.undo()
    f64 = _float64_steps(ttr, s64, batches, all_draws, layout)
    return (logs, states, jcfg, fwd_draws, student0, teacher0, new_shapes,
            f64)


def test_org_dacs_logs_match_jax(org_dacs_steps):
    logs = org_dacs_steps[0]
    for jl, tl in logs:
        assert set(jl) == {"src/loss_seg", "src/acc_seg", "mix/loss_seg",
                           "mix/acc_seg", "src/loss_imnet_feat_dist", "loss",
                           "pseudo_weight"}
        assert jl["src/loss_imnet_feat_dist"] > 0
        # rows 2 / 15 zeroed under a threshold of 0
        np.testing.assert_allclose(jl["pseudo_weight"],
                                   (HW[0] - 17) / HW[0], rtol=1e-6)
        _assert_logs_close(jl, tl)


def test_org_dacs_state_matches_jax(org_dacs_steps):
    _, states, cfg = org_dacs_steps[:3]
    _assert_steps_close(states, cfg)


def test_org_dacs_moments_match_float64(org_dacs_steps):
    """As ``test_dacs_image_moments_match_float64``, for OrgDACS with its
    feature distance, drop-path and dropout."""
    _, states = org_dacs_steps[:2]
    _assert_moments_match_float64(states, org_dacs_steps[7])


def test_org_dacs_forwards_share_draws_and_drop(org_dacs_steps):
    """Both JAX forwards of a step draw the same uniforms (they get the
    same rngs), which is why ``OrgDACSDraws`` holds one ``ForwardDraws``;
    at these rates they drop."""
    image_shapes, keep_shape = org_dacs_steps[6]
    ramp = np.linspace(0.0, DP_MIT, 4).astype(np.float32)
    for drawn in org_dacs_steps[3]:
        for a, b in zip(drawn[:5], drawn[5:], strict=True):
            np.testing.assert_array_equal(a, b)
        # the port's own draws have the recorded shapes
        assert [u.shape for u in drawn[:4]] == image_shapes
        assert keep_shape == (1, drawn[4].shape[0], drawn[4].shape[-1])
        assert any((u >= 1 - r).any() for u, r in zip(drawn[:4], ramp))
        assert (drawn[4] >= 1 - DROPOUT).any()


def test_org_dacs_teacher_after_step0_is_pre_update_student(org_dacs_steps):
    student0, teacher0 = org_dacs_steps[4:6]
    assert student0.keys() == teacher0.keys()
    for k, v in student0.items():
        assert torch.equal(teacher0[k], v), k
