"""The port's other DACS train types and training options against the JAX
package, on the CPU, from seeded numpy inputs.

* ``cs2dz_image+raw-isr`` (the DarkZurich preset's step: image + raw ISR,
  ``AttentionFusion``, no events, no CycleGAN, the mixed ISR in the fixed
  ``rightdown`` direction with the DarkZurich ISR parameters, the pseudo
  weight's top and bottom rows zeroed): three steps of the micro config at
  64x64 against the jitted JAX step (one compile; rates 0, as
  ``test_torch_train.py``'s steps), the logs, pseudo-labels and states
  after 1 and 3 steps; and its training forward at non-zero drop-path and
  Dropout2d rates, the uniforms the JAX forward draws recorded and handed
  to the port. The preset's ``ignore_top=15`` / ``ignore_bottom=120`` rows of
  512 are cut to 2 / 15 rows of 64, and the pseudo threshold to 0, so the
  weight is 1 outside the zeroed rows and the crop shows in the mixed loss
  (at 0.968 the micro teacher's random weights make the weight 0
  everywhere).
* ``cs2dsec_image+events`` (the student and the teacher take
  where(coin, events, ISR) as one batch): one step from one state under
  each coin outcome, against the JAX step (one compile, two calls).
* ``uda.teacher_bf16``: the teacher's fusion logits against
  ``DACSTrainer._teacher_logits`` of the JAX package (jitted), in float32 (a float32 forward on bfloat16-rounded
  weights, since flax promotes the parameters to the module's dtype) and in
  bfloat16; and different from the float32 teacher's.
* ``optim.moment_dtype='bfloat16'`` and ``optim.grad_clip``: three AdamW
  updates against the optax chain of ``make_optimizer``; the clip against
  ``optax.clip_by_global_norm`` below (bitwise unchanged) and above its
  threshold.

Tolerances are those of ``test_torch_train.py``'s step tests: logs rtol
1e-4; BN running statistics and EMA parameters 1e-5; AdamW moments 1e-4 of
each leaf's largest (of each group's, to 1e-3, after three cs2dz steps:
see ``test_cs2dz_step_state_matches_jax``); parameters atol 2 * lr *
head_lr_mult per step taken.

The cheap tests come first and the two JAX DACS step compiles last, so a
run cut by its time limit keeps the most passes.
"""
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cmda_tpu import config as JC
from cmda_tpu.models import fusion as jfus
from cmda_tpu.models.segmentor import FusionEncoderDecoder as JFED
from cmda_tpu.train import optim as joptim
from cmda_tpu.uda.dacs import DACSTrainer as JTrainer, DACSTrainState
from cmda_tpu.data.synthetic import SyntheticSource, SyntheticTarget
from cmda_tpu_torch import config as TC
from cmda_tpu_torch.data.synthetic import uda_batch
from cmda_tpu_torch.models.common import DropPath
from cmda_tpu_torch.models.segmentor import (FusionEncoderDecoder as TFED,
                                             ForwardDraws)
from cmda_tpu_torch.train import optim as toptim
from cmda_tpu_torch.uda import dacs as tdacs
from cmda_tpu_torch.uda.dacs import DACSTrainer
from cmda_tpu_torch.utils.weights import (load_jax_train_state,
                                          load_jax_variables,
                                          state_dict_to_tree,
                                          train_state_to_numpy)
from test_torch_train import (_Tiny, _assert_moments_close,
                              _assert_tree_close, _draws, _jax_init_state,
                              _jax_state_numpy, _opt_layout, _record_draws)
from test_torch_train_bf16 import _record_pseudo_labels
from torch_port_util import assert_labels_match, random_variables

HW = (64, 64)
# the cs2dz steps' rates: the MiT drop-path ramp to 0.6, the fusion blocks'
# 0.5 (a constructor argument in both packages), Dropout2d 0.5
DP_MIT, DP_FUSION, DROPOUT = 0.6, 0.5, 0.5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _configs(train_type, rates=False):
    """(JAX config, port config): the micro config at 64x64, warmup 2 of
    10 iterations, the port with remat on and the JAX step with it off (the
    same values, a shorter trace); cs2dz with the preset's model and UDA
    settings cut as the module docstring says, cs2dsec_image+events with
    the flagship's, the CycleGAN off (the micro config's; the flagship's
    step test holds it) so the day events are the source's temporal
    difference."""
    def cut(C):
        cfg = C.micro_test_config()
        m = C.replace(cfg.model, train_type=train_type, remat=True)
        uda = cfg.uda
        if train_type.startswith("cs2dz"):
            dz = C.cs2dz_image_rawisr_b5()
            m = C.replace(m, fusion=dz.model.fusion,
                          fusion_isr=dz.model.fusion_isr)
            uda = C.replace(dz.uda, pseudo_threshold=0.0,
                            pseudo_weight_ignore_top=2,
                            pseudo_weight_ignore_bottom=15)
        m = C.replace(m, drop_path_rate=DP_MIT if rates else 0.0,
                      head=C.replace(m.head,
                                     dropout_ratio=DROPOUT if rates else 0.0))
        return C.replace(cfg, model=m, uda=uda,
                         data=C.replace(cfg.data, crop_size=HW),
                         optim=C.replace(cfg.optim, warmup_iters=2,
                                         max_iters=10))
    jcfg = cut(JC)
    return JC.replace(jcfg, model=JC.replace(jcfg.model, remat=False)), cut(TC)


def _port(tcfg, jstate):
    """The port's trainer on the CPU and its state loaded from the JAX
    state, the fusion blocks' drop-path rate 0 as the JAX one is patched
    to be (it is a constructor argument, 0.05, in both packages)."""
    ttr = DACSTrainer(tcfg, device="cpu")
    tstate = ttr.init_state()
    for m in (tstate.model, tstate.ema_model):
        for mod in m.fusion_module.modules():
            if isinstance(mod, DropPath):
                mod.rate = 0.0
    return ttr, load_jax_train_state(tstate, _jax_state_numpy(jstate))


def _assert_logs_close(jlogs, tlogs):
    assert set(tlogs) == set(jlogs)
    for k, ref in jlogs.items():
        np.testing.assert_allclose(tlogs[k], ref, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _assert_state_close(got, ref, cfg, n_steps, moments_of_group=False):
    """BN running statistics and EMA parameters to 1e-5; parameters to
    2 lr head_lr_mult per step; AdamW's moments each leaf to 1e-4 of its own
    largest, or (``moments_of_group``) to 1e-3 of its group's largest."""
    assert got["step"] == ref["step"]
    _assert_tree_close(got["batch_stats"], ref["batch_stats"], "batch_stats",
                       atol=1e-5, rtol=1e-5)
    _assert_tree_close(got["ema_params"], ref["ema_params"], "ema_params",
                       atol=1e-5, rtol=1e-5)
    for part in ("head", "backbone"):
        assert got["opt"][part]["count"] == ref["opt"][part]["count"]
        for m in ("mu", "nu"):
            what = f"{part}/{m}"
            if not moments_of_group:
                _assert_moments_close(got["opt"][part][m],
                                      ref["opt"][part][m], what)
                continue
            flat = dict(jax.tree_util.tree_leaves_with_path(
                got["opt"][part][m]))
            leaves = jax.tree_util.tree_leaves_with_path(ref["opt"][part][m])
            scale = max(float(np.abs(np.asarray(r)).max()) for _, r in leaves)
            for k, r in leaves:
                diff = float(np.abs(np.asarray(flat[k]) - np.asarray(r)).max())
                assert diff <= 1e-3 * scale, (what, jax.tree_util.keystr(k),
                                              diff, scale)
    atol = 2 * cfg.optim.lr * cfg.optim.head_lr_mult * n_steps
    _assert_tree_close(got["params"], ref["params"], "params", atol=atol,
                       rtol=0)


# ---------------------------------------------------------------------------
# bfloat16 moments and grad_clip
# ---------------------------------------------------------------------------

def _bits(x):
    """The bfloat16 bits of a JAX array or a torch tensor, as uint16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


_PATH = {"hc": ("decode_head", "conv", "kernel"),
         "hb": ("decode_head", "bn", "scale"),
         "bn": ("backbone", "norm1", "scale"),
         "bf": ("backbone", "fc", "kernel"),
         "bu": ("backbone", "unused", "kernel")}


@pytest.mark.parametrize("moments,clip", [("bfloat16", None),
                                          ("bfloat16", 0.02),
                                          ("float32", 0.02)])
def test_adamw_options_match_optax_three_steps(moments, clip):
    """Three updates of ``make_optimizer`` (and ``clip_grad_global_norm_``
    ahead of it) against the JAX package's optax chain, on parameters that
    hit every group rule: parameters to 1e-6; the stored moments bitwise in
    bfloat16 (optax rounds what it stores, after using the float32 values
    for the update), to 1e-5 relative in float32. With the clip at 0.02 the
    global norm of the gradients (~0.01-0.05) falls on both sides of it."""
    g = np.random.default_rng(31)
    shapes = {"hc": (3, 4), "hb": (4,), "bn": (5,), "bf": (5, 2), "bu": (3,)}
    init = {k: g.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jtree = {"decode_head": {"conv": {"kernel": init["hc"]},
                             "bn": {"scale": init["hb"]}},
             "backbone": {"norm1": {"scale": init["bn"]},
                          "fc": {"kernel": init["bf"]},
                          "unused": {"kernel": init["bu"]}}}
    kw = dict(warmup_iters=2, max_iters=10, moment_dtype=moments,
              grad_clip=clip)
    tx = joptim.make_optimizer(jtree, JC.OptimConfig(**kw))
    jstate = tx.init(jtree)
    model = _Tiny({k: torch.nn.Parameter(_t(v.copy()))
                   for k, v in init.items()})
    tcfg = TC.OptimConfig(**kw)
    opt = toptim.make_optimizer(model, tcfg)
    assert isinstance(opt, toptim.LowPrecisionAdamW) == (moments ==
                                                         "bfloat16")
    scheds = toptim.make_schedules(tcfg)
    tparams = {"hc": model.decode_head["conv"]["weight"],
               "hb": model.decode_head["bn"]["weight"],
               "bn": model.backbone["norm1"]["weight"],
               "bf": model.backbone["fc"]["weight"],
               "bu": model.backbone["unused"]["weight"]}
    norms = []
    for step in range(3):
        scale = 10.0 ** (-3 + step / 2)
        grads = {k: (g.normal(size=shapes[k]) * scale).astype(np.float32)
                 for k in shapes}
        grads["bu"] = np.zeros(shapes["bu"], np.float32)
        norms.append(float(optax.global_norm(grads)))
        jg = jax.tree.map(np.zeros_like, jtree)
        for k, p in _PATH.items():
            jg[p[0]][p[1]][p[2]] = grads[k]
        upd, jstate = tx.update(jg, jstate, jtree)
        jtree = jax.tree.map(lambda a, u: np.asarray(a + u), jtree, upd)
        opt.zero_grad(set_to_none=True)
        for k, p in tparams.items():
            if k != "bu":
                p.grad = _t(grads[k].copy())
        toptim.zero_missing_grads(model.parameters())
        if clip is not None:
            toptim.clip_grad_global_norm_(model.parameters(), clip)
        toptim.set_lr(opt, scheds, step)
        opt.step()
        for k, p in _PATH.items():
            np.testing.assert_allclose(
                tparams[k].detach().numpy(), jtree[p[0]][p[1]][p[2]],
                rtol=1e-6, atol=1e-7, err_msg=f"{k} step {step}")
    if clip is not None:
        assert min(norms) < clip <= max(norms), norms
    layout = _opt_layout(jstate)
    for k, p in _PATH.items():
        part = "head" if p[0] == "decode_head" else "backbone"
        st = opt.state[tparams[k]]
        assert layout[part]["count"] == int(st["step"]) == 3
        for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            ref = layout[part][name][p[0]][p[1]][p[2]]
            if moments == "bfloat16":
                assert st[key].dtype == torch.bfloat16
                assert ref.dtype.name == "bfloat16"
                np.testing.assert_array_equal(_bits(st[key]), _bits(ref),
                                              err_msg=f"{k} {name}")
            else:
                assert st[key].dtype == torch.float32
                np.testing.assert_allclose(st[key].numpy(), ref, rtol=1e-5,
                                           atol=1e-12)


@pytest.mark.parametrize("max_norm", [10.0, 0.5], ids=["below", "above"])
def test_grad_clip_matches_optax(max_norm):
    """``clip_grad_global_norm_`` against ``optax.clip_by_global_norm`` on
    gradients of global norm ~3: below the threshold every gradient is left
    bitwise as it was (optax selects the input), above it each is
    (g / norm) * max to 1e-6 relative and the returned norm is optax's."""
    g = np.random.default_rng(41)
    grads = [g.normal(size=s).astype(np.float32)
             for s in ((3, 4), (7,), (2, 3, 5), (1,))]
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(x) for x in grads], optax.EmptyState())
    params = [torch.nn.Parameter(torch.zeros(x.shape)) for x in grads]
    for p, x in zip(params, grads):
        p.grad = _t(x.copy())
    norm = toptim.clip_grad_global_norm_(params, max_norm)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                               rtol=1e-6)
    for p, r, x in zip(params, ref, grads):
        if max_norm > float(norm):
            np.testing.assert_array_equal(p.grad.numpy(), x)
            np.testing.assert_array_equal(np.asarray(r), x)
        else:
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(r),
                                       rtol=1e-6)
    if max_norm < float(norm):
        total = np.sqrt(sum(float((p.grad ** 2).sum()) for p in params))
        assert total == pytest.approx(max_norm, rel=1e-5)


def test_load_jax_train_state_bf16_moments_copied():
    """``load_jax_train_state`` of a JAX state whose optimizer has bfloat16
    moments and ``grad_clip`` (the clip's chain level in front of the
    multi_transform state): the port's ``LowPrecisionAdamW`` gets them
    bitwise, in bfloat16, as copies (writing into the JAX arrays afterwards
    changes nothing), and ``train_state_to_numpy`` hands them back as
    their exact float32 values."""
    jcfg, tcfg = _configs("cs2dz_image+raw-isr")
    jcfg, tcfg = (C.replace(c, optim=C.replace(
        c.optim, moment_dtype="bfloat16", grad_clip=1.0))
        for C, c in ((JC, jcfg), (TC, tcfg)))
    jtr = JTrainer(jcfg)
    js = _jax_init_state(jtr, jcfg)
    assert not hasattr(js.opt_state, "inner_states")   # the chain's level
    g = np.random.default_rng(51)
    opt_state = jax.tree.map(
        lambda a: (g.normal(size=a.shape) * 1e-3).astype(a.dtype)
        if a.dtype.name == "bfloat16" else a, js.opt_state)
    js = js.replace(opt_state=opt_state)
    jnum = _jax_state_numpy(js)
    ttr = DACSTrainer(tcfg, device="cpu")
    tstate = load_jax_train_state(ttr.init_state(), jnum)
    assert isinstance(tstate.optimizer, toptim.LowPrecisionAdamW)
    layout = {"params": jnum["params"], "batch_stats": jnum["batch_stats"]}
    back = train_state_to_numpy(tstate, layout)
    for part in ("head", "backbone"):
        for m, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            ref = jnum["opt"][part][m]
            for path, r in jax.tree_util.tree_leaves_with_path(ref):
                assert r.dtype.name == "bfloat16"
                got = dict(jax.tree_util.tree_leaves_with_path(
                    back["opt"][part][m]))[path]
                np.testing.assert_array_equal(got, r.astype(np.float32))
                r[...] = 0   # the port's tensors are copies
    back2 = train_state_to_numpy(tstate, layout)
    _assert_tree_close(back2["opt"], back["opt"], "moments", atol=0, rtol=0)
    kinds = {t.dtype for st in tstate.optimizer.state.values()
             for k, t in st.items() if k != "step"}
    assert kinds == {torch.bfloat16}


# ---------------------------------------------------------------------------
# teacher_bf16
# ---------------------------------------------------------------------------

# the bfloat16 teacher: the two packages round to bfloat16 at different
# places, and train-mode BatchNorm on the micro model's small maps carries
# that on, so its logits are held as tests/test_torch_train_bf16.py holds the
# bfloat16 training forward, against n = |JAX bf16 - JAX f32| (max-abs, both
# with teacher_bf16; 2.2% of max|logit|): |port - JAX| <= 1.5 n (measured
# 1.17 n) and |port - port f32| >= 0.5 n (measured 0.88 n). (The bfloat16
# teacher without the option lies 1.6 n from JAX's: 3.4% of max|logit|.)
TEACHER_NOISE_RATIO = 1.5
TEACHER_F32_MIN_RATIO = 0.5


@pytest.fixture(scope="module")
def teacher_pair():
    """{dtype: (JAX teacher_bf16 logits, port teacher_bf16 logits, port
    logits without the option)}: the teacher's stride-4 fusion logits
    (night image + events, BN on batch statistics, the micro model at
    64x64) from one set of seeded EMA weights; the JAX ``_teacher_logits``
    jitted, one compile a dtype."""
    g = np.random.default_rng(24)
    image, events = (g.normal(size=(2, *HW, 3)).astype(np.float32)
                     for _ in range(2))
    out, v = {}, None
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _configs("cs2dsec_image+events_together")
        jcfg, tcfg = (C.replace(c, dtype=dtype, uda=C.replace(
            c.uda, teacher_bf16=True)) for C, c in ((JC, jcfg), (TC, tcfg)))
        jtr = JTrainer(jcfg)
        if v is None:
            v = random_variables(lambda: jtr.model.init(
                jax.random.PRNGKey(0), *[jnp.zeros((2, *HW, 3))] * 3,
                mode="fusion_all", method=jtr.model.forward_logits), seed=23)
        js = DACSTrainState(step=np.zeros((), np.int32), params=v["params"],
                            batch_stats=v["batch_stats"],
                            ema_params=v["params"], opt_state=None)
        ref = np.asarray(jax.jit(lambda js, a, b: jtr._teacher_logits(
            js, a, b, None, "default", resize=False)["fusion_output"])(
                js, image, events))
        ema = load_jax_variables(TFED(tcfg.model, dtype=dtype), v)
        teacher = DACSTrainer(tcfg, device="cpu")._teacher_copy(ema)
        kinds = {p.dtype for p in teacher.parameters()}
        assert kinds == ({torch.float32} if dtype == "float32"
                         else {torch.float32, torch.bfloat16})

        def logits(m):
            with torch.no_grad():
                return m.forward_logits(
                    _t(image), _t(events), None, "default",
                    resize_to_input=False, streams=("fusion",), train=False,
                    bn_train=True, bn_update=False)["fusion_output"].numpy()
        out[dtype] = (ref, logits(teacher), logits(ema))
        # the EMA is untouched: float32, its own values
        assert all(p.dtype == torch.float32 for p in ema.parameters())
    return out


def test_teacher_bf16_float32_logits_match_jax(teacher_pair):
    """``dtype='float32'``: a float32 forward on bfloat16-rounded weights,
    to 1e-4 of the largest logit (the eval forward's tolerance; measured
    3.0e-6), and farther than 10 times that from the teacher on the float32
    EMA weights (measured 1.2e-2)."""
    ref, out, plain = teacher_pair["float32"]
    tol = 1e-4 * np.abs(ref).max()
    assert np.abs(out - ref).max() <= tol, (np.abs(out - ref).max(), tol)
    assert np.abs(plain - ref).max() > 10 * tol


def test_teacher_bf16_bfloat16_logits_match_jax(teacher_pair):
    """``dtype='bfloat16'``: against the JAX bfloat16 teacher as stated
    above, and unequal to the bfloat16 teacher without the option (the
    matmuls and convolutions see the same bfloat16 weights either way; the
    norms and the classifier read bfloat16-rounded values with it)."""
    ref, out, plain = teacher_pair["bfloat16"]
    ref32, out32, _ = teacher_pair["float32"]
    n = np.abs(ref - ref32).max()
    assert n > 0
    assert np.abs(out - ref).max() <= TEACHER_NOISE_RATIO * n
    assert np.abs(out - out32).max() >= TEACHER_F32_MIN_RATIO * n
    assert not np.array_equal(plain, out)


# ---------------------------------------------------------------------------
# cs2dz_image+raw-isr: the training forward at non-zero rates, three steps
# ---------------------------------------------------------------------------

def _dz_forward_draws(drawn, b, n_blocks):
    """The port's ForwardDraws from the uniforms one JAX training forward
    of the single-batch model drew, in call order: 4 image stages [1, 2, B],
    4 events stages [1, 2, B] (the ISR alone), the fusion blocks' two
    drop-paths each [B, 1, 1], the image, events and fusion streams'
    Dropout2d [B, 1, 1, C]."""
    return ForwardDraws(
        image=[_t(d) for d in drawn[:4]], events=[_t(d) for d in drawn[4:8]],
        fusion=_t(np.stack(drawn[8:-3]).reshape(n_blocks, 2, b)),
        dropout_keep=_t(np.stack(drawn[-3:])[:, :, 0, 0]
                        < np.float32(1.0 - DROPOUT)))


def test_cs2dz_forward_train_same_draws_as_jax(monkeypatch):
    """The cs2dz micro segmentor's training forward on (image, ISR) at
    non-zero drop-path (MiT ramp to 0.6, the AttentionFusion blocks 0.5)
    and Dropout2d (0.5) rates, 64x64: every uniform the JAX forward draws is
    recorded and handed to the port as its single-batch ``ForwardDraws``,
    whose shapes ``new_draws(with_isr=False)`` gives. The three stream
    logits to 1e-4 and the BN running statistics to 1e-5, as
    ``test_torch_train.py`` holds the double-batch forward; a draw taken by
    the wrong block, sample or stream moves the logits by O(1)."""
    jcfg, tcfg = _configs("cs2dz_image+raw-isr", rates=True)
    b = jcfg.data.batch_size
    n_blocks = len(jcfg.model.head.in_channels)   # one MiT block per scale
    monkeypatch.setitem(jfus.FUSION_REGISTRY, "attention", functools.partial(
        jfus.FUSION_REGISTRY["attention"], drop_path_rate=DP_FUSION))
    jm = JFED(jcfg.model)
    g = np.random.default_rng(22)
    image, isr = (g.normal(size=(b, *HW, 3)).astype(np.float32)
                  for _ in range(2))
    v = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), image, isr, None, method=jm.forward_logits),
        seed=19)
    tm = load_jax_variables(TFED(tcfg.model), v)
    for mod in tm.fusion_module.modules():
        if isinstance(mod, DropPath):
            mod.rate = DP_FUSION
    rec = _record_draws(monkeypatch)

    @jax.jit
    def jfwd(v, image, isr):
        rec.clear()
        out = jm.apply(v, image, isr, None, mode="default",
                       mutable=["batch_stats"],
                       rngs={"droppath": jax.random.PRNGKey(3),
                             "dropout": jax.random.PRNGKey(4)},
                       method=jm.forward_train)
        return out, list(rec)
    ((ref, _), upd), drawn = jfwd(v, image, isr)
    drawn = [np.asarray(u) for u in drawn]
    new = tm.new_draws(b, generator=torch.Generator().manual_seed(0),
                       device=torch.device("cpu"), with_isr=False)
    assert [u.shape for u in drawn] == (
        [tuple(u.shape) for u in new.image + new.events]
        + [(b, 1, 1)] * new.fusion.shape[0] * 2
        + [(b, 1, 1, new.dropout_keep.shape[-1])] * new.dropout_keep.shape[0])
    assert new.fusion.shape[0] == n_blocks and new.dropout_keep.shape[0] == 3
    draws = _dz_forward_draws(drawn, b, n_blocks)
    # the draws do drop: a sample in a MiT stage and in a fusion block, and
    # a classifier channel
    ramp = np.linspace(0.0, DP_MIT, 4).astype(np.float32)
    assert any((u >= 1 - r).any() for u, r in zip(drawn[:8], [*ramp, *ramp]))
    assert (draws.fusion >= 1 - DP_FUSION).any()
    assert not draws.dropout_keep.all()

    out, _ = tm.forward_train(_t(image), _t(isr), None, "default", draws)
    assert out["img_self_res_output"] is None and ref["img_self_res_output"] is None
    for k, r in ref.items():
        if r is not None:
            np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(r),
                                       err_msg=k, atol=1e-4, rtol=1e-4)
    got = state_dict_to_tree(tm.state_dict(), upd["batch_stats"])
    _assert_tree_close(got, upd["batch_stats"], "batch_stats", atol=1e-5,
                       rtol=1e-5)


@pytest.fixture(scope="module")
def dz_steps():
    """Three cs2dz DACS steps of the JAX and the port's trainer from one
    state on the same batches and draws (``test_torch_train.py``'s
    ``step_pair`` recipe, rates 0): the logs and states after steps 1 and
    3, each step's pseudo-labels (JAX, port) with the JAX teacher's
    full-size logits, and the uniforms each JAX forward drew (the MiT
    stages' only, at rates 0). One jitted JAX compile."""
    jcfg, tcfg = _configs("cs2dz_image+raw-isr")
    b = jcfg.data.batch_size
    n_fwd = 4 + 4           # MiT stage uniforms per training forward
    mp = pytest.MonkeyPatch()
    mp.setitem(jfus.FUSION_REGISTRY, "attention", functools.partial(
        jfus.FUSION_REGISTRY["attention"], drop_path_rate=0.0))
    jpl_rec, tpl_rec = _record_pseudo_labels(mp)
    mixed = _record_mixed_images(mp)
    rec = _record_draws(mp)

    def jstep_recorded(state, batch, rng):
        jpl_rec.clear()
        rec.clear()
        return jtr.train_step(state, batch, rng), list(jpl_rec), list(rec)
    try:
        jtr = JTrainer(jcfg)
        assert jtr.cyclegan is None and jcfg.uda.shift_type == "rightdown"
        jstate = _jax_init_state(jtr, jcfg)
        jstep = jax.jit(jstep_recorded)
        ttr, tstate = _port(tcfg, jstate)
        assert tstate.cyclegan is None
        src = SyntheticSource(crop_size=HW, with_time_res=False)
        tgt = SyntheticTarget(crop_size=HW, with_events=False)
        base = jax.random.PRNGKey(11)
        layout = {"params": jstate.params, "batch_stats": jstate.batch_stats}
        results, pls, fwds = {}, [], []
        for step in range(3):
            batch = uda_batch(src, tgt, [2 * step, 2 * step + 1])
            assert set(batch["source"]) == {"image", "img_self_res", "label"}
            assert set(batch["target"]) == {"image", "isr"}
            mixed.clear()
            (jstate, jlogs), jpl, drawn = jstep(
                jstate, jax.tree.map(jnp.asarray, batch), base)
            jax.effects_barrier()
            drawn = [np.asarray(d) for d in drawn[-2 * n_fwd:]]
            fwds.append((drawn[:n_fwd], drawn[n_fwd:]))
            gen = torch.Generator().manual_seed(step)   # rates 0: any do
            draws = _draws(base, step, b, jcfg, tstate.model.new_draws(
                b, generator=gen, device=torch.device("cpu"),
                with_isr=False))
            tpl_rec.clear()
            tstate, tlogs = ttr.train_step(tstate, batch, draws)
            [(jlogits, jlabel)] = jpl
            [tlabel] = tpl_rec
            pls.append((np.asarray(jlogits), np.asarray(jlabel),
                        tlabel.numpy()))
            pls[-1] += (mixed["port"], mixed["jax"])
            if step in (0, 2):
                results[step + 1] = (
                    {k: float(v) for k, v in jlogs.items()},
                    {k: float(v) for k, v in tlogs.items()},
                    _jax_state_numpy(jstate),
                    train_state_to_numpy(tstate, layout))
    finally:
        mp.undo()
    return results, pls, fwds, jcfg


def _record_mixed_images(mp):
    """Record the mixed image (ClassMix, jitter, blur) of the JAX step
    (through a debug callback, the step being jitted) and of the port's:
    {'jax', 'port'} of the last step."""
    mixed = {}
    jfn, tfn = JTrainer._mixed_isr, tdacs.maybe_gaussian_blur

    def jmixed_isr(self, img, *a, **k):
        jax.debug.callback(lambda x: mixed.__setitem__("jax", np.asarray(x)),
                           img)
        return jfn(self, img, *a, **k)

    def tblur(*a):
        out = tfn(*a)
        mixed["port"] = out.numpy().copy()
        return out
    mp.setattr(JTrainer, "_mixed_isr", jmixed_isr)
    mp.setattr(tdacs, "maybe_gaussian_blur", tblur)
    return mixed


@pytest.mark.parametrize("n_steps", [1, 3])
def test_cs2dz_step_logs_match_jax(dz_steps, n_steps):
    jlogs, tlogs = dz_steps[0][n_steps][:2]
    # three streams, no ISR stream; the weight is 1 outside the zeroed rows
    assert "src/loss_isr" not in jlogs and "mix/loss_events" in jlogs
    _assert_logs_close(jlogs, tlogs)
    h = HW[0]
    assert tlogs["pseudo_weight"] == pytest.approx((h - 2 - 15) / h,
                                                   rel=1e-6)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_cs2dz_step_state_matches_jax(dz_steps, n_steps):
    """The state after 1 and 3 steps at the tolerances of
    ``test_torch_train.py``, except AdamW's moments after 3 steps: each
    leaf to 1e-3 of its group's largest moment (measured 3.0e-4 in the
    head, 4.1e-5 in the backbone), not to 1e-4 of its own. The two
    packages' stream logits differ by ~1e-5 from the first step on (XLA's
    and PyTorch's convolutions round differently); where that moves a ReLU
    input across 0 its gradient flips, which moves a few of the head's
    leaves whose gradients are small sums of larger terms (the dilated
    ASPP's depthwise kernel: 3.0e-4 of its own largest after 3 steps).
    With the base key 5 instead of 11 (the one ``test_torch_train.py``
    uses), such a flip in step 2 also put a BN running mean 1.55e-5 off
    after step 3 (tolerance 1e-5), while the stream logits of all three
    steps agreed to 9.5e-5 and a 1-ulp change of the port's own mixed image
    moved its step-2 moments by 6e-8."""
    results, _, _, cfg = dz_steps
    _, _, ref, got = results[n_steps]
    assert got["step"] == ref["step"] == n_steps
    assert got["cyclegan_params"] is ref["cyclegan_params"] is None
    _assert_state_close(got, ref, cfg, n_steps,
                        moments_of_group=n_steps > 1)


def test_cs2dz_pseudo_labels_and_mixed_image_match_jax(dz_steps):
    """Every step's pseudo-labels equal, except at near ties of the JAX
    teacher's full-size logits (top-2 margin below 1e-4 of their largest
    magnitude), and at least 99.9% equal; the port's own mixed image
    (ClassMix, jitter, blur) within 1e-5 of the JAX step's, the tolerance
    of the blur's module test (measured 1.6e-6)."""
    for jlogits, jlabel, tlabel, port_img, jax_img in dz_steps[1]:
        assert_labels_match(tlabel, jlabel, jlogits,
                            1e-4 * np.abs(jlogits).max())
        assert (tlabel == jlabel).mean() >= 0.999
        np.testing.assert_allclose(port_img, jax_img, atol=1e-5, rtol=0)


def test_cs2dz_step_forwards_share_draws(dz_steps):
    """In the JAX step the source and the mixed forward draw the same MiT
    stage uniforms, the events stages' at the single batch [1, 2, B] that
    the port's ``new_draws(with_isr=False)`` sizes (the double batch would
    be [1, 2, 2B])."""
    b = dz_steps[3].data.batch_size
    for src, mix in dz_steps[2]:
        assert [u.shape for u in src] == [(1, 2, b)] * 8
        for a, c in zip(src, mix, strict=True):
            np.testing.assert_array_equal(a, c)


# ---------------------------------------------------------------------------
# cs2dsec_image+events: one step under each coin outcome
# ---------------------------------------------------------------------------

def _coin(base, step=0):
    rng = jax.random.fold_in(base, step)
    return float(jax.random.uniform(jax.random.split(rng, 10)[0]))


@pytest.fixture(scope="module")
def events_steps():
    """One cs2dsec_image+events step of both packages from one state under
    each coin outcome (the bases picked so that the coin falls on either
    side of random_choice_thres): {use_events: (JAX logs, port logs, JAX
    state, port state)}. One jitted JAX compile, two calls."""
    jcfg, tcfg = _configs("cs2dsec_image+events")
    b = jcfg.data.batch_size
    thres = jcfg.uda.random_choice_thres
    bases = {}
    for i in range(64):
        key = jax.random.PRNGKey(100 + i)
        bases.setdefault(_coin(key) > thres, key)
        if len(bases) == 2:
            break
    mp = pytest.MonkeyPatch()
    for kind in ("attention_avg", "attention"):
        mp.setitem(jfus.FUSION_REGISTRY, kind, functools.partial(
            jfus.FUSION_REGISTRY[kind], drop_path_rate=0.0))
    try:
        jtr = JTrainer(jcfg)
        jstate0 = _jax_init_state(jtr, jcfg)
        jstep = jax.jit(jtr.train_step)
        src = SyntheticSource(crop_size=HW)
        tgt = SyntheticTarget(crop_size=HW)
        batch = uda_batch(src, tgt, [3, 4])
        layout = {"params": jstate0.params,
                  "batch_stats": jstate0.batch_stats}
        out = {}
        for use_events, base in sorted(bases.items()):
            jstate, jlogs = jstep(jstate0, jax.tree.map(jnp.asarray, batch),
                                  base)
            ttr, tstate = _port(tcfg, jstate0)
            gen = torch.Generator().manual_seed(0)   # rates 0: any do
            draws = _draws(base, 0, b, jcfg, tstate.model.new_draws(
                b, generator=gen, device=torch.device("cpu"),
                with_isr=False))
            tstate, tlogs = ttr.train_step(tstate, batch, draws)
            out[use_events] = ({k: float(v) for k, v in jlogs.items()},
                               {k: float(v) for k, v in tlogs.items()},
                               _jax_state_numpy(jstate),
                               train_state_to_numpy(tstate, layout))
    finally:
        mp.undo()
    return out, jcfg


@pytest.mark.parametrize("use_events", [False, True],
                         ids=["isr_coin", "events_coin"])
def test_cs2dsec_image_events_step_matches_jax(events_steps, use_events):
    out, cfg = events_steps
    jlogs, tlogs, ref, got = out[use_events]
    assert jlogs["use_events"] == tlogs["use_events"] == float(use_events)
    assert "src/loss_isr" not in jlogs and "src/loss_events" in jlogs
    _assert_logs_close(jlogs, tlogs)
    _assert_state_close(got, ref, cfg, 1)


def test_cs2dsec_image_events_coin_changes_the_step(events_steps):
    """The two coin outcomes train on different second inputs."""
    out, _ = events_steps
    assert out[False][1]["src/loss_events"] != out[True][1]["src/loss_events"]
