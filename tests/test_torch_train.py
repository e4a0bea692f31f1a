"""The port's DACS training step and its modules against the JAX package,
on the CPU, from seeded numpy inputs.

* Modules: train-mode and teacher-mode StreamBatchNorm, DropPath given the
  same uniforms, the CycleGAN ResnetGenerator, each augment op given the
  same random values, AdamW against optax.
* The step: ``DACSTrainer.train_step`` of the micro config at 64x64
  (CycleGAN day events on, remat on, warmup 2, 10 iterations, drop-path and
  dropout rates 0) from the same seeded numpy state, batches and draws as
  the JAX step. The JAX step is jitted with remat off (the same math, a
  shorter trace): one compile of about a minute, where running it eagerly
  under ``jax.disable_jit()`` took about six minutes for three steps on one
  CPU. The draws are derived with the JAX step's own ``fold_in`` /
  ``split``.

Tolerances (float32 on the CPU; XLA and PyTorch sum in different orders):
module outputs 1e-5; losses and logs rtol 1e-4; BN running statistics and
EMA parameters 1e-5; AdamW moments 1e-4 of each leaf's largest magnitude;
parameters atol 2 * lr * head_lr_mult per step taken, because Adam's early
updates are close to sign(g) and a tiny gradient can flip.

Where the mixed ISR may differ: it quantises the jittered, blurred mixed
image to uint8 before the PIL grayscale, so a float difference at a level
boundary can move a gray level; ``test_mixed_isr_on_identical_image``
compares the two ISR paths on one identical mixed image.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cmda_tpu import config as JC
from cmda_tpu.models import common as jcommon
from cmda_tpu.models import cyclegan as jcyc
from cmda_tpu.models import fusion as jfus
from cmda_tpu.models import mit as jmit
from cmda_tpu.models.segmentor import FusionEncoderDecoder as JFED
from cmda_tpu.ops import augment as jaug
from cmda_tpu.train import optim as joptim
from cmda_tpu.uda.dacs import DACSTrainer as JTrainer, DACSTrainState
from cmda_tpu.data.synthetic import SyntheticSource, SyntheticTarget
from cmda_tpu_torch import config as TC
from cmda_tpu_torch.data.synthetic import uda_batch
from cmda_tpu_torch.models.common import DropPath, StreamBatchNorm
from cmda_tpu_torch.models.cyclegan import (ResnetGenerator,
                                            generator_from_params)
from cmda_tpu_torch.models.segmentor import (FusionEncoderDecoder as TFED,
                                             ForwardDraws)
from cmda_tpu_torch.ops import augment as taug
from cmda_tpu_torch.train import optim as toptim
from cmda_tpu_torch.uda.dacs import DACSTrainer, StepDraws
from cmda_tpu_torch.utils.weights import (cyclegan_to_state_dict,
                                          load_jax_train_state,
                                          load_jax_variables,
                                          state_dict_to_tree,
                                          train_state_to_numpy)
from torch_port_util import random_variables

MOD_TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_stream_batchnorm_train_and_teacher_modes():
    g = np.random.default_rng(0)
    x1, x2 = (g.normal(1.0, 2.0, size=(2, 5, 6, 4)).astype(np.float32)
              for _ in range(2))
    jm = jcommon.StreamBatchNorm()
    v = jm.init(jax.random.PRNGKey(0), x1)
    scale = g.uniform(0.5, 1.5, 4).astype(np.float32)
    bias = g.normal(size=4).astype(np.float32)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": g.normal(size=4).astype(np.float32),
                         "var": g.uniform(0.5, 1.5, 4).astype(np.float32)}}
    tm = StreamBatchNorm(4)
    with torch.no_grad():
        tm.weight.copy_(_t(scale))
        tm.bias.copy_(_t(bias))
        tm.running_mean.copy_(_t(v["batch_stats"]["mean"]))
        tm.running_var.copy_(_t(v["batch_stats"]["var"]))
    start = (tm.running_mean.clone(), tm.running_var.clone())

    # teacher mode: batch statistics, running statistics untouched
    ref, _ = jm.apply(v, x1, train=True, mutable=["batch_stats"])
    out = tm(_t(x1).permute(0, 3, 1, 2), bn_train=True, update=False)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(ref), **MOD_TOL)
    assert torch.equal(tm.running_mean, start[0])
    assert torch.equal(tm.running_var, start[1])

    # train mode, two calls: outputs and the running statistics after each
    for x in (x1, x2):
        ref, upd = jm.apply(v, x, train=True, mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
        out = tm(_t(x).permute(0, 3, 1, 2), bn_train=True)
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(ref), **MOD_TOL)
        np.testing.assert_allclose(tm.running_mean.numpy(),
                                   np.asarray(upd["batch_stats"]["mean"]),
                                   **MOD_TOL)
        np.testing.assert_allclose(tm.running_var.numpy(),
                                   np.asarray(upd["batch_stats"]["var"]),
                                   **MOD_TOL)
    # eval mode: the running statistics
    ref = jm.apply(v, x2, train=False)
    out = tm(_t(x2).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(ref), **MOD_TOL)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.35])
def test_drop_path_same_uniforms(rate):
    g = np.random.default_rng(1)
    y = g.normal(size=(6, 4, 3)).astype(np.float32)
    u = g.random(6).astype(np.float32)
    jm = jmit.MiTBlockScan(dim=3, num_heads=1, mlp_ratio=4, sr_ratio=1,
                           qkv_bias=True, drop_rate=0.0, attn_drop_rate=0.0,
                           hw=(2, 2), deterministic=False)
    ref = jm._drop_path(jnp.asarray(y), jnp.float32(rate), jnp.asarray(u))
    out = DropPath(rate)(_t(y), _t(u))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MOD_TOL)
    assert torch.equal(DropPath(rate)(_t(y)), _t(y))   # eval: identity


def _record_draws(mp):
    """Patch ``jax.random.uniform`` and ``bernoulli`` on ``mp`` so that every
    uniform the JAX package draws (the MiT stages' drop-path uniforms, the
    fusion blocks' and Dropout2d's Bernoullis, as ``uniform < p``) is
    appended, in call order, to the returned list."""
    rec, uniform = [], jax.random.uniform

    def record_uniform(key, shape=(), *a, **k):
        rec.append(uniform(key, shape, *a, **k))
        return rec[-1]

    def record_bernoulli(key, p=0.5, shape=None):
        rec.append(uniform(key, shape))
        return rec[-1] < p
    mp.setattr(jax.random, "uniform", record_uniform)
    mp.setattr(jax.random, "bernoulli", record_bernoulli)
    return rec


def test_forward_train_same_draws_as_jax(monkeypatch):
    """The micro segmentor's training forward at non-zero drop-path (MiT
    ramp to 0.6, fusion blocks 0.5) and Dropout2d (0.5) rates, 64x64. The
    JAX forward draws from fixed keys; every uniform it draws is recorded
    and handed to the port as its ``ForwardDraws``, which holds the port's
    mapping of them (per stage, per block, per half of the double batch,
    per stream) against JAX's. The port runs remat on, as the flagship.
    Tolerances: the logits 1e-4, as the eval forward in
    tests/test_torch_models.py (train-mode BatchNorm in the ASPP moves a
    few by ~1.5e-5; a draw applied to the wrong sample or channel moves
    them by O(1)); the BN running statistics after the forward 1e-5."""
    b, hw, dp_fusion = 2, 64, 0.5

    def cut(C, remat):
        cfg = C.micro_test_config().model
        return C.replace(cfg, drop_path_rate=0.6, remat=remat,
                         head=C.replace(cfg.head, dropout_ratio=0.5))
    monkeypatch.setitem(jfus.FUSION_REGISTRY, "attention_avg",
                        functools.partial(jfus.AttentionAvgFusion,
                                          drop_path_rate=dp_fusion))
    jcfg = cut(JC, remat=False)
    jm = JFED(jcfg)
    g = np.random.default_rng(21)
    x = [g.normal(size=(b, hw, hw, 3)).astype(np.float32) for _ in range(3)]
    v = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), *x, mode="fusion_all",
        method=jm.forward_logits), seed=17)
    tm = load_jax_variables(TFED(cut(TC, remat=True)), v)
    for mod in tm.fusion_module.modules():
        if isinstance(mod, DropPath):
            mod.rate = dp_fusion
    rec = _record_draws(monkeypatch)

    @jax.jit
    def jfwd(v, *x):
        rec.clear()
        out = jm.apply(v, *x, mode="default", mutable=["batch_stats"],
                       rngs={"droppath": jax.random.PRNGKey(3),
                             "dropout": jax.random.PRNGKey(4)},
                       method=jm.forward_train)
        return out, list(rec)
    ((ref, _), upd), drawn = jfwd(v, *x)
    # in call order: 4 image stages [1, 2, B], 4 events+ISR stages
    # [1, 2, 2B], the fusion blocks' two drop-paths each [B, 1, 1], the
    # Dropout2d of the image, events, fusion and isr streams [B, 1, 1, C]
    drawn = [np.asarray(u) for u in drawn]
    n_blocks, c = 2 * len(jcfg.head.in_channels), jcfg.head.channels
    assert [u.shape for u in drawn] == (
        [(1, 2, b)] * 4 + [(1, 2, 2 * b)] * 4 + [(b, 1, 1)] * 2 * n_blocks
        + [(b, 1, 1, c)] * 4)
    draws = ForwardDraws(
        image=[_t(u) for u in drawn[:4]], events=[_t(u) for u in drawn[4:8]],
        fusion=_t(np.stack(drawn[8:-4]).reshape(n_blocks, 2, b)),
        dropout_keep=_t(np.stack(drawn[-4:])[:, :, 0, 0] < np.float32(0.5)))
    # the draws do drop: a sample in a MiT block, one in a fusion block,
    # and a classifier channel
    ramp = np.linspace(0.0, 0.6, 4).astype(np.float32)
    assert any((u >= 1 - r).any() for u, r in zip(drawn[:8], [*ramp, *ramp]))
    assert (draws.fusion >= 1 - dp_fusion).any()
    assert not draws.dropout_keep.all()

    out, _ = tm.forward_train(*(_t(a) for a in x), "default", draws)
    for k, r in ref.items():
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(r),
                                   err_msg=k, atol=1e-4, rtol=1e-4)
    got = state_dict_to_tree(tm.state_dict(), upd["batch_stats"])
    _assert_tree_close(got, upd["batch_stats"], "batch_stats", **MOD_TOL)


def _jax_cyclegan(seed=0, ngf=8, n_blocks=2, size=32):
    """Seeded numpy params of a small JAX ResnetGenerator (nothing is
    compiled)."""
    jm = jcyc.ResnetGenerator(output_nc=1, ngf=ngf, n_blocks=n_blocks)
    return random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 1))), seed)["params"]


def test_resnet_generator_matches_jax():
    params = _jax_cyclegan()
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 1)).astype(
        np.float32)
    ref = jcyc.generator_from_params(params).apply({"params": params}, x)
    sd = cyclegan_to_state_dict(params)
    tm = generator_from_params(sd)
    tm.load_state_dict({k: _t(v) for k, v in sd.items()})
    with torch.no_grad():
        out = tm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MOD_TOL)
    assert isinstance(tm, ResnetGenerator) and len(tm.model) == 10 + 2 + 9


def _aug_inputs(seed=3, b=2, h=24, w=20):
    g = np.random.default_rng(seed)
    img = g.normal(size=(b, h, w, 3)).astype(np.float32)
    lbl = g.integers(0, 7, size=(b, h, w)).astype(np.int32)
    lbl[0, :2] = 255
    return img, lbl


def test_class_mix_ops_same_scores():
    img, lbl = _aug_inputs()
    img2 = np.random.default_rng(4).normal(size=img.shape).astype(np.float32)
    key = jax.random.PRNGKey(5)
    sel = jaug.sample_class_half(key, jnp.asarray(lbl), 7)
    scores = jax.random.uniform(key, (2, 8))
    tsel = taug.sample_class_half(_t(scores), _t(lbl), 7)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(sel))
    mask = jaug.class_mix_mask(jnp.asarray(lbl), sel, 7)
    tmask = taug.class_mix_mask(_t(lbl), tsel, 7)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    np.testing.assert_allclose(
        taug.one_mix(tmask, _t(img), _t(img2)).numpy(),
        np.asarray(jaug.one_mix(mask, jnp.asarray(img), jnp.asarray(img2))),
        **MOD_TOL)


def test_color_jitter_same_factors():
    img, _ = _aug_inputs(seed=6)
    key = jax.random.PRNGKey(7)
    kb, kc, ks, kh = jax.random.split(key, 4)
    s, b = 0.2, img.shape[0]
    factors = (jax.random.uniform(kb, (b, 1, 1, 1), minval=1 - s, maxval=1 + s),
               jax.random.uniform(kc, (b, 1, 1, 1), minval=1 - s, maxval=1 + s),
               jax.random.uniform(ks, (b, 1, 1, 1), minval=1 - s, maxval=1 + s),
               jax.random.uniform(kh, (b, 1, 1), minval=-s, maxval=s))
    tf = tuple(_t(f) for f in factors)
    for apply in (True, False):
        ref = jaug.maybe_color_jitter_normalized(key, jnp.asarray(img),
                                                 jnp.asarray(apply), s)
        out = taug.maybe_color_jitter_normalized(_t(img), torch.tensor(apply),
                                                 tf)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=1e-5)


@pytest.mark.parametrize("dim", [24, 51, 512])
def test_blur_kernel_size_rule(dim):
    assert (taug.reference_blur_kernel_size(dim)
            == jaug.reference_blur_kernel_size(dim))


def test_gaussian_blur_same_sigma():
    img, _ = _aug_inputs(seed=8, h=40, w=36)
    for sigma, apply in ((0.4, True), (1.1, True), (0.7, False)):
        ref = jaug.maybe_gaussian_blur(jnp.asarray(img), jnp.float32(sigma),
                                       jnp.asarray(apply))
        out = taug.maybe_gaussian_blur(_t(img), torch.tensor(sigma),
                                       torch.tensor(apply))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MOD_TOL)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class _Tiny(torch.nn.Module):
    """Parameter names that hit every group rule: head / backbone, norm /
    decayed, and one parameter that never gets a gradient."""

    def __init__(self, arrays):
        super().__init__()
        self.decode_head = torch.nn.ModuleDict({
            "conv": torch.nn.ParameterDict({"weight": arrays["hc"]}),
            "bn": torch.nn.ParameterDict({"weight": arrays["hb"]})})
        self.backbone = torch.nn.ModuleDict({
            "norm1": torch.nn.ParameterDict({"weight": arrays["bn"]}),
            "fc": torch.nn.ParameterDict({"weight": arrays["bf"]}),
            "unused": torch.nn.ParameterDict({"weight": arrays["bu"]})})


def test_adamw_matches_optax_three_steps():
    g = np.random.default_rng(9)
    shapes = {"hc": (3, 4), "hb": (4,), "bn": (5,), "bf": (5, 2), "bu": (3,)}
    init = {k: g.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jtree = {"decode_head": {"conv": {"kernel": init["hc"]},
                             "bn": {"scale": init["hb"]}},
             "backbone": {"norm1": {"scale": init["bn"]},
                          "fc": {"kernel": init["bf"]},
                          "unused": {"kernel": init["bu"]}}}
    path = {"hc": ("decode_head", "conv", "kernel"),
            "hb": ("decode_head", "bn", "scale"),
            "bn": ("backbone", "norm1", "scale"),
            "bf": ("backbone", "fc", "kernel"),
            "bu": ("backbone", "unused", "kernel")}
    cfg = JC.OptimConfig(warmup_iters=2, max_iters=10)
    tx = joptim.make_optimizer(jtree, cfg)
    jstate = tx.init(jtree)
    model = _Tiny({k: torch.nn.Parameter(_t(v.copy())) for k, v in init.items()})
    opt = toptim.make_optimizer(model, TC.OptimConfig(warmup_iters=2,
                                                      max_iters=10))
    scheds = toptim.make_schedules(TC.OptimConfig(warmup_iters=2,
                                                  max_iters=10))
    tparams = {"hc": model.decode_head["conv"]["weight"],
               "hb": model.decode_head["bn"]["weight"],
               "bn": model.backbone["norm1"]["weight"],
               "bf": model.backbone["fc"]["weight"],
               "bu": model.backbone["unused"]["weight"]}
    for step in range(3):
        grads = {k: (g.normal(size=shapes[k]) * 1e-3).astype(np.float32)
                 for k in shapes}
        grads["bu"] = np.zeros(shapes["bu"], np.float32)
        jg = jax.tree.map(np.zeros_like, jtree)
        for k, p in path.items():
            jg[p[0]][p[1]][p[2]] = grads[k]
        upd, jstate = tx.update(jg, jstate, jtree)
        jtree = jax.tree.map(lambda a, u: np.asarray(a + u), jtree, upd)
        opt.zero_grad(set_to_none=True)
        for k, p in tparams.items():
            if k != "bu":
                p.grad = _t(grads[k])
        toptim.zero_missing_grads(model.parameters())
        toptim.set_lr(opt, scheds, step)
        opt.step()
        for k, p in path.items():
            np.testing.assert_allclose(
                tparams[k].detach().numpy(), jtree[p[0]][p[1]][p[2]],
                rtol=1e-6, atol=1e-7, err_msg=f"{k} step {step}")
    # the zero-gradient parameter was still weight-decayed, as optax does
    assert not np.array_equal(tparams["bu"].detach().numpy(), init["bu"])
    for part, p in (("head", "hc"), ("backbone", "bf")):
        adam = jstate.inner_states[part].inner_state[0]
        mu = adam.mu[path[p][0]][path[p][1]][path[p][2]]
        st = opt.state[tparams[p]]
        assert int(adam.count) == int(st["step"]) == 3
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(mu),
                                   rtol=1e-5, atol=1e-12)


# ---------------------------------------------------------------------------
# the DACS step
# ---------------------------------------------------------------------------

def _configs():
    """(JAX config, port config): the micro config with the CycleGAN on,
    warmup 2 of 10 iterations, the drop-path and dropout rates 0, and 64x64
    crops: at the micro config's 32x32 the stride-32 map is 1x1, so the
    dilation-12 and -18 ASPP branches see only their centre tap and each of
    their channels has a batch variance over two numbers, a BatchNorm that
    amplifies float32 noise about a thousandfold. The port runs remat on,
    as the flagship; the JAX reference runs it off, which changes no value
    and cuts its trace and compile by about a fifth."""
    def cut(C):
        cfg = C.micro_test_config()
        return C.replace(
            cfg,
            model=C.replace(cfg.model, drop_path_rate=0.0, remat=True,
                            head=C.replace(cfg.model.head, dropout_ratio=0.0)),
            uda=C.replace(cfg.uda, use_cyclegan_day_events=True),
            data=C.replace(cfg.data, crop_size=(64, 64)),
            optim=C.replace(cfg.optim, warmup_iters=2, max_iters=10))
    jcfg = cut(JC)
    return JC.replace(jcfg, model=JC.replace(jcfg.model, remat=False)), cut(TC)


def _jax_init_state(jtr, cfg, cyclegan_params=None):
    """A JAX DACSTrainState from seeded numpy (``random_variables``) instead
    of ``init_state``, whose init would compile (or, eager, take minutes);
    the teacher is a copy of the student and the AdamW moments are 0. The
    model is initialised as ``init_state`` does: mode 'fusion_all' with the
    ISR input where it has a ``fusion_isr`` module, 'default' without."""
    h, w = cfg.data.crop_size
    img = jnp.zeros((cfg.data.batch_size, h, w, 3))
    isr, mode = ((img, "fusion_all") if cfg.model.fusion_isr
                 else (None, "default"))
    v = random_variables(lambda: jtr.model.init(
        jax.random.PRNGKey(0), img, img, isr, mode=mode,
        method=jtr.model.forward_logits), seed=13)
    jtr.tx = joptim.make_optimizer(v["params"], cfg.optim)
    if cyclegan_params is not None:
        jtr.cyclegan = jcyc.generator_from_params(cyclegan_params)
    opt = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                       jax.eval_shape(jtr.tx.init, v["params"]))
    return DACSTrainState(
        step=np.zeros((), np.int32), params=v["params"],
        batch_stats=v["batch_stats"],
        ema_params=jax.tree.map(np.copy, v["params"]), opt_state=opt,
        cyclegan_params=cyclegan_params)


def _drop_masked(tree):
    """An optax moment tree without its MaskedNode leaves (another group's
    parameters)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = _drop_masked(v)
            if sub:
                out[k] = sub
        elif not isinstance(v, tuple):
            out[k] = np.asarray(v)
    return out


def _opt_layout(opt_state):
    """The port's JAX layout of ``make_optimizer``'s state: each group's
    count and moments (``scale_by_adam`` leads each group's chain, float32
    or bfloat16); with ``grad_clip`` the multi_transform state sits behind
    the clip's empty one in an ``optax.chain``."""
    if not hasattr(opt_state, "inner_states"):
        [opt_state] = [s for s in opt_state if hasattr(s, "inner_states")]
    opt = {}
    for part, ms in opt_state.inner_states.items():
        adam = ms.inner_state[0]
        opt[part] = {"count": int(adam.count), "mu": _drop_masked(adam.mu),
                     "nu": _drop_masked(adam.nu)}
    return opt


def _jax_state_numpy(js):
    tree = functools.partial(jax.tree.map, np.asarray)
    return {"step": int(js.step), "params": tree(js.params),
            "batch_stats": tree(js.batch_stats),
            "ema_params": tree(js.ema_params),
            "opt": _opt_layout(js.opt_state),
            "cyclegan_params": tree(js.cyclegan_params)}


def _draws(base_rng, step, batch, cfg, fwd):
    """The JAX step's draws (dacs.py:272-290, augment.py), as a StepDraws;
    ``fwd`` the ForwardDraws of both forwards."""
    rng = jax.random.fold_in(base_rng, step)
    (k_coin, k_mix, k_jit_gate, k_jit, k_blur_gate, k_sigma, k_dir,
     _k_drop, _k_dpath, _k_noise) = jax.random.split(rng, 10)
    s = cfg.uda.color_jitter_strength
    kb, kc, ks, kh = jax.random.split(k_jit, 4)
    u = jax.random.uniform
    return StepDraws(
        coin=_t(u(k_coin)), mix_scores=_t(u(k_mix, (batch, 20))),
        jitter_gate=_t(u(k_jit_gate)),
        jitter=(_t(u(kb, (batch, 1, 1, 1), minval=1 - s, maxval=1 + s)),
                _t(u(kc, (batch, 1, 1, 1), minval=1 - s, maxval=1 + s)),
                _t(u(ks, (batch, 1, 1, 1), minval=1 - s, maxval=1 + s)),
                _t(u(kh, (batch, 1, 1), minval=-s, maxval=s))),
        blur_gate=_t(u(k_blur_gate)),
        sigma=_t(u(k_sigma, minval=0.15, maxval=1.15)),
        isr_dirs=_t(jax.random.randint(k_dir, (batch,), 0, 4)).to(
            torch.int32),
        fwd=fwd)


def _assert_tree_close(got, ref, what, **tol):
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert flat_g.keys() == flat_r.keys(), what
    for k, r in flat_r.items():
        np.testing.assert_allclose(np.asarray(flat_g[k]), np.asarray(r),
                                   err_msg=f"{what} {jax.tree_util.keystr(k)}",
                                   **tol)


def _assert_moments_close(got, ref, what):
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    for k, r in jax.tree_util.tree_leaves_with_path(ref):
        r = np.asarray(r)
        diff = np.abs(np.asarray(flat_g[k]) - r).max()
        assert diff <= 1e-4 * max(np.abs(r).max(), 1e-30), (
            what, jax.tree_util.keystr(k), diff, np.abs(r).max())


@pytest.fixture(scope="module")
def step_pair():
    """The JAX and the port's trainer from one state, and both after 1 and
    after 3 steps on the same batches and draws. The JAX step is jitted: its
    one compile (about a minute) costs less than running it eagerly (about
    six minutes for three steps). The rates are 0, so the MiT stages' are
    the only uniforms the JAX forwards draw; they are recorded for
    ``test_dacs_step_forwards_share_draws``."""
    jcfg, tcfg = _configs()
    mp = pytest.MonkeyPatch()
    # the fusion modules' drop-path rate (0.05) is not a config field
    for kind in ("attention_avg", "attention"):
        mp.setitem(jfus.FUSION_REGISTRY, kind, functools.partial(
            jfus.FUSION_REGISTRY[kind], drop_path_rate=0.0))
    rec = _record_draws(mp)

    def jstep_recorded(state, batch, rng):
        rec.clear()
        return jtr.train_step(state, batch, rng), list(rec)
    n_fwd = 4 + 4           # MiT stage uniforms per training forward
    try:
        jtr = JTrainer(jcfg)
        cyclegan = _jax_cyclegan()
        jstate = _jax_init_state(jtr, jcfg, cyclegan)
        jstep = jax.jit(jstep_recorded)
        ttr = DACSTrainer(tcfg, device="cpu")
        tstate = ttr.init_state(cyclegan_state_dict=cyclegan_to_state_dict(
            cyclegan))
        for m in (tstate.model, tstate.ema_model):
            for mod in m.modules():
                if isinstance(mod, DropPath):
                    mod.rate = 0.0
        load_jax_train_state(tstate, _jax_state_numpy(jstate))
        src = SyntheticSource(crop_size=jcfg.data.crop_size)
        tgt = SyntheticTarget(crop_size=jcfg.data.crop_size)
        base = jax.random.PRNGKey(11)
        layout = {"params": jstate.params, "batch_stats": jstate.batch_stats}
        results, drawn = {}, []
        for step in range(3):
            batch = uda_batch(src, tgt, [2 * step, 2 * step + 1])
            if step == 0:
                student0 = {k: v.detach().clone() for k, v in
                            tstate.model.named_parameters()}
            (jstate, jlogs), rec_step = jstep(
                jstate, jax.tree.map(jnp.asarray, batch), base)
            # the source forward's draws, then the mixed forward's
            fwd = [np.asarray(u) for u in rec_step[-2 * n_fwd:]]
            drawn.append((fwd[:n_fwd], fwd[n_fwd:]))
            gen = torch.Generator().manual_seed(step)  # rates 0: any do
            draws = _draws(base, step, 2, jcfg, tstate.model.new_draws(
                2, generator=gen, device=torch.device("cpu")))
            tstate, tlogs = ttr.train_step(tstate, batch, draws)
            if step in (0, 2):
                results[step + 1] = (
                    {k: float(v) for k, v in jlogs.items()},
                    {k: float(v) for k, v in tlogs.items()},
                    _jax_state_numpy(jstate),
                    train_state_to_numpy(tstate, layout))
            if step == 0:
                teacher0 = {k: v.detach().clone() for k, v in
                            tstate.ema_model.named_parameters()}
    finally:
        mp.undo()
    return results, student0, teacher0, jcfg, drawn


@pytest.mark.parametrize("n_steps", [1, 3])
def test_dacs_step_logs_match_jax(step_pair, n_steps):
    jlogs, tlogs, _, _ = step_pair[0][n_steps]
    assert set(tlogs) == set(jlogs)
    for k, ref in jlogs.items():
        np.testing.assert_allclose(tlogs[k], ref, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_dacs_step_state_matches_jax(step_pair, n_steps):
    results, _, _, cfg, _ = step_pair
    _, _, ref, got = results[n_steps]
    assert got["step"] == ref["step"] == n_steps
    _assert_tree_close(got["batch_stats"], ref["batch_stats"], "batch_stats",
                       atol=1e-5, rtol=1e-5)
    _assert_tree_close(got["ema_params"], ref["ema_params"], "ema_params",
                       atol=1e-5, rtol=1e-5)
    for part in ("head", "backbone"):
        assert got["opt"][part]["count"] == ref["opt"][part]["count"]
        for m in ("mu", "nu"):
            _assert_moments_close(got["opt"][part][m], ref["opt"][part][m],
                                  f"{part}/{m}")
    atol = 2 * cfg.optim.lr * cfg.optim.head_lr_mult * n_steps
    _assert_tree_close(got["params"], ref["params"], "params", atol=atol,
                       rtol=0)
    _assert_tree_close(got["cyclegan_params"], ref["cyclegan_params"],
                       "cyclegan", atol=0, rtol=0)


def test_dacs_teacher_after_step0_is_pre_update_student(step_pair):
    _, student0, teacher0, _, _ = step_pair
    assert student0.keys() == teacher0.keys()
    for k, v in student0.items():
        assert torch.equal(teacher0[k], v), k


def test_dacs_step_forwards_share_draws(step_pair):
    """In the JAX step the source and the mixed forward draw the same
    drop-path values (both get the step's rngs), which is why the port's
    ``StepDraws`` holds one ``ForwardDraws`` for both."""
    drawn = step_pair[4]
    assert len(drawn) == 3
    for src, mix in drawn:
        assert [u.shape for u in src] == [(1, 2, 2)] * 4 + [(1, 2, 4)] * 4
        for a, b in zip(src, mix, strict=True):
            np.testing.assert_array_equal(a, b)


def test_mixed_isr_on_identical_image():
    jcfg, tcfg = _configs()
    img, _ = _aug_inputs(seed=12, h=32, w=32)
    dirs = np.array([1, 2], np.int32)
    with jax.disable_jit():
        ref = JTrainer(jcfg)._mixed_isr(jnp.asarray(img), jnp.asarray(dirs))
    out = DACSTrainer(tcfg, device="cpu")._mixed_isr(_t(img), _t(dirs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_unported_flags_raise():
    _, tcfg = _configs()
    # share='half' builds since the model zoo slice (held against JAX in
    # tests/test_torch_zoo.py)
    state = DACSTrainer(TC.replace(tcfg, model=TC.replace(
        tcfg.model, share_decoder="half")), device="cpu").init_state()
    assert state.model.decode_head.share == "half"
    with pytest.raises(NotImplementedError, match="train_type"):
        DACSTrainer(TC.replace(tcfg, model=TC.replace(
            tcfg.model, train_type="cs2dz_image")), device="cpu")
