"""The port's CycleGAN workflow against the JAX package, on the CPU, from
seeded numpy weights and inputs:

* the NLayer (3 and 2 layers) and pixel discriminators from the same flax
  params (outputs 1e-5; the weights bridge both ways bitwise), ``gan_loss``
  in each mode (1e-6 relative) and ``gradient_penalty`` at the real, fake
  and mixed points (the value 1e-5 relative, its gradient in the critic's
  parameters 1e-4 of the largest: the penalty keeps its graph);
* the history pool in its fill and its playback phase, bitwise, on the
  JAX pool's own draws; ``_linear_decay`` bitwise and the empty-patch-map
  guard;
* the flat npz both ways (a JAX-written file through the port's loader and
  ``tools.train --cyclegan``, a port-written one through the JAX loader):
  the same keys and bits;
* ``UnpairedFolderDataset``, ``image_change`` (the IC mode over a written
  sequence tree) and the crops bitwise against the JAX tools; the ``en``
  mode against the JAX one (the generators within 1e-5, so the uint8
  levels within 1) and against the generator applied in-process (equal);
* the port CLI on PNG folders for 2 steps on the CPU: its log, samples and
  npz, and its logged losses equal to the trainer's on the same loader
  batches.

Last, the one jitted JAX CycleGAN step (about 9 s to compile): three steps
of both packages at ngf 8, ndf 8, one block, 32x32, batch 2, pool 2 (step 1
fills the pool; steps 2 and 3 play it back) from one state, on the JAX
pool's draws: losses rtol 1e-4, the pools 1e-5, the pool's choices equal,
Adam's first moments 1e-4 of each network's largest (a conv bias before an
instance norm has no gradient but rounding noise), the parameters within
2 lr per step taken (Adam's first updates are about +-lr, so a gradient
near 0 may flip sign between the packages).
"""
import json
import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from cmda_tpu.data.unpaired import UnpairedFolderDataset as JUnpaired
from cmda_tpu.models import cyclegan as jcyc
from cmda_tpu.uda import cyclegan_train as jcg
from cmda_tpu_torch import config as TC
from cmda_tpu_torch.data.unpaired import UnpairedFolderDataset as TUnpaired
from cmda_tpu_torch.models import cyclegan as tcyc
from cmda_tpu_torch.tools import create_cityscapes_image_change as ttool
from cmda_tpu_torch.tools import train as tcli
from cmda_tpu_torch.tools import train_cyclegan as tcg_cli
from cmda_tpu_torch.uda import cyclegan_train as tcg
from cmda_tpu_torch.uda.dacs import DACSTrainer
from cmda_tpu_torch.utils.weights import (cyclegan_to_state_dict,
                                          cyclegan_to_tree,
                                          discriminator_to_state_dict,
                                          discriminator_to_tree)
from tools import create_cityscapes_image_change as jtool
from torch_port_util import random_variables

MOD_TOL = dict(atol=1e-5, rtol=1e-5)
HW = 32
# the step test's config: ngf 8, ndf 8, one block, pool 2, two epochs of
# two steps so that step 2 takes the decayed lr
CFG = dict(ngf=8, ndf=8, n_blocks=1, pool_size=2, n_epochs=1,
           n_epochs_decay=1, steps_per_epoch=2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _disc_params(kind, n_layers=3, seed=0, nc=1):
    jm = (jcyc.NLayerDiscriminator(ndf=8, n_layers=n_layers)
          if kind == "patch" else jcyc.PixelDiscriminator(ndf=8))
    x = jnp.zeros((1, HW, HW, nc))
    return jm, random_variables(lambda: jm.init(jax.random.PRNGKey(0), x),
                                seed)["params"]


def _port_disc(kind, params, n_layers=3, nc=1):
    tm = (tcyc.NLayerDiscriminator(nc, 8, n_layers) if kind == "patch"
          else tcyc.PixelDiscriminator(nc, 8))
    tm.load_state_dict({k: _t(v) for k, v in
                        discriminator_to_state_dict(params).items()})
    return tm


def _assert_trees_equal(a, b, what=""):
    fa = dict(jax.tree_util.tree_leaves_with_path(a))
    fb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert fa.keys() == fb.keys(), what
    for k, v in fa.items():
        assert np.array_equal(np.asarray(v), np.asarray(fb[k])), (what, k)


# ---------------------------------------------------------------------------
# the networks and objectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,n_layers", [("patch", 3), ("patch", 2),
                                           ("pixel", 0)])
def test_discriminators_match_jax(kind, n_layers):
    jm, params = _disc_params(kind, n_layers)
    tm = _port_disc(kind, params, n_layers)
    x = np.random.default_rng(3).normal(size=(2, HW, HW, 1)).astype(
        np.float32)
    ref = jm.apply({"params": params}, x)
    with torch.no_grad():
        out = tm(_nchw(x)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    if kind == "patch":
        side = tcg.patch_output_size(HW, n_layers)
        assert ref.shape[1:3] == (side, side) == (
            jcg.patch_output_size(HW, n_layers),) * 2
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MOD_TOL)
    _assert_trees_equal(discriminator_to_tree(tm.state_dict()), params)


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "wgangp"])
@pytest.mark.parametrize("real", [True, False], ids=["real", "fake"])
def test_gan_loss_matches_jax(mode, real):
    pred = np.random.default_rng(4).normal(size=(2, 2, 2, 1)).astype(
        np.float32) * 3
    ref = float(jcyc.gan_loss(jnp.asarray(pred), real, mode))
    np.testing.assert_allclose(float(tcyc.gan_loss(_t(pred), real, mode)),
                               ref, rtol=1e-6)


@pytest.mark.parametrize("kind", ["real", "fake", "mixed"])
def test_gradient_penalty_matches_jax(kind):
    """The penalty of the 2-layer PatchGAN at one point, and its gradient
    in the critic's parameters (JAX: ``jax.grad`` through the penalty's own
    ``jax.grad``; the port: ``create_graph=True``). The mixed point's alpha
    is drawn by the JAX function from its key and handed to the port."""
    jm, params = _disc_params("patch", 2, seed=5)
    tm = _port_disc("patch", params, 2)
    g = np.random.default_rng(6)
    real, fake = (g.normal(size=(2, 16, 16, 1)).astype(np.float32)
                  for _ in range(2))
    rng = jax.random.PRNGKey(9)

    def jgp(p):
        return jcyc.gradient_penalty(
            lambda x: jm.apply({"params": p}, x), rng, jnp.asarray(real),
            jnp.asarray(fake), kind=kind, constant=1.0, lambda_gp=10.0)
    ref, ref_grads = jax.value_and_grad(jgp)(params)
    alpha = _t(jax.random.uniform(rng, (2, 1, 1, 1))).reshape(2)
    got = tcyc.gradient_penalty(tm, _nchw(real), _nchw(fake), kind=kind,
                                alpha=alpha if kind == "mixed" else None)
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    got.backward()
    want = discriminator_to_state_dict(ref_grads)
    # a conv bias before an instance norm has no gradient but rounding
    # noise in both packages, so each tensor is held to 1e-4 of the
    # largest gradient over all of them
    scale = max(np.abs(r).max() for r in want.values())
    for k, p in tm.state_dict(keep_vars=True).items():
        # the last bias does not reach d critic / d x: no graph, no grad
        grad = (p.grad.numpy() if p.grad is not None
                else np.zeros_like(want[k]))
        err = np.abs(grad - want[k]).max()
        assert err <= 1e-4 * scale, (k, err, scale)
    assert float(tcyc.gradient_penalty(tm, _nchw(real), _nchw(fake),
                                       lambda_gp=0.0)) == 0.0


# ---------------------------------------------------------------------------
# the pool, the schedule, the guard
# ---------------------------------------------------------------------------

def _pool_draws(key, batch, cap):
    """The JAX ``_pool_query``'s draws of ``key``: per image i, from
    fold_in(key, i) split in two, uniform > 0.5 and randint [0, cap)."""
    use, idx = [], []
    for i in range(batch):
        k_use, k_idx = jax.random.split(jax.random.fold_in(key, i))
        use.append(bool(jax.random.uniform(k_use) > 0.5))
        idx.append(int(jax.random.randint(k_idx, (), 0, cap)))
    return torch.tensor(use), torch.tensor(idx, dtype=torch.int64)


@pytest.mark.parametrize("n_stored", [0, 1, 4], ids=["fill", "fill_then_full",
                                                     "full"])
def test_pool_query_matches_jax(n_stored):
    cap, b = 4, 5
    g = np.random.default_rng(7)
    pool = g.normal(size=(cap, 3, 2, 1)).astype(np.float32)
    pool[n_stored:] = 0.0
    imgs = g.normal(size=(b, 3, 2, 1)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    with jax.disable_jit():
        jpool, jn, jout = jcg._pool_query(jnp.asarray(pool),
                                          jnp.int32(n_stored),
                                          jnp.asarray(imgs), key)
    use, idx = _pool_draws(key, b, cap)
    tpool = _t(pool)
    n, out, picked = tcg.pool_query(tpool, n_stored, _t(imgs), use, idx)
    assert n == int(jn)
    assert np.array_equal(out.numpy(), np.asarray(jout))
    assert np.array_equal(tpool.numpy(), np.asarray(jpool))
    # the choices: every image past the fill count takes its draw
    fill = max(cap - n_stored, 0)
    want = [-1] * fill + [i if u else -1 for u, i in
                          zip(use.tolist()[fill:], idx.tolist()[fill:])]
    assert picked.tolist() == want[:b]
    if n_stored == cap:
        assert min(want) == -1 and max(want) >= 0   # both branches taken


def test_linear_decay_and_patch_guard():
    cfg = dict(lr=2e-4, n_epochs=3, n_epochs_decay=4, steps_per_epoch=5)
    jsched = jcg._linear_decay(jcg.CycleGANConfig(**cfg))
    tsched = tcg._linear_decay(tcg.CycleGANConfig(**cfg))
    for step in range(0, 45):
        ref = np.float32(jsched(jnp.int32(step)))
        assert np.float32(tsched(step)) == ref, step
    assert tsched(44) == 0.0 and tsched(0) == np.float32(2e-4)
    for side, n in [(32, 3), (16, 3), (24, 3), (16, 2), (8, 2)]:
        assert tcg.patch_output_size(side, n) == jcg.patch_output_size(
            side, n)
    small = tcg.CycleGANConfig(ngf=8, ndf=8, n_blocks=1)
    with pytest.raises(ValueError, match="empty"):
        tcg.CycleGANTrainer(small, device="cpu").init_state(0, (16, 16))
    with pytest.raises(ValueError, match="empty"):
        jcg.CycleGANTrainer(jcg.CycleGANConfig(**{
            k: getattr(small, k) for k in ("ngf", "ndf", "n_blocks")})
        ).init_state(jax.random.PRNGKey(0), (16, 16))
    with pytest.raises(ValueError, match="lsgan"):
        tcg.CycleGANTrainer(tcg.CycleGANConfig(gan_mode="wgangp"),
                            device="cpu")


# ---------------------------------------------------------------------------
# the JAX state and the port's from the same params
# ---------------------------------------------------------------------------

def _jax_params(jtr, hw=HW):
    x = jnp.zeros((1, hw, hw, jtr.cfg.input_nc))

    def init(m, seed):
        return random_variables(lambda: m.init(jax.random.PRNGKey(0), x),
                                seed)["params"]
    return ({"g_a": init(jtr.g_a, 1), "g_b": init(jtr.g_b, 2)},
            {"d_a": init(jtr.d_a, 3), "d_b": init(jtr.d_b, 4)})


def _jax_state(jtr, g, d, hw=HW):
    """A JAX CycleGANTrainState from numpy params without the init's
    compiles."""
    pool = jnp.zeros((jtr.cfg.pool_size, hw, hw, jtr.cfg.input_nc))
    return jcg.CycleGANTrainState(
        step=jnp.zeros((), jnp.int32), g_params=g, d_params=d,
        g_opt=jtr.g_tx.init(g), d_opt=jtr.d_tx.init(d), pool_a=pool,
        pool_b=pool, pool_n=jnp.zeros((), jnp.int32))


def _port_state(ttr, g, d, hw=HW):
    cfg = ttr.cfg
    nets = []
    for tree in (g["g_a"], g["g_b"]):
        sd = cyclegan_to_state_dict(tree)
        m = tcyc.generator_from_params(sd)
        m.load_state_dict({k: _t(v) for k, v in sd.items()})
        nets.append(m)
    for tree in (d["d_a"], d["d_b"]):
        nets.append(_port_disc("patch", tree, cfg.n_layers_d, cfg.input_nc))
    pool = torch.zeros((cfg.pool_size, cfg.input_nc, hw, hw))
    return ttr.state_from(*nets, pool=pool)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _npz_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_npz_both_ways(tmp_path):
    jcfg = jcg.CycleGANConfig(**CFG)
    jtr = jcg.CycleGANTrainer(jcfg)
    g, d = _jax_params(jtr)
    jstate = _jax_state(jtr, g, d).replace(step=jnp.int32(7))
    jpath = str(tmp_path / "jax.npz")
    jcg.save_checkpoint(jpath, jstate)
    ttr = tcg.CycleGANTrainer(tcg.CycleGANConfig(**CFG), device="cpu")
    tstate = _port_state(ttr, g, d)
    tstate.step = 7
    tpath = str(tmp_path / "port.npz")
    tcg.save_checkpoint(tpath, tstate)
    ja, ta = _npz_arrays(jpath), _npz_arrays(tpath)
    assert ja.keys() == ta.keys()
    for k, v in ja.items():
        assert v.dtype == ta[k].dtype and np.array_equal(v, ta[k]), k
    for which in ("g_a", "g_b"):
        _assert_trees_equal(tcg.load_generator_npz(jpath, which),
                            jcg.load_generator_npz(tpath, which), which)
    with pytest.raises(ValueError, match="no 'nope'"):
        tcg.load_generator_npz(jpath, "nope")


def test_train_cli_loads_a_jax_npz(tmp_path):
    """``tools.train --cyclegan x.npz``: the frozen day-events generator is
    the JAX file's ``g_a``, and computes as the JAX
    ``generator_from_params`` of that file does."""
    jtr = jcg.CycleGANTrainer(jcg.CycleGANConfig(**CFG))
    g, d = _jax_params(jtr)
    path = str(tmp_path / "cyclegan_final.npz")
    jcg.save_checkpoint(path, _jax_state(jtr, g, d))
    cfg = TC.tiny_test_config()
    cfg = TC.replace(cfg, uda=TC.replace(cfg.uda,
                                         use_cyclegan_day_events=True))
    args = tcli.parse_args(["--config", "tiny", "--synthetic", "--device",
                            "cpu", "--cyclegan", path])
    state = tcli.init_state(DACSTrainer(cfg, device="cpu"), cfg, args)
    params = jcg.load_generator_npz(path, "g_a")
    _assert_trees_equal(cyclegan_to_tree(state.cyclegan.state_dict()),
                        params)
    x = np.random.default_rng(8).uniform(-1, 1, (1, HW, HW, 1)).astype(
        np.float32)
    ref = jcyc.generator_from_params(params).apply({"params": params}, x)
    with torch.no_grad():
        out = state.cyclegan(_nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MOD_TOL)


# ---------------------------------------------------------------------------
# the data and the corpus tools
# ---------------------------------------------------------------------------

def _write_pngs(root, n, size=(40, 30), seed=0):
    os.makedirs(root, exist_ok=True)
    g = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(g.integers(0, 256, size[::-1], dtype=np.uint8)).save(
            os.path.join(root, f"{i:02d}.png"))


def test_unpaired_dataset_bitwise(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _write_pngs(a, 3)
    _write_pngs(b, 2, seed=1)
    kw = dict(load_size=(36, 34), crop_size=(24, 20))
    jds, tds = JUnpaired(a, b, **kw), TUnpaired(a, b, **kw)
    assert len(jds) == len(tds) == 3
    for idx in range(4):
        for j, t in ((jds[idx], tds[idx]),
                     (jds.load(idx, random.Random(5 + idx)),
                      tds.load(idx, random.Random(5 + idx)))):
            for k in ("a", "b"):
                assert j[k].dtype == t[k].dtype and np.array_equal(
                    j[k], t[k]), (idx, k)


def _write_sequence_tree(root, size=(48, 32)):
    """A Cityscapes-like train tree and its sequence frames: two cities,
    two frames each, every frame's predecessor under the sequence dir."""
    g = np.random.default_rng(11)
    for city in ("aachen", "bonn"):
        for sub in ("leftImg8bit/train", "leftImg8bit_sequence/train"):
            os.makedirs(os.path.join(root, sub, city), exist_ok=True)
        for index in (19, 40):
            for sub, i in (("leftImg8bit/train", index),
                           ("leftImg8bit_sequence/train", index - 1)):
                name = f"{city}_000000_{i:06d}_leftImg8bit.png"
                img = g.integers(0, 256, (*size[::-1], 3), dtype=np.uint8)
                Image.fromarray(img).save(os.path.join(root, sub, city, name))


def _tree_pngs(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            out[os.path.relpath(os.path.join(d, n), root)] = np.asarray(
                Image.open(os.path.join(d, n)))
    return out


def test_ic_mode_and_crops_bitwise(tmp_path):
    roots = {}
    for pkg, tool in (("jax", jtool), ("port", ttool)):
        root = str(tmp_path / pkg)
        _write_sequence_tree(root)
        argv = ["--root_dir", root, "--mode", "ic"]
        if tool is ttool:
            ttool.main(argv)
        else:
            _jax_main(jtool, argv)
        tool.create_crops(os.path.join(root, "leftImg8bit_IC1"),
                          os.path.join(root, "crops"), crop_size=16,
                          per_image=3, seed=4)
        roots[pkg] = root
    j = _tree_pngs(os.path.join(roots["jax"], "leftImg8bit_IC1"))
    t = _tree_pngs(os.path.join(roots["port"], "leftImg8bit_IC1"))
    assert len(j) == 4 and j.keys() == t.keys()
    for k, v in j.items():
        assert np.array_equal(v, t[k]), k
    jc = _tree_pngs(os.path.join(roots["jax"], "crops"))
    tc = _tree_pngs(os.path.join(roots["port"], "crops"))
    assert len(jc) == 12 and jc.keys() == tc.keys()
    for k, v in jc.items():
        assert v.shape == (16, 16) and np.array_equal(v, tc[k]), k
    g = np.random.default_rng(2)
    now, front = (g.integers(0, 256, (20, 24), dtype=np.uint8)
                  for _ in range(2))
    assert np.array_equal(ttool.image_change(now, front),
                          jtool.image_change(now, front))


def _jax_main(tool, argv):
    import sys
    old = sys.argv
    sys.argv = ["create_cityscapes_image_change.py", *argv]
    try:
        tool.main()
    finally:
        sys.argv = old


def test_en_mode_matches_jax(tmp_path):
    """``--mode en`` from a JAX-written npz (a one-block ngf-8 generator):
    the port's PNGs equal its generator applied in-process, and are within
    one level of the JAX tool's (the generators agree to 1e-5; uint8
    truncation may cut such a difference either way)."""
    jtr = jcg.CycleGANTrainer(jcg.CycleGANConfig(**CFG))
    g, d = _jax_params(jtr)
    npz = str(tmp_path / "g.npz")
    jcg.save_checkpoint(npz, _jax_state(jtr, g, d))
    outs = {}
    for pkg in ("jax", "port"):
        root = str(tmp_path / pkg)
        ic = os.path.join(root, "leftImg8bit_IC1", "train", "aachen")
        os.makedirs(ic)
        gen = np.random.default_rng(3)
        for i in range(2):
            Image.fromarray(gen.integers(0, 256, (64, 96), dtype=np.uint8),
                            mode="L").save(os.path.join(ic, f"{i}.png"))
        argv = ["--root_dir", root, "--mode", "en", "--cyclegan", npz]
        if pkg == "port":
            ttool.main(argv + ["--device", "cpu"])
        else:
            _jax_main(jtool, argv)
        outs[pkg] = _tree_pngs(os.path.join(root, "leftImg8bit_EN1"))
    assert len(outs["jax"]) == 2 and outs["jax"].keys() == outs["port"].keys()
    gen = ttool.load_generator(npz, "cpu")
    for k, v in outs["jax"].items():
        got = outs["port"][k]
        assert got.shape == v.shape == (512, 1024)
        assert np.abs(got.astype(int) - v).max() <= 1, k
        src = os.path.join(tmp_path, "port", "leftImg8bit_IC1", k)
        assert np.array_equal(got, ttool.en_frame(gen, Image.open(src))), k


def test_cli_two_steps(tmp_path, capsys):
    """The port CLI for 2 steps on PNG folders on the CPU: the log's two
    records equal the trainer's losses on the same loader batches (the
    same seeds), a sample strip real_a | fake_b | rec_a, and the npz's
    ``g_a`` read back by the JAX loader equal to the final state's."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _write_pngs(a, 3)
    _write_pngs(b, 2, seed=1)
    wd = str(tmp_path / "wd")
    argv = ["--data-a", a, "--data-b", b, "--work-dir", wd, "--steps", "2",
            "--batch", "2", "--load-size", "36", "--crop", "32",
            "--n-blocks", "1", "--ngf", "8", "--ndf", "8", "--pool-size",
            "2", "--num-workers", "1", "--save-interval", "2",
            "--sample-interval", "1", "--log-interval", "1", "--device",
            "cpu"]
    trainer, state = tcg_cli.main(argv)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"done": True, "steps": 2,
                    "checkpoint": os.path.join(wd, "cyclegan_final.npz")}
    with open(os.path.join(wd, "cyclegan.log.json")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["iter"] for r in recs] == [1, 2]
    strip = np.asarray(Image.open(os.path.join(wd, "sample_000002.png")))
    assert strip.shape == (32, 96) and strip.dtype == np.uint8
    params = jcg.load_generator_npz(last["checkpoint"], "g_a")
    _assert_trees_equal(cyclegan_to_tree(state.g_a.state_dict()), params)
    # the same run through the trainer on the loader's batches
    from cmda_tpu_torch.data.loader import PrefetchLoader
    args = tcg_cli.parse_args(argv)
    ds = TUnpaired(a, b, load_size=(36, 36), crop_size=(32, 32))
    tr = tcg.CycleGANTrainer(trainer.cfg, device="cpu", seed=args.seed + 1)
    st = tr.init_state(args.seed, (32, 32))
    loader = PrefetchLoader(ds, 2, num_workers=1, seed=args.seed)
    try:
        for rec in recs:
            batch = next(loader)
            st, logs = tr.train_step(st, batch["a"], batch["b"])
            for k, v in logs.items():
                assert rec[k] == round(float(v), 4), (rec["iter"], k)
                assert np.isfinite(rec[k])
    finally:
        loader.close()


# ---------------------------------------------------------------------------
# three steps against the jitted JAX step (the file's one compile)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cyclegan_steps():
    jcfg = jcg.CycleGANConfig(**CFG)
    jtr = jcg.CycleGANTrainer(jcfg)
    g, d = _jax_params(jtr)
    jstate = _jax_state(jtr, g, d)
    ttr = tcg.CycleGANTrainer(tcg.CycleGANConfig(**CFG), device="cpu")
    tstate = _port_state(ttr, g, d)
    jstep = jax.jit(jtr.train_step)
    base = jax.random.PRNGKey(21)
    gen = np.random.default_rng(22)
    out = []
    for step in range(3):
        a, b = (gen.uniform(-1, 1, (2, HW, HW, 1)).astype(np.float32)
                for _ in range(2))
        jstate, jlogs = jstep(jstate, a, b, base)
        k_a, k_b = jax.random.split(jax.random.fold_in(base, step))
        use_a, idx_a = _pool_draws(k_a, 2, jcfg.pool_size)
        use_b, idx_b = _pool_draws(k_b, 2, jcfg.pool_size)
        full = tstate.pool_n >= jcfg.pool_size
        draws = tcg.CycleGANDraws(use_old_a=use_a, idx_a=idx_a,
                                  use_old_b=use_b, idx_b=idx_b)
        tstate, tlogs = ttr.train_step(tstate, a, b, draws)
        want = {k: (torch.where(u, i, -1) if full else torch.full((2,), -1))
                for k, u, i in (("a", use_a, idx_a), ("b", use_b, idx_b))}
        out.append(({k: float(v) for k, v in jlogs.items()},
                    {k: float(v) for k, v in tlogs.items()},
                    {k: v.clone() for k, v in ttr.last_picked.items()},
                    want))
    return jstate, tstate, out, jcfg


def test_cyclegan_steps_logs_match_jax(cyclegan_steps):
    _, _, out, _ = cyclegan_steps
    for step, (jlogs, tlogs, picked, want) in enumerate(out):
        assert set(jlogs) == set(tlogs) == {
            "idt_a", "idt_b", "g_a", "g_b", "cycle_a", "cycle_b", "loss_g",
            "d_a", "d_b", "loss_d"}
        for k, r in jlogs.items():
            np.testing.assert_allclose(tlogs[k], r, rtol=1e-4,
                                       err_msg=f"step {step} {k}")
        for k in ("a", "b"):
            assert torch.equal(picked[k], want[k]), (step, k)
    # steps 2 and 3 played the pool back at least once
    assert any((p[k] >= 0).any() for *_, p, _ in out[1:] for k in "ab")


def _moment_sd(mu, to_sd):
    return {n: to_sd(jax.tree.map(np.asarray, t)) for n, t in mu.items()}


def test_cyclegan_steps_state_matches_jax(cyclegan_steps):
    jstate, tstate, _, jcfg = cyclegan_steps
    assert tstate.step == int(jstate.step) == 3
    assert tstate.pool_n == int(jstate.pool_n) == 2
    for name in ("pool_a", "pool_b"):
        np.testing.assert_allclose(
            getattr(tstate, name).permute(0, 2, 3, 1).numpy(),
            np.asarray(getattr(jstate, name)), **MOD_TOL, err_msg=name)
    atol = 2 * jcfg.lr * 3
    nets = {"g_a": tstate.g_a, "g_b": tstate.g_b, "d_a": tstate.d_a,
            "d_b": tstate.d_b}
    params = {**_moment_sd(jstate.g_params, cyclegan_to_state_dict),
              **_moment_sd(jstate.d_params, discriminator_to_state_dict)}
    mus = {**_moment_sd(jstate.g_opt[0].mu, cyclegan_to_state_dict),
           **_moment_sd(jstate.d_opt[0].mu, discriminator_to_state_dict)}
    for name, net in nets.items():
        opt = tstate.g_opt if name.startswith("g") else tstate.d_opt
        # a conv bias before an instance norm has no gradient but rounding
        # noise: each moment is held to 1e-4 of the network's largest
        scale = max(np.abs(r).max() for r in mus[name].values())
        for k, p in net.state_dict(keep_vars=True).items():
            np.testing.assert_allclose(p.detach().numpy(), params[name][k],
                                       atol=atol, rtol=0,
                                       err_msg=f"{name}.{k}")
            err = np.abs(opt.state[p]["exp_avg"].numpy()
                         - mus[name][k]).max()
            assert err <= 1e-4 * scale, (name, k, err, scale)
            assert int(opt.state[p]["step"]) == 3
