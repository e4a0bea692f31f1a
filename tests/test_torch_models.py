"""Eval-mode forward parity of the port's modules with the JAX package's,
on the same seeded weights carried over by ``load_jax_variables``.

float32 on the CPU. Tolerance 1e-4 absolute and relative: XLA and PyTorch
sum the convolutions and matmuls in different orders."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cmda_tpu import config as JC
from cmda_tpu.models import daformer as jdaf
from cmda_tpu.models import fusion as jfus
from cmda_tpu.models import mit as jmit
from cmda_tpu.models.segmentor import FusionEncoderDecoder as JFED
from cmda_tpu_torch import config as TC
from cmda_tpu_torch.models import daformer as tdaf
from cmda_tpu_torch.models import fusion as tfus
from cmda_tpu_torch.models import mit as tmit
from cmda_tpu_torch.models.segmentor import FusionEncoderDecoder as TFED
from cmda_tpu_torch.ops.resize import resize_bilinear
from cmda_tpu_torch.utils.weights import (jax_to_state_dict,
                                          load_jax_variables,
                                          match_state_dict)

from torch_port_util import random_variables

TOL = dict(atol=1e-4, rtol=1e-4)
MODES = ("default", "no_fusion", "fusion_isr", "fusion_all")
KEYS = ("image_output", "events_output", "fusion_output",
        "img_self_res_output")


def _nhwc(x):
    return np.asarray(x).transpose(0, 2, 3, 1)


def _pyramid(seed, b, hw, dims):
    g = np.random.default_rng(seed)
    return [g.normal(size=(b, hw // 2 ** i, hw // 2 ** i, c)).astype(np.float32)
            for i, c in enumerate(dims)]


def _nchw_t(feats):
    return [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]


@pytest.mark.parametrize("variant,size", [("mit_micro", 32), ("mit_b0", 64)])
def test_mix_vision_transformer(variant, size):
    cfg = jmit.MIT_VARIANTS[variant]
    jm = jmit.MixVisionTransformer(cfg)
    x = np.random.default_rng(0).normal(size=(2, size, size, 3)).astype(np.float32)
    v = random_variables(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    tm = load_jax_variables(tmit.MixVisionTransformer(
        tmit.MIT_VARIANTS[variant]).eval(), v)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(out) == 4
    for o, r in zip(out, ref):
        np.testing.assert_allclose(_nhwc(o), np.asarray(r), **TOL)


@pytest.mark.parametrize("kind", ["attention_avg", "attention"])
def test_fusion_modules(kind):
    dims = (16, 32, 64, 128)
    fi, fe = _pyramid(1, 2, 16, dims), _pyramid(2, 2, 16, dims)
    jm = jfus.FUSION_REGISTRY[kind]()
    v = random_variables(lambda: jm.init(jax.random.PRNGKey(0), fi, fe))
    ref = jax.jit(jm.apply)(v, fi, fe)
    tm = load_jax_variables(tfus.build_fusion_module(kind, dims).eval(), v)
    with torch.no_grad():
        out = tm(_nchw_t(fi), _nchw_t(fe))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(_nhwc(o), np.asarray(r), **TOL)


@pytest.fixture(scope="module")
def head_pair():
    hcfg = jdaf.DAFormerHeadConfig(in_channels=(16, 32, 64, 128),
                                   embed_dim=32, channels=32)
    feats = {k: _pyramid(i + 3, 2, 16, hcfg.in_channels)
             for i, k in enumerate(("f_image", "f_events", "f_fusion",
                                    "f_img_self_res"))}
    jm = jdaf.DAFormerFusionHead(hcfg)
    v = random_variables(lambda: jm.init(jax.random.PRNGKey(0), feats))
    tm = load_jax_variables(tdaf.DAFormerFusionHead(
        tdaf.DAFormerHeadConfig(in_channels=(16, 32, 64, 128), embed_dim=32,
                                channels=32)).eval(), v)
    return jm, v, tm, feats


@pytest.mark.parametrize("streams", [None, ("fusion",), ("image", "isr")])
def test_daformer_fusion_head(head_pair, streams):
    """streams=None and a pair take the batched eval path, one stream the
    per-stream loop."""
    jm, v, tm, feats = head_pair
    ref = jax.jit(lambda v, f: jm.apply(v, f, streams=streams))(v, feats)
    with torch.no_grad():
        out = tm({k: _nchw_t(f) for k, f in feats.items()}, streams=streams)
    for k in KEYS:
        if ref[k] is None:
            assert out[k] is None, k
        else:
            np.testing.assert_allclose(_nhwc(out[k]), np.asarray(ref[k]),
                                       err_msg=k, **TOL)


@pytest.fixture(scope="module")
def fed_pair():
    """The micro FusionEncoderDecoder in both packages on the same weights,
    and every JAX output the tests below compare, from one compile."""
    jcfg, tcfg = JC.micro_test_config(), TC.micro_test_config()
    jm = JFED(jcfg.model)
    g = np.random.default_rng(7)
    x = [g.normal(size=(2, 32, 32, 3)).astype(np.float32) for _ in range(3)]
    v = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), *x, mode="fusion_all",
        method=jm.forward_logits))
    tm = load_jax_variables(TFED(tcfg.model).eval(), v)

    @jax.jit
    def jfwd(v, a, b, c):
        return {m: jm.apply(v, a, b, c, mode=m, method=jm.forward_logits)
                for m in MODES}

    return tm, [torch.from_numpy(a) for a in x], jfwd(v, *x)


@pytest.mark.parametrize("mode", MODES)
def test_fusion_encoder_decoder_modes(fed_pair, mode):
    tm, t, ref = fed_pair
    with torch.no_grad():
        out = tm.forward_logits(*t, mode=mode)
    for k in KEYS:
        if ref[mode][k] is None:
            assert out[k] is None, k
            continue
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[mode][k]),
                                   err_msg=k, **TOL)


def test_fusion_encoder_decoder_stride4_and_output_select(fed_pair):
    """Stride-4 logits upsample to the default mode's outputs; output
    'fusion' without events falls back to the image stream (which does not
    depend on the events)."""
    tm, t, ref = fed_pair
    with torch.no_grad():
        out4 = tm.forward_logits(t[0], t[1], resize_to_input=False)
        sel = tm(t[0], None, output="fusion")
    assert tuple(out4["fusion_output"].shape) == (2, 8, 8, 19)
    np.testing.assert_allclose(
        resize_bilinear(out4["fusion_output"], (32, 32)).numpy(),
        np.asarray(ref["default"]["fusion_output"]), **TOL)
    np.testing.assert_allclose(sel.numpy(),
                               np.asarray(ref["default"]["image_output"]),
                               **TOL)


def test_b5_shapes_match_jax_at_full_width():
    """The flagship MiT-b5 model, built on the meta device, has exactly the
    parameter and buffer shapes that load_jax_variables maps from the JAX
    b5 init (shapes only, nothing computed)."""
    jcfg, tcfg = JC.cs2dsec_image_events_b5(), TC.cs2dsec_image_events_b5()
    jm = JFED(jcfg.model)
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), x, x, x, mode="fusion_all",
        method=jm.forward_logits))
    zeros = jax.tree.map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    with torch.device("meta"):
        tm = TFED(tcfg.model)
    want = match_state_dict(tm, jax_to_state_dict(zeros))
    # 3+6+40+3 blocks per encoder, all mapped from the scanned stages
    assert tuple(want["backbone_events.block3.39.attn.sr.weight"].shape) == (
        320, 320, 2, 2)
    assert sum(t.numel() for t in want.values()) == 201_322_643
