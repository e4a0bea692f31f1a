"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's Pallas kernels in interpret mode and its XLA compositions.

The CUDA kernels themselves run only on the GPU; ``chip_smoke.py`` holds
them against these same plain versions there."""
import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from cmda_tpu.data.host_isr import host_image_change_numpy
from cmda_tpu.ops import isr as jisr
from cmda_tpu.ops import pallas_ce as jce
from cmda_tpu.ops.pallas_kernels import pallas_batched_isr
from cmda_tpu.ops.resize import resize_bilinear as j_resize_bilinear
from cmda_tpu.ops.resize import resize_nearest as j_resize_nearest
from cmda_tpu_torch.ops import isr as tisr
from cmda_tpu_torch.ops.fused_resize import fused_resize_argmax
from cmda_tpu_torch.ops.isr_kernel import batched_isr
from cmda_tpu_torch.ops.resize import resize_bilinear, resize_nearest

from torch_port_util import assert_labels_match

# ---------------------------------------------------------------------------
# fused upsample + argmax / max-softmax
# ---------------------------------------------------------------------------
# Tolerance: prob to 1e-5 absolute (float32 softmax of O(1) logits); labels
# equal except where the top-2 margin is < 1e-5 (rounding may break a tie).

ARGMAX_CASES = {
    "square_x4": ((2, 6, 10, 5), (24, 40)),
    "nonsquare_3x4": ((2, 6, 10, 5), (12, 40)),
    "factor_1": ((1, 5, 7, 19), (5, 7)),
    "serving_like": ((1, 11, 16, 19), (44, 64)),
    # the edge geometries the CUDA kernel's tiles meet: both clamps on one
    # coarse pixel, one of them, a 2x3 factor, one image, a narrow C = 150
    "h1_w1": ((2, 1, 1, 5), (4, 4)),
    "h1": ((2, 1, 9, 5), (4, 36)),
    "w1": ((2, 7, 1, 5), (28, 4)),
    "fh2_fw3": ((2, 6, 10, 5), (12, 30)),
    "b1": ((1, 6, 10, 5), (24, 40)),
    "c150": ((1, 3, 4, 150), (12, 16)),
}


@pytest.mark.parametrize("with_prob", [True, False])
@pytest.mark.parametrize("case", sorted(ARGMAX_CASES))
def test_fused_resize_argmax_matches_pallas_and_xla(case, with_prob):
    shape, out_size = ARGMAX_CASES[case]
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    label, prob = fused_resize_argmax(torch.from_numpy(x), out_size,
                                      with_prob=with_prob)
    assert label.dtype == torch.int32 and tuple(label.shape) == (
        shape[0],) + out_size
    big = np.asarray(j_resize_bilinear(jnp.asarray(x), out_size))
    assert_labels_match(label.numpy(), np.argmax(big, axis=-1), big, 1e-5)
    p_label, p_prob = jce.fused_resize_argmax(
        jnp.asarray(x), out_size, with_prob=with_prob, interpret=True)
    assert_labels_match(label.numpy(), np.asarray(p_label), big, 1e-5)
    if with_prob:
        np.testing.assert_allclose(prob.numpy(), np.asarray(p_prob),
                                   atol=1e-5)
        ref = np.exp(big - big.max(-1, keepdims=True))
        np.testing.assert_allclose(prob.numpy(), 1.0 / ref.sum(-1),
                                   atol=1e-5)
    else:
        assert prob is None and p_prob is None


def test_fused_resize_argmax_ties_go_to_first_class():
    x = torch.full((2, 6, 10, 5), 0.25)
    label, prob = fused_resize_argmax(x, (24, 40))
    assert int(label.abs().sum()) == 0
    np.testing.assert_allclose(prob.numpy(), 0.2, atol=1e-6)
    p_label, _ = jce.fused_resize_argmax(jnp.asarray(x.numpy()), (24, 40),
                                         interpret=True)
    assert int(np.abs(np.asarray(p_label)).sum()) == 0


def test_fused_resize_argmax_rejects_non_integer_geometry():
    with pytest.raises(ValueError, match="integer-factor"):
        fused_resize_argmax(torch.zeros(1, 6, 10, 3), (25, 40))


# ---------------------------------------------------------------------------
# ISR: grayscale, image_change_from_gray, the batched wrapper
# ---------------------------------------------------------------------------
# Tolerance: 1e-5 absolute on values in [-1, 1] (float32 logs). The dead
# zone |d| <= thr could flip a pixel where d lands within rounding of thr;
# such a flip would show here as a large single-pixel error, not be hidden.

PRESETS = {
    "cs2dsec": dict(val_range=(0.01, 1.01), threshold=0.005, clip_range=0.1),
    "cs2dz": dict(val_range=(1.0, 100.0), threshold=0.01, clip_range=0.1),
}


def _gray(seed, b=3, h=24, w=40):
    g = np.random.default_rng(seed)
    # integer gray levels, as the PIL grayscale gives them, with smooth
    # regions so the dead zone and both clips are all exercised
    base = g.integers(0, 256, size=(b, 1, 1)) + np.cumsum(
        g.integers(-3, 4, size=(b, h, w)), axis=2)
    return np.clip(base, 0, 255).astype(np.float32)


# (preset, shift, [B, H, W]): four images at 24x40 (every direction), and
# the edge geometries the CUDA kernel meets: one image, W = shift + 1 (one
# column the shift reaches, the rest keep their value) and one row (the
# shift may not exceed H, so shift 1 only)
ISR_CASES = [
    pytest.param(preset, shift, (4, 24, 40), id=f"{preset}-{shift}")
    for preset in sorted(PRESETS) for shift in (1, 3)] + [
    pytest.param(preset, shift, geom, id=f"{preset}-{shift}-{name}")
    for preset in sorted(PRESETS) for shift in (1, 3)
    for name, geom in (("b1", (1, 24, 40)),
                       ("w_shift_plus_1", (4, 24, shift + 1)))] + [
    pytest.param(preset, 1, (4, 1, 40), id=f"{preset}-1-h1")
    for preset in sorted(PRESETS)]


@pytest.mark.parametrize("preset,shift,geom", ISR_CASES)
def test_batched_isr_matches_pallas_and_jnp(preset, shift, geom):
    params = PRESETS[preset]
    b, h, w = geom
    gray = _gray(1, b=b, h=h, w=w)
    dirs = np.arange(b, dtype=np.int32) % 4
    out = batched_isr(torch.from_numpy(gray), torch.from_numpy(dirs),
                      shift_pixel=shift, **params).numpy()
    pal = np.asarray(pallas_batched_isr(jnp.asarray(gray), jnp.asarray(dirs),
                                        shift_pixel=shift, interpret=True,
                                        **params))
    np.testing.assert_allclose(out, pal, atol=1e-5)
    for i, d in enumerate(dirs):
        ref = jisr.image_change_from_gray(
            jnp.asarray(gray[i]), shift_pixel=shift, shift_direction=None,
            direction_idx=jnp.asarray(d), **params)
        np.testing.assert_allclose(out[i], np.asarray(ref), atol=1e-5)
        host = host_image_change_numpy(
            gray[i], shift_pixel=shift,
            shift_direction=tisr.SHIFT_DIRECTIONS[d], **params)
        np.testing.assert_allclose(out[i], host, atol=1e-5)


@pytest.mark.parametrize("direction", ["all", "rightdown", "leftup"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_image_change_from_gray_named_directions(preset, direction):
    params = PRESETS[preset]
    gray = _gray(2, b=1)[0]
    out = tisr.image_change_from_gray(
        torch.from_numpy(gray), shift_pixel=3, shift_direction=direction,
        **params).numpy()
    ref = jisr.image_change_from_gray(jnp.asarray(gray), shift_pixel=3,
                                      shift_direction=direction, **params)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)
    host = host_image_change_numpy(gray, shift_pixel=3,
                                   shift_direction=direction, **params)
    np.testing.assert_allclose(out, host, atol=1e-5)


def test_pil_grayscale_bit_exact():
    rgb = np.random.default_rng(3).integers(0, 256, size=(17, 23, 3),
                                            dtype=np.uint8)
    rgb[0, :3] = [[0, 0, 0], [255, 255, 255], [255, 0, 128]]
    ours = tisr.pil_grayscale(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(ours,
                                  np.asarray(jisr.pil_grayscale(rgb)))
    np.testing.assert_array_equal(ours,
                                  np.asarray(Image.fromarray(rgb).convert("L")))


def test_image_to_isr_matches_jax():
    rgb01 = np.random.default_rng(4).random((20, 28, 3)).astype(np.float32)
    params = PRESETS["cs2dsec"]
    ours = tisr.image_to_isr(torch.from_numpy(rgb01), **params).numpy()
    ref = jisr.image_to_isr(jnp.asarray(rgb01), **params)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("size", [(24, 40), (13, 7), (5, 9)])
def test_resize_matches_jax(size):
    x = np.random.default_rng(5).normal(size=(2, 9, 11, 4)).astype(np.float32)
    np.testing.assert_allclose(
        resize_bilinear(torch.from_numpy(x), size).numpy(),
        np.asarray(j_resize_bilinear(jnp.asarray(x), size)), atol=1e-5)
    lbl = np.random.default_rng(6).integers(0, 19, size=(2, 9, 11))
    np.testing.assert_array_equal(
        resize_nearest(torch.from_numpy(lbl), size).numpy(),
        np.asarray(j_resize_nearest(jnp.asarray(lbl), size)))
