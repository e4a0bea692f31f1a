"""The port's fused upsample+CE (its plain version on the CPU, which the
CUDA kernels are held against on the card) against the JAX package's Pallas
kernel in interpret mode, values and gradients, at the shapes of
tests/test_pallas.py and at the edge geometries of the CUDA kernels' tiles.
The Pallas kernel's transposed shifts need two coarse rows and columns, so
at h = 1 or w = 1 the reference is the JAX package's XLA path,
``weighted_cross_entropy(resize_bilinear(...))``.

Tolerances: the loss to rtol 1e-5 (float32 sums of O(1) terms); dx and
dweight, which are O(1/N), to 1e-4 of the reference's largest magnitude."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cmda_tpu.ops.pallas_ce import fused_resize_ce as j_fused_resize_ce
from cmda_tpu_torch.ops.fused_ce import fused_resize_ce, resize_ce
from cmda_tpu_torch.ops.losses import pixel_accuracy, weighted_cross_entropy
from cmda_tpu.ops import losses as jlosses
from cmda_tpu.ops.resize import resize_bilinear as j_resize_bilinear

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


def _case(seed=0, b=2, h=6, w=10, c=5, fh=4, fw=4, ignored=True):
    g = np.random.default_rng(seed)
    x = g.normal(size=(b, h, w, c)).astype(np.float32)
    lbl = g.integers(0, c, size=(b, h * fh, w * fw)).astype(np.int32)
    if ignored:
        lbl[0, :3, :5] = 255
    wgt = g.uniform(0.2, 1.5, size=(b, h * fh, w * fw)).astype(np.float32)
    return x, lbl, wgt


def _jax(x, lbl, wgt):
    """JAX loss, d/dx and d/dweight (None without weight)."""
    def f(a, wt):
        return j_fused_resize_ce(a, jnp.asarray(lbl), wt, interpret=True)
    if wgt is None:
        loss, gx = jax.value_and_grad(lambda a: f(a, None))(jnp.asarray(x))
        return np.asarray(loss), np.asarray(gx), None
    loss, (gx, gw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(wgt))
    return np.asarray(loss), np.asarray(gx), np.asarray(gw)


def _xla(x, lbl, wgt):
    """The JAX package's unfused loss, d/dx and d/dweight."""
    def f(a, wt):
        return jlosses.weighted_cross_entropy(
            j_resize_bilinear(a, lbl.shape[1:3]), jnp.asarray(lbl), wt)
    loss, (gx, gw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(wgt))
    return np.asarray(loss), np.asarray(gx), np.asarray(gw)


def _torch(x, lbl, wgt):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = (torch.from_numpy(wgt).requires_grad_(True) if wgt is not None
          else None)
    loss = fused_resize_ce(xt, torch.from_numpy(lbl), wt)
    loss.backward()
    return (loss.detach().numpy(), xt.grad.numpy(),
            wt.grad.numpy() if wt is not None else None)


def _assert_rel(got, ref, what):
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= GRAD_REL * scale, (
        what, np.abs(got - ref).max(), scale)


@pytest.mark.parametrize("case", ["square_weighted", "square_no_weight",
                                  "nonsquare_3x4", "factor_1", "h1",
                                  "b1_w1", "fh2_fw3", "c7"])
def test_fused_resize_ce_matches_pallas(case):
    kw = {"square_weighted": {}, "square_no_weight": {},
          "nonsquare_3x4": dict(seed=2, fh=3, fw=4),
          "factor_1": dict(seed=3, fh=1, fw=1),
          "h1": dict(seed=6, h=1, w=6), "b1_w1": dict(seed=7, b=1, w=1),
          "fh2_fw3": dict(seed=8, fh=2, fw=3), "c7": dict(seed=9, c=7)}[case]
    x, lbl, wgt = _case(**kw)
    if case == "square_no_weight":
        wgt = None
    loss, gx, gw = _torch(x, lbl, wgt)
    reference = _xla if case in ("h1", "b1_w1") else _jax
    ref, rgx, rgw = reference(x, lbl, wgt)
    np.testing.assert_allclose(loss, ref, rtol=LOSS_RTOL)
    _assert_rel(gx, rgx, "dx")
    if wgt is not None:
        _assert_rel(gw, rgw, "dweight")


def test_fused_resize_ce_all_ignored_is_zero():
    x, lbl, wgt = _case(seed=4)
    lbl[:] = 255
    loss, gx, gw = _torch(x, lbl, wgt)
    assert float(loss) == 0.0
    assert np.abs(gx).max() == 0.0 and np.abs(gw).max() == 0.0
    ref, rgx, _ = _jax(x, lbl, wgt)
    assert float(ref) == 0.0 and np.abs(rgx).max() == 0.0


def test_fused_resize_ce_rejects_non_integer_geometry():
    x, _, _ = _case()
    with pytest.raises(ValueError, match="integer-factor"):
        fused_resize_ce(torch.from_numpy(x), torch.zeros(2, 25, 40,
                                                         dtype=torch.int32))
    # the plain version takes any geometry, as a caller's dispatch needs
    lbl = torch.zeros(2, 25, 40, dtype=torch.int32)
    assert torch.isfinite(resize_ce(torch.from_numpy(x), lbl))


def test_losses_match_jax_denominator_includes_ignored():
    """B*H*W denominator, ignored pixels included (not the valid count)."""
    g = np.random.default_rng(5)
    z = g.normal(size=(2, 8, 12, 5)).astype(np.float32)
    lbl = g.integers(0, 5, size=(2, 8, 12)).astype(np.int32)
    lbl[:, :4] = 255
    wgt = g.uniform(0.2, 1.5, size=(2, 8, 12)).astype(np.float32)
    got = {}
    for name, w in (("none", None), ("pixel", wgt)):
        got[name] = weighted_cross_entropy(
            torch.from_numpy(z), torch.from_numpy(lbl),
            None if w is None else torch.from_numpy(w))
        ref = jlosses.weighted_cross_entropy(
            jnp.asarray(z), jnp.asarray(lbl),
            None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(float(got[name]), float(ref),
                                   rtol=LOSS_RTOL)
    # torch's mean over the valid pixels is twice ours here (half ignored)
    valid_mean = torch.nn.functional.cross_entropy(
        torch.from_numpy(z).permute(0, 3, 1, 2), torch.from_numpy(lbl).long(),
        ignore_index=255)
    np.testing.assert_allclose(float(valid_mean), 2 * float(got["none"]),
                               rtol=LOSS_RTOL)
    acc = pixel_accuracy(torch.from_numpy(z), torch.from_numpy(lbl))
    np.testing.assert_allclose(
        float(acc), float(jlosses.pixel_accuracy(jnp.asarray(z),
                                                 jnp.asarray(lbl))),
        rtol=1e-6)
