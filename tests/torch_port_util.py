"""Shared helpers of the tests that hold cmda_tpu_torch against cmda_tpu:
seeded numpy weights for a JAX module and the near-tie rule for argmax
comparisons."""
import numpy as np
import jax


def random_variables(init_fn, seed=0):
    """Seeded numpy values for every leaf of ``jax.eval_shape(init_fn)``:
    kernels ~ N(0, 1/fan_in), biases and BN means ~ N(0, 0.1^2), norm
    scales ~ 1 + N(0, 0.1^2), BN variances ~ U(0.5, 1.5). Nothing is
    compiled; stacked (scanned) stages get the leading depth axis."""
    g = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn)

    def fill(path, s):
        names = [str(getattr(k, "key", k)) for k in path]
        shape, leaf = s.shape, names[-1]
        stacked = any(n.startswith("blocks") for n in names)
        core = shape[1:] if stacked else shape
        if leaf == "kernel":
            fan_in = int(np.prod(core[:-1]))
            v = g.normal(size=shape) / np.sqrt(fan_in)
        elif leaf == "scale":
            v = 1.0 + 0.1 * g.normal(size=shape)
        elif leaf == "var":
            v = g.uniform(0.5, 1.5, size=shape)
        else:
            v = 0.1 * g.normal(size=shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_labels_match(label, ref_label, logits, margin):
    """``label == ref_label`` except where the top-2 margin of ``logits``
    (the class axis last) is below ``margin``: a near tie that float
    rounding may break either way."""
    label, ref_label = np.asarray(label), np.asarray(ref_label)
    bad = label != ref_label
    if not bad.any():
        return
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    gap = (top2[..., 1] - top2[..., 0])[bad]
    assert gap.max() < margin, (
        f"{bad.sum()} labels differ, top-2 margins up to {gap.max()}")
