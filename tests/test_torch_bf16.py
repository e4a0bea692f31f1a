"""bfloat16 serving of the port against the JAX package's bfloat16 mode: the
micro FusionEncoderDecoder on the same seeded weights and inputs, each
package in its own ``dtype='bfloat16'``.

The JAX modules cast their inputs to the module dtype and hand bfloat16
activations on, keeping only the qk softmax, the norm statistics and the
classifier in float32; the port's layers compute in the dtype they are
handed, so its residual stream and pyramids are bfloat16 too (checked).

Tolerance: the two packages round to bfloat16 at different points (XLA on
the CPU fuses elementwise chains in float32 and drops the casts between
them; PyTorch rounds after each op), so their logits differ by a few
bfloat16 units of the last place, which the layers carry on. Measured at
this size: 1.05e-2 of max|logit| (1.4 x 2^-7), about as far as the JAX
package's own bfloat16 logits are from its float32 ones (0.93e-2). The
logits are held to 2^-6 of max|logit|; the labels must agree on at least
99% of the pixels and differ only where the top-2 margin is below twice
that tolerance.

64x64 inputs: at 32x32 the stride-4 stage map is 8x8, its sr-8 conv has a
1x1 output, and PyTorch's CPU bfloat16 convolution of a channels-last input
of that shape is wrong (off by the size of its output) in the installed
version; from 2x2 outputs up it is right."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from cmda_tpu import config as JC
from cmda_tpu.models.segmentor import FusionEncoderDecoder as JFED
from cmda_tpu_torch import config as TC
from cmda_tpu_torch.models.segmentor import FusionEncoderDecoder as TFED
from cmda_tpu_torch.utils.weights import load_jax_variables

from torch_port_util import assert_labels_match, random_variables

LOGIT_REL = 2.0 ** -6
MIN_AGREEMENT = 0.99


def test_bf16_serving_forward_matches_jax_bf16():
    g = np.random.default_rng(7)
    image, events = [g.normal(size=(2, 64, 64, 3)).astype(np.float32)
                     for _ in range(2)]
    jm = JFED(JC.micro_test_config().model, dtype=jnp.bfloat16)
    v = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), image, events, events, mode="fusion_all",
        method=jm.forward_logits), seed=11)
    ref = jax.jit(lambda v, a, b: jm.apply(
        v, a, b, method=jm.forward_logits)["fusion_output"])(v, image, events)
    ref = np.asarray(ref.astype(jnp.float32))

    tm = load_jax_variables(
        TFED(TC.micro_test_config().model, dtype="bfloat16").eval(), v)
    with torch.no_grad():
        out, feats = tm.forward_logits(torch.from_numpy(image),
                                       torch.from_numpy(events),
                                       return_feats=True)
    logits = out["fusion_output"]
    assert logits.dtype == torch.float32 and logits.shape == (2, 64, 64, 19)
    assert all(f.dtype == torch.bfloat16
               for k in ("f_image", "f_events", "f_fusion") for f in feats[k])
    logits = logits.numpy()
    scale = np.abs(ref).max()
    assert np.abs(logits - ref).max() <= LOGIT_REL * scale
    agreement = (logits.argmax(-1) == ref.argmax(-1)).mean()
    assert agreement >= MIN_AGREEMENT, agreement
    assert_labels_match(logits.argmax(-1), ref.argmax(-1), ref,
                        2 * LOGIT_REL * scale)
