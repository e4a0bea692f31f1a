"""CycleGAN training for the Image Content-Extractor (mirrors
cmda_tpu.uda.cyclegan_train).

The unpaired A <-> B recipe: two ResnetGenerators (``g_a``: A -> B, ``g_b``:
B -> A), two PatchGAN discriminators (``d_a`` judges domain B, ``d_b``
domain A), the LSGAN (or vanilla) objective, L1 cycle and identity losses,
the 50-image history pool of fakes, Adam(0.5, 0.999) with the linear-decay
epoch schedule. One ``train_step``:

  1. the generators' loss: fake_b = g_a(a), rec_a = g_b(fake_b),
     fake_a = g_b(b), rec_b = g_a(fake_a); with ``lambda_identity`` > 0
     also g_a(b) and g_b(a); the GAN terms read the discriminators as they
     were before this step, and the generators' backward leaves no gradient
     in them; Adam on both generators;
  2. the pool: ``pool_b`` is queried with the detached fake_b, then
     ``pool_a`` with fake_a, both at the fill count the step began with;
     the new count is ``pool_b``'s;
  3. the discriminators' loss 0.5 (D(real) vs 1 + D(pooled fake) vs 0) per
     discriminator; Adam on both.

Adam's update ``t`` (0-based) takes the schedule's lr at ``t``, as optax
counts. The pool's random choices are explicit (``CycleGANDraws``: for
each image whether a stored fake is played back and which), from a
``torch.Generator`` on the device seeded with (seed, step), or handed in.

Checkpoints are the JAX package's flat ``.npz``: the flax key paths
(``g_a/conv_in/kernel``, ``d_a/conv0/bias``, ...), HWIO kernels, float32,
and ``__step__``; a file written by either package loads in the other.
Images are NHWC in [-1, 1], as the JAX trainer takes them; the modules run
NCHW.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..apis import resolve_device
from ..models.cyclegan import (NLayerDiscriminator, PixelDiscriminator,
                               ResnetGenerator, gan_loss, init_generator)
from ..utils.weights import (cyclegan_to_tree, discriminator_to_tree)


@dataclass(frozen=True)
class CycleGANConfig:
    """The unpaired recipe's hyperparameters (junyanz defaults), as the JAX
    package's ``CycleGANConfig``."""
    input_nc: int = 1
    ngf: int = 64
    n_blocks: int = 9
    ndf: int = 64
    n_layers_d: int = 3
    netd: str = "patch"          # patch | pixel
    gan_mode: str = "lsgan"      # lsgan | vanilla
    lambda_a: float = 10.0
    lambda_b: float = 10.0
    lambda_identity: float = 0.5
    pool_size: int = 50
    lr: float = 2e-4
    beta1: float = 0.5
    n_epochs: int = 100
    n_epochs_decay: int = 100
    steps_per_epoch: int = 1000


def _linear_decay(cfg: CycleGANConfig):
    """step -> lr: ``cfg.lr`` for ``n_epochs`` epochs, then linear to 0 over
    ``n_epochs_decay`` (per-epoch steps), in float32 as the JAX schedule."""
    f32 = np.float32

    def sched(step: int) -> float:
        epoch = step // cfg.steps_per_epoch
        over = max(f32(0.0), f32(epoch) + f32(1.0) - f32(cfg.n_epochs))
        keep = max(f32(0.0), f32(1.0) - over / f32(cfg.n_epochs_decay + 1.0))
        return float(f32(cfg.lr) * keep)
    return sched


def patch_output_size(side: int, n_layers: int) -> int:
    """Side of the NLayerDiscriminator's prediction map for a square
    ``side`` input: ``n_layers`` k4 s2 p1 convs, then two k4 s1 p1 convs
    (-1 each). Below 1 the map is empty and its mean is NaN."""
    for _ in range(n_layers):
        side = (side - 2) // 2 + 1
    return side - 2


@dataclass
class CycleGANDraws:
    """The pool's choices of one step, per image [B]: ``use_old_*``
    (bool: play a stored fake back and store the incoming one in its
    place) and ``idx_*`` (int64 in [0, pool_size): which), for pool_a and
    pool_b. Read only once the pool is full."""
    use_old_a: torch.Tensor
    idx_a: torch.Tensor
    use_old_b: torch.Tensor
    idx_b: torch.Tensor

    def to(self, device) -> "CycleGANDraws":
        return CycleGANDraws(**{k: v.to(device)
                                for k, v in self.__dict__.items()})


def pool_query(pool: torch.Tensor, n_stored: int, imgs: torch.Tensor,
               use_old: torch.Tensor, idx: torch.Tensor):
    """junyanz ``ImagePool.query``, one image after another: while the pool
    holds fewer than its capacity, store the image and return it; once
    full, where ``use_old[i]`` return the stored image ``idx[i]`` and store
    the incoming one there, else return the incoming image. ``pool``
    [cap, ...] is updated in place. Returns (n_stored, out, picked):
    ``picked`` [B] int64, the slot played back or -1 for the incoming
    image. The choices stay on the device (no host read)."""
    cap = pool.shape[0]
    out, picked = [], []
    minus1 = torch.full((), -1, dtype=torch.int64, device=pool.device)
    for i in range(imgs.shape[0]):
        img = imgs[i]
        if n_stored < cap:
            pool[n_stored] = img
            n_stored += 1
            out.append(img)
            picked.append(minus1)
            continue
        slot = idx[i].reshape(1).to(torch.int64)
        old = pool.index_select(0, slot)[0]
        pool.index_copy_(0, slot, torch.where(use_old[i], img, old)[None])
        out.append(torch.where(use_old[i], old, img))
        picked.append(torch.where(use_old[i], slot[0], minus1))
    return n_stored, torch.stack(out), torch.stack(picked)


@dataclass
class CycleGANTrainState:
    """The two generators and discriminators, their Adam optimizers, the
    two pools of fakes (NCHW, on the device), the pool's fill count and
    the number of steps taken. ``train_step`` updates it in place."""
    g_a: ResnetGenerator
    g_b: ResnetGenerator
    d_a: torch.nn.Module
    d_b: torch.nn.Module
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    pool_a: torch.Tensor
    pool_b: torch.Tensor
    pool_n: int = 0
    step: int = 0


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


class CycleGANTrainer:
    """The CycleGAN step of a ``CycleGANConfig`` on ``device`` (cuda unless
    the caller asks for the CPU); ``seed`` seeds the pool's draws."""

    def __init__(self, cfg: CycleGANConfig, device="cuda", seed: int = 0):
        if cfg.netd not in ("patch", "pixel"):
            raise ValueError(f"netd must be patch|pixel, got {cfg.netd!r}")
        if cfg.gan_mode not in ("lsgan", "vanilla"):
            raise ValueError("gan_mode must be lsgan|vanilla for training "
                             f"(wgangp needs a critic loop), got "
                             f"{cfg.gan_mode!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = seed
        self.sched = _linear_decay(cfg)

    def _discriminator(self):
        c = self.cfg
        if c.netd == "patch":
            return NLayerDiscriminator(c.input_nc, c.ndf, c.n_layers_d)
        return PixelDiscriminator(c.input_nc, c.ndf)

    def init_state(self, seed: int, image_shape) -> CycleGANTrainState:
        """Random N(0, 0.02) weights with zero biases (the pix2pix 'normal'
        init) from ``seed``, for (H, W) images; the pools zeros."""
        cfg = self.cfg
        h, w = image_shape
        if cfg.netd == "patch":
            po = patch_output_size(min(h, w), cfg.n_layers_d)
            if po < 1:
                raise ValueError(
                    f"crop {h}x{w} collapses to an empty {cfg.n_layers_d}-"
                    f"layer PatchGAN map ({po}); use a larger crop or "
                    "smaller n_layers_d")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        with torch.device(self.device):
            nets = [ResnetGenerator(cfg.input_nc, cfg.input_nc, cfg.ngf,
                                    cfg.n_blocks),
                    ResnetGenerator(cfg.input_nc, cfg.input_nc, cfg.ngf,
                                    cfg.n_blocks),
                    self._discriminator(), self._discriminator()]
            pool = torch.zeros((max(cfg.pool_size, 1), cfg.input_nc, h, w))
        for net in nets:
            init_generator(net, gen)
        return self.state_from(*nets, pool=pool)

    def state_from(self, g_a, g_b, d_a, d_b, pool=None, step: int = 0,
                   pool_n: int = 0) -> CycleGANTrainState:
        """A train state around given networks (fresh Adam state)."""
        def adam(*nets):
            return torch.optim.Adam(
                [p for n in nets for p in n.parameters()], lr=self.cfg.lr,
                betas=(self.cfg.beta1, 0.999), eps=1e-8)
        return CycleGANTrainState(
            g_a=g_a, g_b=g_b, d_a=d_a, d_b=d_b, g_opt=adam(g_a, g_b),
            d_opt=adam(d_a, d_b), pool_a=pool, pool_b=pool.clone(),
            pool_n=pool_n, step=step)

    def new_draws(self, state: CycleGANTrainState,
                  batch: int) -> CycleGANDraws:
        """The pool's draws of step ``state.step`` from a generator on the
        device seeded with (seed, step)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed * 1_000_003 + state.step)
        cap = state.pool_a.shape[0]

        def pick():
            return (torch.rand((batch,), generator=gen, device=self.device)
                    > 0.5,
                    torch.randint(0, cap, (batch,), generator=gen,
                                  device=self.device))
        (ua, ia), (ub, ib) = pick(), pick()
        return CycleGANDraws(use_old_a=ua, idx_a=ia, use_old_b=ub, idx_b=ib)

    def _set_lr(self, state):
        lr = self.sched(state.step)
        for opt in (state.g_opt, state.d_opt):
            for group in opt.param_groups:
                group["lr"] = lr

    def train_step(self, state: CycleGANTrainState, real_a, real_b,
                   draws: CycleGANDraws | None = None):
        """One iteration on NHWC batches ``real_a``, ``real_b`` in [-1, 1]
        (numpy arrays or tensors): the generators' joint update, then the
        discriminators' on the pooled fakes. Returns (state, logs), the logs
        0-dim tensors on the device, and keeps the pool's choices of the
        step in ``self.last_picked`` ({'a', 'b'}: [B] int64)."""
        cfg = self.cfg
        real_a = _nchw(torch.as_tensor(real_a, device=self.device).float())
        real_b = _nchw(torch.as_tensor(real_b, device=self.device).float())
        if draws is None:
            draws = self.new_draws(state, real_a.shape[0])
        self._set_lr(state)
        nets_d = (state.d_a, state.d_b)
        for d in nets_d:
            d.requires_grad_(False)
        state.g_opt.zero_grad(set_to_none=True)
        fake_b = state.g_a(real_a)
        rec_a = state.g_b(fake_b)
        fake_a = state.g_b(real_b)
        rec_b = state.g_a(fake_a)
        logs = {}
        loss = 0.0
        if cfg.lambda_identity > 0:
            idt_a = state.g_a(real_b)
            idt_b = state.g_b(real_a)
            l_idt_a = ((idt_a - real_b).abs().mean() * cfg.lambda_b
                       * cfg.lambda_identity)
            l_idt_b = ((idt_b - real_a).abs().mean() * cfg.lambda_a
                       * cfg.lambda_identity)
            logs.update(idt_a=l_idt_a, idt_b=l_idt_b)
            loss = loss + l_idt_a + l_idt_b
        l_g_a = gan_loss(state.d_a(fake_b), True, cfg.gan_mode)
        l_g_b = gan_loss(state.d_b(fake_a), True, cfg.gan_mode)
        l_cyc_a = (rec_a - real_a).abs().mean() * cfg.lambda_a
        l_cyc_b = (rec_b - real_b).abs().mean() * cfg.lambda_b
        loss = loss + l_g_a + l_g_b + l_cyc_a + l_cyc_b
        logs.update(g_a=l_g_a, g_b=l_g_b, cycle_a=l_cyc_a, cycle_b=l_cyc_b,
                    loss_g=loss)
        loss.backward()
        state.g_opt.step()
        for d in nets_d:
            d.requires_grad_(True)

        n0 = state.pool_n
        state.pool_n, fake_b_d, picked_b = pool_query(
            state.pool_b, n0, fake_b.detach(), draws.use_old_b, draws.idx_b)
        _, fake_a_d, picked_a = pool_query(
            state.pool_a, n0, fake_a.detach(), draws.use_old_a, draws.idx_a)
        self.last_picked = {"a": picked_a, "b": picked_b}

        state.d_opt.zero_grad(set_to_none=True)

        def one(net, real, fake):
            return 0.5 * (gan_loss(net(real), True, cfg.gan_mode)
                          + gan_loss(net(fake), False, cfg.gan_mode))
        l_d_a = one(state.d_a, real_b, fake_b_d)
        l_d_b = one(state.d_b, real_a, fake_a_d)
        loss_d = l_d_a + l_d_b
        loss_d.backward()
        state.d_opt.step()
        state.step += 1
        logs.update(d_a=l_d_a, d_b=l_d_b, loss_d=loss_d)
        return state, {k: v.detach() for k, v in logs.items()}

    @torch.no_grad()
    def generate(self, state: CycleGANTrainState, x, direction: str = "a2b"):
        """``g_a`` (a2b) or ``g_b`` (b2a) on NHWC ``x``; NHWC out."""
        net = state.g_a if direction == "a2b" else state.g_b
        x = _nchw(torch.as_tensor(x, device=self.device).float())
        return net(x).permute(0, 2, 3, 1)


# ----------------------------------------------------------------------
# the JAX package's flat-npz checkpoints
# ----------------------------------------------------------------------
def _flatten(tree, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(path: str, state: CycleGANTrainState):
    """The flat npz of the JAX ``save_checkpoint``: ``g_a/...``,
    ``g_b/...``, ``d_a/...``, ``d_b/...`` (flax paths, HWIO kernels) and
    ``__step__`` (int32)."""
    flat = {}
    for name, net, to_tree in (("g_a", state.g_a, cyclegan_to_tree),
                               ("g_b", state.g_b, cyclegan_to_tree),
                               ("d_a", state.d_a, discriminator_to_tree),
                               ("d_b", state.d_b, discriminator_to_tree)):
        flat.update(_flatten(to_tree(net.state_dict()), name))
    flat["__step__"] = np.asarray(state.step, np.int32)
    np.savez(path, **flat)


def load_generator_npz(path: str, which: str = "g_a") -> dict:
    """One generator's flax params tree (numpy) from a trainer npz of
    either package (default ``g_a``, the A -> B direction: ICD -> EN when
    A is the day IC crops); ``cyclegan_to_state_dict`` makes it the
    reference state_dict."""
    with np.load(path) as z:
        flat = {k[len(which) + 1:]: z[k] for k in z.files
                if k.startswith(which + "/")}
    if not flat:
        raise ValueError(f"{path} holds no {which!r} generator params")
    return _unflatten(flat)
