"""CycleGAN networks (mirrors cmda_tpu.models.cyclegan): the
ResnetGenerator, the PatchGAN and pixel discriminators, the GAN objectives
and the WGAN-GP penalty.

The generator is the frozen "Image Content-Extractor" that turns the source temporal
difference into night-event style day events: reflect-pad 7x7 conv -> two
stride-2 downs -> ``n_blocks`` residual blocks (reflect-pad 3x3 convs) -> two
transposed-conv ups (k3 s2 p1 output_padding 1) -> reflect-pad 7x7 conv ->
tanh, instance norm (eps 1e-5, no affine, no running statistics) after every
conv but the last. NCHW.

The CycleGAN trainer (``uda/cyclegan_train.py``) trains two generators
against two discriminators. Parameter names are the reference (pix2pix)
``nn.Sequential`` keys; the generator's are
``model.1`` (conv_in), ``model.4`` / ``model.7`` (downs),
``model.{10+i}.conv_block.1`` / ``.5`` (block i), then the ups and the
output conv at the indices that follow.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class ResnetBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3),
            nn.InstanceNorm2d(dim), nn.ReLU(),
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3),
            nn.InstanceNorm2d(dim))

    def forward(self, x):
        return x + self.conv_block(x)


class ResnetGenerator(nn.Module):
    """reflect 7x7 -> 2 downs -> n_blocks res -> 2 ups -> reflect 7x7 ->
    tanh, instance-norm variant (the flagship's 1ch -> 1ch, 9 blocks)."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1, ngf: int = 64,
                 n_blocks: int = 9):
        super().__init__()
        layers = [nn.ReflectionPad2d(3), nn.Conv2d(input_nc, ngf, 7),
                  nn.InstanceNorm2d(ngf), nn.ReLU()]
        for i in range(2):
            mult = 2 ** i
            layers += [nn.Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2,
                                 padding=1),
                       nn.InstanceNorm2d(ngf * mult * 2), nn.ReLU()]
        layers += [ResnetBlock(ngf * 4) for _ in range(n_blocks)]
        for i in range(2):
            mult = 2 ** (2 - i)
            layers += [nn.ConvTranspose2d(ngf * mult, ngf * mult // 2, 3,
                                          stride=2, padding=1,
                                          output_padding=1),
                       nn.InstanceNorm2d(ngf * mult // 2), nn.ReLU()]
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7),
                   nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


def generator_from_params(sd: dict) -> ResnetGenerator:
    """A ResnetGenerator sized from its weights (reference keys): ngf and
    input_nc from ``model.1.weight``, n_blocks by counting the blocks'
    ``conv_block.1.weight`` keys, output_nc from the last conv's bias."""
    ngf, input_nc = (int(n) for n in sd["model.1.weight"].shape[:2])
    n_blocks = sum(1 for k in sd if k.endswith("conv_block.1.weight"))
    out_idx = 10 + n_blocks + 6 + 1
    output_nc = int(sd[f"model.{out_idx}.bias"].shape[0])
    return ResnetGenerator(input_nc, output_nc, ngf, n_blocks)


@torch.no_grad()
def init_generator(gen: nn.Module, generator: torch.Generator):
    """Random conv weights N(0, 0.02) with zero biases (the pix2pix
    'normal' init) of a generator or discriminator, drawn from
    ``generator`` in module order."""
    for m in gen.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
    return gen


def frozen_generator(state_dict: dict | None = None, *, channels: int = 1,
                     device="cpu", seed: int = 0) -> ResnetGenerator:
    """A frozen generator on ``device``, in eval mode without gradients:
    from ``state_dict`` (reference keys, sized from it), or a random
    ``channels`` -> ``channels`` ngf-64 9-block one drawn from ``seed``."""
    with torch.device(device):
        if state_dict is not None:
            gen = generator_from_params(state_dict)
            gen.load_state_dict({k: torch.as_tensor(v)
                                 for k, v in state_dict.items()})
        else:
            g = torch.Generator(device=device)
            g.manual_seed(seed)
            gen = init_generator(ResnetGenerator(channels, channels), g)
    return gen.eval().requires_grad_(False)

class NLayerDiscriminator(nn.Module):
    """The 4x4 stride-2 PatchGAN (mirrors cmda_tpu.models.cyclegan.
    NLayerDiscriminator, instance norm): conv (bias) + LeakyReLU(0.2), then
    ``n_layers - 1`` strided convs and one stride-1 conv, each with instance
    norm and LeakyReLU, then a 1-channel conv (bias). The convs before an
    instance norm keep their bias, as in the JAX module. Keys are the
    reference (pix2pix) ``model.{i}``: 0, 2, 5, ... for n_layers 3 ``model.0
    / .2 / .5 / .8 / .11``."""

    def __init__(self, input_nc: int = 1, ndf: int = 64, n_layers: int = 3,
                 norm: str = "instance"):
        super().__init__()
        if norm != "instance":
            raise NotImplementedError(
                f"NLayerDiscriminator norm={norm!r}: only instance norm is "
                "ported (the CycleGAN trainer's)")
        layers = [nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1),
                  nn.LeakyReLU(0.2)]
        nf = 1
        for n in range(1, n_layers):
            nf_prev, nf = nf, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * nf_prev, ndf * nf, 4, stride=2,
                                 padding=1),
                       nn.InstanceNorm2d(ndf * nf), nn.LeakyReLU(0.2)]
        nf_prev, nf = nf, min(2 ** n_layers, 8)
        layers += [nn.Conv2d(ndf * nf_prev, ndf * nf, 4, stride=1, padding=1),
                   nn.InstanceNorm2d(ndf * nf), nn.LeakyReLU(0.2),
                   nn.Conv2d(ndf * nf, 1, 4, stride=1, padding=1)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


class PixelDiscriminator(nn.Module):
    """The 1x1 PatchGAN (mirrors cmda_tpu.models.cyclegan.
    PixelDiscriminator, instance norm): keys ``net.0``, ``net.2``,
    ``net.5``, every conv with a bias."""

    def __init__(self, input_nc: int = 1, ndf: int = 64,
                 norm: str = "instance"):
        super().__init__()
        if norm != "instance":
            raise NotImplementedError(
                f"PixelDiscriminator norm={norm!r}: only instance norm is "
                "ported (the CycleGAN trainer's)")
        self.net = nn.Sequential(
            nn.Conv2d(input_nc, ndf, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(ndf, ndf * 2, 1), nn.InstanceNorm2d(ndf * 2),
            nn.LeakyReLU(0.2), nn.Conv2d(ndf * 2, 1, 1))

    def forward(self, x):
        return self.net(x)


def gan_loss(prediction: torch.Tensor, target_is_real: bool,
             mode: str = "lsgan") -> torch.Tensor:
    """lsgan: the mean squared distance to the 0/1 target; vanilla: BCE
    with logits; wgangp: -mean for real, mean for fake."""
    if mode == "lsgan":
        target = 1.0 if target_is_real else 0.0
        return ((prediction - target) ** 2).mean()
    if mode == "vanilla":
        target = 1.0 if target_is_real else 0.0
        logp = F.logsigmoid(prediction)
        log1mp = F.logsigmoid(-prediction)
        return -(target * logp + (1 - target) * log1mp).mean()
    if mode == "wgangp":
        return -prediction.mean() if target_is_real else prediction.mean()
    raise NotImplementedError(mode)


def gradient_penalty(critic, real: torch.Tensor, fake: torch.Tensor, *,
                     kind: str = "mixed", constant: float = 1.0,
                     lambda_gp: float = 10.0,
                     alpha: torch.Tensor | None = None) -> torch.Tensor:
    """The WGAN-GP penalty lambda * mean((||d critic / d x||_2 - c)^2) per
    sample, at ``real``, ``fake`` or (``kind='mixed'``) alpha * real +
    (1 - alpha) * fake with ``alpha`` [B] handed in (the JAX function draws
    it from its key). The gradient keeps its graph
    (``create_graph=True``), so the penalty trains the critic."""
    if lambda_gp <= 0.0:
        return torch.zeros((), device=real.device)
    if kind == "real":
        x = real
    elif kind == "fake":
        x = fake
    elif kind == "mixed":
        if alpha is None:
            raise ValueError("kind='mixed' needs alpha [B]")
        a = alpha.reshape((-1,) + (1,) * (real.ndim - 1)).to(real.dtype)
        x = a * real + (1.0 - a) * fake
    else:
        raise NotImplementedError(kind)
    x = x.detach().requires_grad_(True)
    # the sum over outputs: grad_outputs of ones, as in the reference
    (grads,) = torch.autograd.grad(critic(x).sum(), x, create_graph=True)
    norms = torch.linalg.vector_norm(grads.reshape(x.shape[0], -1) + 1e-16,
                                     dim=1)
    return lambda_gp * ((norms - constant) ** 2).mean()
