"""CycleGAN ResnetGenerator, inference only (mirrors
cmda_tpu.models.cyclegan.ResnetGenerator).

The frozen "Image Content-Extractor" that turns the source temporal
difference into night-event style day events: reflect-pad 7x7 conv -> two
stride-2 downs -> ``n_blocks`` residual blocks (reflect-pad 3x3 convs) -> two
transposed-conv ups (k3 s2 p1 output_padding 1) -> reflect-pad 7x7 conv ->
tanh, instance norm (eps 1e-5, no affine, no running statistics) after every
conv but the last. NCHW.

Parameter names are the reference (pix2pix) ``nn.Sequential`` keys:
``model.1`` (conv_in), ``model.4`` / ``model.7`` (downs),
``model.{10+i}.conv_block.1`` / ``.5`` (block i), then the ups and the
output conv at the indices that follow.
"""
from __future__ import annotations

import torch
import torch.nn as nn


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
def init_generator(gen: ResnetGenerator, generator: torch.Generator):
    """Random weights N(0, 0.02) with zero biases (the pix2pix 'normal'
    init), drawn from ``generator`` in module order."""
    for m in gen.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
    return gen
