"""Conv + BatchNorm + ReLU blocks (2D and 3D) and the transposed 3D block.

Counterpart of wildmvs/nn/blocks.py:231-564 (reference
models/MVSNet/module.py:21-48, model.py:57-70), unpacked math only: the JAX
package's depth-packed, space-to-depth and conv3d-via-2D forms are TPU
layouts of the same math and have no counterpart here. BatchNorm uses eps
1e-5 and momentum 0.1, torch's defaults. Attribute names reproduce the
reference state_dict keys (`<block>.conv.weight`, `<block>.bn.*`; the
transposed block is a Sequential, so `<block>.0.weight`, `<block>.1.*`).

Tensors are torch's NC(D)HW; the model keeps them in channels-last memory.
"""
from __future__ import annotations

import torch
from torch import nn

CONVS = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)


class ConvBnReLU(nn.Module):
    """Conv (no bias) -> BN -> ReLU, 2D or 3D."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, pad: int = 1,
                 dim: int = 2):
        super().__init__()
        conv = {2: nn.Conv2d, 3: nn.Conv3d}[dim]
        bn = {2: nn.BatchNorm2d, 3: nn.BatchNorm3d}[dim]
        self.conv = conv(in_channels, out_channels, kernel_size, stride, pad,
                         bias=False)
        self.bn = bn(out_channels, eps=1e-5, momentum=0.1)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class ConvTransposeBnReLU(nn.Sequential):
    """ConvTranspose3d (stride 2, padding 1, output_padding 1, no bias) ->
    BN -> ReLU, as the reference's nn.Sequential."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 2, pad: int = 1,
                 output_padding: int = 1):
        super().__init__(
            nn.ConvTranspose3d(in_channels, out_channels, kernel_size,
                               stride=stride, padding=pad,
                               output_padding=output_padding, bias=False),
            nn.BatchNorm3d(out_channels, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=True))


def cast_convs(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every convolution's weights to `dtype`, leaving BatchNorm in
    f32: the counterpart of flax's `dtype=bf16`, where a conv computes in
    bf16 and BN normalizes in f32 and returns the input dtype."""
    for m in module.modules():
        if isinstance(m, CONVS):
            m.to(dtype)
    return module


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: He-normal conv weights (std sqrt(2 /
    fan_in), which keeps activations at unit scale through the ReLUs),
    zero biases, identity BatchNorm (weight 1, bias 0, running mean 0,
    variance 1). Values are drawn on the CPU from `generator`."""
    for m in module.modules():
        if isinstance(m, CONVS):
            w = m.weight
            fan_in = w[0].numel() if not isinstance(m, nn.ConvTranspose3d) \
                else w.shape[0] * w[0, 0].numel()
            w.copy_(torch.randn(w.shape, generator=generator)
                    * (2.0 / fan_in) ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return module
