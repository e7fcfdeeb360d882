"""Conv + BatchNorm + ReLU blocks (2D and 3D), the transposed 3D block, and
the ResNet BasicBlock / ResLayer / UNet of Vis-MVSNet.

Counterpart of wildmvs/nn/blocks.py:231-696 (reference
models/MVSNet/module.py:21-48, model.py:57-70, VisMVSNet/nn_utils.py:
123-278), unpacked math only: the JAX package's depth-packed,
space-to-depth and conv3d-via-2D forms are TPU layouts of the same math and
have no counterpart here. BatchNorm uses eps 1e-5 and momentum 0.1, torch's
defaults. Attribute names reproduce the reference state_dict keys
(`<block>.conv.weight`, `<block>.bn.*`; the transposed block is a
Sequential, so `<block>.0.weight`, `<block>.1.*`; BasicBlock
`conv1/bn1/conv2/bn2/downsample.0/.1`; UNet `enc_blocks` / `dec_blocks`
keyed `{prefix}{scale}_{idx}`).

Tensors are torch's NC(D)HW; the model keeps them in channels-last memory.

Two contexts change how train-mode BatchNorm runs: `frozen_running_stats`
(normalize, but leave the running statistics alone) and
`synced_batch_norm` (normalize over the batches of several ranks, the
data-parallel step's counterpart of JAX's one program over the whole
batch).
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn

from ..dist.mesh import all_reduce_sum

CONVS = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)
_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_DECONV = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_BN = {2: nn.BatchNorm2d, 3: nn.BatchNorm3d}


class ConvBnReLU(nn.Module):
    """Conv (no bias) -> BN -> ReLU, 2D or 3D."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, pad: int = 1,
                 dim: int = 2):
        super().__init__()
        self.conv = _CONV[dim](in_channels, out_channels, kernel_size,
                               stride, pad, bias=False)
        self.bn = _BN[dim](out_channels, eps=1e-5, momentum=0.1)

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


class BasicBlock(nn.Module):
    """ResNet BasicBlock: conv3x3-BN-ReLU, conv3x3-BN, plus the input or
    its 1x1 projection (when the stride or the width changes), then ReLU
    (reference nn_utils.py:123-171). 2D or 3D."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dim: int = 2):
        super().__init__()
        self.conv1 = _CONV[dim](in_channels, out_channels, 3, stride, 1,
                                bias=False)
        self.bn1 = _BN[dim](out_channels, eps=1e-5, momentum=0.1)
        self.conv2 = _CONV[dim](out_channels, out_channels, 3, 1, 1,
                                bias=False)
        self.bn2 = _BN[dim](out_channels, eps=1e-5, momentum=0.1)
        self.downsample = None
        if stride != 1 or in_channels != out_channels:
            self.downsample = nn.Sequential(
                _CONV[dim](in_channels, out_channels, 1, stride, 0,
                           bias=False),
                _BN[dim](out_channels, eps=1e-5, momentum=0.1))

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class ResLayer(nn.Sequential):
    """`blocks` BasicBlocks, the first one strided (reference
    nn_utils.py:175-191 `_make_layer`, a Sequential: keys `.0`, `.1`)."""

    def __init__(self, in_channels: int, out_channels: int, blocks: int,
                 stride: int = 1, dim: int = 2):
        super().__init__(*[
            BasicBlock(in_channels if i == 0 else out_channels, out_channels,
                       stride if i == 0 else 1, dim) for i in range(blocks)])


class UNet(nn.Module):
    """The Vis-MVSNet UNet, 2D or 3D (reference nn_utils.py:194-278).

    Encoder: a ResLayer per filter width, stride 1 for the first and 2
    after. Decoder, for each width but the last in reverse: a stride-2
    transposed conv, concatenation with the encoder output of that scale,
    a 3x3 conv, and `dec_blocks_per_stage` BasicBlocks. Blocks are keyed
    `{prefix}{scale}_{idx}` (scale = initial_scale * 2^level) as the
    reference registers them.

    forward(x, multi_scale=k) returns the last k decoder outputs (coarsest
    first; the first of them may be the bottom encoder output), or the
    finest alone for k = 1.
    """

    def __init__(self, in_channels: int, enc_blocks_per_stage: int,
                 dec_blocks_per_stage: int, filters, prefix: str,
                 initial_scale: int, dim: int = 2):
        super().__init__()
        self.enc_blocks = nn.ModuleDict()
        self.dec_blocks = nn.ModuleDict()
        scale, prev = initial_scale, in_channels
        for idx, f in enumerate(filters):
            self.enc_blocks[f"{prefix}{scale}_{idx}"] = ResLayer(
                prev, f, enc_blocks_per_stage, 1 if idx == 0 else 2, dim)
            scale, prev = scale * 2, f
        idx = len(filters)
        for f in list(filters)[-2::-1]:
            parts = [_DECONV[dim](prev, f, 3, stride=2, padding=1,
                                  output_padding=1, bias=False),
                     _CONV[dim](2 * f, f, 3, 1, 1, bias=False)]
            if dec_blocks_per_stage > 0:
                parts.append(ResLayer(f, f, dec_blocks_per_stage, 1, dim))
            self.dec_blocks[f"{prefix}{scale}_{idx}"] = nn.Sequential(*parts)
            scale, prev, idx = scale // 2, f, idx + 1

    def forward(self, x, multi_scale: int = 1):
        enc_out = []
        for layer in self.enc_blocks.values():
            x = layer(x)
            enc_out.append(x)
        dec_out = [x]
        for i, block in enumerate(self.dec_blocks.values()):
            x = block[0](x)
            x = block[1](torch.cat([x, enc_out[-2 - i]], dim=1))
            if len(block) > 2:
                x = block[2](x)
            dec_out.append(x)
        if multi_scale == 1:
            return x
        return dec_out[-multi_scale:]


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
            w.copy_(torch.randn(w.shape, generator=generator)
                    * (2.0 / conv_fan_in(m)) ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return module


#: flax's truncated normal: the std of a standard normal cut at +-2
#: (jax.nn.initializers.variance_scaling divides the scale by it)
TRUNC_STD = 0.87962566103423978


def conv_fan_in(conv: nn.Module) -> int:
    """A conv's fan-in as flax reckons it for the same layer: the kernel's
    input channels times its taps (a transposed conv's weight is
    [in, out, *k], a conv's [out, in / groups, *k])."""
    w = conv.weight
    deconv = isinstance(conv, (nn.ConvTranspose2d, nn.ConvTranspose3d))
    return w.shape[0] * w[0, 0].numel() if deconv else w[0].numel()


@torch.no_grad()
def lecun_normal_init(module: nn.Module,
                      generator: torch.Generator) -> nn.Module:
    """Fresh training weights from the JAX package's distribution: every
    conv and transposed-conv kernel drawn as flax's `lecun_normal` draws
    it (a normal of scale sqrt(1 / fan_in) / TRUNC_STD cut at two of those
    scales, so its std is sqrt(1 / fan_in)), zero biases, identity
    BatchNorm. Other parameters (MVSNet-s's temperature, ones in both
    packages) keep what the constructor gave them. Values are drawn on
    the CPU from `generator`."""
    for m in module.modules():
        if isinstance(m, CONVS):
            scale = (1.0 / conv_fan_in(m)) ** 0.5 / TRUNC_STD
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, scale, -2.0 * scale, 2.0 * scale,
                                  generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return module


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Within the block, train-mode BatchNorm still normalizes by the batch
    statistics but leaves its running statistics and count as they were
    (momentum 0): a checkpointed level's second forward, in the backward,
    must not count its batch twice, nor a second reference view's forward
    in an occlusion-masked step. The running tensors stay arguments of
    the op, so the recomputation saves what the first forward saved."""
    bns = [m for m in module.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    kept = [(m.momentum, m.num_batches_tracked.clone()) for m in bns]
    for m in bns:
        m.momentum = 0.0
    try:
        yield
    finally:
        for m, (momentum, count) in zip(bns, kept):
            m.momentum = momentum
            m.num_batches_tracked.copy_(count)


def _synced_bn_forward(bn, axis, x):
    """Train-mode BatchNorm over the batch of every rank of `axis`: the
    per-channel sum and count, then the sum of squared deviations, each
    all-reduced with autograd (so each rank's gradient reaches the others'
    inputs, and the ranks' gradient mean is the whole batch's gradient).
    The sums accumulate in f64, so that the statistics hardly depend on how
    the batch is split (torch's CPU kernel accumulates in f64 too), and
    the rest runs in f32; the result takes the input's dtype; the running
    statistics take torch's momentum update with the unbiased variance of
    the whole batch."""
    if not bn.training:
        return type(bn).forward(bn, x)
    dims = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    xf = x.float()
    f64 = torch.float64
    local = torch.cat([xf.sum(dims, dtype=f64),
                       xf.new_full((1,), x.numel() / x.shape[1], dtype=f64)])
    total = all_reduce_sum(local, axis)
    count = total[-1].detach()
    mean = (total[:-1] / count).float()
    dev = xf - mean.reshape(shape)
    var = (all_reduce_sum((dev * dev).sum(dims, dtype=f64), axis)
           / count).float()
    y = dev * torch.rsqrt(var + bn.eps).reshape(shape)
    if bn.affine:
        y = y * bn.weight.reshape(shape) + bn.bias.reshape(shape)
    if bn.track_running_stats:
        with torch.no_grad():
            bn.num_batches_tracked.add_(1)
            m = (1.0 / float(bn.num_batches_tracked) if bn.momentum is None
                 else bn.momentum)
            bn.running_mean.mul_(1 - m).add_(m * mean.detach())
            bn.running_var.mul_(1 - m).add_(
                m * var.detach() * (count / (count - 1)))
    return y.to(x.dtype)


@contextlib.contextmanager
def synced_batch_norm(module: nn.Module, axis):
    """Within the block, every train-mode BatchNorm of `module` normalizes
    over the batches of all ranks of `axis` (a dist.mesh.MeshAxis; None or
    one rank: nothing changes). torch.nn.SyncBatchNorm takes CUDA tensors
    only; this one serves the CPU (gloo) as well. The backward must run
    inside the block too when it recomputes forwards (remat)."""
    if axis is None or axis.group is None:
        yield
        return
    bns = [m for m in module.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for m in bns:
        m.forward = functools.partial(_synced_bn_forward, m, axis)
    try:
        yield
    finally:
        for m in bns:
            del m.forward
