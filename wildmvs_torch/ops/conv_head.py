"""The score head of the 3D regularizers: wrapper, plain version, work,
launch count.

The one convolution that ends every 3D regularizer of the served nets
(MVSNet `CostRegNet.prob` 8 -> 1, Vis-MVSNet `RegPair` / `RegFuse`
`final_conv` 8 -> 1, CVP-MVSNet `prob0` 16 -> 1): 3x3x3 taps, stride 1,
zero padding 1, one output channel, with or without bias. On the card it
is a hand-written Hopper kernel (csrc/conv3d_head.cu, built on first use by
_build.py); cuDNN runs it on a generic implicit-GEMM kernel without tensor
cores, about 190x off its bound. It replaces no Pallas kernel (the JAX
package leaves the convolution to XLA).

  conv3d_head   x [B, C, D, H, W] in channels_last_3d memory (the
      [B, D, H, W, C] volume seen as NCDHW), C = 8 or 16, bf16 or f32;
      weight [1, C, 3, 3, 3] and bias [1] (or None) in x's dtype ->
      [B, 1, D, H, W] in x's dtype. Each voxel sums its 27 * C products in
      f32, adds the bias in f32 and is rounded once. Bound
      (`conv3d_head_bound`): its bytes, in bf16 since products of bf16
      operands summed in f32 are the tensor cores' bf16 MMA, in f32 even
      at the CUDA cores' rate. Design and launch plan: the kernel's
      source. No backward: the training heads run nn.Conv3d.

`nn.blocks.ScoreConv3d` routes a head to it on a CUDA tensor when autograd
records nothing. The wrapper takes its plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises, never falls
back. `conv3d_head.launches` counts kernel launches (never plain calls);
the kernel is registered with ops/sweep_kernels' launch counts and
`on_launch` hooks as "conv3d_head".
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import sweep_kernels as sk

DTYPES = (torch.bfloat16, torch.float32)


def conv3d_head_work(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None = None) -> sk.KernelWork:
    """One launch on x [B, C, D, H, W]: x, weight and bias read once, the
    one-channel output written once; 27 * C FMAs (2 operations each) and
    the bias add a voxel."""
    b, c, d, h, w = x.shape
    voxels = b * d * h * w
    params = (weight,) if bias is None else (weight, bias)
    return sk.KernelWork(sk.nbytes(x, *params) + voxels * x.element_size(),
                         voxels * (54 * c + 1), voxels)


def conv3d_head_bound(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor | None = None):
    """(bound_ms, bound_by) of one launch: its bytes against its operations
    at the bf16 tensor-core rate in bf16 (bf16 products summed in f32 are
    what the tensor cores' bf16 MMA computes), at the f32 rate in f32."""
    flops = sk.BF16_FLOPS if x.dtype == torch.bfloat16 else sk.F32_FLOPS
    return sk.bound(conv3d_head_work(x, weight, bias), flops)


def conv3d_head_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in PyTorch: 27 shifted slices of the zero-padded
    input, their channel sums accumulated in f32, the bias added in f32,
    one rounding to x's dtype. x [B, C, D, H, W] -> [B, 1, D, H, W]."""
    _, c, d, h, w = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1, 1, 1))
    wf = weight.float()[0]
    acc = torch.zeros_like(xp[:, 0, :d, :h, :w])
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                tap = wf[:, kd, kh, kw].view(1, c, 1, 1, 1)
                acc += (xp[:, :, kd:kd + d, kh:kh + h, kw:kw + w]
                        * tap).sum(1)
    if bias is not None:
        acc += bias.float()
    return acc.to(x.dtype)[:, None]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def conv3d_head(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """The score head (kernel `wm_conv3d_head`). Eval only (no backward).

    Args:
      x: [B, C, D, H, W] bf16 or f32, C = 8 or 16, contiguous in
        channels_last_3d memory.
      weight: [1, C, 3, 3, 3] in x's dtype.
      bias: [1] in x's dtype, or None.
    Returns:
      [B, 1, D, H, W] in x's dtype (channels_last_3d, as cuDNN returns it).
    """
    _require(x.dim() == 5, f"x must be [B, C, D, H, W], got {tuple(x.shape)}")
    b, c, d, h, w = x.shape
    _require(c in (8, 16), f"channels must be 8 or 16, got {c}")
    _require(x.dtype in DTYPES, f"x must be bfloat16 or float32, got "
             f"{x.dtype}")
    _require(tuple(weight.shape) == (1, c, 3, 3, 3),
             f"weight must be [1, {c}, 3, 3, 3], got {tuple(weight.shape)}")
    _require(bias is None or tuple(bias.shape) == (1,),
             f"bias must be [1] or None, got {getattr(bias, 'shape', None)}")
    params = (weight,) if bias is None else (weight, bias)
    for t in params:
        _require(t.dtype == x.dtype, f"weight and bias must be {x.dtype}, "
                 f"got {t.dtype}")
        _require(t.device == x.device, "all tensors must be on one device")
    _require(x.is_contiguous(memory_format=torch.channels_last_3d),
             "x must be contiguous in channels_last_3d memory")
    _require(min(b, d, h, w) >= 1, f"empty input {tuple(x.shape)}")
    _require(not (torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *params))),
        "conv3d_head has no backward: call it without grad")
    if x.device.type == "cpu":
        return conv3d_head_plain(x, weight, bias)
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    _require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    weight = weight.contiguous()
    from .. import _build
    lib = _build.load()
    out = torch.empty((b, 1, d, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last_3d)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.wm_conv3d_head(
            x.data_ptr(), weight.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, c, d, h, w, int(x.dtype == torch.float32), stream)
    _build.check(rc, "wm_conv3d_head")
    conv3d_head.launches += 1
    sk.launched("conv3d_head", (x, weight, bias), out)
    return out


conv3d_head.launches = 0
sk.register("conv3d_head", conv3d_head, conv3d_head_plain)
