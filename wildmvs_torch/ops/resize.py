"""The two resizes of CVP-MVSNet's pyramids.

Counterpart of wildmvs/models/cvp_mvsnet.py:38-50:
  bilinear_half    the image pyramid's 0.5x step: a bilinear resize to
                   (h // 2, w // 2) with half-pixel centres (for odd sizes
                   the scale is (h // 2) / h, not torch's scale_factor=0.5
                   mapping); losses/supervised.resize_bilinear computes it.
  bicubic_double   the depth's 2x upsampling between levels:
                   jax.image.resize(method="cubic"), a Keys kernel with
                   a = -0.5 at half-pixel centres, taps outside the map
                   dropped and the remaining weights renormalised
                   (F.interpolate's bicubic has a = -0.75 and clamps the
                   edges instead). Built here as JAX builds it: one weight
                   matrix per axis, contracted in f32.
"""
from __future__ import annotations

import torch

from ..losses.supervised import resize_bilinear


def bilinear_half(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H // 2, W // 2, C], bilinear, half-pixel."""
    return resize_bilinear(x, (x.shape[1] // 2, x.shape[2] // 2))


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel (a = -0.5) at distances x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """[n_in, n_out] f32 weights of jax.image.resize's cubic kernel
    without antialiasing (jax/_src/image/scale.py compute_weight_mat):
    each output column normalised to sum 1, zero where the sample lies
    outside the input."""
    inv_scale = 1.0 / (n_out / n_in)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = _keys_cubic((sample[None, :] - src[:, None]).abs())
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def bicubic_double(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, 2H, 2W] f32, jax.image.resize(method="cubic")."""
    _, h, w = x.shape
    wy = cubic_weights(h, 2 * h, x.device)
    wx = cubic_weights(w, 2 * w, x.device)
    return torch.einsum("bhw,hH,wW->bHW", x.float(), wy, wx)
