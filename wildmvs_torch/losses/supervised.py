"""Supervised depth losses and GT pyramid helpers.

Counterpart of wildmvs/losses/supervised.py (reference
models/trainer.py:114-198 and models/utils.py:110-119). Depth maps are
[B, H, W]; images may be [B, H, W, C] (channels-last).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize, half-pixel centers, no antialiasing (torch
    align_corners=False; jax.image.resize "linear" with antialias=False,
    edges included). Works on [B, H, W] or [B, H, W, C]."""
    squeeze = x.dim() == 3
    x4 = x[:, None] if squeeze else x.permute(0, 3, 1, 2)
    out = F.interpolate(x4, size=tuple(hw), mode="bilinear",
                        align_corners=False, antialias=False)
    return out[:, 0] if squeeze else out.permute(0, 2, 3, 1)


def downsample_gt(gt: torch.Tensor, mask: torch.Tensor,
                  hw: tuple[int, int]):
    """Downsample GT depth bilinearly; downsample the mask and keep only
    EXACT 1.0 (all bilinear neighbours valid). Reference
    models/trainer.py:130-132.

    Args:
      gt, mask: [B, H, W].
    Returns:
      (gt_down [B, h, w], mask_down [B, h, w] float in {0, 1}).
    """
    gt_d = resize_bilinear(gt, hw)
    mask_d = (resize_bilinear(mask.to(gt.dtype), hw) == 1.0).to(gt.dtype)
    return gt_d, mask_d


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(v*m)/sum(m), or the (zero, graph-keeping) sum for an empty mask
    (reference models/trainer.py:170-174, models/utils.py:110-119)."""
    msum = mask.sum()
    total = (values * mask).sum()
    return torch.where(msum > 0, total / msum.clamp_min(1.0), total)


def masked_l1_interval(depth_est: torch.Tensor, gt: torch.Tensor,
                       mask: torch.Tensor,
                       depth_interval: torch.Tensor) -> torch.Tensor:
    """Masked mean L1 in units of depth_interval = (max - min) / 128
    (reference models/trainer.py:165-167). depth_est, gt, mask [B, h, w];
    depth_interval [B]."""
    l1 = (depth_est - gt).abs() / depth_interval[:, None, None]
    return masked_mean(l1, mask)


def bayesian_loss(l: torch.Tensor, uncertainty: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Bayesian pair loss: masked mean of l * e^-u + u + l (reference
    models/utils.py:110-119 `bayesian_version_loss`)."""
    return masked_mean(l * torch.exp(-uncertainty) + uncertainty + l, mask)
