"""Depth-quality metrics in interval units.

Counterpart of wildmvs/train/metrics.py (reference models/utils.py:122-171
and the normalization of models/trainer.py:311-314): estimate and GT are
divided by (depth_max - depth_min) / 128 before EPE and the >1px / >3px
error rates; each image is averaged over its mask, then the batch.
"""
from __future__ import annotations

import torch


def _per_image_masked_mean(values: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Mean over each image's masked pixels, then over the batch; an image
    with an empty mask gives NaN (the reference's mean over an empty
    selection), so a degenerate sample is visible."""
    m = mask.to(values.dtype)
    msum = m.sum(dim=(1, 2))
    per_img = torch.where(msum > 0,
                          (values * m).sum(dim=(1, 2)) / msum.clamp_min(1.0),
                          torch.full_like(msum, float("nan")))
    return per_img.mean()


def depth_metrics(depth_est: torch.Tensor, depth_gt: torch.Tensor,
                  mask: torch.Tensor, depth_min: torch.Tensor,
                  depth_max: torch.Tensor) -> dict:
    """EPE / 1px / 3px in units of (max - min) / 128 on the GT grid.

    Args:
      depth_est: [B, H, W] at the GT resolution.
      depth_gt, mask: [B, H, W].
      depth_min, depth_max: [B] reference-view depth range.
    Returns:
      {"EPE", "1pxError", "3pxError"}: 0-d tensors.
    """
    step = (depth_max - depth_min) / 128.0
    est = depth_est / step[:, None, None]
    gt = depth_gt / step[:, None, None]
    m = mask > 0.5
    err = (est - gt).abs()
    return {
        "EPE": _per_image_masked_mean(err, m),
        "1pxError": _per_image_masked_mean((err > 1.0).to(err.dtype), m),
        "3pxError": _per_image_masked_mean((err > 3.0).to(err.dtype), m),
    }
