"""Cost-volume aggregation and depth regression.

Counterpart of wildmvs/ops/volumes.py:67-141, 165-179, 215-234. Layout:
volumes [B, D, H, W, C], probability volumes [B, D, H, W]. The running sums
are f32 whatever the feature dtype (E[x^2] - E[x]^2 cancels badly in bf16)
and are updated in place, so one source volume at a time is live besides
them; the result is cast back to the feature dtype. Both aggregations are
differentiable: the variance's in-place updates keep what autograd needs,
and softmin updates in place only when no input requires grad.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in tensors)


def _thunks(warped_iter, warp_fns):
    if warp_fns is not None:
        return list(warp_fns)
    return [lambda v=v: v for v in warped_iter]


def variance_cost_volume(ref_feature: torch.Tensor,
                         warped_iter: Sequence[torch.Tensor] | None = None,
                         *, warp_fns: Sequence[Callable[[], torch.Tensor]]
                         | None = None,
                         num_depth: int | None = None) -> torch.Tensor:
    """Variance aggregation E[f^2] - E[f]^2 over {ref} and the sources
    (population variance, reference models/MVSNet/model.py:113-139).

    Args:
      ref_feature: [B, H, W, C].
      warped_iter: [B, D, H, W, C] warped source volumes, or
      warp_fns: thunks that produce them one at a time.
      num_depth: D (required: it sizes the zero-source result).
    Returns:
      [B, D, H, W, C] in the feature dtype.
    """
    if num_depth is None:
        raise ValueError("num_depth is required")
    fns = _thunks(warped_iter, warp_fns)
    num_views = len(fns) + 1
    if not fns:
        b, h, w, c = ref_feature.shape
        return ref_feature.new_zeros((b, num_depth, h, w, c))
    vol_sum = vol_sq_sum = None
    for fn in fns:
        warped = fn().float()
        if vol_sum is None:
            vol_sum = warped.clone()
            vol_sq_sum = warped.square()
        else:
            vol_sum.add_(warped)
            vol_sq_sum.addcmul_(warped, warped)
    ref_volume = ref_feature.float()[:, None]
    vol_sum.add_(ref_volume)
    vol_sq_sum.addcmul_(ref_volume, ref_volume)
    vol_sq_sum.div_(num_views)
    vol_sum.div_(num_views)
    return (vol_sq_sum - vol_sum.square_()).to(ref_feature.dtype)


def softmin_cost_volume(ref_feature: torch.Tensor,
                        warped_iter: Sequence[torch.Tensor] | None = None,
                        *, warp_fns: Sequence[Callable[[], torch.Tensor]]
                        | None = None,
                        temperature: torch.Tensor | float = 1.0,
                        eps: float = 1e-6) -> torch.Tensor:
    """Softmin aggregation (MVSNet-s): per-view squared differences
    weighted by exp(-T * sum_c diff), normalized by the weight sum
    (reference models/MVSNet/model.py:141-173). Returns [B, D, H, W, C] in
    the feature dtype."""
    fns = _thunks(warped_iter, warp_fns)
    ref_volume = ref_feature.float()[:, None]
    sum_exp = sum_val = None
    for fn in fns:
        warped = fn().float()
        if _needs_grad(ref_volume, warped, temperature):
            # autograd keeps exp's output and the squared differences for
            # the backward: no in-place updates
            diff = (ref_volume - warped).square()
            e = torch.exp(-temperature * diff.sum(-1, keepdim=True))
            contrib = e * diff
            sum_exp = e if sum_exp is None else sum_exp + e
            sum_val = contrib if sum_val is None else sum_val + contrib
            continue
        diff = (ref_volume - warped).square_()
        e = torch.exp(-temperature * diff.sum(-1, keepdim=True))
        if sum_exp is None:
            sum_exp, sum_val = e, diff.mul_(e)
        else:
            sum_exp.add_(e)
            sum_val.addcmul_(diff, e)
    return (sum_val / (sum_exp + eps)).to(ref_feature.dtype)


def depth_regression(prob_volume: torch.Tensor,
                     depth_values: torch.Tensor) -> torch.Tensor:
    """Soft-argmin expected depth (reference module.py:174-182).

    prob_volume [B, D, H, W]; depth_values [B, D] or [B, D, H, W] ->
    [B, H, W]."""
    if depth_values.dim() == 2:
        depth_values = depth_values[..., None, None]
    return torch.sum(prob_volume * depth_values, dim=1)


def photometric_confidence(prob_volume: torch.Tensor) -> torch.Tensor:
    """Sum of the 4 probability taps around the regressed depth index.

    Reference model.py:211-215: pad depth by (1, 2), window-4 sum, read at
    the soft-argmax index truncated toward zero (torch .long()).
    prob_volume [B, D, H, W] -> [B, H, W].
    """
    d = prob_volume.shape[1]
    padded = F.pad(prob_volume, (0, 0, 0, 0, 1, 2))
    sum4 = (padded[:, 0:d] + padded[:, 1:d + 1] + padded[:, 2:d + 2]
            + padded[:, 3:d + 3])
    index = torch.arange(d, dtype=prob_volume.dtype,
                         device=prob_volume.device).reshape(1, d, 1, 1)
    idx = torch.sum(prob_volume * index, dim=1).long()
    return torch.gather(sum4, 1, idx[:, None])[:, 0]
