"""Cost-volume aggregation and depth regression.

Counterpart of wildmvs/ops/volumes.py:67-234. Layout:
volumes [B, D, H, W, C], probability volumes [B, D, H, W]. The running sums
are f32 whatever the feature dtype (E[x^2] - E[x]^2 cancels badly in bf16)
and are updated in place, so one source volume at a time is live besides
them; the result is cast back to the feature dtype. Both aggregations are
differentiable: the variance's in-place updates keep what autograd needs,
and softmin updates in place only when no input requires grad.

The reductions over depth (`softmax_depth`, `soft_argmin`, `entropy`,
`depth_regression`, `photometric_confidence`) take an optional `slab`
(dist/mesh.Slab): the volume is then this rank's slab of the hypotheses
[lo, hi), its planes numbered lo + arange, and each sum over depth is a
local sum added over the slab's axis (differentiable, `all_reduce_sum`);
the softmax subtracts the maximum over the axis (detached). Every rank
returns the whole result. Without a slab each is what it was, bit for
bit.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..dist.mesh import Slab, all_reduce, all_reduce_sum


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


def groupwise_correlation(v1: torch.Tensor, v2: torch.Tensor,
                          groups: int) -> torch.Tensor:
    """Group-wise correlation over the trailing channel axis (reference
    VisMVSNet nn_utils.py:473-490, channels-last): v1, v2 [..., C] ->
    [..., groups], the dot product of each group of C/groups channels."""
    c = v1.shape[-1]
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    a = v1.reshape(v1.shape[:-1] + (groups, c // groups))
    b = v2.reshape(v2.shape[:-1] + (groups, c // groups))
    return (a * b).sum(-1)


def _sum_depth(x: torch.Tensor, slab: Slab | None,
               keepdim: bool = False) -> torch.Tensor:
    """The sum over depth (dim 1): over the slabs of every rank with one."""
    out = x.sum(1, keepdim=keepdim)
    return out if slab is None else all_reduce_sum(out, slab.axis)


def _indices(x: torch.Tensor, slab: Slab | None) -> torch.Tensor:
    """[1, D, 1, 1] global indices of x's depth planes, in x's dtype."""
    d = x.shape[1]
    lo = 0 if slab is None else slab.lo
    return torch.arange(lo, lo + d, dtype=x.dtype,
                        device=x.device).reshape(1, d, 1, 1)


def softmax_depth(x: torch.Tensor, slab: Slab | None = None) -> torch.Tensor:
    """Softmax over depth (dim 1) of [B, D, H, W]; over every rank's slab
    with one (the maximum reduced with MAX, detached; the sum with
    `all_reduce_sum`)."""
    if slab is None:
        return torch.softmax(x, dim=1)
    if x.shape[1]:
        top = x.detach().amax(1, keepdim=True)
    else:                                         # an empty slab
        top = x.new_full(x.shape[:1] + (1,) + x.shape[2:], float("-inf"))
    e = torch.exp(x - all_reduce(top, slab.axis, dist.ReduceOp.MAX))
    return e / _sum_depth(e, slab, keepdim=True)


def soft_argmin(score_volume: torch.Tensor, window: int | None = None,
                slab: Slab | None = None):
    """Softmax over depth and the expected class index (reference
    nn_utils.py:453-466).

    Args:
      score_volume: [B, D, H, W] raw scores (this rank's slab with `slab`).
      window: if set, also return the probability mass within +-window of
        the expected index (Vis-MVSNet's photometric confidence, window=2).
      slab: see the module docstring.
    Returns:
      (prob [B, D, H, W], expected index [B, H, W][, prob_map [B, H, W]]);
      prob is this rank's slab with `slab`, the rest whole.
    """
    prob = softmax_depth(score_volume, slab)
    index = _indices(prob, slab)
    out = _sum_depth(index * prob, slab, keepdim=True)
    if window is None:
        return prob, out[:, 0]
    mask = ((index - out).abs() <= window).to(prob.dtype)
    return prob, out[:, 0], _sum_depth(prob * mask, slab)


def entropy(prob_volume: torch.Tensor, axis: int = 1,
            keepdims: bool = False, slab: Slab | None = None) -> torch.Tensor:
    """Shannon entropy over the depth axis, log clamped to [1e-9, 1]
    (reference nn_utils.py:469-470); with `slab` (depth on axis 1), over
    every rank's slab."""
    p = prob_volume
    terms = -p * torch.log(p.clamp(1e-9, 1.0))
    if slab is None:
        return terms.sum(axis, keepdim=keepdims)
    assert axis == 1, axis
    return _sum_depth(terms, slab, keepdim=keepdims)


def depth_regression(prob_volume: torch.Tensor, depth_values: torch.Tensor,
                     slab: Slab | None = None) -> torch.Tensor:
    """Soft-argmin expected depth (reference module.py:174-182).

    prob_volume [B, D, H, W] (this rank's slab with `slab`); depth_values
    [B, D] or [B, D, H, W], all D hypotheses -> [B, H, W]."""
    if depth_values.dim() == 2:
        depth_values = depth_values[..., None, None]
    if slab is not None:
        depth_values = depth_values[:, slab.lo:slab.hi]
    return _sum_depth(prob_volume * depth_values, slab)


def photometric_confidence(prob_volume: torch.Tensor,
                           slab: Slab | None = None) -> torch.Tensor:
    """Sum of the 4 probability taps around the regressed depth index.

    Reference model.py:211-215: pad depth by (1, 2), window-4 sum, read at
    the soft-argmax index truncated toward zero (torch .long()).
    prob_volume [B, D, H, W] -> [B, H, W]. With `slab` the window may
    straddle a slab edge: each rank sums its planes within idx - 1 ..
    idx + 2, and the sums are added.
    """
    if slab is not None:
        index = _indices(prob_volume, slab)
        idx = all_reduce(torch.sum(prob_volume * index, dim=1),
                         slab.axis).long()[:, None].to(index.dtype)
        near = ((index >= idx - 1) & (index <= idx + 2)).to(
            prob_volume.dtype)
        return _sum_depth(prob_volume * near, slab)
    d = prob_volume.shape[1]
    padded = F.pad(prob_volume, (0, 0, 0, 0, 1, 2))
    sum4 = (padded[:, 0:d] + padded[:, 1:d + 1] + padded[:, 2:d + 2]
            + padded[:, 3:d + 3])
    index = torch.arange(d, dtype=prob_volume.dtype,
                         device=prob_volume.device).reshape(1, d, 1, 1)
    idx = torch.sum(prob_volume * index, dim=1).long()
    return torch.gather(sum4, 1, idx[:, None])[:, 0]
