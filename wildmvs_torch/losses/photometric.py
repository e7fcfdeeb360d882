"""Unsupervised photometric (DSSIM) losses, with optional occlusion masking.

Counterpart of wildmvs/losses/photometric.py (reference
models/trainer.py:209-278). The occlusion-masked loss takes every view's
depthmap already stacked ([B, N, H, W], the other views' detached), as the
JAX package's does: the trainer runs all reference views in one step and
gathers their depths itself.

Precision: the flows, the sampling and the DSSIM run in f32 whatever the
network's compute dtype; a bf16 depth is upcast before it is unprojected.
"""
from __future__ import annotations

import torch

from ..geometry.projective import flows_from_single_depthmap, normalize_flow
from ..ops.grid_sample import grid_sample_xy
from .ssim import dssim
# the one masked mean lives with the supervised losses; re-exported here
# because the photometric callers (and the trainer) import it from this
# module, as in the JAX package
from .supervised import masked_mean  # noqa: F401


def get_flow_from_depthmap(depth_est: torch.Tensor, proj_mat: torch.Tensor,
                           src_hw: tuple[int, int], ref_idx: int):
    """Normalized sampling flows from a reference depthmap into the source
    views (reference models/trainer.py:209-219): normalized with the
    align_corners=True convention, a point behind a source camera -> -10,
    everything clamped to [-10, 10].

    Args:
      depth_est: [B, H, W].
      proj_mat: [B, N, 4, 4].
      src_hw: (h, w) of the source images being sampled.
    Returns:
      (flows [B, N-1, H, W, 2], src_depth [B, N-1, H, W]), f32.
    """
    h, w = src_hw
    px_flow, depth = flows_from_single_depthmap(depth_est.float(),
                                                proj_mat.float(), ref_idx)
    flows = normalize_flow(px_flow, h, w, align_corners=True)
    flows = torch.where((depth <= 0)[..., None], -10.0, flows)
    return torch.clamp(flows, -10.0, 10.0), depth


def _inside(flows: torch.Tensor) -> torch.Tensor:
    """Strictly inside (-1, 1) on both coordinates -> bool [..., H, W]."""
    return ((flows < 1.0) & (flows > -1.0)).all(dim=-1)


def _warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Sample img [B, h, w, C] at flow [B, H, W, 2] with align_corners=False
    (over flows normalized align_corners=True: the reference's own
    mismatch, models/trainer.py:221-238, reproduced)."""
    return grid_sample_xy(img, flow[..., 0], flow[..., 1],
                          align_corners=False)


def photometric_loss(imgs: torch.Tensor, depth_est: torch.Tensor,
                     proj_mat: torch.Tensor):
    """Per-source DSSIM maps and in-frustum masks, reference view 0
    (reference models/trainer.py:221-238).

    Args:
      imgs: [B, N, H, W, C] images at loss resolution (view 0 = reference).
      depth_est: [B, H, W] reference depth at the same resolution.
      proj_mat: [B, N, 4, 4] projection matrices at the same resolution.
    Returns:
      (ssim [B, N-1, H, W], mask [B, N-1, H, W] float).
    """
    n, h, w = imgs.shape[1:4]
    flows, _ = get_flow_from_depthmap(depth_est, proj_mat, (h, w), 0)
    mask = _inside(flows).to(imgs.dtype)
    ssims = [dssim(imgs[:, 0], _warp(imgs[:, i], flows[:, i - 1])).mean(-1)
             for i in range(1, n)]
    return torch.stack(ssims, dim=1), mask


def warped_src_views(imgs: torch.Tensor, depth_est: torch.Tensor,
                     proj_mat: torch.Tensor, ref_idx: int = 0):
    """Source views warped into the reference frame by the predicted depth
    (the reference's `warped_ref{r}src_{s}` panels, models/trainer.py:
    258-276).

    Args:
      imgs: [B, N, H, W, C]; depth_est: [B, H, W] reference depth;
      proj_mat: [B, N, 4, 4] at image resolution.
    Returns:
      (warped [B, N-1, H, W, C] in source order without ref_idx,
       inside [B, N-1, H, W] in-frustum mask).
    """
    n, h, w = imgs.shape[1:4]
    flows, _ = get_flow_from_depthmap(depth_est, proj_mat, (h, w), ref_idx)
    src_idx = [i for i in range(n) if i != ref_idx]
    warped = torch.stack([_warp(imgs[:, i], flows[:, k])
                          for k, i in enumerate(src_idx)], dim=1)
    return warped, _inside(flows).to(imgs.dtype)


def masked_photometric_loss(imgs: torch.Tensor, all_depthmaps: torch.Tensor,
                            proj_mat: torch.Tensor, ref_idx: int,
                            geom_clamping: float = 0.05):
    """Occlusion-masked photometric loss (reference models/trainer.py:
    240-278): a pixel counts only where the source view's own depth, warped
    into the reference, agrees with the reprojected depth within
    `geom_clamping` (relative). The gate and the in-frustum test are masks
    without gradient; the denominator is detached.

    Args:
      imgs: [B, N, H, W, C] images at loss resolution.
      all_depthmaps: [B, N, H, W] the depth of every view (view i estimated
        with reference i), the other views' detached.
      proj_mat: [B, N, 4, 4].
      ref_idx: the reference view of this term.
      geom_clamping: the relative depth-consistency gate.
    Returns:
      (ssim [B, N-1, H, W], mask [B, N-1, H, W] float).
    """
    n, h, w = imgs.shape[1:4]
    src_idx = [i for i in range(n) if i != ref_idx]
    flows, depth_src = get_flow_from_depthmap(all_depthmaps[:, ref_idx],
                                              proj_mat, (h, w), ref_idx)
    inside = _inside(flows)
    all_depthmaps = all_depthmaps.float()
    ssims, masks = [], []
    for k, i in enumerate(src_idx):
        warped = _warp(imgs[:, i], flows[:, k])
        warped_src_depth = _warp(all_depthmaps[:, i, :, :, None],
                                 flows[:, k])[..., 0]
        denom = warped_src_depth.clamp_min(1e-8).detach()
        reproj_diff = (depth_src[:, k] - warped_src_depth).abs() / denom
        ssims.append(dssim(imgs[:, ref_idx], warped).mean(-1))
        masks.append(inside[:, k].to(imgs.dtype)
                     * (reproj_diff < geom_clamping).to(imgs.dtype))
    return torch.stack(ssims, dim=1), torch.stack(masks, dim=1)
