"""Plane-sweep warping, MVSNet convention: the exact f32 gather path.

Counterpart of wildmvs/ops/plane_sweep.py:28-122 (reference
models/MVSNet/module.py:111-169): integer pixel grid, behind-camera points
sent to pixel -10, align_corners=True normalization x_n = x/((W-1)/2) - 1,
grid clamped to [-10, 10]. Everything the port's Hopper kernels compute is
checked against this path.

Layout: features [B, H, W, C]; output volumes [B, D, H, W, C]; depth values
[B, D] (fronto-parallel sweep) or [B, D, H, W] (per-pixel hypotheses).
"""
from __future__ import annotations

import torch

from ..geometry.projective import pixel_grid
from .grid_sample import grid_sample_xy

# bytes of gather intermediates (indices, weights, four f32 corner reads)
# one depth slab may hold; bounds the eval-size sweep on the card
GATHER_CHUNK_BYTES = 1 << 30


def sweep_grid_xy(src_proj: torch.Tensor, ref_proj: torch.Tensor,
                  depth_values: torch.Tensor, ref_hw: tuple[int, int],
                  src_hw: tuple[int, int]):
    """Normalized sampling grid of the MVSNet plane sweep as (x, y) planes.

    Args:
      src_proj, ref_proj: [B, 4, 4] projection matrices.
      depth_values: [B, D] or [B, D, H, W].
      ref_hw: (H, W) of the reference grid.
      src_hw: (h, w) of the source map (for normalization).
    Returns:
      (xn, yn): two [B, D, H, W] normalized planes in [-10, 10]. The grid
      carries no gradient (the reference builds it under no_grad).
    """
    rh, rw = ref_hw
    sh, sw = src_hw
    b, d = depth_values.shape[:2]
    with torch.no_grad():
        proj = src_proj @ torch.linalg.inv(ref_proj)
        rot = proj[:, :3, :3]
        trans = proj[:, :3, 3]
        grid = pixel_grid(rh, rw, depth_values.dtype, depth_values.device)
        xyz = torch.cat([grid, torch.ones_like(grid[..., :1])], -1)
        rot_xyz = torch.einsum("bij,hwj->bihw", rot, xyz)   # [B, 3, H, W]
        if depth_values.dim() == 2:
            depth = depth_values.reshape(b, 1, d, 1, 1)
        else:
            depth = depth_values[:, None]
        proj_xyz = rot_xyz[:, :, None] * depth + trans[:, :, None, None, None]
        z = proj_xyz[:, 2]
        behind = z <= 0
        x = torch.where(behind, -10.0, proj_xyz[:, 0] / z)
        y = torch.where(behind, -10.0, proj_xyz[:, 1] / z)
        xn = torch.clamp(x / ((sw - 1) / 2.0) - 1.0, -10.0, 10.0)
        yn = torch.clamp(y / ((sh - 1) / 2.0) - 1.0, -10.0, 10.0)
    return xn, yn


def gather_chunk_planes(num_depth: int, hw: tuple[int, int], c: int,
                        limit: int) -> int:
    """Depth planes per slab so one slab's gather intermediates stay under
    `limit` bytes (about 4 f32 corner reads plus indices per output)."""
    per_plane = hw[0] * hw[1] * (4 * c * 4 + 64)
    return max(1, min(num_depth, limit // per_plane))


def plane_sweep_warp(src_fea: torch.Tensor, src_proj: torch.Tensor,
                     ref_proj: torch.Tensor, depth_values: torch.Tensor,
                     ref_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """MVSNet homography warp: source features -> reference sweep volume.

    Runs in depth slabs (`gather_chunk_planes`) written into one output, so
    the gather's corner intermediates never exceed about 1 GiB at once.

    Args:
      src_fea: [B, h, w, C] source features.
      src_proj, ref_proj: [B, 4, 4].
      depth_values: [B, D] or [B, D, H, W].
      ref_hw: reference grid size; defaults to the source size.
    Returns:
      [B, D, H, W, C] warped volume in the feature dtype (zeros outside the
      source frustum).
    """
    b, sh, sw, c = src_fea.shape
    if ref_hw is None:
        ref_hw = (sh, sw)
    d = depth_values.shape[1]
    out = src_fea.new_empty((b, d) + tuple(ref_hw) + (c,))
    dc = gather_chunk_planes(d, ref_hw, c, GATHER_CHUNK_BYTES)
    for d0 in range(0, d, dc):
        xn, yn = sweep_grid_xy(src_proj, ref_proj, depth_values[:, d0:d0 + dc],
                               ref_hw, (sh, sw))
        out[:, d0:d0 + dc] = grid_sample_xy(src_fea, xn, yn,
                                            align_corners=True)
    return out
