"""Stage 2: geometric cross-view consistency filtering, on the device.

Counterpart of wildmvs/pipeline/filtering.py:30-91 (reference
evaluation/filtering.py:60-85): unproject the reference depthmap, project
it into each source view, sample that view's depthmap there, unproject the
sample and project it back into the reference view, then gate on
  * reprojection error < max_reproj_error px (default 1),
  * relative depth difference < depth_threshold (default 0.01),
  * triangulation angle > min_tri_angle degrees (default 1).
A pixel passes a mask when at least num_consistent - 1 source views agree.
Everything runs on the tensors' device; nothing crosses to the host.
"""
from __future__ import annotations

import torch

from ..geometry.projective import (compute_triangulation_angles, pixel_grid,
                                   unproject)
from ..ops.grid_sample import grid_sample_xy


def geometric_filter(ref_depth: torch.Tensor, src_depths, K: torch.Tensor,
                     R: torch.Tensor, t: torch.Tensor,
                     max_reproj_error: float = 1.0,
                     depth_threshold: float = 0.01,
                     min_tri_angle: float = 1.0,
                     num_consistent: int = 3) -> dict:
    """Consistency masks of one reference view.

    Args:
      ref_depth: [H, W] reference depthmap.
      src_depths: [N-1, h, w] source depthmaps, or a list of per-view
        [h_i, w_i] maps of different sizes.
      K, R: [N, 3, 3]; t: [N, 3, 1], view 0 the reference, each K at its
        own depthmap's resolution.
    Returns:
      {"mask_depth", "mask_disp", "geo_mask"}: [H, W] bool tensors.
    """
    h, w = ref_depth.shape
    srcs = list(src_depths)
    grid = pixel_grid(h, w, ref_depth.dtype, ref_depth.device)  # [H, W, 2]
    pc = unproject(grid, K[0], R[0], t[0], ref_depth)           # world

    def per_src(i):
        cam = pc @ R[i + 1].T + t[i + 1][:, 0]
        pix = cam @ K[i + 1].T
        depth_in_src = pix[..., 2]
        proj = pix[..., :2] / torch.clamp_min(depth_in_src, 1e-6)[..., None]
        sh, sw = srcs[i].shape
        # normalized with the (w-1) convention, sampled align_corners=False:
        # the reference's combination (filtering.py:66-69)
        gx = 2.0 * proj[..., 0] / (sw - 1.0) - 1.0
        gy = 2.0 * proj[..., 1] / (sh - 1.0) - 1.0
        sampled = grid_sample_xy(srcs[i][None, ..., None], gx[None],
                                 gy[None], align_corners=False)[0, ..., 0]
        src_pc = unproject(proj, K[i + 1], R[i + 1], t[i + 1], sampled)
        back_cam = src_pc @ R[0].T + t[0][:, 0]
        back_pix = back_cam @ K[0].T
        depth_reproj = back_pix[..., 2] + 1e-6
        reproj = back_pix[..., :2] / depth_reproj[..., None]
        reproj_err = torch.linalg.vector_norm(reproj - grid, dim=-1)
        valid_disp = reproj_err < max_reproj_error
        mask_depth = ((torch.abs(depth_reproj - ref_depth)
                       < torch.maximum(depth_reproj, ref_depth)
                       * depth_threshold)
                      & (depth_reproj > 0) & (depth_in_src > 0))
        return mask_depth, valid_disp

    masks = [per_src(i) for i in range(len(srcs))]
    mask_depth = torch.stack([m[0] for m in masks])
    valid_disp = torch.stack([m[1] for m in masks])
    mask_tri = compute_triangulation_angles(pc, R, t) > min_tri_angle
    geo = mask_depth & valid_disp & mask_tri
    need = num_consistent - 1
    return {
        "mask_depth": mask_depth.sum(0) >= need,
        "mask_disp": valid_disp.sum(0) >= need,
        "geo_mask": geo.sum(0) >= need,
    }
