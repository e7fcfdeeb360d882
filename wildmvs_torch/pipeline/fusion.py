"""Stage 3: depthmap fusion into one point cloud, on the device.

Counterpart of wildmvs/pipeline/fusion.py:37-223 (the native replacement of
the reference's external fusibile and COLMAP stereo_fusion binaries). For
each reference view r in turn, so that a surface point is fused once:
  1. unproject every unused valid pixel of r to 3D;
  2. project it into every other view and read that view's depth at the
     rounded pixel;
  3. view i is consistent when the pixel lands in frame with positive
     depth, the source pixel is valid and not yet used by an earlier
     reference view, and |d_projected - d_sampled| < disp_threshold *
     max(d_projected, d_sampled) (with max_reproj_error set, also when the
     source point projects back within that many pixels: COLMAP's gate);
  4. keep pixels with >= num_consistent - 1 consistent sources; the point
     is the mean of the reference point and the consistent source points;
  5. mark the consistent source pixels and the kept reference pixels as
     used.
Each step for a reference view runs on the device, the scatter of the used
mask included; only the candidate points and the keep mask cross to the
host (two device-to-host copies a reference view).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.projective import pixel_grid, project, unproject


def _consistency(pc, grid, ref_idx: int, depths, used, Ks, Rs, ts,
                 disp_threshold: float, max_reproj_error: float | None):
    """(consistent [N, H, W], source points [N, H, W, 3], flat source
    pixel [N, H, W]) of the reference points pc [H, W, 3] against each
    view's (masked) depthmap; depths and used are per-view lists."""
    cons, pts, flats = [], [], []
    for i in range(len(depths)):
        sh, sw = depths[i].shape
        proj, d_proj = project(pc, Ks[i], Rs[i], ts[i])
        ix = torch.round(proj[..., 0]).to(torch.int64)
        iy = torch.round(proj[..., 1]).to(torch.int64)
        inb = (ix >= 0) & (ix < sw) & (iy >= 0) & (iy < sh) & (d_proj > 0)
        ixc = ix.clamp(0, sw - 1)
        iyc = iy.clamp(0, sh - 1)
        d_smp = depths[i][iyc, ixc]
        consistent = (inb & (d_smp > 0) & ~used[i][iyc, ixc]
                      & (torch.abs(d_proj - d_smp)
                         < disp_threshold * torch.maximum(d_proj, d_smp)))
        if i == ref_idx:
            consistent = torch.zeros_like(consistent)
        src_pt = unproject(torch.stack([ixc, iyc], -1).to(pc.dtype), Ks[i],
                           Rs[i], ts[i], d_smp)
        if max_reproj_error is not None:
            bproj, _ = project(src_pt, Ks[ref_idx], Rs[ref_idx], ts[ref_idx])
            consistent = consistent & (torch.linalg.vector_norm(
                bproj - grid, dim=-1) < max_reproj_error)
        cons.append(consistent)
        pts.append(src_pt)
        flats.append(iyc * sw + ixc)
    return torch.stack(cons), torch.stack(pts), flats


def _fuse_one_view(ref_idx: int, depths, used, Ks, Rs, ts,
                   disp_threshold: float = 0.01, num_consistent: int = 3,
                   max_reproj_error: float | None = None):
    """One reference view's fusion step (the JAX package's _fuse_one_view
    and _fuse_one_view_ragged in one: eager torch needs no static shapes).

    Args:
      ref_idx: index of the reference view.
      depths: per-view (masked) depthmaps [h_i, w_i], 0 = invalid (a
        stacked [N, H, W] tensor iterates as one).
      used: per-view bool masks of the same shapes, the pixels consumed by
        earlier reference views.
      Ks, Rs: [N, 3, 3]; ts: [N, 3, 1].
    Returns:
      (points [H*W, 3], keep [H*W] bool, the new used masks, a list).
    """
    ref_depth = depths[ref_idx]
    h, w = ref_depth.shape
    grid = pixel_grid(h, w, ref_depth.dtype, ref_depth.device)
    pc = unproject(grid, Ks[ref_idx], Rs[ref_idx], ts[ref_idx], ref_depth)
    valid = (ref_depth > 0) & ~used[ref_idx]
    consistent, src_pts, flats = _consistency(
        pc, grid, ref_idx, depths, used, Ks, Rs, ts, disp_threshold,
        max_reproj_error)
    count = consistent.sum(0)
    # num_consistent counts the reference itself (reference
    # filtering.py:81-83): >= num_consistent - 1 agreeing sources
    keep = valid & (count >= num_consistent - 1)
    csum = (src_pts * consistent[..., None]).sum(0) + pc
    point = csum / (count[..., None] + 1.0)
    new_used = []
    for i in range(len(depths)):
        consumed = (consistent[i] & keep).reshape(-1).to(torch.uint8)
        upd = torch.zeros(used[i].numel(), dtype=torch.uint8,
                          device=used[i].device).scatter_reduce_(
            0, flats[i].reshape(-1), consumed, reduce="amax")
        upd = upd.reshape(used[i].shape).bool()
        if i == ref_idx:
            upd = upd | keep
        new_used.append(used[i] | upd)
    return point.reshape(-1, 3), keep.reshape(-1), new_used


def fuse_depthmaps(depths, Ks: np.ndarray, Rs: np.ndarray, ts: np.ndarray,
                   colors=None, disp_threshold: float = 0.01,
                   num_consistent: int = 3,
                   max_reproj_error: float | None = None,
                   device: str | torch.device | None = None):
    """Fuse every view's (pre-masked) depthmap into one point cloud.

    Args:
      depths: [N, H, W], or a list of per-view [H_i, W_i] maps whose sizes
        may differ; invalid pixels are 0 (masked upstream, reference
        evaluation/fusibile.py:152-158).
      Ks, Rs: [N, 3, 3]; ts: [N, 3, 1].
      colors: optional [N, H, W, 3] (or a matching list) float in [0, 1]
        or uint8.
      device: "cuda" (default; raises without a card) or "cpu".
    Returns:
      (points [M, 3] float32, colors [M, 3] uint8 or None).
    """
    dev = resolve_device(device)
    n = len(depths)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    Ks_t, Rs_t, ts_t = tensor(Ks), tensor(Rs), tensor(ts)
    depths_t = [tensor(d) for d in depths]
    used = [torch.zeros(d.shape, dtype=torch.bool, device=dev)
            for d in depths_t]
    all_pts, all_cols = [], []
    for r in range(n):
        point, keep, used = _fuse_one_view(
            r, depths_t, used, Ks_t, Rs_t, ts_t,
            disp_threshold=disp_threshold, num_consistent=num_consistent,
            max_reproj_error=max_reproj_error)
        keep_np = keep.cpu().numpy()
        all_pts.append(point.cpu().numpy()[keep_np])
        if colors is not None:
            col = np.asarray(colors[r]).reshape(-1, 3)[keep_np]
            if col.dtype != np.uint8:
                col = (np.clip(col, 0, 1) * 255).astype(np.uint8)
            all_cols.append(col)
    points = (np.concatenate(all_pts, axis=0) if all_pts
              else np.zeros((0, 3), np.float32))
    cols = (np.concatenate(all_cols, axis=0)
            if colors is not None and all_cols else None)
    return points, cols
