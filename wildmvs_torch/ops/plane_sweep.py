"""Plane-sweep warping: the exact gather path of both grid conventions.

Counterpart of wildmvs/ops/plane_sweep.py:28-281. Everything the port's
Hopper kernels compute is checked against this path.

  * MVSNet convention (reference models/MVSNet/module.py:111-169):
    integer pixel grid, behind-camera points sent to pixel -10,
    align_corners=True normalization x_n = x/((W-1)/2) - 1, grid clamped
    to [-10, 10].
  * Vis-MVSNet convention (reference models/VisMVSNet/homography.py:23-121):
    pixel-centre grid (+0.5), plane-induced homographies H(d) = A - B/d,
    normalization x_n = 2 x / W - 1 clamped to [-1.1, 1.1], behind-camera
    -> pixel -10, align_corners=True sample.

The geometry (grids, homographies, coordinates) is f32 whatever the
feature dtype. (The JAX package builds the Vis pixel grid in the feature
dtype, plane_sweep.py:191 and :237, which at bf16 puts pixel centres above
256 on a 2-4 px lattice; the port does not copy that.) Sampling
coordinates carry no gradient: the reference builds its grids under
no_grad.

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


# ---------------------------------------------------------------------------
# Vis-MVSNet convention: plane-induced homographies + pixel-centre sampling.
# ---------------------------------------------------------------------------

def get_homographies(K_ref, R_ref, t_ref, K_src, R_src, t_src,
                     depth_num: int, depth_start, depth_interval,
                     inverse_depth: bool = False) -> torch.Tensor:
    """Fronto-parallel plane-induced homographies per depth hypothesis
    (reference homography.py:23-74; the JAX package's get_homographies).

    Args:
      K_ref, R_ref: [B, 3, 3]; t_ref: [B, 3, 1]; the same for src.
      depth_start: [B, 1, 1, 1] or [B, 1, H, W]; depth_interval [B, 1, 1, 1].
    Returns:
      [B, D, H', W', 3, 3] f32 homographies (H', W' those of depth_start).
    """
    K_ref, R_ref, t_ref, K_src, R_src, t_src = (
        a.float() for a in (K_ref, R_ref, t_ref, K_src, R_src, t_src))
    d = depth_num
    steps = torch.arange(d, dtype=torch.float32,
                         device=K_ref.device).reshape(1, d, 1, 1)
    depth_start = depth_start.float()
    depth_interval = depth_interval.float()
    if not inverse_depth:
        depth = depth_start + depth_interval * steps
    else:
        depth_end = depth_start + (d - 1) * depth_interval
        inv_interv = ((1.0 / (depth_start + 1e-9) - 1.0 / (depth_end + 1e-9))
                      / (d - 1 + 1e-9))
        depth = 1.0 / (1.0 / (depth_end + 1e-9) + inv_interv * steps)
    depth = depth[..., None, None]                  # [B, D, H', W', 1, 1]
    K_ref_inv = torch.linalg.inv(K_ref)
    R_ref_T = R_ref.transpose(-1, -2)
    fronto = R_ref[:, 2:3, :]
    c_rel = (-R_src.transpose(-1, -2) @ t_src) - (-R_ref_T @ t_ref)
    temp = (c_rel @ fronto)[:, None, None, None]
    eye = torch.eye(3, dtype=torch.float32, device=K_ref.device)
    mid0 = eye - temp / (depth + 1e-9)
    mid1 = (R_ref_T @ K_ref_inv)[:, None, None, None]
    return (K_src @ R_src)[:, None, None, None] @ (mid0 @ mid1)


def _vis_normalize(wx, wy, z, src_hw):
    """Projective (wx, wy, z) -> the reference's normalized grid
    (homography.py:85-121): behind the camera -> pixel -10, divided by the
    size, x 2 - 1, clamped to [-1.1, 1.1]."""
    sh, sw = src_hw
    zs = torch.clamp_min(z, 1e-9)
    x = torch.where(z > 0, wx / zs, -10.0)
    y = torch.where(z > 0, wy / zs, -10.0)
    xn = torch.clamp(x / sw * 2.0 - 1.0, -1.1, 1.1)
    yn = torch.clamp(y / sh * 2.0 - 1.0, -1.1, 1.1)
    return xn, yn


def homography_warp(src: torch.Tensor, H: torch.Tensor,
                    ref_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """Warp source features by (possibly per-pixel) homographies
    (reference homography.py:85-121).

    Args:
      src: [B, h, w, C] source features.
      H: [B, 3, 3] or [B, H, W, 3, 3] homographies mapping reference
        pixels (centre convention, +0.5) to source pixels.
      ref_hw: output grid size (defaults to the source size).
    Returns:
      [B, H, W, C] in the feature dtype.
    """
    if ref_hw is None:
        ref_hw = tuple(src.shape[1:3])
    rh, rw = ref_hw
    with torch.no_grad():
        grid = pixel_grid(rh, rw, torch.float32, src.device, offset=0.5)
        hom = torch.cat([grid, torch.ones_like(grid[..., :1])], -1)
        H = H.float()
        if H.dim() == 3:
            warped = torch.einsum("bij,hwj->bhwi", H, hom)
        else:
            warped = torch.einsum("bhwij,hwj->bhwi", H, hom)
        xn, yn = _vis_normalize(warped[..., 0], warped[..., 1],
                                warped[..., 2], tuple(src.shape[1:3]))
    return grid_sample_xy(src, xn, yn, align_corners=True)


def homography_sweep_grid_xy(src_hw: tuple[int, int], K_ref, R_ref, t_ref,
                             K_src, R_src, t_src, depth_num: int,
                             depth_start, depth_interval,
                             ref_hw: tuple[int, int],
                             steps: range | None = None):
    """Normalized (xn, yn) planes of the Vis-MVSNet homography sweep, f32
    and without gradient.

    The plane-induced homography is H(d) = A - B/d with A = K_src R_src
    R_ref^T K_ref^-1 and B = K_src R_src c_rel f^T R_ref^T K_ref^-1 (f the
    reference's fronto direction), so the warped coordinate of pixel p at
    depth d is A p - (B p)/d (the JAX package's factoring,
    plane_sweep.py:209-260).

    Args:
      src_hw: (h, w) of the source map (for normalization).
      K_ref, R_ref, t_ref, K_src, R_src, t_src: [B, 3, 3] / [B, 3, 1].
      depth_num: D; the hypotheses are depth_start + depth_interval * i.
      depth_start: [B, 1, 1, 1] or [B, 1, H, W]; depth_interval
        [B, 1, 1, 1].
      ref_hw: (H, W) of the reference grid.
      steps: the hypothesis indices to build (default all D).
    Returns:
      (xn, yn): two [B, len(steps), H, W] f32 planes in [-1.1, 1.1].
    """
    rh, rw = ref_hw
    steps = range(depth_num) if steps is None else steps
    with torch.no_grad():
        K_ref, R_ref, t_ref, K_src, R_src, t_src = (
            a.float() for a in (K_ref, R_ref, t_ref, K_src, R_src, t_src))
        b = K_ref.shape[0]
        K_ref_inv = torch.linalg.inv(K_ref)
        R_ref_T = R_ref.transpose(-1, -2)
        fronto = R_ref[:, 2:3, :]
        c_rel = (-R_src.transpose(-1, -2) @ t_src) - (-R_ref_T @ t_ref)
        M = K_src @ R_src
        A = M @ R_ref_T @ K_ref_inv
        Bm = M @ (c_rel @ fronto) @ R_ref_T @ K_ref_inv
        grid = pixel_grid(rh, rw, torch.float32, K_ref.device, offset=0.5)
        hom = torch.cat([grid, torch.ones_like(grid[..., :1])], -1)
        Ap = torch.einsum("bij,hwj->bihw", A, hom)   # [B, 3, H, W]
        Bp = torch.einsum("bij,hwj->bihw", Bm, hom)
        idx = torch.tensor(list(steps), dtype=torch.float32,
                           device=K_ref.device).reshape(1, -1, 1, 1)
        depth = depth_start.float() + depth_interval.float() * idx
        de = depth.expand(b, idx.shape[1], rh, rw) + 1e-9
        return _vis_normalize(Ap[:, 0, None] - Bp[:, 0, None] / de,
                              Ap[:, 1, None] - Bp[:, 1, None] / de,
                              Ap[:, 2, None] - Bp[:, 2, None] / de, src_hw)


def homography_sweep_warp(src: torch.Tensor, K_ref, R_ref, t_ref, K_src,
                          R_src, t_src, depth_num: int, depth_start,
                          depth_interval,
                          ref_hw: tuple[int, int] | None = None,
                          steps: range | None = None) -> torch.Tensor:
    """Vis-MVSNet cost-volume warp: [B, D, H, W, C] through per-depth
    homographies (reference model_cas.py:176-187 + homography.py:23-121).

    depth_start may be [B, 1, 1, 1] or a per-pixel [B, 1, H, W] map
    (cascade stages 2-3 re-centre the slab per pixel). `steps` (default
    all D) picks the hypotheses to warp, a contiguous range: the output
    then holds len(steps) planes. Runs in depth slabs
    (`gather_chunk_planes`), written into one output.
    """
    b, sh, sw, c = src.shape
    if ref_hw is None:
        ref_hw = (sh, sw)
    steps = range(depth_num) if steps is None else steps
    out = src.new_empty((b, len(steps)) + tuple(ref_hw) + (c,))
    dc = gather_chunk_planes(len(steps), ref_hw, c, GATHER_CHUNK_BYTES)
    for d0 in range(0, len(steps), dc):
        chunk = steps[d0:d0 + dc]
        xn, yn = homography_sweep_grid_xy(
            (sh, sw), K_ref, R_ref, t_ref, K_src, R_src, t_src, depth_num,
            depth_start, depth_interval, ref_hw, chunk)
        out[:, d0:d0 + len(chunk)] = grid_sample_xy(
            src, xn, yn, align_corners=True)
    return out
