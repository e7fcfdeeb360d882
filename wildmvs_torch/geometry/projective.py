"""Projective geometry core, batched torch functions over channels-last data.

Counterpart of wildmvs/geometry/projective.py:18-220 (the quaternion
helpers are not ported). Conventions:

  * pixel coordinates are (x, y); x goes along width, y along height
  * a pinhole view is (K [3,3], R [3,3], t [3,1]); world->cam: Xc = R Xw + t
  * projection matrices P are 4x4 with [:3,:4] = K [R|t] and P[3,3] = 1
  * depth is z in the camera frame

Inverses use torch.linalg.inv_ex, which skips the error check (a host sync
on the card); the matrices inverted here (intrinsics, projections) are
never singular.
"""
from __future__ import annotations

import torch


def build_proj_matrices(K: torch.Tensor, R: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
    """4x4 projection matrices P = [[K R, K t], [0, 0, 0, 1]].

    Args:
      K: [..., 3, 3] intrinsics.
      R: [..., 3, 3] rotations.
      t: [..., 3, 1] translations.
    Returns:
      [..., 4, 4] projection matrices.
    """
    top = torch.cat([K @ R, K @ t], dim=-1)             # [..., 3, 4]
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def scale_K(K: torch.Tensor, factor) -> torch.Tensor:
    """Scale the first two rows of K by `factor` (resolution change).

    `factor` may be a scalar or a broadcastable tensor: rows 0, 1 *= factor.
    """
    factor = torch.as_tensor(factor, dtype=K.dtype, device=K.device)
    row_scale = torch.stack([factor, factor, torch.ones_like(factor)], -1)
    return K * row_scale[..., :, None]


def pixel_grid(h: int, w: int, dtype=torch.float32, device=None,
               offset: float = 0.0) -> torch.Tensor:
    """[h, w, 2] grid of (x, y) pixel coordinates, optionally center-offset.

    offset=0.0 is the MVSNet integer grid; offset=0.5 the Vis-MVSNet
    pixel-center grid.
    """
    ys = torch.arange(h, dtype=dtype, device=device) + offset
    xs = torch.arange(w, dtype=dtype, device=device) + offset
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def add_hom(pts: torch.Tensor) -> torch.Tensor:
    """Append a homogeneous 1-coordinate."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], -1)


def project(coords: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
            t: torch.Tensor, eps: float = 1e-6):
    """World points [..., 3] into one view (K, R [3, 3], t [3, 1]) ->
    (pixels [..., 2], depth [...]); the depth divisor is clamped at eps."""
    cam = coords @ R.T + t[:, 0]
    pix = cam @ K.T
    depth = pix[..., 2]
    xy = pix[..., :2] / torch.clamp_min(depth[..., None], eps)
    return xy, depth


def project_all(coords: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                t: torch.Tensor, eps: float = 1e-6):
    """World points [..., 3] into N views (K, R [N, 3, 3], t [N, 3, 1]) ->
    (pixels [N, ..., 2], depth [N, ...])."""
    outs = [project(coords, K[i], R[i], t[i], eps) for i in range(K.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def unproject(coords: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
              t: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] with depth [...] in one view -> world points
    [..., 3]."""
    hom = add_hom(coords) * depth[..., None]
    return (hom @ torch.linalg.inv_ex(K)[0].T - t[:, 0]) @ R


def flows_from_single_depthmap(depthmaps: torch.Tensor,
                               proj_mat: torch.Tensor, ref_idx: int,
                               eps: float = 1e-6):
    """Pixel flow from the reference view to each source view: the
    reference depthmaps [B, H, W] unprojected by inv(P_ref) and projected
    by each source P (proj_mat [B, N, 4, 4]). Returns (flows
    [B, N-1, H, W, 2] in source pixels, the points' depth in each source
    camera [B, N-1, H, W])."""
    b, h, w = depthmaps.shape
    n = proj_mat.shape[1]
    src_idx = [i for i in range(n) if i != ref_idx]
    inv_ref = torch.linalg.inv_ex(proj_mat[:, ref_idx])[0]     # [B, 4, 4]
    grid = pixel_grid(h, w, depthmaps.dtype,
                      depthmaps.device).reshape(1, h * w, 2)
    pts = add_hom(add_hom(grid) * depthmaps.reshape(b, h * w, 1))
    world = pts @ inv_ref.transpose(-1, -2)                   # [B, HW, 4]
    src_P = proj_mat[:, src_idx]                              # [B, N-1, 4, 4]
    reproj = world[:, None] @ src_P.transpose(-1, -2)         # [B, N-1, HW, 4]
    depth = reproj[..., 2]
    flow = reproj[..., :2] / torch.clamp_min(depth[..., None], eps)
    return flow.reshape(b, n - 1, h, w, 2), depth.reshape(b, n - 1, h, w)


def normalize_flow(flow: torch.Tensor, h, w, align_corners: bool = False,
                   clamp: float | None = None) -> torch.Tensor:
    """Pixel coordinates [..., 2] -> [-1, 1] normalized coordinates in
    either grid_sample convention, optionally clamped to +-clamp."""
    if align_corners:
        x = 2.0 * flow[..., 0] / (w - 1.0) - 1.0
        y = 2.0 * flow[..., 1] / (h - 1.0) - 1.0
    else:
        x = (2.0 * flow[..., 0] + 1.0) / w - 1.0
        y = (2.0 * flow[..., 1] + 1.0) / h - 1.0
    res = torch.stack([x, y], -1)
    if clamp is not None:
        res = torch.clamp(res, -clamp, clamp)
    return res


def unnormalize_flow(flow: torch.Tensor, h, w) -> torch.Tensor:
    """[-1, 1] normalized coordinates [..., 2] -> pixel coordinates
    (align_corners=True convention)."""
    x = (w - 1.0) * (flow[..., 0] + 1.0) / 2.0
    y = (h - 1.0) * (flow[..., 1] + 1.0) / 2.0
    return torch.stack([x, y], -1)


def compute_triangulation_angles(point_cloud: torch.Tensor, R: torch.Tensor,
                                 t: torch.Tensor,
                                 ref_idx: int = 0) -> torch.Tensor:
    """Triangulation angle in degrees of each point [H, W, 3] (world)
    between the reference camera and each source camera (R [N, 3, 3],
    t [N, 3, 1]) -> [N-1, H, W]."""
    n = R.shape[0]
    src_idx = [i for i in range(n) if i != ref_idx]
    centers = -R.transpose(-1, -2) @ t                        # [N, 3, 1]
    ray_ref = point_cloud - centers[ref_idx, :, 0]
    rays_src = point_cloud[None] - centers[src_idx][:, None, None, :, 0]
    num = torch.sum(ray_ref[None] * rays_src, -1)
    den = (torch.clamp_min(torch.linalg.vector_norm(ray_ref, dim=-1),
                           1e-12)[None]
           * torch.clamp_min(torch.linalg.vector_norm(rays_src, dim=-1),
                             1e-12))
    cos = torch.clamp(num / den, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def compute_triangulation_angle(point_cloud: torch.Tensor, R: torch.Tensor,
                                t: torch.Tensor) -> torch.Tensor:
    """Triangulation angle in degrees of points [M, 3] in frame 1 between a
    view pair of relative pose (R [3, 3], t [3, 1]) -> [M]."""
    ray1 = point_cloud
    ray2 = point_cloud + (R.T @ t)[:, 0]
    cos = torch.clamp(
        torch.sum(ray1 * ray2, -1)
        / torch.clamp_min(torch.linalg.vector_norm(ray1, dim=-1), 1e-12)
        / torch.clamp_min(torch.linalg.vector_norm(ray2, dim=-1), 1e-12),
        -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))
