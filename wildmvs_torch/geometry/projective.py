"""Projective geometry core, batched torch functions over channels-last data.

Counterpart of wildmvs/geometry/projective.py, the quaternion helpers
(quat_to_rot, rot_to_quat, relative_pose) included. Conventions:

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


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (wxyz) -> rotation matrix. Parity: utils/utils_3D.py:326-343.

    Args: q [N, 4]. Returns [N, 3, 3].
    """
    a, b, c, d = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    a2, b2, c2, d2 = a * a, b * b, c * c, d * d
    rows = [
        torch.stack([a2 + b2 - c2 - d2, 2 * b * c - 2 * a * d,
                     2 * a * c + 2 * b * d], -1),
        torch.stack([2 * a * d + 2 * b * c, a2 - b2 + c2 - d2,
                     2 * c * d - 2 * a * b], -1),
        torch.stack([2 * b * d - 2 * a * c, 2 * a * b + 2 * c * d,
                     a2 - b2 - c2 + d2], -1),
    ]
    return torch.stack(rows, dim=-2)


def rot_to_quat(M: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (wxyz), branch-free (torch.where).

    Parity: utils/utils_3D.py:345-378 (Shepperd's method, 4 cases on the
    dominant diagonal entry, each evaluated for every matrix, then one
    selected).

    Args: M [N, 3, 3]. Returns [N, 4] unit quaternions.
    """
    m = M
    tr = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12))

    # case 1: trace dominant
    s1 = 2.0 * safe_sqrt(1.0 + tr)
    q1 = torch.stack([0.25 * s1,
                      (m[:, 2, 1] - m[:, 1, 2]) / s1,
                      (m[:, 0, 2] - m[:, 2, 0]) / s1,
                      (m[:, 1, 0] - m[:, 0, 1]) / s1], -1)
    # case 2: m00 dominant
    s2 = 2.0 * safe_sqrt(1.0 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2])
    q2 = torch.stack([(m[:, 2, 1] - m[:, 1, 2]) / s2,
                      0.25 * s2,
                      (m[:, 0, 1] + m[:, 1, 0]) / s2,
                      (m[:, 0, 2] + m[:, 2, 0]) / s2], -1)
    # case 3: m11 dominant
    s3 = 2.0 * safe_sqrt(1.0 + m[:, 1, 1] - m[:, 0, 0] - m[:, 2, 2])
    q3 = torch.stack([(m[:, 0, 2] - m[:, 2, 0]) / s3,
                      (m[:, 0, 1] + m[:, 1, 0]) / s3,
                      0.25 * s3,
                      (m[:, 1, 2] + m[:, 2, 1]) / s3], -1)
    # case 4: m22 dominant
    s4 = 2.0 * safe_sqrt(1.0 + m[:, 2, 2] - m[:, 0, 0] - m[:, 1, 1])
    q4 = torch.stack([(m[:, 1, 0] - m[:, 0, 1]) / s4,
                      (m[:, 0, 2] + m[:, 2, 0]) / s4,
                      (m[:, 1, 2] + m[:, 2, 1]) / s4,
                      0.25 * s4], -1)

    cond1 = tr > 0
    cond2 = (~cond1) & (m[:, 0, 0] > m[:, 1, 1]) & (m[:, 0, 0] > m[:, 2, 2])
    cond3 = (~cond1) & (~cond2) & (m[:, 1, 1] > m[:, 2, 2])
    q = torch.where(cond1[:, None], q1,
                    torch.where(cond2[:, None], q2,
                                torch.where(cond3[:, None], q3, q4)))
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def relative_pose(R1: torch.Tensor, t1: torch.Tensor, R2: torch.Tensor,
                  t2: torch.Tensor):
    """Pose of view 2 relative to view 1. Parity: utils/utils_3D.py:380-383."""
    R = R2 @ R1.T
    t = t2 - R @ t1
    return R, t
