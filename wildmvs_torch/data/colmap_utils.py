"""COLMAP-scene helpers: calibration extraction, depth ranges, source-view
selection, and native triangulation.

The port's own copy of wildmvs/data/colmap_utils.py. Reference utils/colmap_utils.py:52-155 (pure reimplementation) plus a native
replacement for the `colmap point_triangulator` subprocess
(utils/colmap_utils.py:156-231): multi-view DLT triangulation of known-pose
feature tracks — preprocessing, not hot path, so host numpy.
"""
from __future__ import annotations

import numpy as np

from .colmap_model import Camera, Image, Point3D, qvec2rotmat


def compute_K_colmap(params: np.ndarray) -> np.ndarray:
    """PINHOLE-family params -> K. Parity: colmap_utils.py:52-57."""
    return np.array([[params[0], 0, params[2]],
                     [0, params[1], params[3]],
                     [0, 0, 1]])


def get_calib_from_sparse(cameras: dict, images: dict):
    """Stack K/R/t/sizes over images (insertion order).
    Parity: colmap_utils.py:147-154."""
    K = np.array([compute_K_colmap(cameras[images[i].camera_id].params)
                  for i in images], np.float32)
    R = np.stack([qvec2rotmat(images[i].qvec) for i in images]).astype(np.float32)
    t = np.array([images[i].tvec for i in images], np.float32)[..., None]
    sizes = np.array([[cameras[images[i].camera_id].width,
                       cameras[images[i].camera_id].height]
                      for i in images], np.float32)
    return K, R, t, sizes


def compute_min_max_depth(points3d: dict, images: dict, K, R, t,
                          perc=(1, 99)):
    """Per-view depth range = percentiles of that view's observed sparse
    points. Parity: colmap_utils.py:59-72 (compute_min_max_depth_yao)."""
    n = len(images)
    dmin = np.zeros(n)
    dmax = np.zeros(n)
    for idx, im_id in enumerate(images):
        pts = np.array([points3d[p].xyz for p in images[im_id].point3D_ids
                        if p != -1 and p in points3d])
        if len(pts) > 0:
            cam = pts @ R[idx].T + t[idx][:, 0]
            depth = cam[:, 2]
            dmin[idx], dmax[idx] = np.percentile(depth, perc)
    return dmin, dmax


def compute_src_images(images: dict, points3d: dict, R, t,
                       min_triangulation_angle: float, nsrc: int,
                       nb_points_thresh: int | None = None,
                       rng: np.random.Generator | None = None):
    """Source-view selection: co-visible point counts gated by a >=75%
    well-triangulated requirement, then top-nsrc.
    Parity: colmap_utils.py:101-145 (compute_src_imgs)."""
    n = len(images)
    im_ids = list(images.keys())
    id_to_idx = {im_ids[i]: i for i in range(n)}

    adj = np.zeros((n, n), np.int64)
    adj_tri = np.zeros((n, n), np.int64)

    R_rel = R[None, :] @ np.transpose(R[:, None], (0, 1, 3, 2))
    t_rel = t[None, :] - R_rel @ t[:, None]
    rel_center = (np.transpose(R_rel, (0, 1, 3, 2)) @ t_rel).squeeze(3)  # NxNx3

    for p in points3d:
        point = points3d[p]
        idxs = np.array([id_to_idx[i] for i in point.image_ids
                         if i in id_to_idx])
        if idxs.size == 0:
            continue
        ray1 = point.xyz
        ray2 = point.xyz + rel_center
        cos = np.clip(np.sum(ray1 * ray2, axis=-1)
                      / np.linalg.norm(ray1) / np.linalg.norm(ray2, axis=-1),
                      -1, 1)
        tri = np.degrees(np.arccos(cos))
        seen = np.zeros((n, n), bool)
        seen[idxs[None, :], idxs[:, None]] = True
        adj[idxs[None, :], idxs[:, None]] += 1
        adj_tri[(tri > min_triangulation_angle) & seen] += 1

    sel = []
    for i in range(n):
        common = adj[i].copy()
        common[adj_tri[i] < 0.75 * adj[i]] = 0
        if nb_points_thresh is None:
            sel.append(np.argsort(common)[-nsrc:].tolist())
        else:
            cand = np.nonzero(common > nb_points_thresh)[0]
            if len(cand) < nsrc:
                sel.append([])
            else:
                rng = rng or np.random.default_rng(0)
                sel.append(rng.choice(cand, nsrc, replace=False).tolist())
    return sel


def triangulate_dlt(obs_px: np.ndarray, Ks: np.ndarray, Rs: np.ndarray,
                    ts: np.ndarray) -> np.ndarray:
    """Multi-view DLT triangulation of one track.

    Native replacement for `colmap point_triangulator` when poses are known
    (colmap_utils.py:171-227 shells out for this).

    Args:
      obs_px: [M, 2] pixel observations.
      Ks, Rs, ts: [M, 3, 3]/[M, 3, 3]/[M, 3, 1] of the observing views.
    Returns:
      [3] world point (least-squares).
    """
    m = obs_px.shape[0]
    A = np.zeros((2 * m, 4))
    for i in range(m):
        P = np.zeros((3, 4))
        P[:3, :3] = Ks[i] @ Rs[i]
        P[:3, 3:] = Ks[i] @ ts[i]
        x, y = obs_px[i]
        A[2 * i] = x * P[2] - P[0]
        A[2 * i + 1] = y * P[2] - P[1]
    _, _, vh = np.linalg.svd(A)
    X = vh[-1]
    return X[:3] / X[3]


def triangulate_tracks(images: dict, Ks, Rs, ts, min_views: int = 2,
                       max_reproj_error: float = 4.0):
    """Triangulate all matched 2D tracks into Point3Ds with reprojection
    filtering (the point_triangulator role for known-pose scenes).

    `images[i].point3D_ids` here are *track ids* (matched groups); returns a
    dict of Point3D keyed by track id.
    """
    id_list = list(images.keys())
    id_to_idx = {id_list[i]: i for i in range(len(id_list))}
    tracks: dict[int, list] = {}
    for im_id, im in images.items():
        for j, tid in enumerate(im.point3D_ids):
            if tid < 0:
                continue
            tracks.setdefault(int(tid), []).append((im_id, j))
    points = {}
    for tid, obs in tracks.items():
        if len(obs) < min_views:
            continue
        idxs = [id_to_idx[i] for i, _ in obs]
        px = np.array([images[i].xys[j] for i, j in obs])
        X = triangulate_dlt(px, Ks[idxs], Rs[idxs], ts[idxs])
        # reprojection check
        cam = np.einsum("mij,j->mi", Rs[idxs], X) + ts[idxs][:, :, 0]
        depth = cam[:, 2]
        proj = np.einsum("mij,mj->mi", Ks[idxs], cam)
        proj2 = proj[:, :2] / np.maximum(proj[:, 2:], 1e-9)
        err = np.linalg.norm(proj2 - px, axis=1)
        good = (depth > 0) & (err < max_reproj_error)
        if good.sum() >= min_views:
            points[tid] = Point3D(
                tid, X, np.array([128, 128, 128]), float(err[good].mean()),
                np.array([o[0] for o, g in zip(obs, good) if g], np.int32),
                np.array([o[1] for o, g in zip(obs, good) if g], np.int32))
    return points
