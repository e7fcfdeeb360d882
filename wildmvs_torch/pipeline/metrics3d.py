"""3D reconstruction metrics: the DTU MATLAB benchmark and the YFCC chamfer
protocol.

The port's own numpy/scipy copy of wildmvs/pipeline/metrics3d.py
(reference evaluation/metrics.py): duplicate-point reduction by a k-d tree
radius dedup (0.2 mm, :38-64), chamfer distances chunked over 60 mm grid
cells (:141-167), ObsMask / bounding-box / plane validity (:99-139), and
the YFCC chamfer with a cutoff of 10x the scene resolution (:76-96).
`reduce_pts` (not chunked) and `chamfer_nn` take the port's native C++ k-d
tree (wildmvs_torch/cpp, a copy of the JAX package's) first, as the JAX
package does, and scipy's cKDTree when it did not build; `chamfer_cells`
and the chunked dedup take cKDTree. Where the native tree returns the
cutoff for a point beyond it, cKDTree returns inf; every consumer clips at
the cutoff. `summarize_dtu` reduces the raw distances to the protocol's
accuracy and completeness means.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
from scipy.spatial import cKDTree

from ..cpp import NativeKDTree, radius_dedup as _native_dedup


def format_point_cloud(vertices) -> np.ndarray:
    """Structured PLY vertices -> [N, 3], NaNs dropped."""
    pts = np.stack((vertices["x"], vertices["y"], vertices["z"]), axis=1)
    return pts[~(np.isnan(pts).any(axis=1))].astype(np.float64)


def reduce_pts(pts: np.ndarray, radius: float, chunked: bool = False,
               seed: int = 0):
    """Random-order radius dedup: keep a point, drop everything within
    `radius` of it. Parity: metrics.py:38-64 (incl. the chunked low-memory
    variant)."""
    n = pts.shape[0]
    keep = np.ones((n,), dtype=bool)
    rand_ord = np.random.default_rng(seed).permutation(n)
    if not chunked:
        try:
            keep = _native_dedup(np.asarray(pts, np.float64), radius, rand_ord)
            return pts[keep], keep
        except RuntimeError:
            pass                    # the native library did not build
    kdtree = cKDTree(pts)
    if chunked:
        chunks = list(range(0, n, min(int(4e6), max(n - 1, 1))))
        chunks.append(n)
        for i in range(len(chunks) - 1):
            s, e = chunks[i], chunks[i + 1]
            idx = kdtree.query_ball_point(pts[rand_ord[s:e]], radius,
                                          workers=8)
            for j in range(len(idx)):
                pid = rand_ord[s + j]
                if keep[pid]:
                    keep[idx[j]] = False
                    keep[pid] = True
    else:
        idx = kdtree.query_ball_tree(kdtree, radius)
        for j in range(n):
            pid = rand_ord[j]
            if keep[pid]:
                keep[idx[pid]] = False
                keep[pid] = True
    return pts[keep], keep


def chamfer_cells(pts_from: np.ndarray, pts_to: np.ndarray, bb: np.ndarray,
                  maxdist: float) -> np.ndarray:
    """NN distance from each pts_from to pts_to, computed per maxdist-sized
    grid cell with a 1-cell halo. Parity: metrics.py:141-167."""
    rx, ry, rz = np.floor((bb[1, :] - bb[0, :]) / maxdist).astype(int)
    dist = np.ones(pts_from.shape[0]) * maxdist
    for x in range(rx + 1):
        for y in range(ry + 1):
            for z in range(rz + 1):
                low = bb[0, :] + np.array([x, y, z]) * maxdist
                high = low + maxdist
                vf = ((pts_from >= low[None]).all(axis=1)
                      & (pts_from < high[None]).all(axis=1))
                lo2, hi2 = low - maxdist, high + maxdist
                vt = ((pts_to >= lo2[None]).all(axis=1)
                      & (pts_to < hi2[None]).all(axis=1))
                if vt.sum() == 0:
                    dist[vf] = maxdist
                elif vf.sum() > 0:
                    kd = cKDTree(pts_to[vt])
                    dist[vf] = kd.query(pts_from[vf], workers=8,
                                        distance_upper_bound=maxdist)[0]
    return dist


def chamfer_nn(pts_from: np.ndarray, pts_to: np.ndarray,
               maxdist: float = np.inf) -> np.ndarray:
    """Plain NN distance with a cutoff. Parity: metrics.py:93-96.
    The native tree returns maxdist for cut-off points where scipy returns
    inf; all consumers clip at maxdist anyway."""
    if pts_to.shape[0] > 0:
        try:
            return NativeKDTree(np.asarray(pts_to, np.float64)).nn_distance(
                np.asarray(pts_from, np.float64), maxdist)
        except RuntimeError:
            pass                    # the native library did not build
    kd = cKDTree(pts_to)
    return kd.query(pts_from, distance_upper_bound=maxdist, workers=8)[0]


def add_hom(pts: np.ndarray) -> np.ndarray:
    return np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)


def eval_dtu(pred_pts: np.ndarray, gt_pts: np.ndarray, mask: np.ndarray,
             bb: np.ndarray, res: float, plane: np.ndarray,
             dedup_radius: float = 0.2, maxdist: float = 60.0,
             chunked: bool = False) -> dict:
    """DTU protocol. Parity: metrics.py:99-139.

    Args:
      pred_pts: fused prediction [M, 3] (mm).
      gt_pts: GT structured-light points [G, 3].
      mask: ObsMask voxel validity volume.
      bb: [2, 3] bounding box; res: voxel resolution; plane: [4] floor plane.
    Returns raw dict like the reference pickles (+ the inputs needed for
    summarize_dtu).
    """
    pred_pts, _ = reduce_pts(pred_pts, dedup_radius, chunked=chunked)
    above_plane = (add_hom(gt_pts) @ np.asarray(plane).reshape(4)) > 0
    norm_pts = np.rint((pred_pts - bb[0:1]) / res).astype(int)
    valid1 = ((norm_pts >= 0).all(axis=1)
              & (norm_pts < np.array(mask.shape)[None]).all(axis=1))
    npv = norm_pts[valid1]
    valid_mask = np.zeros((pred_pts.shape[0],), dtype=bool)
    valid2 = mask.astype(bool)[npv[:, 0], npv[:, 1], npv[:, 2]]
    valid_mask[np.where(valid1)[0][valid2]] = True
    dist_gt_to_pred = chamfer_cells(gt_pts, pred_pts, bb, maxdist)
    dist_pred_to_gt = chamfer_cells(pred_pts, gt_pts, bb, maxdist)
    return {
        "margin": 10, "maxdist": maxdist, "abovePlane": above_plane,
        "validMask": valid_mask, "dist_gtToPred": dist_gt_to_pred,
        "dist_predToGt": dist_pred_to_gt,
    }


def summarize_dtu(raw: dict) -> dict:
    """Reduce the raw distance arrays to the MATLAB protocol's numbers:
    accuracy = mean/median pred->GT distance over ObsMask-valid points,
    completeness = mean/median GT->pred over above-plane GT points."""
    md = raw["maxdist"]
    acc_d = np.minimum(raw["dist_predToGt"][raw["validMask"]], md)
    comp_d = np.minimum(raw["dist_gtToPred"][raw["abovePlane"]], md)
    return {
        "accuracy_mean": float(acc_d.mean()) if acc_d.size else float("nan"),
        "accuracy_median": float(np.median(acc_d)) if acc_d.size else float("nan"),
        "completeness_mean": float(comp_d.mean()) if comp_d.size else float("nan"),
        "completeness_median": float(np.median(comp_d)) if comp_d.size else float("nan"),
        "overall": float((acc_d.mean() + comp_d.mean()) / 2)
        if acc_d.size and comp_d.size else float("nan"),
    }


def eval_yfcc(pred_pts: np.ndarray, gt_pts: np.ndarray,
              scene_resolution: float) -> dict:
    """YFCC chamfer with 10x-resolution cutoff. Parity: metrics.py:76-96."""
    cutoff = 10.0 * scene_resolution
    return {
        "dist_gtToPred": chamfer_nn(gt_pts, pred_pts, maxdist=cutoff),
        "dist_predToGt": chamfer_nn(pred_pts, gt_pts, maxdist=cutoff),
    }


def save_raw(out_path: Path, scene: str, raw: dict):
    out_path.mkdir(parents=True, exist_ok=True)
    with open(out_path / f"dists{scene}.pkl", "wb") as f:
        pickle.dump(raw, f)


def load_dtu_gt(data_path: Path, scene: str):
    """Load ObsMask/Plane .mat files + GT ply for a DTU scan.
    Parity: metrics.py:67-74."""
    from scipy.io import loadmat
    from ..data.ply import read_ply
    scan_id = int(scene[4:])
    loaded = loadmat(Path(data_path) / "ObsMask" / f"ObsMask{scan_id}_10.mat")
    plane = loadmat(Path(data_path) / "ObsMask" / f"Plane{scan_id}.mat")["P"]
    gt = format_point_cloud(read_ply(
        Path(data_path) / "Points" / "stl" / f"stl{scan_id:03d}_total.ply"))
    return gt, loaded["ObsMask"], loaded["BB"], loaded["Res"], plane
