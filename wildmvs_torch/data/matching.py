"""The matching front end: a sparse model for scenes with known poses.

Counterpart of wildmvs/data/matching.py, on host numpy, as there. The
reference's in-the-wild ingest runs the COLMAP binaries (`colmap
feature_extractor`, `exhaustive_matcher` and a triangulation,
utils/colmap_utils.py:156-231 `create_colmap_sparse`) only to get a
sparse model of scenes whose poses are known: the later stages read it
for co-visibility source selection (`compute_src_images`) and percentile
depth ranges (`compute_min_max_depth`). This module builds that model
without the binaries:

  Harris corners -> mean- and contrast-normalized patch descriptors ->
  mutual ZNCC matching gated by the known epipolar geometry (the gate is
  what lets plain patches match) -> union-find tracks -> the DLT
  `triangulate_tracks` (data/colmap_utils.py) -> a COLMAP model written
  through data/colmap_model.

Scenes without known poses need full SfM, which is not reimplemented:
bring a COLMAP sparse model for them.
"""
from __future__ import annotations

import collections
from pathlib import Path

import numpy as np

from .colmap_model import Camera, Image, rotmat2qvec, write_model
from .colmap_utils import triangulate_tracks


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

def _box_sum(x: np.ndarray, r: int) -> np.ndarray:
    """Sum over a (2r+1)^2 window via integral image (edge-padded)."""
    p = np.pad(x, r, mode="edge")
    c = np.cumsum(np.cumsum(p, 0), 1)
    c = np.pad(c, ((1, 0), (1, 0)))
    k = 2 * r + 1
    return (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k])


def harris_keypoints(gray: np.ndarray, max_kp: int = 2048,
                     nms_radius: int = 4, k: float = 0.04,
                     border: int = 8) -> np.ndarray:
    """Harris corners with local-max NMS. gray [H, W] float; returns
    [K, 2] (x, y) float32 sorted by response."""
    g = gray.astype(np.float64)
    ix = np.zeros_like(g)
    iy = np.zeros_like(g)
    ix[:, 1:-1] = (g[:, 2:] - g[:, :-2]) * 0.5
    iy[1:-1, :] = (g[2:, :] - g[:-2, :]) * 0.5
    sxx = _box_sum(ix * ix, 2)
    syy = _box_sum(iy * iy, 2)
    sxy = _box_sum(ix * iy, 2)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    resp = det - k * tr * tr
    # NMS: keep strict local maxima over the (2r+1) window
    r = nms_radius
    p = np.pad(resp, r, constant_values=-np.inf)
    win = np.lib.stride_tricks.sliding_window_view(p, (2 * r + 1, 2 * r + 1))
    is_max = resp >= win.max(axis=(2, 3))
    resp = np.where(is_max, resp, -np.inf)
    resp[:border] = resp[-border:] = -np.inf
    resp[:, :border] = resp[:, -border:] = -np.inf
    flat = resp.ravel()
    n = min(max_kp, int(np.isfinite(flat).sum()))
    if n == 0:
        return np.zeros((0, 2), np.float32)
    idx = np.argpartition(-flat, n - 1)[:n]
    idx = idx[np.argsort(-flat[idx])]
    ys, xs = np.unravel_index(idx, resp.shape)
    return np.stack([xs, ys], -1).astype(np.float32)


def patch_descriptors(gray: np.ndarray, kps: np.ndarray,
                      radius: int = 5) -> np.ndarray:
    """Mean-removed, L2-normalized intensity patches -> [K, (2r+1)^2].
    Dot products between them are ZNCC scores."""
    g = np.pad(gray.astype(np.float32), radius, mode="edge")
    k = 2 * radius + 1
    out = np.empty((len(kps), k * k), np.float32)
    for i, (x, y) in enumerate(kps.astype(np.int64)):
        patch = g[y:y + k, x:x + k].ravel()
        patch = patch - patch.mean()
        out[i] = patch / max(np.linalg.norm(patch), 1e-8)
    return out


# ---------------------------------------------------------------------------
# epipolar-gated matching
# ---------------------------------------------------------------------------

def fundamental_from_poses(KA, RA, tA, KB, RB, tB) -> np.ndarray:
    """F mapping pixels of A to epipolar lines in B (x_B^T F x_A = 0)."""
    R = RB @ RA.T
    t = (tB - R @ tA).reshape(3)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    return np.linalg.inv(KB).T @ E @ np.linalg.inv(KA)


def match_pair(kpsA, dA, kpsB, dB, F=None, epi_thresh: float = 3.0,
               min_score: float = 0.7, ratio: float = 0.95) -> np.ndarray:
    """Mutual-nearest ZNCC matches, optionally epipolar-gated.

    Returns [M, 2] int (idxA, idxB). With F given, candidates farther than
    `epi_thresh` px from the epipolar line are excluded BEFORE the argmax —
    the pose prior doing the disambiguation work SIFT invariance would."""
    if len(kpsA) == 0 or len(kpsB) == 0:
        return np.zeros((0, 2), np.int64)
    score = dA @ dB.T                                    # [KA, KB] ZNCC
    if F is not None:
        ha = np.concatenate([kpsA, np.ones_like(kpsA[:, :1])], 1)
        hb = np.concatenate([kpsB, np.ones_like(kpsB[:, :1])], 1)
        lines = ha @ F.T                                 # [KA, 3] lines in B
        d = np.abs(lines @ hb.T) / np.maximum(
            np.linalg.norm(lines[:, :2], axis=1, keepdims=True), 1e-9)
        score = np.where(d <= epi_thresh, score, -np.inf)
    best_b = score.argmax(1)
    best_a = score.argmax(0)
    ia = np.arange(len(kpsA))
    s1 = score[ia, best_b]
    mutual = (best_a[best_b] == ia) & np.isfinite(s1) & (s1 >= min_score)
    # Lowe-style ratio against the runner-up (on the gated scores)
    if ratio < 1.0 and score.shape[1] > 1:
        tmp = score.copy()
        tmp[ia, best_b] = -np.inf
        s2 = tmp.max(1)
        ok2 = ~np.isfinite(s2) | (s2 <= s1 * (2 - ratio))  # ZNCC in [-1,1]
        mutual &= ok2
    return np.stack([ia[mutual], best_b[mutual]], -1)


# ---------------------------------------------------------------------------
# tracks + sparse model
# ---------------------------------------------------------------------------

class _UnionFind:
    def __init__(self, n):
        self.p = list(range(n))

    def find(self, a):
        while self.p[a] != a:
            self.p[a] = self.p[self.p[a]]
            a = self.p[a]
        return a

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra


def build_tracks(counts: list[int], matches: dict) -> list[np.ndarray]:
    """Union-find track ids from pairwise matches.

    Args:
      counts: keypoints per view.
      matches: {(i, j): [M, 2] index pairs}.
    Returns:
      per-view int64 arrays of track ids (-1 = unmatched keypoint);
      inconsistent tracks (two keypoints of one view) are dropped.
    """
    off = np.cumsum([0] + list(counts))
    uf = _UnionFind(off[-1])
    for (i, j), m in matches.items():
        for a, b in m:
            uf.union(off[i] + int(a), off[j] + int(b))
    root = np.array([uf.find(x) for x in range(off[-1])])
    # drop singleton and view-inconsistent tracks
    members = collections.defaultdict(list)
    for node, r in enumerate(root):
        members[r].append(node)
    valid = {}
    next_id = 0
    for r, nodes in members.items():
        if len(nodes) < 2:
            continue
        views = [np.searchsorted(off, n, side="right") - 1 for n in nodes]
        if len(set(views)) != len(views):
            continue  # a view observed twice -> ambiguous, drop
        valid[r] = next_id
        next_id += 1
    out = []
    for v, c in enumerate(counts):
        ids = np.full(c, -1, np.int64)
        for kp in range(c):
            r = root[off[v] + kp]
            if r in valid:
                ids[kp] = valid[r]
        out.append(ids)
    return out


def create_sparse_from_known_poses(grays, Ks, Rs, ts, names=None,
                                   max_kp: int = 2048,
                                   epi_thresh: float = 3.0,
                                   min_score: float = 0.7,
                                   min_views: int = 2,
                                   max_reproj_error: float = 4.0,
                                   out_dir=None, ext: str = ".bin"):
    """The whole sparse bootstrap of a scene with known poses.

    Args:
      grays: list of [H, W] float grayscale images.
      Ks/Rs/ts: [V, 3, 3] / [V, 3, 3] / [V, 3, 1] known calibration/poses.
      out_dir: when set, writes a standard COLMAP model there.
    Returns:
      (cameras, images, points3D) dicts — `read_model`-compatible, feeding
      compute_src_images / compute_min_max_depth (data/colmap_utils.py).
    """
    v = len(grays)
    Ks = np.asarray(Ks)
    Rs = np.asarray(Rs)
    ts = np.asarray(ts).reshape(v, 3, 1)
    kps, descs = [], []
    for g in grays:
        kp = harris_keypoints(np.asarray(g, np.float32), max_kp=max_kp)
        kps.append(kp)
        descs.append(patch_descriptors(np.asarray(g, np.float32), kp))

    matches = {}
    for i in range(v):
        for j in range(i + 1, v):
            F = fundamental_from_poses(Ks[i], Rs[i], ts[i], Ks[j], Rs[j],
                                       ts[j])
            m = match_pair(kps[i], descs[i], kps[j], descs[j], F=F,
                           epi_thresh=epi_thresh, min_score=min_score)
            if len(m):
                matches[(i, j)] = m

    track_ids = build_tracks([len(k) for k in kps], matches)

    cameras, images = {}, {}
    for i in range(v):
        h, w = grays[i].shape[:2]
        K = Ks[i]
        cameras[i + 1] = Camera(i + 1, "PINHOLE", w, h,
                                np.array([K[0, 0], K[1, 1], K[0, 2],
                                          K[1, 2]]))
        images[i + 1] = Image(
            i + 1, rotmat2qvec(Rs[i]), ts[i].reshape(3), i + 1,
            names[i] if names else f"{i:08d}.jpg", kps[i],
            track_ids[i])

    points3D = triangulate_tracks(images, Ks, Rs, ts, min_views=min_views,
                                  max_reproj_error=max_reproj_error)
    # drop references to tracks the triangulation rejected
    kept = set(points3D.keys())
    for im in images.values():
        ids = im.point3D_ids
        ids[~np.isin(ids, list(kept))] = -1

    if out_dir is not None:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        write_model(cameras, images, points3D, out_dir, ext=ext)
    return cameras, images, points3D
