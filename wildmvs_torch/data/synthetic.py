"""Synthetic multi-view dataset: coherent renders with exact GT depth.

The port's own numpy copy of wildmvs/data/synthetic.py:14-222 (the same
seeds give the same arrays). Each sample is a tilted textured plane
rendered into N pinhole views, so the plane sweep and the supervised loss
behave as on real data, with no files. `SyntheticSceneDataset` is one such
scene under the eval-dataset contract (every view a reference in turn),
for the reconstruction pipeline. `render_rig_plane` renders such a plane
into any world-frame rig (the DTU-like eval rig of chip_smoke.py).
"""
from __future__ import annotations

import numpy as np


def _sample_texture(tex: np.ndarray, u: np.ndarray,
                    v: np.ndarray) -> np.ndarray:
    """Bilinear sample of a [Ht, Wt, C] texture at continuous (u, v)."""
    ht, wt, _ = tex.shape
    u = np.clip(u, 0.0, wt - 1.001)
    v = np.clip(v, 0.0, ht - 1.001)
    u0, v0 = u.astype(np.int32), v.astype(np.int32)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    return (tex[v0, u0] * (1 - fu) * (1 - fv)
            + tex[v0, u0 + 1] * fu * (1 - fv)
            + tex[v0 + 1, u0] * (1 - fu) * fv
            + tex[v0 + 1, u0 + 1] * fu * fv)


class SyntheticMVSDataset:
    """N-view renders of tilted textured planes.

    A sample follows the reference loader contract: imgs [N, H, W, 3]
    float32 in [0, 1], K/R [N, 3, 3], t [N, 3, 1], depth_min/max [N],
    depth [H, W] (reference-view GT), mask [H, W], filename.
    """

    def __init__(self, num_samples: int = 16, num_views: int = 3,
                 height: int = 64, width: int = 96, seed: int = 0,
                 z_range: tuple = (2.0, 6.0)):
        self.num_samples = num_samples
        self.num_views = num_views
        self.h, self.w = height, width
        self.seed = seed
        self.z_min, self.z_max = z_range

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        h, w, n = self.h, self.w, self.num_views
        f = 1.2 * w
        K = np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]],
                     np.float32)

        # plane: z = z0 + a*x + b*y in the reference camera frame
        z0 = rng.uniform(self.z_min + 1.0, self.z_max - 1.0)
        a, b = rng.uniform(-0.15, 0.15, 2)

        # smooth random texture (low frequency, so bilinear rendering is
        # clean)
        tex_res = 256
        tex = rng.random((tex_res // 8, tex_res // 8, 3)).astype(np.float32)
        tex = np.kron(tex, np.ones((8, 8, 1), np.float32))
        for _ in range(2):  # cheap blur
            tex = 0.25 * (np.roll(tex, 1, 0) + np.roll(tex, -1, 0)
                          + np.roll(tex, 1, 1) + np.roll(tex, -1, 1))

        Ks = np.tile(K, (n, 1, 1))
        Rs = [np.eye(3, dtype=np.float32)]
        ts = [np.zeros((3, 1), np.float32)]
        for _ in range(n - 1):
            ang = rng.uniform(-0.03, 0.03, 3)
            cx, sx = np.cos(ang[0]), np.sin(ang[0])
            cy, sy = np.cos(ang[1]), np.sin(ang[1])
            Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
            Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
            Rs.append((Rx @ Ry).astype(np.float32))
            ts.append(rng.uniform(-0.25, 0.25, (3, 1)).astype(np.float32)
                      * [[1], [1], [0.3]])
        Rs, ts = np.stack(Rs), np.stack(ts).astype(np.float32)

        ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        pix = np.stack([xs, ys, np.ones_like(xs)], -1)  # [H, W, 3]

        imgs = np.zeros((n, h, w, 3), np.float32)
        ref_depth = None
        for i in range(n):
            rays_cam = pix @ np.linalg.inv(K).T            # [H, W, 3]
            rays_world = rays_cam @ Rs[i]                  # R^T applied
            center = (-Rs[i].T @ ts[i])[:, 0]              # camera center
            # the ray parameter at the plane z = z0 + a x + b y (the world
            # frame is the reference camera's)
            denom = (rays_world[..., 2] - a * rays_world[..., 0]
                     - b * rays_world[..., 1])
            num = z0 + a * center[0] + b * center[1] - center[2]
            lam = num / np.where(np.abs(denom) < 1e-6, 1e-6, denom)
            pts = center + rays_world * lam[..., None]     # world points
            u = (pts[..., 0] + 4.0) * (tex_res / 8.0)
            v = (pts[..., 1] + 4.0) * (tex_res / 8.0)
            imgs[i] = _sample_texture(tex, u, v)
            if i == 0:
                # camera 0 at the origin with R = I: depth = z = lam
                ref_depth = lam.astype(np.float32)

        depth_min = np.full((n,), self.z_min, np.float32)
        depth_max = np.full((n,), self.z_max, np.float32)
        mask = ((ref_depth >= self.z_min)
                & (ref_depth <= self.z_max)).astype(np.float32)
        return {
            "imgs": imgs, "K": Ks, "R": Rs, "t": ts,
            "depth_min": depth_min, "depth_max": depth_max,
            "depth": ref_depth, "mask": mask,
            "filename": f"synthetic/{idx:08d}",
        }


class SyntheticSceneDataset:
    """One coherent scene rendered from V views; sample i is reference view
    i with the other views as sources, under the eval-dataset contract
    (imgs, K, R, t, depth_min/max, depth, mask, filename, src_filenames)."""

    def __init__(self, num_views: int = 5, height: int = 64, width: int = 96,
                 seed: int = 0, z_range: tuple = (2.0, 6.0)):
        base = SyntheticMVSDataset(num_samples=1, num_views=num_views,
                                   height=height, width=width, seed=seed,
                                   z_range=z_range)
        self.num_views = num_views
        sample0 = base[0]
        self.imgs = sample0["imgs"]
        self.K, self.R, self.t = sample0["K"], sample0["R"], sample0["t"]
        self.z_range = z_range
        # per-view GT depth: each view's rays against the same plane
        rng = np.random.default_rng(seed * 100003)
        z0 = rng.uniform(z_range[0] + 1.0, z_range[1] - 1.0)
        a, b = rng.uniform(-0.15, 0.15, 2)
        h, w = self.imgs.shape[1:3]
        ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        pix = np.stack([xs, ys, np.ones_like(xs)], -1)
        self.depths = []
        for i in range(num_views):
            rays_world = (pix @ np.linalg.inv(self.K[i]).T) @ self.R[i]
            center = (-self.R[i].T @ self.t[i])[:, 0]
            denom = (rays_world[..., 2] - a * rays_world[..., 0]
                     - b * rays_world[..., 1])
            num = z0 + a * center[0] + b * center[1] - center[2]
            lam = num / np.where(np.abs(denom) < 1e-6, 1e-6, denom)
            pts = center + rays_world * lam[..., None]
            cam_pts = pts @ self.R[i].T + self.t[i][:, 0]
            self.depths.append(cam_pts[..., 2].astype(np.float32))

    def __len__(self):
        return self.num_views

    def __getitem__(self, idx: int) -> dict:
        order = [idx] + [i for i in range(self.num_views) if i != idx]
        depth = self.depths[idx]
        mask = (depth >= self.z_range[0]) & (depth <= self.z_range[1])
        n = self.num_views
        return {
            "imgs": self.imgs[order],
            "K": self.K[order], "R": self.R[order], "t": self.t[order],
            "depth_min": np.full((n,), self.z_range[0], np.float32),
            "depth_max": np.full((n,), self.z_range[1], np.float32),
            "depth": depth, "mask": mask.astype(np.float32),
            "filename": f"view_{idx:04d}",
            "src_filenames": [f"view_{i:04d}" for i in order[1:]],
        }


def render_rig_plane(Ks: np.ndarray, Rs: np.ndarray, ts: np.ndarray,
                     h: int, w: int, plane: tuple, extent: float,
                     seed: int = 0, tex_res: int = 1024):
    """Render a tilted textured plane into an arbitrary world-frame rig.

    Args:
      Ks/Rs/ts: [N, 3, 3] / [N, 3, 3] / [N, 3, 1] cameras
        (x_cam = R x_w + t).
      plane: (z0, a, b), the surface z_w = z0 + a x_w + b y_w.
      extent: half-width (world units) of the textured region.
    Returns:
      imgs [N, H, W, 3] float32, depths [N, H, W] float32 (per-view GT).
    """
    n = Ks.shape[0]
    z0, a, b = plane
    rng = np.random.default_rng(seed)
    tex = rng.random((tex_res // 8, tex_res // 8, 3)).astype(np.float32)
    tex = np.kron(tex, np.ones((8, 8, 1), np.float32))
    for _ in range(2):
        tex = 0.25 * (np.roll(tex, 1, 0) + np.roll(tex, -1, 0)
                      + np.roll(tex, 1, 1) + np.roll(tex, -1, 1))
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1)
    imgs = np.zeros((n, h, w, 3), np.float32)
    depths = np.zeros((n, h, w), np.float32)
    for i in range(n):
        rays_world = (pix @ np.linalg.inv(Ks[i]).T) @ Rs[i]   # R^T applied
        center = (-Rs[i].T @ ts[i])[:, 0]
        denom = (rays_world[..., 2] - a * rays_world[..., 0]
                 - b * rays_world[..., 1])
        num = z0 + a * center[0] + b * center[1] - center[2]
        lam = num / np.where(np.abs(denom) < 1e-6, 1e-6, denom)
        pts = center + rays_world * lam[..., None]
        u = (pts[..., 0] + extent) * (tex_res / (2.0 * extent))
        v = (pts[..., 1] + extent) * (tex_res / (2.0 * extent))
        imgs[i] = _sample_texture(tex, u, v)
        cam_pts = pts @ Rs[i].T + ts[i][:, 0]
        depths[i] = cam_pts[..., 2].astype(np.float32)
    return imgs, depths


def collate(samples: list) -> dict:
    """Stack sample dicts into a batch (numpy); file names stay a list."""
    out = {}
    for key in samples[0]:
        if key == "filename":
            out[key] = [s[key] for s in samples]
        else:
            out[key] = np.stack([s[key] for s in samples])
    return out
