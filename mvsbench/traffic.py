"""The one traffic generator: a DTU-like rig of 49 cameras, seeded images,
the request order of a serving cell and the sample pool of a training
cell, all from a workload file's parameters and `--seed`.

The rig extends the port's `bench.scene_dtu` (cameras on a sphere of
650 mm looking at its centre, 6 degree steps, up (0, -1, 0), K with the
principal point at the image centre) from a row of views to DTU's 49, a
7 x 7 grid of azimuth and elevation steps. A request takes one reference
camera and its N - 1 nearest cameras (by centre distance, ties by index).
Every seed serves the same 49 requests, each permutation in another
order, so seeds change the images and the order, never the work.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Rig:
    K: np.ndarray          # [C, 3, 3]
    R: np.ndarray          # [C, 3, 3]
    t: np.ndarray          # [C, 3, 1]
    centres: np.ndarray    # [C, 3]
    depth_range: tuple

    @property
    def cameras(self) -> int:
        return len(self.K)

    def views(self, ref: int, n: int) -> list[int]:
        """The reference camera, then its n - 1 nearest."""
        d = np.linalg.norm(self.centres - self.centres[ref], axis=1)
        order = sorted((float(d[i]), i) for i in range(self.cameras)
                       if i != ref)
        return [ref] + [i for _, i in order[:n - 1]]


def dtu_rig(spec: dict, h: int, w: int) -> Rig:
    """The rig of a workload's "rig" entry at an image size: focal
    `focal[f"{h}x{w}"]`, `grid` x `grid` cameras `step_deg` apart in
    azimuth and elevation on a sphere of `radius_mm`."""
    f = spec["focal"][f"{h}x{w}"]
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float64)
    g, step = spec["grid"], np.deg2rad(spec["step_deg"])
    up = np.array([0.0, -1.0, 0.0])
    Ks, Rs, ts, cs = [], [], [], []
    for k in range(g * g):
        row, col = divmod(k, g)
        az, el = step * (col - g // 2), step * (row - g // 2)
        d = np.array([np.sin(az) * np.cos(el), np.sin(el),
                      -np.cos(az) * np.cos(el)])
        eye = -spec["radius_mm"] * d
        z = -eye / np.linalg.norm(eye)
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z], 0)
        Ks.append(K)
        Rs.append(R)
        ts.append((-R @ eye).reshape(3, 1))
        cs.append(eye)
    f32 = np.float32
    return Rig(np.stack(Ks).astype(f32), np.stack(Rs).astype(f32),
               np.stack(ts).astype(f32), np.stack(cs),
               tuple(spec["depth_range_mm"]))


def images(seed: int, cameras: int, h: int, w: int,
           device: torch.device) -> list[np.ndarray]:
    """One image [h, w, 3] f32 in [0, 1] a camera, drawn on `device` from
    `seed` in one call, held as host numpy (what a client hands over)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((cameras, h, w, 3), generator=g, device=device)
    host = x.cpu().numpy()
    return [host[i] for i in range(cameras)]


def request_order(seed: int, cameras: int):
    """Reference cameras in serving order: successive permutations of all
    cameras, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    while True:
        yield from (int(i) for i in rng.permutation(cameras))


def request(rig: Rig, imgs: list, ref: int, n: int) -> dict:
    """The arguments of one `Predictor` call (host numpy, view 0 the
    reference): a list of N images, K, R, t [N, ...], depth_min/max [N]."""
    v = rig.views(ref, n)
    lo, hi = rig.depth_range
    return {"imgs": [imgs[i] for i in v], "K": rig.K[v], "R": rig.R[v],
            "t": rig.t[v], "depth_min": np.full(n, lo, np.float32),
            "depth_max": np.full(n, hi, np.float32), "views": v}


def plane_depth(rig: Rig, ref: int, hw: tuple, scale: float,
                normal: list) -> np.ndarray:
    """Depth [h, w] in camera `ref` of the plane through the rig's centre
    with `normal` (world), on the integer grid of K scaled by `scale`,
    clipped to the depth range."""
    h, w = hw
    K = rig.K[ref].astype(np.float64).copy()
    K[:2] *= scale
    R = rig.R[ref].astype(np.float64)
    n = np.asarray(normal, np.float64)
    n /= np.linalg.norm(n)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
    rays = pix @ np.linalg.inv(K).T @ R            # R^T d, cam z = 1
    centre = rig.centres[ref]
    z = -(n @ centre) / (rays @ n)
    return np.clip(z, *rig.depth_range).astype(np.float32)


def training_pool(seed: int, rig: Rig, imgs: list, spec: dict) -> list:
    """The training cell's samples, batch 1, in the order the loop takes
    them: `spec["pool"]` reference cameras (every `spec["ref_stride"]`-th,
    in an order drawn from `seed`), each with its N - 1 nearest views, the
    analytic plane as ground truth at the depth map's resolution and a
    full mask. Host numpy, as a loader collates it."""
    refs = list(range(0, rig.cameras, spec["ref_stride"]))[:spec["pool"]]
    rng = np.random.default_rng(seed)
    refs = [refs[i] for i in rng.permutation(len(refs))]
    n, down = spec["views"], spec["depth_down"]
    hw = (spec["height"] // down, spec["width"] // down)
    pool = []
    for ref in refs:
        r = request(rig, imgs, ref, n)
        pool.append({
            "imgs": np.stack(r["imgs"])[None],
            "K": r["K"][None], "R": r["R"][None], "t": r["t"][None],
            "depth_min": r["depth_min"][None],
            "depth_max": r["depth_max"][None],
            "depth": plane_depth(rig, ref, hw, 1.0 / down,
                                 spec["gt_plane_normal"])[None],
            "mask": np.ones((1,) + hw, np.float32)})
    return pool
