"""Fusion parameter sensitivity on rendered scenes with controlled depth
error.

Counterpart of tools/fusion_sensitivity.py: oracle depths plus Gaussian
noise (in units of the scene's (max - min) / 128 interval) plus a share of
gross outliers, fused by the port's fusion (pipeline/fusion.py) over the
grid of disparity thresholds and consistent-view counts, and scored by
chamfer accuracy (pred -> GT) and completeness (GT -> pred) against the
GT surface points (pipeline/metrics3d.chamfer_nn). The noise ladder is
the yardstick the end-to-end quality drive (e2e_quality.py) scales a
network's chamfer against.

  python -m wildmvs_torch.tools.fusion_sensitivity            # the card
  python -m wildmvs_torch.tools.fusion_sensitivity --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from ..data.synthetic import SyntheticSceneDataset
from ..device import resolve_device
from ..pipeline.fusion import fuse_depthmaps
from ..pipeline.metrics3d import chamfer_nn

#: the study's grid: disparity thresholds (px) and consistent-view counts
DISP_THRESHOLDS = (0.0025, 0.005, 0.01, 0.02, 0.04)
NUM_CONSISTENT = (2, 3, 4)
#: the noise ladder (sigma in intervals, outlier share)
NOISE_LEVELS = ((0.5, 0.0), (1.0, 0.05), (2.0, 0.1))


def noisy_scene_depths(scene, sigma_intervals: float, outlier_frac: float,
                       seed: int = 0):
    """Oracle depths + N(0, sigma * interval) + uniform-range outliers."""
    rng = np.random.default_rng(seed)
    zmin, zmax = scene.z_range
    interval = (zmax - zmin) / 128.0
    out = []
    for i in range(scene.num_views):
        d = scene.depths[i].copy()
        d += rng.normal(0.0, sigma_intervals * interval, d.shape)
        bad = rng.random(d.shape) < outlier_frac
        d[bad] = rng.uniform(zmin, zmax, bad.sum())
        out.append(d.astype(np.float32))
    return out


def gt_points(scene, stride: int = 1) -> np.ndarray:
    """Dense GT surface points (world) from every view's exact depth."""
    pts = []
    h, w = scene.depths[0].shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
    for i in range(scene.num_views):
        rays = pix[::stride, ::stride] @ np.linalg.inv(scene.K[i]).T
        cam = rays * scene.depths[i][::stride, ::stride][..., None]
        world = (cam - scene.t[i][:, 0]) @ scene.R[i]
        pts.append(world.reshape(-1, 3))
    return np.concatenate(pts)


def run_grid(sigma: float = 1.0, outlier_frac: float = 0.05,
             views: int = 5, hw=(64, 96), seed: int = 0, device=None):
    """Fuse one noise level's depths at every grid point. Returns
    ([(disp, ncons, points, acc, comp)], source pixels); acc and comp are
    inf where fewer than 10 points fused. `device`: "cuda" (default) or
    "cpu"."""
    dev = resolve_device(device)
    scene = SyntheticSceneDataset(num_views=views, height=hw[0], width=hw[1],
                                  seed=seed)
    depths = noisy_scene_depths(scene, sigma, outlier_frac, seed=seed + 1)
    gt = gt_points(scene)
    n_px = views * hw[0] * hw[1]

    rows = []
    for disp in DISP_THRESHOLDS:
        for ncons in NUM_CONSISTENT:
            pts, _ = fuse_depthmaps(depths, scene.K, scene.R, scene.t,
                                    disp_threshold=disp,
                                    num_consistent=ncons, device=dev)
            if len(pts) < 10:
                rows.append((disp, ncons, len(pts), np.inf, np.inf))
                continue
            acc = float(np.mean(chamfer_nn(pts, gt)))
            comp = float(np.mean(chamfer_nn(gt, pts)))
            rows.append((disp, ncons, len(pts), acc, comp))
    return rows, n_px


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    print(f"{'disp':>8} {'ncons':>5} {'points':>8} {'acc':>10} {'comp':>10}"
          f"  (acc/comp in scene units; interval = {4.0 / 128:.4f})")
    for sigma, outf in NOISE_LEVELS:
        rows, n_px = run_grid(sigma=sigma, outlier_frac=outf, device=dev)
        print(f"-- noise sigma={sigma} intervals, outliers={outf:.0%} "
              f"({n_px} source px)")
        for disp, ncons, n, acc, comp in rows:
            print(f"{disp:>8} {ncons:>5} {n:>8} {acc:>10.5f} {comp:>10.5f}")


if __name__ == "__main__":
    main()
