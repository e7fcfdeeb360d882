"""MegaDepth n-uplet preprocessor, the offline dataset generator.

Counterpart of wildmvs/data/preprocess_megadepth.py (reference
preprocess.py): walks MegaDepth's COLMAP models, picks n-uplets (a
reference and 4 sources for training, 9 for testing) sharing > 100
points with the reference, of which > 100 have a triangulation angle
> 5 deg, resizes the images to a min side of 512 px on /32 multiples,
computes the visible min/max depth, and writes im_{i}_{v}.jpg,
infos_{i}.npz {K, R, t, min_d, max_d} and the copied depth_{i}.h5: the
layout `data/loaders.MegaDepthDataset` reads. Host code; PIL is imported
where an image is resized.

Usage:
  python -m wildmvs_torch.data.preprocess_megadepth --mode train \
      --md_folder datasets/MegaDepth_v1 --md_sfm_folder <sparse models>
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import numpy as np

from .colmap_model import qvec2rotmat, read_model
from .colmap_utils import get_calib_from_sparse
from .loaders import _require, scene_list


def resized_size(size, min_size: int = 512):
    """Min-side resize to /32-aligned dims. Parity: preprocess.py:30-37."""
    w, h = size
    r = min(w / min_size, h / min_size)
    return int(w / r / 32) * 32, int(h / r / 32) * 32


def visible_depth_range(points3d, im_ids, K, R, t, sizes, min_obs: int = 3):
    """Min/max depth of points observed by >= min_obs of the n-uplet's views,
    restricted to in-frame projections.
    Parity: utils/colmap_utils.py:76-99 (compute_min_max_depth_visible)."""
    pts = []
    ids = set(int(i) for i in im_ids)
    for p in points3d:
        n_obs = sum(1 for im in points3d[p].image_ids if int(im) in ids)
        if n_obs >= min_obs:
            pts.append(points3d[p].xyz)
    if not pts:
        return None, None
    pts = np.array(pts)
    cam = np.einsum("nij,pj->npi", R, pts) + t[:, None, :, 0]
    proj = np.einsum("nij,npj->npi", K, cam)
    depth = cam[..., 2]
    xy = proj[..., :2] / np.maximum(proj[..., 2:], 1e-9)
    valid = ((xy >= 0).all(-1) & (xy[..., 0] < sizes[:, None, 0])
             & (xy[..., 1] < sizes[:, None, 1]) & (depth > 0))
    depth = np.where(valid, depth, np.nan)
    if np.isnan(depth).all(axis=1).any():
        return None, None
    return np.nanmin(depth, axis=1), np.nanmax(depth, axis=1)


def triangulation_angles(point_cloud, R_rel, t_rel):
    ray1 = point_cloud
    ray2 = point_cloud + (R_rel.T @ t_rel.reshape(3, 1)).T
    cos = np.clip(np.sum(ray1 * ray2, axis=1)
                  / np.linalg.norm(ray1, axis=1)
                  / np.linalg.norm(ray2, axis=1), -1, 1)
    return np.degrees(np.arccos(cos))


def process_scene(scene_id: str, img_root: Path, sfm_root: Path,
                  out_root: Path, nb_src: int, nb_per_scene: int,
                  nb_points_thresh: int = 100, tri_angle_thresh: float = 5.0,
                  seed: int = 0) -> int:
    """Generate n-uplets for one scene; returns the number written."""
    Image = _require("PIL.Image", "pillow", "MegaDepth preprocessing")
    try:
        cameras, images, points3d = read_model(sfm_root / scene_id)
    except (FileNotFoundError, TypeError, ValueError):
        print(f"scene {scene_id} not found")
        return 0
    full_imgs = img_root / scene_id / "dense0" / "imgs"
    out_path = out_root / scene_id
    out_path.mkdir(parents=True, exist_ok=True)

    K, R, t, _ = get_calib_from_sparse(cameras, images)
    im_keys = list(images.keys())
    rng = np.random.default_rng(seed)
    count = 0
    for idx in rng.permutation(len(images)):
        im_ref = im_keys[idx]
        if not (full_imgs / images[im_ref].name).exists():
            continue
        # co-visibility counts from the ref's observed points
        shared: dict[int, int] = {}
        ref_pts = set(int(p) for p in images[im_ref].point3D_ids if p != -1)
        for p in ref_pts:
            if p not in points3d:
                continue
            for neigh in points3d[p].image_ids:
                if int(neigh) != im_ref:
                    shared[int(neigh)] = shared.get(int(neigh), 0) + 1

        R1 = qvec2rotmat(images[im_ref].qvec)
        t1 = images[im_ref].tvec
        nuplet, nuplet_idx = [], []
        for j in rng.permutation(len(images)):
            im_c = im_keys[j]
            if im_c == im_ref or shared.get(im_c, 0) <= nb_points_thresh:
                continue
            if not (full_imgs / images[im_c].name).exists():
                continue
            common = ref_pts & set(int(p) for p in images[im_c].point3D_ids
                                   if p != -1)
            pc = np.array([points3d[p].xyz for p in common if p in points3d])
            if len(pc) == 0:
                continue
            R2 = qvec2rotmat(images[im_c].qvec)
            t2 = images[im_c].tvec
            R_rel = R2 @ R1.T
            t_rel = t2 - R_rel @ t1
            # angles computed on ref-frame points
            pc_ref = pc @ R1.T + t1
            tri = triangulation_angles(pc_ref, R_rel, t_rel)
            if (tri > tri_angle_thresh).sum() <= nb_points_thresh:
                continue
            nuplet.append(im_c)
            nuplet_idx.append(j)
            if len(nuplet) >= nb_src:
                break
        if len(nuplet) < nb_src:
            continue
        depth_path = (full_imgs.parent / "depths"
                      / images[im_ref].name).with_suffix(".h5")
        if not depth_path.exists() or depth_path.stat().st_size < 100 * 1024:
            continue
        shutil.copy(depth_path, out_path / f"depth_{count}.h5")
        all_ids = [im_ref] + nuplet
        idx_list = [int(idx)] + [int(j) for j in nuplet_idx]
        new_K = K[idx_list].copy()
        new_sizes = []
        for v, im_id in enumerate(all_ids):
            pil = Image.open(full_imgs / images[im_id].name)
            rs = resized_size(pil.size)
            new_sizes.append(rs)
            new_K[v][0:1] *= rs[0] / pil.size[0]
            new_K[v][1:2] *= rs[1] / pil.size[1]
            pil.resize(rs, resample=Image.LANCZOS).save(
                out_path / f"im_{count}_{v}.jpg")
        min_d, max_d = visible_depth_range(
            points3d, all_ids, new_K, R[idx_list], t[idx_list],
            np.array(new_sizes, np.float64))
        if min_d is None or np.isnan(min_d).any() or np.isnan(max_d).any():
            continue
        np.savez(out_path / f"infos_{count}.npz", min_d=min_d, max_d=max_d,
                 K=new_K, R=R[idx_list], t=t[idx_list])
        count += 1
        if count >= nb_per_scene:
            break
    return count


def main(argv=None):
    p = argparse.ArgumentParser(description="MegaDepth n-uplet generator")
    p.add_argument("--mode", choices=["train", "test"], required=True)
    p.add_argument("--out_name", default="md")
    p.add_argument("--md_folder", default="datasets/MegaDepth_v1/")
    p.add_argument("--md_sfm_folder", required=True)
    p.add_argument("--scenes", default=None,
                   help="scene list file; defaults to the packaged md_train")
    a = p.parse_args(argv)
    nb_src, nb_per_scene = (4, 150) if a.mode == "train" else (9, 100)
    if a.scenes:
        scenes = [s.strip() for s in Path(a.scenes).read_text().splitlines()
                  if s.strip()]
    else:
        scenes = scene_list("md_train" if a.mode == "train" else "md_test")
    out_root = Path("datasets") / a.out_name / a.mode
    total = 0
    for s in scenes:
        total += process_scene(s, Path(a.md_folder), Path(a.md_sfm_folder),
                               out_root, nb_src, nb_per_scene)
    print(f"wrote {total} n-uplets")


if __name__ == "__main__":
    main()
