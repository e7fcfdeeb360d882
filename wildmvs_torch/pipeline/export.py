"""External-fuser workspace exporters: the Gipuma/fusibile and COLMAP
dense layouts.

Counterpart of wildmvs/pipeline/export.py, on host numpy. The reference
can hand its stage-1 depthmaps to two external fusers: the fusibile
binary through a Gipuma workspace (evaluation/fusibile.py:95-160
`mvsnet_to_gipuma`) and COLMAP `stereo_fusion` through a dense workspace
(utils/colmap_utils.py:324-400 `colmap_fusion`). The port fuses on the
card (pipeline/fusion.py); these exporters write the same on-disk layouts
from the port's npz caches and codecs, so that the port's fusion can be
compared with those binaries, and users can keep their external tools.

Both read the stage-1 cache (`<name>_out.npz` with {depthmap,
probability}) and, if given, the stage-2 geometric masks, and zero the
depth where `get_mask_invalid` says so (the reference's get_mask,
pipeline_utils.py:88-111; fusibile.py:152-159, colmap_utils.py:373-374).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..data.codecs import write_colmap_array, write_dmb
from ..data.colmap_model import Camera, Image, rotmat2qvec, write_model
from .depthmaps import get_mask_invalid


def _proj_matrix(K, R, t) -> np.ndarray:
    """4x4 P = [KR | Kt] (reference utils/utils_3D.py:50)."""
    P = np.eye(4)
    P[:3, :3] = np.asarray(K) @ np.asarray(R)
    P[:3, 3:] = np.asarray(K) @ np.asarray(t).reshape(3, 1)
    return P


GIPUMA_PREFIX = "2333__"  # fusibile's expected folder prefix (fusibile.py:127)


def _load_masked_depth(depth_dir: Path, filter_dir: Path | None, name: str,
                       prob_threshold: float):
    """Stage-1 depth with invalid pixels zeroed (fusibile.py:137-158)."""
    npz = np.load(Path(depth_dir) / f"{name}_out.npz")
    depth = npz["depthmap"].astype(np.float32).copy()
    prob = npz["probability"]
    geo_mask = None
    if filter_dir is not None:
        f = Path(filter_dir) / f"{name}_out.npz"
        if f.exists():
            geo_mask = np.load(f)["geo_mask"]
    mask_invalid = get_mask_invalid(prob, prob_threshold, geo_mask)
    depth[mask_invalid] = 0.0
    return depth, mask_invalid


def _save_image_jpg(img: np.ndarray, path: Path, size_wh=None):
    """Write a [H, W, 3] float image in [0,1] as jpg (optionally resized,
    LANCZOS like the reference's PIL resize, fusibile.py:125)."""
    from PIL import Image as PILImage
    arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    im = PILImage.fromarray(arr)
    if size_wh is not None and size_wh != im.size:
        im = im.resize(size_wh, resample=PILImage.LANCZOS)
    im.save(path)


def _iter_views(dataset):
    for i in range(len(dataset)):
        s = dataset[i]
        name = s["filename"].replace("/", "_")
        # s["imgs"][0] is the reference view for both stacked arrays and
        # ragged per-view lists
        yield name, s["imgs"][0], s["K"][0], s["R"][0], s["t"][0]


def export_gipuma_workspace(dataset, depth_dir, out_dir,
                            filter_dir: Path | None = None,
                            downscale: int = 1,
                            prob_threshold: float = 0.8) -> Path:
    """Emit the fusibile input layout (mvsnet_to_gipuma, fusibile.py:95-160):

      out_dir/cams/<name>.jpg.P        3x4 P = [KR | Kt], rows space-ended
      out_dir/images/<name>.jpg        reference image at depthmap resolution
      out_dir/2333__<name>/disp.dmb    depth, invalid pixels = 0
      out_dir/2333__<name>/normals.dmb fake unit normals 1/sqrt(3), masked

    `downscale` divides the intrinsic rows like fusibile.py:122 (the network
    ran at image_size/downscale; cams must match the depthmap grid).
    """
    out_dir = Path(out_dir)
    cam_dir = out_dir / "cams"
    img_dir = out_dir / "images"
    cam_dir.mkdir(parents=True, exist_ok=True)
    img_dir.mkdir(parents=True, exist_ok=True)

    for name, img, K, R, t in _iter_views(dataset):
        P = _proj_matrix(K, R, t)
        P[:2] /= downscale
        lines = [" ".join(str(v) for v in row) + " " for row in P[:3]]
        (cam_dir / f"{name}.jpg.P").write_text("\n".join(lines) + "\n\n")

        depth, mask_invalid = _load_masked_depth(depth_dir, filter_dir, name,
                                                 prob_threshold)
        h, w = depth.shape
        _save_image_jpg(img, img_dir / f"{name}.jpg", size_wh=(w, h))

        sub = out_dir / f"{GIPUMA_PREFIX}{name}"
        sub.mkdir(exist_ok=True)
        write_dmb(sub / "disp.dmb", depth)
        # fake unit normals (1,1,1)/sqrt(3), zeroed where depth == 0
        # (fake_gipuma_normal, fusibile.py:75-92 — mask from the WRITTEN
        # depth, i.e. depth > 0)
        normals = np.full((h, w, 3), 1.0 / np.sqrt(3.0), np.float32)
        normals *= (depth > 0)[..., None]
        write_dmb(sub / "normals.dmb", normals)
    return out_dir


def fusibile_command(out_dir, fusibile_exe: str = "./fusibile",
                     disp_thresh: float = 0.25, num_consistent: int = 3
                     ) -> list[str]:
    """The exact fusibile invocation (depth_map_fusion, fusibile.py:162-179)
    for a workspace written by export_gipuma_workspace."""
    out_dir = Path(out_dir)
    return [fusibile_exe,
            "-input_folder", f"{out_dir}/",
            "-p_folder", f"{out_dir / 'cams'}/",
            "-images_folder", f"{out_dir / 'images'}/",
            "--depth_min=0.001", "--depth_max=100000",
            "--normal_thresh=360", f"--disp_thresh={disp_thresh}",
            f"--num_consistent={num_consistent}"]


def export_colmap_workspace(dataset, depth_dir, out_dir,
                            filter_dir: Path | None = None,
                            prob_threshold: float = 0.8) -> Path:
    """Emit a COLMAP dense workspace ready for `colmap stereo_fusion`
    (colmap_fusion, colmap_utils.py:324-400 — there built by
    `image_undistorter` + overwritten depth/normal maps; here written
    directly, the cameras being pinhole already):

      out_dir/images/<name>.jpg
      out_dir/sparse/{cameras,images,points3D}.bin
      out_dir/stereo/depth_maps/<name>.jpg.geometric.bin
      out_dir/stereo/normal_maps/<name>.jpg.geometric.bin
      out_dir/stereo/fusion.cfg            (image list for stereo_fusion)
      out_dir/stereo/patch-match.cfg

    Depths are masked like colmap_utils.py:373-374; normals are the fake
    1/sqrt(3) constant (max_normal_error 180 makes them inert,
    colmap_utils.py:396).
    """
    out_dir = Path(out_dir)
    img_dir = out_dir / "images"
    sparse_dir = out_dir / "sparse"
    stereo = out_dir / "stereo"
    for d in (img_dir, sparse_dir, stereo / "depth_maps",
              stereo / "normal_maps"):
        d.mkdir(parents=True, exist_ok=True)

    cameras, images, names = {}, {}, []
    for idx, (name, img, K, R, t) in enumerate(_iter_views(dataset)):
        depth, _ = _load_masked_depth(depth_dir, filter_dir, name,
                                      prob_threshold)
        h, w = depth.shape
        _save_image_jpg(img, img_dir / f"{name}.jpg", size_wh=(w, h))

        cam_id = idx + 1
        K = np.asarray(K, np.float64)
        cameras[cam_id] = Camera(
            id=cam_id, model="PINHOLE", width=w, height=h,
            params=np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))
        images[cam_id] = Image(
            id=cam_id, qvec=rotmat2qvec(np.asarray(R, np.float64)),
            tvec=np.asarray(t, np.float64).reshape(3),
            camera_id=cam_id, name=f"{name}.jpg",
            xys=np.zeros((0, 2)), point3D_ids=np.zeros((0,), np.int64))
        names.append(f"{name}.jpg")

        write_colmap_array(stereo / "depth_maps" / f"{name}.jpg.geometric.bin",
                           depth)
        normals = np.full((h, w, 3), 1.0 / np.sqrt(3.0), np.float32)
        normals *= (depth > 0)[..., None]
        write_colmap_array(
            stereo / "normal_maps" / f"{name}.jpg.geometric.bin", normals)

    write_model(cameras, images, {}, sparse_dir, ext=".bin")
    (stereo / "fusion.cfg").write_text("\n".join(names) + "\n")
    (stereo / "patch-match.cfg").write_text(
        "\n".join(f"{n}\n__auto__, 20" for n in names) + "\n")
    return out_dir


def colmap_fusion_command(out_dir, ply_out, colmap_exe: str = "colmap",
                          num_consistent: int = 3,
                          depth_threshold: float = 0.01,
                          max_reproj_error: float = 2.0) -> list[str]:
    """The exact stereo_fusion invocation (colmap_utils.py:391-400, network
    branch: max_normal_error 180)."""
    return [colmap_exe, "stereo_fusion",
            "--workspace_path", str(out_dir),
            "--output_path", str(ply_out),
            "--StereoFusion.max_normal_error", "180",
            "--StereoFusion.min_num_pixels", str(num_consistent),
            "--StereoFusion.max_depth_error", str(depth_threshold),
            "--StereoFusion.max_reproj_error", str(max_reproj_error)]
