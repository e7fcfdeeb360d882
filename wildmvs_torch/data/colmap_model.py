"""COLMAP sparse-model reader/writer (text + binary), pure Python.

The port's own copy of wildmvs/data/colmap_model.py. Role of the
reference's utils/read_write_model_colmap.py — load/save cameras, images
(poses + 2D points) and 3D points from a COLMAP reconstruction. Implemented
from the public COLMAP file-format specification.
"""
from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

# model name -> (model_id, num_params)
CAMERA_MODELS = {
    "SIMPLE_PINHOLE": (0, 3), "PINHOLE": (1, 4), "SIMPLE_RADIAL": (2, 4),
    "RADIAL": (3, 5), "OPENCV": (4, 8), "OPENCV_FISHEYE": (5, 8),
    "FULL_OPENCV": (6, 12), "FOV": (7, 5), "SIMPLE_RADIAL_FISHEYE": (8, 4),
    "RADIAL_FISHEYE": (9, 5), "THIN_PRISM_FISHEYE": (10, 12),
}
MODEL_ID_TO_NAME = {v[0]: k for k, v in CAMERA_MODELS.items()}
MODEL_ID_TO_NPARAMS = {v[0]: v[1] for v in CAMERA_MODELS.values()}


@dataclasses.dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def K(self) -> np.ndarray:
        p = self.params
        if self.model == "SIMPLE_PINHOLE" or self.model == "SIMPLE_RADIAL":
            f, cx, cy = p[0], p[1], p[2]
            return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]])
        if self.model in ("PINHOLE", "OPENCV", "FULL_OPENCV", "OPENCV_FISHEYE"):
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
            return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        if self.model == "RADIAL":
            f, cx, cy = p[0], p[1], p[2]
            return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]])
        raise NotImplementedError(self.model)


@dataclasses.dataclass
class Image:
    id: int
    qvec: np.ndarray           # [4] (w, x, y, z)
    tvec: np.ndarray           # [3]
    camera_id: int
    name: str
    xys: np.ndarray            # [M, 2]
    point3D_ids: np.ndarray    # [M] int64, -1 = unmatched

    @property
    def R(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)

    @property
    def t(self) -> np.ndarray:
        return self.tvec.reshape(3, 1)


@dataclasses.dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y]])


def rotmat2qvec(R) -> np.ndarray:
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


# ------------------------------- binary IO ---------------------------------

def _read_cameras_bin(path):
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, mid, w, h = struct.unpack("<iiQQ", f.read(24))
            np_ = MODEL_ID_TO_NPARAMS[mid]
            params = np.array(struct.unpack(f"<{np_}d", f.read(8 * np_)))
            cams[cid] = Camera(cid, MODEL_ID_TO_NAME[mid], w, h, params)
    return cams


def _read_images_bin(path):
    images = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            q = np.array(struct.unpack("<4d", f.read(32)))
            t = np.array(struct.unpack("<3d", f.read(24)))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while (ch := f.read(1)) != b"\x00":
                name += ch
            (m,) = struct.unpack("<Q", f.read(8))
            blob = np.frombuffer(f.read(24 * m),
                                 dtype=[("x", "<f8"), ("y", "<f8"),
                                        ("id", "<i8")])
            images[iid] = Image(iid, q, t, cam_id, name.decode(),
                                np.stack([blob["x"], blob["y"]], 1),
                                blob["id"].copy())
    return images


def _read_points3d_bin(path):
    pts = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            pid = struct.unpack("<Q", f.read(8))[0]
            xyz = np.array(struct.unpack("<3d", f.read(24)))
            rgb = np.array(struct.unpack("<3B", f.read(3)))
            err = struct.unpack("<d", f.read(8))[0]
            (tl,) = struct.unpack("<Q", f.read(8))
            track = np.frombuffer(f.read(8 * tl),
                                  dtype=[("im", "<i4"), ("pt", "<i4")])
            pts[pid] = Point3D(pid, xyz, rgb, err, track["im"].copy(),
                               track["pt"].copy())
    return pts


def _write_cameras_bin(path, cameras):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for c in cameras.values():
            mid = CAMERA_MODELS[c.model][0]
            f.write(struct.pack("<iiQQ", c.id, mid, c.width, c.height))
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))


def _write_images_bin(path, images):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for xy, pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], int(pid)))


def _write_points3d_bin(path, points):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q", int(p.id)))
            f.write(struct.pack("<3d", *p.xyz))
            f.write(struct.pack("<3B", *np.asarray(p.rgb, np.uint8)))
            f.write(struct.pack("<d", float(p.error)))
            track = list(zip(p.image_ids, p.point2D_idxs))
            assert len(track) == len(p.image_ids), \
                "image_ids / point2D_idxs length mismatch"
            f.write(struct.pack("<Q", len(track)))
            for im, pt in track:
                f.write(struct.pack("<ii", int(im), int(pt)))


# -------------------------------- text IO ----------------------------------

def _read_cameras_txt(path):
    cams = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        cid = int(tok[0])
        cams[cid] = Camera(cid, tok[1], int(tok[2]), int(tok[3]),
                           np.array([float(x) for x in tok[4:]]))
    return cams


def _read_images_txt(path):
    """Blank/comment lines are skipped only BEFORE a header; the points
    line is read unconditionally right after it — an image with zero 2D
    points has an EMPTY points line (our own writer emits one), and the
    reference reads it the same way
    (read_write_model_colmap.py:205-226)."""
    images = {}
    raw = Path(path).read_text().splitlines()
    i = 0
    while i < len(raw):
        line = raw[i].strip()
        i += 1
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        iid = int(tok[0])
        q = np.array([float(x) for x in tok[1:5]])
        t = np.array([float(x) for x in tok[5:8]])
        cam_id = int(tok[8])
        name = tok[9]
        pts = raw[i].split() if i < len(raw) else []
        i += 1
        m = len(pts) // 3
        xys = np.array([[float(pts[3 * j]), float(pts[3 * j + 1])]
                        for j in range(m)]).reshape(m, 2)
        ids = np.array([int(pts[3 * j + 2]) for j in range(m)], np.int64)
        images[iid] = Image(iid, q, t, cam_id, name, xys, ids)
    return images


def _read_points3d_txt(path):
    pts = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        pid = int(tok[0])
        xyz = np.array([float(x) for x in tok[1:4]])
        rgb = np.array([int(x) for x in tok[4:7]])
        err = float(tok[7])
        track = [int(x) for x in tok[8:]]
        pts[pid] = Point3D(pid, xyz, rgb, err,
                           np.array(track[0::2], np.int32),
                           np.array(track[1::2], np.int32))
    return pts


def _write_cameras_txt(path, cameras):
    lines = ["# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]"]
    for c in cameras.values():
        params = " ".join(str(v) for v in c.params)
        lines.append(f"{c.id} {c.model} {c.width} {c.height} {params}")
    Path(path).write_text("\n".join(lines) + "\n")


def _write_images_txt(path, images):
    lines = ["# Image list: IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME",
             "#   POINTS2D[] as (X, Y, POINT3D_ID)"]
    for im in images.values():
        q = " ".join(str(v) for v in im.qvec)
        t = " ".join(str(v) for v in im.tvec)
        lines.append(f"{im.id} {q} {t} {im.camera_id} {im.name}")
        lines.append(" ".join(f"{xy[0]} {xy[1]} {int(pid)}"
                              for xy, pid in zip(im.xys, im.point3D_ids)))
    Path(path).write_text("\n".join(lines) + "\n")


def _write_points3d_txt(path, points):
    lines = ["# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[]"]
    for p in points.values():
        xyz = " ".join(str(v) for v in p.xyz)
        rgb = " ".join(str(int(v)) for v in p.rgb)
        track = " ".join(f"{int(i)} {int(j)}"
                         for i, j in zip(p.image_ids, p.point2D_idxs))
        lines.append(f"{int(p.id)} {xyz} {rgb} {p.error} {track}")
    Path(path).write_text("\n".join(lines) + "\n")


# ------------------------------- public API --------------------------------

def read_model(path, ext: str | None = None):
    """Load (cameras, images, points3D) from a sparse model directory.
    Auto-detects .bin vs .txt when ext is None."""
    path = Path(path)
    if ext is None:
        ext = ".bin" if (path / "cameras.bin").exists() else ".txt"
    if ext == ".bin":
        return (_read_cameras_bin(path / "cameras.bin"),
                _read_images_bin(path / "images.bin"),
                _read_points3d_bin(path / "points3D.bin"))
    return (_read_cameras_txt(path / "cameras.txt"),
            _read_images_txt(path / "images.txt"),
            _read_points3d_txt(path / "points3D.txt"))


def write_model(cameras, images, points3D, path, ext: str = ".bin"):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if ext == ".bin":
        _write_cameras_bin(path / "cameras.bin", cameras)
        _write_images_bin(path / "images.bin", images)
        _write_points3d_bin(path / "points3D.bin", points3D)
    else:
        _write_cameras_txt(path / "cameras.txt", cameras)
        _write_images_txt(path / "images.txt", images)
        _write_points3d_txt(path / "points3D.txt", points3D)
