"""File-format codecs: PFM, Yao camera txt, Gipuma DMB, COLMAP float arrays.

The port's own copy of wildmvs/data/codecs.py (numpy only). Formats
(reference code locations): PFM (data/MVSDataset.py:152-187),
Yao-format cam.txt (data/dtu_yao.py:71-82, data/blended.py:66-81),
Gipuma .dmb (evaluation/fusibile.py:27-63), COLMAP .bin float arrays
(utils/colmap_utils.py:233-279). All are tiny self-describing binary/text
formats; implemented from the format specs.
"""
from __future__ import annotations

import re
import struct
from pathlib import Path

import numpy as np


# ---------------------------------------------------------------------------
# PFM (portable float map): used by DTU/BlendedMVS depth ground truth.
# ---------------------------------------------------------------------------

def read_pfm(path) -> tuple[np.ndarray, float]:
    """Read a PFM file -> (float array [H, W] or [H, W, 3], scale)."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline().decode("latin-1")
        m = re.match(r"^(\d+)\s(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"malformed PFM header: {dims!r}")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("latin-1").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(), dtype=endian + "f")
        shape = (h, w, 3) if color else (h, w)
        data = data.reshape(shape)
        # PFM stores rows bottom-to-top
        return np.flipud(data).copy(), abs(scale)


def write_pfm(path, image: np.ndarray, scale: float = 1.0):
    """Write a float array as PFM (rows stored bottom-to-top)."""
    image = np.asarray(image, np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("PFM needs HxW or HxWx3")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)


# ---------------------------------------------------------------------------
# Yao-format camera text files (MVSNet convention):
#   extrinsic\n <4x4>\n intrinsic\n <3x3>\n \n depth_min interval [count max]
# ---------------------------------------------------------------------------

def read_cam_txt(path) -> dict:
    """Parse a Yao cam.txt -> {extrinsic [4,4], intrinsic [3,3],
    depth_min, depth_interval, [depth_count, depth_max]}."""
    tokens = Path(path).read_text().split()
    assert tokens[0] == "extrinsic", tokens[:2]
    ext = np.array(tokens[1:17], np.float64).reshape(4, 4)
    assert tokens[17] == "intrinsic", tokens[17]
    intr = np.array(tokens[18:27], np.float64).reshape(3, 3)
    rest = [float(x) for x in tokens[27:]]
    out = {"extrinsic": ext, "intrinsic": intr}
    if len(rest) >= 1:
        out["depth_min"] = rest[0]
    if len(rest) >= 2:
        out["depth_interval"] = rest[1]
    if len(rest) >= 3:
        out["depth_count"] = rest[2]
    if len(rest) >= 4:
        out["depth_max"] = rest[3]
    return out


def write_cam_txt(path, extrinsic: np.ndarray, intrinsic: np.ndarray,
                  depth_min: float = None, depth_interval: float = None,
                  depth_count: float = None, depth_max: float = None):
    lines = ["extrinsic"]
    for r in np.asarray(extrinsic).reshape(4, 4):
        lines.append(" ".join(f"{v}" for v in r))
    lines += ["", "intrinsic"]
    for r in np.asarray(intrinsic).reshape(3, 3):
        lines.append(" ".join(f"{v}" for v in r))
    tail = [v for v in (depth_min, depth_interval, depth_count, depth_max)
            if v is not None]
    lines += ["", " ".join(f"{v}" for v in tail)]
    Path(path).write_text("\n".join(lines) + "\n")


def read_pair_txt(path) -> list[tuple[int, list[int]]]:
    """Parse pair.txt: first line = #views, then per view: id then
    '<k> src score src score ...'. Returns [(ref_id, [src ids...])]."""
    tokens = Path(path).read_text().split()
    n = int(tokens[0])
    pos = 1
    out = []
    for _ in range(n):
        ref = int(tokens[pos]); pos += 1
        k = int(tokens[pos]); pos += 1
        srcs = [int(tokens[pos + 2 * i]) for i in range(k)]
        pos += 2 * k
        out.append((ref, srcs))
    return out


# ---------------------------------------------------------------------------
# Gipuma .dmb (binary float map: int32 type, h, w, c then data) — fusibile IO.
# ---------------------------------------------------------------------------

def read_dmb(path) -> np.ndarray:
    """The file stores CHANNEL PLANES, each a row-major [h, w] map
    (fusibile.py:27-39 reshape((w,h,c), order='F') + transpose). Identical
    to interleaved only for c == 1."""
    with open(path, "rb") as f:
        _type, h, w, c = struct.unpack("<iiii", f.read(16))
        data = np.frombuffer(f.read(), "<f4")
    if c > 1:
        return data.reshape(c, h, w).transpose(1, 2, 0)
    return data.reshape(h, w)


def write_dmb(path, arr: np.ndarray):
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        h, w, c = arr.shape[0], arr.shape[1], 1
        flat = arr
    else:
        h, w, c = arr.shape
        flat = arr.transpose(2, 0, 1)  # channel-planar (fusibile.py:41-63)
    with open(path, "wb") as f:
        f.write(struct.pack("<iiii", 1, h, w, c))
        np.ascontiguousarray(flat, "<f4").tofile(f)


# ---------------------------------------------------------------------------
# COLMAP binary float arrays (depth/normal maps): "w&h&c&" ascii header + f32.
# ---------------------------------------------------------------------------

def read_colmap_array(path) -> np.ndarray:
    with open(path, "rb") as f:
        header = b""
        amps = 0
        while amps < 3:
            ch = f.read(1)
            header += ch
            if ch == b"&":
                amps += 1
        w, h, c = (int(x) for x in header.decode().split("&")[:3])
        data = np.frombuffer(f.read(), "<f4")
    # channel-planar like the dmb codec (colmap_utils.py:233-248
    # reshape((w,h,c), order='F') + transpose; COLMAP src/mvs/mat.h)
    if c > 1:
        return data.reshape(c, h, w).transpose(1, 2, 0)
    return data.reshape(h, w)


def write_colmap_array(path, arr: np.ndarray):
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{c}&".encode())
        np.ascontiguousarray(arr.transpose(2, 0, 1), "<f4").tofile(f)
