"""PLY point-cloud codec (ascii and binary, little or big endian).

The port's own numpy copy of wildmvs/data/ply.py (reference
utils/utils_ply.py): reads fused and ground-truth clouds for the metrics
and writes the fusion's output, from the PLY format spec over structured
numpy.
"""
from __future__ import annotations

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
              "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


def read_ply(path) -> np.ndarray:
    """Read the `vertex` element -> structured array (fields as named)."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements = []  # (name, count, [(prop_name, np_type)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unterminated PLY header")
            tokens = line.decode("latin-1").strip().split()
            if not tokens or tokens[0] == "comment":
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                cur = (tokens[1], int(tokens[2]), [])
                elements.append(cur)
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    cur[2].append((tokens[-1], "list",
                                   _PLY_TO_NP[tokens[2]], _PLY_TO_NP[tokens[3]]))
                else:
                    cur[2].append((tokens[-1], _PLY_TO_NP[tokens[1]]))
            elif tokens[0] == "end_header":
                break

        endian = {"binary_little_endian": "<", "binary_big_endian": ">",
                  "ascii": None}[fmt]

        out = None
        for name, count, props in elements:
            if any(p[1] == "list" for p in props):
                if name == "vertex":
                    raise ValueError("list properties on vertex unsupported")
                # skip non-vertex list elements (e.g. faces)
                if endian is None:
                    for _ in range(count):
                        f.readline()
                else:
                    for _ in range(count):
                        n_t, v_t = props[0][2], props[0][3]
                        n = np.frombuffer(f.read(np.dtype(n_t).itemsize),
                                          endian + n_t)[0]
                        f.read(int(n) * np.dtype(v_t).itemsize)
                continue
            if endian is None:
                rows = [f.readline().split() for _ in range(count)]
                arr = np.zeros(count, dtype=[(p, t) for p, t in props])
                for j, (p, t) in enumerate(props):
                    arr[p] = np.array([r[j] for r in rows], dtype=t)
            else:
                dt = np.dtype([(p, endian + t) for p, t in props])
                arr = np.frombuffer(f.read(count * dt.itemsize), dt).copy()
            if name == "vertex":
                out = arr
        if out is None:
            raise ValueError("PLY file has no vertex element")
        return out


def ply_xyz(path) -> np.ndarray:
    """Read just the xyz coordinates -> [N, 3] float64."""
    v = read_ply(path)
    return np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)


def write_ply(path, points: np.ndarray, colors: np.ndarray | None = None,
              normals: np.ndarray | None = None, binary: bool = True):
    """Write a point cloud.

    Args:
      points: [N, 3] float.
      colors: optional [N, 3] uint8.
      normals: optional [N, 3] float.
    """
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    fields = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    if normals is not None:
        fields += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    arr = np.zeros(n, dtype=[(f, "<" + t if t != "u1" else t)
                             for f, t in fields])
    arr["x"], arr["y"], arr["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        normals = np.asarray(normals, np.float32)
        arr["nx"], arr["ny"], arr["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if colors is not None:
        colors = np.asarray(colors, np.uint8)
        arr["red"], arr["green"], arr["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]

    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}"]
    for fname, t in fields:
        header.append(f"property {_NP_TO_PLY[t]} {fname}")
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            arr.tofile(f)
        else:
            for row in arr:
                f.write((" ".join(str(v) for v in row) + "\n").encode())
