"""Native host helpers (C++), built with g++ on first use and loaded with
ctypes.

The port's own copy of wildmvs/cpp, under the same names: kdtree.cpp (the
3D k-d tree behind the metrics' NN distances and radius dedup) and
image.cpp (JPEG/PNG decode and the f32 Lanczos-3 resize behind the
loaders). The C++ is the JAX package's, so both packages compute the same
bits on one host.

Build: `g++ -O3 -shared -fPIC -std=c++17 -pthread -march=native` into
`build/native/` at the repository root (git-ignored). The file name
carries a hash of the sources, the flags and the host CPU's feature flags
(-march=native code runs only on a CPU like the one that built it), so an
edited source or another host never loads a stale library. The "full"
library links libjpeg and libpng; where their headers are missing, a
"kdtree" library holds the tree alone and the loaders take PIL. Each build
writes a per-process temporary file and publishes it with os.replace, so
processes that build at once never load a half-written library. A library
that does not load is deleted, so the next process rebuilds it, and this
process takes the scipy/PIL fallbacks. Nothing builds at import:
`get_lib()` builds on first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent.parent / "build" / "native"
SOURCES = {"full": ("kdtree.cpp", "image.cpp"), "kdtree": ("kdtree.cpp",)}
LINK = {"full": ["-ljpeg", "-lpng"], "kdtree": []}
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             "-march=native"]

_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False
_VARIANT = None          # "full" or "kdtree" once a library loaded


def _host_cpu() -> str:
    """The host CPU's feature flags (what -march=native compiles for)."""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith(("flags", "Features")):
                return line
    except OSError:
        pass
    import platform
    return platform.machine() + platform.processor()


def library_path(variant: str) -> Path:
    h = hashlib.sha256()
    for name in SOURCES[variant]:
        h.update(name.encode())
        h.update((HERE / name).read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK[variant]).encode())
    h.update(_host_cpu().encode())
    return BUILD_DIR / f"libwildmvs_native_{variant}_{h.hexdigest()[:16]}.so"


def _compile(variant: str) -> Path | None:
    """Build `variant` unless its library exists; None if g++ fails."""
    lib = library_path(variant)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *CXX_FLAGS,
                        *[str(HERE / s) for s in SOURCES[variant]],
                        "-o", str(tmp), *LINK[variant]],
                       check=True, capture_output=True)
        os.replace(tmp, lib)     # atomic: never a half-written library
        return lib
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    finally:
        tmp.unlink(missing_ok=True)


def build() -> tuple[Path | None, str | None]:
    """The full library, else the k-d tree alone: (path, variant), or
    (None, None) when neither builds."""
    for variant in ("full", "kdtree"):
        lib = _compile(variant)
        if lib is not None:
            return lib, variant
    return None, None


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _LIB_FAILED, _VARIANT
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        so, variant = build()
        if so is None:
            print("wildmvs_torch.cpp: native build failed (g++); using the "
                  "scipy/PIL fallbacks", file=sys.stderr)
            _LIB_FAILED = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            # a corrupt or truncated library: drop it so that the next
            # process rebuilds, and take the fallbacks in this one
            print(f"wildmvs_torch.cpp: failed to load {so.name}; rebuilding "
                  f"next run, using the scipy/PIL fallbacks", file=sys.stderr)
            so.unlink(missing_ok=True)
            _LIB_FAILED = True
            return None
        if variant == "full":
            lib.wmvs_load_batch.restype = ctypes.c_int
            lib.wmvs_load_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int]
            lib.wmvs_resize_f32.restype = None
            lib.wmvs_resize_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.wmvs_free.restype = None
            lib.wmvs_free.argtypes = [ctypes.c_void_p]
        lib.kdtree_build.restype = ctypes.c_void_p
        lib.kdtree_build.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.kdtree_free.restype = None
        lib.kdtree_free.argtypes = [ctypes.c_void_p]
        lib.kdtree_nn.restype = None
        lib.kdtree_nn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_double,
                                  ctypes.c_void_p, ctypes.c_int]
        lib.kdtree_radius_dedup.restype = None
        lib.kdtree_radius_dedup.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_void_p]
        _LIB, _VARIANT = lib, variant
        return _LIB


def variant() -> str | None:
    """Which library loaded: "full", "kdtree", or None (no library)."""
    return _VARIANT if get_lib() is not None else None


def _points(a: np.ndarray) -> np.ndarray:
    """[N, 3] float64, C-contiguous (the C side reads double[3] rows)."""
    a = np.ascontiguousarray(a, dtype=np.float64)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"expected [N, 3] points, got {a.shape}")
    return a


class NativeKDTree:
    """3D KD-tree over [N, 3] float64 points (native C++)."""

    def __init__(self, points: np.ndarray):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._pts = _points(points)       # the tree points into this buffer
        self._handle = lib.kdtree_build(
            self._pts.ctypes.data_as(ctypes.c_void_p), self._pts.shape[0])

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.kdtree_free(self._handle)
            self._handle = None

    def nn_distance(self, queries: np.ndarray, maxdist: float = np.inf,
                    threads: int = 8) -> np.ndarray:
        """NN distance per query, clipped at maxdist (like cKDTree.query
        with distance_upper_bound, but returning maxdist instead of inf)."""
        q = _points(queries)
        out = np.empty(q.shape[0], np.float64)
        md = 1e30 if np.isinf(maxdist) else float(maxdist)
        self._lib.kdtree_nn(self._handle, q.ctypes.data_as(ctypes.c_void_p),
                            q.shape[0], md, out.ctypes.data_as(ctypes.c_void_p),
                            threads)
        return out


def radius_dedup(points: np.ndarray, radius: float,
                 order: np.ndarray) -> np.ndarray:
    """Random-order radius dedup -> keep mask (bool[N])."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    pts = _points(points)
    order = np.ascontiguousarray(order, dtype=np.int64)
    if order.shape != (pts.shape[0],):
        raise ValueError(f"order {order.shape} for {pts.shape[0]} points")
    keep = np.empty(pts.shape[0], np.uint8)
    lib.kdtree_radius_dedup(pts.ctypes.data_as(ctypes.c_void_p),
                            pts.shape[0], float(radius),
                            order.ctypes.data_as(ctypes.c_void_p),
                            keep.ctypes.data_as(ctypes.c_void_p))
    return keep.astype(bool)


def has_image_module() -> bool:
    """True when the native JPEG/PNG decode + Lanczos resize module linked."""
    return variant() == "full"


def load_images(paths, resize_to: tuple | None = None, threads: int = 0):
    """Decode n images in parallel (native pool), optional min-side-fit
    LANCZOS resize exactly as `data.loaders.read_image` defines it.

    Returns list of (img float32 [H,W,3]|[H,W] in [0,1], ratio) — ratio is
    original/resized. Raises RuntimeError if the image module is unavailable
    or any file fails to decode (caller falls back to PIL).
    """
    if not has_image_module():
        raise RuntimeError("native image module unavailable")
    lib = get_lib()
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    out_data = (ctypes.c_void_p * n)()
    out_h = (ctypes.c_int * n)()
    out_w = (ctypes.c_int * n)()
    out_c = (ctypes.c_int * n)()
    out_r = (ctypes.c_float * n)()
    th, tw = (0, 0) if resize_to is None else (int(resize_to[0]),
                                               int(resize_to[1]))
    ok = lib.wmvs_load_batch(c_paths, n, th, tw, out_data, out_h, out_w,
                             out_c, out_r, threads)
    results = []
    try:
        if ok != n:
            bad = [str(paths[i]) for i in range(n) if not out_data[i]]
            raise RuntimeError(f"native decode failed for {bad}")
        for i in range(n):
            h, w, c = out_h[i], out_w[i], out_c[i]
            buf = ctypes.cast(out_data[i],
                              ctypes.POINTER(ctypes.c_float * (h * w * c)))
            img = np.frombuffer(buf.contents, np.float32).reshape(h, w, c)
            if c == 1:  # match np.asarray(PIL gray) -> [H, W]
                img = img[..., 0]
            results.append((img.copy(), float(out_r[i])))
    finally:
        for i in range(n):
            if out_data[i]:
                lib.wmvs_free(out_data[i])
    return results


def resize_lanczos(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Native separable Lanczos-3 resize of float32 [H, W, C] (PIL box
    semantics, no clamping)."""
    if not has_image_module():
        raise RuntimeError("native image module unavailable")
    lib = get_lib()
    src = np.ascontiguousarray(img, dtype=np.float32)
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    h, w, c = src.shape
    dst = np.empty((out_h, out_w, c), np.float32)
    lib.wmvs_resize_f32(src.ctypes.data_as(ctypes.c_void_p), h, w, c,
                        out_h, out_w, dst.ctypes.data_as(ctypes.c_void_p))
    return dst[..., 0] if squeeze else dst
