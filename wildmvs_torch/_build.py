"""Build and load the port's CUDA kernels (csrc/*.cu) on first use.

Route: nvcc by hand into a shared library with a plain `extern "C"`
interface, loaded with ctypes. Each csrc/*.cu is compiled to an object by
its own nvcc, all started together, and the objects are linked into one
library. No PyTorch headers are compiled, so a build takes seconds. The
library lands in `build/kernels/` at the repository root (listed in
.gitignore); its file name carries a hash of the sources (headers
included) and flags, so an edited source never loads a stale library.

Every pointer and the stream are declared `ctypes.c_void_p` (a bare Python
int would be passed as a 32-bit int and cut the pointer); every C entry
returns `cudaGetLastError()` as an int, which the wrappers check.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu (argument order as declared there); _F * 6 is a
# coordinate convention (sx, sy, x_lo, x_hi, y_lo, y_hi)
SIGNATURES = {
    "wm_sweep_warp": [_P] * 5 + [_I] * 8 + [_F] * 6 + [_P],
    "wm_sweep_warp_backward": [_P] * 5 + [_I] * 9 + [_F] * 6 + [_P],
    "wm_fused_cost_volume": [_P] * 8 + [_I] * 12 + [_P],
    "wm_sweep_gwc": [_P] * 7 + [_I] * 10 + [_F] * 6 + [_P],
}

_lib = None


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then
    /usr/local/cuda/bin/nvcc."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from csrc/ on first use")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libwildmvs_sweep_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists: one
    nvcc per source, all running at once, then one link. The compilers'
    output (the -Xptxas -v register/spill summary) is kept in
    `<library>.log`. Returns the library path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{lib.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in (s for s in sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], False
    for proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        failed |= proc.returncode != 0
    tmp = lib.with_name(f"{tag}.tmp.so")
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        failed = link.returncode != 0
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "".join(logs)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{log}")
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)      # atomic: a concurrent process never loads
    return lib                # a half-written library


def build_log() -> str:
    """The compiler output of the current library's build ('' if the
    library was built by an earlier process without a log)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (its cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch error {rc}")
