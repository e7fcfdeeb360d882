"""Headline benchmark of the port: depthmap inference throughput, one card.

    python -m wildmvs_torch.bench [--device cuda|cpu]

The counterpart of the repo-level bench.py (the JAX package's), with its
field names and configurations: the headline is MVSNet at 512x640, N=3
views, 192 depth hypotheses, bf16, in depthmaps/s; the same record carries
Vis-MVSNet and CVP-MVSNet at their training-resolution eval configurations
and all three architectures at the DTU eval protocol (1184x1600, N=5),
exact and rectified, Vis-MVSNet also with its trained weights
(assets/vis_synth_trained.npz) on a rendered textured plane. Weights are
the port's seeded init (`build_model(..., seed=0)`), batch 1, bf16 weights
and compute, PyTorch's default TF32 flags.

A complete JSON record is printed (flushed) after every measurement,
starting with the headline, so a run cut short keeps what it measured.
A measurement that fails is recorded as `<key>_error` and the run goes
on; the exit code is then 1.

Switches (environment, read by `main`):
  WILDMVS_BENCH_METHOD    MVSNet's sweep_method ("auto": the fused kernel)
  WILDMVS_BENCH_EXTRAS=0  skip the Vis / CVP training-resolution fields
  WILDMVS_BENCH_EVALRES=0 skip the eval-protocol fields
  WILDMVS_BENCH_SMOKE=1   one forward a chain, one chain (no real timing)
  WILDMVS_BENCH_DEADLINE  seconds after which the remaining fields are
                          skipped as `<key>_skipped` (default 1380)

Each field's diagnostics, `<key>_<name>` (`headline_<name>` for the
headline): seconds per forward is the best of 3 timed chains of `iters`
eager forwards after one warm-up chain (host clock, each chain ending in a
device sync), as bench.py's `time_model`;
  spread_pct     (slowest - best) / best of the chains, %
  median_ms      the median chain's ms per forward
  launches       the port's kernel launches per forward, by kernel
  peak_gib       max_memory_allocated over the field's forwards
  finite_share   the share of finite depth pixels of one more, untimed
                 forward
Only on the card: peak_gib (a device figure) and `card`, the nvidia-smi
name and power limit.

Unlike bench.py: no `vs_baseline` (its denominators are a torch-CPU figure
scaled by a measured CPU-to-TPU ratio; no TPU figure is the port's
target), no cost fields (the benchmark, mvsbench, reads a cell's MFU and
kernel rooflines on the card), no compilation cache (nothing is compiled
ahead), and the added launches, peak_gib, median_ms, finite_share, card,
torch and cuda fields.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device
from .ops import sweep_kernels as sk

HEADLINE = "mvsnet_depthmap_inference_512x640_D192_N3"
VIS_ASSET = Path(__file__).resolve().parents[1] / "assets" / \
    "vis_synth_trained.npz"
#: the textured plane the trained Vis field renders (bench.py:221-224)
VIS_PLANE = dict(plane=(-30.0, 0.12, -0.08), extent=320.0, seed=0)
DEPTH_RANGE = (425.0, 935.0)


def _scene_np(b, n, h, w, f):
    """bench.py's `scene` (bench.py:61-74) in numpy: views 0.1 mm apart
    sideways, random images."""
    rng = np.random.default_rng(0)
    imgs = rng.random((b, n, h, w, 3)).astype(np.float32)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    K = np.tile(K, (b, n, 1, 1))
    R = np.tile(np.eye(3, dtype=np.float32), (b, n, 1, 1))
    t = np.zeros((b, n, 3, 1), np.float32)
    for i in range(n):
        t[:, i, 0, 0] = 0.1 * i
    return imgs, K, R, t


def _scene_dtu_np(b, n, h, w, f):
    """bench.py's `scene_dtu` (bench.py:77-107) in numpy: cameras on a
    650 mm sphere in ~6 degree steps, random images."""
    rng = np.random.default_rng(0)
    imgs = rng.random((b, n, h, w, 3)).astype(np.float32)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    Ks, Rs, ts = [], [], []
    up = np.array([0.0, -1.0, 0.0])
    for i in range(n):
        az = np.deg2rad(6.0) * ((i + 1) // 2) * (-1) ** i
        el = np.deg2rad(3.0) * (i % 3 - 1)
        d = np.array([np.sin(az) * np.cos(el), np.sin(el),
                      -np.cos(az) * np.cos(el)])
        eye = -650.0 * d
        z = -eye / np.linalg.norm(eye)
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z], 0).astype(np.float32)
        ts.append((-R @ eye).astype(np.float32).reshape(3, 1))
        Rs.append(R)
        Ks.append(K)
    K = np.tile(np.stack(Ks)[None], (b, 1, 1, 1))
    R = np.tile(np.stack(Rs)[None], (b, 1, 1, 1))
    t = np.tile(np.stack(ts)[None], (b, 1, 1, 1))
    return imgs, K, R, t


RIGS = {"scene": _scene_np, "scene_dtu": _scene_dtu_np}


def _tensors(imgs, K, R, t, device):
    b, n = imgs.shape[:2]
    dmin = np.full((b, n), DEPTH_RANGE[0], np.float32)
    dmax = np.full((b, n), DEPTH_RANGE[1], np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (imgs, K, R, t, dmin, dmax))


def scene(b, n, h, w, f, device="cpu"):
    """(imgs [b, n, h, w, 3], K, R, t, depth_min, depth_max) of bench.py's
    `scene` rig, f32 tensors on `device`."""
    return _tensors(*_scene_np(b, n, h, w, f), device)


def scene_dtu(b, n, h, w, f, device="cpu"):
    """bench.py's `scene_dtu` rig, as `scene`."""
    return _tensors(*_scene_dtu_np(b, n, h, w, f), device)


@dataclasses.dataclass(frozen=True)
class Field:
    """One measurement: bench.py's record key, the architecture and its
    constructor kwargs (besides dtype, seed and device), the rig
    (RIGS name, b, n, h, w, f), forwards a timed chain, forward kwargs,
    and whether it serves the trained Vis asset on the rendered plane."""
    key: str
    architecture: str
    rig: tuple
    iters: int
    model: dict = dataclasses.field(default_factory=dict)
    forward: dict = dataclasses.field(default_factory=dict)
    trained: bool = False


def fields(method: str = "auto", extras: bool = True,
           evalres: bool = True) -> list:
    """bench.py's fields in its order (bench.py:265-372), MVSNet's sweep
    through `method`."""
    mvsnet = dict(num_depth=192, sweep_method=method)
    vis = dict(depth_nums=(64, 32, 16), interval_scales=(2.0, 1.0, 0.5))
    cvp = dict(nscale=5)
    head = ("scene", 1, 3, 512, 640, 720.0)
    evalrig = ("scene_dtu", 1, 5, 1184, 1600, 2892.0)
    out = [Field(HEADLINE, "mvsnet", head, 10, mvsnet)]
    if extras:
        out += [Field("vis_mvsnet_maps_s", "vis_mvsnet",
                      ("scene", 1, 3, 256, 320, 360.0), 6, vis),
                Field("cvp_mvsnet_maps_s", "cvp_mvsnet", head, 6,
                      forward=cvp)]
    if evalres:
        out += [
            Field("mvsnet_train_dtugeo_maps_s", "mvsnet",
                  ("scene_dtu", 1, 3, 512, 640, 1156.8), 10, mvsnet),
            Field("mvsnet_eval_1184x1600_N5_maps_s", "mvsnet", evalrig, 4,
                  mvsnet),
            Field("mvsnet_eval_1184x1600_N5_rect_maps_s", "mvsnet", evalrig,
                  4, dict(num_depth=192, sweep_method="rect")),
            Field("vis_eval_1184x1600_N5_maps_s", "vis_mvsnet", evalrig, 3,
                  vis),
            Field("vis_eval_1184x1600_N5_trained_maps_s", "vis_mvsnet",
                  evalrig, 3, vis, trained=True),
            Field("cvp_eval_1184x1600_N5_maps_s", "cvp_mvsnet", evalrig, 3,
                  forward=cvp),
            Field("cvp_eval_1184x1600_N5_rect_maps_s", "cvp_mvsnet",
                  evalrig, 3, dict(sweep_method="rect"), forward=cvp)]
    return out


def build(field: Field, device):
    """(model in eval mode, forward args) of a field on `device`."""
    from .data.synthetic import render_rig_plane
    from .models import build_model
    from .train.jax_import import load_params_npz, state_dict_from_jax

    name, *shape = field.rig
    imgs, K, R, t = RIGS[name](*shape)
    model = build_model(field.architecture, device=device, seed=0,
                        dtype=torch.bfloat16, **field.model)
    if field.trained:
        params, stats, _ = load_params_npz(VIS_ASSET)
        model.load_state_dict(state_dict_from_jax(params, stats))
        h, w = imgs.shape[2:4]
        imgs = render_rig_plane(K[0], R[0], t[0], h, w, **VIS_PLANE)[0][None]
    return model.eval(), _tensors(imgs, K, R, t, device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_model(model, args, kwargs, iters: int, repeats: int = 3,
               info: dict | None = None, smoke: bool = False) -> float:
    """Best-of-`repeats` seconds per forward (bench.py:146-212).

    A chain is `iters` eager forwards under inference_mode, each adding its
    depth's sum to a device scalar, ending in a device sync, timed by the
    host clock; one warm-up chain first. `info` (optional) receives the
    module docstring's diagnostics, finite_share from one more forward.
    """
    if smoke:
        iters, repeats = 1, 1
    device = args[0].device

    def chain():
        with torch.inference_mode():
            total = torch.zeros((), device=device)
            for _ in range(iters):
                total += model(*args, **kwargs)["depth"].float().sum()
        _sync(device)
        return total

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sk.reset_launch_counts()
    chain()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        chain()
        times.append(time.perf_counter() - t0)
    best = min(times)
    if info is None:
        return best / iters
    forwards = iters * (repeats + 1)
    launches = {k: v / forwards for k, v in sk.launch_counts().items() if v}
    info["spread_pct"] = 100.0 * (max(times) - best) / max(best, 1e-9)
    info["median_ms"] = 1e3 * statistics.median(times) / iters
    info["launches"] = {k: int(v) if v == int(v) else v
                        for k, v in launches.items()}
    if device.type == "cuda":
        info["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    with torch.inference_mode():
        depth = model(*args, **kwargs)["depth"]
    info["finite_share"] = torch.isfinite(depth).float().mean().item()
    return best / iters


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wildmvs_torch.bench", description=__doc__.split(
            "\n\n")[0], formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    env = os.environ
    method = env.get("WILDMVS_BENCH_METHOD", "auto")
    extras = env.get("WILDMVS_BENCH_EXTRAS", "1") != "0"
    evalres = env.get("WILDMVS_BENCH_EVALRES", "1") != "0"
    smoke = env.get("WILDMVS_BENCH_SMOKE", "0") == "1"
    deadline = float(env.get("WILDMVS_BENCH_DEADLINE", "1380"))
    t_start = time.time()

    def note(msg):
        print(f"[t+{time.time() - t_start:5.0f}s] {msg}", file=sys.stderr,
              flush=True)

    record = {}
    context = {"device": str(device), "torch": torch.__version__,
               "cuda": torch.version.cuda}
    if device.type == "cuda":
        context["card"] = card_line()

    def emit():
        print(json.dumps(record), flush=True)

    def run(field: Field, info: dict) -> float:
        model, args = build(field, device)
        try:
            return 1.0 / time_model(model, args, field.forward, field.iters,
                                    info=info, smoke=smoke)
        finally:
            del model, args
            if device.type == "cuda":
                torch.cuda.empty_cache()

    head, *rest = fields(method, extras, evalres)
    note(f"bench: timing {head.key} ...")
    info = {}
    value = run(head, info)
    record.update({"metric": head.key, "value": value,
                   "unit": "depthmaps/s", **context})
    record.update({f"headline_{k}": v for k, v in info.items()})
    note(f"bench: headline {value:.3f} maps/s, launches "
         f"{info['launches']}")
    emit()

    for field in rest:
        if time.time() - t_start > deadline:
            record[f"{field.key}_skipped"] = "deadline"
            emit()
            continue
        try:
            note(f"bench: timing {field.key} ...")
            info = {}
            record[field.key] = run(field, info)
            record.update({f"{field.key}_{k}": v for k, v in info.items()})
            note(f"bench: {field.key} = {record[field.key]:.3f}, launches "
                 f"{info['launches']}")
        except Exception as e:       # one field's failure keeps the others
            record[f"{field.key}_error"] = f"{type(e).__name__}: {e}"[:200]
            note(f"bench: {field.key} failed: {record[field.key + '_error']}")
        emit()
    return 1 if any(k.endswith("_error") for k in record) else 0


if __name__ == "__main__":
    sys.exit(main())
