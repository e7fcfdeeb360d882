#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (wildmvs_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (the kernels are built from
wildmvs_torch/csrc/ on first use); fails without them. Imports nothing of
JAX or of the JAX package. Phases, each of which stops the run if it fails:

  1. kernel vs plain: each Hopper kernel against its plain PyTorch version
     at the 512x640 headline shapes (128x160 features, C=32, D=192, NV=2):
     fronto-parallel and per-pixel hypotheses, variance and softmin, and a
     rig partly behind the source camera. Times the kernel, the plain
     version and, for the warp, torch's grid_sample over the same grid.
  2. serving (the main path): Predictor("mvsnet", bf16) at 512x640, N=3,
     D=192 answers 3 requests (seeded DTU-like scenes) through the fused
     kernel, then one through the per-view warp kernel; the launch counts
     must move, the outputs be finite and the depth agree with the exact
     gather path.
  3. eval: one 1184x1600, N=5, D=192 request through the fused kernel.
  4. run_depthmaps over 2 in-memory samples into a temporary directory.

Prints the card, the kernels' register/spill summary and one line per
phase, then a `kernels` JSON line and, last, the device JSON line.
"""
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from wildmvs_torch import _build
from wildmvs_torch.geometry.projective import build_proj_matrices, scale_K
from wildmvs_torch.infer import Predictor
from wildmvs_torch.ops import sweep_kernels as sk
from wildmvs_torch.pipeline.depthmaps import run_depthmaps

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
HEADLINE = dict(n=3, h=512, w=640, f=1156.8)
EVAL = dict(n=5, h=1184, w=1600, f=2892.0)
NUM_DEPTH = 192
DEPTH_RANGE = (425.0, 935.0)
# random weights give nearly equal logits over depth (a flat softmax, every
# depth the mid-range one); this gain on the last conv peaks them, so that
# the sweep backends' differences reach the depth
PROB_GAIN = 100.0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def dtu_scene(seed: int, n: int, h: int, w: int, f: float):
    """A DTU-like rig: cameras on a 650 mm sphere in ~6 degree steps
    looking at the origin, random images; (imgs [N, H, W, 3], K, R, t,
    depth_min [N], depth_max [N]) as numpy f32."""
    rng = np.random.default_rng(seed)
    imgs = rng.random((n, h, w, 3), dtype=np.float32)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    up = np.array([0.0, -1.0, 0.0])
    Rs, ts = [], []
    for i in range(n):
        az = np.deg2rad(6.0) * ((i + 1) // 2) * (-1) ** i
        el = np.deg2rad(3.0) * (i % 3 - 1)
        d = np.array([np.sin(az) * np.cos(el), np.sin(el),
                      -np.cos(az) * np.cos(el)])
        eye = -650.0 * d
        z = -eye / np.linalg.norm(eye)
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z]).astype(np.float32)
        Rs.append(R)
        ts.append((-R @ eye).astype(np.float32).reshape(3, 1))
    return (imgs, np.stack([K] * n), np.stack(Rs), np.stack(ts),
            np.full(n, DEPTH_RANGE[0], np.float32),
            np.full(n, DEPTH_RANGE[1], np.float32))


def feature_projections(K, R, t, dev):
    """[1, N, 4, 4] projections at 1/4 feature resolution, on the card."""
    k = torch.from_numpy(K)[None].to(dev)
    return build_proj_matrices(scale_K(k, 0.25),
                               torch.from_numpy(R)[None].to(dev),
                               torch.from_numpy(t)[None].to(dev))


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, CUDA events over `reps` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def live_samples(P, Q, s, h, w) -> int:
    """Bilinear samples that read the source (the data-dependent work)."""
    s = s[:, :, None, None] if s.dim() == 2 else s
    r = P[:, :, None] * s[:, None] + Q[:, :, None]
    pos = r[:, 2] > 0
    z = torch.where(pos, r[:, 2], torch.ones_like(r[:, 2]))
    x0 = torch.floor(r[:, 0] / z)
    y0 = torch.floor(r[:, 1] / z)
    live = pos & (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
    return int(live.sum())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, flops: float):
    """(bound_ms, bound_by): the larger of the byte and operation times."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, got, want, extra=""):
    """Max abs error of kernel vs plain, held to one bf16 ulp of the scale:
    both round the same f32 arithmetic to bf16 once; FMA contraction and
    summation order may move a value across a rounding boundary."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    limit = 2.0 ** -7 * max(scale, 1e-6)
    print(f"phase1 {name}: max_abs_err {err:.6g} limit {limit:.6g} "
          f"(scale {scale:.4g}){extra}", flush=True)
    check(err <= limit, f"{name}: kernel vs plain {err} > {limit}")
    return err


def kernel_inputs(cfg, dev, C=32):
    """Seeded bf16 features and the DTU-like rig's planes at feature
    resolution: (ref [1, H, W, C], srcs [1, NV, H, W, C], P, Q
    [1, NV, 3, H, W], s [1, D], K, R, t)."""
    n, fh, fw = cfg["n"], cfg["h"] // 4, cfg["w"] // 4
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal(
        (1, n, fh, fw, C), dtype=np.float32)).to(dev, torch.bfloat16)
    _, K, R, t, _, _ = dtu_scene(0, n, cfg["h"], cfg["w"], cfg["f"])
    proj = feature_projections(K, R, t, dev)
    planes = [sk.mvsnet_planes(proj[:, i], proj[:, 0], (fh, fw))
              for i in range(1, n)]
    P = torch.stack([p for p, _ in planes], 1)
    Q = torch.stack([q for _, q in planes], 1)
    s = torch.linspace(*DEPTH_RANGE, NUM_DEPTH, device=dev)[None]
    return (feats[:, 0].contiguous(), feats[:, 1:].contiguous(), P, Q, s,
            K, R, t)


def fused_bound(ref, srcs, P, Q, s, out):
    """bound_ms, bound_by of one fused launch on these inputs."""
    _, nv, h, w, C = srcs.shape
    _, D, H, W, _ = out.shape
    n_live = sum(live_samples(P[:, v], Q[:, v], s, h, w) for v in range(nv))
    return bound(nbytes(ref, srcs, P, Q, s, out),
                 n_live * C * 8 + nv * D * H * W * 20
                 + D * H * W * C * (nv * 3 + 4)), n_live


def phase1_kernels(dev):
    """Each kernel vs its plain version at the headline shapes."""
    ref, srcs, P, Q, s, K, R, t = kernel_inputs(HEADLINE, dev)
    fh, fw, C = ref.shape[1:]
    s_dhw = (s[:, :, None, None] + 20.0 * torch.randn(
        (1, NUM_DEPTH, fh, fw), device=dev,
        generator=torch.Generator(dev).manual_seed(0))).contiguous()
    # a source camera moved 600 mm forward along the reference axis: the
    # hypotheses nearer than that lie behind it
    R_b, t_b = R.copy(), t.copy()
    R_b[1] = R[0]
    t_b[1] = t[0] - np.array([[0.0], [0.0], [600.0]], np.float32)
    proj_b = feature_projections(K, R_b, t_b, dev)
    P_b, Q_b = sk.mvsnet_planes(proj_b[:, 1], proj_b[:, 0], (fh, fw))
    temp = torch.full((1,), 0.05, device=dev)   # exp(-T * sum) stays > 0
    src = srcs[:, 0].contiguous()
    results = {}

    # --- sweep_warp --------------------------------------------------------
    warp_args = (src, P[:, 0].contiguous(), Q[:, 0].contiguous(), s)
    out = sk.sweep_warp(*warp_args)
    check(out.shape == (1, NUM_DEPTH, fh, fw, C), f"warp shape {out.shape}")
    err = compare("sweep_warp", out, sk.sweep_warp_plain(*warp_args))
    behind = (src, P_b, Q_b, s)
    got_b = sk.sweep_warp(*behind)
    compare("sweep_warp behind-camera rig", got_b,
            sk.sweep_warp_plain(*behind))
    # points well behind the source camera (z < -1 mm) read exact zeros
    rz = P_b[:, 2, None] * s[:, :, None, None] + Q_b[:, 2, None]
    behind_share = (rz < -1.0).float().mean().item()
    print(f"phase1 behind-camera share {behind_share:.3f}", flush=True)
    check(0.0 < behind_share < 1.0, f"behind share {behind_share}")
    check(bool((got_b[rz < -1.0] == 0).all()),
          "behind-camera samples are not zero")
    a = (src, warp_args[1], warp_args[2], s_dhw)
    compare("sweep_warp per-pixel hypotheses", sk.sweep_warp(*a),
            sk.sweep_warp_plain(*a))

    ms = cuda_ms(lambda: sk.sweep_warp(*warp_args), reps=50, warmup=5)
    plain_ms = cuda_ms(lambda: sk.sweep_warp_plain(*warp_args), reps=3,
                       warmup=1)
    # yardstick: torch's grid_sample over the same sampling grid
    r = (warp_args[1][:, :, None] * s[:, None, :, None, None]
         + warp_args[2][:, :, None])
    pos = r[:, 2] > 0
    z = torch.where(pos, r[:, 2], torch.ones_like(r[:, 2]))
    gx = torch.where(pos, r[:, 0] / z, -10.0) / ((fw - 1) / 2.0) - 1.0
    gy = torch.where(pos, r[:, 1] / z, -10.0) / ((fh - 1) / 2.0) - 1.0
    grid = torch.stack([gx, gy], -1).reshape(1, NUM_DEPTH * fh, fw, 2)
    src_nchw = src.permute(0, 3, 1, 2)
    grid = grid.to(torch.bfloat16).contiguous()
    library_ms = cuda_ms(lambda: F.grid_sample(
        src_nchw, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), reps=20, warmup=2)
    n_live = live_samples(*warp_args[1:], fh, fw)
    b_ms, b_by = bound(nbytes(*warp_args, out),
                       n_live * C * 8 + NUM_DEPTH * fh * fw * 20)
    results["sweep_warp"] = dict(
        name="sweep_warp", route="cuda",
        source="wildmvs_torch/csrc/sweep.cu",
        replaces="wildmvs/ops/mosaic_sweep.py:143",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=library_ms)
    print(f"phase1 sweep_warp: ms {ms:.4f} plain_ms {plain_ms:.3f} "
          f"library_ms {library_ms:.4f} (bf16 grid_sample) "
          f"bound_ms {b_ms:.4f} ({b_by}) live samples {n_live}",
          flush=True)

    # --- fused_cost_volume -------------------------------------------------
    fused_args = {}
    for agg in ("variance", "softmin"):
        for hyp_name, s_ in (("D", s), ("DHW", s_dhw)):
            a = (ref, srcs, P, Q, s_, temp, agg)
            compare(f"fused_cost_volume {agg} [{hyp_name}]",
                    sk.fused_cost_volume(*a), sk.fused_cost_volume_plain(*a))
            fused_args[(agg, hyp_name)] = a
    a_b = (ref, srcs, torch.stack([P_b, P[:, 1]], 1),
           torch.stack([Q_b, Q[:, 1]], 1), s, temp, "variance")
    compare("fused_cost_volume behind-camera rig", sk.fused_cost_volume(*a_b),
            sk.fused_cost_volume_plain(*a_b))
    a = fused_args[("variance", "D")]
    out = sk.fused_cost_volume(*a)
    err = compare("fused_cost_volume variance (timed)", out,
                  sk.fused_cost_volume_plain(*a))
    ms = cuda_ms(lambda: sk.fused_cost_volume(*a), reps=50, warmup=5)
    ms_softmin = cuda_ms(lambda: sk.fused_cost_volume(
        *fused_args[("softmin", "D")]), reps=50, warmup=5)
    plain_ms = cuda_ms(lambda: sk.fused_cost_volume_plain(*a), reps=3,
                       warmup=1)
    (b_ms, b_by), n_live = fused_bound(ref, srcs, P, Q, s, out)
    results["fused_cost_volume"] = dict(
        name="fused_cost_volume", route="cuda",
        source="wildmvs_torch/csrc/sweep.cu",
        replaces="wildmvs/ops/mosaic_sweep.py:811",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    print(f"phase1 fused_cost_volume: variance ms {ms:.4f} softmin ms "
          f"{ms_softmin:.4f} plain_ms {plain_ms:.3f} bound_ms {b_ms:.4f} "
          f"({b_by}) live samples {n_live} library_ms none (no single "
          f"torch call aggregates the views)", flush=True)
    return results


def sharpen(pred: Predictor) -> Predictor:
    with torch.no_grad():
        pred.model.cost_regularization.prob.weight.mul_(PROB_GAIN)
    return pred


def request_ms(pred, scene):
    t0 = time.perf_counter()
    out = pred(*scene)               # numpy results: the device is done
    return out, (time.perf_counter() - t0) * 1e3


def with_cost_volume(pred, scene):
    """(outputs, the cost volume the regularizer received) of one request."""
    seen = []
    hook = pred.model.cost_regularization.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].float()))
    try:
        out = pred(*scene)
    finally:
        hook.remove()
    return out, seen[0]


def agreement(name, out, cv, out_ref, cv_ref):
    """A kernel path against the exact gather path on the same request.

    Cost volume: the kernels take bf16 features and combine in f32, the
    gather combines bf16 corners with bf16 weights (the JAX semantics); the
    difference is bf16 rounding, held to the bounds tests/test_torch_mvsnet
    .py uses on the CPU: max 0.03 and mean 0.002 of the volume's scale.
    Depth: the x100 logit gain magnifies that rounding; held to a mean
    below 0.25 interval and 95% of pixels within one interval."""
    scale = cv_ref.abs().max().item()
    err = (cv - cv_ref).abs()
    interval = (DEPTH_RANGE[1] - DEPTH_RANGE[0]) / (NUM_DEPTH - 1)
    derr = np.abs(out["depth"] - out_ref["depth"]) / interval
    within = float((derr < 1.0).mean())
    print(f"phase2 {name} vs gather: cost volume max {err.max().item():.5g}"
          f" mean {err.mean().item():.5g} (scale {scale:.4g}); depth mean "
          f"{derr.mean():.4f} intervals, {within:.4f} within 1, max "
          f"{derr.max():.3f}", flush=True)
    check(err.max().item() <= 0.03 * scale
          and err.mean().item() <= 2e-3 * scale,
          f"{name} cost volume disagrees with the exact gather")
    check(derr.mean() < 0.25 and within > 0.95,
          f"{name} depth disagrees with the exact gather")


def profile_request(pred, scene):
    """Device time by kernel over one request (torch.profiler); only
    device-side events count, so no kernel is counted twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_ms = request_ms(pred, scene)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"phase2 profile: request {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.3f} of the request)",
          flush=True)
    for e in sorted(events, key=lambda e: -e.device_time_total)[:12]:
        print(f"phase2 profile: {e.device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<4d} {e.key[:100]}", flush=True)
    return dict(profiled_request_ms=wall_ms, device_busy_ms=busy_ms)


def phase2_serving():
    """The main path: Predictor requests through the kernels."""
    scenes = [dtu_scene(seed, **HEADLINE) for seed in (1, 2, 3)]
    pred = sharpen(Predictor(architecture="mvsnet"))
    pred_warp = sharpen(Predictor(architecture="mvsnet", sweep_method="warp"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    outs, times = [], []
    for sc in scenes:
        out, ms = request_ms(pred, sc)
        outs.append(out)
        times.append(ms)
    out_warp, warp_ms = request_ms(pred_warp, scenes[0])
    counts = sk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase2 launches {json.dumps(counts)}", flush=True)
    check(counts["fused_cost_volume"] >= 3 and counts["sweep_warp"] >= 2,
          f"the main path skipped a kernel: {counts}")
    for out in outs + [out_warp]:
        check(out["depth"].shape == (HEADLINE["h"] // 4, HEADLINE["w"] // 4)
              and np.isfinite(out["depth"]).all()
              and np.isfinite(out["confidence"]).all(), "bad output")
    steady = [request_ms(pred, scenes[i % 3])[1] for i in range(6)]
    steady_warp = [request_ms(pred_warp, scenes[i % 3])[1] for i in range(3)]
    print(f"phase2 serving 512x640 N3 D192 bf16 fused: ms per depthmap "
          f"{[round(t, 3) for t in times]} then {[round(t, 3) for t in steady]}"
          f" (median {np.median(steady):.3f}); warp {warp_ms:.3f} then "
          f"{[round(t, 3) for t in steady_warp]}; peak memory "
          f"{peak / 2**30:.3f} GiB; depth mean {outs[0]['depth'].mean():.2f}"
          f" std {outs[0]['depth'].std():.2f}, confidence mean "
          f"{outs[0]['confidence'].mean():.3f}", flush=True)

    pred_gather = sharpen(Predictor(architecture="mvsnet",
                                    sweep_method="gather"))
    out_g, cv_g = with_cost_volume(pred_gather, scenes[0])
    gather_ms = [request_ms(pred_gather, scenes[0])[1] for _ in range(2)]
    for name, p in (("fused", pred), ("warp", pred_warp)):
        agreement(name, *with_cost_volume(p, scenes[0]), out_g, cv_g)
    del cv_g
    prof = profile_request(pred, scenes[1])
    print(f"phase2 gather request ms {[round(t, 3) for t in gather_ms]}",
          flush=True)
    return pred, counts, dict(
        first_request_ms=times, request_ms_median=float(np.median(steady)),
        warp_request_ms_median=float(np.median(steady_warp)),
        gather_request_ms=gather_ms[-1], peak_gib=peak / 2 ** 30, **prof)


def phase3_eval(pred, dev):
    """The 1184x1600 N5 request, and the fused kernel at its shapes."""
    ref, srcs, P, Q, s, *_ = kernel_inputs(EVAL, dev)
    a = (ref, srcs, P, Q, s, None, "variance")
    out = sk.fused_cost_volume(*a)
    check(out.shape == (1, NUM_DEPTH, EVAL["h"] // 4, EVAL["w"] // 4, 32),
          f"eval volume shape {out.shape}")
    compare("fused_cost_volume variance at the eval shapes", out,
            sk.fused_cost_volume_plain(*a))
    del out
    kernel_ms = cuda_ms(lambda: sk.fused_cost_volume(*a), reps=10)
    (b_ms, b_by), _ = fused_bound(*a[:5], torch.empty(
        (1, NUM_DEPTH) + ref.shape[1:], dtype=torch.bfloat16, device=dev))
    print(f"phase3 fused_cost_volume 296x400 C32 D192 NV4: ms "
          f"{kernel_ms:.4f} bound_ms {b_ms:.4f} ({b_by})", flush=True)
    del a, ref, srcs, P, Q, s
    torch.cuda.empty_cache()

    scene = dtu_scene(4, **EVAL)
    n0 = sk.fused_cost_volume.launches
    torch.cuda.reset_peak_memory_stats()
    out, first_ms = request_ms(pred, scene)
    out, ms = request_ms(pred, scene)
    peak = torch.cuda.max_memory_allocated()
    check(sk.fused_cost_volume.launches == n0 + 2, "eval skipped the kernel")
    check(out["depth"].shape == (EVAL["h"] // 4, EVAL["w"] // 4)
          and np.isfinite(out["depth"]).all()
          and np.isfinite(out["confidence"]).all(), "bad eval output")
    print(f"phase3 eval 1184x1600 N5 D192 bf16 fused: ms per depthmap "
          f"{ms:.3f} (first {first_ms:.3f}), peak memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    return dict(eval_ms=ms, eval_peak_gib=peak / 2 ** 30,
                eval_kernel_ms=kernel_ms, eval_kernel_bound_ms=b_ms)


def phase4_depthmaps(pred):
    samples = []
    for i in range(2):
        imgs, K, R, t, dmin, dmax = dtu_scene(10 + i, **HEADLINE)
        samples.append(dict(imgs=imgs, K=K, R=R, t=t, depth_min=dmin,
                            depth_max=dmax, filename=f"scan1/{i:08d}"))
    with tempfile.TemporaryDirectory() as tmp:
        run_depthmaps(samples, pred.model, tmp)
        files = sorted(p.name for p in Path(tmp).iterdir())
        check(files == ["finished.txt", "scan1_00000000_out.npz",
                        "scan1_00000001_out.npz"], f"files {files}")
        for f in files[1:]:
            with np.load(Path(tmp) / f) as z:
                check(sorted(z.files) == ["depthmap", "probability"]
                      and np.isfinite(z["depthmap"]).all(), f"bad {f}")
    print(f"phase4 run_depthmaps: {files}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    # f32 comparisons run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.load()
    print(f"built {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_log().splitlines():
        if re.search(r"registers|spill|Compiling entry", line):
            print(f"ptxas: {line.strip()}", flush=True)

    kernels = phase1_kernels(dev)
    pred, counts, serving = phase2_serving()
    evals = phase3_eval(pred, dev)
    phase4_depthmaps(pred)

    for name, k in kernels.items():
        k["launches"] = counts[name]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: v[k] for k in keys}
                                  for v in kernels.values()],
                      "serving": serving, "eval": evals, "card": card}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
