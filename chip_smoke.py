#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (wildmvs_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (the kernels are built from
wildmvs_torch/csrc/ on first use); fails without them. Imports nothing of
JAX or of the JAX package. Phases, each of which stops the run if it fails:

  1. kernel vs plain: each Hopper kernel against its plain PyTorch version
     at the 512x640 headline shapes (128x160 features, C=32, D=192, NV=2):
     fronto-parallel and per-pixel hypotheses, variance and softmin, and a
     rig partly behind the source camera. Times the kernel (CUDA events
     around replays of a CUDA graph of its launches, and around a plain
     loop of launches), the plain version and, for the warp, torch's
     grid_sample over the same grid.
  2. serving (the main path): Predictor("mvsnet", bf16) at 512x640, N=3,
     D=192 answers 3 requests (seeded DTU-like scenes) through the fused
     kernel, then one through the per-view warp kernel; the launch counts
     must move, the outputs be finite and the depth agree with the exact
     gather path.
  3. eval: one 1184x1600, N=5, D=192 request through the fused kernel.
  4. run_depthmaps over 2 in-memory samples into a temporary directory.
  5. training (the second path): 6 supervised steps of MVSNet at 512x640,
     N=3, D=192, bf16 compute with f32 parameters, on one synthetic batch
     through sweep_method "auto": the warp kernel forward and the
     sweep_warp_backward kernel backward, 2 launches each per step, no
     fused launch. Finite losses and gradients, the last loss below the
     first, the first step's feature gradients against the exact gather
     path's autograd, then an eval step, a test step, and a checkpoint
     served by Predictor.
  6. Vis-MVSNet serving (the third path): Predictor with the trained asset
     assets/vis_synth_trained.npz at 1184x1600, N=5, depth_nums (64, 32,
     16), bf16, on the bench scene (a textured plane rendered into the
     DTU-like rig): 12 sweep_gwc launches per request (3 stages x 4 pairs)
     and nothing else of the kernels; finite outputs; each stage held to
     the exact gather on that stage's own inputs (cost volumes within bf16
     rounding, stage-3 depth within one hypothesis interval); a request
     with random weights; run_depthmaps over 2 samples.
  7. Vis-MVSNet training (the fourth path): 6 supervised bf16 steps at
     512x640, N=3, depth_nums (32, 16, 8): 6 sweep_warp (Vis convention)
     and 6 sweep_warp_backward launches per step, no gwc or fused launch;
     finite losses and gradients, the last loss below the first; the first
     step's feature gradients against the exact gather's autograd; an eval
     and a test step (gwc launches) and a checkpoint served by Predictor.

Phase 1 also holds sweep_warp_backward to its plain version ([D], [D,H,W]
and the behind-camera rig) and times it against torch's
grid_sampler_2d_backward, beside its own count of its 16-byte atomics
into device memory (held to a plain model of its flushes) and the first
design's (a plain model, backward_atomics); and holds the Vis-convention
kernels (sweep_gwc, sweep_warp and sweep_warp_backward with the
coordinate scale and clamp) to their plain versions at the Vis eval's
stage shapes (gwc) and the Vis training's (warp and backward), on a
source under 21 px and on a rig partly behind the source camera, and
times them there. Every kernel works on 8x8 tiles over runs of
hypotheses (csrc/footprint.cuh), so each is also held to its plain
version on a ragged shape (RAGGED: a reference grid no multiple of the
tile, D no multiple of the run) and on a grazing rig, whose launch of a
forward kernel mixes stages staged in shared memory with stages that use
device memory; the warp and its backward also at every other channel
count they take (CHANNELS, a kernel body each) in both conventions, and
sweep_gwc at those it takes; the fused kernel also at 6, 8 and 16 source
views (FUSED_VIEWS), where its stage buffers shrink or vanish to keep
the block's shared memory in bounds; at each timed shape a forward
kernel's own count of staged stages is printed beside the share that the
plain rule (sweep_footprints) predicts. Phase 3 times the fused kernel at
the eval shapes by CUDA-graph replay too.

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
from wildmvs_torch.data.synthetic import (SyntheticMVSDataset, collate,
                                          render_rig_plane)
from wildmvs_torch.geometry.projective import build_proj_matrices, scale_K
from wildmvs_torch.infer import Predictor
from wildmvs_torch.models import mvsnet as mvsnet_module
from wildmvs_torch.models import vis_mvsnet as vis_module
from wildmvs_torch.ops import sweep_kernels as sk
from wildmvs_torch.ops.plane_sweep import (homography_sweep_warp,
                                           plane_sweep_warp)
from wildmvs_torch.ops.volumes import groupwise_correlation
from wildmvs_torch.pipeline.depthmaps import run_depthmaps
from wildmvs_torch.train import trainer as T
from wildmvs_torch.train.checkpoint import save_checkpoint
from wildmvs_torch.train.config import TrainConfig

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
TRAIN_STEPS = 6
VIS_ASSET = Path(__file__).resolve().parent / "assets" / \
    "vis_synth_trained.npz"
# the bench scene of the trained Vis network (bench.py:215-233)
VIS_PLANE = dict(plane=(-30.0, 0.12, -0.08), extent=320.0, seed=0)
VIS_EVAL_DEPTHS = (64, 32, 16)
VIS_EVAL_SCALES = (2.0, 1.0, 0.5)
VIS_STAGE_SCALE = (8, 4, 2)
# degrees: the source view of the grazing rig (phase 1)
GRAZING_AZIMUTH = 60.0
# the ragged case of phase 1: a reference grid that is no multiple of the
# footprint kernels' 8x8 tile, and D no multiple of their run
RAGGED = (100, 150, 37)
# source views of the extra fused cases of phase 1 at the headline's
# feature shape: 6 shares the block's shared memory among smaller stage
# buffers, 8 and 16 read every sample from device memory
FUSED_VIEWS = (6, 8, 16)
# channel counts of phase 1's channel cases, besides the C = 32 of the
# others: each is a kernel body of its own (sweep_warp and
# sweep_warp_backward take 8-256 in both conventions, sweep_gwc 8-64)
CHANNELS = (8, 16, 64, 128, 256)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def camera_on_sphere(az: float, el: float):
    """(R [3, 3], t [3, 1]) f32 of a camera on the 650 mm sphere at
    azimuth az and elevation el (radians), looking at the origin."""
    up = np.array([0.0, -1.0, 0.0])
    d = np.array([np.sin(az) * np.cos(el), np.sin(el),
                  -np.cos(az) * np.cos(el)])
    eye = -650.0 * d
    z = -eye / np.linalg.norm(eye)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z]).astype(np.float32)
    return R, (-R @ eye).astype(np.float32).reshape(3, 1)


def grazing(R, t, v: int = 1):
    """The rig with view v moved to GRAZING_AZIMUTH: it sees the sweep's
    fronto-parallel planes obliquely, so that some tiles' footprints pass
    the shared-memory budget while the rest are staged."""
    R, t = R.copy(), t.copy()
    R[v], t[v] = camera_on_sphere(np.deg2rad(GRAZING_AZIMUTH), 0.0)
    return R, t


def dtu_scene(seed: int, n: int, h: int, w: int, f: float):
    """A DTU-like rig: cameras on a 650 mm sphere in ~6 degree steps
    looking at the origin, random images; (imgs [N, H, W, 3], K, R, t,
    depth_min [N], depth_max [N]) as numpy f32."""
    rng = np.random.default_rng(seed)
    imgs = rng.random((n, h, w, 3), dtype=np.float32)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    Rs, ts = [], []
    for i in range(n):
        R, t = camera_on_sphere(np.deg2rad(6.0) * ((i + 1) // 2) * (-1) ** i,
                                np.deg2rad(3.0) * (i % 3 - 1))
        Rs.append(R)
        ts.append(t)
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


def graph_ms(fn, reps: int = 50) -> float:
    """Mean device time in ms of one fn() call: CUDA events around replays
    of a CUDA graph that holds `reps` calls, so the kernels run back to
    back, without the gaps of their Python launches (which set the pace of
    an event-timed loop of kernels shorter than their launch)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def timed(fn):
    """(graph-replayed ms, event-timed loop ms) of a kernel's wrapper call
    (the wrapper's own small kernels, such as the backward's zero fill and
    cast, included)."""
    return graph_ms(fn), cuda_ms(fn, reps=50, warmup=5)


def live_samples(P, Q, s, h, w, scale=sk.UNIT_SCALE, clamp=None) -> int:
    """Bilinear samples that read the source (the data-dependent work), in
    the sweep's convention."""
    x, y = sk.source_coords(*sk._project(P, Q, s), scale, clamp)
    x0, y0 = torch.floor(x), torch.floor(y)
    live = (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
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


def tile_shares(launch, P, Q, s, src_hw, plan, scale=sk.UNIT_SCALE,
                clamp=None):
    """The staged share of one launch of a forward footprint kernel as the
    kernel counts it on the card (staged / all stages of a tile, view and
    run), beside the plain rule's (sk.sweep_footprints) for the same
    planes, hypotheses and plan (tile_h, cells_max: sk.fused_plan or
    sk.footprint_plan). Returns (kernel share, plain share, (staged,
    global))."""
    with sk.counting_tiles(P.device) as counter:
        launch()
        torch.cuda.synchronize()
        staged, glob, _ = counter.tolist()
    tile_h, cells_max = plan
    plain, _ = sk.sweep_footprints(P, Q, s, (tile_h, sk.FOOTPRINT_TILE_W),
                                   src_hw, scale, clamp, sk.FOOTPRINT_D_RUN,
                                   cells_max)
    return (staged / max(staged + glob, 1), plain.float().mean().item(),
            (staged, glob))


def warp_share(src, P, Q, s, scale=sk.UNIT_SCALE, clamp=None):
    """tile_shares of one sweep_warp launch under the warp's plan."""
    return tile_shares(lambda: sk.sweep_warp(src, P, Q, s, scale, clamp),
                       P, Q, s, tuple(src.shape[1:3]),
                       sk.footprint_plan(src.shape[-1]), scale, clamp)


def share_text(share) -> str:
    return f"staged share {share[0]:.4f} (plain rule {share[1]:.4f})"


def compare_backward(g, P, Q, s, src_hw, case, scale=sk.UNIT_SCALE,
                     clamp=None):
    """sweep_warp_backward against its plain version: the f32 accumulation
    within 1e-4 of the plain result's scale (the atomics add in an order
    that changes from run to run; f32 sums of at most a few hundred terms
    per element stay far below that), and the bf16 result within one bf16
    ulp (2^-7) of the scale. Returns (f32 error, bf16 error)."""
    want = sk.sweep_warp_backward_plain(g, P, Q, s, src_hw, scale, clamp)
    got32 = sk.sweep_warp_backward(g, P, Q, s, src_hw, torch.float32,
                                   scale=scale, clamp=clamp)
    got16 = sk.sweep_warp_backward(g, P, Q, s, src_hw, scale=scale,
                                   clamp=clamp)
    torch.cuda.synchronize()
    scale = max(want.abs().max().item(), 1e-6)
    err32 = (got32 - want).abs().max().item()
    err16 = (got16.float() - want).abs().max().item()
    print(f"phase1 sweep_warp_backward {case}: f32 max_abs_err {err32:.6g} "
          f"limit {1e-4 * scale:.6g}; bf16 max_abs_err {err16:.6g} limit "
          f"{2 ** -7 * scale:.6g} (scale {scale:.4g})", flush=True)
    check(err32 <= 1e-4 * scale, f"sweep_warp_backward {case}: f32 "
          f"accumulation vs plain {err32} > {1e-4 * scale}")
    check(err16 <= 2 ** -7 * scale, f"sweep_warp_backward {case}: bf16 "
          f"result vs plain {err16} > {2 ** -7 * scale}")
    return err32, err16


#: hypotheses of a thread's run in the first sweep_warp_backward design
#: (one thread per pixel and 8 channels, every flush into device memory)
FIRST_BACKWARD_RUN = 16


def thread_flushes(x0, y0, live, src_hw, d_run, shift):
    """[D, H, W] long: the corners inside the image that a thread walking
    its pixel's runs of d_run hypotheses adds out of its registers at each
    sample (x0, y0, live: [D, H, W] top-left corners and liveness). A
    thread sums its sample's four corners while the sample stays in one
    source cell; when a live sample lands in another cell it adds the old
    cell's corners (with `shift`, all but the two that a move of one cell
    shares with the new one, which it keeps), and after its run's last
    live sample it adds that cell's four."""
    h, w = src_hw
    out = torch.zeros_like(x0)
    for d0 in range(0, x0.shape[0], d_run):
        xs, ys, lv = x0[d0:d0 + d_run], y0[d0:d0 + d_run], live[d0:d0 + d_run]
        idx = torch.where(lv, torch.arange(
            xs.shape[0], device=xs.device)[:, None, None], -1)
        last = torch.cummax(idx, 0).values     # last live sample so far
        prev = last[:-1].clamp_min(0)
        xp, yp = torch.gather(xs, 0, prev), torch.gather(ys, 0, prev)
        moved = lv[1:] & (last[:-1] >= 0) & ((xs[1:] != xp) | (ys[1:] != yp))
        mx, my = xs[1:] - xp, ys[1:] - yp
        one = (mx.abs() + my.abs() == 1) if shift else torch.zeros_like(moved)
        end = idx == last[-1:]                 # the run's last live sample
        for k in range(4):
            kx, ky = k % 2, k // 2
            kept = one & (kx - mx >= 0) & (kx - mx <= 1) & (ky - my >= 0) \
                & (ky - my <= 1)
            xi, yi = xp + kx, yp + ky
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            out[d0 + 1:d0 + d_run] += (moved & ~kept & inside).long()
            xi, yi = xs + kx, ys + ky
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            out[d0:d0 + d_run] += (end & lv & inside).long()
    return out


def backward_atomics(P, Q, s, src_hw, C, scale=sk.UNIT_SCALE, clamp=None):
    """A plain model of the 16-byte atomics into device memory of one
    sweep_warp_backward launch on these inputs (B = 1), two a corner and
    8-channel slice (`thread_flushes`): (this design's, which keeps the
    corners that a move of one cell shares over runs of
    sk.FOOTPRINT_D_RUN; the first design's, which added all four at every
    move over runs of FIRST_BACKWARD_RUN)."""
    h, w = src_hw
    x, y = sk.source_coords(*sk._project(P, Q, s), scale, clamp)
    x0, y0 = torch.floor(x[0]).long(), torch.floor(y[0]).long()  # [D, H, W]
    live = (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
    return tuple(2 * (C // 8) * int(thread_flushes(
        x0, y0, live, src_hw, run, shift).sum()) for run, shift in (
            (sk.FOOTPRINT_D_RUN, True), (FIRST_BACKWARD_RUN, False)))


def counted_atomics(case, g, P, Q, s, src_hw, scale=sk.UNIT_SCALE,
                    clamp=None) -> int:
    """The 16-byte atomics into device memory of one sweep_warp_backward
    launch as the kernel counts them on the card (sk.counting_tiles), held
    within 1 % of the plain model of its flushes (backward_atomics: a
    coordinate within rounding of a cell's edge may floor the other way)
    and printed beside the first design's plain count."""
    with sk.counting_tiles(P.device) as counter:
        sk.sweep_warp_backward(g, P, Q, s, src_hw, scale=scale, clamp=clamp)
        torch.cuda.synchronize()
        n = int(counter[2])
    model, first = backward_atomics(P, Q, s, src_hw, g.shape[-1], scale,
                                    clamp)
    print(f"phase1 sweep_warp_backward {case}: 16-byte f32 atomics into "
          f"device memory {n} (the kernel's count; plain model {model}); "
          f"the first design's {first} (plain model)", flush=True)
    check(abs(n - model) <= 0.01 * model, f"sweep_warp_backward {case}: "
          f"the kernel counted {n} atomics, its plain model {model}")
    return n


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

    # --- sweep_warp and sweep_warp_backward ---------------------------------
    warp_args = (src, P[:, 0].contiguous(), Q[:, 0].contiguous(), s)
    g = torch.randn((1, NUM_DEPTH, fh, fw, C), device=dev,
                    generator=torch.Generator(dev).manual_seed(1)).to(
        torch.bfloat16)
    out = sk.sweep_warp(*warp_args)
    check(out.shape == (1, NUM_DEPTH, fh, fw, C), f"warp shape {out.shape}")
    behind = (src, P_b, Q_b, s)
    got_b = sk.sweep_warp(*behind)
    # points well behind the source camera (z < -1 mm) read exact zeros
    rz = P_b[:, 2, None] * s[:, :, None, None] + Q_b[:, 2, None]
    behind_share = (rz < -1.0).float().mean().item()
    print(f"phase1 behind-camera share {behind_share:.3f}", flush=True)
    check(0.0 < behind_share < 1.0, f"behind share {behind_share}")
    check(bool((got_b[rz < -1.0] == 0).all()),
          "behind-camera samples are not zero")
    rh, rw, rd = RAGGED
    proj_g = feature_projections(K, *grazing(R, t), dev)
    P_g, Q_g = sk.mvsnet_planes(proj_g[:, 1], proj_g[:, 0], (fh, fw))
    sweeps = {"[D]": warp_args[1:], "[D,H,W]": (*warp_args[1:3], s_dhw),
              "behind-camera rig": behind[1:],
              f"ragged {rh}x{rw} D{rd}": (
                  warp_args[1][..., :rh, :rw].contiguous(),
                  warp_args[2][..., :rh, :rw].contiguous(),
                  s[:, :rd].contiguous()),
              "grazing rig": (P_g, Q_g, s)}
    errs = {}
    for case, (P_, Q_, s_) in sweeps.items():
        g_ = g[:, :s_.shape[1], :P_.shape[2], :P_.shape[3]].contiguous()
        extra = ""
        if case == "grazing rig":
            share = warp_share(src, P_, Q_, s_)
            n_st, n_gl = share[2]
            check(n_st > 0 and n_gl > 0, f"sweep_warp: the grazing rig's "
                  f"launch did not mix staged and global stages: {n_st} "
                  f"and {n_gl}")
            extra = f"; staged {n_st} global {n_gl}: {share_text(share)}"
        errs[case] = (
            compare(f"sweep_warp {case}", sk.sweep_warp(src, P_, Q_, s_),
                    sk.sweep_warp_plain(src, P_, Q_, s_), extra),
            compare_backward(g_, P_, Q_, s_, (fh, fw), case)[0])

    ms, events_ms = timed(lambda: sk.sweep_warp(*warp_args))
    plain_ms = cuda_ms(lambda: sk.sweep_warp_plain(*warp_args), reps=3,
                       warmup=1)
    share = warp_share(*warp_args)
    # yardstick: torch's grid_sample over the same sampling grid
    grid = vis_grid(*warp_args[1:], sk.UNIT_SCALE, None, fh, fw)
    src_nchw = src.permute(0, 3, 1, 2)
    library_ms = cuda_ms(lambda: F.grid_sample(
        src_nchw, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), reps=20, warmup=2)
    n_live = live_samples(*warp_args[1:], fh, fw)
    b_ms, b_by = bound(nbytes(*warp_args, out),
                       n_live * C * 8 + NUM_DEPTH * fh * fw * 20)
    results["sweep_warp"] = dict(
        name="sweep_warp", route="cuda",
        source="wildmvs_torch/csrc/warp.cu",
        replaces="wildmvs/ops/mosaic_sweep.py:143",
        max_abs_err=errs["[D]"][0], ms=ms, events_ms=events_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms, staged_share=share[0])
    print(f"phase1 sweep_warp: ms {ms:.4f} (events {events_ms:.4f}) "
          f"plain_ms {plain_ms:.3f} "
          f"library_ms {library_ms:.4f} (bf16 grid_sample) "
          f"bound_ms {b_ms:.4f} ({b_by}) live samples {n_live}; "
          f"{share_text(share)}", flush=True)

    bwd = (g, *warp_args[1:], (fh, fw))
    ms, events_ms = timed(lambda: sk.sweep_warp_backward(*bwd))
    plain_ms = cuda_ms(lambda: sk.sweep_warp_backward_plain(*bwd), reps=3,
                       warmup=1)
    # yardstick: the input gradient of grid_sample over the same grid and
    # cotangent (bf16, NCHW views of the channels-last tensors)
    g_nchw = g.reshape(1, NUM_DEPTH * fh, fw, C).permute(0, 3, 1, 2)
    library_ms = cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        g_nchw, src_nchw, grid, 0, 0, True, [True, False]), reps=20,
        warmup=2)
    atomics = counted_atomics("[D]", *bwd)
    df_bytes = fh * fw * C * 4
    b_ms, b_by = bound(nbytes(g, *warp_args[1:]) + df_bytes,
                       n_live * C * 8 + NUM_DEPTH * fh * fw * 20)
    results["sweep_warp_backward"] = dict(
        name="sweep_warp_backward", route="cuda",
        source="wildmvs_torch/csrc/sweep.cu",
        replaces="wildmvs/ops/mosaic_sweep.py:1930",
        max_abs_err=errs["[D]"][1], ms=ms, events_ms=events_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms, device_atomics=atomics)
    print(f"phase1 sweep_warp_backward: ms {ms:.4f} (events "
          f"{events_ms:.4f}) plain_ms {plain_ms:.3f}"
          f" library_ms {library_ms:.4f} (bf16 grid_sampler_2d_backward) "
          f"bound_ms {b_ms:.4f} ({b_by})", flush=True)

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
    for agg in ("variance", "softmin"):
        a_r = (ref[:, :rh, :rw].contiguous(), srcs,
               P[..., :rh, :rw].contiguous(), Q[..., :rh, :rw].contiguous(),
               s[:, :rd].contiguous(), temp, agg)
        compare(f"fused_cost_volume ragged {rh}x{rw} D{rd} {agg}",
                sk.fused_cost_volume(*a_r), sk.fused_cost_volume_plain(*a_r))
    a_g = (ref, srcs, torch.stack([P_g, P[:, 1]], 1),
           torch.stack([Q_g, Q[:, 1]], 1), s, temp, "variance")
    share, plain_share, (n_st, n_gl) = tile_shares(
        lambda: sk.fused_cost_volume(*a_g), a_g[2], a_g[3], s, (fh, fw),
        sk.fused_plan(C, 2))
    check(n_st > 0 and n_gl > 0, f"the grazing rig's launch did not mix "
          f"staged and global stages: {n_st} and {n_gl}")
    compare("fused_cost_volume grazing rig", sk.fused_cost_volume(*a_g),
            sk.fused_cost_volume_plain(*a_g),
            f" staged {n_st} global {n_gl}: share {share:.4f} (plain rule "
            f"{plain_share:.4f})")
    a = fused_args[("variance", "D")]
    out = sk.fused_cost_volume(*a)
    err = compare("fused_cost_volume variance (timed)", out,
                  sk.fused_cost_volume_plain(*a))
    ms, events_ms = timed(lambda: sk.fused_cost_volume(*a))
    ms_softmin = cuda_ms(lambda: sk.fused_cost_volume(
        *fused_args[("softmin", "D")]), reps=50, warmup=5)
    plain_ms = cuda_ms(lambda: sk.fused_cost_volume_plain(*a), reps=3,
                       warmup=1)
    (b_ms, b_by), n_live = fused_bound(ref, srcs, P, Q, s, out)
    share, plain_share, _ = tile_shares(
        lambda: sk.fused_cost_volume(*a), P, Q, s, (fh, fw),
        sk.fused_plan(C, P.shape[1]))
    results["fused_cost_volume"] = dict(
        name="fused_cost_volume", route="cuda",
        source="wildmvs_torch/csrc/sweep.cu",
        replaces="wildmvs/ops/mosaic_sweep.py:811",
        max_abs_err=err, ms=ms, events_ms=events_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, staged_share=share,
        softmin_ms=ms_softmin)
    print(f"phase1 fused_cost_volume: variance ms {ms:.4f} (events "
          f"{events_ms:.4f}) softmin ms "
          f"{ms_softmin:.4f} plain_ms {plain_ms:.3f} bound_ms {b_ms:.4f} "
          f"({b_by}) live samples {n_live} library_ms none (no single "
          f"torch call aggregates the views); staged share {share:.4f} "
          f"(plain rule {plain_share:.4f})", flush=True)

    # --- fused_cost_volume over more source views (the DTU-like rig grown
    # by 6-degree steps), each launch's plan from sk.fused_plan
    views = {}
    for nv in FUSED_VIEWS:
        ref_v, srcs_v, P_v, Q_v, *_ = kernel_inputs(dict(HEADLINE, n=nv + 1),
                                                    dev)
        a_v = (ref_v, srcs_v, P_v, Q_v, s, temp, "variance")
        plan = sk.fused_plan(C, nv)
        share, plain_share, _ = tile_shares(
            lambda: sk.fused_cost_volume(*a_v), P_v, Q_v, s, (fh, fw), plan)
        out = sk.fused_cost_volume(*a_v)
        err = compare(f"fused_cost_volume NV={nv}", out,
                      sk.fused_cost_volume_plain(*a_v))
        ms = graph_ms(lambda: sk.fused_cost_volume(*a_v))
        (b_ms, b_by), _ = fused_bound(*a_v[:5], out)
        views[str(nv)] = dict(max_abs_err=err, ms=ms, bound_ms=b_ms,
                              bound_by=b_by, cells_max=plan[1],
                              staged_share=share)
        print(f"phase1 fused_cost_volume NV={nv}: ms {ms:.4f} bound_ms "
              f"{b_ms:.4f} ({b_by}); one stage buffer of {plan[1]} cells "
              f"for the {nv} views, staged share {share:.4f} (plain rule "
              f"{plain_share:.4f})", flush=True)
        del ref_v, srcs_v, P_v, Q_v, a_v, out
    results["fused_cost_volume"]["views"] = views
    return results


def phase1_channels(dev):
    """sweep_warp and sweep_warp_backward at each channel count of CHANNELS
    on the ragged crop (RAGGED) of the headline rig ([D], MVSNet
    convention) and on that crop of Vis training stage 2 (a slab of
    per-pixel hypotheses, Vis convention), and sweep_gwc on the Vis crop at
    the channel counts it takes, each held to its plain version."""
    rh, rw, rd = RAGGED
    tr = dict(n=3, h=HEADLINE["h"], w=HEADLINE["w"], f=HEADLINE["f"])
    for c in CHANNELS:
        _, srcs, P, Q, s, *_ = kernel_inputs(HEADLINE, dev, C=c)
        src, ref, P_v, Q_v, s_v, scale, clamp = vis_kernel_inputs(
            dev, tr, 2, rd, True, C=c)
        ref = ref[:, :rh, :rw].contiguous()
        crop = (lambda t: t[..., :rh, :rw].contiguous())
        sweeps = {"MVSNet": (srcs[:, 0].contiguous(), crop(P[:, 0]),
                             crop(Q[:, 0]), s[:, :rd].contiguous(),
                             sk.UNIT_SCALE, None),
                  "Vis": (src, crop(P_v), crop(Q_v), crop(s_v), scale,
                          clamp)}
        for conv, (src_, P_, Q_, s_, scale_, clamp_) in sweeps.items():
            case = f"{conv} ragged {rh}x{rw} D{rd} C{c}"
            compare(f"sweep_warp {case}",
                    sk.sweep_warp(src_, P_, Q_, s_, scale_, clamp_),
                    sk.sweep_warp_plain(src_, P_, Q_, s_, scale_, clamp_))
            g = torch.randn((1, rd, rh, rw, c), device=dev,
                            generator=torch.Generator(dev).manual_seed(4)).to(
                torch.bfloat16)
            compare_backward(g, P_, Q_, s_, tuple(src_.shape[1:3]), case,
                             scale_, clamp_)
            if conv == "Vis" and c <= 64:
                vis = (P_, Q_, s_, scale_, clamp_)
                compare(f"sweep_gwc {case}", sk.sweep_gwc(src_, ref, *vis),
                        sk.sweep_gwc_plain(src_, ref, *vis))
        del srcs, P, Q, s, src, ref, sweeps
    torch.cuda.empty_cache()


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


def profile_step(fn, phase):
    """Device time by operation over one call of fn (torch.profiler),
    host clock to the device's end; only device-side events count, so no
    kernel is counted twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"{phase} profile: {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / wall_ms:.3f})", flush=True)
    for e in sorted(events, key=lambda e: -e.device_time_total)[:15]:
        print(f"{phase} profile: {e.device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<4d} {e.key[:100]}", flush=True)
    return dict(profiled_ms=wall_ms, device_busy_ms=busy_ms)


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
    prof = profile_step(lambda: pred(*scenes[1]), "phase2")
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
    kernel_ms = graph_ms(lambda: sk.fused_cost_volume(*a), reps=10)
    share, plain_share, _ = tile_shares(
        lambda: sk.fused_cost_volume(*a), P, Q, s, tuple(srcs.shape[2:4]),
        sk.fused_plan(ref.shape[-1], P.shape[1]))
    (b_ms, b_by), _ = fused_bound(*a[:5], torch.empty(
        (1, NUM_DEPTH) + ref.shape[1:], dtype=torch.bfloat16, device=dev))
    print(f"phase3 fused_cost_volume 296x400 C32 D192 NV4: ms "
          f"{kernel_ms:.4f} (CUDA-graph replay) bound_ms {b_ms:.4f} ({b_by})"
          f"; staged share {share:.4f} (plain rule {plain_share:.4f})",
          flush=True)
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
                eval_kernel_ms=kernel_ms, eval_kernel_bound_ms=b_ms,
                eval_kernel_staged_share=share)


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


def record_warps(rec: list):
    """Patch the model's sweep_warp so that, while `rec` is not None, each
    call keeps its inputs, the gradient of its output (g) and the gradient
    of its source features (df: the source features feed nothing but the
    warp, so that is what sweep_warp_backward returned). Returns the undo."""
    real = mvsnet_module.sweep_warp

    def recording(src, P, Q, s):
        out = real(src, P, Q, s)
        entry = {"src": src.detach(), "P": P, "Q": Q, "s": s}
        out.register_hook(lambda g: entry.__setitem__("g", g))
        src.register_hook(lambda df: entry.__setitem__("df", df))
        rec.append(entry)
        return out

    mvsnet_module.sweep_warp = recording
    return lambda: setattr(mvsnet_module, "sweep_warp", real)


def warp_gradient_agreement(rec, batch, model):
    """The kernel path's source-feature gradients against the exact gather
    path's autograd (plane_sweep_warp in f32) at the same cotangent.

    The kernel takes the bf16 cotangent, accumulates in f32 with atomics
    and rounds once to bf16; the gather transposes in f32. Held to one
    bf16 ulp (2^-7) of the gradient's scale in max and 2^-9 in mean."""
    D = model.num_depth
    proj = build_proj_matrices(scale_K(batch["K"], 0.25), batch["R"],
                               batch["t"])
    steps = torch.arange(D, dtype=torch.float32, device=proj.device)
    dmin, dmax = batch["depth_min"][:, 0], batch["depth_max"][:, 0]
    ref_depths = dmin[:, None] + ((dmax - dmin) / (D - 1))[:, None] * steps
    worst = 0.0
    for view, e in zip((1, 2), rec):
        src = e["src"].float().requires_grad_()
        fh, fw = src.shape[1:3]
        warped = plane_sweep_warp(src, proj[:, view], proj[:, 0],
                                  ref_depths, (fh, fw))
        (want,) = torch.autograd.grad(warped, src, e["g"].float())
        err = (e["df"].float() - want).abs()
        scale = want.abs().max().item()
        print(f"phase5 feature gradient view {view}: kernel vs gather max "
              f"{err.max().item():.6g} mean {err.mean().item():.6g} (scale "
              f"{scale:.4g}, limits {2 ** -7 * scale:.4g} and "
              f"{2 ** -9 * scale:.4g})", flush=True)
        check(scale > 0, "zero feature gradient")
        check(err.max().item() <= 2 ** -7 * scale
              and err.mean().item() <= 2 ** -9 * scale,
              f"view {view}: kernel feature gradient disagrees with the "
              f"gather path's")
        worst = max(worst, err.max().item())
    return worst


def phase5_training(dev):
    """The training path: TRAIN_STEPS supervised bf16 steps of MVSNet at
    512x640, N=3, D=192 through sweep_method "auto" (the warp kernel and
    its backward) on one fixed synthetic batch, an eval and a test step, a
    checkpoint, and a Predictor that serves it."""
    cfg = TrainConfig(architecture="mvsnet", dataset="synthetic",
                      num_depth=NUM_DEPTH, lr=1e-3, train_dtype="bfloat16")
    ds = SyntheticMVSDataset(num_samples=1, num_views=HEADLINE["n"],
                             height=HEADLINE["h"], width=HEADLINE["w"])
    sample = collate([ds[0]])
    batch = T.batch_to_device(sample, dev)
    state = T.create_train_state(cfg, dev)
    params = list(state.model.parameters())
    check(all(p.dtype == torch.float32 for p in params),
          "training parameters are not f32")
    rec = []
    undo = record_warps(rec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = T.train_step(state, batch, cfg)
        grads_finite = torch.stack([torch.isfinite(p.grad).all()
                                    for p in params]).all()
        losses.append(m["train_loss"].item())
        times.append((time.perf_counter() - t0) * 1e3)
        check(bool(grads_finite), f"step {i}: a gradient is not finite")
        if i == 0:
            undo()
            first_conv = state.model.feature.conv0.conv.weight.grad
            check(first_conv.abs().max().item() > 0,
                  "FeatureNet's first conv got no gradient")
    counts = sk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase5 launches {json.dumps(counts)}", flush=True)
    check(counts["sweep_warp"] == 2 * TRAIN_STEPS
          and counts["sweep_warp_backward"] == 2 * TRAIN_STEPS
          and counts["fused_cost_volume"] == 0,
          f"training did not take the warp kernels: {counts}")
    check(len(rec) == 2 and all("df" in e and "g" in e for e in rec),
          "the first step's warps were not recorded")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"losses {losses}")
    steady = float(np.median(times[1:]))
    print(f"phase5 training 512x640 N3 D192 bf16 (f32 parameters): losses "
          f"{[round(x, 4) for x in losses]}; ms per step first "
          f"{times[0]:.3f} then {[round(t, 3) for t in times[1:]]} (median "
          f"{steady:.3f}); peak memory {peak / 2**30:.3f} GiB", flush=True)
    grad_err = warp_gradient_agreement(rec, batch, state.model)
    del rec
    prof = profile_step(lambda: T.train_step(state, batch, cfg), "phase5")

    n0 = sk.fused_cost_volume.launches
    val = T.eval_step(state, batch, cfg)["val_loss"].item()
    test = {k: v.item() for k, v in T.test_step(state, batch, cfg).items()}
    check(sk.fused_cost_volume.launches == n0 + 2,
          "eval and test steps skipped the fused kernel")
    check(np.isfinite(val) and all(np.isfinite(list(test.values()))),
          f"eval {val} test {test}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(tmp, 0, state, cfg.architecture)
        pred = Predictor(ckpt)
        out = pred(*(sample[k][0] for k in ("imgs", "K", "R", "t",
                                            "depth_min", "depth_max")))
    check(out["depth"].shape == (HEADLINE["h"] // 4, HEADLINE["w"] // 4)
          and np.isfinite(out["depth"]).all(),
          "the trained checkpoint served a bad depthmap")
    print(f"phase5 eval_step val_loss {val:.4f}; test_step {test}; "
          f"checkpoint served: depth mean {out['depth'].mean():.3f}",
          flush=True)
    return counts, dict(losses=losses, first_step_ms=times[0],
                        step_ms_median=steady, step_ms=times,
                        peak_gib=peak / 2 ** 30, val_loss=val, test=test,
                        feature_grad_max_err=grad_err, **prof)


# ---------------------------------------------------------------------------
# Vis-MVSNet
# ---------------------------------------------------------------------------

_VIS_SCENES = {}


def vis_scene(n: int, h: int, w: int, f: float):
    """The bench scene of the trained Vis network: the DTU-like rig (seed 0)
    with the textured plane of bench.py rendered into it. Returns the
    Predictor arguments (numpy) and the per-view GT depths."""
    key = (n, h, w, f)
    if key not in _VIS_SCENES:
        _, K, R, t, dmin, dmax = dtu_scene(0, n, h, w, f)
        imgs, depths = render_rig_plane(K, R, t, h, w, **VIS_PLANE)
        _VIS_SCENES[key] = (imgs, K, R, t, dmin, dmax), depths
    return _VIS_SCENES[key]


def vis_kernel_inputs(dev, cfg, stage, D, per_pixel, behind=False, v=1,
                      C=32, graze=False):
    """Seeded bf16 features and the Vis sweep of one pair (view v against
    view 0) at one cascade stage of the bench scene `cfg`: (src, ref, P, Q,
    s, scale, clamp). Per-pixel hypotheses centre a slab of D stage
    intervals on the plane's GT depth; per-plane ones span the whole depth
    range. `behind` moves the source camera 600 mm ahead along the
    reference axis, so the nearer hypotheses lie behind it; `graze` moves
    it to GRAZING_AZIMUTH (`grazing`)."""
    (_, K, R, t, dmin, dmax), depths = vis_scene(**cfg)
    sc = VIS_STAGE_SCALE[stage - 1]
    fh, fw = cfg["h"] // sc, cfg["w"] // sc
    R, t = R.copy(), t.copy()
    if behind:
        R[v] = R[0]
        t[v] = t[0] - np.array([[0.0], [0.0], [600.0]], np.float32)
    if graze:
        R, t = grazing(R, t, v)
    Ks = scale_K(torch.from_numpy(K).to(dev), 1.0 / sc)
    Rt, tt = torch.from_numpy(R).to(dev), torch.from_numpy(t).to(dev)
    P, Q, scale, clamp = sk.vis_planes(
        Ks[0:1], Rt[0:1], tt[0:1], Ks[v:v + 1], Rt[v:v + 1], tt[v:v + 1],
        (fh, fw), (fh, fw))
    interval = (DEPTH_RANGE[1] - DEPTH_RANGE[0]) / 128.0 * \
        VIS_EVAL_SCALES[stage - 1]
    steps = torch.arange(D, dtype=torch.float32, device=dev)
    if per_pixel:
        gt = torch.from_numpy(depths[0, ::sc, ::sc].copy()).to(dev)
        start = gt[None, None] - D * interval / 2.0
        s = sk.inverse_depths(start + interval * steps.reshape(1, D, 1, 1))
    else:
        span = (DEPTH_RANGE[1] - DEPTH_RANGE[0]) / (D - 1)
        s = sk.inverse_depths(DEPTH_RANGE[0] + span * steps)[None]
    rng = np.random.default_rng(stage)
    src, ref = (torch.from_numpy(rng.standard_normal(
        (1, fh, fw, C), dtype=np.float32)).to(dev, torch.bfloat16)
        for _ in range(2))
    return src, ref, P, Q, s.contiguous(), scale, clamp


def vis_grid(P, Q, s, scale, clamp, h, w):
    """grid_sample's normalized (align_corners=True) grid [1, D*H, W, 2]
    bf16 of a Vis sweep: the yardstick's sampling positions."""
    x, y = sk.source_coords(*sk._project(P, Q, s), scale, clamp)
    D, H, W = x.shape[1:]
    grid = torch.stack([x / ((w - 1) / 2.0) - 1.0,
                        y / ((h - 1) / 2.0) - 1.0], -1)
    return grid.reshape(1, D * H, W, 2).to(torch.bfloat16).contiguous()


def gwc_library(src, ref, grid):
    """The two-call torch reference of sweep_gwc: grid_sample over the
    same grid, then the group-wise products and sums."""
    _, h, w, C = src.shape
    _, H, W, _ = ref.shape
    warped = F.grid_sample(src.permute(0, 3, 1, 2), grid, mode="bilinear",
                           padding_mode="zeros", align_corners=True)
    warped = warped.reshape(1, C, -1, H, W).permute(0, 2, 3, 4, 1)
    return groupwise_correlation(ref[:, None], warped, sk.GWC_GROUPS)


def phase1_vis_kernels(dev, results):
    """The Vis-convention kernels vs their plain versions: sweep_gwc at the
    1184x1600 eval's stage-1 ([D], 148x200, D=64), stage-2 ([D,H,W],
    296x400, D=32) and stage-3 ([D,H,W], 592x800, D=16) shapes, on a
    ragged crop of stage 1 (RAGGED) and on the grazing rig (staged and
    global stages in one launch); sweep_warp and sweep_warp_backward at the
    512x640 training's stage shapes (64x80 D=32 [D], 128x160 D=16 [D,H,W],
    256x320 D=8 [D,H,W]), on the same ragged crop and on the grazing rig
    at training stage 2; a source under 21 px (stage 1 of a 64x80 image,
    8x10) and a rig partly behind the source camera for all three. Adds
    the timings (gwc at the eval stages, the warp and its backward at the
    training stages) to `results`."""
    ev = dict(n=5, h=EVAL["h"], w=EVAL["w"], f=EVAL["f"])
    tr = dict(n=3, h=HEADLINE["h"], w=HEADLINE["w"], f=HEADLINE["f"])
    small = dict(n=5, h=64, w=80, f=EVAL["f"] * 80 / EVAL["w"])
    # (scene, stage, D, per-pixel, behind, source view); the 8x10 source
    # is the widest pair (12 degrees) of its rig, so that samples leave it
    cases = {"eval stage 1 [D]": (ev, 1, 64, False, False, 1),
             "eval stage 2 [D,H,W]": (ev, 2, 32, True, False, 1),
             "eval stage 3 [D,H,W]": (ev, 3, 16, True, False, 1),
             "train stage 1 [D]": (tr, 1, 32, False, False, 1),
             "train stage 2 [D,H,W]": (tr, 2, 16, True, False, 1),
             "train stage 3 [D,H,W]": (tr, 3, 8, True, False, 1),
             "source 8x10 [D]": (small, 1, 32, False, False, 4),
             "behind-camera rig": (tr, 3, 8, False, True, 1)}
    inputs = {}
    for case, (cfg, stage, D, per_pixel, behind, v) in cases.items():
        src, ref, P, Q, s, scale, clamp = inputs[case] = vis_kernel_inputs(
            dev, cfg, stage, D, per_pixel, behind, v)
        vis = (P, Q, s, scale, clamp)
        err_gwc = compare(f"sweep_gwc {case}", sk.sweep_gwc(src, ref, *vis),
                          sk.sweep_gwc_plain(src, ref, *vis))
        if case.startswith("eval"):
            continue
        err_warp = compare(f"sweep_warp Vis {case}", sk.sweep_warp(src, *vis),
                           sk.sweep_warp_plain(src, *vis))
        g = torch.randn((1,) + tuple(s.shape[1:2]) + tuple(P.shape[2:])
                        + (src.shape[-1],), device=dev,
                        generator=torch.Generator(dev).manual_seed(2)).to(
            torch.bfloat16)
        err_bwd, _ = compare_backward(g, P, Q, s, tuple(src.shape[1:3]),
                                      f"Vis {case}", scale, clamp)
        if case == "behind-camera rig":
            rz = sk._project(P, Q, s)[2]
            share = (rz <= 0).float().mean().item()
            print(f"phase1 Vis behind-camera share {share:.3f}", flush=True)
            check(0.0 < share < 1.0, f"Vis behind share {share}")
        if case.startswith("source"):
            x, _ = sk.source_coords(*sk._project(P, Q, s), scale)
            check(bool(((x < clamp[0]) | (x > clamp[1])).any()),
                  "the small-source case never clamps")

    # sweep_gwc on a ragged crop of stage 1 and on the grazing rig
    rh, rw, rd = RAGGED
    src, ref, P, Q, s, scale, clamp = inputs["eval stage 1 [D]"]
    vis = (P[..., :rh, :rw].contiguous(), Q[..., :rh, :rw].contiguous(),
           s[:, :rd].contiguous(), scale, clamp)
    compare(f"sweep_gwc ragged {rh}x{rw} D{rd}",
            sk.sweep_gwc(src, ref[:, :rh, :rw].contiguous(), *vis),
            sk.sweep_gwc_plain(src, ref[:, :rh, :rw].contiguous(), *vis))
    compare(f"sweep_warp Vis ragged {rh}x{rw} D{rd}", sk.sweep_warp(src, *vis),
            sk.sweep_warp_plain(src, *vis))
    g = torch.randn((1, rd, rh, rw, src.shape[-1]), device=dev,
                    generator=torch.Generator(dev).manual_seed(2)).to(
        torch.bfloat16)
    compare_backward(g, *vis[:3], tuple(src.shape[1:3]),
                     f"Vis ragged {rh}x{rw} D{rd}", scale, clamp)
    src, ref, P, Q, s, scale, clamp = vis_kernel_inputs(
        dev, ev, 1, 64, False, graze=True)
    vis = (P, Q, s, scale, clamp)
    share, plain_share, (n_st, n_gl) = tile_shares(
        lambda: sk.sweep_gwc(src, ref, *vis), P, Q, s, tuple(src.shape[1:3]),
        sk.footprint_plan(src.shape[-1]), scale, clamp)
    check(n_st > 0 and n_gl > 0, f"the grazing rig's launch did not mix "
          f"staged and global stages: {n_st} and {n_gl}")
    compare("sweep_gwc grazing rig", sk.sweep_gwc(src, ref, *vis),
            sk.sweep_gwc_plain(src, ref, *vis),
            f" staged {n_st} global {n_gl}: share {share:.4f} (plain rule "
            f"{plain_share:.4f})")
    # sweep_warp and its backward on the grazing rig at training stage 2
    src, ref, P, Q, s, scale, clamp = vis_kernel_inputs(
        dev, tr, 2, 16, True, graze=True)
    vis = (P, Q, s, scale, clamp)
    g = torch.randn((1, 16) + tuple(P.shape[2:]) + (src.shape[-1],),
                    device=dev, generator=torch.Generator(dev).manual_seed(
                        2)).to(torch.bfloat16)
    share = warp_share(src, *vis)
    n_st, n_gl = share[2]
    check(n_st > 0 and n_gl > 0, f"sweep_warp: the Vis grazing rig's launch "
          f"did not mix staged and global stages: {n_st} and {n_gl}")
    compare("sweep_warp Vis grazing rig", sk.sweep_warp(src, *vis),
            sk.sweep_warp_plain(src, *vis),
            f"; staged {n_st} global {n_gl}: {share_text(share)}")
    compare_backward(g, P, Q, s, tuple(src.shape[1:3]), "Vis grazing rig",
                     scale, clamp)

    # --- sweep_gwc timings: the three eval stages ---------------------------
    times = {}
    for case in ("eval stage 1 [D]", "eval stage 2 [D,H,W]",
                 "eval stage 3 [D,H,W]"):
        src, ref, P, Q, s, scale, clamp = inputs[case]
        vis = (P, Q, s, scale, clamp)
        _, h, w, C = src.shape
        out = sk.sweep_gwc(src, ref, *vis)
        err = compare(f"sweep_gwc {case} (timed)", out,
                      sk.sweep_gwc_plain(src, ref, *vis))
        ms, events_ms = timed(lambda: sk.sweep_gwc(src, ref, *vis))
        plain_ms = cuda_ms(lambda: sk.sweep_gwc_plain(src, ref, *vis),
                           reps=3, warmup=1)
        grid = vis_grid(P, Q, s, scale, clamp, h, w)
        library_ms = cuda_ms(lambda: gwc_library(src, ref, grid), reps=10,
                             warmup=2)
        n_live = live_samples(P, Q, s, h, w, scale, clamp)
        D, H, W = out.shape[1:4]
        b_ms, b_by = bound(nbytes(src, ref, P, Q, s, out),
                           n_live * C * 10 + D * H * W * 20)
        share, plain_share, _ = tile_shares(
            lambda: sk.sweep_gwc(src, ref, *vis), P, Q, s, (h, w),
            sk.footprint_plan(C), scale, clamp)
        times[case] = dict(max_abs_err=err, ms=ms, events_ms=events_ms,
                           plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=b_ms, bound_by=b_by, staged_share=share)
        print(f"phase1 sweep_gwc {case}: ms {ms:.4f} (events "
              f"{events_ms:.4f}) plain_ms "
              f"{plain_ms:.3f} library_ms {library_ms:.4f} (bf16 grid_sample"
              f" + group sum, two calls) bound_ms {b_ms:.4f} ({b_by}) live "
              f"samples {n_live}; staged share {share:.4f} (plain rule "
              f"{plain_share:.4f})", flush=True)
    results["sweep_gwc"] = dict(
        name="sweep_gwc", route="cuda", source="wildmvs_torch/csrc/warp.cu",
        replaces="wildmvs/ops/mosaic_sweep.py:627",
        **times["eval stage 3 [D,H,W]"],
        stage1=times["eval stage 1 [D]"], stage2=times["eval stage 2 [D,H,W]"])

    # --- Vis sweep_warp and its backward: the three training stages -------
    for stage, case in enumerate(("train stage 1 [D]", "train stage 2 [D,H,W]",
                                  "train stage 3 [D,H,W]"), 1):
        src, ref, P, Q, s, scale, clamp = inputs[case]
        vis = (P, Q, s, scale, clamp)
        _, h, w, C = src.shape
        D, H, W = s.shape[1], *P.shape[2:]
        shape = f"{H}x{W} C{C} D{D} {case.split()[-1]}"
        out = sk.sweep_warp(src, *vis)
        g = torch.randn(out.shape, device=dev, generator=torch.Generator(
            dev).manual_seed(3)).to(torch.bfloat16)
        share = warp_share(src, *vis)
        grid = vis_grid(P, Q, s, scale, clamp, h, w)
        src_nchw = src.permute(0, 3, 1, 2)
        n_live = live_samples(P, Q, s, h, w, scale, clamp)
        ops = n_live * C * 8 + D * H * W * 20
        ms, events_ms = timed(lambda: sk.sweep_warp(src, *vis))
        plain_ms = cuda_ms(lambda: sk.sweep_warp_plain(src, *vis), reps=3,
                           warmup=1)
        library_ms = cuda_ms(lambda: F.grid_sample(
            src_nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True), reps=20, warmup=2)
        b_ms, b_by = bound(nbytes(src, P, Q, s, out), ops)
        results["sweep_warp"].setdefault("vis", {})[f"stage{stage}"] = dict(
            shape=shape, ms=ms, events_ms=events_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
            staged_share=share[0])
        print(f"phase1 sweep_warp Vis train stage {stage} {shape}: ms "
              f"{ms:.4f} (events {events_ms:.4f}) plain_ms {plain_ms:.3f} "
              f"library_ms {library_ms:.4f} (bf16 grid_sample) bound_ms "
              f"{b_ms:.4f} ({b_by}); {share_text(share)}", flush=True)
        bwd = (g, P, Q, s, (h, w))
        ms, events_ms = timed(lambda: sk.sweep_warp_backward(
            *bwd, scale=scale, clamp=clamp))
        plain_ms = cuda_ms(lambda: sk.sweep_warp_backward_plain(
            *bwd, scale, clamp), reps=3, warmup=1)
        g_nchw = g.reshape(1, D * H, W, C).permute(0, 3, 1, 2)
        library_ms = cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            g_nchw, src_nchw, grid, 0, 0, True, [True, False]), reps=20,
            warmup=2)
        b_ms, b_by = bound(nbytes(g, P, Q, s) + h * w * C * 4, ops)
        atomics = counted_atomics(f"Vis train stage {stage}", *bwd, scale,
                                  clamp)
        results["sweep_warp_backward"].setdefault("vis", {})[
            f"stage{stage}"] = dict(
            shape=shape, ms=ms, events_ms=events_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
            device_atomics=atomics)
        print(f"phase1 sweep_warp_backward Vis train stage {stage} {shape}: "
              f"ms {ms:.4f} (events {events_ms:.4f}) plain_ms "
              f"{plain_ms:.3f} library_ms {library_ms:.4f} (bf16 "
              f"grid_sampler_2d_backward) bound_ms {b_ms:.4f} ({b_by})",
              flush=True)
    return results


def stage_forced(model, args, method):
    """Run `model` with `method`, then each stage again through the exact
    gather on the very inputs that stage received (features, cameras,
    slab). Returns {stage: (method's cost volumes, gather's, method's
    depth, gather's depth, the stage's hypothesis interval)}. Holding each
    stage on its own inputs keeps the cascade's re-centring, which
    amplifies any difference between two runs, out of the comparison."""
    model.sweep_method = method
    inputs, outputs, costs, hooks = {}, {}, {}, []
    for i in (1, 2, 3):
        st = getattr(model, f"stage{i}")
        hooks += [
            st.register_forward_pre_hook(
                lambda m, a, i=i: inputs.__setitem__(i, a)),
            st.register_forward_hook(
                lambda m, a, o, i=i: outputs.__setitem__(i, o)),
            st.reg.register_forward_pre_hook(
                lambda m, a, i=i: costs.setdefault(i, []).append(a[0]))]
    try:
        with torch.inference_mode():
            model(*args)
            got = {}
            for i in (1, 2, 3):
                n_pairs = len(costs[i])
                est, _, _ = getattr(model, f"stage{i}")(*inputs[i][:-1],
                                                        "gather")
                got[i] = (costs[i][:n_pairs], costs[i][n_pairs:],
                          outputs[i][0], est,
                          inputs[i][5].flatten()[0].item())
    finally:
        for hk in hooks:
            hk.remove()
        model.sweep_method = "auto"
    return got


def vis_agreement(pred, scene_args):
    """Each stage of the kernel path against the exact gather on that
    stage's own inputs: every pair's cost volume within bf16 rounding (max
    0.03, mean 0.002 of its scale) and the stage-3 depth within one
    stage-3 hypothesis interval on >= 95 % of pixels."""
    dev = pred.device
    args = [torch.as_tensor(np.asarray(a, np.float32), device=dev)[None]
            for a in scene_args]
    worst = {}
    for stage, (cv, cv_g, est, est_g, interval) in stage_forced(
            pred.model, args, "auto").items():
        check(len(cv) == len(cv_g) > 0, f"stage {stage} pairs")
        for i, (a, b) in enumerate(zip(cv, cv_g)):
            a, b = a.float(), b.float()
            scale = b.abs().max().item()
            err = (a - b).abs()
            mx, mean = err.max().item() / scale, err.mean().item() / scale
            worst[stage] = max(worst.get(stage, 0.0), mx)
            print(f"phase6 stage {stage} pair {i} cost volume vs gather: max "
                  f"{mx:.5f} mean {mean:.6f} of the scale {scale:.4g}",
                  flush=True)
            check(mx <= 0.03 and mean <= 0.002,
                  f"stage {stage} pair {i} cost volume disagrees with the "
                  f"gather")
        derr = (est.float() - est_g.float()).abs() / interval
        within = (derr < 1).float().mean().item()
        print(f"phase6 stage {stage} depth vs gather on the same inputs: "
              f"mean {derr.mean().item():.4f} intervals ({interval:.4f} mm),"
              f" {within:.4f} within 1, max {derr.max().item():.3f}",
              flush=True)
        if stage == 3:
            check(within >= 0.95, f"stage-3 depth within one interval on "
                  f"{within:.4f} of pixels")
            worst["stage3_within_1"] = within
            worst["stage3_mean_intervals"] = derr.mean().item()
    return worst


def phase6_vis_serving():
    """Vis-MVSNet serving: the trained asset at 1184x1600 N5 through
    sweep_gwc (12 launches a request), held to the gather; a random-weight
    request; run_depthmaps."""
    cfg = dict(n=5, h=EVAL["h"], w=EVAL["w"], f=EVAL["f"])
    scene, depths = vis_scene(**cfg)
    pred = Predictor(VIS_ASSET)
    check(pred.architecture == "vis_mvsnet"
          and pred.model.depth_nums == VIS_EVAL_DEPTHS, "Vis predictor")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    out, first_ms = request_ms(pred, scene)
    times = [request_ms(pred, scene)[1] for _ in range(3)]
    counts = sk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase6 launches {json.dumps(counts)}", flush=True)
    check(counts == {"sweep_warp": 0, "sweep_warp_backward": 0,
                     "fused_cost_volume": 0, "sweep_gwc": 12 * 4},
          f"Vis serving did not take 12 gwc launches a request: {counts}")
    h2, w2 = EVAL["h"] // 2, EVAL["w"] // 2
    check(out["depth"].shape == (h2, w2)
          and out["confidence"].shape == (3, h2, w2)
          and np.isfinite(out["depth"]).all()
          and np.isfinite(out["confidence"]).all(), "bad Vis output")
    gt = depths[0, ::2, ::2]
    interval3 = (DEPTH_RANGE[1] - DEPTH_RANGE[0]) / 128.0 * VIS_EVAL_SCALES[2]
    gt_err = np.abs(out["depth"] - gt) / interval3
    print(f"phase6 Vis serving 1184x1600 N5 (64,32,16) bf16 gwc, trained "
          f"asset: ms per depthmap first {first_ms:.3f} then "
          f"{[round(t, 3) for t in times]} (median {np.median(times):.3f});"
          f" peak memory {peak / 2**30:.3f} GiB; depth vs the plane's GT: "
          f"median {np.median(gt_err):.3f} stage-3 intervals "
          f"({interval3:.4f} mm); confidence means "
          f"{[round(float(c.mean()), 3) for c in out['confidence']]}",
          flush=True)
    worst = vis_agreement(pred, scene)
    gather = Predictor(VIS_ASSET, sweep_method="gather")
    out_g, gather_ms = request_ms(gather, scene)
    gather_ms = request_ms(gather, scene)[1]
    e2e = np.abs(out["depth"] - out_g["depth"]) / interval3
    print(f"phase6 end to end vs the gather path (each cascade on its own "
          f"slabs, reported only): mean {e2e.mean():.3f} intervals, "
          f"{(e2e < 1).mean():.4f} within 1; gather request ms "
          f"{gather_ms:.3f}", flush=True)
    del gather
    prof = profile_step(lambda: pred(*scene), "phase6")

    n0 = sk.sweep_gwc.launches
    rand = Predictor(architecture="vis_mvsnet")
    out_r = rand(*scene)
    check(sk.sweep_gwc.launches == n0 + 12 and np.isfinite(out_r["depth"])
          .all(), "random-weight Vis request")
    samples = []
    for i in range(2):
        (imgs, K, R, t, dmin, dmax), _ = vis_scene(
            n=3, h=HEADLINE["h"], w=HEADLINE["w"], f=HEADLINE["f"])
        samples.append(dict(imgs=imgs, K=K, R=R, t=t, depth_min=dmin,
                            depth_max=dmax, filename=f"scan2/{i:08d}"))
    with tempfile.TemporaryDirectory() as tmp:
        run_depthmaps(samples, pred.model, tmp)
        files = sorted(q.name for q in Path(tmp).iterdir())
        check(files == ["finished.txt", "scan2_00000000_out.npz",
                        "scan2_00000001_out.npz"], f"files {files}")
        for f in files[1:]:
            with np.load(Path(tmp) / f) as z:
                check(z["probability"].shape == (3, HEADLINE["h"] // 2,
                                                 HEADLINE["w"] // 2)
                      and np.isfinite(z["depthmap"]).all(), f"bad {f}")
    print(f"phase6 random-weight request depth mean "
          f"{out_r['depth'].mean():.2f}; run_depthmaps: {files}", flush=True)
    return counts, dict(
        first_request_ms=first_ms, request_ms=times,
        request_ms_median=float(np.median(times)), gather_request_ms=gather_ms,
        peak_gib=peak / 2 ** 30, agreement=worst,
        depth_vs_gt_median_intervals=float(np.median(gt_err)),
        end_to_end_vs_gather_mean_intervals=float(e2e.mean()), **prof)


def record_vis_warps(model, rec: list):
    """Patch the Vis model's sweep_warp to keep, while `rec` is not None,
    each call's source, the gradient of its output (g) and of its source
    (df), and each stage's inputs (cameras and slab) to rebuild the exact
    gather. Returns the undo."""
    real = vis_module.sweep_warp
    stages = {}

    def recording(src, P, Q, s, scale, clamp):
        out = real(src, P, Q, s, scale, clamp)
        entry = {"src": src.detach()}
        out.register_hook(lambda g: entry.__setitem__("g", g))
        src.register_hook(lambda df: entry.__setitem__("df", df))
        rec.append(entry)
        return out

    hooks = [getattr(model, f"stage{i}").register_forward_pre_hook(
        lambda m, a, i=i: stages.setdefault(i, a)) for i in (1, 2, 3)]
    vis_module.sweep_warp = recording

    def undo():
        vis_module.sweep_warp = real
        for hk in hooks:
            hk.remove()
    return undo, stages


def vis_gradient_agreement(rec, stages):
    """The Vis warp kernel's source-feature gradients (first step) against
    the exact gather's autograd (homography_sweep_warp in f32) at the same
    cotangent: max <= 2^-7, mean <= 2^-9 of the gradient's scale."""
    worst = 0.0
    n_src = len(rec) // 3
    for j, e in enumerate(rec):
        stage, i = j // n_src + 1, j % n_src
        _, _, cams, D, start, interval, s_scale, _ = stages[stage]
        K = scale_K(cams["K"].float(), 1.0 / s_scale)
        R, t = cams["R"].float(), cams["t"].float()
        src = e["src"].float().requires_grad_()
        hw = tuple(stages[stage][0].shape[1:3])
        warped = homography_sweep_warp(
            src, K[:, 0], R[:, 0], t[:, 0], K[:, i + 1], R[:, i + 1],
            t[:, i + 1], D, start, interval, hw)
        (want,) = torch.autograd.grad(warped, src, e["g"].float())
        err = (e["df"].float() - want).abs()
        scale = want.abs().max().item()
        print(f"phase7 feature gradient stage {stage} pair {i}: kernel vs "
              f"gather max {err.max().item():.6g} mean {err.mean().item():.6g}"
              f" (scale {scale:.4g})", flush=True)
        check(scale > 0 and err.max().item() <= 2 ** -7 * scale
              and err.mean().item() <= 2 ** -9 * scale,
              f"stage {stage} pair {i}: the kernel's feature gradient "
              f"disagrees with the gather's")
        worst = max(worst, err.max().item() / scale)
    return worst


def phase7_vis_training(dev):
    """Vis-MVSNet training: 6 bf16 steps at 512x640 N3 through the Vis
    warp kernel and its backward; eval and test steps; a checkpoint."""
    cfg = TrainConfig(architecture="vis_mvsnet", dataset="synthetic",
                      lr=1e-3, train_dtype="bfloat16")
    ds = SyntheticMVSDataset(num_samples=1, num_views=HEADLINE["n"],
                             height=HEADLINE["h"], width=HEADLINE["w"])
    sample = collate([ds[0]])
    batch = T.batch_to_device(sample, dev)
    state = T.create_train_state(cfg, dev)
    params = list(state.model.parameters())
    check(all(p.dtype == torch.float32 for p in params),
          "Vis training parameters are not f32")
    rec = []
    undo, stages = record_vis_warps(state.model, rec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = T.train_step(state, batch, cfg)
        grads_finite = torch.stack([torch.isfinite(p.grad).all()
                                    for p in params]).all()
        losses.append(m["train_loss"].item())
        times.append((time.perf_counter() - t0) * 1e3)
        check(bool(grads_finite), f"Vis step {i}: a gradient is not finite")
        if i == 0:
            undo()
    counts = sk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase7 launches {json.dumps(counts)}", flush=True)
    per_step = 3 * (HEADLINE["n"] - 1)
    check(counts == {"sweep_warp": per_step * TRAIN_STEPS,
                     "sweep_warp_backward": per_step * TRAIN_STEPS,
                     "fused_cost_volume": 0, "sweep_gwc": 0},
          f"Vis training did not take the warp kernels: {counts}")
    check(len(rec) == per_step and all("df" in e and "g" in e for e in rec),
          "the first Vis step's warps were not recorded")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"Vis losses {losses}")
    steady = float(np.median(times[1:]))
    print(f"phase7 Vis training 512x640 N3 (32,16,8) bf16 (f32 parameters):"
          f" losses {[round(x, 4) for x in losses]}; ms per step first "
          f"{times[0]:.3f} then {[round(t, 3) for t in times[1:]]} (median "
          f"{steady:.3f}); peak memory {peak / 2**30:.3f} GiB", flush=True)
    grad_err = vis_gradient_agreement(rec, stages)
    del rec, stages
    prof = profile_step(lambda: T.train_step(state, batch, cfg), "phase7")

    n0 = sk.sweep_gwc.launches
    val = T.eval_step(state, batch, cfg)["val_loss"].item()
    test = {k: v.item() for k, v in T.test_step(state, batch, cfg).items()}
    check(sk.sweep_gwc.launches == n0 + 2 * per_step,
          "Vis eval and test steps skipped the gwc kernel")
    check(np.isfinite(val) and all(np.isfinite(list(test.values()))),
          f"Vis eval {val} test {test}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(tmp, 0, state, cfg.architecture)
        pred = Predictor(ckpt)
        out = pred(*(sample[k][0] for k in ("imgs", "K", "R", "t",
                                            "depth_min", "depth_max")))
    check(out["depth"].shape == (HEADLINE["h"] // 2, HEADLINE["w"] // 2)
          and np.isfinite(out["depth"]).all(),
          "the trained Vis checkpoint served a bad depthmap")
    print(f"phase7 eval_step val_loss {val:.4f}; test_step {test}; "
          f"checkpoint served: depth mean {out['depth'].mean():.3f}",
          flush=True)
    return (counts, dict(
        losses=losses, first_step_ms=times[0], step_ms_median=steady,
        step_ms=times, peak_gib=peak / 2 ** 30, val_loss=val, test=test,
        feature_grad_max_rel_err=grad_err, **prof))


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

    kernels = phase1_vis_kernels(dev, phase1_kernels(dev))
    phase1_channels(dev)
    kernels["sweep_warp"]["replaces"] = \
        "wildmvs/ops/mosaic_sweep.py:143 and :298"
    pred, counts, serving = phase2_serving()
    evals = phase3_eval(pred, dev)
    phase4_depthmaps(pred)
    del pred
    torch.cuda.empty_cache()
    train_counts, training = phase5_training(dev)
    torch.cuda.empty_cache()
    vis_counts, vis_serving = phase6_vis_serving()
    torch.cuda.empty_cache()
    vis_train_counts, vis_training = phase7_vis_training(dev)

    # launches: each path's own, counted from 0 just before its run
    paths = {"mvsnet_serving": counts, "mvsnet_training": train_counts,
             "vis_serving": vis_counts, "vis_training": vis_train_counts}
    for name, k in kernels.items():
        k["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        k["launches"] = sum(c[name] for c in paths.values())
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "events_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "staged_share", "launches_by_path"]
    extra = ["device_atomics", "softmin_ms", "views", "vis", "stage1",
             "stage2"]
    for k in kernels.values():
        k.setdefault("staged_share", None)      # kernels without footprints
    print(json.dumps({"kernels": [{k: v[k] for k in keys + extra if k in v}
                                  for v in kernels.values()],
                      "serving": serving, "eval": evals,
                      "training": training, "vis_serving": vis_serving,
                      "vis_training": vis_training, "card": card}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
