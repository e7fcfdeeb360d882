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
  8. CVP-MVSNet serving (the fifth path): Predictor(sweep_method="fused",
     cvp_nscale=5), bf16, random weights with prob0 x PROB_GAIN, answers 3
     requests at 1184x1600 N5 and 3 at 512x640 N3: 5 fused_cost_volume
     launches (C = 16) a request and nothing else of the kernels; finite
     outputs; each level's cost volume held to the exact gather on that
     level's own inputs and the finest depth within one refinement
     interval of the depth regressed from the gather's volume; the fused
     kernel timed at the coarse (74x100 D96 [D]) and finest (1184x1600 D8
     [D,H,W]) levels; run_depthmaps over 2 samples.
  9. CVP-MVSNet training (the sixth path): 6 supervised bf16 steps at
     512x640 N3, nscale 2: 4 sweep_warp and 4 sweep_warp_backward launches
     (C = 16) a step, no fused or gwc launch; finite losses and gradients,
     the last loss below the first; the first step's feature gradients at
     both levels against the exact gather's autograd; an eval and a test
     step (fused launches) and a checkpoint served by Predictor.
 10. the rectified sweep (phase10_rect_serving) and
 11. the reconstruction pipeline (phase11_reconstruction): see their
     docstrings.
 12. unsupervised training (the seventh path, "unsup_training"): MVSNet at
     512x640 N3 D192, bf16, occlusion-masked (every view as the reference
     in one step, geom_clamping 0.05): 6 steps of 6 sweep_warp and 6
     sweep_warp_backward launches, finite gradients, the last loss below
     the first, the first step's six warps' feature gradients against the
     gather's autograd, one profiled step, the peak memory beside phase
     5's, an occlusion-masked eval step; then 4 steps each of Vis-MVSNet
     occlusion-masked (18 + 18 launches a step) and CVP-MVSNet nscale 2
     unmasked (4 + 4). The DTU loader is not driven here: the card's
     machine has PIL and cv2 but not h5py (README). 12c
     (`phase12c_default_flags`): phase 12a's step under PyTorch's default
     TF32 flags, the flags `train.cli --unsupervised` runs with, against
     both flags off: DSSIM maps, loss and feature gradients within
     DEFAULT_FLAGS_REL and phase 12a's limits.
 13. distribution on the one card (the eighth path, "distributed";
     `phase13_distribution`): ranks spawned as processes on cuda:0 over
     gloo (the kernels built once before the spawn). (a) View-parallel
     occlusion-masked MVSNet at 512x640 N3 D192 bf16, three ranks, one
     reference view each, from phase 12's seeded weights and batch: two
     steps' losses within 2^-7 of the single-program step's, the first
     step's gradients within VIEW_GRAD_REL of its (median over the
     parameters of the relative L2), the parameters after it within
     Adam's sign-flip bound (99.9 % within 2e-5, all within 2.5 lr),
     2 warps and 2 backwards a rank and
     step, ms a step beside phase 12's. (b) MVSNet serving at 1184x1600
     N5 D192 with the hypotheses over hyp = 2 (`Predictor(mesh=)`): one
     fused launch a rank a request, over its 96 hypotheses, each rank
     keeping its slab through the depth-partitioned CostRegNet; the depth
     within phase 2's limits of the unsharded request's; per rank, beside
     the unsharded request, the peak GiB, the regularizer's CUDA-event ms
     and the bytes its collectives moved, those under HYP_BYTES_SHARE of
     the 2.9 GB f32 volume that a gather before the regularizer would
     move. (c) The
     trained
     Vis asset at 1184x1600 N5 with its source pairs over view = 2: two
     pairs a rank through sweep_gwc; stage-3 depth within one interval of
     the unsharded request's on >= 95 % of pixels. (d) A data-parallel
     supervised MVSNet step, world 2, batch 2 (the second sample's mask
     cut to its lower half), BatchNorm synced, in f32
     (the exact gather: bf16 rounding leaves nothing sharp to hold it to),
     against the single-program step on the batch: loss within 1e-5,
     gradients within 1e-2 in relative L2, parameters within the
     sign-flip bound. (f) At hyp = 2, the trained Vis asset at 1184x1600
     N5 (12 gwc launches a rank a request, Reg, RegPair and RegFuse
     depth-partitioned) and CVP-MVSNet "fused" nscale 5 (5 fused launches,
     the coarse level partitioned) against their unsharded requests under
     phase 6's limit (stage-3 depth within one interval on >= 95 % of
     pixels) and phase 8's (one interval on >= 95 %, on the same inputs:
     CVP's coarse depth, the level the partition runs; its finest depth
     end to end reported). (e) --remat, in this process:
     phase 5's supervised step and the occlusion-masked step with and
     without it, losses within 2^-7, the warps launched twice, the
     occlusion-masked step's peak memory lower. Every time here is a
     one-card gloo figure: it says nothing of NCCL or of scaling over
     cards.
 14. classic and the offline tools (`phase14_classic_and_tools`, the
     paths "classic" and "depthmap_eval"), on BenchScene at 1184x1600 N5:
     (a) the classic ZNCC sweep at the JAX defaults (D192, window 7, half
     resolution): ms a depthmap (median of 3 after a warm-up), peak GiB,
     median relative depth error against GT under 3 %, confidence in
     [0, 1]; at 296x400 D48 on the card (PyTorch's default TF32
     settings) against the CPU within CLASSIC_LIMITS; (b)
     run_pipeline(architecture="classic", compute_metrics=True) within
     RECON_BOUNDS["classic"]; (a) and (b) launch no kernel; (c)
     depthmap_eval.evaluate with the trained Vis asset (12 gwc launches
     a sample), EPE within 1e-3 of the metrics recomputed in numpy from
     run_depthmaps' npz, two shards merged within 1e-6 of the unsharded
     run; (d) the Gipuma and COLMAP workspaces exported from (b)'s
     caches, their depths read back equal to the masked depths. The
     orbax reader, matching and MegaDepth preprocessing are not run: the
     card's machine has no tensorstore and no h5py, and the last two are
     host code.
 15. the native host helpers (`phase15_native`, wildmvs_torch/cpp, built
     by main before phase 1): which library built (the k-d tree must; the
     image module must where libjpeg's and libpng's headers exist); the
     DTU dedup and the NN distances of the metrics stage on phase 11's
     oracle cloud and on a 5 M-point dense cloud, native against cKDTree
     (keep masks equal, distances within 1e-12), ms of each; the
     BlendedMVS loader and MegaDepth's resize, ms a sample beside phase
     5's step, native against PIL where the image module linked.
 16. the port's benchmark (`phase16_bench`, the path "bench"): (a)
     `python -m wildmvs_torch.bench` in a subprocess, under PyTorch's
     default TF32 flags and the bench's default switches, with the kernel
     library built above: its ten fields (MVSNet, Vis-MVSNet and
     CVP-MVSNet at their training-resolution eval configurations and at
     the 1184x1600 N5 eval protocol, exact and rect, Vis also with the
     trained asset) each > 0 and finite with its diagnostics, finite_share
     1, the kernel launches a forward of BENCH_LAUNCHES; its last record
     is printed. (b) One forward of every field in this process (the
     path's launch counts), each launch held to its plain version on its
     own inputs under compare's limit: the bench's shapes and rigs (the
     0.1 mm `scene` rig too), which phase 1's cases do not cover.
 17. the quality drive (`phase17_quality`, the path "e2e"): (a) `python
     -m wildmvs_torch.tools.e2e_quality --epochs 40 --prob_threshold 0.05`
     in a subprocess under PyTorch's default flags: MVSNet, Vis-MVSNet and
     CVP-MVSNet trained by the port's CLI on the synthetic set (the JAX
     recipes, f32), each logdir reconstructed through the four stages on
     the held-out 64x96 5-view scene; the oracle, MVSNet and Vis rows held
     to the JAX package's bounds (E2E_BOUNDS), CVP printed; no error row.
     (b) The trained checkpoints in this process through load_network:
     one bf16 eval forward each and one bf16 training step each at the
     drive's shapes, every launch held to its plain version on its own
     inputs.

Phase 1 also holds the regularizers' score head (`phase1_conv_head`,
csrc/conv3d_head.cu) to its plain version at MVSNet's 1184x1600 head
(D192 C8, with bias), Vis-MVSNet's stage 3 (592x800 D16 C8) and
CVP-MVSNet's finest level (1184x1600 D8 C16, with bias), in bf16, and
times it beside its bound and F.conv3d (cuDNN) as its yardstick. Its
launches (`conv3d_head`, registered with sweep_kernels) are counted in
every path like the sweep kernels': one a MVSNet request, 3n a Vis-MVSNet
request of n views (`vis_heads`), one a CVP-MVSNet level, none in a step
with grad or in a hyp-partitioned regularizer.

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
count they take (CHANNELS, a kernel body each) in both conventions,
sweep_gwc and the fused kernel (variance and softmin, [D] and [D,H,W]) at
those they take; the fused kernel also at 6, 8 and 16 source
views (FUSED_VIEWS), where its stage buffers shrink or vanish to keep
the block's shared memory in bounds; at each timed shape a forward
kernel's own count of staged stages is printed beside the share that the
plain rule (sweep_footprints) predicts. Phase 3 times the fused kernel at
the eval shapes by CUDA-graph replay too.

Prints the card, the kernels' register/spill summary, the native
library's variant and one line per phase, then a `kernels` JSON line and,
last, the device JSON line.
"""
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from wildmvs_torch import _build
from wildmvs_torch import bench as port_bench
from wildmvs_torch import cpp as native
from wildmvs_torch.data import loaders
from wildmvs_torch.data.synthetic import (SyntheticMVSDataset,
                                          SyntheticSceneDataset, collate,
                                          render_rig_plane)
from wildmvs_torch.dist.mesh import (collective_bytes, make_mesh,
                                     reset_collective_bytes, shard_batch,
                                     spawn)
from wildmvs_torch.dist.view_parallel import make_view_parallel_train_step
from wildmvs_torch.geometry.projective import build_proj_matrices, scale_K
from wildmvs_torch.infer import Predictor
from wildmvs_torch.models import mvsnet as mvsnet_module
from wildmvs_torch.models import vis_mvsnet as vis_module
from wildmvs_torch.ops import conv_head
from wildmvs_torch.ops import rect_sweep as rs
from wildmvs_torch.ops import sweep_kernels as sk
from wildmvs_torch.ops.plane_sweep import (homography_sweep_warp,
                                           plane_sweep_warp)
from wildmvs_torch.ops.volumes import groupwise_correlation
from wildmvs_torch.data.codecs import (read_colmap_array, read_dmb,
                                       write_cam_txt, write_pfm)
from wildmvs_torch.losses import photometric as photometric_module
from wildmvs_torch.losses.ssim import dssim
from wildmvs_torch.losses.supervised import resize_bilinear
from wildmvs_torch.data.ply import ply_xyz
from wildmvs_torch.pipeline import depthmap_eval, export, metrics3d
from wildmvs_torch.pipeline.classic import classic_depthmap
from wildmvs_torch.pipeline.depthmaps import get_mask_invalid, run_depthmaps
from wildmvs_torch.pipeline.reconstruction import (load_network,
                                                   run_pipeline)
from wildmvs_torch.tools import e2e_quality
from wildmvs_torch.train import trainer as T
from wildmvs_torch.train.checkpoint import save_checkpoint
from wildmvs_torch.train.config import TrainConfig

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
# CVP-MVSNet serving: pyramid levels (the reference's DTU eval) and requests
# at each of the two sizes
CVP_NSCALE = 5
CVP_REQUESTS = 3


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


def compare(name, got, want, extra="", phase="phase1"):
    """Max abs error of kernel vs plain, held to one bf16 ulp of the scale:
    both round the same f32 arithmetic to bf16 once; FMA contraction and
    summation order may move a value across a rounding boundary."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    limit = 2.0 ** -7 * max(scale, 1e-6)
    print(f"{phase} {name}: max_abs_err {err:.6g} limit {limit:.6g} "
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
    work = sk.warp_work(*warp_args)
    n_live = work.live_samples
    b_ms, b_by = sk.bound(work)
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
    b_ms, b_by = sk.bound(sk.warp_backward_work(*bwd))
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
    work = sk.fused_work(ref, srcs, P, Q, s)
    (b_ms, b_by), n_live = sk.bound(work), work.live_samples
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
        b_ms, b_by = sk.bound(sk.fused_work(*a_v[:5]))
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
    per-pixel hypotheses, Vis convention), sweep_gwc on the Vis crop at
    the channel counts it takes, and fused_cost_volume (NV = 2, variance
    and softmin, [D] and [D,H,W]) on the headline crop, each held to its
    plain version."""
    rh, rw, rd = RAGGED
    tr = dict(n=3, h=HEADLINE["h"], w=HEADLINE["w"], f=HEADLINE["f"])
    for c in CHANNELS:
        ref_m, srcs, P, Q, s, *_ = kernel_inputs(HEADLINE, dev, C=c)
        # the softmin weight exp(-T * sum over C channels) as at C = 32
        temp = torch.full((1,), 0.05 * 32 / c, device=dev)
        s_c = s[:, :rd].contiguous()
        s_px = (s_c[:, :, None, None] + 20.0 * torch.randn(
            (1, rd, rh, rw), device=dev,
            generator=torch.Generator(dev).manual_seed(5))).contiguous()
        for agg in ("variance", "softmin"):
            for hyp_name, s_ in (("[D]", s_c), ("[D,H,W]", s_px)):
                a = (ref_m[:, :rh, :rw].contiguous(), srcs,
                     P[..., :rh, :rw].contiguous(),
                     Q[..., :rh, :rw].contiguous(), s_, temp, agg)
                compare(f"fused_cost_volume ragged {rh}x{rw} D{rd} C{c} "
                        f"{agg} {hyp_name}", sk.fused_cost_volume(*a),
                        sk.fused_cost_volume_plain(*a))
        del ref_m
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


#: the score head's timed shapes [B, C, D, H, W] and bias: MVSNet's head at
#: 1184x1600, Vis-MVSNet's stage 3 (its largest), CVP-MVSNet's finest level
HEAD_SHAPES = {"mvsnet 1184x1600": ((1, 8, 192, 296, 400), True),
               "vis stage 3": ((1, 8, 16, 592, 800), False),
               "cvp finest": ((1, 16, 8, 1184, 1600), True)}


def vis_heads(n: int) -> int:
    """Score-head launches of one Vis-MVSNet request with n views: in each
    of the three stages the n - 1 pairs' heads and the fused volume's."""
    return 3 * n


def phase1_conv_head(dev, results) -> dict:
    """The score head's kernel against its plain version (compare's limit)
    at HEAD_SHAPES in bf16, each timed by CUDA-graph replay beside its
    bound, the plain version and F.conv3d (cuDNN, the library that ran it
    before) on the same channels_last_3d input. Adds its entry to
    `results`: the first shape's numbers and each shape's under "shapes"."""
    shapes = {}
    gen = torch.Generator(dev).manual_seed(21)
    for name, (shape, has_bias) in HEAD_SHAPES.items():
        c = shape[1]
        x = torch.randn(shape, device=dev, generator=gen).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
        w = (torch.randn((1, c, 3, 3, 3), device=dev, generator=gen)
             / (27 * c) ** 0.5).to(torch.bfloat16)
        b = (torch.randn((1,), device=dev, generator=gen).to(torch.bfloat16)
             if has_bias else None)
        n0 = conv_head.conv3d_head.launches
        got = conv_head.conv3d_head(x, w, b)
        check(conv_head.conv3d_head.launches == n0 + 1, "head not launched")
        err = compare(f"conv3d_head {name} {tuple(shape)}", got,
                      conv_head.conv3d_head_plain(x, w, b))
        check(torch.equal(got, conv_head.conv3d_head(x, w, b)),
              f"conv3d_head {name}: two calls differ")
        ms = graph_ms(lambda: conv_head.conv3d_head(x, w, b), reps=10)
        plain_ms = cuda_ms(lambda: conv_head.conv3d_head_plain(x, w, b),
                           reps=2, warmup=1)
        library_ms = graph_ms(lambda: F.conv3d(x, w, b, padding=1), reps=5)
        b_ms, b_by = conv_head.conv3d_head_bound(x, w, b)
        shapes[name] = dict(shape=list(shape), max_abs_err=err, ms=ms,
                            bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms,
                            library_ms=library_ms)
        print(f"phase1 conv3d_head {name}: ms {ms:.4f} bound_ms {b_ms:.4f} "
              f"({b_by}, {100 * b_ms / ms:.1f} %) plain_ms {plain_ms:.3f} "
              f"library_ms {library_ms:.4f} (F.conv3d, cuDNN)", flush=True)
        del x, got
    torch.cuda.empty_cache()
    first = next(iter(shapes.values()))
    results["conv3d_head"] = dict(
        name="conv3d_head", route="cuda",
        source="wildmvs_torch/csrc/conv3d_head.cu",
        replaces="none (the JAX package leaves the convolution to XLA)",
        **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
        max_abs_err=max(v["max_abs_err"] for v in shapes.values()),
        shapes=shapes)
    return results


def sharpen(pred: Predictor) -> Predictor:
    """The predictor with its last conv (MVSNet's prob, CVP's prob0)
    scaled by PROB_GAIN."""
    model = pred.model
    last = (model.cost_reg_refine.prob0 if hasattr(model, "cost_reg_refine")
            else model.cost_regularization.prob)
    with torch.no_grad():
        last.weight.mul_(PROB_GAIN)
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
    check(counts["conv3d_head"] == len(scenes) + 1,
          f"MVSNet serving did not take one head launch a request: {counts}")
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
    b_ms, b_by = sk.bound(sk.fused_work(*a[:5]))
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


def warp_gradient_agreement(rec, batch, model, pairs=((0, 1), (0, 2)),
                            phase="phase5"):
    """The kernel path's source-feature gradients against the exact gather
    path's autograd (plane_sweep_warp in f32) at the same cotangent; entry
    j of `rec` warped source view pairs[j][1] into reference pairs[j][0].

    The kernel takes the bf16 cotangent, accumulates in f32 with atomics
    and rounds once to bf16; the gather transposes in f32. Held to one
    bf16 ulp (2^-7) of the gradient's scale in max and 2^-9 in mean."""
    D = model.num_depth
    proj = build_proj_matrices(scale_K(batch["K"], 0.25), batch["R"],
                               batch["t"])
    steps = torch.arange(D, dtype=torch.float32, device=proj.device)
    worst = 0.0
    for (ref, view), e in zip(pairs, rec):
        dmin, dmax = batch["depth_min"][:, ref], batch["depth_max"][:, ref]
        ref_depths = (dmin[:, None]
                      + ((dmax - dmin) / (D - 1))[:, None] * steps)
        src = e["src"].float().requires_grad_()
        fh, fw = src.shape[1:3]
        warped = plane_sweep_warp(src, proj[:, view], proj[:, ref],
                                  ref_depths, (fh, fw))
        (want,) = torch.autograd.grad(warped, src, e["g"].float())
        err = (e["df"].float() - want).abs()
        scale = want.abs().max().item()
        print(f"{phase} feature gradient reference {ref} view {view}: kernel"
              f" vs gather max {err.max().item():.6g} mean "
              f"{err.mean().item():.6g} (scale {scale:.4g}, limits "
              f"{2 ** -7 * scale:.4g} and {2 ** -9 * scale:.4g})",
              flush=True)
        check(scale > 0, "zero feature gradient")
        check(err.max().item() <= 2 ** -7 * scale
              and err.mean().item() <= 2 ** -9 * scale,
              f"reference {ref} view {view}: kernel feature gradient "
              f"disagrees with the gather path's")
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
          and counts["fused_cost_volume"] == 0
          and counts["conv3d_head"] == 0,
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
        work = sk.gwc_work(src, ref, *vis)
        n_live = work.live_samples
        b_ms, b_by = sk.bound(work)
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
        ms, events_ms = timed(lambda: sk.sweep_warp(src, *vis))
        plain_ms = cuda_ms(lambda: sk.sweep_warp_plain(src, *vis), reps=3,
                           warmup=1)
        library_ms = cuda_ms(lambda: F.grid_sample(
            src_nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True), reps=20, warmup=2)
        b_ms, b_by = sk.bound(sk.warp_work(src, *vis))
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
        b_ms, b_by = sk.bound(sk.warp_backward_work(
            *bwd, scale=scale, clamp=clamp))
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


def keep_first(store: dict, key):
    """A forward (pre-)hook that keeps the first call's inputs (or output)
    under `key` and returns None, so that it changes nothing: a later call
    of the module, on the kept inputs, neither overwrites them nor gets
    them back in place of its own result."""
    def hook(module, *args):
        if key not in store:
            store[key] = args[-1]
    return hook


def stage_forced(model, args, method):
    """Run `model` with `method`, then each stage again through the exact
    gather on the very inputs that stage received (features, cameras,
    slab). Returns {stage: (method's cost volumes, gather's, method's
    depth, gather's depth, the stage's hypothesis interval, its inputs)}.
    Holding each stage on its own inputs keeps the cascade's re-centring,
    which amplifies any difference between two runs, out of the
    comparison."""
    model.sweep_method = method
    inputs, outputs, costs, hooks = {}, {}, {}, []
    for i in (1, 2, 3):
        st = getattr(model, f"stage{i}")
        hooks += [
            st.register_forward_pre_hook(
                keep_first(inputs, i)),
            st.register_forward_hook(
                keep_first(outputs, i)),
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
                          inputs[i][5].flatten()[0].item(), inputs[i])
    finally:
        for hk in hooks:
            hk.remove()
        model.sweep_method = "auto"
    return got


def perturbed(f, gen):
    """f times (1 + 2^-8 noise): about one bf16 step on every value."""
    noise = torch.randn(f.shape, device=f.device, generator=gen)
    return (f.float() * (1 + 2.0 ** -8 * noise)).to(f.dtype)


def vis_agreement(pred, scene_args):
    """Each stage of the kernel path against the exact gather on that
    stage's own inputs: every pair's cost volume within bf16 rounding (max
    0.03, mean 0.002 of its scale) and the stage-3 depth within one
    stage-3 hypothesis interval on >= 95 % of pixels. Beside it, reported
    only, the stage's own sensitivity: the gather against the gather on
    features perturbed by about one bf16 step."""
    dev = pred.device
    args = [torch.as_tensor(np.asarray(a, np.float32), device=dev)[None]
            for a in scene_args]
    worst = {}
    gen = torch.Generator(dev).manual_seed(0)
    for stage, (cv, cv_g, est, est_g, interval, inp) in stage_forced(
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
        with torch.inference_mode():
            est_p = getattr(pred.model, f"stage{stage}")(
                perturbed(inp[0], gen), [perturbed(f, gen) for f in inp[1]],
                *inp[2:-1], "gather")[0]
        perr = (est_p.float() - est_g.float()).abs() / interval
        sens = (perr < 1).float().mean().item()
        print(f"phase6 stage {stage} gather on features x (1 + 2^-8 noise) "
              f"vs gather (the stage's own sensitivity, reported only): mean "
              f"{perr.mean().item():.4f} intervals, {sens:.4f} within 1, max "
              f"{perr.max().item():.3f}", flush=True)
        worst[f"stage{stage}_within_1"] = within
        worst[f"stage{stage}_sensitivity_within_1"] = sens
        if stage == 3:
            check(within >= 0.95, f"stage-3 depth within one interval on "
                  f"{within:.4f} of pixels")
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
                     "fused_cost_volume": 0, "sweep_gwc": 12 * 4,
                     "conv3d_head": vis_heads(5) * 4},
          f"Vis serving did not take 12 gwc and {vis_heads(5)} head "
          f"launches a request: {counts}")
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
                     "fused_cost_volume": 0, "sweep_gwc": 0,
                     "conv3d_head": 0},
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


# ---------------------------------------------------------------------------
# CVP-MVSNet
# ---------------------------------------------------------------------------

def record_levels(model):
    """Patch the CVP model's cost_volume so that each call keeps its level's
    inputs and cost volume in the returned list (coarse first). Returns
    (list, undo)."""
    levels = []
    real = model.cost_volume

    def recording(flevel, proj, hyp, method, *args):
        cv = real(flevel, proj, hyp, method, *args)
        levels.append(dict(flevel=[f.detach() for f in flevel], proj=proj,
                           hyp=hyp.detach(), cv=cv.detach()))
        return cv
    model.cost_volume = recording
    return levels, lambda: delattr(model, "cost_volume")


def cvp_agreement(pred, scene):
    """Each level of the fused path against the exact gather on that level's
    own inputs (features, projections, hypotheses): the cost volume within
    bf16 rounding (max 0.03, mean 0.002 of its scale), and the finest depth
    regressed from the gather's volume within one refinement interval of
    the kernel path's on >= 95 % of pixels. Returns the worst ratios and
    the level inputs (for the kernel timings)."""
    model = pred.model
    levels, undo = record_levels(model)
    try:
        out = pred(*scene)
    finally:
        undo()
    check(len(levels) == CVP_NSCALE, f"{len(levels)} levels recorded")
    worst = {}
    with torch.inference_mode():
        for i, lv in enumerate(levels):
            cv_g = model.cost_volume(lv["flevel"], lv["proj"], lv["hyp"],
                                     "gather").float()
            scale = cv_g.abs().max().item()
            err = (lv["cv"].float() - cv_g).abs()
            mx, mean = err.max().item() / scale, err.mean().item() / scale
            worst[f"level{i}"] = mx
            D, H, W = lv["cv"].shape[1:4]
            print(f"phase8 level {i} ({H}x{W}, D{D}) cost volume vs gather: "
                  f"max {mx:.5f} mean {mean:.6f} of the scale {scale:.4g}",
                  flush=True)
            check(mx <= 0.03 and mean <= 0.002,
                  f"CVP level {i} cost volume disagrees with the gather")
        _, depth_g = model.regress(cv_g.to(lv["cv"].dtype), lv["hyp"])
    interval = (lv["hyp"][:, 1] - lv["hyp"][:, 0]).flatten()[0].item()
    derr = np.abs(out["depth"] - depth_g[0].float().cpu().numpy()) / interval
    within = float((derr < 1.0).mean())
    print(f"phase8 finest depth vs the gather's on the same inputs: mean "
          f"{derr.mean():.4f} refinement intervals ({interval:.4f} mm), "
          f"{within:.4f} within 1, max {derr.max():.3f}", flush=True)
    check(within >= 0.95, f"CVP finest depth within one interval on "
          f"{within:.4f} of pixels")
    worst.update(finest_within_1=within, finest_mean_intervals=float(
        derr.mean()))
    return worst, levels


def cvp_level_kernel(lv, name):
    """fused_cost_volume at one recorded CVP eval level: held to its plain
    version, timed by CUDA-graph replay and bounded."""
    f = lv["flevel"]
    ref = f[0].to(torch.bfloat16).contiguous()
    srcs = torch.stack(f[1:], 1).to(torch.bfloat16).contiguous()
    fh, fw = ref.shape[1:3]
    planes = [sk.mvsnet_planes(lv["proj"][:, i], lv["proj"][:, 0], (fh, fw))
              for i in range(1, len(f))]
    P = torch.stack([p for p, _ in planes], 1)
    Q = torch.stack([q for _, q in planes], 1)
    s = lv["hyp"].contiguous()
    a = (ref, srcs, P, Q, s, None, "variance")
    out = sk.fused_cost_volume(*a)
    err = compare(f"fused_cost_volume CVP {name}", out,
                  sk.fused_cost_volume_plain(*a))
    ms = graph_ms(lambda: sk.fused_cost_volume(*a), reps=10)
    plain_ms = cuda_ms(lambda: sk.fused_cost_volume_plain(*a), reps=2,
                       warmup=1)
    share, plain_share, _ = tile_shares(
        lambda: sk.fused_cost_volume(*a), P, Q, s, (fh, fw),
        sk.fused_plan(ref.shape[-1], P.shape[1]))
    work = sk.fused_work(ref, srcs, P, Q, s)
    (b_ms, b_by), n_live = sk.bound(work), work.live_samples
    D = s.shape[1]
    shape = (f"{fh}x{fw} D{D} NV{P.shape[1]} C{ref.shape[-1]} "
             f"{'[D,H,W]' if s.dim() == 4 else '[D]'}")
    print(f"phase8 fused_cost_volume CVP {name} {shape}: ms {ms:.4f} "
          f"(CUDA-graph replay) plain_ms {plain_ms:.3f} bound_ms {b_ms:.4f} "
          f"({b_by}) live samples {n_live}; staged share {share:.4f} (plain "
          f"rule {plain_share:.4f})", flush=True)
    return dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                staged_share=share)


def phase8_cvp_serving(results):
    """CVP-MVSNet serving: Predictor(sweep_method="fused", cvp_nscale=5),
    bf16, random weights (seed 0, prob0 x PROB_GAIN): CVP_REQUESTS requests
    at 1184x1600 N5, then CVP_REQUESTS at 512x640 N3, 5 fused launches each
    and no other kernel; each level held to the gather; run_depthmaps; the
    fused kernel at the coarse and finest eval levels (added to
    `results`)."""
    pred = sharpen(Predictor(architecture="cvp_mvsnet", sweep_method="fused",
                             cvp_nscale=CVP_NSCALE))
    evals = [dtu_scene(20 + i, **EVAL) for i in range(CVP_REQUESTS)]
    heads = [dtu_scene(30 + i, **HEADLINE) for i in range(CVP_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    outs, eval_ms, head_ms = [], [], []
    for sc in evals:
        out, ms = request_ms(pred, sc)
        outs.append(out)
        eval_ms.append(ms)
    for sc in heads:
        out, ms = request_ms(pred, sc)
        outs.append(out)
        head_ms.append(ms)
    counts = sk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase8 launches {json.dumps(counts)}", flush=True)
    n_req = 2 * CVP_REQUESTS
    check(counts == {"sweep_warp": 0, "sweep_warp_backward": 0,
                     "fused_cost_volume": CVP_NSCALE * n_req,
                     "sweep_gwc": 0, "conv3d_head": CVP_NSCALE * n_req},
          f"CVP serving did not take {CVP_NSCALE} fused and head launches a "
          f"request: {counts}")
    for out, cfg in zip(outs, [EVAL] * CVP_REQUESTS
                        + [HEADLINE] * CVP_REQUESTS):
        check(out["depth"].shape == out["confidence"].shape
              == (cfg["h"], cfg["w"]) and np.isfinite(out["depth"]).all()
              and np.isfinite(out["confidence"]).all(), "bad CVP output")
    steady_eval = [request_ms(pred, evals[i % CVP_REQUESTS])[1]
                   for i in range(CVP_REQUESTS)]
    steady_head = [request_ms(pred, heads[i % CVP_REQUESTS])[1]
                   for i in range(CVP_REQUESTS)]
    print(f"phase8 CVP serving bf16 fused nscale {CVP_NSCALE}: "
          f"{EVAL['h']}x{EVAL['w']} N{EVAL['n']} ms per depthmap "
          f"{[round(t, 3) for t in eval_ms]} then "
          f"{[round(t, 3) for t in steady_eval]} (median "
          f"{np.median(steady_eval):.3f}); {HEADLINE['h']}x{HEADLINE['w']} "
          f"N{HEADLINE['n']} "
          f"{[round(t, 3) for t in head_ms]} then "
          f"{[round(t, 3) for t in steady_head]} (median "
          f"{np.median(steady_head):.3f}); peak memory {peak / 2**30:.3f} "
          f"GiB; depth mean {outs[0]['depth'].mean():.2f} std "
          f"{outs[0]['depth'].std():.2f}, confidence mean "
          f"{outs[0]['confidence'].mean():.3f}", flush=True)

    worst, levels = cvp_agreement(pred, evals[0])
    results["fused_cost_volume"]["cvp"] = {
        "coarse": cvp_level_kernel(levels[0], "coarse"),
        "finest": cvp_level_kernel(levels[-1], "finest")}
    del levels
    torch.cuda.empty_cache()
    prof = profile_step(lambda: pred(*evals[1]), "phase8")

    samples = []
    for i in range(2):
        imgs, K, R, t, dmin, dmax = heads[i]
        samples.append(dict(imgs=imgs, K=K, R=R, t=t, depth_min=dmin,
                            depth_max=dmax, filename=f"scan4/{i:08d}"))
    n0 = sk.fused_cost_volume.launches
    with tempfile.TemporaryDirectory() as tmp:
        run_depthmaps(samples, pred.model, tmp, cvp_nscale=CVP_NSCALE)
        files = sorted(p.name for p in Path(tmp).iterdir())
        check(files == ["finished.txt", "scan4_00000000_out.npz",
                        "scan4_00000001_out.npz"], f"files {files}")
        for f in files[1:]:
            with np.load(Path(tmp) / f) as z:
                check(z["depthmap"].shape == (HEADLINE["h"], HEADLINE["w"])
                      and np.isfinite(z["depthmap"]).all(), f"bad {f}")
    check(sk.fused_cost_volume.launches == n0 + 2 * CVP_NSCALE,
          "run_depthmaps skipped the fused kernel")
    print(f"phase8 run_depthmaps: {files}", flush=True)
    return counts, dict(
        first_request_ms=eval_ms, request_ms=steady_eval,
        request_ms_median=float(np.median(steady_eval)),
        headline_first_request_ms=head_ms, headline_request_ms=steady_head,
        headline_request_ms_median=float(np.median(steady_head)),
        peak_gib=peak / 2 ** 30, agreement=worst, **prof)


def record_cvp_warps(model, rec: list):
    """Patch the sweep_warp of models/mvsnet.py (whose sweep_cost_volume
    CVP shares) so that each call keeps its source, the gradient of its
    output (g) and of its source (df), and `model`'s cost_volume so that
    each level keeps its projections and hypotheses. Returns (undo,
    levels)."""
    real = mvsnet_module.sweep_warp
    levels, undo_levels = record_levels(model)

    def recording(src, P, Q, s):
        out = real(src, P, Q, s)
        entry = {"src": src.detach(), "level": len(levels)}
        out.register_hook(lambda g: entry.__setitem__("g", g))
        src.register_hook(lambda df: entry.__setitem__("df", df))
        rec.append(entry)
        return out
    mvsnet_module.sweep_warp = recording

    def undo():
        mvsnet_module.sweep_warp = real
        undo_levels()
    return undo, levels


def cvp_gradient_agreement(rec, levels):
    """The warp kernel's source-feature gradients (first step) against the
    exact gather's autograd (plane_sweep_warp in f32) at the same
    cotangent, at each level and source: max <= 2^-7, mean <= 2^-9 of the
    gradient's scale."""
    worst = 0.0
    n_src = len(rec) // len(levels)
    for j, e in enumerate(rec):
        lv = levels[e["level"]]
        i = j % n_src + 1
        src = e["src"].float().requires_grad_()
        hw = tuple(lv["flevel"][0].shape[1:3])
        warped = plane_sweep_warp(src, lv["proj"][:, i], lv["proj"][:, 0],
                                  lv["hyp"], hw)
        (want,) = torch.autograd.grad(warped, src, e["g"].float())
        err = (e["df"].float() - want).abs()
        scale = want.abs().max().item()
        print(f"phase9 feature gradient level {e['level']} source {i}: "
              f"kernel vs gather max {err.max().item():.6g} mean "
              f"{err.mean().item():.6g} (scale {scale:.4g})", flush=True)
        check(scale > 0 and err.max().item() <= 2 ** -7 * scale
              and err.mean().item() <= 2 ** -9 * scale,
              f"CVP level {e['level']} source {i}: the kernel's feature "
              f"gradient disagrees with the gather's")
        worst = max(worst, err.max().item() / scale)
    return worst


def phase9_cvp_training(dev):
    """CVP-MVSNet training: TRAIN_STEPS bf16 steps at 512x640 N3, nscale 2,
    through the warp kernel and its backward (2 levels x 2 sources a
    step); eval and test steps (fused launches); a checkpoint served by
    Predictor(sweep_method="fused")."""
    cfg = TrainConfig(architecture="cvp_mvsnet", dataset="synthetic",
                      lr=1e-3, train_dtype="bfloat16")
    ds = SyntheticMVSDataset(num_samples=1, num_views=HEADLINE["n"],
                             height=HEADLINE["h"], width=HEADLINE["w"])
    sample = collate([ds[0]])
    batch = T.batch_to_device(sample, dev)
    state = T.create_train_state(cfg, dev)
    params = list(state.model.parameters())
    check(all(p.dtype == torch.float32 for p in params),
          "CVP training parameters are not f32")
    rec = []
    undo, levels = record_cvp_warps(state.model, rec)
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
        check(bool(grads_finite), f"CVP step {i}: a gradient is not finite")
        if i == 0:
            undo()
    counts = sk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase9 launches {json.dumps(counts)}", flush=True)
    per_step = state.model.nscale * (HEADLINE["n"] - 1)
    check(counts == {"sweep_warp": per_step * TRAIN_STEPS,
                     "sweep_warp_backward": per_step * TRAIN_STEPS,
                     "fused_cost_volume": 0, "sweep_gwc": 0,
                     "conv3d_head": 0},
          f"CVP training did not take the warp kernels: {counts}")
    check(len(rec) == per_step and len(levels) == state.model.nscale
          and all("df" in e and "g" in e for e in rec),
          "the first CVP step's warps were not recorded")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"CVP losses {losses}")
    steady = float(np.median(times[1:]))
    print(f"phase9 CVP training 512x640 N3 nscale {state.model.nscale} bf16 "
          f"(f32 parameters): losses {[round(x, 4) for x in losses]}; ms per "
          f"step first {times[0]:.3f} then {[round(t, 3) for t in times[1:]]}"
          f" (median {steady:.3f}); peak memory {peak / 2**30:.3f} GiB",
          flush=True)
    grad_err = cvp_gradient_agreement(rec, levels)
    del rec, levels
    prof = profile_step(lambda: T.train_step(state, batch, cfg), "phase9")

    n0 = sk.fused_cost_volume.launches
    val = T.eval_step(state, batch, cfg)["val_loss"].item()
    test = {k: v.item() for k, v in T.test_step(state, batch, cfg).items()}
    check(sk.fused_cost_volume.launches == n0 + state.model.nscale + 4,
          "CVP eval and test steps skipped the fused kernel")
    check(np.isfinite(val) and all(np.isfinite(list(test.values()))),
          f"CVP eval {val} test {test}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(tmp, 0, state, cfg.architecture)
        pred = Predictor(ckpt, sweep_method="fused")
        out = pred(*(sample[k][0] for k in ("imgs", "K", "R", "t",
                                            "depth_min", "depth_max")))
    check(out["depth"].shape == (HEADLINE["h"], HEADLINE["w"])
          and np.isfinite(out["depth"]).all(),
          "the trained CVP checkpoint served a bad depthmap")
    print(f"phase9 eval_step val_loss {val:.4f}; test_step {test}; "
          f"checkpoint served: depth mean {out['depth'].mean():.3f}",
          flush=True)
    return counts, dict(
        losses=losses, first_step_ms=times[0], step_ms_median=steady,
        step_ms=times, peak_gib=peak / 2 ** 30, val_loss=val, test=test,
        feature_grad_max_rel_err=grad_err, **prof)


# ---------------------------------------------------------------------------
# Unsupervised training
# ---------------------------------------------------------------------------

UNSUP_STEPS = 4                 # phase 12b's steps an architecture


def headline_batch(dev, samples: int = 1):
    """Synthetic training samples at the headline shape, on `dev`."""
    ds = SyntheticMVSDataset(num_samples=samples, num_views=HEADLINE["n"],
                             height=HEADLINE["h"], width=HEADLINE["w"])
    return T.batch_to_device(collate([ds[i] for i in range(samples)]), dev)


def occ_mvsnet_config(**kw):
    """Phase 12a's (and 13a's) occlusion-masked MVSNet recipe."""
    return TrainConfig(architecture="mvsnet", dataset="synthetic",
                       num_depth=NUM_DEPTH, lr=1e-3, train_dtype="bfloat16",
                       supervised=False, occ_masking=True, geom_clamping=0.05,
                       **kw)


def unsup_steps(state, batch, cfg, steps, phase, first_step=None):
    """`steps` train steps on one batch: finite gradients at each, and the
    launch counts of the loop alone (read just after it). first_step(state)
    runs after step 0. Returns (counts, losses, ms per step, peak bytes)."""
    params = list(state.model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = T.train_step(state, batch, cfg)
        grads_finite = torch.stack([torch.isfinite(p.grad).all()
                                    for p in params]).all()
        losses.append(m["train_loss"].item())
        times.append((time.perf_counter() - t0) * 1e3)
        check(bool(grads_finite), f"{phase} step {i}: a gradient is not "
              f"finite")
        if i == 0 and first_step is not None:
            first_step(state)
    counts = sk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"{phase} launches {json.dumps(counts)}", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{phase} losses {losses}")
    return counts, losses, times, peak


def unsup_report(phase, what, losses, times, peak, **extra):
    steady = float(np.median(times[1:]))
    print(f"{phase} {what}: losses {[round(x, 5) for x in losses]}; ms per "
          f"step first {times[0]:.3f} then {[round(t, 3) for t in times[1:]]}"
          f" (median {steady:.3f}); peak memory {peak / 2**30:.3f} GiB",
          flush=True)
    return dict(losses=losses, first_step_ms=times[0], step_ms_median=steady,
                step_ms=times, peak_gib=peak / 2 ** 30, **extra)


def phase12_unsup_training(dev, supervised_peak_gib):
    """Unsupervised (photometric) training, the paper's recipe. 12a: MVSNet
    at 512x640 N3 D192, bf16 compute, f32 parameters, Adam lr 1e-3,
    occlusion-masked (every view as the reference, geom_clamping 0.05)
    through the warp kernel and its backward: TRAIN_STEPS steps, 6 + 6
    launches a step, the first step's feature gradients (all six warps,
    references 0-2) against the gather's autograd, one profiled step, the
    peak memory beside phase 5's, and an occlusion-masked eval step (3
    fused launches). 12b: Vis-MVSNet (32, 16, 8) occlusion-masked (18 + 18
    a step) and CVP-MVSNet nscale 2 unmasked (4 + 4), UNSUP_STEPS steps
    each. 12c: `phase12c_default_flags`. Returns the summed counts of the
    step loops (the "unsup_training" path) and the results."""
    n = HEADLINE["n"]
    batch = headline_batch(dev)
    cfg = occ_mvsnet_config()
    state = T.create_train_state(cfg, dev)
    rec = []
    undo = record_warps(rec)
    counts, losses, times, peak = unsup_steps(
        state, batch, cfg, TRAIN_STEPS, "phase12a",
        first_step=lambda st: undo())
    per_step = n * (n - 1)
    check(counts == {"sweep_warp": per_step * TRAIN_STEPS,
                     "sweep_warp_backward": per_step * TRAIN_STEPS,
                     "fused_cost_volume": 0, "sweep_gwc": 0,
                     "conv3d_head": 0},
          f"occlusion-masked MVSNet training did not take the warp "
          f"kernels: {counts}")
    check(len(rec) == per_step and all("df" in e and "g" in e for e in rec),
          "the first occlusion-masked step's warps were not recorded")
    mvsnet = unsup_report(
        "phase12a", f"occlusion-masked MVSNet {HEADLINE['h']}x"
        f"{HEADLINE['w']} N{n} D{NUM_DEPTH} "
        f"bf16 (f32 parameters; phase 5's supervised peak "
        f"{supervised_peak_gib:.3f} GiB)", losses, times, peak,
        supervised_peak_gib=supervised_peak_gib)
    pairs = [(r, v) for r in range(n) for v in range(n) if v != r]
    mvsnet["feature_grad_max_err"] = warp_gradient_agreement(
        rec, batch, state.model, pairs, "phase12a")
    del rec
    mvsnet.update(profile_step(lambda: T.train_step(state, batch, cfg),
                               "phase12a"))
    n0 = sk.fused_cost_volume.launches
    val = T.eval_step(state, batch, cfg)["val_loss"].item()
    check(sk.fused_cost_volume.launches == n0 + n and np.isfinite(val),
          f"occlusion-masked eval step: val_loss {val}, "
          f"{sk.fused_cost_volume.launches - n0} fused launches")
    mvsnet["val_loss"] = val
    print(f"phase12a occlusion-masked eval_step val_loss {val:.5f}",
          flush=True)
    del state
    torch.cuda.empty_cache()

    results = {"mvsnet_occ": mvsnet}
    total = dict(counts)
    for arch, occ, per in (("vis_mvsnet", True, 3 * n * (n - 1)),
                           ("cvp_mvsnet", False, 2 * (n - 1))):
        cfg = TrainConfig(architecture=arch, dataset="synthetic", lr=1e-3,
                          train_dtype="bfloat16", supervised=False,
                          occ_masking=occ, geom_clamping=0.05)
        state = T.create_train_state(cfg, dev)
        counts, losses, times, peak = unsup_steps(
            state, batch, cfg, UNSUP_STEPS, "phase12b")
        check(counts == {"sweep_warp": per * UNSUP_STEPS,
                         "sweep_warp_backward": per * UNSUP_STEPS,
                         "fused_cost_volume": 0, "sweep_gwc": 0,
                         "conv3d_head": 0},
              f"unsupervised {arch} did not take the warp kernels: {counts}")
        name = f"{arch}_{'occ' if occ else 'unsup'}"
        results[name] = unsup_report(
            "phase12b", f"{'occlusion-masked' if occ else 'unsupervised'} "
            f"{arch} {HEADLINE['h']}x{HEADLINE['w']} N{n} bf16", losses,
            times, peak)
        results[name].update(profile_step(
            lambda: T.train_step(state, batch, cfg), f"phase12b {arch}"))
        total = {k: total[k] + counts[k] for k in total}
        del state
        torch.cuda.empty_cache()
    results["default_flags"] = phase12c_default_flags(dev)
    return total, results


#: phase 12c's limits, written before its first run on the card: under
#: PyTorch's default TF32 flags the DSSIM maps within DEFAULT_FLAGS_REL of
#: their scale of the maps with both flags off (f32 rounding of the
#: 121-tap window sums, magnified by the cancellation in sigma^2 =
#: blur(x^2) - mu^2, stays far below it; TF32's 10-bit mantissa does not),
#: the loss within DEFAULT_FLAGS_REL relative, and the six warps' feature
#: gradients within phase 12a's limits of each other (2^-7 of the scale in
#: max, 2^-9 in mean: the backward's atomics add in a varying order, so two
#: runs under one setting differ too).
DEFAULT_FLAGS_REL = 1e-5


def record_dssim(rec: list):
    """Patch the photometric losses' dssim so that each call appends its
    map, detached, to rec. Returns the undo."""
    real = photometric_module.dssim

    def recording(img1, img2, *args, **kwargs):
        out = real(img1, img2, *args, **kwargs)
        rec.append(out.detach().clone())
        return out

    photometric_module.dssim = recording
    return lambda: setattr(photometric_module, "dssim", real)


def flagged_step(dev, batch, cfg, default_flags: bool):
    """One occlusion-masked MVSNet step from phase 12a's seeded weights,
    under PyTorch's default TF32 flags or with both off (main's setting).
    Returns (loss, the step's DSSIM maps, its warps' source-feature
    gradients)."""
    state = T.create_train_state(cfg, dev)
    maps, warps = [], []
    undo_maps, undo_warps = record_dssim(maps), record_warps(warps)
    try:
        with (torch_default_precision() if default_flags
              else contextlib.nullcontext()):
            state, m = T.train_step(state, batch, cfg)
            loss = m["train_loss"].item()
    finally:
        undo_maps()
        undo_warps()
    return loss, maps, [e["df"].float() for e in warps]


def rel_max(got, want) -> float:
    return (got - want).abs().max().item() / want.abs().max().item()


def phase12c_default_flags(dev):
    """Phase 12a's step under the flags `train.cli --unsupervised` runs
    with (PyTorch's defaults: cuDNN convolutions may take TF32) against
    both flags off: the step with flags off, with the defaults, and with
    flags off again (the run-to-run spread). The DSSIM maps, the loss and
    the six warps' feature gradients within DEFAULT_FLAGS_REL and phase
    12a's gradient limits; the DSSIM alone on two views at the loss
    resolution (128x160) under both settings, and its ms (forward and
    backward) under the defaults."""
    batch = headline_batch(dev)
    cfg = occ_mvsnet_config()
    off = flagged_step(dev, batch, cfg, False)
    on = flagged_step(dev, batch, cfg, True)
    again = flagged_step(dev, batch, cfg, False)
    check(len(on[1]) == len(off[1]) == len(again[1]) > 0
          and len(on[2]) == len(off[2]) == 6,
          f"phase12c recorded {len(off[1])}/{len(on[1])} DSSIM maps, "
          f"{len(off[2])}/{len(on[2])} warps")
    res = dict(
        dssim_rel=max(rel_max(a, b) for a, b in zip(on[1], off[1])),
        dssim_rel_rerun=max(rel_max(a, b) for a, b in zip(again[1], off[1])),
        loss_rel=abs(on[0] - off[0]) / abs(off[0]),
        loss_rel_rerun=abs(again[0] - off[0]) / abs(off[0]))
    for tag, run in (("grad", on), ("grad_rerun", again)):
        res[tag + "_max_rel"] = max(rel_max(a, b)
                                    for a, b in zip(run[2], off[2]))
        res[tag + "_mean_rel"] = max(
            (a - b).abs().mean().item() / b.abs().max().item()
            for a, b in zip(run[2], off[2]))
    h, w = HEADLINE["h"] // 4, HEADLINE["w"] // 4
    views = resize_bilinear(batch["imgs"][0], (h, w))
    a, b = views[0:1], views[1:2].clone().requires_grad_()
    with torch.no_grad():
        want = dssim(a, b)
        with torch_default_precision():
            got = dssim(a, b)
    res["dssim_alone_rel"] = rel_max(got, want)
    with torch_default_precision():
        res["dssim_ms"] = cuda_ms(lambda: dssim(a, b).sum().backward(), 20)
    print(f"phase12c default TF32 flags vs both off (off again): DSSIM maps "
          f"{res['dssim_rel']:.3g} ({res['dssim_rel_rerun']:.3g}) of their "
          f"scale, alone {res['dssim_alone_rel']:.3g}; loss "
          f"{res['loss_rel']:.3g} ({res['loss_rel_rerun']:.3g}) relative; "
          f"feature gradients max {res['grad_max_rel']:.3g} "
          f"({res['grad_rerun_max_rel']:.3g}), mean "
          f"{res['grad_mean_rel']:.3g} ({res['grad_rerun_mean_rel']:.3g}) "
          f"of their scale; limits {DEFAULT_FLAGS_REL:g}, {DEFAULT_FLAGS_REL:g}"
          f", {2 ** -7:.4g} and {2 ** -9:.4g}; DSSIM {h}x{w} forward and "
          f"backward {res['dssim_ms']:.4f} ms (defaults)", flush=True)
    check(res["dssim_rel"] <= DEFAULT_FLAGS_REL
          and res["dssim_alone_rel"] <= DEFAULT_FLAGS_REL,
          "the default TF32 flags move the DSSIM map")
    check(res["loss_rel"] <= DEFAULT_FLAGS_REL,
          "the default TF32 flags move the unsupervised loss")
    check(res["grad_max_rel"] <= 2 ** -7 and res["grad_mean_rel"] <= 2 ** -9,
          "the default TF32 flags move the feature gradients")
    return res


# ---------------------------------------------------------------------------
# The rectified sweep and the reconstruction pipeline
# ---------------------------------------------------------------------------

def rect_fused_inputs(dev, cfg, scale, C, D, per_pixel, nv=4):
    """The rectified and the exact sweep of one reference shape of the
    DTU-like rig (the image cfg at 1/scale, NV sources, seeded bf16
    features; per-pixel hypotheses: +-D/2 refinement steps of 1.68 mm
    around a tilted plane through the origin). Returns (rect: ref,
    canvases [1, NV, H+2M, W+2M, C], P, Q, s = 1/d; exact: srcs, P, Q,
    depth; the canvas margin M)."""
    n, h, w = nv + 1, cfg["h"] // scale, cfg["w"] // scale
    _, K, R, t, _, _ = dtu_scene(0, n, cfg["h"], cfg["w"], cfg["f"])
    k = scale_K(torch.from_numpy(K)[None].to(dev), 1.0 / scale)
    proj = build_proj_matrices(k, torch.from_numpy(R)[None].to(dev),
                               torch.from_numpy(t)[None].to(dev))
    rng = np.random.default_rng(7)
    feats = torch.from_numpy(rng.standard_normal(
        (n, h, w, C), dtype=np.float32)).to(dev, torch.bfloat16)
    if per_pixel:
        ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                                torch.arange(w, device=dev), indexing="ij")
        base = 650.0 + 40.0 * (xs / w - 0.5) + 30.0 * (ys / h - 0.5)
        steps = torch.arange(D, device=dev) - D // 2
        depth = (base[None] + 1.68 * steps[:, None, None])[None]
    else:
        depth = torch.linspace(*DEPTH_RANGE, D, device=dev)[None]
    depth = depth.float().contiguous()
    s = (1.0 / depth).contiguous()
    M = rs.rect_margin((h, w))
    A, e = rs.rect_decompose(proj[:, 1:], proj[:, :1])
    shift = rs.rect_shift(e, s[:, None], (h, w))
    ok = rs.rect_coverage_ok(e, A, s[:, None], (h, w), M, (h, w), shift)
    check(bool(ok.all()), f"the rect canvas does not cover the {h}x{w} "
          f"sweep")
    canvas = rs.rect_resample(feats[1:], A[0], (h, w), M, shift[0])[None]
    P, Q = rs.rect_planes(e, (h, w), M, shift)
    planes = [sk.mvsnet_planes(proj[:, i], proj[:, 0], (h, w))
              for i in range(1, n)]
    Px = torch.stack([p for p, _ in planes], 1)
    Qx = torch.stack([q for _, q in planes], 1)
    ref = feats[:1].contiguous()
    return ((ref, canvas.contiguous(), P, Q, s),
            (feats[None, 1:].contiguous(), Px, Qx, depth), M,
            (feats[1:], A[0], shift[0]))


def phase1_rect_kernels(dev, results):
    """fused_cost_volume on the rect canvases (variance and softmin) at
    MVSNet eval 296x400 NV4 C32 D192 [D], CVP coarse 74x100 NV4 C16 D96
    [D] and CVP finest 1184x1600 NV4 C16 D8 [D,H,W], and sweep_gwc at
    unit scale with no clamp on the Vis eval stage-3 canvas (592x800 C32
    D16 [D,H,W]), each held to its plain version within 2^-7 of the scale
    and timed by CUDA-graph replay beside the exact path at the same
    reference shape and the canvas resample."""
    temp = torch.full((1,), 0.05, device=dev)
    cases = {"MVSNet eval": (EVAL, 4, 32, NUM_DEPTH, False),
             "CVP coarse": (EVAL, 16, 16, 96, False),
             "CVP finest": (EVAL, 1, 16, 8, True)}
    rect = {}
    for name, (cfg, scale, C, D, per_pixel) in cases.items():
        (ref, canvas, P, Q, s), (srcs, Px, Qx, depth), M, rsm = \
            rect_fused_inputs(dev, cfg, scale, C, D, per_pixel)
        H, W = ref.shape[1:3]
        for agg in ("variance", "softmin"):
            a = (ref, canvas, P, Q, s, temp, agg)
            err = compare(f"fused_cost_volume rect {name} {agg}",
                          sk.fused_cost_volume(*a),
                          sk.fused_cost_volume_plain(*a))
        a = (ref, canvas, P, Q, s, None, "variance")
        reps = 10 if H * W * D > 1e6 else 50
        ms = graph_ms(lambda: sk.fused_cost_volume(*a), reps=reps)
        exact_ms = graph_ms(lambda: sk.fused_cost_volume(
            ref, srcs, Px, Qx, depth, None, "variance"), reps=reps)
        resample_ms = cuda_ms(lambda: rs.rect_resample(
            rsm[0], rsm[1], (H, W), M, rsm[2]), reps=5, warmup=1)
        plain_ms = cuda_ms(lambda: sk.fused_cost_volume_plain(*a), reps=2,
                           warmup=1)
        share, plain_share, _ = tile_shares(
            lambda: sk.fused_cost_volume(*a), P, Q, s,
            tuple(canvas.shape[2:4]), sk.fused_plan(C, P.shape[1]))
        exact_share, _, _ = tile_shares(
            lambda: sk.fused_cost_volume(ref, srcs, Px, Qx, depth, None,
                                         "variance"), Px, Qx, depth,
            (H, W), sk.fused_plan(C, P.shape[1]))
        work = sk.fused_work(ref, canvas, P, Q, s)
        (b_ms, b_by), n_live = sk.bound(work), work.live_samples
        shape = (f"{H}x{W} D{D} NV{P.shape[1]} C{C} "
                 f"{'[D,H,W]' if per_pixel else '[D]'} on "
                 f"{canvas.shape[2]}x{canvas.shape[3]} canvases")
        rect[name] = dict(shape=shape, max_abs_err=err, ms=ms,
                          exact_ms=exact_ms, resample_ms=resample_ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          staged_share=share, exact_staged_share=exact_share)
        print(f"phase1 fused_cost_volume rect {name} {shape}: ms {ms:.4f} "
              f"(exact path {exact_ms:.4f}, staged {exact_share:.4f}) + "
              f"canvas resample {resample_ms:.4f} ms; plain_ms "
              f"{plain_ms:.3f} bound_ms {b_ms:.4f} ({b_by}) live samples "
              f"{n_live}; staged share {share:.4f} (plain rule "
              f"{plain_share:.4f})", flush=True)
        del ref, canvas, P, Q, s, srcs, Px, Qx, depth, rsm, a
        torch.cuda.empty_cache()
    results["fused_cost_volume"]["rect"] = rect

    # sweep_gwc on the Vis eval stage-3 canvas (the exact path's inputs
    # from vis_kernel_inputs, the same pair, slab and features)
    cfg = dict(n=5, h=EVAL["h"], w=EVAL["w"], f=EVAL["f"])
    src, ref, Px, Qx, s, scale, clamp = vis_kernel_inputs(dev, cfg, 3, 16,
                                                          True)
    (_, K, R, t, _, _), _ = vis_scene(**cfg)
    H, W = ref.shape[1:3]
    Ks = scale_K(torch.from_numpy(K).to(dev), 0.5)
    Rt, tt = torch.from_numpy(R).to(dev), torch.from_numpy(t).to(dev)
    A, e = rs.vis_rect_decompose(Ks[0], Rt[0], tt[0], Ks[1], Rt[1], tt[1])
    M = rs.rect_margin((H, W))
    shift = rs.rect_shift(e[None], s[:, None], (H, W), 0.5)[0]
    check(bool(rs.rect_coverage_ok(e, A, s[0], (H, W), M, (H, W), shift,
                                   0.5)), "the Vis stage-3 canvas")
    canvas = rs.vis_rect_resample(src, A[None], (H, W), M, shift[None])
    P, Q = rs.rect_planes(e[None], (H, W), M, shift[None], 0.5)
    a = (canvas, ref, P, Q, s, sk.UNIT_SCALE, None)
    out = sk.sweep_gwc(*a)
    err = compare("sweep_gwc rect Vis eval stage 3", out,
                  sk.sweep_gwc_plain(*a))
    ms = graph_ms(lambda: sk.sweep_gwc(*a))
    exact_ms = graph_ms(lambda: sk.sweep_gwc(src, ref, Px, Qx, s, scale,
                                             clamp))
    resample_ms = cuda_ms(lambda: rs.vis_rect_resample(
        src, A[None], (H, W), M, shift[None]), reps=5, warmup=1)
    plain_ms = cuda_ms(lambda: sk.sweep_gwc_plain(*a), reps=3, warmup=1)
    share, plain_share, _ = tile_shares(
        lambda: sk.sweep_gwc(*a), P, Q, s, tuple(canvas.shape[1:3]),
        sk.footprint_plan(src.shape[-1]))
    work = sk.gwc_work(canvas, ref, P, Q, s)
    n_live, D = work.live_samples, s.shape[1]
    b_ms, b_by = sk.bound(work)
    shape = (f"{H}x{W} D{D} C{src.shape[-1]} [D,H,W] on "
             f"{canvas.shape[1]}x{canvas.shape[2]} canvas")
    results["sweep_gwc"]["rect"] = dict(
        shape=shape, max_abs_err=err, ms=ms, exact_ms=exact_ms,
        resample_ms=resample_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, staged_share=share)
    print(f"phase1 sweep_gwc rect Vis eval stage 3 {shape} (unit scale, no "
          f"clamp): ms {ms:.4f} (exact path {exact_ms:.4f}) + canvas "
          f"resample {resample_ms:.4f} ms; plain_ms {plain_ms:.3f} bound_ms "
          f"{b_ms:.4f} ({b_by}) live samples {n_live}; staged share "
          f"{share:.4f} (plain rule {plain_share:.4f})", flush=True)
    return results


def stage3_forced(model, args):
    """The Vis model's stage-3 depth under its own sweep_method and that
    stage again through the exact kernel path ("gwc") on the very inputs
    it received. Returns (depth, exact depth, the stage's interval)."""
    seen = {}
    st = model.stage3
    hooks = [st.register_forward_pre_hook(
                 lambda m, a: seen.__setitem__("in", a)),
             st.register_forward_hook(
                 lambda m, a, o: seen.__setitem__("out", o))]
    try:
        with torch.inference_mode():
            model(*args)
    finally:
        for hk in hooks:
            hk.remove()
    with torch.inference_mode():
        exact, _, _ = st(*seen["in"][:-1], "gwc")
    return seen["out"][0], exact, seen["in"][5].flatten()[0].item()


def phase10_rect_serving():
    """The rectified sweep's serving path: CVP-MVSNet under its eval
    default (Predictor(architecture="cvp_mvsnet", cvp_nscale=5) -> "rect",
    random weights, prob0 x PROB_GAIN) at 1184x1600 N5, CVP_REQUESTS
    requests, 5 fused launches each; the trained Vis asset with
    sweep_method="rect" at 1184x1600 N5, 12 sweep_gwc launches a request.
    Each CVP level that took the rect path, its depth against the depth
    regressed from the exact fused volume on the same level inputs (the
    coarse level and one refinement level at least must take it); Vis
    stage 3 against the exact gwc path on its inputs; request times beside
    the exact paths'."""
    pred = sharpen(Predictor(architecture="cvp_mvsnet",
                             cvp_nscale=CVP_NSCALE))
    check(pred.model.sweep_method == "rect", "CVP's eval default")
    vis = Predictor(VIS_ASSET, sweep_method="rect")
    evals = [dtu_scene(20 + i, **EVAL) for i in range(CVP_REQUESTS)]
    vcfg = dict(n=5, h=EVAL["h"], w=EVAL["w"], f=EVAL["f"])
    vscene, vdepths = vis_scene(**vcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    outs, cvp_first = [], []
    for sc in evals:
        out, ms = request_ms(pred, sc)
        outs.append(out)
        cvp_first.append(ms)
    vis_out, vis_first = request_ms(vis, vscene)
    vis_first = [vis_first] + [request_ms(vis, vscene)[1] for _ in range(3)]
    counts = sk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase10 launches {json.dumps(counts)}", flush=True)
    check(counts == {"sweep_warp": 0, "sweep_warp_backward": 0,
                     "fused_cost_volume": CVP_NSCALE * CVP_REQUESTS,
                     "sweep_gwc": 12 * 4,
                     "conv3d_head": CVP_NSCALE * CVP_REQUESTS
                     + vis_heads(5) * 4},
          f"rect serving did not take {CVP_NSCALE} fused and head launches "
          f"a CVP request and 12 gwc and {vis_heads(5)} head launches a Vis "
          f"request: {counts}")
    for out in outs:
        check(out["depth"].shape == out["confidence"].shape
              == (EVAL["h"], EVAL["w"]) and np.isfinite(out["depth"]).all()
              and np.isfinite(out["confidence"]).all(), "bad CVP output")
    check(np.isfinite(vis_out["depth"]).all()
          and vis_out["depth"].shape == (EVAL["h"] // 2, EVAL["w"] // 2),
          "bad Vis rect output")

    steady = [request_ms(pred, evals[i % CVP_REQUESTS])[1]
              for i in range(CVP_REQUESTS)]
    exact = sharpen(Predictor(architecture="cvp_mvsnet",
                              sweep_method="fused", cvp_nscale=CVP_NSCALE))
    request_ms(exact, evals[0])
    exact_ms = [request_ms(exact, evals[i % CVP_REQUESTS])[1]
                for i in range(CVP_REQUESTS)]
    del exact
    # each level on the rect path against the exact fused volume on the
    # same level inputs (features, projections, hypotheses); a level whose
    # coverage probe failed took the exact path itself
    levels, undo = record_levels(pred.model)
    resampled, real = [], rs.rect_resample
    rs.rect_resample = lambda src, *a: (resampled.append(src.shape[1]),
                                        real(src, *a))[1]
    try:
        pred(*evals[0])
    finally:
        undo()
        rs.rect_resample = real
    rect_levels = {}
    with torch.inference_mode():
        for i, lv in enumerate(levels):
            H, W = lv["flevel"][0].shape[1:3]
            if H not in resampled:
                continue
            hyp = lv["hyp"]
            _, d_rect = pred.model.regress(lv["cv"], hyp)
            _, d_x = pred.model.regress(pred.model.cost_volume(
                lv["flevel"], lv["proj"], hyp, "fused"), hyp)
            step = (hyp[0, 1] - hyp[0, 0]).abs()      # [] or per pixel
            derr = ((d_rect[0] - d_x[0]).abs() / step).cpu().numpy()
            inner = derr[4:-4, 4:-4]
            rect_levels[f"level{i}"] = dict(
                shape=f"{H}x{W} D{hyp.shape[1]}",
                interior_mean_intervals=float(inner.mean()),
                within_1=float((derr < 1.0).mean()))
            print(f"phase10 CVP level {i} ({H}x{W}, D{hyp.shape[1]}) rect "
                  f"depth vs the exact volume on the same inputs: interior "
                  f"mean {inner.mean():.4f} intervals, "
                  f"{(derr < 1.0).mean():.4f} within 1, max "
                  f"{derr.max():.3f}", flush=True)
            # the JAX package's rect bound (tests/test_rect_sweep.py:
            # 300-303): an interior mean under 2 hypothesis intervals
            check(inner.mean() < 2.0, f"CVP rect level {i}: interior mean "
                  f"{inner.mean()} intervals from the exact path")
    print(f"phase10 CVP levels on the rect path (source heights): "
          f"{resampled}; the others failed the coverage probe and took the "
          f"exact path", flush=True)
    check(levels[0]["flevel"][0].shape[1] in resampled
          and len(rect_levels) >= 2, "CVP rect: the coarse level and at "
          "least one per-pixel refinement level must take the rectified "
          "sweep")
    print(f"phase10 CVP rect nscale {CVP_NSCALE} {EVAL['h']}x{EVAL['w']} "
          f"N{EVAL['n']} bf16: ms per depthmap "
          f"{[round(t, 3) for t in cvp_first]} then "
          f"{[round(t, 3) for t in steady]} (median "
          f"{np.median(steady):.3f}); the exact fused path "
          f"{[round(t, 3) for t in exact_ms]} (median "
          f"{np.median(exact_ms):.3f}); peak memory {peak / 2**30:.3f} GiB",
          flush=True)
    del levels
    torch.cuda.empty_cache()
    prof = profile_step(lambda: pred(*evals[1]), "phase10")
    del pred
    torch.cuda.empty_cache()

    # Vis rect: stage 3 against the exact gwc path on its own inputs
    args = [torch.as_tensor(np.asarray(a, np.float32), device=vis.device)[None]
            for a in vscene]
    est, est_x, interval3 = stage3_forced(vis.model, args)
    verr = ((est[0].float() - est_x[0].float()).abs()
            / interval3).cpu().numpy()
    vwithin = float((verr < 1.0).mean())
    vinner = float(verr[4:-4, 4:-4].mean())
    vis_steady = vis_first[1:]
    auto = Predictor(VIS_ASSET)
    out_x, _ = request_ms(auto, vscene)
    auto_ms = [request_ms(auto, vscene)[1] for _ in range(3)]
    del auto
    gt = vdepths[0, ::2, ::2]
    gt_err = np.abs(vis_out["depth"] - gt) / interval3
    gt_err_x = np.abs(out_x["depth"] - gt) / interval3
    print(f"phase10 Vis rect 1184x1600 N5 (64,32,16) bf16, trained asset: "
          f"ms per depthmap {[round(t, 3) for t in vis_first]} (steady "
          f"median {np.median(vis_steady):.3f}); the exact gwc path "
          f"{[round(t, 3) for t in auto_ms]} (median "
          f"{np.median(auto_ms):.3f}); stage 3 vs the exact path on its "
          f"inputs: mean {verr.mean():.4f} intervals ({interval3:.4f} mm), "
          f"interior {vinner:.4f}, {vwithin:.4f} within 1; depth vs the "
          f"plane's GT median {np.median(gt_err):.3f} intervals (the exact "
          f"path {np.median(gt_err_x):.3f})", flush=True)
    # rect is an approximation: held to the JAX package's own bound for
    # Vis rect against the exact path (tests/test_rect_vis.py:162-164, an
    # interior mean under 2 of the 128-step base intervals = 4 stage-3
    # intervals), here stage 3 on its own inputs
    check(vinner < 4.0, f"Vis rect stage-3 depth: interior mean {vinner} "
          f"stage-3 intervals from the exact path")
    return counts, dict(
        cvp_first_request_ms=cvp_first, cvp_request_ms=steady,
        cvp_request_ms_median=float(np.median(steady)),
        cvp_exact_request_ms=exact_ms,
        cvp_exact_request_ms_median=float(np.median(exact_ms)),
        cvp_rect_levels=rect_levels, cvp_rect_source_heights=resampled,
        vis_request_ms=vis_first,
        vis_request_ms_median=float(np.median(vis_steady)),
        vis_exact_request_ms=auto_ms,
        vis_exact_request_ms_median=float(np.median(auto_ms)),
        vis_stage3_within_1=vwithin,
        vis_stage3_mean_intervals=float(verr.mean()),
        vis_stage3_interior_mean_intervals=vinner,
        vis_depth_vs_gt_median_intervals=float(np.median(gt_err)),
        vis_exact_depth_vs_gt_median_intervals=float(np.median(gt_err_x)),
        peak_gib=peak / 2 ** 30, **prof)


class BenchScene:
    """The bench scene under the eval-dataset contract: the textured plane
    (VIS_PLANE) rendered into the DTU-like rig of n views (seed 0), sample
    i being view i against the others, with GT depths (for the oracle) and
    `gt_points`: view 0's GT depth at every second pixel, unprojected to
    the world (mm), for the chamfer metrics at `gt_resolution` 1 mm (a
    10 mm cutoff). A sample's `mask` is its GT depth inside the depth
    range (the depthmap benchmark's)."""

    gt_resolution = 1.0

    def __init__(self, n: int, h: int, w: int, f: float):
        (self.imgs, self.K, self.R, self.t, self.dmin, self.dmax), \
            self.depths = vis_scene(n, h, w, f)
        self.n = n
        ys, xs = np.meshgrid(np.arange(0, h, 2, dtype=np.float32),
                             np.arange(0, w, 2, dtype=np.float32),
                             indexing="ij")
        d = self.depths[0, ::2, ::2]
        cam = (np.stack([xs, ys, np.ones_like(xs)], -1)
               @ np.linalg.inv(self.K[0]).T) * d[..., None]
        self.gt_points = ((cam - self.t[0][:, 0]) @ self.R[0]).reshape(
            -1, 3).astype(np.float64)

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> dict:
        order = [i] + [j for j in range(self.n) if j != i]
        depth = self.depths[i]
        mask = (depth >= self.dmin[i]) & (depth <= self.dmax[i])
        return {"imgs": self.imgs[order], "K": self.K[order],
                "R": self.R[order], "t": self.t[order],
                "depth_min": self.dmin[order], "depth_max": self.dmax[order],
                "depth": depth, "mask": mask.astype(np.float32),
                "filename": f"view_{i:04d}",
                "src_filenames": [f"view_{j:04d}" for j in order[1:]]}


#: phase 11's bounds by architecture: (the fused cloud's least size, the
#: most either chamfer mean may be, in mm, clipped at the 10 mm cutoff).
#: The oracle's GT depths put every point on the plane, so its distances
#: are the GT points' spacing (0.45 mm at every second pixel): 1 mm. The
#: trained Vis asset's depth is a median 5.8 stage-3 intervals (11.6 mm)
#: from the plane's GT on this scene (phase 10, the exact path), so the
#: network, not the pipeline, sets its chamfer; the filter keeps points
#: whose views agree within 1 % of the depth (6.5 mm at 650 mm): 8 mm.
#: Classic (phase 14b, written before its first run on the card): the
#: ZNCC sweep at half resolution with D192 over 510 mm (2.67 mm a
#: hypothesis, refined by the parabola) on a textured plane: the trained
#: Vis asset's floor, 10 000 points and 8 mm, which the filter's 1 %
#: agreement (6.5 mm) and the cutoff (10 mm) bound as they do for Vis.
RECON_BOUNDS = {"vis_mvsnet": (10_000, 8.0), "oracle": (100_000, 1.0),
                "classic": (10_000, 8.0)}


def phase11_reconstruction():
    """run_pipeline end to end on the card over BenchScene (1184x1600, 5
    views): the trained Vis asset (depthmaps -> geometric filter -> fusion
    -> PLY -> chamfer against the plane's GT points), then the oracle (GT
    depths at full resolution) through stages 2-4. The metrics stage takes
    the native k-d tree (cpp/kdtree.cpp). Returns (the Vis run's launch
    counts, stats, the oracle's fused cloud and the GT points for phase
    15)."""
    ds = BenchScene(n=5, h=EVAL["h"], w=EVAL["w"], f=EVAL["f"])
    stats, counts, oracle_points = {}, None, None
    with tempfile.TemporaryDirectory() as tmp:
        for arch in ("vis_mvsnet", "oracle"):
            model_dir = VIS_ASSET if arch == "vis_mvsnet" else None
            torch.cuda.synchronize()
            sk.reset_launch_counts()
            res = run_pipeline(ds, Path(tmp) / arch, model_dir=model_dir,
                               architecture=arch, compute_metrics=True)
            c = sk.launch_counts()
            if arch == "vis_mvsnet":
                counts = c
                check(c == {"sweep_warp": 0, "sweep_warp_backward": 0,
                            "fused_cost_volume": 0, "sweep_gwc": 12 * ds.n,
                            "conv3d_head": vis_heads(5) * ds.n},
                      f"the pipeline's depthmaps skipped a kernel: {c}")
            else:
                check(sum(c.values()) == 0, f"the oracle launched {c}")
            m = res["metrics"]
            stages = {k: round(v["total_s"] * 1e3, 3)
                      for k, v in res["stage_timings"].items()}
            print(f"phase11 run_pipeline {arch} 1184x1600 N5: stage ms "
                  f"{stages}; {res['num_points']} points; chamfer mm "
                  f"pred->GT {m['chamfer_pred_to_gt']:.4f}, GT->pred "
                  f"{m['chamfer_gt_to_pred']:.4f}; launches {c}", flush=True)
            min_points, bound_mm = RECON_BOUNDS[arch]
            check(res["num_points"] >= min_points,
                  f"{arch}: {res['num_points']} points")
            check(m["chamfer_pred_to_gt"] <= bound_mm
                  and m["chamfer_gt_to_pred"] <= bound_mm,
                  f"{arch}: chamfer {m} above {bound_mm} mm")
            check(Path(res["ply"]).stat().st_size > 0, "no PLY")
            stats[arch] = dict(stage_ms=stages, num_points=res["num_points"],
                               **m)
            if arch == "oracle":
                oracle_points = ply_xyz(res["ply"])
    return counts, stats, (oracle_points, ds.gt_points)


# ---------------------------------------------------------------------------
# Distribution on the one card
# ---------------------------------------------------------------------------

DIST_STEPS = 2                  # phase 13a's steps (13d takes one)
VIEW_RANKS = 3                  # phase 13a: one reference view a rank
# phase 13a's bound on the median over the parameters of the first step's
# gradient error in relative L2: each view's gradient is computed by the
# same bf16 operations on every rank as in the single program, and only
# the f32 sum over the views is taken in another order
VIEW_GRAD_REL = 1e-2
# phase 13d's compute: bf16 rounding noise moves a training step's
# gradients by tens of percent between two runs of one batch that differ
# only in their convolutions' summation order, which leaves nothing sharp
# to hold a data-parallel step to; in f32 the step must equal the single
# program's (tests/test_multihost.py's bound)
DATA_PARALLEL_DTYPE = "float32"
# phase 13b's bound on the bytes a rank's collectives move in a hyp-2
# MVSNet request, as a share of the f32 volume a gather before the
# regularizer would move (2.9 GB at 1184x1600 D192): the partitioned
# regularizer moves the halos of its 3D convs and the [B, H, W]
# reductions over depth
HYP_BYTES_SHARE = 0.05


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms within the block: the steps held to
    one another then differ in their own arithmetic only."""
    kept = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = kept


def sup_mvsnet_config(**kw):
    """Phase 5's supervised MVSNet recipe."""
    return TrainConfig(**{"architecture": "mvsnet", "dataset": "synthetic",
                          "num_depth": NUM_DEPTH, "lr": 1e-3,
                          "train_dtype": "bfloat16", **kw})


def synced_ms(fn):
    """(fn(), host ms to the device's end)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def flat_params(model):
    return torch.cat([p.detach().float().reshape(-1).cpu()
                      for p in model.parameters()])


def flat_grads(model):
    return torch.cat([p.grad.float().reshape(-1).cpu()
                      for p in model.parameters()])


def leaf_grads(model):
    return [p.grad.float().cpu() for p in model.parameters()]


def median_leaf_rel(got, want):
    """The median over the parameters of each one's gradient error in
    relative L2 (against its norm, or 1e-4 of the largest gradient where
    that is larger: a gradient the softmax over depth cancels is ~0)."""
    gmax = max(w.abs().max().item() for w in want)
    return float(np.median([((g - w).norm() / max(w.norm().item(),
                                                  1e-4 * gmax)).item()
                            for g, w in zip(got, want)]))


def phase13a_rank(dev, world):
    """Phase 13a on one rank: DIST_STEPS view-parallel occlusion-masked
    MVSNet steps (mesh data 1 x view `world`) from phase 12's seeded
    weights and batch; the launches of this rank's loop alone, and on view
    rank 0 the parameters after each step and the first step's summed
    gradients."""
    mesh = make_mesh(data=1, view=world)
    cfg = occ_mvsnet_config()
    state = T.create_train_state(cfg, dev)
    batch = headline_batch(dev)
    step = make_view_parallel_train_step(mesh, cfg)
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    losses, times, params, grads = [], [], [], None
    with deterministic_cudnn():
        for _ in range(DIST_STEPS):
            (state, m), ms = synced_ms(lambda: step(state, batch))
            losses.append(m["train_loss"].item())
            times.append(ms)
            if mesh.index("view") == 0:
                params.append(flat_params(state.model))
                grads = grads or leaf_grads(state.model)
    return dict(counts=sk.launch_counts(), losses=losses, step_ms=times,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                params=params, grads=grads)


def traced_request(pred, scene, modules):
    """One request with the card's peak memory and this process's
    collective bytes counted from 0, and CUDA events around every call of
    `modules` (the regularizer's span on this rank's stream: its kernels,
    the halo exchanges it waits for, and, with ranks sharing the card, the
    other ranks' kernels in between). Returns (outputs, a dict of request
    ms, regularizer ms, peak GiB, collective bytes)."""
    spans = []

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    hooks = [h for m in modules for h in (
        m.register_forward_pre_hook(lambda mod, a: spans.append([event()])),
        m.register_forward_hook(lambda mod, a, o: spans[-1].append(event())))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_collective_bytes()
    try:
        out, ms = synced_ms(lambda: pred(*scene))
    finally:
        for h in hooks:
            h.remove()
    return out, dict(ms=ms, reg_ms=sum(a.elapsed_time(b) for a, b in spans),
                     peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                     collective_bytes=collective_bytes())


def regularizers(model):
    """The 3D networks a request partitions over hyp: MVSNet's CostRegNet,
    CVP's regularizer (all its levels' calls), Vis's Reg, RegPair and
    RegFuse of every stage."""
    if hasattr(model, "cost_regularization"):
        return [model.cost_regularization]
    if hasattr(model, "cost_reg_refine"):
        return [model.cost_reg_refine]
    return [getattr(getattr(model, f"stage{i}"), net) for i in (1, 2, 3)
            for net in ("reg", "reg_pair", "reg_fuse")]


def hyp_requests(make, scene, world, rank):
    """A request of the predictor `make(mesh)` builds, with its
    regularizers hyp-partitioned over `world` ranks, after a warm-up
    request; on rank 0 first the unsharded predictor's (mesh None), the
    reference, warmed up alike. Returns (reference, sharded), each a dict
    of depth, launches, traced_request's numbers and the first request's
    ms."""
    runs = {}
    for name, mesh in (("ref", None), ("hyp", make_mesh(hyp=world))):
        if name == "ref" and rank != 0:
            continue
        pred = make(mesh)
        sk.reset_launch_counts()
        _, first = synced_ms(lambda: pred(*scene))
        out, numbers = traced_request(pred, scene, regularizers(pred.model))
        runs[name] = dict(depth=out["depth"], counts=sk.launch_counts(),
                          first_ms=first, **numbers)
        if hasattr(pred, "levels"):          # CVP: this request's levels
            runs[name]["levels"] = pred.levels[-CVP_NSCALE:]
        del pred
        torch.cuda.empty_cache()
    return runs.get("ref"), runs["hyp"]


def phase13bcd_rank(dev, world):
    """Phases 13b-d and f on one of two ranks: MVSNet serving with the
    hypotheses over hyp, the trained Vis asset with its source pairs over
    view (each beside the unsharded request on rank 0), one data-parallel
    supervised MVSNet step with BatchNorm synced over data (beside the
    single-program step on the whole batch, on rank 0), and the Vis asset
    and CVP "fused" with the hypotheses over hyp (beside their unsharded
    requests)."""
    rank = torch.distributed.get_rank()
    res = {}
    # (b) MVSNet at the eval shape, hyp = 2: one fused launch a rank, over
    # its 96 hypotheses, and its slab through the partitioned CostRegNet
    res["b_ref"], res["b"] = hyp_requests(
        lambda mesh: sharpen(Predictor(architecture="mvsnet", mesh=mesh)),
        dtu_scene(4, **EVAL), world, rank)

    # (c) the trained Vis asset at the eval shape, view = 2: two of the
    # four source pairs a rank, each through sweep_gwc
    (vscene, _) = vis_scene(n=5, h=EVAL["h"], w=EVAL["w"], f=EVAL["f"])
    mesh = make_mesh(data=1, view=world)
    pred = Predictor(VIS_ASSET, mesh=mesh)
    if rank == 0:
        res["c_ref"] = Predictor(VIS_ASSET)(*vscene)
    sk.reset_launch_counts()
    out, first = synced_ms(lambda: pred(*vscene))
    out, ms = synced_ms(lambda: pred(*vscene))
    res["c"] = dict(counts=sk.launch_counts(), depth=out["depth"],
                    first_ms=first, ms=ms)
    del pred
    torch.cuda.empty_cache()

    # (d) data-parallel supervised MVSNet, batch 2, a sample a rank, in f32
    # (the exact gather; DATA_PARALLEL_DTYPE); the second sample's mask cut
    # to its lower half, so that the ranks' masks count different numbers
    # of pixels and the loss must be the whole batch's masked mean
    mesh = make_mesh(data=world)
    cfg = sup_mvsnet_config(batch_size=world, train_dtype=DATA_PARALLEL_DTYPE)
    batch = headline_batch(dev, samples=world)
    batch["mask"][1, :HEADLINE["h"] // 2] = 0
    with deterministic_cudnn():
        if rank == 0:
            state = T.create_train_state(cfg, dev)
            (state, m), ms = synced_ms(lambda: T.train_step(state, batch,
                                                            cfg))
            res["d_ref"] = dict(loss=m["train_loss"].item(),
                                grads=flat_grads(state.model),
                                params=flat_params(state.model), ms=ms)
            del state
        state = T.create_train_state(cfg, dev)
        local = shard_batch(batch, mesh)
        sk.reset_launch_counts()
        (state, m), ms = synced_ms(lambda: T.train_step(state, local, cfg,
                                                        mesh))
    res["d"] = dict(counts=sk.launch_counts(), loss=m["train_loss"].item(),
                    ms=ms, grads=flat_grads(state.model) if rank == 0
                    else None, params=flat_params(state.model) if rank == 0
                    else None)
    del state
    torch.cuda.empty_cache()

    # (f) the trained Vis asset and CVP "fused" at the eval shape, hyp = 2
    res["f_vis_ref"], res["f_vis"] = hyp_requests(
        lambda mesh: Predictor(VIS_ASSET, mesh=mesh),
        vis_scene(n=5, h=EVAL["h"], w=EVAL["w"], f=EVAL["f"])[0], world,
        rank)
    scene = dtu_scene(20, **EVAL)

    def cvp(mesh):
        pred = sharpen(Predictor(architecture="cvp_mvsnet",
                                 sweep_method="fused", cvp_nscale=CVP_NSCALE,
                                 mesh=mesh))
        pred.levels = record_regress(pred.model)
        return pred
    res["f_cvp_ref"], res["f_cvp"] = hyp_requests(cvp, scene, world, rank)
    return res


def record_regress(model):
    """Patch the CVP model's regress so that each call appends its level's
    (depth, hypothesis interval) to the returned list, on the host: the
    coarse level first, CVP_NSCALE calls a request."""
    levels = []
    real = model.regress

    def recording(cost, hyp, slab=None, **kw):
        out = real(cost, hyp, slab, **kw)
        levels.append((out[1][0].float().cpu().numpy(),
                       (hyp[:, 1] - hyp[:, 0]).flatten()[0].item()))
        return out
    model.regress = recording
    return levels


def phase13_rank(rank, world, part):
    """A rank of phase 13, spawned on cuda:0 over gloo; returns what its
    part returns."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    return (phase13a_rank if part == "a" else phase13bcd_rank)(dev, world)


def spawn_ranks(world: int, part: str) -> list:
    """Run phase 13's `part` over `world` gloo ranks sharing the card;
    each rank's results, and the seconds the spawn took."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn(phase13_rank, world, world, part, device="cuda")
    return res, time.perf_counter() - t0


def adam_agreement(phase, got, want, lr):
    """Parameters after one Adam step against the single program's: the
    first step moves each by about lr * sign(gradient), so a gradient
    within rounding of 0 may flip it (tests/test_multihost.py:102-111):
    99.9 % within 2e-5, all within 2.5 lr."""
    diff = (got - want).abs()
    tight = (diff < 2e-5).float().mean().item()
    print(f"{phase} parameters vs the single program: {tight:.6f} within "
          f"2e-5, max {diff.max().item():.4g} (limit {2.5 * lr:.4g})",
          flush=True)
    check(tight > 0.999 and diff.max().item() < 2.5 * lr,
          f"{phase}: parameters disagree with the single program's")


def phase13e_remat(dev):
    """--remat: phase 5's supervised step and phase 12's occlusion-masked
    step, each without and with it, from the same seeded weights: the
    first step's losses equal within 2^-7; the second step timed; the
    peak memory of the two steps, each beside the other."""
    res = {}
    batch = headline_batch(dev)
    for name, base in (("supervised", sup_mvsnet_config()),
                       ("occ", occ_mvsnet_config())):
        runs = {}
        for remat in (False, True):
            cfg = dataclasses.replace(base, remat=remat)
            state = T.create_train_state(cfg, dev)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            sk.reset_launch_counts()
            state, m = T.train_step(state, batch, cfg)
            loss = m["train_loss"].item()
            counts = sk.launch_counts()
            _, ms = synced_ms(lambda: T.train_step(state, batch, cfg))
            runs[remat] = dict(loss=loss, ms=ms,
                               peak_gib=torch.cuda.max_memory_allocated()
                               / 2 ** 30, counts=counts)
            del state
        plain, remat = runs[False], runs[True]
        rel = abs(remat["loss"] - plain["loss"]) / abs(plain["loss"])
        print(f"phase13e remat {name} MVSNet 512x640 N3 D192 bf16: loss "
              f"{plain['loss']:.6f} plain, {remat['loss']:.6f} remat "
              f"(relative {rel:.3g}); peak {plain['peak_gib']:.3f} GiB "
              f"plain, {remat['peak_gib']:.3f} remat; step ms "
              f"{plain['ms']:.3f} plain, {remat['ms']:.3f} remat (second "
              f"steps); warps {plain['counts']['sweep_warp']} plain, "
              f"{remat['counts']['sweep_warp']} remat", flush=True)
        check(rel <= 2 ** -7, f"remat {name}: loss {remat['loss']} against "
              f"{plain['loss']}")
        check(remat["counts"]["sweep_warp"]
              == 2 * plain["counts"]["sweep_warp"],
              f"remat {name} did not recompute the warps: {runs}")
        res[name] = runs
    check(res["occ"][True]["peak_gib"] < res["occ"][False]["peak_gib"],
          "remat did not lower the occlusion-masked step's peak memory")
    return res


def phase13_distribution(dev, single_step_ms):
    """Distribution on the one card (the eighth path, "distributed"):
    spawned ranks on cuda:0 over gloo (one process a rank; the kernels
    were built once, before the spawn). (a) view-parallel occlusion-
    masked MVSNet, three ranks, DIST_STEPS steps against the single-
    program step's; (b) MVSNet serving at 1184x1600 N5 D192 with hyp 2,
    the regularizer depth-partitioned: peak GiB, regularizer ms and
    collective bytes a rank beside the unsharded request's; (c) the
    trained Vis asset at 1184x1600 N5 with view 2; (d) a data-parallel
    supervised MVSNet step, two ranks, BatchNorm synced; (f) the Vis asset
    and CVP "fused" at hyp 2; (e) --remat in this process. One card: no
    figure here says anything of NCCL or of scaling over cards. Returns
    the ranks' launches summed and the results."""
    _build.build()
    lr = occ_mvsnet_config().lr
    remat = phase13e_remat(dev)

    # (a) the single program's DIST_STEPS steps, then the view ranks'
    cfg = occ_mvsnet_config()
    state = T.create_train_state(cfg, dev)
    batch = headline_batch(dev)
    want, want_params, want_grads = [], [], None
    with deterministic_cudnn():
        for _ in range(DIST_STEPS):
            state, m = T.train_step(state, batch, cfg)
            want.append(m["train_loss"].item())
            want_params.append(flat_params(state.model))
            want_grads = want_grads or leaf_grads(state.model)
    del state, batch
    ranks_a, spawn_a = spawn_ranks(VIEW_RANKS, "a")
    per_step = 2 * DIST_STEPS
    total = {k: 0 for k in sk.KERNELS}
    for r, res in enumerate(ranks_a):
        check(res["counts"] == {"sweep_warp": per_step,
                                "sweep_warp_backward": per_step,
                                "fused_cost_volume": 0, "sweep_gwc": 0,
                                "conv3d_head": 0},
              f"phase13a rank {r} launches {res['counts']}")
        total = {k: total[k] + res["counts"][k] for k in total}
        print(f"phase13a rank {r}: losses {[round(x, 6) for x in res['losses']]}"
              f"; ms per step {[round(t, 3) for t in res['step_ms']]} "
              f"(one-card gloo figure: {VIEW_RANKS} ranks share the card); "
              f"peak {res['peak_gib']:.3f} GiB", flush=True)
    got = ranks_a[0]
    for i, (g, w) in enumerate(zip(got["losses"], want)):
        check(abs(g - w) <= 2 ** -7 * abs(w),
              f"phase13a step {i}: loss {g} against the single program's {w}")
    # Adam's sign-flip bound is the first step's: a flip there moves the
    # second step's bf16 forward, and the bf16 rounding of the whole step
    # then moves the later gradients (on an H100, 73.6 % of the parameters
    # were within 2e-5 after two steps)
    # Adam's first step moves each parameter by about lr * sign(gradient),
    # so the parameters show the gradients' signs only: their size is held
    # here (a missing 1 / ranks would be off by 2 in relative L2)
    a_rel = median_leaf_rel(got["grads"], want_grads)
    print(f"phase13a step 0 gradients vs the single program: median over "
          f"the parameters of the relative L2 {a_rel:.4g} (limit "
          f"{VIEW_GRAD_REL:.4g})", flush=True)
    check(a_rel < VIEW_GRAD_REL, f"phase13a step 0: gradients off the single "
          f"program's by {a_rel:.4g} (median relative L2)")
    adam_agreement("phase13a step 0", got["params"][0], want_params[0], lr)
    later = (got["params"][-1] - want_params[-1]).abs()
    print(f"phase13a after {DIST_STEPS} steps: "
          f"{(later < 2e-5).float().mean().item():.6f} of the parameters "
          f"within 2e-5 of the single program's, max {later.max().item():.4g}"
          f" (reported only)", flush=True)
    a_ms = float(np.median([t for res in ranks_a for t in res["step_ms"][1:]]))
    print(f"phase13a view-parallel occlusion-masked MVSNet 512x640 N3 D192 "
          f"bf16 over {VIEW_RANKS} gloo ranks on one card: losses "
          f"{[round(x, 6) for x in got['losses']]} (single program "
          f"{[round(x, 6) for x in want]}); {a_ms:.3f} ms a step (median "
          f"over the ranks' later steps) beside phase 12's single-program "
          f"{single_step_ms:.3f}; spawn and run {spawn_a:.1f} s", flush=True)

    ranks_b, spawn_b = spawn_ranks(2, "bcd")
    ref = ranks_b[0]
    interval = (DEPTH_RANGE[1] - DEPTH_RANGE[0]) / (NUM_DEPTH - 1)
    interval3 = (DEPTH_RANGE[1] - DEPTH_RANGE[0]) / 128.0 * VIS_EVAL_SCALES[2]
    # the f32 volume [1, D, H/4, W/4, 32] a gather before the regularizer
    # would hand each rank
    gathered = NUM_DEPTH * (EVAL["h"] // 4) * (EVAL["w"] // 4) * 32 * 4
    out = {}
    # heads: the hyp-partitioned regularizers run their own haloed
    # F.conv3d (none); view-parallel Vis runs, in each of 2 requests and
    # 3 stages, the heads of this rank's 2 pairs and of the fused volume;
    # CVP's finer levels run unsharded
    for part, limit, want_c in (
            ("b", interval, {"fused_cost_volume": 2}),
            ("c", interval3, {"sweep_gwc": 12,
                              "conv3d_head": 2 * 3 * (2 + 1)}),
            ("f_vis", interval3, {"sweep_gwc": 24}),
            ("f_cvp", ref["f_cvp_ref"]["levels"][-1][1],
             {"fused_cost_volume": 2 * CVP_NSCALE,
              "conv3d_head": 2 * (CVP_NSCALE - 1)})):
        phase = f"phase13{part[0]}" + (f" {part[2:]}" if part[1:] else "")
        want_d = ref[f"{part}_ref"]["depth"]
        for r, res in enumerate(ranks_b):
            c = res[part]["counts"]
            total = {k: total[k] + c[k] for k in total}
            check(c == {**{k: 0 for k in total}, **want_c},
                  f"{phase} rank {r} launches {c}")
            err = np.abs(res[part]["depth"] - want_d) / limit
            within = float((err < 1).mean())
            print(f"{phase} rank {r}: depth vs the unsharded request "
                  f"mean {err.mean():.4g} intervals ({limit:.4g} mm), "
                  f"{within:.5f} within 1, max {err.max():.4g}; request ms "
                  f"{res[part]['ms']:.3f} (first {res[part]['first_ms']:.3f})",
                  flush=True)
            if part == "b":
                check(err.mean() < 0.25 and within > 0.95,
                      f"phase13b rank {r}: the hyp-sharded depth disagrees")
            elif part == "f_cvp":
                # phase 8's limit on the level the partition runs, whose
                # inputs (features, the fused volume's planes) are the
                # unsharded request's bit for bit; the finer levels run
                # unsharded from its depth, and a random-weight cascade
                # carries any difference there on (the finest, above,
                # reported)
                (coarse, step), (coarse_ref, _) = (
                    res[part]["levels"][0], ref[f"{part}_ref"]["levels"][0])
                cerr = np.abs(coarse - coarse_ref) / step
                c_within = float((cerr < 1).mean())
                print(f"{phase} rank {r}: coarse depth (partitioned) vs the "
                      f"unsharded request mean {cerr.mean():.4g} intervals "
                      f"({step:.4g} mm), {c_within:.5f} within 1, max "
                      f"{cerr.max():.4g}", flush=True)
                check(c_within >= 0.95, f"{phase} rank {r}: the partitioned "
                      f"coarse depth disagrees")
            else:
                check(within >= 0.95,
                      f"{phase} rank {r}: the sharded depth disagrees")
            check(np.isfinite(res[part]["depth"]).all(), "non-finite depth")
        out[part] = dict(request_ms=[res[part]["ms"] for res in ranks_b],
                         counts=[res[part]["counts"] for res in ranks_b])
        if part == "c":
            continue
        # the partitioned regularizers, rank by rank beside the unsharded
        # request (rank 0, alone on the card while it ran)
        keys = ("ms", "reg_ms", "peak_gib", "collective_bytes")
        unsharded = {k: ref[f"{part}_ref"][k] for k in keys}
        ranks = [{k: res[part][k] for k in keys} for res in ranks_b]
        for r, x in enumerate(ranks):
            print(f"{phase} rank {r} hyp 2: peak {x['peak_gib']:.3f} GiB, "
                  f"regularizer {x['reg_ms']:.3f} ms (CUDA events; the two "
                  f"ranks share the card), request {x['ms']:.3f} ms, "
                  f"collectives {x['collective_bytes']} bytes; unsharded: "
                  f"peak {unsharded['peak_gib']:.3f} GiB, regularizer "
                  f"{unsharded['reg_ms']:.3f} ms, request "
                  f"{unsharded['ms']:.3f} ms", flush=True)
        out[part].update(unsharded=unsharded, ranks=ranks)
        if part == "b":
            share = max(x["collective_bytes"] for x in ranks) / gathered
            print(f"phase13b collectives: {share:.5f} of the {gathered} "
                  f"bytes of the f32 volume (limit {HYP_BYTES_SHARE})",
                  flush=True)
            check(share < HYP_BYTES_SHARE, f"phase13b collectives moved "
                  f"{share:.4f} of the gathered volume")
            out[part]["collective_share_of_gather"] = share
    d_ref = ref["d_ref"]
    for r, res in enumerate(ranks_b):
        c = res["d"]["counts"]
        total = {k: total[k] + c[k] for k in total}
        check(c == {k: 0 for k in total}, f"phase13d rank {r} launches {c} "
              f"(f32 takes the exact gather)")
    loss = ranks_b[0]["d"]["loss"]
    g, gw = ranks_b[0]["d"]["grads"], d_ref["grads"]
    g_rel = ((g - gw).norm() / gw.norm()).item()
    print(f"phase13d data-parallel supervised MVSNet 512x640 N3 D192 "
          f"{DATA_PARALLEL_DTYPE}, batch 2 over 2 gloo ranks, BatchNorm "
          f"synced: loss {loss:.7f} (single program on the batch "
          f"{d_ref['loss']:.7f}); gradient relative L2 {g_rel:.4g}; ms "
          f"{[round(res['d']['ms'], 3) for res in ranks_b]} (single program "
          f"{d_ref['ms']:.3f}); spawn and run {spawn_b:.1f} s", flush=True)
    check(abs(loss - d_ref["loss"]) <= 1e-5 * abs(d_ref["loss"]),
          f"phase13d loss {loss} against {d_ref['loss']}")
    check(g_rel < 1e-2, f"phase13d gradients off the single program's by "
          f"{g_rel:.4g} (relative L2)")
    adam_agreement("phase13d", ranks_b[0]["d"]["params"], d_ref["params"], lr)
    print(f"phase13 launches {json.dumps(total)}", flush=True)
    return total, dict(
        view_parallel=dict(losses=got["losses"], single_losses=want,
                           grad_median_rel_l2=a_rel,
                           step_ms_median=a_ms,
                           single_step_ms=single_step_ms,
                           rank_step_ms=[res["step_ms"] for res in ranks_a],
                           spawn_s=spawn_a),
        hyp_serving=out["b"], vis_view_serving=out["c"],
        vis_hyp_serving=out["f_vis"], cvp_hyp_serving=out["f_cvp"],
        data_parallel=dict(loss=loss, single_loss=d_ref["loss"],
                           grad_rel_l2=g_rel,
                           ms=[res["d"]["ms"] for res in ranks_b],
                           single_ms=d_ref["ms"], spawn_s=spawn_b),
        remat=remat)


# ---------------------------------------------------------------------------
# Classic and the offline tools
# ---------------------------------------------------------------------------

#: the classic sweep held to another run of it (tests/test_torch_classic.py
#: against JAX on the CPU, phase 14 the card against the CPU): depth in
#: hypothesis intervals, confidence absolute. The box filter's sums round
#: in another order on each side, ZNCC's variances are differences of
#: near-equal means, and the parabola's offset divides by the peak's
#: curvature, so last-bit differences move the sub-hypothesis depth: the
#: JAX function against itself, on the 64x96 scene's images moved by one
#: ulp, moves it by 0.0044 interval at the median and 0.068 at the 99th
#: percentile at D192, half resolution (0.0009 and 0.053 at D64, full
#: resolution), and a near-tie of two peaks flips the argmax (a flip moves
#: the depth by up to 2 intervals and more).
CLASSIC_LIMITS = dict(depth_median=0.05, depth_q99=0.5, flips=5e-3,
                      flip_intervals=2.0, conf_atol=1e-4, conf_share=0.99,
                      conf_max=1e-3)


def classic_agreement(got, want, interval: float) -> dict:
    """(depth, confidence) of two classic runs -> their differences; fails
    unless they are within CLASSIC_LIMITS. interval: the hypothesis step
    (depth_max - depth_min) / (num_depth - 1)."""
    lim = CLASSIC_LIMITS
    dd = np.abs(np.asarray(got[0], np.float64)
                - np.asarray(want[0], np.float64)) / interval
    dc = np.abs(np.asarray(got[1], np.float64)
                - np.asarray(want[1], np.float64))
    stats = dict(depth_median=float(np.median(dd)),
                 depth_q99=float(np.quantile(dd, 0.99)),
                 flips=float((dd >= lim["flip_intervals"]).mean()),
                 conf_share=float((dc <= lim["conf_atol"]).mean()),
                 conf_max=float(dc.max()))
    ok = (stats["depth_median"] <= lim["depth_median"]
          and stats["depth_q99"] <= lim["depth_q99"]
          and stats["flips"] <= lim["flips"]
          and stats["conf_share"] >= lim["conf_share"]
          and stats["conf_max"] <= lim["conf_max"])
    check(ok, f"classic runs disagree: {stats} (limits {lim})")
    return stats


#: phase 14a: the classic sweep at the JAX defaults (the configuration
#: users run), and the small shape it is run at on the card and the CPU
CLASSIC = dict(num_depth=192, window=7, downscale=2)
CLASSIC_SMALL = dict(h=296, w=400, f=EVAL["f"] / 4, num_depth=48)
CLASSIC_REL_DEPTH = 0.03        # the JAX package's bound against GT
EVAL_EPE_REL = 1e-3             # phase 14c: evaluate vs the npz
MERGE_REL = 1e-6                # phase 14c: merged shards vs unsharded
SAMPLE_KEYS = ("imgs", "K", "R", "t", "depth_min", "depth_max")


@contextlib.contextmanager
def torch_default_precision():
    """PyTorch's own defaults for TF32 inside (cuDNN convolutions in TF32,
    matmuls in f32), which main() turns off for its f32 comparisons."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def sample_tensors(sample, dev):
    return [torch.as_tensor(np.asarray(sample[k], np.float32),
                            device=dev)[None] for k in SAMPLE_KEYS]


def resize_bilinear_np(x: np.ndarray, hw) -> np.ndarray:
    """[h, w] -> hw in float64: bilinear, half-pixel centres, no
    antialiasing, sources clamped at the edges (the benchmark's resize,
    written out in numpy)."""
    def axis(n_in, n_out):
        c = np.maximum((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0.0)
        i0 = np.minimum(np.floor(c).astype(np.int64), n_in - 1)
        return i0, np.minimum(i0 + 1, n_in - 1), c - i0
    y0, y1, fy = axis(x.shape[0], hw[0])
    x0, x1, fx = axis(x.shape[1], hw[1])
    x = x.astype(np.float64)
    top = x[y0][:, x0] * (1 - fx) + x[y0][:, x1] * fx
    bottom = x[y1][:, x0] * (1 - fx) + x[y1][:, x1] * fx
    return top * (1 - fy)[:, None] + bottom * fy[:, None]


def npz_metrics(ds, depth_dir: Path) -> dict:
    """EPE / 1pxError / 3pxError of the stage-1 npz files, in numpy: each
    depthmap resized to its GT, both over (depth_max - depth_min) / 128,
    averaged over the mask, then over the samples."""
    sums = {"EPE": 0.0, "1pxError": 0.0, "3pxError": 0.0}
    for i in range(len(ds)):
        s = ds[i]
        with np.load(depth_dir / f"{s['filename']}_out.npz") as z:
            est = resize_bilinear_np(z["depthmap"], s["depth"].shape)
        step = (float(s["depth_max"][0]) - float(s["depth_min"][0])) / 128.0
        err = np.abs(est / step - s["depth"].astype(np.float64) / step)
        m = s["mask"] > 0.5
        sums["EPE"] += err[m].mean()
        sums["1pxError"] += (err[m] > 1.0).mean()
        sums["3pxError"] += (err[m] > 3.0).mean()
    return {k: v / len(ds) for k, v in sums.items()}


def phase14a_classic(dev, ds):
    """The classic sweep on BenchScene's view 0 at 1184x1600 N5 and the JAX
    defaults: ms a depthmap (median of 3 after a warm-up, card-synced),
    peak GiB, one profiled call, the median relative depth error against GT on the mask, the
    confidence in [0, 1]; then at 296x400 D48 on the card (under PyTorch's
    default TF32 settings) and on the CPU, held to CLASSIC_LIMITS."""
    s = ds[0]
    args = sample_tensors(s, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    with torch.inference_mode():
        for _ in range(4):
            t0 = time.perf_counter()
            depth, conf = classic_depthmap(*args, **CLASSIC)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    with torch.inference_mode():
        prof = profile_step(lambda: classic_depthmap(*args, **CLASSIC),
                            "phase14a classic")
    depth, conf = depth[0].cpu().numpy(), conf[0].cpu().numpy()
    d = CLASSIC["downscale"]
    check(depth.shape == (EVAL["h"] // d, EVAL["w"] // d)
          and np.isfinite(depth).all(), f"classic depth {depth.shape}")
    check(0.0 <= conf.min() and conf.max() <= 1.0,
          f"classic confidence in [{conf.min()}, {conf.max()}]")
    gt = s["depth"][::d, ::d]
    mask = s["mask"][::d, ::d] > 0.5
    rel = float(np.median(np.abs(depth - gt)[mask] / gt[mask]))
    check(rel < CLASSIC_REL_DEPTH,
          f"classic median relative depth error {rel}")

    small = BenchScene(n=EVAL["n"], h=CLASSIC_SMALL["h"],
                       w=CLASSIC_SMALL["w"], f=CLASSIC_SMALL["f"])[0]
    kw = dict(CLASSIC, num_depth=CLASSIC_SMALL["num_depth"])
    runs = []
    with torch.inference_mode(), torch_default_precision():
        for where in (dev, torch.device("cpu")):
            out = classic_depthmap(*sample_tensors(small, where), **kw)
            runs.append([o[0].cpu().numpy() for o in out])
    step = float(small["depth_max"][0] - small["depth_min"][0]) / (
        kw["num_depth"] - 1)
    card_cpu = classic_agreement(runs[0], runs[1], step)
    return dict(ms=float(np.median(times[1:])), ms_runs=times[1:],
                warmup_ms=times[0], peak_gib=peak, **prof,
                median_rel_depth_err=rel,
                confidence=[float(conf.min()), float(conf.max())],
                card_vs_cpu_296x400_d48=card_cpu)


def phase14_classic_and_tools(dev):
    """Phase 14 on BenchScene (1184x1600, 5 views): (a) the classic sweep
    (`phase14a_classic`); (b) run_pipeline(architecture="classic",
    compute_metrics=True) held to RECON_BOUNDS["classic"]; (a) and (b)
    launch no kernel; (c) `depthmap_eval.evaluate` with the trained Vis
    asset over the 5 samples, its EPE within EVAL_EPE_REL of the metrics
    recomputed in numpy from the npz that run_depthmaps writes with the
    model Predictor loads, and two shards merged by `merge_parts` within
    MERGE_REL of the unsharded run; (d) the Gipuma and COLMAP workspaces
    exported from (b)'s caches, their depths read back through the codecs
    equal to the masked depths. Returns (the classic path's launch counts,
    the benchmark's, stats)."""
    ds = BenchScene(n=EVAL["n"], h=EVAL["h"], w=EVAL["w"], f=EVAL["f"])
    torch.cuda.synchronize()
    sk.reset_launch_counts()
    stats = {"classic": phase14a_classic(dev, ds)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        res = run_pipeline(ds, tmp / "classic", architecture="classic",
                           compute_metrics=True)
        torch.cuda.synchronize()
        classic_counts = sk.launch_counts()
        check(sum(classic_counts.values()) == 0,
              f"the classic path launched {classic_counts}")
        m = res["metrics"]
        min_points, bound_mm = RECON_BOUNDS["classic"]
        check(res["num_points"] >= min_points,
              f"classic: {res['num_points']} points")
        check(m["chamfer_pred_to_gt"] <= bound_mm
              and m["chamfer_gt_to_pred"] <= bound_mm,
              f"classic: chamfer {m} above {bound_mm} mm")
        stats["reconstruction"] = dict(
            stage_ms={k: v["total_s"] * 1e3
                      for k, v in res["stage_timings"].items()},
            num_points=res["num_points"], **m)

        # (c) the depthmap benchmark against the stage-1 npz
        depth_dir = tmp / "vis_depthmaps"
        run_depthmaps(ds, Predictor(VIS_ASSET).model, depth_dir)
        want = npz_metrics(ds, depth_dir)
        model, _, _ = load_network(VIS_ASSET, None, ds[0], "synthetic")
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        full = depthmap_eval.evaluate(ds, model)
        torch.cuda.synchronize()
        eval_counts = sk.launch_counts()
        check(eval_counts["sweep_gwc"] == 12 * ds.n
              and eval_counts["conv3d_head"] == vis_heads(ds.n) * ds.n,
              f"evaluate skipped a kernel: {eval_counts}")
        rel = abs(full["EPE"] - want["EPE"]) / want["EPE"]
        check(full["count"] == ds.n and rel <= EVAL_EPE_REL,
              f"evaluate {full} against the npz {want}")
        base = tmp / "parts" / "vis_5"
        base.parent.mkdir()
        for i in range(2):
            part = depthmap_eval.evaluate(ds, model, process_index=i,
                                          process_count=2)
            (base.parent / f"vis_5.part{i}.json").write_text(
                json.dumps(part))
        merged = depthmap_eval.merge_parts(base)
        merge_err = max(abs(merged[k] - full[k]) / max(abs(full[k]), 1e-12)
                        for k in ("EPE", "1pxError", "3pxError"))
        check(merged["count"] == ds.n and merge_err <= MERGE_REL,
              f"merged shards {merged} against {full}")
        stats["depthmap_eval"] = dict(
            **{k: full[k] for k in ("EPE", "1pxError", "3pxError",
                                    "seconds")},
            npz=want, epe_rel_err=rel, merge_rel_err=merge_err)
        del model

        # (d) the exporters on (b)'s caches
        cache = tmp / "classic" / "IntRes"
        d_dir = cache / "depthmaps" / "scene"
        f_dir = cache / "geometric_filtering" / "scene"
        t0 = time.perf_counter()
        gip = export.export_gipuma_workspace(ds, d_dir, tmp / "gipuma",
                                             filter_dir=f_dir, downscale=2)
        col = export.export_colmap_workspace(ds, d_dir, tmp / "colmap",
                                             filter_dir=f_dir)
        export_ms = (time.perf_counter() - t0) * 1e3
        kept = 0
        for i in range(ds.n):
            name = f"view_{i:04d}"
            with np.load(d_dir / f"{name}_out.npz") as z, \
                    np.load(f_dir / f"{name}_out.npz") as g:
                want_d = z["depthmap"].astype(np.float32)
                want_d[get_mask_invalid(z["probability"], 0.8,
                                        g["geo_mask"])] = 0.0
            got_dmb = read_dmb(gip / f"{export.GIPUMA_PREFIX}{name}"
                               / "disp.dmb")
            got_col = read_colmap_array(
                col / "stereo" / "depth_maps" / f"{name}.jpg.geometric.bin")
            check(np.array_equal(got_dmb, want_d)
                  and np.array_equal(got_col, want_d),
                  f"{name}: exported depths differ from the masked depth")
            kept += int((want_d > 0).sum())
        stats["export"] = dict(ms=export_ms, valid_pixels=kept)
    print(f"phase14 classic {EVAL['h']}x{EVAL['w']} N{ds.n} "
          f"D{CLASSIC['num_depth']} w{CLASSIC['window']} "
          f"ds{CLASSIC['downscale']}: " + json.dumps(stats), flush=True)
    return classic_counts, eval_counts, stats


# ---------------------------------------------------------------------------
# The native host helpers
# ---------------------------------------------------------------------------

DEDUP_RADIUS = 0.2              # the DTU protocol's dedup radius (mm)
#: phase 15's synthetic dense cloud: a wavy surface (amplitude 10 mm) over
#: 224 x 224 mm with 0.05 mm of noise, ~100 points a mm^2 (~12 within the
#: dedup radius), GT on a 1 mm grid of it (the chamfer cutoff 10 mm)
DENSE_CLOUD = dict(n=5_000_000, side=224.0, noise=0.05)
#: native decode and resize against PIL: the JAX package's bounds
#: (tests/test_native_image.py): the two libjpeg builds' IDCTs may differ
#: by a level; PIL resizes through 8 bits and clips Lanczos's overshoot
IMAGE_LIMITS = dict(decode_max=1.5 / 255, resize_mean=1 / 255,
                    resize_max=0.08)
LOADER_SAMPLES = 3              # BlendedMVS samples a path (3 views each)


@contextlib.contextmanager
def scipy_only():
    """metrics3d with the native tree unavailable: its cKDTree paths (the
    port's metrics before the native module)."""
    def unavailable(*args, **kwargs):
        raise RuntimeError("native tree switched off")

    saved = metrics3d.NativeKDTree, metrics3d._native_dedup
    metrics3d.NativeKDTree = metrics3d._native_dedup = unavailable
    try:
        yield
    finally:
        metrics3d.NativeKDTree, metrics3d._native_dedup = saved


def host_ms(fn):
    """(fn(), its host-clock ms)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def native_io(enabled: bool):
    """The loaders' native decode on or off (WILDMVS_NATIVE_IO)."""
    import os
    saved = os.environ.get("WILDMVS_NATIVE_IO")
    os.environ["WILDMVS_NATIVE_IO"] = "1" if enabled else "0"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["WILDMVS_NATIVE_IO"]
        else:
            os.environ["WILDMVS_NATIVE_IO"] = saved


def dense_cloud(seed: int = 0):
    """DENSE_CLOUD's points and its 1 mm GT grid, float64 [N, 3]."""
    n, side, noise = (DENSE_CLOUD[k] for k in ("n", "side", "noise"))

    def surface(x, y):
        return 10.0 * np.sin(x / 25.0) * np.cos(y / 35.0)

    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.0, side, (n, 2))
    pts = np.column_stack([xy, surface(xy[:, 0], xy[:, 1])
                           + rng.normal(0.0, noise, n)])
    gx, gy = np.meshgrid(np.arange(0.5, side, 1.0), np.arange(0.5, side, 1.0))
    gt = np.column_stack([gx.ravel(), gy.ravel(),
                          surface(gx.ravel(), gy.ravel())])
    return pts, gt


def native_metrics(name: str, pts: np.ndarray, gt: np.ndarray,
                   resolution: float) -> dict:
    """The metrics on one cloud, native against cKDTree: the dedup
    (reduce_pts, the DTU path) keep masks equal; eval_yfcc's NN distances
    both ways (the phase 11 / 14b metrics stage) within 1e-12 of cKDTree's
    clipped at the cutoff, and none beyond it; ms of each path."""
    cutoff = 10.0 * resolution
    (_, keep), dedup_ms = host_ms(
        lambda: metrics3d.reduce_pts(pts, DEDUP_RADIUS))
    raw, nn_ms = host_ms(lambda: metrics3d.eval_yfcc(pts, gt, resolution))
    with scipy_only():
        (_, keep_ref), dedup_ref_ms = host_ms(
            lambda: metrics3d.reduce_pts(pts, DEDUP_RADIUS))
        ref, nn_ref_ms = host_ms(
            lambda: metrics3d.eval_yfcc(pts, gt, resolution))
    nn_err = max(np.abs(raw[k] - np.minimum(ref[k], cutoff)).max()
                 for k in ref)
    res = dict(points=len(pts), gt_points=len(gt), kept=int(keep.sum()),
               dedup_ms=dedup_ms, dedup_ckdtree_ms=dedup_ref_ms,
               nn_ms=nn_ms, nn_ckdtree_ms=nn_ref_ms, nn_max_err=nn_err)
    print(f"phase15 {name}: {len(pts)} points, GT {len(gt)}: dedup r "
          f"{DEDUP_RADIUS} keeps {res['kept']}, native {dedup_ms:.1f} ms, "
          f"cKDTree loop {dedup_ref_ms:.1f} ms; NN both ways (cutoff "
          f"{cutoff:g}) native {nn_ms:.1f} ms, cKDTree {nn_ref_ms:.1f} ms, "
          f"max difference {nn_err:.3g}", flush=True)
    check(np.array_equal(keep, keep_ref),
          f"{name}: the native dedup's keep mask differs from the loop's")
    check(nn_err <= 1e-12 and all((raw[k] <= cutoff).all() for k in raw),
          f"{name}: native NN distances differ from cKDTree's by {nn_err}")
    return res


def write_blended(root: Path, views: int, h: int, w: int):
    """A BlendedMVS scene (JPEG + PFM + Yao cams, the loader's layout):
    a smooth field plus noise, as a JPEG of a photograph holds."""
    from PIL import Image
    scene = root / "scene"
    (scene / "cams").mkdir(parents=True)
    (scene / "blended_images").mkdir()
    (scene / "rendered_depth_maps").mkdir()
    lines = [str(views)]
    for v in range(views):
        srcs = [u for u in range(views) if u != v]
        lines += [str(v), f"{len(srcs)} " + " ".join(f"{u} 10.0"
                                                      for u in srcs)]
    (scene / "cams" / "pair.txt").write_text("\n".join(lines) + "\n")
    K = np.array([[600.0, 0, w / 2], [0, 600.0, h / 2], [0, 0, 1]])
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:h, 0:w]
    for v in range(views):
        name = f"{v:08d}"
        ext = np.eye(4)
        ext[0, 3] = 0.1 * v
        write_cam_txt(scene / "cams" / f"{name}_cam.txt", ext, K, 2.0, 0.05,
                      128, 2.0 + 128 * 0.05)
        base = 127 + 100 * (np.sin(xx / 17.0 + v) * np.cos(yy / 23.0))
        img = np.clip(base[..., None] + rng.normal(0, 20, (h, w, 3)), 0,
                      255).astype(np.uint8)
        Image.fromarray(img).save(scene / "blended_images" / f"{name}.jpg",
                                  quality=95)
        write_pfm(scene / "rendered_depth_maps" / f"{name}.pfm",
                  rng.uniform(2.0, 8.0, (h, w)).astype(np.float32))
    return ["scene"]


def native_images(step_ms: float, native_decode: bool) -> dict:
    """The loaders on the card's host: BlendedMVS val samples (576x768
    JPEG decode, PFM, crop; no augmentation) and read_images with
    MegaDepth's min-side 512 resize on the same files, ms a sample beside
    phase 5's step; through PIL, and, where the image module linked,
    natively too, held to PIL within IMAGE_LIMITS."""
    paths_taken = (True, False) if native_decode else (False,)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        scenes = write_blended(root, views=LOADER_SAMPLES, h=576, w=768)
        ds = loaders.BlendedMVSDataset(root, scenes, "val", 3)
        paths = sorted((root / "scene" / "blended_images").glob("*.jpg"))
        out = {}
        for enabled in paths_taken:
            with native_io(enabled):
                ds[0]                                   # warm the path
                samples, ms = host_ms(lambda: [ds[i] for i in range(len(ds))])
                resized, rms = host_ms(
                    lambda: loaders.read_images(paths, (512, 512)))
            out[enabled] = (samples, ms / len(ds), resized, rms / len(paths))
    pil, pil_ms, pil_r, pil_rms = out[False]
    res = dict(sample_pil_ms=pil_ms, resize_pil_ms=pil_rms, step_ms=step_ms)
    text = (f"PIL {pil_ms:.2f} ms a sample, {pil_rms:.2f} ms a resized "
            f"view")
    if native_decode:
        nat, nat_ms, nat_r, nat_rms = out[True]
        diffs = [np.abs(a - b) for (a, _), (b, _) in zip(nat_r, pil_r)]
        res.update(sample_ms=nat_ms, resize_ms=nat_rms,
                   decode_max=float(max(np.abs(a["imgs"] - b["imgs"]).max()
                                        for a, b in zip(nat, pil))),
                   resize_mean=float(np.mean([d.mean() for d in diffs])),
                   resize_max=float(max(d.max() for d in diffs)))
        text += (f"; native {nat_ms:.2f} and {nat_rms:.2f} ms; native vs "
                 f"PIL decode max {res['decode_max'] * 255:.3f}/255, resize "
                 f"mean {res['resize_mean'] * 255:.3f}/255 max "
                 f"{res['resize_max'] * 255:.3f}/255")
    print(f"phase15 loaders (BlendedMVS val, 3 views 576x768 JPEG + PFM; "
          f"MegaDepth's min-side 512 resize): {text}; phase 5's MVSNet step "
          f"{step_ms:.3f} ms", flush=True)
    if native_decode:
        check(res["decode_max"] <= IMAGE_LIMITS["decode_max"]
              and res["resize_mean"] <= IMAGE_LIMITS["resize_mean"]
              and res["resize_max"] <= IMAGE_LIMITS["resize_max"],
              f"native decode or resize against PIL outside {IMAGE_LIMITS}")
    return res


def phase15_native(clouds, step_ms: float) -> dict:
    """The native host helpers (wildmvs_torch/cpp) on the card's host: the
    library variant that built (the k-d tree must; the image module must
    link where libjpeg's and libpng's headers exist); the metrics on phase
    11's oracle cloud against its GT points and on DENSE_CLOUD
    (native_metrics); the loaders (native_images)."""
    lib = native.get_lib()            # main() built it before phase 1
    variant = native.variant()
    headers = all(Path("/usr/include", h).exists()
                  for h in ("jpeglib.h", "png.h"))
    print(f"phase15 native library: {variant} "
          f"({native.library_path(variant or 'kdtree').name}); "
          f"libjpeg/libpng headers {'present' if headers else 'absent'}",
          flush=True)
    check(lib is not None, "the native k-d tree did not build")
    check(variant == "full" or not headers,
          "the native image module did not link though its headers exist")
    oracle, gt = clouds
    return dict(variant=variant, headers=headers,
                oracle=native_metrics("oracle cloud", oracle, gt,
                                      BenchScene.gt_resolution),
                dense=native_metrics("dense cloud", *dense_cloud(), 1.0),
                loaders=native_images(step_ms, variant == "full"))


#: phase 16: the port's kernel launches per forward in each field of
#: `python -m wildmvs_torch.bench` under its defaults (fused at MVSNet's and
#: CVP's every level, rect canvases included; one gwc launch a Vis pair and
#: stage)
BENCH_LAUNCHES = {
    "headline": {"fused_cost_volume": 1, "conv3d_head": 1},
    "vis_mvsnet_maps_s": {"sweep_gwc": 6, "conv3d_head": 9},
    "cvp_mvsnet_maps_s": {"fused_cost_volume": 5, "conv3d_head": 5},
    "mvsnet_train_dtugeo_maps_s": {"fused_cost_volume": 1, "conv3d_head": 1},
    "mvsnet_eval_1184x1600_N5_maps_s": {"fused_cost_volume": 1,
                                        "conv3d_head": 1},
    "mvsnet_eval_1184x1600_N5_rect_maps_s": {"fused_cost_volume": 1,
                                             "conv3d_head": 1},
    "vis_eval_1184x1600_N5_maps_s": {"sweep_gwc": 12, "conv3d_head": 15},
    "vis_eval_1184x1600_N5_trained_maps_s": {"sweep_gwc": 12,
                                             "conv3d_head": 15},
    "cvp_eval_1184x1600_N5_maps_s": {"fused_cost_volume": 5,
                                     "conv3d_head": 5},
    "cvp_eval_1184x1600_N5_rect_maps_s": {"fused_cost_volume": 5,
                                          "conv3d_head": 5}}
BENCH_INFO = ("spread_pct", "median_ms", "launches", "peak_gib",
              "finite_share")
BENCH_TIMEOUT = 600              # seconds; the whole bench takes ~1-2 min


def bench_subprocess() -> dict:
    """`python -m wildmvs_torch.bench` under its defaults: its checks
    (phase16_bench), its last record returned."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("WILDMVS_BENCH_")}
    proc = subprocess.run([sys.executable, "-m", "wildmvs_torch.bench"],
                          cwd=Path(__file__).resolve().parent, env=env,
                          capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    for line in proc.stderr.splitlines():
        print(f"phase16 bench: {line}", flush=True)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines, f"the bench exited with "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    record = json.loads(lines[-1])
    bad = [k for k in record if k.endswith(("_error", "_skipped"))]
    check(not bad, f"bench fields failed or skipped: {bad}")
    for key, want in BENCH_LAUNCHES.items():
        value = record["value" if key == "headline" else key]
        prefix = "headline" if key == "headline" else key
        info = {k: record.get(f"{prefix}_{k}") for k in BENCH_INFO}
        missing = [k for k, v in info.items() if v is None]
        check(not missing, f"bench {key}: no {missing}")
        check(value > 0 and np.isfinite(value), f"bench {key}: {value}")
        check(info["finite_share"] == 1.0, f"bench {key}: finite_share "
              f"{info['finite_share']}")
        check(info["launches"] == want, f"bench {key}: launches "
              f"{info['launches']}, expected {want}")
        print(f"phase16 {key}: {value:.4f} maps/s, median "
              f"{info['median_ms']:.3f} ms, spread {info['spread_pct']:.2f} "
              f"%, peak {info['peak_gib']:.3f} GiB, launches "
              f"{info['launches']}", flush=True)
    print(f"phase16 bench record: {lines[-1]}", flush=True)
    return record


def held_launches(phase: str, label: str, errs: dict):
    """An `on_launch` hook that holds each launch to its plain version on
    its own inputs under phase 1's limits (compare for the forward
    kernels, the non-finite elements of both equal; the backward's f32
    accumulation within 1e-4 of its scale) and keeps each kernel's
    largest error in `errs`."""
    def hook(name, inputs, out):
        want = sk.PLAIN[name](*inputs)
        torch.cuda.synchronize()
        what = f"{label} {name} {tuple(out.shape)}"
        if name == "sweep_warp_backward":
            scale = max(want.abs().max().item(), 1e-6)
            err = (out - want).abs().max().item()
            print(f"{phase} {what}: f32 max_abs_err {err:.6g} limit "
                  f"{1e-4 * scale:.6g} (scale {scale:.4g})", flush=True)
            check(err <= 1e-4 * scale, f"{what}: {err} > {1e-4 * scale}")
        else:
            ok_g, ok_w = torch.isfinite(out), torch.isfinite(want)
            check(torch.equal(ok_g, ok_w), f"{what}: kernel and plain "
                  f"differ in their non-finite elements")
            err = compare(what, torch.where(ok_g, out.float(), 0.0),
                          torch.where(ok_w, want.float(), 0.0), phase=phase)
        errs[name] = max(errs.get(name, 0.0), err)
    return hook


def bench_forwards(dev) -> dict:
    """One forward of each bench field in this process, each kernel
    launch held to its plain version on its own inputs (held_launches),
    the depth finite. Returns the launches of these forwards: the path
    "bench"."""
    errs = {}

    sk.reset_launch_counts()
    for field in port_bench.fields():
        model, args = port_bench.build(field, dev)
        with torch.inference_mode(), \
                sk.on_launch(held_launches("phase16", field.key, errs)):
            depth = model(*args, **field.forward)["depth"]
        check(bool(torch.isfinite(depth).all()), f"{field.key}: depth not "
              f"finite")
        del model, args, depth
        torch.cuda.empty_cache()
    counts = sk.launch_counts()
    want = {}
    for per_forward in BENCH_LAUNCHES.values():
        for name, n in per_forward.items():
            want[name] = want.get(name, 0) + n
    check({k: v for k, v in counts.items() if v} == want,
          f"bench forwards launched {counts}, expected {want}")
    print(f"phase16 bench forwards: launches {counts}, max_abs_err by "
          f"kernel {errs}", flush=True)
    return counts


def phase16_bench(dev) -> dict:
    """The port's benchmark. (a) `python -m wildmvs_torch.bench` in a
    subprocess under its defaults (PyTorch's default TF32 flags; the
    kernel library built above is loaded, not rebuilt): exit code 0,
    every field > 0 and finite with each diagnostic of BENCH_INFO,
    finite_share 1, no field failed or skipped, the launches a forward of
    BENCH_LAUNCHES. (b) bench_forwards: one forward of every field in
    this process, every launch held to its plain version at the bench's
    own shapes and rigs. Returns (b)'s launches."""
    bench_subprocess()
    return bench_forwards(dev)


# ---------------------------------------------------------------------------
# The quality drive (phase 17)
# ---------------------------------------------------------------------------

#: phase 17: the quality drive as the JAX package's quality test runs its
#: tool (tests/test_quality_validation.py:165-207): the JAX recipes for 40
#: epochs, scored at the confidence gate 0.05 on the held-out 64x96 5-view
#: scene (scene seed 0)
E2E_EPOCHS = 40
E2E_THRESHOLD = 0.05
E2E_ARCHS = ("oracle", "mvsnet", "vis_mvsnet", "cvp_mvsnet")
#: the JAX package's bounds (tests/test_quality_validation.py:196-207): the
#: fused cloud's least points, the most stage-1 depth EPE (intervals) and
#: chamfer accuracy (scene units; the oracle's strictly below). CVP is
#: printed, not held: it does not converge on the 8 tiny training scenes
#: (BASELINE.md:746-750)
E2E_BOUNDS = {"oracle": dict(points=5000, acc=0.006),
              "mvsnet": dict(points=1000, epe=7.5, acc=0.20),
              "vis_mvsnet": dict(points=150, epe=11.5, acc=0.20)}
E2E_TIMEOUT = 900                # seconds; the drive takes ~1-2 min
E2E_DIR = Path(__file__).resolve().parent / "build" / "e2e"


def phase17a_quality_drive() -> dict:
    """`python -m wildmvs_torch.tools.e2e_quality` in a subprocess under
    PyTorch's default flags (users train under them), the kernel library
    built above, the three trainings at once on the card: exit code 0,
    one row an architecture, none an error row, each held to E2E_BOUNDS.
    Returns {"rows": {arch: row}, "drive_s": seconds}."""
    shutil.rmtree(E2E_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "wildmvs_torch.tools.e2e_quality",
         "--epochs", str(E2E_EPOCHS), "--prob_threshold",
         str(E2E_THRESHOLD), "--archs", ",".join(E2E_ARCHS), "--device",
         "cuda", "--workdir", str(E2E_DIR)],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=E2E_TIMEOUT)
    seconds = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        print(f"phase17 drive: {line}", flush=True)
    rows = {}
    for line in proc.stdout.splitlines():
        with contextlib.suppress(json.JSONDecodeError):
            row = json.loads(line)
            if isinstance(row, dict) and "arch" in row:
                rows[row["arch"]] = row
                print(f"phase17 row {line}", flush=True)
    check(proc.returncode == 0, f"the quality drive exited with "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    check(sorted(rows) == sorted(E2E_ARCHS), f"the drive gave rows for "
          f"{sorted(rows)}, expected {sorted(E2E_ARCHS)}")
    bad = {a: r["error"] for a, r in rows.items() if "error" in r}
    check(not bad, f"the drive failed: {bad}")
    for arch, bound in E2E_BOUNDS.items():
        r = rows[arch]
        ok = (r["num_points"] >= bound["points"] and r["acc"] is not None
              and (r["acc"] < bound["acc"] if arch == "oracle"
                   else r["acc"] <= bound["acc"])
              and r.get("depth_epe_itv", 0.0) <= bound.get("epe", np.inf))
        print(f"phase17 {arch}: {r['num_points']} points (>= "
              f"{bound['points']}), EPE {r.get('depth_epe_itv')} (<= "
              f"{bound.get('epe')}), acc {r['acc']} (<= {bound['acc']}), "
              f"comp {r['comp']}, train_s {r.get('train_s')}: "
              f"{'held' if ok else 'MISSED'}", flush=True)
        check(ok, f"phase17 {arch}: {r} outside {bound}")
    print(f"phase17a drive took {seconds:.1f} s (train_s "
          f"{ {a: r.get('train_s') for a, r in rows.items()} })",
          flush=True)
    return {"rows": rows, "drive_s": seconds}


def phase17b_trained_nets(dev):
    """The networks phase 17a trained, in this process: each checkpoint
    through load_network (the pipeline's bf16 eval: fused for MVSNet, gwc
    for Vis, rect canvases into fused for CVP), one eval forward on the
    held-out scene's first view, and one training step of the drive's
    recipe at its shapes (64x96 N3) from the trained weights with bf16
    compute (the drive trains in f32, which takes the exact gather in
    both packages: the kernels are bf16, as the Pallas kernels are), every
    kernel launch held to its plain version on its own inputs
    (held_launches). The card's first launches below 64x80. Returns (the
    path's launches, {kernel: largest error})."""
    scene = SyntheticSceneDataset(**e2e_quality.SCENE)
    sample = scene[0]
    train_batch = T.batch_to_device(collate([SyntheticMVSDataset(
        num_samples=8, num_views=3, seed=1)[0]]), dev)
    errs = {}
    sk.reset_launch_counts()
    for arch in E2E_ARCHS[1:]:
        logdir = E2E_DIR / f"train_{arch}"
        model, _, nscale = load_network(logdir, None, sample, "synthetic",
                                        device=dev)
        extra = {} if nscale is None else {"nscale": nscale}
        args = [torch.as_tensor(np.asarray(sample[k], np.float32),
                                device=dev)[None]
                for k in ("imgs", "K", "R", "t", "depth_min", "depth_max")]
        n0 = sk.launch_counts()
        with torch.inference_mode(), sk.on_launch(
                held_launches("phase17b", f"{arch} eval", errs)):
            out = model(*args, **extra)
        check(bool(torch.isfinite(out["depth"]).all()),
              f"phase17b {arch}: eval depth not finite")
        evals = {k: v - n0[k] for k, v in sk.launch_counts().items()}
        del model
        flags = e2e_quality.TRAIN_ARGS[arch]
        recipe = dict(zip(flags[::2], flags[1::2]))
        cfg = TrainConfig(architecture=arch, dataset="synthetic",
                          num_depth=int(recipe.get("--num_depth", 192)),
                          lr=float(recipe["--lr"]),
                          train_dtype="bfloat16")
        state = T.create_train_state(cfg, dev)
        sd = torch.load(sorted(logdir.glob("model_*.ckpt"))[-1],
                        map_location=dev, weights_only=True)["model"]
        state.model.load_state_dict(sd)
        n0 = sk.launch_counts()
        with sk.on_launch(held_launches("phase17b", f"{arch} train",
                                        errs)):
            state, m = T.train_step(state, train_batch, cfg)
        loss = m["train_loss"].item()
        steps = {k: v - n0[k] for k, v in sk.launch_counts().items()}
        check(np.isfinite(loss) and steps["sweep_warp"] > 0
              and steps["sweep_warp"] == steps["sweep_warp_backward"]
              and steps["conv3d_head"] == 0,
              f"phase17b {arch}: the training step launched {steps}, "
              f"loss {loss}")
        print(f"phase17b {arch}: eval launches {evals}; train step loss "
              f"{loss:.4f}, launches {steps}", flush=True)
        del state
    counts = sk.launch_counts()
    check(all(counts[k] > 0 for k in sk.KERNELS), f"phase17b launched "
          f"{counts}: a kernel of the e2e path never ran")
    print(f"phase17b launches {json.dumps(counts)}, max_abs_err by kernel "
          f"{errs}", flush=True)
    return counts, errs


def phase17_quality(dev):
    """Phase 17: the drive (a) and its trained networks in this process
    (b); the path "e2e" is (b)'s launches."""
    t0 = time.perf_counter()
    drive = phase17a_quality_drive()
    counts, errs = phase17b_trained_nets(dev)
    drive["phase_s"] = time.perf_counter() - t0
    drive["max_abs_err"] = errs
    print(f"phase17 took {drive['phase_s']:.1f} s", flush=True)
    return counts, drive


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    # f32 comparisons run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = port_bench.card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.load()
    print(f"built {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_log().splitlines():
        if re.search(r"registers|spill|Compiling entry", line):
            print(f"ptxas: {line.strip()}", flush=True)
    # the native host helpers (cpp/), built here so that no phase's
    # metrics stage pays for g++
    t1 = time.perf_counter()
    native.get_lib()
    print(f"native library {native.variant()} built and loaded in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)

    kernels = phase1_rect_kernels(dev, phase1_vis_kernels(
        dev, phase1_kernels(dev)))
    phase1_channels(dev)
    phase1_conv_head(dev, kernels)
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
    torch.cuda.empty_cache()
    cvp_counts, cvp_serving = phase8_cvp_serving(kernels)
    torch.cuda.empty_cache()
    cvp_train_counts, cvp_training = phase9_cvp_training(dev)
    torch.cuda.empty_cache()
    rect_counts, rect_serving = phase10_rect_serving()
    torch.cuda.empty_cache()
    recon_counts, reconstruction, clouds = phase11_reconstruction()
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    unsup_counts, unsup_training = phase12_unsup_training(
        dev, training["peak_gib"])
    unsup_training["phase_s"] = time.perf_counter() - t12
    print(f"phase12 took {unsup_training['phase_s']:.1f} s of "
          f"{time.perf_counter() - t0:.1f} s since the build began",
          flush=True)
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    dist_counts, distributed = phase13_distribution(
        dev, unsup_training["mvsnet_occ"]["step_ms_median"])
    distributed["phase_s"] = time.perf_counter() - t13
    print(f"phase13 took {distributed['phase_s']:.1f} s of "
          f"{time.perf_counter() - t0:.1f} s since the build began",
          flush=True)
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    classic_counts, eval_counts, tools = phase14_classic_and_tools(dev)
    tools["phase_s"] = time.perf_counter() - t14
    print(f"phase14 took {tools['phase_s']:.1f} s of "
          f"{time.perf_counter() - t0:.1f} s since the build began",
          flush=True)
    t15 = time.perf_counter()
    native_host = phase15_native(clouds, training["step_ms_median"])
    native_host["phase_s"] = time.perf_counter() - t15
    print(f"phase15 took {native_host['phase_s']:.1f} s of "
          f"{time.perf_counter() - t0:.1f} s since the build began",
          flush=True)

    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    bench_counts = phase16_bench(dev)
    print(f"phase16 took {time.perf_counter() - t16:.1f} s of "
          f"{time.perf_counter() - t0:.1f} s since the build began",
          flush=True)
    torch.cuda.empty_cache()
    e2e_counts, quality = phase17_quality(dev)
    print(f"phase17 ended {time.perf_counter() - t0:.1f} s after the build "
          f"began", flush=True)

    # launches: each path's own, counted from 0 just before its run
    paths = {"mvsnet_serving": counts, "mvsnet_training": train_counts,
             "vis_serving": vis_counts, "vis_training": vis_train_counts,
             "cvp_serving": cvp_counts, "cvp_training": cvp_train_counts,
             "rect_serving": rect_counts, "reconstruction": recon_counts,
             "unsup_training": unsup_counts, "distributed": dist_counts,
             "classic": classic_counts, "depthmap_eval": eval_counts,
             "bench": bench_counts, "e2e": e2e_counts}
    for name, k in kernels.items():
        k["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        k["launches"] = sum(c[name] for c in paths.values())
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "events_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "staged_share", "launches_by_path"]
    extra = ["device_atomics", "softmin_ms", "views", "vis", "stage1",
             "stage2", "cvp", "rect", "shapes"]
    for k in kernels.values():
        k.setdefault("staged_share", None)      # kernels without footprints
    print(json.dumps({"kernels": [{k: v[k] for k in keys + extra if k in v}
                                  for v in kernels.values()],
                      "serving": serving, "eval": evals,
                      "training": training, "vis_serving": vis_serving,
                      "vis_training": vis_training,
                      "cvp_serving": cvp_serving, "cvp_training": cvp_training,
                      "rect_serving": rect_serving,
                      "reconstruction": reconstruction,
                      "unsup_training": unsup_training,
                      "distributed": distributed,
                      "classic_and_tools": tools,
                      "native_host": native_host, "quality": quality,
                      "card": card}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
