"""The port's plane-sweep kernels: wrappers, plain versions, launch counts.

Four hand-written CUDA kernels for Hopper (csrc/sweep.cu, csrc/warp.cu,
built on first use by _build.py) replace the five Pallas TPU kernels of
wildmvs/ops/mosaic_sweep.py. All four share one block structure
(csrc/footprint.cuh): a block owns 8x8 reference pixels x C/8 threads,
one thread per (pixel, 8-channel slice), over a run of
FOOTPRINT_D_RUN hypotheses, and loads the tile's planes and the run's
hypotheses once. The three forward kernels read their samples from the
box of source cells that the tile's samples over the run reach, copied
into shared memory (exact: a sample outside the box reads device memory).

  sweep_warp          <- _kernel / mosaic_sweep_warp (:143-270) and
      _kernel_px / mosaic_sweep_warp_px (:298-624). One source view warped
      over D hypotheses -> [B, D, H, W, C] bf16, in either convention.
      Bound: HBM bytes. At the 512x640 headline (128x160 features, C=32,
      D=192) it writes 251.7 MB and reads about 1.8 MB (source map plus
      the P/Q planes): about 76 us at 3.35 TB/s; on the card the
      instructions of its samples set the pace. Design (csrc/warp.cu, the
      loop of sweep_gwc): the block stages the tile's bf16 footprint over
      a run of FOOTPRINT_D_RUN hypotheses, the C/8 threads of a pixel share
      the taps of C/8 hypotheses at a time, and each thread stores its 8
      channels with a streaming store. Differentiable in the features
      through SweepWarpFn.
  sweep_warp_backward <- _kernel_scatter_px / mosaic_scatter_px
      (:1930-2088). The warp's transpose: gradient g [B, D, H, W, C] bf16
      -> source-feature gradient [B, h, w, C], accumulated in f32.
      Bound: HBM bytes (251.7 MB of g read at the headline, ~76 us); on the
      card its 16-byte f32 atomics into device memory set the pace.
      Design (csrc/sweep.cu): the C/8 threads of a pixel share the taps
      of C/8 hypotheses at a time; a thread sums its four corners in
      registers while its sample stays in one source cell, keeps the two
      corners that a move of one cell shares and adds the others into the
      gradient with 16-byte atomics. (An f32 accumulator of the tile's
      footprint in shared memory measured slower: PERF.md.) No one-hot
      MXU contraction, KY/NTS window or channel split: an atomic scatter
      has no window.
  sweep_gwc           <- _kernel_px_gwc / mosaic_sweep_warp_px_gwc
      (:627-791). The Vis-MVSNet per-pair cost volume: the warp fused with
      the group-wise correlation against the reference features ->
      [B, D, H, W, 8] bf16; the warped volume never reaches HBM.
      Bound: HBM bytes. At the 1184x1600 eval's stage 3 (592x800, C=32,
      D=16, per-pixel hypotheses) it writes 121.2 MB and reads about
      102 MB (reference, source, hypotheses, planes): about 67 us at
      3.35 TB/s. On the card it is bound by the instructions of its
      samples. Design (csrc/warp.cu): the warp's loop; each thread sums
      its own groups and the pixel's threads write its 16 output bytes
      with streaming stores. No backward: it serves eval only (training
      warps with sweep_warp).
  fused_cost_volume   <- _kernel_fused / fused_cost_volume_px (:811-1117).
      All NV source views in one launch; variance (sum, sum of squares) or
      softmin (sum e*diff, sum e) statistics in f32 registers; only the
      final [B, D, H, W, C] bf16 volume is written.
      Bound: HBM bytes at the headline, 251.7 MB out + about 5 MB in
      (~77 us); at 1184x1600 N5 the f32 operations (~0.52 ms) about equal
      the 1.455 GB out + about 50 MB in (~0.45 ms). On the card it is bound
      by the instructions of its samples. Design (csrc/sweep.cu): the block
      copies each view's footprint over a run of FOOTPRINT_D_RUN
      hypotheses into one stage buffer (sized by NV so that the block
      keeps 3 blocks on an SM, `fused_plan`), then walks the hypotheses
      with the views inside;
      the C/8 threads of a pixel each compute one view's taps and share
      them by shuffles, and an xor-shuffle channel sum across them gives
      softmin's per-pixel weight; streaming stores.

The footprint rule of the forward kernels is `sweep_footprints`, their
launch geometry `footprint_plan` and `fused_plan` (the backward's tile is
`_tile_rows`); inside `counting_tiles()` their launches count their
staged and global stages on the card, and the backward its atomics (the
model paths count nothing).

None carries over the TPU's corner table, span plans, KY/KR/NT window
tiers, lax.cond gather fallbacks, row/lane padding or depth pairing: a
Hopper gather has no window, so the kernels are exact for any rig.
`fused_cost_volume` and `sweep_gwc` have no backward and refuse inputs
that require grad.

One projection form serves every kernel: for reference pixel (y, x) and
hypothesis s (per plane [D] or per pixel [D, H, W]),
  (rx, ry, rz) = P[:, y, x] * s + Q[:, y, x],
  x = clamp((rz > 0 ? rx / rz : -10) * sx, x_lo, x_hi)   (y alike)
in source pixels (mosaic_sweep.py:328-338), in one of two conventions:
  MVSNet (`mvsnet_planes`): integer reference grid, s = depth, scale
    (1, 1), no clamp: coords = (rx, ry) / rz, and a point behind the
    camera samples zero.
  Vis-MVSNet (`vis_planes`): pixel-centre grid, P = -B p, Q = A p (the
    homography H(d) = A - B/d), s = 1 / (d + 1e-9), scale ((w-1)/w,
    (h-1)/h) and the reference's normalized [-1.1, 1.1] clamp, which is
    [-0.05 (w-1), 1.05 (w-1)] in source pixels. On a source narrower than
    21 px the clamp lies inside (-1, 0), so a clamped or behind-camera
    sample reads pixel 0 as the exact gather does (the JAX package keeps
    such sources off its kernels, mosaic_sweep.py:1493-1500; the port's
    kernels are exact for them).
Coordinates, bilinear weights and the combine are f32; features are read
as bf16; each output is rounded once to bf16. (The Pallas kernels combine
with bf16 weights in bf16, and the gwc kernel rounds the warped value to
bf16 before its products; the port's f32 combine differs from them by
bf16 rounding, by design.)

The backward's adds are f32 atomics in an order that changes from run to
run, so two runs may differ in the last f32 bits.

Each wrapper takes its plain PyTorch version only for tensors on the CPU.
For CUDA tensors it launches its kernel or raises; it never falls back.
`<wrapper>.launches` counts kernel launches (never plain calls).

`warp_work`, `warp_backward_work`, `gwc_work` and `fused_work` count what
one launch must do on its inputs (bytes in and out, operations from the
live samples) and `bound` turns that into the least time at the H100's
peaks: chip_smoke.py's kernel bounds read them. Inside `on_launch(hook)`
each launch calls hook(kernel name, inputs, output), its inputs in the
order of its plain version (chip_smoke.py holds each launch to it).
`KERNELS` and `PLAIN` hold every kernel of the port by name; the kernels
of other ops modules join them through `register` (ops/conv_head).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..geometry.projective import pixel_grid

AGGREGATIONS = ("variance", "softmin")
#: groups of the group-wise correlation (Vis-MVSNet, model_cas.py:176-187)
GWC_GROUPS = 8


# ---------------------------------------------------------------------------
# projection planes
# ---------------------------------------------------------------------------

def mvsnet_planes(src_proj: torch.Tensor, ref_proj: torch.Tensor,
                  ref_hw: tuple[int, int]):
    """(P, Q) planes of the MVSNet sweep, coords = (P*d + Q)_xy / (P*d + Q)_z.

    Counterpart of rot_planes/mvsnet_planes (mosaic_sweep.py:86-99,
    392-399): P = rot @ [x, y, 1] over the integer reference grid, Q the
    relative translation broadcast per pixel.

    Args:
      src_proj, ref_proj: [B, 4, 4] projections at feature resolution.
      ref_hw: (H, W) of the reference grid.
    Returns:
      (P, Q): contiguous [B, 3, H, W] f32 planes.
    """
    rh, rw = ref_hw
    proj = (src_proj.float() @ torch.linalg.inv(ref_proj.float()))
    rot, trans = proj[:, :3, :3], proj[:, :3, 3]
    grid = pixel_grid(rh, rw, torch.float32, proj.device)
    xyz = torch.cat([grid, torch.ones_like(grid[..., :1])], -1)
    P = torch.einsum("bij,hwj->bihw", rot, xyz).contiguous()
    Q = trans[:, :, None, None].expand_as(P).contiguous()
    return P, Q


#: the MVSNet convention's coordinate scale (and no clamp)
UNIT_SCALE = (1.0, 1.0)


def vis_planes(K_ref, R_ref, t_ref, K_src, R_src, t_src,
               ref_hw: tuple[int, int], src_hw: tuple[int, int]):
    """(P, Q, scale, clamp) of the Vis-MVSNet homography sweep; sample with
    s = 1 / (depth + 1e-9) (`inverse_depths`).

    Counterpart of vis_planes (mosaic_sweep.py:402-427), batched: over the
    pixel-centre (+0.5) reference grid p, P = -B p and Q = A p with the
    plane-induced homography H(d) = A - B/d of homography_sweep_grid_xy
    (wildmvs/ops/plane_sweep.py:209-260); the reference normalizes the
    coordinates by the source size and unnormalizes them align_corners,
    a net scale ((w-1)/w, (h-1)/h), after clamping the normalized value to
    [-1.1, 1.1], which is [-0.05 (size-1), 1.05 (size-1)] in pixels.

    Args:
      K_ref, R_ref, K_src, R_src: [B, 3, 3]; t_ref, t_src: [B, 3, 1].
      ref_hw, src_hw: (H, W) of the reference grid and of the source map.
    Returns:
      P, Q: contiguous [B, 3, H, W] f32 planes; scale (sx, sy);
      clamp (x_lo, x_hi, y_lo, y_hi) in source pixels.
    """
    rh, rw = ref_hw
    sh, sw = src_hw
    K_ref, R_ref, t_ref, K_src, R_src, t_src = (
        a.float() for a in (K_ref, R_ref, t_ref, K_src, R_src, t_src))
    K_ref_inv = torch.linalg.inv(K_ref)
    R_ref_T = R_ref.transpose(-1, -2)
    fronto = R_ref[:, 2:3, :]
    c_rel = (-R_src.transpose(-1, -2) @ t_src) - (-R_ref_T @ t_ref)
    M = K_src @ R_src
    A = M @ R_ref_T @ K_ref_inv
    Bm = M @ (c_rel @ fronto) @ R_ref_T @ K_ref_inv
    grid = pixel_grid(rh, rw, torch.float32, K_ref.device, offset=0.5)
    hom = torch.cat([grid, torch.ones_like(grid[..., :1])], -1)
    Q = torch.einsum("bij,hwj->bihw", A, hom).contiguous()
    P = (-torch.einsum("bij,hwj->bihw", Bm, hom)).contiguous()
    scale = ((sw - 1.0) / sw, (sh - 1.0) / sh)
    clamp = (-0.05 * (sw - 1), 1.05 * (sw - 1),
             -0.05 * (sh - 1), 1.05 * (sh - 1))
    return P, Q, scale, clamp


def inverse_depths(depth: torch.Tensor) -> torch.Tensor:
    """The Vis convention's hypotheses s = 1 / (depth + 1e-9), f32."""
    return 1.0 / (depth.float() + 1e-9)


def vis_svals(depth_num: int, depth_start: torch.Tensor,
              depth_interval: torch.Tensor,
              ref_hw: tuple[int, int]) -> torch.Tensor:
    """The Vis sweep's hypotheses `inverse_depths(start + interval * i)`,
    i < depth_num, contiguous f32: [B, D] for a uniform depth_start
    [B, 1, 1, 1], [B, D, H, W] for a per-pixel one [B, 1, H, W]."""
    steps = torch.arange(depth_num, dtype=torch.float32,
                         device=depth_start.device).reshape(1, -1, 1, 1)
    s = inverse_depths(depth_start.float() + depth_interval.float() * steps)
    if s.shape[2:] == (1, 1):
        return s[:, :, 0, 0].contiguous()
    return s.expand((s.shape[0], depth_num) + tuple(ref_hw)).contiguous()


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch)
# ---------------------------------------------------------------------------

def _project(P: torch.Tensor, Q: torch.Tensor, s: torch.Tensor):
    """P, Q [B, 3, H, W]; s [B, D] or [B, D, H, W] -> rx, ry, rz [B, D, H, W]."""
    s = s[:, :, None, None] if s.dim() == 2 else s
    r = P[:, :, None] * s[:, None] + Q[:, :, None]
    return r[:, 0], r[:, 1], r[:, 2]


def source_coords(rx, ry, rz, scale=UNIT_SCALE, clamp=None):
    """(x, y) source-pixel coordinates of projective points in a
    convention: (rz > 0 ? r / rz : -10) * scale, then the clamp (None:
    none)."""
    pos = rz > 0
    safe_z = torch.where(pos, rz, torch.ones_like(rz))
    x = torch.where(pos, rx / safe_z, -10.0)
    y = torch.where(pos, ry / safe_z, -10.0)
    if tuple(scale) != UNIT_SCALE:
        x = x * scale[0]
        y = y * scale[1]
    if clamp is not None:
        x = x.clamp(clamp[0], clamp[1])
        y = y.clamp(clamp[2], clamp[3])
    return x, y


def _taps(rx, ry, rz, h: int, w: int, scale=UNIT_SCALE, clamp=None):
    """The four bilinear taps of each sample at `source_coords` on a source
    of h x w pixels seen through a one-pixel zero ring [h+2, w+2].

    A sample is live when floor(x) in [-1, w-1] and floor(y) in [-1, h-1]
    (behind the camera, x = -10 * sx: dead unless a clamp moves it); its
    corners outside the image fall on the ring. A dead sample has weight 0
    at ring index 0.
    Returns (idx [B, M] ring index of the top-left corner, offsets of the
    four corners, weights: four f32 [B, ..., 1])."""
    b = rx.shape[0]
    x, y = source_coords(rx, ry, rz, scale, clamp)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    live = ((x0f >= -1) & (x0f <= w - 1)
            & (y0f >= -1) & (y0f <= h - 1))
    fx = x - x0f
    fy = y - y0f
    zero = torch.zeros_like(fx)
    wts = [torch.where(live, wt, zero)[..., None]
           for wt in ((1 - fy) * (1 - fx), (1 - fy) * fx,
                      fy * (1 - fx), fy * fx)]
    ix = torch.where(live, x0f + 1, zero).long()           # ring coords
    iy = torch.where(live, y0f + 1, zero).long()
    idx = (iy * (w + 2) + ix).reshape(b, -1)
    return idx, (0, 1, w + 2, w + 3), wts


def _sample_f32(img: torch.Tensor, rx, ry, rz, dtype=torch.float32,
                scale=UNIT_SCALE, clamp=None) -> torch.Tensor:
    """Bilinear border-zero sample of img [B, h, w, C] at the projective
    points (rx, ry, rz) in a convention (`_taps`). Returns the unrounded
    values in `dtype`, [B, ..., C]."""
    b, h, w, c = img.shape
    idx, offs, wts = _taps(rx, ry, rz, h, w, scale, clamp)
    flat = F.pad(img, (0, 0, 1, 1, 1, 1)).reshape(b, -1, c)
    rows = torch.arange(b, device=img.device)[:, None]
    acc = None
    for off, wt in zip(offs, wts):
        corner = flat[rows, idx + off].reshape(rx.shape + (c,)).to(dtype)
        term = wt.to(dtype) * corner
        acc = term if acc is None else acc + term
    return acc


def _scatter_f32(g: torch.Tensor, rx, ry, rz, src_hw: tuple[int, int],
                 dtype=torch.float32, scale=UNIT_SCALE,
                 clamp=None) -> torch.Tensor:
    """The exact transpose of `_sample_f32`: g [B, ..., C] -> df [B, h, w,
    C] in `dtype`, each sample's four weighted corners added with
    index_add_ into the zero ring, which is then cut away."""
    h, w = src_hw
    b, c = g.shape[0], g.shape[-1]
    idx, offs, wts = _taps(rx, ry, rz, h, w, scale, clamp)
    ring = torch.zeros((b * (h + 2) * (w + 2), c), dtype=dtype,
                       device=g.device)
    base = (torch.arange(b, device=g.device) * ((h + 2) * (w + 2)))[:, None]
    gv = g.to(dtype)
    for off, wt in zip(offs, wts):
        ring.index_add_(0, (idx + off + base).reshape(-1),
                        (wt.to(dtype) * gv).reshape(-1, c))
    return ring.reshape(b, h + 2, w + 2, c)[:, 1:h + 1, 1:w + 1]


def sweep_warp_plain(src, P, Q, s, scale=UNIT_SCALE,
                     clamp=None) -> torch.Tensor:
    """Plain PyTorch version of the `sweep_warp` kernel (same arguments)."""
    return _sample_f32(src, *_project(P, Q, s), scale=scale,
                       clamp=clamp).to(torch.bfloat16)


def sweep_warp_backward_plain(g, P, Q, s, src_hw, scale=UNIT_SCALE,
                              clamp=None) -> torch.Tensor:
    """Plain PyTorch version of the `sweep_warp_backward` kernel: the f32
    accumulation [B, h, w, C], before any cast."""
    return _scatter_f32(g, *_project(P, Q, s), src_hw, scale=scale,
                        clamp=clamp).contiguous()


def sweep_gwc_plain(src, ref, P, Q, s, scale=UNIT_SCALE, clamp=None,
                    groups: int = GWC_GROUPS) -> torch.Tensor:
    """Plain PyTorch version of the `sweep_gwc` kernel: the f32 warp
    (unrounded), times the reference features, summed over each group's
    C/groups channels in f32, rounded once to bf16 -> [B, D, H, W, groups]."""
    warped = _sample_f32(src, *_project(P, Q, s), scale=scale, clamp=clamp)
    prod = ref.float()[:, None] * warped
    corr = prod.reshape(prod.shape[:-1] + (groups, -1)).sum(-1)
    return corr.to(torch.bfloat16)


def fused_cost_volume_plain(ref, srcs, P, Q, s, temp=None,
                            agg: str = "variance") -> torch.Tensor:
    """Plain PyTorch version of the `fused_cost_volume` kernel."""
    nv = srcs.shape[1]
    refv = ref.float()[:, None]                            # [B, 1, H, W, C]
    if agg == "variance":
        a1, a2 = refv, refv * refv
    else:
        a1, sum_exp = 0.0, 0.0
        tmp = temp.float().reshape(()) if torch.is_tensor(temp) else temp
    for v in range(nv):
        wv = _sample_f32(srcs[:, v], *_project(P[:, v], Q[:, v], s))
        if agg == "variance":
            a1 = a1 + wv
            a2 = a2 + wv * wv
        else:
            diff = (refv - wv) ** 2
            e = torch.exp(-tmp * diff.sum(-1, keepdim=True))
            sum_exp = sum_exp + e
            a1 = a1 + e * diff
    if agg == "variance":
        n = float(nv + 1)
        mean = a1 / n
        cv = a2 / n - mean * mean
    else:
        cv = a1 / (sum_exp + 1e-6)
    return cv.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the work of a launch: bytes, operations and the bound they set
# ---------------------------------------------------------------------------

#: the H100 SXM's published peaks (NVIDIA's data sheet, at a 700 W limit):
#: HBM3 bytes a second, f32 operations a second outside the tensor cores,
#: and dense bf16 tensor-core operations a second (f32 accumulation)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


class KernelWork(NamedTuple):
    """What one launch must do on its inputs: `bytes` (each input read
    once, the output written once), `operations` (f32, counted from the
    live samples) and `live_samples`."""
    bytes: int
    operations: int
    live_samples: int


def live_samples(P, Q, s, h: int, w: int, scale=UNIT_SCALE,
                 clamp=None) -> int:
    """Bilinear samples that read the source (the data-dependent work), in
    the sweep's convention (the liveness rule of `_taps`)."""
    x, y = source_coords(*_project(P, Q, s), scale, clamp)
    x0, y0 = torch.floor(x), torch.floor(y)
    live = (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
    return int(live.sum())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(work: KernelWork, flops: float = F32_FLOPS):
    """(bound_ms, bound_by) of a launch: the larger of its bytes' time at
    HBM_BYTES_PER_S and its operations' at `flops` a second."""
    t_bytes = work.bytes / HBM_BYTES_PER_S * 1e3
    t_ops = work.operations / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def warp_work(src, P, Q, s, scale=UNIT_SCALE, clamp=None) -> KernelWork:
    """One `sweep_warp` launch: 8 operations a live sample and channel (4
    taps, multiply and add), 20 a sample for its coordinates; writes the
    bf16 volume."""
    b, h, w, c = src.shape
    H, W = P.shape[-2:]
    n = b * s.shape[1] * H * W
    live = live_samples(P, Q, s, h, w, scale, clamp)
    return KernelWork(nbytes(src, P, Q, s) + n * c * 2, live * c * 8 + n * 20,
                      live)


def warp_backward_work(g, P, Q, s, src_hw, scale=UNIT_SCALE,
                       clamp=None) -> KernelWork:
    """One `sweep_warp_backward` launch: the warp's operations; reads g,
    writes the f32 source gradient."""
    b, D, H, W, c = g.shape
    h, w = src_hw
    live = live_samples(P, Q, s, h, w, scale, clamp)
    return KernelWork(nbytes(g, P, Q, s) + b * h * w * c * 4,
                      live * c * 8 + b * D * H * W * 20, live)


def gwc_work(src, ref, P, Q, s, scale=UNIT_SCALE, clamp=None,
             groups: int = GWC_GROUPS) -> KernelWork:
    """One `sweep_gwc` launch: the warp's 8 operations a live sample and
    channel plus the product and group sum (10); writes [.., groups]."""
    b, h, w, c = src.shape
    H, W = P.shape[-2:]
    n = b * s.shape[1] * H * W
    live = live_samples(P, Q, s, h, w, scale, clamp)
    return KernelWork(nbytes(src, ref, P, Q, s) + n * groups * 2,
                      live * c * 10 + n * 20, live)


def fused_work(ref, srcs, P, Q, s) -> KernelWork:
    """One `fused_cost_volume` launch: each view's warp (8 a live sample
    and channel, 20 a sample), the combine (3 a view and channel, 4 a
    channel, the variance's; softmin's is counted as the same); writes
    the bf16 volume."""
    b, nv, h, w, c = srcs.shape
    H, W = P.shape[-2:]
    n = b * s.shape[1] * H * W
    live = sum(live_samples(P[:, v], Q[:, v], s, h, w) for v in range(nv))
    return KernelWork(nbytes(ref, srcs, P, Q, s) + n * c * 2,
                      live * c * 8 + nv * n * 20 + n * c * (nv * 3 + 4), live)


_launch_hook = None


@contextlib.contextmanager
def on_launch(hook):
    """Within the block, each kernel launch calls hook(kernel name,
    inputs, output) after it is queued: `inputs` are its arguments in the
    order of its plain version (`sweep_warp_plain`, ...); `output` is what
    the plain version returns (the backward's f32 accumulation). The
    previous hook is restored on exit."""
    global _launch_hook
    saved, _launch_hook = _launch_hook, hook
    try:
        yield
    finally:
        _launch_hook = saved


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_planes(P, Q, s, b, nv=None):
    lead = (b,) if nv is None else (b, nv)
    _require(P.dim() == len(lead) + 3 and tuple(P.shape[:len(lead) + 1])
             == lead + (3,), f"P must be {list(lead) + [3, 'H', 'W']}, "
             f"got {tuple(P.shape)}")
    _require(Q.shape == P.shape, f"Q {tuple(Q.shape)} != P {tuple(P.shape)}")
    H, W = P.shape[-2:]
    _require(s.dim() in (2, 4) and s.shape[0] == b
             and (s.dim() == 2 or tuple(s.shape[2:]) == (H, W)),
             f"s must be [B, D] or [B, D, H, W], got {tuple(s.shape)}")
    for name, t in (("P", P), ("Q", Q), ("s", s)):
        _require(t.dtype == torch.float32, f"{name} must be float32")
    return H, W, s.shape[1]


def _check_features(name, t, c=None):
    _require(t.dtype == torch.bfloat16, f"{name} must be bfloat16")
    c = t.shape[-1] if c is None else c
    _require(t.shape[-1] == c, f"{name} has {t.shape[-1]} channels, "
             f"expected {c}")
    g = c // 8
    _require(c % 8 == 0 and g & (g - 1) == 0 and g <= 32,
             f"channels must be 8 * 2^k <= 256, got {c}")
    return c


def _convention(scale, clamp):
    """Checked (scale, clamp) -> the kernels' six floats (sx, sy, x_lo,
    x_hi, y_lo, y_hi); no clamp is infinite bounds."""
    _require(len(scale) == 2, f"scale must be (sx, sy), got {scale}")
    inf = float("inf")
    clamp = (-inf, inf, -inf, inf) if clamp is None else clamp
    _require(len(clamp) == 4 and clamp[0] <= clamp[1]
             and clamp[2] <= clamp[3],
             f"clamp must be (x_lo, x_hi, y_lo, y_hi), got {clamp}")
    return tuple(float(v) for v in (*scale, *clamp))


def _launch_args(tensors):
    dev = tensors[0].device
    for t in tensors:
        _require(t.device == dev, "all tensors must be on one device")
        _require(t.is_contiguous(), "tensors must be contiguous")
        _require(t.data_ptr() % 16 == 0, "tensors must be 16-byte aligned")
    return dev


def _sweep_warp_forward(src, P, Q, s, scale, clamp) -> torch.Tensor:
    """The checked arguments of `sweep_warp` -> the warped volume."""
    b, h, w, c = src.shape
    H, W = P.shape[-2:]
    D = s.shape[1]
    conv = _convention(scale, clamp)
    dev = _launch_args([src, P, Q, s])
    if dev.type == "cpu":
        return sweep_warp_plain(src, P, Q, s, scale, clamp)
    _require(dev.type == "cuda", f"unsupported device {dev}")
    from .. import _build
    lib = _build.load()
    out = torch.empty((b, D, H, W, c), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wm_sweep_warp(src.data_ptr(), P.data_ptr(), Q.data_ptr(),
                               s.data_ptr(), out.data_ptr(),
                               _counter_ptr(dev), b, D, H, W, h, w, c,
                               int(s.dim() == 4), *footprint_plan(c), *conv,
                               stream)
    _build.check(rc, "wm_sweep_warp")
    sweep_warp.launches += 1
    if _launch_hook is not None:
        _launch_hook("sweep_warp", (src, P, Q, s, scale, clamp), out)
    return out


class SweepWarpFn(torch.autograd.Function):
    """`sweep_warp` with its transpose, `sweep_warp_backward`, as the
    features' gradient (the counterpart of the custom VJP
    plane_sweep_warp_mosaic and homography_sweep_warp_mosaic,
    mosaic_sweep.py:1393-1478, 1646-1736). The grid carries no gradient
    (reference module.py:127, homography.py:25/92/110): P, Q and s get
    None."""

    @staticmethod
    def forward(ctx, src, P, Q, s, scale, clamp):
        ctx.save_for_backward(P, Q, s)
        ctx.src_hw = tuple(src.shape[1:3])
        ctx.convention = (scale, clamp)
        return _sweep_warp_forward(src, P, Q, s, scale, clamp)

    @staticmethod
    def backward(ctx, g):
        P, Q, s = ctx.saved_tensors
        df = None
        if ctx.needs_input_grad[0]:
            scale, clamp = ctx.convention
            df = sweep_warp_backward(g.to(torch.bfloat16).contiguous(), P, Q,
                                     s, ctx.src_hw, scale=scale, clamp=clamp)
        return df, None, None, None, None, None


def sweep_warp(src: torch.Tensor, P: torch.Tensor, Q: torch.Tensor,
               s: torch.Tensor, scale=UNIT_SCALE,
               clamp=None) -> torch.Tensor:
    """Warp one source view over a sweep (kernel `wm_sweep_warp`).

    Differentiable in `src`: its gradient is `sweep_warp_backward` of the
    output's gradient (kernel `wm_sweep_warp_backward` on the card).

    Args:
      src: [B, h, w, C] bf16 source features (any h, w).
      P, Q: [B, 3, H, W] f32 projection planes (`mvsnet_planes` or
        `vis_planes`).
      s: [B, D] or [B, D, H, W] f32 hypotheses.
      scale, clamp: the coordinate convention (`vis_planes`; the default
        is MVSNet's: unit scale, no clamp).
    Returns:
      [B, D, H, W, C] bf16 warped volume.
    """
    _require(src.dim() == 4, f"src must be [B, h, w, C], got {src.shape}")
    _check_features("src", src)
    _check_planes(P, Q, s, src.shape[0])
    return SweepWarpFn.apply(src, P, Q, s, tuple(scale),
                             None if clamp is None else tuple(clamp))


sweep_warp.launches = 0


def sweep_warp_backward(g: torch.Tensor, P: torch.Tensor, Q: torch.Tensor,
                        s: torch.Tensor, src_hw: tuple[int, int],
                        dtype: torch.dtype = torch.bfloat16,
                        scale=UNIT_SCALE, clamp=None) -> torch.Tensor:
    """The warp's transpose (kernel `wm_sweep_warp_backward`): the
    gradient of `sweep_warp` with respect to its source features.

    Args:
      g: [B, D, H, W, C] bf16 gradient of the warped volume.
      P, Q, s, scale, clamp: the forward's planes, hypotheses and
        convention.
      src_hw: (h, w) of the source features.
      dtype: dtype of the result; torch.float32 returns the f32
        accumulation uncast (the JAX VJP casts it to the feature dtype,
        mosaic_sweep.py:1463).
    Returns:
      [B, h, w, C] source-feature gradient.
    """
    _require(g.dim() == 5, f"g must be [B, D, H, W, C], got {g.shape}")
    b, D, H, W, c = g.shape
    _check_features("g", g)
    _require((H, W, D) == _check_planes(P, Q, s, b),
             f"g {tuple(g.shape)} does not match the planes and hypotheses")
    h, w = src_hw
    conv = _convention(scale, clamp)
    dev = _launch_args([g, P, Q, s])
    if dev.type == "cpu":
        return sweep_warp_backward_plain(g, P, Q, s, src_hw, scale,
                                         clamp).to(dtype)
    _require(dev.type == "cuda", f"unsupported device {dev}")
    from .. import _build
    lib = _build.load()
    df = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wm_sweep_warp_backward(
            g.data_ptr(), P.data_ptr(), Q.data_ptr(), s.data_ptr(),
            df.data_ptr(), _counter_ptr(dev), b, D, H, W, h, w, c,
            int(s.dim() == 4), _tile_rows(c), *conv, stream)
    _build.check(rc, "wm_sweep_warp_backward")
    sweep_warp_backward.launches += 1
    if _launch_hook is not None:
        _launch_hook("sweep_warp_backward",
                     (g, P, Q, s, src_hw, scale, clamp), df)
    return df.to(dtype)


sweep_warp_backward.launches = 0

# The footprint plans of the kernels (csrc/footprint.cuh).
#: hypotheses of a block's run and columns of its tile (kDRun and kTileW in
#: csrc/footprint.cuh)
FOOTPRINT_D_RUN, FOOTPRINT_TILE_W = 16, 8
#: bytes of a block's shared-memory stage buffer for each view, at most (the
#: views' footprints share one buffer; a footprint that does not fit in
#: what is left is read from device memory instead)
FUSED_VIEW_BYTES, GWC_VIEW_BYTES = 16 * 1024, 32 * 1024
#: the dynamic shared memory of a fused block that keeps the 3 blocks of its
#: __launch_bounds__ on an H100 SM (228 KB an SM, 1 KB of it reserved a
#: block): at NV = 4, 16 KB a view with 3 blocks beat staging more
#: footprints with 2 (PERF.md), and more views share the same bytes
FUSED_BLOCK_BYTES = 228 * 1024 // 3 - 1024
#: the most dynamic shared memory of one block on an H100
SMEM_LIMIT = 227 * 1024


def footprint_smem_bytes(nv: int, cells_max: int, c: int, tile_h: int) -> int:
    """Dynamic shared memory of a footprint block (the sum of
    wm::footprint_smem_bytes): the stage buffer of cells_max cells, the
    tile's planes of every view, the run's hypotheses, the views'
    footprints (32 bytes each) and the warps' hypothesis ranges."""
    npx = tile_h * FOOTPRINT_TILE_W
    threads = npx * (c // 8)
    return (cells_max * c * 2 + nv * 6 * npx * 4
            + FOOTPRINT_D_RUN * npx * 4 + nv * 32 + threads // 32 * 8)


def _tile_rows(c: int, nv: int = 1) -> int:
    """Rows of a footprint block's tile: 8, halved while the block passes
    256 threads (C/8 a pixel), or while the planes of NV views pass
    SMEM_LIMIT (down to one warp)."""
    th = 8
    while th > 1 and th * FOOTPRINT_TILE_W * (c // 8) > 256:
        th //= 2
    while (footprint_smem_bytes(nv, 0, c, th) > SMEM_LIMIT
           and th * FOOTPRINT_TILE_W * (c // 8) > 32):
        th //= 2
    return th


def _whole_tiles(cells: int, tile_h: int) -> int:
    """cells, or 0 when that is less than one tile's footprint at one
    hypothesis ((tile_h + 3) x (FOOTPRINT_TILE_W + 3) cells): such a
    buffer would stage nearly nothing, so every sample uses device
    memory."""
    return cells if cells >= (tile_h + 3) * (FOOTPRINT_TILE_W + 3) else 0


def footprint_plan(c: int, nv: int = 1, view_bytes: int = GWC_VIEW_BYTES,
                   block_bytes: int | None = None) -> tuple[int, int]:
    """(tile_h, cells_max) of a forward footprint kernel's launch for C
    channels and NV views (`_tile_rows`); the block's stage buffer holds NV
    x view_bytes, or what block_bytes leaves after the rest of the block,
    if less (`_whole_tiles`). sweep_warp and sweep_gwc launch with
    footprint_plan(c)."""
    th = _tile_rows(c, nv)
    nbytes = nv * view_bytes
    if block_bytes is not None:
        spare = block_bytes - footprint_smem_bytes(nv, 0, c, th)
        nbytes = min(nbytes, max(spare, 0))
    return th, _whole_tiles(nbytes // (2 * c), th)


def fused_plan(c: int, nv: int) -> tuple[int, int]:
    """`footprint_plan` of fused_cost_volume."""
    return footprint_plan(c, nv, FUSED_VIEW_BYTES, FUSED_BLOCK_BYTES)


_tile_counter = None


@contextlib.contextmanager
def counting_tiles(device):
    """Within the block, the kernels count into the yielded int64 tensor
    [3] on `device`: each launch of a forward kernel adds its staged and
    its global stages to [0] and [1] (a stage: one tile, view and run of
    hypotheses; global: read from device memory), and each launch of
    sweep_warp_backward its 16-byte atomics into device memory to [2].
    Outside it the kernels count nothing; the model paths never open
    it."""
    global _tile_counter
    counter = torch.zeros(3, dtype=torch.int64, device=device)
    prev, _tile_counter = _tile_counter, counter
    try:
        yield counter
    finally:
        _tile_counter = prev


def _counter_ptr(dev):
    if _tile_counter is None:
        return None
    _require(_tile_counter.device == dev,
             "the tile counter lies on another device")
    return _tile_counter.data_ptr()


def sweep_footprints(P, Q, s, tile, src_hw, scale=UNIT_SCALE, clamp=None,
                     d_run: int = 1, cells_max: int | None = None):
    """The footprint rule of csrc/footprint.cuh in PyTorch: for each stage
    (view, run of d_run hypotheses, tile of reference pixels), whether
    the kernels stage it and the box of source cells they copy. The model
    paths never call it; tests and chip_smoke.py hold the kernels' rule to
    it.

    The 8 corners of the box (the tile's 4 corner pixels) x [s_lo, s_hi]
    (the stage's least and greatest hypothesis over the tile) are
    projected in the convention; the footprint is [floor(min) - 1,
    floor(max) + 2] in x and y, cut to the zero ring [-1, w] x [-1, h]. A
    stage can be staged when rz > 0 and the coordinates are finite at all 8
    corners. It is staged when, besides, its box fits in the block's stage
    buffer of `cells_max` cells (None: no limit) after the boxes of the
    views before it that were staged (the views share one buffer, filled
    in view order).

    Args:
      P, Q: [B, 3, H, W] planes of one view, or [B, NV, 3, H, W].
      s: [B, D] or [B, D, H, W] hypotheses.
      tile: (tile_h, tile_w); src_hw: (h, w) of the source.
    Returns:
      staged: bool [B, (NV,) n_stages, tiles_y, tiles_x];
      box: int64 [..., 4], (x0, y0, x1, y1), inclusive source cells.
    """
    if P.dim() == 4:
        staged, box, n_cells = _view_footprints(P, Q, s, tile, src_hw, scale,
                                                clamp, d_run)
        if cells_max is not None:
            staged = staged & (n_cells <= cells_max)
        return staged, box
    per_view = [_view_footprints(P[:, v], Q[:, v], s, tile, src_hw, scale,
                                 clamp, d_run) for v in range(P.shape[1])]
    staged = torch.stack([f[0] for f in per_view], 1)
    box = torch.stack([f[1] for f in per_view], 1)
    if cells_max is not None:
        used = torch.zeros_like(per_view[0][2])
        for v, (ok, _, n_cells) in enumerate(per_view):
            fits = ok & (used + n_cells <= cells_max)
            staged[:, v] = fits
            used = used + torch.where(fits, n_cells, 0)
    return staged, box


def _view_footprints(P, Q, s, tile, src_hw, scale, clamp, d_run):
    """`sweep_footprints` of one view, P, Q [B, 3, H, W], with no budget:
    (stageable [B, n_stages, tiles_y, tiles_x], box [..., 4], cells of the
    box [...])."""
    th, tw = tile
    h, w = src_hw
    b, _, H, W = P.shape
    D = s.shape[1]
    ty, tx, n_st = -(-H // th), -(-W // tw), -(-D // d_run)
    dev = P.device
    # each stage's hypothesis range over each tile; the padding repeats the
    # last hypothesis, row and column, which leaves every range as it is
    idx_d = torch.arange(n_st * d_run, device=dev).clamp(max=D - 1)
    if s.dim() == 4:
        idx_y = torch.arange(ty * th, device=dev).clamp(max=H - 1)
        idx_x = torch.arange(tx * tw, device=dev).clamp(max=W - 1)
        sp = s[:, idx_d][:, :, idx_y][:, :, :, idx_x].reshape(
            b, n_st, d_run, ty, th, tx, tw)
        dims = (2, 4, 6)
    else:
        sp = s[:, idx_d].reshape(b, n_st, d_run, 1, 1, 1, 1)
        dims = (2, 4, 6)
    nan = torch.isnan(sp)
    inf = float("inf")
    s_lo = torch.where(nan, inf, sp).amin(dims).expand(b, n_st, ty, tx)
    s_hi = torch.where(nan, -inf, sp).amax(dims).expand(b, n_st, ty, tx)
    y0s = torch.arange(ty, device=dev) * th
    x0s = torch.arange(tx, device=dev) * tw
    y1s = (y0s + th).clamp(max=H) - 1
    x1s = (x0s + tw).clamp(max=W) - 1
    xs, ys, oks = [], [], []
    for yy in (y0s, y1s):
        for xx in (x0s, x1s):
            Pc = P[:, :, yy][:, :, :, xx][:, :, None]      # [B, 3, 1, ty, tx]
            Qc = Q[:, :, yy][:, :, :, xx][:, :, None]
            for sv in (s_lo, s_hi):
                r = Pc * sv[:, None] + Qc
                x, y = source_coords(r[:, 0], r[:, 1], r[:, 2], scale, clamp)
                oks.append((r[:, 2] > 0) & torch.isfinite(x)
                           & torch.isfinite(y))
                xs.append(torch.nan_to_num(x))
                ys.append(torch.nan_to_num(y))
    xs, ys = torch.stack(xs), torch.stack(ys)

    def cells(lo, hi, n):
        a = torch.floor(lo.clamp(-4.0, n + 4.0)).long() - 1
        z = torch.floor(hi.clamp(-4.0, n + 4.0)).long() + 2
        return a.clamp(min=-1), z.clamp(max=n)

    bx0, bx1 = cells(xs.amin(0), xs.amax(0), w)
    by0, by1 = cells(ys.amin(0), ys.amax(0), h)
    n_cells = (bx1 - bx0 + 1).clamp(min=0) * (by1 - by0 + 1).clamp(min=0)
    return (torch.stack(oks).all(0), torch.stack([bx0, by0, bx1, by1], -1),
            n_cells)


def _refuse_grad(name: str, tensors) -> None:
    _require(not (torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in tensors)),
        f"{name} has no backward: call it without grad, or train through "
        f"sweep_warp (sweep_method 'warp')")


def sweep_gwc(src: torch.Tensor, ref: torch.Tensor, P: torch.Tensor,
              Q: torch.Tensor, s: torch.Tensor, scale=UNIT_SCALE,
              clamp=None, groups: int = GWC_GROUPS) -> torch.Tensor:
    """The warp fused with the group-wise correlation (kernel
    `wm_sweep_gwc`): out[..., g] = sum over the channels c of group g of
    ref[..., c] * warped[..., c]. Eval only (no backward).

    Args:
      src: [B, h, w, C] bf16 source features (any h, w; C in 8, 16, 32,
        64).
      ref: [B, H, W, C] bf16 reference features.
      P, Q: [B, 3, H, W] f32 planes; s: [B, D] or [B, D, H, W] f32
        hypotheses; scale, clamp: the convention (`vis_planes`).
      groups: must be 8 (GWC_GROUPS).
    Returns:
      [B, D, H, W, groups] bf16 correlation volume.
    """
    _require(groups == GWC_GROUPS, f"groups must be {GWC_GROUPS}")
    _require(src.dim() == 4 and ref.dim() == 4,
             "src must be [B, h, w, C] and ref [B, H, W, C]")
    b, h, w, c = src.shape
    _check_features("src", src)
    _check_features("ref", ref, c)
    _require(c in (8, 16, 32, 64), f"channels must be 8, 16, 32 or 64, "
             f"got {c}")
    H, W, D = _check_planes(P, Q, s, b)
    _require(tuple(ref.shape[:3]) == (b, H, W),
             f"ref {tuple(ref.shape)} does not match the planes")
    _refuse_grad("sweep_gwc", (src, ref, P, Q, s))
    conv = _convention(scale, clamp)
    dev = _launch_args([src, ref, P, Q, s])
    if dev.type == "cpu":
        return sweep_gwc_plain(src, ref, P, Q, s, scale, clamp, groups)
    _require(dev.type == "cuda", f"unsupported device {dev}")
    from .. import _build
    lib = _build.load()
    out = torch.empty((b, D, H, W, groups), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wm_sweep_gwc(src.data_ptr(), ref.data_ptr(), P.data_ptr(),
                              Q.data_ptr(), s.data_ptr(), out.data_ptr(),
                              _counter_ptr(dev), b, D, H, W, h, w, c,
                              int(s.dim() == 4), *footprint_plan(c), *conv,
                              stream)
    _build.check(rc, "wm_sweep_gwc")
    sweep_gwc.launches += 1
    if _launch_hook is not None:
        _launch_hook("sweep_gwc", (src, ref, P, Q, s, scale, clamp, groups),
                     out)
    return out


sweep_gwc.launches = 0


def fused_cost_volume(ref: torch.Tensor, srcs: torch.Tensor, P: torch.Tensor,
                      Q: torch.Tensor, s: torch.Tensor,
                      temp: torch.Tensor | None = None,
                      agg: str = "variance") -> torch.Tensor:
    """Aggregated multi-view cost volume (kernel `wm_fused_cost_volume`).

    Args:
      ref: [B, H, W, C] bf16 reference features.
      srcs: [B, NV, h, w, C] bf16 source features.
      P, Q: [B, NV, 3, H, W] f32 planes of each source view.
      s: [B, D] or [B, D, H, W] f32 hypotheses.
      temp: softmin temperature, a 1-element f32 tensor on the device
        (read by the kernel, so no host sync); unused for variance.
      agg: "variance" | "softmin".
    Returns:
      [B, D, H, W, C] bf16 cost volume.
    """
    _require(agg in AGGREGATIONS, f"agg must be one of {AGGREGATIONS}")
    _require(ref.dim() == 4 and srcs.dim() == 5,
             "ref must be [B, H, W, C] and srcs [B, NV, h, w, C]")
    b, H, W, c = ref.shape
    c = _check_features("ref", ref)
    _check_features("srcs", srcs, c)
    _, nv, h, w, _ = srcs.shape
    _require(srcs.shape[0] == b and nv >= 1, "srcs must be [B, NV>=1, ...]")
    PH, PW, D = _check_planes(P, Q, s, b, nv)
    _require((PH, PW) == (H, W), "P/Q grid must match the reference size")
    if agg == "softmin":
        _require(torch.is_tensor(temp) and temp.numel() == 1
                 and temp.dtype == torch.float32,
                 "softmin needs temp as a 1-element float32 tensor")
        temp = temp.reshape(1)
    else:
        temp = torch.zeros(1, dtype=torch.float32, device=ref.device)
    _refuse_grad("fused_cost_volume", (ref, srcs, P, Q, s, temp))
    dev = _launch_args([ref, srcs, P, Q, s, temp])
    if dev.type == "cpu":
        return fused_cost_volume_plain(ref, srcs, P, Q, s, temp, agg)
    _require(dev.type == "cuda", f"unsupported device {dev}")
    from .. import _build
    lib = _build.load()
    out = torch.empty((b, D, H, W, c), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wm_fused_cost_volume(
            ref.data_ptr(), srcs.data_ptr(), P.data_ptr(), Q.data_ptr(),
            s.data_ptr(), temp.data_ptr(), out.data_ptr(), _counter_ptr(dev),
            b, nv, D, H, W, h, w, c, int(s.dim() == 4),
            AGGREGATIONS.index(agg), *fused_plan(c, nv), stream)
    _build.check(rc, "wm_fused_cost_volume")
    fused_cost_volume.launches += 1
    if _launch_hook is not None:
        _launch_hook("fused_cost_volume", (ref, srcs, P, Q, s, temp, agg),
                     out)
    return out


fused_cost_volume.launches = 0

#: every kernel wrapper of the port, by kernel name (the wrappers of other
#: ops modules join through `register`)
KERNELS = {"sweep_warp": sweep_warp,
           "sweep_warp_backward": sweep_warp_backward,
           "fused_cost_volume": fused_cost_volume,
           "sweep_gwc": sweep_gwc}
#: each kernel's plain version, by kernel name; it takes the inputs that
#: an `on_launch` hook receives
PLAIN = {"sweep_warp": sweep_warp_plain,
         "sweep_warp_backward": sweep_warp_backward_plain,
         "fused_cost_volume": fused_cost_volume_plain,
         "sweep_gwc": sweep_gwc_plain}


def register(name: str, wrapper, plain) -> None:
    """Add the kernel wrapper of another ops module to KERNELS and PLAIN,
    so that the launch counts and `on_launch` hooks cover it."""
    KERNELS[name], PLAIN[name] = wrapper, plain


def launched(name: str, inputs, out) -> None:
    """Hand one launch of a registered kernel to the `on_launch` hook."""
    if _launch_hook is not None:
        _launch_hook(name, inputs, out)


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}
