"""The port's plane-sweep kernels: wrappers, plain versions, launch counts.

Three hand-written CUDA kernels for Hopper (csrc/sweep.cu, built on first
use by _build.py) replace three Pallas TPU kernels of
wildmvs/ops/mosaic_sweep.py:

  sweep_warp          <- _kernel / mosaic_sweep_warp (:143-270). One source
      view warped over D hypotheses -> [B, D, H, W, C] bf16.
      Bound: HBM bytes. At the 512x640 headline (128x160 features, C=32,
      D=192) it writes 251.7 MB and reads about 1.8 MB (source map plus
      the P/Q planes): about 76 us at 3.35 TB/s. Design: one thread per
      (d, y, x, 8-channel group); each corner read and each output write is
      one 16-byte access, contiguous across the C/8 threads of a pixel; the
      source map (1.3 MB) stays in the 50 MB L2. Differentiable in the
      features through SweepWarpFn.
  sweep_warp_backward <- _kernel_scatter_px / mosaic_scatter_px
      (:1930-2088). The warp's transpose: gradient g [B, D, H, W, C] bf16
      -> source-feature gradient [B, h, w, C], accumulated in f32.
      Bound: HBM bytes (251.7 MB of g read at the headline, ~76 us) unless
      the f32 atomics set the pace. Design: one thread per (y, x, 8-channel
      group) and run of BACKWARD_D_CHUNK hypotheses; it sums its four
      corners in registers while the sample stays in one source cell and
      flushes them with 16-byte vector atomics when the cell changes. No
      one-hot MXU contraction, KY/NTS window, VMEM canvas, channel split
      or XLA fallback: an atomic scatter has no window.
  fused_cost_volume   <- _kernel_fused / fused_cost_volume_px (:811-1117).
      All NV source views in one launch; variance (sum, sum of squares) or
      softmin (sum e*diff, sum e) statistics in f32 registers; only the
      final [B, D, H, W, C] bf16 volume is written.
      Bound: HBM bytes: 251.7 MB out + about 5 MB in at the headline
      (~77 us); 1.455 GB out + about 50 MB in at 1184x1600 N5 (~449 us).
      Design: as sweep_warp, with a loop over the views inside the thread
      and an xor-shuffle channel sum across the C/8 threads of a pixel for
      softmin's per-pixel weight.

None carries over the TPU's corner table, span plans, KY/KR/NT window
tiers, lax.cond gather fallbacks, row/lane padding or depth pairing: a
Hopper gather has no window, so the kernels are exact for any rig.
`fused_cost_volume` has no backward and refuses inputs that require grad.

One projection form serves both kernels (`mvsnet_planes`): for reference
pixel (y, x) and hypothesis s (a depth, per plane [D] or per pixel
[D, H, W]),  (rx, ry, rz) = P[:, y, x] * s + Q[:, y, x],  coords =
(rx, ry) / rz in source pixels; rz <= 0 (behind the camera) samples zero.
Coordinates, bilinear weights and the combine are f32; features are read
as bf16; each output is rounded once to bf16. (The Pallas kernels combine
with bf16 weights in bf16; the port's f32 combine differs from them by
bf16 rounding, by design.)

The backward's adds are f32 atomics in an order that changes from run to
run, so two runs may differ in the last f32 bits.

Each wrapper takes its plain PyTorch version only for tensors on the CPU.
For CUDA tensors it launches its kernel or raises; it never falls back.
`<wrapper>.launches` counts kernel launches (never plain calls).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..geometry.projective import pixel_grid

AGGREGATIONS = ("variance", "softmin")


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


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch)
# ---------------------------------------------------------------------------

def _project(P: torch.Tensor, Q: torch.Tensor, s: torch.Tensor):
    """P, Q [B, 3, H, W]; s [B, D] or [B, D, H, W] -> rx, ry, rz [B, D, H, W]."""
    s = s[:, :, None, None] if s.dim() == 2 else s
    r = P[:, :, None] * s[:, None] + Q[:, :, None]
    return r[:, 0], r[:, 1], r[:, 2]


def _taps(rx, ry, rz, h: int, w: int):
    """The four bilinear taps of each sample at (rx, ry) / rz on a source
    of h x w pixels seen through a one-pixel zero ring [h+2, w+2].

    A sample is live when rz > 0, floor(x) in [-1, w-1] and floor(y) in
    [-1, h-1]; its corners outside the image fall on the ring. A dead
    sample has weight 0 at ring index 0.
    Returns (idx [B, M] ring index of the top-left corner, offsets of the
    four corners, weights: four f32 [B, ..., 1])."""
    b = rx.shape[0]
    pos = rz > 0
    safe_z = torch.where(pos, rz, torch.ones_like(rz))
    x = rx / safe_z
    y = ry / safe_z
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    live = (pos & (x0f >= -1) & (x0f <= w - 1)
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


def _sample_f32(img: torch.Tensor, rx, ry, rz,
                dtype=torch.float32) -> torch.Tensor:
    """Bilinear border-zero sample of img [B, h, w, C] at (rx, ry) / rz
    (`_taps`). Returns the unrounded values in `dtype`, [B, ..., C]."""
    b, h, w, c = img.shape
    idx, offs, wts = _taps(rx, ry, rz, h, w)
    flat = F.pad(img, (0, 0, 1, 1, 1, 1)).reshape(b, -1, c)
    rows = torch.arange(b, device=img.device)[:, None]
    acc = None
    for off, wt in zip(offs, wts):
        corner = flat[rows, idx + off].reshape(rx.shape + (c,)).to(dtype)
        term = wt.to(dtype) * corner
        acc = term if acc is None else acc + term
    return acc


def _scatter_f32(g: torch.Tensor, rx, ry, rz, src_hw: tuple[int, int],
                 dtype=torch.float32) -> torch.Tensor:
    """The exact transpose of `_sample_f32`: g [B, ..., C] -> df [B, h, w,
    C] in `dtype`, each sample's four weighted corners added with
    index_add_ into the zero ring, which is then cut away."""
    h, w = src_hw
    b, c = g.shape[0], g.shape[-1]
    idx, offs, wts = _taps(rx, ry, rz, h, w)
    ring = torch.zeros((b * (h + 2) * (w + 2), c), dtype=dtype,
                       device=g.device)
    base = (torch.arange(b, device=g.device) * ((h + 2) * (w + 2)))[:, None]
    gv = g.to(dtype)
    for off, wt in zip(offs, wts):
        ring.index_add_(0, (idx + off + base).reshape(-1),
                        (wt.to(dtype) * gv).reshape(-1, c))
    return ring.reshape(b, h + 2, w + 2, c)[:, 1:h + 1, 1:w + 1]


def sweep_warp_plain(src, P, Q, s) -> torch.Tensor:
    """Plain PyTorch version of the `sweep_warp` kernel (same arguments)."""
    return _sample_f32(src, *_project(P, Q, s)).to(torch.bfloat16)


def sweep_warp_backward_plain(g, P, Q, s, src_hw) -> torch.Tensor:
    """Plain PyTorch version of the `sweep_warp_backward` kernel: the f32
    accumulation [B, h, w, C], before any cast."""
    return _scatter_f32(g, *_project(P, Q, s), src_hw).contiguous()


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


def _launch_args(tensors):
    dev = tensors[0].device
    for t in tensors:
        _require(t.device == dev, "all tensors must be on one device")
        _require(t.is_contiguous(), "tensors must be contiguous")
        _require(t.data_ptr() % 16 == 0, "tensors must be 16-byte aligned")
    return dev


def _sweep_warp_forward(src, P, Q, s) -> torch.Tensor:
    """The checked arguments of `sweep_warp` -> the warped volume."""
    b, h, w, c = src.shape
    H, W = P.shape[-2:]
    D = s.shape[1]
    dev = _launch_args([src, P, Q, s])
    if dev.type == "cpu":
        return sweep_warp_plain(src, P, Q, s)
    _require(dev.type == "cuda", f"unsupported device {dev}")
    from .. import _build
    lib = _build.load()
    out = torch.empty((b, D, H, W, c), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wm_sweep_warp(src.data_ptr(), P.data_ptr(), Q.data_ptr(),
                               s.data_ptr(), out.data_ptr(), b, D, H, W, h,
                               w, c, int(s.dim() == 4), stream)
    _build.check(rc, "wm_sweep_warp")
    sweep_warp.launches += 1
    return out


class SweepWarpFn(torch.autograd.Function):
    """`sweep_warp` with its transpose, `sweep_warp_backward`, as the
    features' gradient (the counterpart of the custom VJP
    plane_sweep_warp_mosaic, mosaic_sweep.py:1393-1478). The grid carries
    no gradient (reference module.py:127): P, Q and s get None."""

    @staticmethod
    def forward(ctx, src, P, Q, s):
        ctx.save_for_backward(P, Q, s)
        ctx.src_hw = tuple(src.shape[1:3])
        return _sweep_warp_forward(src, P, Q, s)

    @staticmethod
    def backward(ctx, g):
        P, Q, s = ctx.saved_tensors
        df = None
        if ctx.needs_input_grad[0]:
            df = sweep_warp_backward(g.to(torch.bfloat16).contiguous(), P, Q,
                                     s, ctx.src_hw)
        return df, None, None, None


def sweep_warp(src: torch.Tensor, P: torch.Tensor, Q: torch.Tensor,
               s: torch.Tensor) -> torch.Tensor:
    """Warp one source view over a sweep (kernel `wm_sweep_warp`).

    Differentiable in `src`: its gradient is `sweep_warp_backward` of the
    output's gradient (kernel `wm_sweep_warp_backward` on the card).

    Args:
      src: [B, h, w, C] bf16 source features (any h, w).
      P, Q: [B, 3, H, W] f32 projection planes (`mvsnet_planes`).
      s: [B, D] or [B, D, H, W] f32 hypotheses.
    Returns:
      [B, D, H, W, C] bf16 warped volume.
    """
    _require(src.dim() == 4, f"src must be [B, h, w, C], got {src.shape}")
    _check_features("src", src)
    _check_planes(P, Q, s, src.shape[0])
    return SweepWarpFn.apply(src, P, Q, s)


sweep_warp.launches = 0

#: hypotheses per thread of the backward kernel (the run over which a
#: thread sums its corners in registers before its atomics)
BACKWARD_D_CHUNK = 16


def sweep_warp_backward(g: torch.Tensor, P: torch.Tensor, Q: torch.Tensor,
                        s: torch.Tensor, src_hw: tuple[int, int],
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The warp's transpose (kernel `wm_sweep_warp_backward`): the
    gradient of `sweep_warp` with respect to its source features.

    Args:
      g: [B, D, H, W, C] bf16 gradient of the warped volume.
      P, Q, s: the forward's planes and hypotheses.
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
    dev = _launch_args([g, P, Q, s])
    if dev.type == "cpu":
        return sweep_warp_backward_plain(g, P, Q, s, src_hw).to(dtype)
    _require(dev.type == "cuda", f"unsupported device {dev}")
    from .. import _build
    lib = _build.load()
    df = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wm_sweep_warp_backward(
            g.data_ptr(), P.data_ptr(), Q.data_ptr(), s.data_ptr(),
            df.data_ptr(), b, D, H, W, h, w, c, int(s.dim() == 4),
            BACKWARD_D_CHUNK, stream)
    _build.check(rc, "wm_sweep_warp_backward")
    sweep_warp_backward.launches += 1
    return df.to(dtype)


sweep_warp_backward.launches = 0


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
    _require(not (torch.is_grad_enabled() and any(
        t.requires_grad for t in (ref, srcs, P, Q, s, temp))),
        "fused_cost_volume has no backward: call it without grad, or "
        "train through sweep_warp (MVSNet sweep_method 'warp')")
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
            s.data_ptr(), temp.data_ptr(), out.data_ptr(), b, nv, D, H, W,
            h, w, c, int(s.dim() == 4), AGGREGATIONS.index(agg), stream)
    _build.check(rc, "wm_fused_cost_volume")
    fused_cost_volume.launches += 1
    return out


fused_cost_volume.launches = 0

#: every kernel wrapper of the port, by kernel name
KERNELS = {"sweep_warp": sweep_warp,
           "sweep_warp_backward": sweep_warp_backward,
           "fused_cost_volume": fused_cost_volume}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}
