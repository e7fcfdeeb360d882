"""The rectified (H_inf-factored) plane sweep, on the port's kernels.

Counterpart of wildmvs/ops/rect_sweep.py. With T = src_proj @ inv(ref_proj)
= [A | b] and e = A^-1 b, the source match of reference pixel x~ at depth d
(s = 1/d) is x_s ~ A (x~ + e s). Resampling each source ONCE by A onto a
reference-aligned canvas (src_rect(u) = src(A u), bilinear, border zero)
leaves the residual sweep
    u = (x~ + e s) / (1 + e_z s),
whose P planes (e) are constant and whose Q planes are the pixel grid. The
port's kernels take any (P, Q) planes, so no new kernel is needed:

  rect_cost_volume  MVSNet / CVP-MVSNet: the NV canvases [B, NV, Hm, Wm, C]
      (Hm = H + 2M, Wm = W + 2M) go through ONE `fused_cost_volume` launch
      with the rect planes and s = 1/d (variance or softmin, [D] or
      [D, H, W] hypotheses). The JAX package runs its per-view Pallas warp
      `mosaic_sweep_warp_px` (the kernel branch, rect_sweep.py:278-310) and
      aggregates in XLA; both compute the same statistic, but the fused
      kernel keeps the sums in f32 and does not round each warped sample to
      bf16 first (an expected difference, ROADMAP Queue 3).
  rect_gwc_volume   Vis-MVSNet: `vis_rect_decompose`, the "vis" canvas
      resample (the reference's x / size * 2 - 1 normalization and +-1.1
      clip folded in), then `sweep_gwc` on the canvas at unit scale with no
      clamp and the pixel-centre (0.5) planes.

Rect is an approximation: the sweep samples a once-interpolated source, and
matches whose canvas coordinate leaves the margin-expanded canvas read
zeros. `rect_coverage_ok` probes for the latter; per batch element, a level
(all views) or a Vis pair whose probe fails takes the port's exact path on
the same views with the original projections (`exact_fused_volume`,
`exact_gwc_volume`), as the JAX gather branch does. Coverage for every view
of a call is decided by one device reduction and ONE host sync.

Dropped, as TPU window artifacts: the JAX span-plan fit (`_plan_fit`,
`tier_b_kr`, `KR < 2`) and the TPU-backend gate of `mosaic_px_supported`.
The port takes rect wherever coverage holds.

Geometry is f32 whatever the feature dtype. The canvas resample is the
port's `grid_sample_xy` (the JAX package's `grid_sample_xy` arithmetic:
f32 weights cast to the feature dtype, the combine in the feature dtype),
computed outside any kernel, as in the JAX package. Features are bf16 on
the kernels: f32 features are cast to bf16 first and the result is cast
back, as the port's "fused" method does.

Layout: features [B, h, w, C]; projections [B, N, 4, 4], reference first;
hypotheses [B, D] or [B, D, H, W]; volumes [B, D, H, W, C].
"""
from __future__ import annotations

import torch

from ..geometry.projective import pixel_grid
from .grid_sample import grid_sample_xy
from .sweep_kernels import (UNIT_SCALE, fused_cost_volume, mvsnet_planes,
                            sweep_gwc, vis_planes, vis_svals)

#: probes a side of the coverage check's pixel grid
N_PROBE = 8


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).contiguous()


def rect_decompose(src_proj: torch.Tensor, ref_proj: torch.Tensor):
    """(A [..., 3, 3], e [..., 3]) of the H_inf factoring (src_proj,
    ref_proj [..., 4, 4], broadcast): A is the ref -> src infinite
    homography at the sweep grid's resolution, e = A^-1 b the residual
    direction (s = 1/depth). f32; inv_ex/solve_ex keep it free of host
    syncs."""
    ref_inv = torch.linalg.inv_ex(ref_proj.float())[0]
    T = src_proj.float() @ ref_inv
    A, b = T[..., :3, :3], T[..., :3, 3:]
    e = torch.linalg.solve_ex(A, b)[0][..., 0]
    return A, e


def rect_margin(ref_hw: tuple[int, int]) -> int:
    """Default canvas margin: half the short side rounded down to a
    multiple of 8, within [32, 96] (the JAX package's rule)."""
    h, w = ref_hw
    return int(min(96, max(32, (min(h, w) // 2) // 8 * 8)))


def _s_extremes(svals: torch.Tensor, lead: int):
    """(s_lo, s_hi) f32 over the hypothesis dims of svals, whose first
    `lead` dims are batch dims that broadcast against e's."""
    flat = svals.float().reshape(svals.shape[:lead] + (-1,))
    return flat.amin(-1), flat.amax(-1)


def rect_shift(e: torch.Tensor, svals: torch.Tensor,
               ref_hw: tuple[int, int], offset: float = 0.0) -> torch.Tensor:
    """Integer canvas recentering [..., 2] (x, y): the mid-sweep disparity
    of the grid-centre pixel, rounded (half to even, as jnp.round) so that
    a pure-translation rig still resamples on the integer grid.

    e: [..., 3]; svals: [*lead, *hyp] with lead broadcasting against
    e.shape[:-1] (the extremes are taken over the hyp dims); offset: the
    pixel-centre offset (0.0 MVSNet grid, 0.5 Vis)."""
    rh, rw = ref_hw
    xc = torch.tensor([(rw - 1) / 2.0 + offset, (rh - 1) / 2.0 + offset],
                      dtype=torch.float32, device=e.device)
    s_lo, s_hi = _s_extremes(svals, e.dim() - 1)

    def delta(s):
        s = s[..., None]
        den = 1.0 + e[..., 2:] * s
        den = torch.where(den.abs() > 1e-6, den, torch.ones_like(den))
        return (e[..., :2] - xc * e[..., 2:]) * s / den

    return torch.round((delta(s_lo) + delta(s_hi)) / 2.0)


def rect_planes(e: torch.Tensor, ref_hw: tuple[int, int], margin: int,
                shift: torch.Tensor | None = None, offset: float = 0.0):
    """(P, Q) contiguous [..., 3, H, W] planes of the residual sweep in
    canvas coordinates:
    U = ((x~ - shift + M) + (e_xy - (shift - M) e_z) s) / (1 + e_z s)."""
    rh, rw = ref_hw
    if shift is None:
        shift = torch.zeros(e.shape[:-1] + (2,), dtype=torch.float32,
                            device=e.device)
    sx, sy = shift[..., 0, None, None], shift[..., 1, None, None]
    grid = pixel_grid(rh, rw, torch.float32, e.device, offset=offset)
    gx = grid[..., 0] - sx + margin
    gy = grid[..., 1] - sy + margin
    ez = e[..., 2, None, None]
    P = torch.stack([(e[..., 0, None, None] - (sx - margin) * ez)
                     .expand(gx.shape),
                     (e[..., 1, None, None] - (sy - margin) * ez)
                     .expand(gx.shape),
                     ez.expand(gx.shape)], -3).contiguous()
    Q = torch.stack([gx, gy, torch.ones_like(gx)], -3).contiguous()
    return P, Q


def rect_coverage_ok(e: torch.Tensor, A: torch.Tensor, svals: torch.Tensor,
                     ref_hw: tuple[int, int], margin: int,
                     src_hw: tuple[int, int], shift: torch.Tensor,
                     offset: float = 0.0) -> torch.Tensor:
    """Bool [...] (e's batch dims): every probed sweep sample that the
    exact sweep finds INSIDE the source also lands on the canvas.

    Probed on an N_PROBE x N_PROBE pixel grid at the s extremes: u(s) is
    affine in the pixel per axis and monotone in s wherever 1 + e_z s keeps
    its sign. That denominator is linear in s, so requiring it > 1e-6 at
    both extremes fails CLOSED on a rig where it crosses zero inside the
    sweep (such a rig takes the exact path). Probes behind the source
    camera (z <= 1e-6) are outside the source for the exact sweep too."""
    rh, rw = ref_hw
    h, w = src_hw
    dev = e.device
    px = torch.linspace(offset, rw - 1 + offset, N_PROBE,
                        dtype=torch.float32, device=dev)
    py = torch.linspace(offset, rh - 1 + offset, N_PROBE,
                        dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(py, px, indexing="ij")            # [P, P]
    s_lo, s_hi = _s_extremes(svals, e.dim() - 1)
    s_ext = torch.stack(torch.broadcast_tensors(s_lo, s_hi), -1)
    s_ext = s_ext[..., None, None]                            # [.., 2, 1, 1]
    ec = e[..., None, None, None, :]                          # [.., 1,1,1,3]
    den = 1.0 + ec[..., 2] * s_ext
    valid_den = den > 1e-6
    den_ok = valid_den.flatten(-3).all(-1)
    dens = torch.where(valid_den, den, torch.ones_like(den))
    ux = (gx + ec[..., 0] * s_ext) / dens                     # [.., 2, P, P]
    uy = (gy + ec[..., 1] * s_ext) / dens
    a = A.float()[..., None, None, None, :, :]
    z = a[..., 2, 0] * ux + a[..., 2, 1] * uy + a[..., 2, 2]
    zok = z > 1e-6
    zs = torch.where(zok, z, torch.ones_like(z))
    vx = (a[..., 0, 0] * ux + a[..., 0, 1] * uy + a[..., 0, 2]) / zs
    vy = (a[..., 1, 0] * ux + a[..., 1, 1] * uy + a[..., 1, 2]) / zs
    src_in = (zok & valid_den & (vx >= 0) & (vx <= w - 1)
              & (vy >= 0) & (vy <= h - 1))
    cx = ux - shift[..., 0, None, None, None] + margin
    cy = uy - shift[..., 1, None, None, None] + margin
    hm, wm = rh + 2 * margin, rw + 2 * margin
    canvas_in = (cx >= 0) & (cx <= wm - 1) & (cy >= 0) & (cy <= hm - 1)
    covered = (~src_in | canvas_in).flatten(-3).all(-1)
    return den_ok & covered


def _rect_resample_body(src, A, ref_hw, margin, shift, norm: str):
    """src [B', h, w, C], A [B', 3, 3], shift [B', 2] or None -> the
    canvas [B', H + 2M, W + 2M, C] in src's dtype; `norm` picks the
    pixel -> NDC convention ("mvsnet" or "vis")."""
    b, h, w, _ = src.shape
    rh, rw = ref_hw
    hm, wm = rh + 2 * margin, rw + 2 * margin
    if shift is None:
        shift = torch.zeros((b, 2), dtype=torch.float32, device=src.device)
    grid = pixel_grid(hm, wm, torch.float32, src.device)
    ux = grid[..., 0] - margin + shift[:, 0, None, None]      # [B', Hm, Wm]
    uy = grid[..., 1] - margin + shift[:, 1, None, None]
    a = A.float()[:, None, None]                              # [B',1,1,3,3]
    z = a[..., 2, 0] * ux + a[..., 2, 1] * uy + a[..., 2, 2]
    pos = z > 0
    zs = torch.where(pos, z, torch.ones_like(z))
    gx = torch.where(pos, (a[..., 0, 0] * ux + a[..., 0, 1] * uy
                           + a[..., 0, 2]) / zs, -10.0)
    gy = torch.where(pos, (a[..., 1, 0] * ux + a[..., 1, 1] * uy
                           + a[..., 1, 2]) / zs, -10.0)
    if norm == "mvsnet":
        # pixel coordinates -> align_corners=True NDC
        gxn = 2.0 * gx / (w - 1.0) - 1.0
        gyn = 2.0 * gy / (h - 1.0) - 1.0
    else:
        # the Vis chain: x / size * 2 - 1 into align_corners, +-1.1 clip
        gxn = torch.clamp(gx / w * 2.0 - 1.0, -1.1, 1.1)
        gyn = torch.clamp(gy / h * 2.0 - 1.0, -1.1, 1.1)
    return grid_sample_xy(src, gxn, gyn, align_corners=True)


def rect_resample(src: torch.Tensor, A: torch.Tensor,
                  ref_hw: tuple[int, int], margin: int,
                  shift: torch.Tensor | None = None) -> torch.Tensor:
    """Sources [B', h, w, C] resampled by their infinite homographies
    A [B', 3, 3] onto the margin-expanded, shift-recentred canvas:
    out[v + M, u + M] = src(A (u + shift_x, v + shift_y, 1)), bilinear,
    border zero (the sweep kernels' invalid-sample convention)."""
    return _rect_resample_body(src, A, ref_hw, margin, shift, "mvsnet")


def vis_rect_decompose(K_ref, R_ref, t_ref, K_src, R_src, t_src):
    """(A [..., 3, 3], e [..., 3]) of the Vis homography convention
    (K, R [..., 3, 3], t [..., 3, 1], broadcast): coords_hom = A (p + e s)
    with s = 1/(d + 1e-9), the sign folded so that rect_planes and
    rect_shift apply as in the MVSNet arm."""
    K_ref, R_ref, t_ref, K_src, R_src, t_src = (
        x.float() for x in (K_ref, R_ref, t_ref, K_src, R_src, t_src))
    K_ref_inv = torch.linalg.inv_ex(K_ref)[0]
    R_ref_T = R_ref.transpose(-1, -2)
    A = K_src @ R_src @ R_ref_T @ K_ref_inv
    c_rel = (-R_src.transpose(-1, -2) @ t_src) - (-R_ref_T @ t_ref)
    e = (K_ref @ R_ref @ c_rel)[..., 0]
    return A, -e


def vis_rect_resample(src: torch.Tensor, A: torch.Tensor,
                      ref_hw: tuple[int, int], margin: int,
                      shift: torch.Tensor | None = None) -> torch.Tensor:
    """`rect_resample` in the Vis convention: canvas pixel U samples the
    source at proj(A [U - M + shift, 1]) through the homography warp's
    normalization chain (the net (size-1)/size pixel scale, +-1.1 clip)."""
    return _rect_resample_body(src, A, ref_hw, margin, shift, "vis")


def _per_batch(ok: list, rect_fn, exact_fn, device) -> torch.Tensor:
    """Assemble a [B, ...] result from rect_fn on the batch elements whose
    `ok` is True and exact_fn on the rest (each called with a slice or an
    index tensor of batch elements)."""
    if all(ok):
        return rect_fn(slice(None))
    if not any(ok):
        return exact_fn(slice(None))
    ri = torch.tensor([i for i, k in enumerate(ok) if k], device=device)
    ei = torch.tensor([i for i, k in enumerate(ok) if not k], device=device)
    a, x = rect_fn(ri), exact_fn(ei)
    out = a.new_empty((len(ok),) + tuple(a.shape[1:]))
    out[ri] = a
    out[ei] = x
    return out


def exact_fused_volume(ref16, srcs16, src_projs, ref_proj, depth,
                       temp=None, agg: str = "variance") -> torch.Tensor:
    """The exact MVSNet-convention volume of the `fused_cost_volume`
    kernel: ref16 [B, H, W, C] and srcs16 [B, NV, h, w, C] bf16,
    src_projs a list of NV [B, 4, 4] projections, ref_proj [B, 4, 4],
    depth [B, D] or [B, D, H, W] f32 -> [B, D, H, W, C] bf16."""
    hw = tuple(ref16.shape[1:3])
    planes = [mvsnet_planes(p, ref_proj, hw) for p in src_projs]
    return fused_cost_volume(ref16, srcs16,
                             torch.stack([p for p, _ in planes], 1),
                             torch.stack([q for _, q in planes], 1),
                             depth, temp, agg)


def rect_cost_volume(feats_l, proj: torch.Tensor, ref_depths: torch.Tensor,
                     ref_hw: tuple[int, int], agg: str = "variance",
                     temp: torch.Tensor | None = None,
                     margin: int | None = None) -> torch.Tensor:
    """Aggregated cost volume through the rectified sweep, per batch
    element the exact path where coverage fails.

    Args:
      feats_l: list of N [B, h, w, C] features, REFERENCE FIRST, sources of
        one size.
      proj: [B, N, 4, 4] projections at the features' resolution, same
        order (MVSNet convention: s = depth; rect sweeps s = 1/d).
      ref_depths: [B, D] or [B, D, H, W] hypothesis depths.
      ref_hw: (H, W) of the sweep grid (the reference feature grid).
      agg: "variance" | "softmin"; temp: softmin's 1-element f32 tensor.
      margin: canvas margin (default `rect_margin`).
    Returns:
      [B, D, H, W, C] in the reference features' dtype.
    """
    ref16 = _bf16(feats_l[0])
    srcs16 = _bf16(torch.stack(list(feats_l[1:]), 1))
    b, nv, h, w, c = srcs16.shape
    M = rect_margin(ref_hw) if margin is None else margin
    proj = proj.float()
    depth = ref_depths.float().contiguous()
    s = (1.0 / depth).contiguous()
    A, e = rect_decompose(proj[:, 1:], proj[:, :1])           # [B, NV, ...]
    shift = rect_shift(e, s[:, None], ref_hw)
    ok = rect_coverage_ok(e, A, s[:, None], ref_hw, M, (h, w), shift)
    ok = ok.all(1).tolist()                    # the call's one host sync

    def rect_fn(idx):
        src = srcs16[idx]
        canvas = rect_resample(src.flatten(0, 1), A[idx].flatten(0, 1),
                               ref_hw, M, shift[idx].flatten(0, 1))
        P, Q = rect_planes(e[idx], ref_hw, M, shift[idx])
        return fused_cost_volume(ref16[idx], canvas.unflatten(0, src.shape[:2]),
                                 P, Q, s[idx], temp, agg)

    def exact_fn(idx):
        p = proj[idx]
        return exact_fused_volume(ref16[idx], srcs16[idx],
                                  [p[:, i] for i in range(1, nv + 1)],
                                  p[:, 0], depth[idx], temp, agg)

    return _per_batch(ok, rect_fn, exact_fn, ref16.device).to(
        feats_l[0].dtype)


def exact_gwc_volume(src16, ref16, K, R, t, view: int, s,
                     src_hw: tuple[int, int]) -> torch.Tensor:
    """The exact Vis pair volume of the `sweep_gwc` kernel: source `view`
    of the cameras K, R [B, N, 3, 3], t [B, N, 3, 1] (reference first, at
    the features' resolution) against the reference, s [B, D] or
    [B, D, H, W] from `vis_svals` -> [B, D, H, W, 8] bf16."""
    hw = tuple(ref16.shape[1:3])
    P, Q, scale, clamp = vis_planes(K[:, 0], R[:, 0], t[:, 0], K[:, view],
                                    R[:, view], t[:, view], hw, src_hw)
    return sweep_gwc(src16, ref16, P, Q, s, scale, clamp)


def rect_gwc_volume(srcs, ref_feat: torch.Tensor, K: torch.Tensor,
                    R: torch.Tensor, t: torch.Tensor, depth_num: int,
                    depth_start: torch.Tensor, depth_interval: torch.Tensor,
                    ref_hw: tuple[int, int],
                    margin: int | None = None) -> list:
    """Vis-MVSNet per-pair warp + group-wise correlation through the
    rectified sweep, for every pair of a stage at once (one host sync for
    the stage's coverage; the JAX package takes one pair a call).

    Args:
      srcs: list of S [B, h, w, C] source features of one size.
      ref_feat: [B, H, W, C] reference features.
      K, R: [B, 1 + S, 3, 3]; t: [B, 1 + S, 3, 1], reference first, K at
        the features' resolution.
      depth_num: D; depth_start [B, 1, 1, 1] or [B, 1, H, W];
        depth_interval [B, 1, 1, 1] (hypotheses start + interval * i).
      ref_hw: (H, W); margin: canvas margin (default `rect_margin`).
    Returns:
      list of S [B, D, H, W, GWC_GROUPS] volumes in the sources' dtype.
    """
    b, h, w, _ = srcs[0].shape
    M = rect_margin(ref_hw) if margin is None else margin
    K, R, t = K.float(), R.float(), t.float()
    A, e = vis_rect_decompose(K[:, :1], R[:, :1], t[:, :1], K[:, 1:],
                              R[:, 1:], t[:, 1:])             # [B, S, ...]
    s = vis_svals(depth_num, depth_start, depth_interval, ref_hw)
    shift = rect_shift(e, s[:, None], ref_hw, offset=0.5)
    ok = rect_coverage_ok(e, A, s[:, None], ref_hw, M, (h, w), shift,
                          offset=0.5).tolist()  # the call's one host sync
    P, Q = rect_planes(e, ref_hw, M, shift, offset=0.5)
    ref16 = _bf16(ref_feat)
    out = []
    for i, src in enumerate(srcs):
        src16 = _bf16(src)

        def rect_fn(idx, i=i, src16=src16):
            canvas = vis_rect_resample(src16[idx], A[idx, i], ref_hw, M,
                                       shift[idx, i])
            return sweep_gwc(canvas, ref16[idx], P[idx, i].contiguous(),
                             Q[idx, i].contiguous(), s[idx], UNIT_SCALE,
                             None)

        def exact_fn(idx, i=i, src16=src16):
            return exact_gwc_volume(src16[idx], ref16[idx], K[idx], R[idx],
                                    t[idx], i + 1, s[idx], (h, w))

        out.append(_per_batch([row[i] for row in ok], rect_fn, exact_fn,
                              src.device).to(src.dtype))
    return out
