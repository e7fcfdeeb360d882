"""CVP-MVSNet: a coarse-to-fine cost-volume pyramid over an image pyramid.

Counterpart of wildmvs/models/cvp_mvsnet.py (reference
models/CVP_MVSNet/models/net.py, modules.py, frontend.py), eval and train
forward:
  image pyramid: nscale levels of 0.5x bilinear steps (ops/resize.py)
  FeaturePyramidNet: one 9-conv LeakyReLU(0.1) extractor (64/32/16
    channels, full resolution of its level), shared by every level
  coarsest level: a fronto-parallel sweep of 48 hypotheses in train mode
    and 96 at eval, interval (dmax - dmin) / D (modules.py:58; not MVSNet's
    / (D - 1)), variance aggregation, one shared 3D regularizer
    (CVPCostRegNet: 16/32/64 channels, one stride-2 level)
  each finer level: the 2x bicubic upsampled depth (ops/resize.py) +- 4
    hypotheses per pixel: fixed halved intervals (dmax - dmin) / 48 /
    2^(k+1) in train mode (net.py:177-182), the epipolar 1-pixel interval
    of `cal_depth_hypo` at eval
  photometric confidence of the finest level's probabilities.

The JAX package's space-to-depth feature tail and depth- and block-packed
regularizer are TPU layouts of the same math: here every conv is a plain
conv2d / conv3d, and `packed_training` is accepted and changes nothing.

Cost-volume backends (`sweep_method`), per level:
  "gather"  the exact f32 gather (ops/plane_sweep.py), variance in torch;
  "warp"    one `sweep_warp` per source view, variance in torch;
            differentiable through `sweep_warp_backward` (the counterpart
            of plane_sweep_warp_mosaic, cvp_mvsnet.py:374-382);
  "fused"   one `fused_cost_volume` launch (the counterpart of
            variance_volume_mosaic_px, :357-372); eval only;
  "auto"    for bf16 features on the card "fused" at eval and "warp" in
            train mode, else "gather";
  "rect"    the rectified sweep (ops/rect_sweep.py) at every level, the
            coarse [D] sweep and the per-pixel refinement maps: one
            canvas resample and one `fused_cost_volume` launch a level,
            the exact "fused" volume per batch element where coverage
            fails; eval with views of one size, else it resolves as
            "auto" (cvp_mvsnet.py:355-367). The pipeline's eval default
            (pipeline/depthmaps.py).
Views of different sizes take "warp" where "fused" was chosen.

Depth-slab sharding (`hyp_axis`, cvp_mvsnet.py:249-254 and :395-417 of
the JAX package): inside `dist.mesh.use_mesh` of a mesh whose axis of
that name spans several ranks, the coarsest level is partitioned over
depth: each rank sweeps its contiguous slab of the hypotheses ("rect"
takes the exact "fused" path there), runs the regularizer on it
(dist/depth_parallel.py: boundary planes fetched from the neighbours for
each 3D conv) and the softmax and regression reduce over the slabs
(ops/volumes.py); every rank holds the whole coarse depth. The refinement
levels (8 per-pixel hypotheses) run unsharded on every rank, as in JAX;
they share the regularizer, so only the coarse call runs partitioned.
Under `remat_levels` the coarse level's recomputation in the backward
replays its halo exchanges, on every rank in the same order.

The hypotheses keep their gradient: the regression's depth flows back
through the upsampled coarser depth as in the JAX package; the sampling
grid carries none (the kernels get the hypotheses detached).

Precision: `dtype` / `param_dtype` as in models/mvsnet.py; geometry,
hypotheses, softmax and regression are f32.

Trace spans (utils/monitor.span, recorded only under a profiler):
`wildmvs_torch.cvp_mvsnet.features` (the image pyramid and the extractor
at every level) and, per level k (1 the coarsest, nscale the finest: the
call order), `wildmvs_torch.cvp_mvsnet.level<k>.hypotheses` (the level's
projections and hypotheses: the coarse linspace, or the bicubic upsample
and the per-pixel steps), `.sweep` (the cost volume), `.regularize` (the
call of the shared regularizer and nothing else) and `.regress` (the
softmax and the regression; the photometric confidence at the finest
level). A `remat_levels` replay records its level's `.sweep`,
`.regularize` and `.regress` again, inside the backward. No counter: the
one data-dependent branch of the eval path, `cal_depth_hypo`'s fallback
where no pixel is valid, is a `torch.where` on the device, and counting
it would take a host sync a level.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist.depth_parallel import depth_partitioned
from ..dist.mesh import active_axis, depth_slab
from ..geometry.projective import build_proj_matrices, scale_K
from ..nn.blocks import (ConvBnReLU, ConvTransposeBnReLU, ScoreConv3d,
                         cast_convs, frozen_running_stats, init_weights)
from ..ops.resize import bicubic_double, bilinear_half
from ..ops.select import masked_median
from ..ops.volumes import (depth_regression, photometric_confidence,
                           softmax_depth)
from ..utils.monitor import span
from .api import register_model, view_list
from .mvsnet import SWEEP_METHODS, compute_in, sweep_cost_volume

SPAN = "wildmvs_torch.cvp_mvsnet"

PYRAMID = (("conv0aa", 3, 64), ("conv0ba", 64, 64), ("conv0bb", 64, 64),
           ("conv0bc", 64, 32), ("conv0bd", 32, 32), ("conv0be", 32, 32),
           ("conv0bf", 32, 16), ("conv0bg", 16, 16), ("conv0bh", 16, 16))


class FeaturePyramidNet(nn.Module):
    """[M, H, W, 3] -> [M, H, W, 16] channels-last: nine
    Sequential(Conv2d(bias), LeakyReLU(0.1)) (reference net.py:21-47)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        for name, cin, cout in PYRAMID:
            setattr(self, name, nn.Sequential(
                nn.Conv2d(cin, cout, 3, 1, 1, bias=True),
                nn.LeakyReLU(0.1)))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        with compute_in(self.dtype, self.conv0aa[0].weight):
            for name, _, _ in PYRAMID:
                x = getattr(self, name)(x)
        return x.permute(0, 2, 3, 1).contiguous()


class CVPCostRegNet(nn.Module):
    """The shared 3D regularizer, [B, D, H, W, 16] -> [B, D, H, W] logits
    (reference net.py:50-85): one stride-2 level, a stride-1 and a stride-2
    transposed conv back up, additive skips c2 and c0."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = ConvBnReLU(16, 16, dim=3)
        self.conv0a = ConvBnReLU(16, 16, dim=3)
        self.conv1 = ConvBnReLU(16, 32, stride=2, dim=3)
        self.conv2 = ConvBnReLU(32, 32, dim=3)
        self.conv2a = ConvBnReLU(32, 32, dim=3)
        self.conv3 = ConvBnReLU(32, 64, dim=3)
        self.conv4 = ConvBnReLU(64, 64, dim=3)
        self.conv4a = ConvBnReLU(64, 64, dim=3)
        self.conv5 = ConvTransposeBnReLU(64, 32, 3, 1, 1, 0)
        self.conv6 = ConvTransposeBnReLU(32, 16, 3, 2, 1, 1)
        self.prob0 = ScoreConv3d(16, bias=True)

    def forward(self, x):
        x = x.permute(0, 4, 1, 2, 3).to(self.dtype)
        with compute_in(self.dtype, self.prob0.weight):
            c0 = self.conv0a(self.conv0(x))
            c2 = self.conv2a(self.conv2(self.conv1(c0)))
            c4 = self.conv4a(self.conv4(self.conv3(c2)))
            c5 = c2 + self.conv5(c4)
            c6 = c0 + self.conv6(c5)
            x = self.prob0(c6)
        return x[:, 0]


def cal_depth_hypo(ref_depth, K_ref, K_src, R_ref, t_ref, R_src, t_src,
                   depth_min, depth_max, d: int = 4,
                   pixel_interval: float = 1.0) -> torch.Tensor:
    """Per-pixel eval hypotheses: the depth step that moves the first source
    view's projection by one pixel along its epipolar line, median over
    the valid pixels (reference modules.py:131-226; the JAX package's
    cal_depth_hypo, f32 with the same degenerate-point guards). Where no
    pixel is valid, (depth_max - depth_min) / 128.

    Args:
      ref_depth: [B, H, W] upsampled coarser depth.
      K_ref, K_src: [B, 3, 3] intrinsics at this level; R_* [B, 3, 3],
        t_* [B, 3, 1].
      depth_min, depth_max: [B].
    Returns:
      [B, 2d, H, W] f32: ref_depth + k * median for k = -d .. d-1.
    """
    K_ref, K_src, R_ref, t_ref, R_src, t_src = (
        a.float() for a in (K_ref, K_src, R_ref, t_ref, R_src, t_src))
    depth = ref_depth.float()
    _, h, w = depth.shape
    dev = depth.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    X = torch.stack([xs, ys, torch.ones_like(xs)], -1)        # [H, W, 3]

    def rows(v, M):                      # v @ M.T over [B, H, W, 3]
        return torch.einsum("bhwj,bij->bhwi", v, M)

    ray = torch.einsum("hwj,bij->bhwi", X, torch.linalg.inv(K_ref))
    proj = []
    for dd in (depth, depth + 1.0):
        world = torch.einsum("bhwi,bij->bhwj",
                             ray * dd[..., None] - t_ref[:, None, None, :, 0],
                             R_ref)                   # R_ref^T (cam - t)
        proj.append(rows(rows(world, R_src) + t_src[:, None, None, :, 0],
                         K_src))
    (X1, X2) = proj
    X1_d, X2_d = X1[..., 2], X2[..., 2]
    X1n = X1 / X1_d[..., None]
    X2n = X2 / X2_d[..., None]
    dir_vec = X2n - X1n
    norm_dir = torch.linalg.vector_norm(dir_vec, dim=-1)
    X3 = X1n + pixel_interval * (dir_vec
                                 / norm_dir.clamp_min(1e-8)[..., None])
    A = K_ref @ R_ref @ torch.linalg.inv(K_src @ R_src)
    tmp1 = X1_d[..., None] * rows(X1n, A)
    tmp2 = rows(X3, A)
    # the 2x2 system [X[1:], tmp2[1:]] delta = tmp1[1:], by Cramer's rule
    det = X[..., 1] * tmp2[..., 2] - tmp2[..., 1] * X[..., 2]
    valid = ((norm_dir > 1e-8) & (X1_d > 1e-8) & (X2_d > 1e-8)
             & (det.abs() > 1e-8))
    safe_det = torch.where(det.abs() > 1e-8, det, torch.ones_like(det))
    delta_d = (tmp1[..., 1] * tmp2[..., 2] - tmp2[..., 1] * tmp1[..., 2]) \
        / safe_det
    abs_dd = delta_d.abs()
    nvalid = (valid & ~torch.isnan(abs_dd)).flatten(1).sum(-1)
    med = torch.where(nvalid > 0, masked_median(abs_dd, valid, start_dim=1),
                      (depth_max.float() - depth_min.float()) / 128.0)
    levels = torch.arange(-d, d, dtype=torch.float32,
                          device=dev).reshape(1, 2 * d, 1, 1)
    return depth[:, None] + levels * med[:, None, None, None]


@register_model("cvp_mvsnet")
class CVPMVSNet(nn.Module):
    """CVP-MVSNet under the uniform model contract (models/api.py); train
    mode (`model.train()`) runs the training forward.

    Args:
      nscale: pyramid levels (the forward's `nscale` overrides it; the
        reference trains at 2 and evaluates at 5 on DTU, 4 elsewhere).
      batched_bn: accepted for symmetry (the extractor has no BatchNorm).
      hyp_axis: the mesh axis to shard the coarse sweep's hypotheses
        over (module docstring), or None.
      sweep_method: see the module docstring.
      remat_levels: in train mode, recompute each level's cost volume and
        regularizer in the backward instead of keeping their activations
        (torch.utils.checkpoint).
      packed_training: accepted; the regularizer is unpacked either way.
      dtype, param_dtype, seed: as models/mvsnet.py.
    """

    def __init__(self, nscale: int = 2, batched_bn: bool = False,
                 hyp_axis: str | None = None, sweep_method: str = "auto",
                 remat_levels: bool = False, packed_training: bool = False,
                 dtype=torch.float32, param_dtype=None, seed: int = 0):
        super().__init__()
        if sweep_method not in SWEEP_METHODS:
            raise ValueError(f"sweep_method {sweep_method!r} not in "
                             f"{SWEEP_METHODS}")
        self.nscale = nscale
        self.batched_bn = batched_bn
        self.hyp_axis = hyp_axis
        self.sweep_method = sweep_method
        self.remat_levels = remat_levels
        self.packed_training = packed_training
        self.featurePyramid = FeaturePyramidNet(dtype)
        self.cost_reg_refine = CVPCostRegNet(dtype)
        init_weights(self, torch.Generator().manual_seed(seed))
        cast_convs(self, dtype if param_dtype is None else param_dtype)

    def resolve_sweep(self, feats_dtype: torch.dtype, device: torch.device,
                      ragged: bool) -> str:
        """The cost-volume backend this forward takes."""
        method = self.sweep_method
        if method == "fused" and self.training:
            raise ValueError(
                "sweep_method='fused' is eval only (fused_cost_volume has "
                "no backward); train through 'warp', 'gather' or 'auto'")
        if method == "rect" and (self.training or ragged):
            method = "auto"       # the JAX package's fall-through
        if method == "auto":
            kernel = "warp" if self.training else "fused"
            method = (kernel if device.type == "cuda"
                      and feats_dtype == torch.bfloat16 else "gather")
        if method == "fused" and ragged:
            method = "warp"
        return method

    def cost_volume(self, flevel, proj, hyp, method: str,
                    slab=None) -> torch.Tensor:
        """The variance cost volume [B, D, H, W, C] of one level (this
        rank's slab of it with `slab`).

        Args:
          flevel: the level's features, reference first ([B, h_i, w_i, C]).
          proj: [B, N, 4, 4] projections at the level, reference first.
          hyp: [B, D] or [B, D, H, W] f32 hypotheses, all D.
          method: "gather" | "warp" | "fused" | "rect" (`resolve_sweep`).
          slab: a dist.mesh.Slab of the hypotheses: sweep this rank's.
        """
        srcs = flevel[1:]
        projs = [proj[:, i] for i in range(1, len(flevel))]
        if slab is None:
            return sweep_cost_volume(flevel[0], srcs, projs, proj[:, 0], hyp,
                                     method)
        return sweep_cost_volume(flevel[0], srcs, projs, proj[:, 0],
                                 hyp[:, slab.lo:slab.hi],
                                 "fused" if method == "rect" else method)

    def regress(self, cost: torch.Tensor, hyp: torch.Tensor, slab=None,
                level: int | None = None, confidence: bool = False):
        """(prob [B, D, H, W] f32, depth [B, H, W] f32) of a cost volume,
        and with `confidence` the photometric confidence [B, H, W] third;
        with `slab`, the regularizer depth-partitioned and prob this rank's
        slab. `level` (k) puts the regularizer under the span
        `.level<k>.regularize` and the rest under `.level<k>.regress`."""
        name = SPAN if level is None else f"{SPAN}.level{level}"
        with depth_partitioned(self.cost_reg_refine,
                               None if slab is None else slab.axis,
                               hyp.shape[1]):
            with span(f"{name}.regularize"):
                logits = self.cost_reg_refine(cost)
        with span(f"{name}.regress"):
            prob = softmax_depth(logits.float(), slab)
            depth = depth_regression(prob, hyp, slab)
            if not confidence:
                return prob, depth
            return prob, depth, photometric_confidence(prob.detach(), slab)

    def _level(self, level: int, last: bool, flevel, proj, hyp, method,
               slab=None):
        """(depth, confidence) of level `level` (1 the coarsest), the
        confidence None but at the `last`; with remat_levels in train mode,
        the cost volume and regularizer are recomputed in the backward."""
        def run(proj, hyp, *flevel):
            with span(f"{SPAN}.level{level}.sweep"):
                cost = self.cost_volume(list(flevel), proj, hyp, method,
                                        slab)
            out = self.regress(cost, hyp, slab, level=level,
                               confidence=last)
            return out[1], out[2] if last else None

        if not (self.remat_levels and self.training):
            return run(proj, hyp, *flevel)
        replay = []

        def remat(proj, hyp, *flevel):
            ctx = (frozen_running_stats(self.cost_reg_refine) if replay
                   else contextlib.nullcontext())
            replay.append(True)
            with ctx:
                return run(proj, hyp, *flevel)
        return checkpoint(remat, proj, hyp, *flevel, use_reentrant=False)

    def forward(self, imgs, K, R, t, depth_min, depth_max,
                reference_frame: int = 0, nscale: int | None = None):
        nscale = self.nscale if nscale is None else int(nscale)
        views, ragged = view_list(imgs)
        n = len(views)
        b = views[0].shape[0]
        ref = reference_frame
        order = [ref] + [i for i in range(n) if i != ref]
        dmin = depth_min[:, ref].float()
        dmax = depth_max[:, ref].float()

        # image pyramid and per-level features, reference first; ratio: each
        # view's level height over its own full height (one pyramid per view
        # when the sizes differ, as the reference's per-view calls)
        with span(f"{SPAN}.features"):
            if ragged:
                pyr = []
                for i in order:
                    lv = [views[i]]
                    for _ in range(nscale - 1):
                        lv.append(bilinear_half(lv[-1]))
                    pyr.append(lv)
                feats = [[self.featurePyramid(pyr[v][lvl]) for v in range(n)]
                         for lvl in range(nscale)]
                ratio = [[pyr[v][lvl].shape[1] / pyr[v][0].shape[1]
                          for v in range(n)] for lvl in range(nscale)]
            else:
                stacked = (imgs if torch.is_tensor(imgs)
                           else torch.stack(views, 1))
                h, w, c = stacked.shape[2:]
                level_imgs = [stacked.reshape(b * n, h, w, c)]
                for _ in range(nscale - 1):
                    level_imgs.append(bilinear_half(level_imgs[-1]))
                feats = []
                for li in level_imgs:
                    f = self.featurePyramid(li)
                    f = f.reshape((b, n) + f.shape[1:])
                    feats.append([f[:, i] for i in order])
                ratio = [[li.shape[1] / h] * n for li in level_imgs]

        Ko, Ro, to = (a[:, order].float() for a in (K, R, t))

        def level_K(level):
            return torch.stack([scale_K(Ko[:, i], ratio[level][i])
                                for i in range(n)], 1)

        method = self.resolve_sweep(feats[0][0].dtype, feats[0][0].device,
                                    ragged)

        # coarsest level (k = 1): a full fronto-parallel sweep
        with span(f"{SPAN}.level1.hypotheses"):
            nhyp = 48 if self.training else 96
            steps = torch.arange(nhyp, dtype=torch.float32,
                                 device=dmin.device)
            hyp = dmin[:, None] + steps * ((dmax - dmin) / nhyp)[:, None]
            proj = build_proj_matrices(level_K(nscale - 1), Ro, to)
        slab = depth_slab(nhyp, active_axis(self.hyp_axis))
        depth, conf = self._level(1, nscale == 1, feats[nscale - 1], proj,
                                  hyp, method, slab)
        depth_est_list = [depth]

        # refinement levels (k = 2 .. nscale): +-4 hypotheses around the
        # upsampled depth
        for k, level in enumerate(range(nscale - 2, -1, -1)):
            with span(f"{SPAN}.level{k + 2}.hypotheses"):
                depth_up = bicubic_double(depth)
                Ks = level_K(level)
                if self.training:
                    isz = (dmax - dmin) / 48.0 / (2.0 ** (k + 1))
                    offs = torch.arange(-4, 4, dtype=torch.float32,
                                        device=dmin.device).reshape(
                                            1, 8, 1, 1)
                    hyp = depth_up[:, None] + offs * isz[:, None, None, None]
                else:
                    hyp = cal_depth_hypo(depth_up, Ks[:, 0], Ks[:, 1],
                                         Ro[:, 0], to[:, 0], Ro[:, 1],
                                         to[:, 1], dmin, dmax)
                proj = build_proj_matrices(Ks, Ro, to)
            depth, conf = self._level(k + 2, level == 0, feats[level], proj,
                                      hyp, method)
            depth_est_list.append(depth)

        depth_est_list.reverse()                       # finest first
        return {
            "depth": depth_est_list[0],
            "depth_est_list": depth_est_list,
            "depth_pair_list": [],
            "photometric_confidence": conf,
        }
