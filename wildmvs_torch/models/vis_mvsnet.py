"""Vis-MVSNet: a 3-stage coarse-to-fine cascade with per-pair,
visibility-weighted fusion.

Counterpart of wildmvs/models/vis_mvsnet.py (reference models/VisMVSNet/
model_cas.py, frontend.py, nn_utils.py, homography.py), eval and train
forward:
  FeatExt: stride-2 init conv + 3-scale 2D UNet -> 32-channel features at
    1/8, 1/4 and 1/2 resolution (model_cas.py:18-35)
  per stage (SingleStage, model_cas.py:166-420): per source view a
    group-wise correlation cost volume (8 groups) over a homography sweep,
    regularized by a small 3D UNet (Reg); RegPair scores it to a per-pair
    depth and entropy, UncertNet turns the entropy into an uncertainty;
    the pairs' volumes are fused by weights from the uncertainties and
    re-regularized (RegFuse) -> the stage depth by soft-argmin, and the
    probability mass within +-2 of it
  cascade (frontend.py:26-109): stage 1 sweeps depth_nums[0] hypotheses
    of width interval * interval_scales[0] from depth_min; stages 2-3
    re-centre a per-pixel slab on the upsampled previous depth.

Quirks of the reference kept as the JAX package keeps them
(vis_mvsnet.py:18-27):
  * slab re-centring uses the MODULE's interval_scales even when the sweep
    interval is overridden by the forward's `interval_scales`
  * UncertNet adds its 1-channel input to its 8-channel features by
    broadcast
  * depth_interval is (depth_max - depth_min) / 128 of the reference view
  * photometric_confidence is the stack [prob1 x4 up, prob2 x2 up, prob3]

Fusion, all five modes (soft | hard | average | uwta | maxpool): at eval
with views of one size, the stacked form of vis_mvsnet.py:294-320 (soft:
softmax(-u) over the pairs with max-subtraction); in train mode or with
views of different sizes, the sequential form of :327-364 (soft: bare
exp(-u)). The two are kept apart, as in the JAX package.

Cost-volume backends (`sweep_method`):
  "gather"  the exact homography gather (ops/plane_sweep.py) and
            groupwise_correlation in torch;
  "warp"    the `sweep_warp` kernel in the Vis convention (`vis_planes`)
            and groupwise_correlation in f32; differentiable through the
            `sweep_warp_backward` kernel (the counterpart of
            homography_sweep_warp_mosaic, mosaic_sweep.py:1646-1736);
  "gwc"     the `sweep_gwc` kernel, warp and correlation in one launch per
            pair (homography_gwc_volume_mosaic, :1570-1643); eval only;
  "auto"    for bf16 features on the card "gwc" at eval and "warp" in
            train mode, else "gather";
  "rect"    the rectified sweep (ops/rect_sweep.py): each stage resamples
            every source once onto a canvas, then one `sweep_gwc` launch
            per pair on the canvas; eval only, where the stage's sources
            share one size of at least 21 px (the JAX package's gate,
            vis_mvsnet.py:233-262), else the exact "gwc" path; per batch
            element, a pair whose coverage probe fails takes the exact
            path. In train mode "rect" trains as "auto" does.
The kernels take any source size, so views of different sizes take the
same backend, one launch per pair.

Sharding (the JAX package's view_axis / hyp_axis, vis_mvsnet.py:145-146,
:222-238, :360-369, :387-391), inside `dist.mesh.use_mesh` of a mesh
whose axes of those names span several ranks ("rect" takes the exact
"gwc" path under either):
  view_axis  at eval with views of one size, the source pairs split over
             the ranks, each running its pairs' sweep and pair tail; the
             stacked fusion's sums (soft, hard: the weighted sum and the
             weight sum, after a max over the ranks of soft's -u; average:
             the sum) are added over the ranks by one all_reduce, maxpool
             and uwta reduce by max / min; the pair depths and
             uncertainties are gathered, so every rank returns what the
             unsharded forward does. Train mode and ragged views keep
             every pair on every rank, as in JAX.
  hyp_axis   each rank sweeps every pair's correlation volume on its
             contiguous slab of the stage's hypotheses and keeps it: Reg,
             RegPair and RegFuse run depth-partitioned
             (dist/depth_parallel.py: each 3D conv fetches its
             neighbours' boundary planes), and the fusion, elementwise
             over depth, runs on the slabs (under view x hyp its
             all_reduce over view moves a slab). Train mode too, as JAX's
             SPMD partitioning of the same program (vis_mvsnet.py:171-174,
             :366-369). The 1-channel scores of RegPair and RegFuse (an
             eighth of the Reg volume) are gathered, and soft_argmin and
             the entropy reduce them whole, bit for bit as the unsharded
             forward does, where sums over the slabs (ops/volumes.py
             `slab`) would add in another order: the cascade re-centres
             each stage on the previous stage's depth and weights the
             fusion by the entropy, so a last-bit change of one 8-plane
             entropy sum moves the third stage's pair uncertainties by
             1e-4 (the unsharded model with that sum reordered does so).

Precision: `dtype` is the networks' compute dtype, `param_dtype` (default
`dtype`) the dtype of the convolution weights, as in models/mvsnet.py:
autocast is confined to the networks, BatchNorm stays f32, geometry is
f32, and the correlation sums, softmaxes, entropies, fusion and depths are
f32 (the JAX package keeps them in the compute dtype).

Trace spans (utils/monitor.span, recorded only under a profiler):
`wildmvs_torch.vis_mvsnet.features` and, per stage k,
`wildmvs_torch.vis_mvsnet.stage<k>.sweep` (a pair's correlation volume),
`.regularize` (every call of Reg, RegPair and RegFuse, nothing else),
`.fuse` (the pair fusion) and `.regress` (the stage's soft-argmin).
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn

from ..dist.depth_parallel import depth_partitioned
from ..dist.mesh import active_axis, all_reduce, gather_slabs, my_slab
from ..geometry.projective import scale_K
from ..losses.supervised import resize_bilinear
from ..nn.blocks import ScoreConv3d, UNet, cast_convs, init_weights
from ..ops.plane_sweep import homography_sweep_warp
from ..ops.rect_sweep import exact_gwc_volume, rect_gwc_volume
from ..ops.sweep_kernels import GWC_GROUPS, sweep_warp, vis_planes, vis_svals
from ..ops.volumes import entropy, groupwise_correlation, soft_argmin
from ..utils.monitor import span
from .api import register_model, view_list
from .mvsnet import compute_in

SPAN = "wildmvs_torch.vis_mvsnet"

SWEEP_METHODS = ("auto", "gather", "gwc", "warp", "rect")
FUSION_MODES = ("soft", "hard", "average", "uwta", "maxpool")


def _conv_bn_relu(cin: int, cout: int, k: int, stride: int, pad: int):
    """Sequential(Conv2d, BatchNorm2d, ReLU): keys `.0` and `.1`."""
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, pad, bias=False),
                         nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1),
                         nn.ReLU(inplace=True))


class _Net(nn.Module):
    """A network that computes in `dtype` (autocast when its weights are
    another dtype) on channels-last inputs seen as NC(D)HW."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype

    def run(self, x, fn, weight):
        perm = (0, x.dim() - 1) + tuple(range(1, x.dim() - 1))
        x = x.permute(*perm).to(self.dtype)
        with compute_in(self.dtype, weight):
            out = fn(x)
        back = (0,) + tuple(range(2, x.dim())) + (1,)
        if isinstance(out, (list, tuple)):
            return tuple(o.permute(*back).contiguous() for o in out)
        return out.permute(*back)


class FeatExt(_Net):
    """[M, H, W, 3] -> 32-channel features at 1/8, 1/4, 1/2 (reference
    model_cas.py:18-35), channels-last."""

    def __init__(self, dtype=torch.float32):
        super().__init__(dtype)
        self.init_conv = _conv_bn_relu(3, 16, 5, 2, 2)
        self.unet = UNet(16, 2, 1, (32, 64, 128), "2d", 2, dim=2)
        self.final_conv_1 = nn.Conv2d(128, 32, 3, 1, 1, bias=False)
        self.final_conv_2 = nn.Conv2d(64, 32, 3, 1, 1, bias=False)
        self.final_conv_3 = nn.Conv2d(32, 32, 3, 1, 1, bias=False)

    def forward(self, x):
        def fn(x):
            f8, f4, f2 = self.unet(self.init_conv(x), multi_scale=3)
            return (self.final_conv_1(f8), self.final_conv_2(f4),
                    self.final_conv_3(f2))
        return self.run(x, fn, self.final_conv_1.weight)


class Reg(_Net):
    """Per-pair 3D regularizer, [B, D, H, W, 8] -> [B, D, H, W, 8]
    (reference model_cas.py:38-48)."""

    def __init__(self, dtype=torch.float32):
        super().__init__(dtype)
        self.unet = UNet(8, 1, 0, (8, 16), "reg1", 4, dim=3)

    def forward(self, x):
        return self.run(x, self.unet, next(self.unet.parameters()))


class RegPair(_Net):
    """Per-pair scorer, [B, D, H, W, 8] -> [B, D, H, W, 1] (reference
    model_cas.py:51-59)."""

    def __init__(self, dtype=torch.float32):
        super().__init__(dtype)
        self.final_conv = ScoreConv3d(8, bias=False)

    def forward(self, x):
        return self.run(x, self.final_conv, self.final_conv.weight)


class RegFuse(_Net):
    """Fused-volume regularizer and scorer, [B, D, H, W, 8] ->
    [B, D, H, W, 1] (reference model_cas.py:62-74)."""

    def __init__(self, dtype=torch.float32):
        super().__init__(dtype)
        self.unet = UNet(8, 1, 0, (8, 16), "reg2", 4, dim=3)
        self.final_conv = ScoreConv3d(8, bias=False)

    def forward(self, x):
        return self.run(x, lambda v: self.final_conv(self.unet(v)),
                        self.final_conv.weight)


class UncertNet(_Net):
    """Entropy -> uncertainty, [B, H, W, 1] -> [B, H, W, 1] (reference
    model_cas.py:77-98); the 1-channel input is added to the 8-channel
    features by broadcast."""

    def __init__(self, dtype=torch.float32):
        super().__init__(dtype)
        self.conv1 = _conv_bn_relu(1, 8, 3, 1, 1)
        self.conv2 = _conv_bn_relu(8, 8, 3, 1, 1)
        self.head_convs = nn.Sequential(nn.Conv2d(8, 1, 3, 1, 1, bias=False))

    def forward(self, x):
        return self.run(x, lambda v: self.head_convs(
            self.conv2(self.conv1(v)) + v), self.head_convs[0].weight)


class SingleStage(nn.Module):
    """One cascade stage with per-pair visibility fusion (reference
    model_cas.py:166-420; the JAX package's SingleStage)."""

    def __init__(self, mode: str = "soft", dtype=torch.float32,
                 view_axis: str | None = None, hyp_axis: str | None = None,
                 name: str = "stage"):
        super().__init__()
        if mode not in FUSION_MODES:
            raise NotImplementedError(f"fusion mode: {mode}")
        self.mode = mode
        #: prefix of the stage's trace spans (utils/monitor.span)
        self.span = f"{SPAN}.{name}"
        self.view_axis = view_axis
        self.hyp_axis = hyp_axis
        self.reg = Reg(dtype)
        self.reg_pair = RegPair(dtype)
        self.uncert_net = UncertNet(dtype)
        self.reg_fuse = RegFuse(dtype)

    def _tail(self, cost, depth_start, depth_interval, hyp=None,
              depth_num=None):
        """correlation volume -> (reg volume, pair depth, uncertainty); over
        an active `hyp` axis the volumes are this rank's slabs of the
        depth_num hypotheses, the score gathered whole."""
        with span(f"{self.span}.regularize"):
            interm = self.reg(cost)                       # [B, D, H, W, 8]
            pair_score = self.reg_pair(interm)
        score = gather_slabs(pair_score[..., 0].float(), hyp, 1,
                             depth_num)                   # [B, D, H, W]
        prob, est_class = soft_argmin(score)
        est_depth = est_class * depth_interval[:, 0] + depth_start[:, 0]
        ent = entropy(prob, axis=1)[..., None]            # [B, H, W, 1]
        uncert = self.uncert_net(ent)[..., 0].float()     # [B, H, W]
        return interm, est_depth, uncert

    def forward(self, ref_feat, srcs_feat, cams, depth_num: int,
                depth_start, depth_interval, s_scale: int, method: str):
        """cams: K/R/t [B, N, ...] with the reference first, K at the input
        resolution (scaled by 1/s_scale here, model_cas.py:177).
        depth_start [B, 1, 1, 1] or [B, 1, H, W]; depth_interval
        [B, 1, 1, 1]. Returns (depth [B, H, W], prob_map [B, H, W],
        [(pair depth, (pair uncertainty,)), ...])."""
        K = scale_K(cams["K"].float(), 1.0 / s_scale)
        R, t = cams["R"].float(), cams["t"].float()
        b, h, w, c = ref_feat.shape
        n_src = len(srcs_feat)
        dtype = ref_feat.dtype

        uniform = all(s.shape == srcs_feat[0].shape for s in srcs_feat)
        stacked = not self.training and uniform
        hyp = active_axis(self.hyp_axis)
        view = active_axis(self.view_axis) if stacked else None
        if view is not None and view.size > n_src:
            raise ValueError(f"{n_src} source pairs cannot be split over "
                             f"{view.size} ranks")
        lo, hi = my_slab(depth_num, hyp)
        mine = range(*my_slab(n_src, view))
        if method == "rect" and not (uniform and hyp is None and view is None
                                     and min(srcs_feat[0].shape[1:3]) >= 21):
            # the JAX package's gate (vis_mosaic_supported, uniform
            # stacked pairs); elsewhere the exact kernel path
            method = "gwc"
        if method == "rect":
            with span(f"{self.span}.sweep"):
                costs = rect_gwc_volume(srcs_feat, ref_feat, K, R, t,
                                        depth_num, depth_start,
                                        depth_interval, (h, w))

        def cost_of(i):
            src = srcs_feat[i]
            if method == "rect":
                return costs[i]
            if method == "gather":
                warped = homography_sweep_warp(
                    src, K[:, 0], R[:, 0], t[:, 0], K[:, i + 1], R[:, i + 1],
                    t[:, i + 1], depth_num, depth_start, depth_interval,
                    (h, w), None if hyp is None else range(lo, hi))
                return groupwise_correlation(ref_feat[:, None], warped,
                                             GWC_GROUPS)
            s = vis_svals(depth_num, depth_start, depth_interval, (h, w))
            if hyp is not None:
                s = s[:, lo:hi].contiguous()
            src16 = src.to(torch.bfloat16).contiguous()
            src_hw = tuple(src.shape[1:3])
            if method == "gwc":
                return exact_gwc_volume(
                    src16, ref_feat.to(torch.bfloat16).contiguous(), K, R, t,
                    i + 1, s, src_hw).to(dtype)
            P, Q, scale, clamp = vis_planes(K[:, 0], R[:, 0], t[:, 0],
                                            K[:, i + 1], R[:, i + 1],
                                            t[:, i + 1], (h, w), src_hw)
            warped = sweep_warp(src16, P, Q, s, scale, clamp)
            return groupwise_correlation(ref_feat.float()[:, None],
                                         warped.float(),
                                         GWC_GROUPS).to(dtype)

        with contextlib.ExitStack() as partitioned:
            for net in (self.reg, self.reg_pair, self.reg_fuse):
                partitioned.enter_context(depth_partitioned(net, hyp,
                                                            depth_num))
            pairs = []
            for i in mine:
                with span(f"{self.span}.sweep"):
                    cost = cost_of(i)
                pairs.append(self._tail(cost, depth_start, depth_interval,
                                        hyp, depth_num))
            with span(f"{self.span}.fuse"):
                if view is not None:
                    fused = self._fuse_stacked_sharded(pairs, view,
                                                       mine.start, n_src)
                    ests, uncs = (gather_slabs(
                        torch.stack([p[j] for p in pairs]), view, 0, n_src)
                        for j in (1, 2))
                    pair_results = [(ests[i], (uncs[i],))
                                    for i in range(n_src)]
                else:
                    pair_results = [(est, (unc,)) for _, est, unc in pairs]
                    fused = (self._fuse_stacked(pairs) if stacked
                             else self._fuse_sequential(pairs))
            with span(f"{self.span}.regularize"):
                fused_score = self.reg_fuse(fused)
            score = gather_slabs(fused_score[..., 0].float(), hyp, 1,
                                 depth_num)
        with span(f"{self.span}.regress"):
            _, est_class, prob_map = soft_argmin(score, window=2)
            est_depth = est_class * depth_interval[:, 0] + depth_start[:, 0]
        return est_depth, prob_map, pair_results

    def _fuse_stacked(self, pairs):
        """Eval with views of one size (vis_mvsnet.py:294-320)."""
        interm_s = torch.stack([p[0] for p in pairs], 0)  # [S, B, D, H, W, 8]
        unc_s = torch.stack([p[2] for p in pairs], 0)     # [S, B, H, W]
        if self.mode == "soft":
            # softmax(-u) with max-subtraction: exp(-u) / sum exp(-u),
            # finite for any finite uncertainty
            lw = -unc_s[:, :, None, :, :, None]
            lw = lw - lw.max(0, keepdim=True).values.detach()
            weight = torch.exp(lw)
            return (interm_s * weight).sum(0) / weight.sum(0)
        if self.mode == "hard":
            weight = (unc_s < 0).float()[:, :, None, :, :, None] + 1e-4
            return (interm_s * weight).sum(0) / weight.sum(0)
        if self.mode == "average":
            return interm_s.float().mean(0)
        if self.mode == "uwta":
            # argmin keeps the first minimum, as the sequential strict <
            sel = unc_s.argmin(0)[:, None, :, :, None]    # [B, 1, H, W, 1]
            return torch.gather(interm_s, 0, sel[None].expand(
                (1,) + interm_s.shape[1:]))[0].float()
        return interm_s.max(0).values.float()            # maxpool

    def _fuse_stacked_sharded(self, pairs, view, first: int, n_src: int):
        """`_fuse_stacked` with the pairs split over the `view` ranks, this
        rank's being pairs first, first + 1, ... (eval only: the
        reductions carry no gradient)."""
        interm_s = torch.stack([p[0] for p in pairs], 0)
        unc_s = torch.stack([p[2] for p in pairs], 0)
        if self.mode in ("soft", "hard"):
            if self.mode == "soft":
                lw = -unc_s[:, :, None, :, :, None]
                top = all_reduce(lw.max(0, keepdim=True).values, view,
                                 dist.ReduceOp.MAX)
                weight = torch.exp(lw - top)
            else:
                weight = (unc_s < 0).float()[:, :, None, :, :, None] + 1e-4
            num = (interm_s * weight).sum(0)
            den = weight.sum(0)
            both = all_reduce(torch.cat([num.reshape(-1), den.reshape(-1)]),
                              view)
            return (both[:num.numel()].view_as(num)
                    / both[num.numel():].view_as(den))
        if self.mode == "average":
            return all_reduce(interm_s.float().sum(0), view) / n_src
        if self.mode == "uwta":
            # the first pair, in pair order, of the least uncertainty
            least = all_reduce(unc_s.min(0).values, view, dist.ReduceOp.MIN)
            ids = torch.arange(first, first + len(pairs),
                               device=unc_s.device).reshape(-1, 1, 1, 1)
            pick = all_reduce(torch.where(unc_s == least, ids, n_src)
                              .min(0).values, view, dist.ReduceOp.MIN)
            sel = (ids == pick).float()[:, :, None, :, :, None]
            return all_reduce((interm_s.float() * sel).sum(0), view)
        return all_reduce(interm_s.max(0).values.float(), view,
                          dist.ReduceOp.MAX)                 # maxpool

    def _fuse_sequential(self, pairs):
        """Train mode, or views of different sizes (vis_mvsnet.py:327-364)."""
        n_src = len(pairs)
        fused = weight_sum = min_weight = None
        for i, (interm, _, uncert) in enumerate(pairs):
            interm = interm.float()
            if self.mode in ("soft", "hard"):
                if self.mode == "soft":
                    weight = torch.exp(-uncert)[:, None, :, :, None]
                else:
                    weight = (uncert < 0).float()[:, None, :, :, None] + 1e-4
                weight_sum = weight if i == 0 else weight_sum + weight
                fused = interm * weight if i == 0 else fused + interm * weight
            elif self.mode == "average":
                fused = interm if i == 0 else fused + interm
            elif self.mode == "uwta":
                weight = uncert[:, None, :, :, None]
                if min_weight is None:
                    min_weight, fused = weight, interm
                else:
                    mask = (weight < min_weight).float()
                    min_weight = weight * mask + min_weight * (1 - mask)
                    fused = interm * mask + fused * (1 - mask)
            else:                                         # maxpool
                fused = interm if i == 0 else torch.maximum(fused, interm)
        if self.mode in ("soft", "hard"):
            return fused / weight_sum
        if self.mode == "average":
            return fused / n_src
        return fused


@register_model("vis_mvsnet")
class VisMVSNet(nn.Module):
    """Vis-MVSNet under the uniform model contract (models/api.py); train
    mode (`model.train()`) runs the training forward.

    Args:
      depth_nums: hypotheses per stage (coarsest first).
      interval_scales: hypothesis spacing per stage, in units of
        (depth_max - depth_min) / 128; also the slab re-centring's scales.
      mode: pair fusion, one of FUSION_MODES.
      batched_bn: featurize all views in one call in train mode too.
      view_axis, hyp_axis: the mesh axes to shard the source pairs and the
        hypotheses over (module docstring), or None.
      sweep_method: see the module docstring.
      dtype: torch.float32 or torch.bfloat16 compute for the networks.
      param_dtype: dtype of the convolution weights (default `dtype`).
      seed: seed of the random initial weights.
    """

    def __init__(self, depth_nums=(32, 16, 8),
                 interval_scales=(4.0, 2.0, 1.0), mode: str = "soft",
                 batched_bn: bool = False, sweep_method: str = "auto",
                 view_axis: str | None = None, hyp_axis: str | None = None,
                 dtype=torch.float32, param_dtype=None, seed: int = 0):
        super().__init__()
        if sweep_method not in SWEEP_METHODS:
            raise ValueError(f"sweep_method {sweep_method!r} not in "
                             f"{SWEEP_METHODS}")
        self.depth_nums = tuple(depth_nums)
        self.interval_scales = tuple(interval_scales)
        self.mode = mode
        self.batched_bn = batched_bn
        self.sweep_method = sweep_method
        self.view_axis = view_axis
        self.hyp_axis = hyp_axis
        self.feat_ext = FeatExt(dtype)
        self.stage1 = SingleStage(mode, dtype, view_axis, hyp_axis, "stage1")
        self.stage2 = SingleStage(mode, dtype, view_axis, hyp_axis, "stage2")
        self.stage3 = SingleStage(mode, dtype, view_axis, hyp_axis, "stage3")
        init_weights(self, torch.Generator().manual_seed(seed))
        cast_convs(self, dtype if param_dtype is None else param_dtype)

    def resolve_sweep(self, feats_dtype: torch.dtype,
                      device: torch.device) -> str:
        """The cost-volume backend this forward takes."""
        method = self.sweep_method
        if method == "gwc" and self.training:
            raise ValueError(
                "sweep_method='gwc' is eval only (sweep_gwc has no "
                "backward); train through 'warp', 'gather' or 'auto'")
        if method == "rect" and self.training:
            method = "auto"          # the JAX package's training fall-through
        if method == "auto":
            kernel = "warp" if self.training else "gwc"
            method = (kernel if device.type == "cuda"
                      and feats_dtype == torch.bfloat16 else "gather")
        return method

    def forward(self, imgs, K, R, t, depth_min, depth_max,
                reference_frame: int = 0, depth_nums=None,
                interval_scales=None):
        depth_nums = tuple(depth_nums or self.depth_nums)
        interval_scales = tuple(interval_scales or self.interval_scales)
        views, ragged = view_list(imgs)
        n = len(views)
        b = views[0].shape[0]
        ref = reference_frame
        order = [ref] + [i for i in range(n) if i != ref]
        # hypothesis spacing: 128 steps of the reference's range
        depth_interval = ((depth_max - depth_min).float() / 128.0)[:, ref]
        d_start0 = depth_min[:, ref].float().reshape(b, 1, 1, 1)
        d_interval = depth_interval.reshape(b, 1, 1, 1)

        with span(f"{SPAN}.features"):
            if ragged or (self.training and not self.batched_bn):
                # per-view calls: train-mode BatchNorm statistics per view,
                # updated in view order (reference first)
                per_view = {i: self.feat_ext(views[i]) for i in order}
                feats = [[per_view[i][lvl] for i in order]
                         for lvl in range(3)]
            else:
                stacked = (imgs if torch.is_tensor(imgs)
                           else torch.stack(views, 1))
                h, w, c = stacked.shape[2:]
                packs = self.feat_ext(stacked.reshape(b * n, h, w, c))
                feats = [[f.reshape((b, n) + f.shape[1:])[:, i]
                          for i in order] for f in packs]
        cams = {k: v[:, order] for k, v in (("K", K), ("R", R), ("t", t))}
        method = self.resolve_sweep(feats[0][0].dtype, feats[0][0].device)

        est1, prob1, pairs1 = self.stage1(
            feats[0][0], feats[0][1:], cams, depth_nums[0], d_start0,
            d_interval * interval_scales[0], 8, method)
        prob1_up = resize_bilinear(prob1, (prob1.shape[1] * 4,
                                           prob1.shape[2] * 4))
        # re-centring uses the module's interval_scales (frontend.py:76-78)
        up1 = resize_bilinear(est1.detach(), tuple(feats[1][0].shape[1:3]))
        d_start2 = (up1 - depth_nums[1] * depth_interval[:, None, None]
                    * self.interval_scales[1] / 2.0)[:, None]
        est2, prob2, pairs2 = self.stage2(
            feats[1][0], feats[1][1:], cams, depth_nums[1], d_start2,
            d_interval * interval_scales[1], 4, method)
        prob2_up = resize_bilinear(prob2, (prob2.shape[1] * 2,
                                           prob2.shape[2] * 2))
        up2 = resize_bilinear(est2.detach(), tuple(feats[2][0].shape[1:3]))
        d_start3 = (up2 - depth_nums[2] * depth_interval[:, None, None]
                    * self.interval_scales[2] / 2.0)[:, None]
        est3, prob3, pairs3 = self.stage3(
            feats[2][0], feats[2][1:], cams, depth_nums[2], d_start3,
            d_interval * interval_scales[2], 2, method)
        return {
            "depth": est3,
            "depth_est_list": [est3, est2, est1],            # finest first
            "depth_pair_list": [pairs3, pairs2, pairs1],
            "photometric_confidence": torch.stack(
                [prob1_up, prob2_up, prob3], 1),
        }
