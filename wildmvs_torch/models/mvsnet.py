"""MVSNet: single-scale plane sweep with variance or softmin aggregation.

Counterpart of wildmvs/models/mvsnet.py:35-322 (reference
models/MVSNet/model.py), eval and train forward:
  FeatureNet: 7 conv2d (8 -> 16 -> 32 channels, two stride-2) + a final conv
    -> 1/4-resolution 32-channel features; one batched call over all views
    at eval, one call per view in train mode (per-view BatchNorm
    statistics, as the reference; `batched_bn=True` batches them)
  cost volume over `num_depth` hypotheses from the reference view's own
    range, aggregated across views by variance or softmin
  CostRegNet: 3D U-Net (8/16/32/64 channels, three stride-2 levels,
    transposed-conv up, additive skips c4, c2, c0)
  softmax over depth -> soft-argmin depth + 4-tap photometric confidence

Cost-volume backends (`sweep_method`):
  "gather"  the plain exact f32 gather (ops/plane_sweep.py);
  "warp"    the per-view `sweep_warp` kernel, aggregation in torch (the
            counterpart of JAX _cost_volume_mosaic_v1 at eval and of
            plane_sweep_warp_mosaic in training); differentiable through
            the `sweep_warp_backward` kernel;
  "fused"   the `fused_cost_volume` kernel, one launch per forward; eval
            only (it has no backward; train mode raises);
  "auto"    for bf16 features on the card "fused" at eval and "warp" in
            train mode, else "gather" (f32 features are not what the
            kernels take; the CPU runs the exact path);
  "rect"    the rectified sweep (ops/rect_sweep.py): each source resampled
            once onto a canvas, then one `fused_cost_volume` launch on the
            canvases (per batch element, the exact "fused" volume where
            the coverage probe fails); eval with views of one size, else
            (training, ragged views) it resolves as "auto" (the JAX
            package's gates, mvsnet.py:235-247).
Views of different sizes go through "warp" where "fused" was chosen: the
warp kernel takes any source size, one launch per source view.

Depth-slab sharding (`hyp_axis`, the JAX package's mvsnet.py:119-123,
:279-287): inside `dist.mesh.use_mesh` of a mesh whose axis of that name
spans several ranks, each rank sweeps its contiguous slab of the
hypotheses (one "fused" launch at eval, one "warp" launch a source view
in training; "rect" takes the exact "fused" path there) and keeps it:
CostRegNet runs depth-partitioned (dist/depth_parallel.py: each 3D conv
fetches its neighbours' boundary planes, every level split by
`slab_bounds` of its own length), and the softmax, the regression and the
confidence reduce over the slabs (ops/volumes.py), as JAX's SPMD
partitioning does. Every rank returns the whole depth and confidence. The
JAX package turns its Pallas kernel off under the axis; the port's kernels
take a sub-range of the hypotheses as they are. Outside such a mesh the
model runs unsharded.

Precision: `dtype` is the networks' compute dtype, `param_dtype` (default
`dtype`) the dtype of the convolution weights, as flax's pair. Serving
(dtype=param_dtype=bf16) casts the weights once; training (dtype=bf16,
param_dtype=f32) keeps f32 parameters and runs the convolutions in bf16
under torch.autocast, confined to the two networks. BatchNorm parameters
and statistics stay f32 and return the compute dtype; geometry
(projections, hypotheses, sampling coordinates) stays f32. The softmax and
regression run in f32 (the JAX package takes its softmax in bf16).

Trace spans (utils/monitor.span, recorded only under a profiler):
`wildmvs_torch.mvsnet.features`, `.sweep` (the cost volume),
`.regularize` (CostRegNet) and `.regress` (softmax, depth, confidence).
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..dist.depth_parallel import depth_partitioned
from ..dist.mesh import active_axis, depth_slab
from ..geometry.projective import build_proj_matrices, scale_K
from ..nn.blocks import (ConvBnReLU, ConvTransposeBnReLU, cast_convs,
                         init_weights)
from ..ops.plane_sweep import plane_sweep_warp
from ..ops.rect_sweep import exact_fused_volume, rect_cost_volume
from ..ops.sweep_kernels import mvsnet_planes, sweep_warp
from ..ops.volumes import (depth_regression, photometric_confidence,
                           softmax_depth, softmin_cost_volume,
                           variance_cost_volume)
from ..utils.monitor import span
from .api import register_model, view_list

SWEEP_METHODS = ("auto", "gather", "warp", "fused", "rect")
SPAN = "wildmvs_torch.mvsnet"


def compute_in(dtype: torch.dtype, weight: torch.Tensor):
    """Context in which a network with weights like `weight` computes in
    `dtype`: autocast when the two differ (f32 parameters, bf16 compute),
    else nothing."""
    if weight.dtype == dtype:
        return contextlib.nullcontext()
    return torch.autocast(weight.device.type, dtype=dtype)


def sweep_cost_volume(ref, srcs, src_projs, ref_proj, depth_values,
                      method: str, agg: str = "variance", temp=None):
    """The aggregated cost volume [B, D, H, W, C] of an MVSNet-convention
    sweep, in the reference features' dtype.

    Args:
      ref: [B, H, W, C] reference features.
      srcs: the source views' features, each [B, h_i, w_i, C] ("fused"
        and "rect" need one size).
      src_projs, ref_proj: [B, 4, 4] projections at feature resolution.
      depth_values: [B, D] or [B, D, H, W] f32 hypotheses; the kernels take
        them detached (the sampling grid carries no gradient).
      method: "gather" | "warp" | "fused" | "rect" (a model's
        resolve_sweep).
      agg: "variance" | "softmin"; temp: softmin's temperature.
    """
    fh, fw = ref.shape[1:3]

    def bf16(f):
        return f.to(torch.bfloat16).contiguous()

    if method == "fused":
        return exact_fused_volume(
            bf16(ref), bf16(torch.stack(srcs, 1)), src_projs, ref_proj,
            depth_values.detach().contiguous(), temp, agg).to(ref.dtype)
    if method == "rect":
        return rect_cost_volume(
            [ref] + list(srcs), torch.stack([ref_proj] + list(src_projs), 1),
            depth_values.detach(), (fh, fw), agg, temp)
    if method == "warp":
        s = depth_values.detach().contiguous()
        fns = [(lambda f=f, p=p: sweep_warp(
            bf16(f), *mvsnet_planes(p, ref_proj, (fh, fw)), s))
            for f, p in zip(srcs, src_projs)]
    else:
        fns = [(lambda f=f, p=p: plane_sweep_warp(
            f, p, ref_proj, depth_values, (fh, fw)))
            for f, p in zip(srcs, src_projs)]
    if agg == "variance":
        return variance_cost_volume(ref, warp_fns=fns,
                                    num_depth=depth_values.shape[1])
    return softmin_cost_volume(ref, warp_fns=fns, temperature=temp)


class FeatureNet(nn.Module):
    """8-8 / 16-16-16 / 32-32 conv stack: [M, H, W, 3] -> [M, H/4, W/4, 32]
    channels-last (reference model.py:21-41)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = ConvBnReLU(3, 8, 3, 1, 1)
        self.conv1 = ConvBnReLU(8, 8, 3, 1, 1)
        self.conv2 = ConvBnReLU(8, 16, 5, 2, 2)
        self.conv3 = ConvBnReLU(16, 16, 3, 1, 1)
        self.conv4 = ConvBnReLU(16, 16, 3, 1, 1)
        self.conv5 = ConvBnReLU(16, 32, 5, 2, 2)
        self.conv6 = ConvBnReLU(32, 32, 3, 1, 1)
        self.feature = nn.Conv2d(32, 32, 3, 1, 1, bias=True)

    def forward(self, x):
        # a channels-last tensor seen as NCHW: cuDNN keeps that memory format
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        with compute_in(self.dtype, self.feature.weight):
            for i in range(7):
                x = getattr(self, f"conv{i}")(x)
            x = self.feature(x)
        return x.permute(0, 2, 3, 1).contiguous()


class CostRegNet(nn.Module):
    """3D U-Net regularizer, [B, D, H, W, C] -> [B, D, H, W, 1]
    (reference model.py:43-84)."""

    def __init__(self, in_channels: int = 32, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = ConvBnReLU(in_channels, 8, dim=3)
        self.conv1 = ConvBnReLU(8, 16, stride=2, dim=3)
        self.conv2 = ConvBnReLU(16, 16, dim=3)
        self.conv3 = ConvBnReLU(16, 32, stride=2, dim=3)
        self.conv4 = ConvBnReLU(32, 32, dim=3)
        self.conv5 = ConvBnReLU(32, 64, stride=2, dim=3)
        self.conv6 = ConvBnReLU(64, 64, dim=3)
        self.conv7 = ConvTransposeBnReLU(64, 32)
        self.conv9 = ConvTransposeBnReLU(32, 16)
        self.conv11 = ConvTransposeBnReLU(16, 8)
        self.prob = nn.Conv3d(8, 1, 3, 1, 1, bias=True)

    def forward(self, x):
        # [B, D, H, W, C] memory seen as NCDHW is channels_last_3d
        x = x.permute(0, 4, 1, 2, 3).to(self.dtype)
        with compute_in(self.dtype, self.prob.weight):
            c0 = self.conv0(x)
            c2 = self.conv2(self.conv1(c0))
            c4 = self.conv4(self.conv3(c2))
            x = self.conv6(self.conv5(c4))
            x = c4 + self.conv7(x)
            x = c2 + self.conv9(x)
            x = c0 + self.conv11(x)
            x = self.prob(x)
        return x.permute(0, 2, 3, 4, 1)


@register_model("mvsnet")
class MVSNet(nn.Module):
    """MVSNet under the uniform model contract (models/api.py); train mode
    (`model.train()`) runs the training forward.

    Args:
      aggregation: "variance" | "softmin", optionally prefixed "norm" (unit
        L2-normalized features).
      num_depth: number of depth hypotheses.
      sweep_method: see the module docstring.
      dtype: torch.float32 or torch.bfloat16 compute for the networks.
      param_dtype: dtype of the convolution weights (default `dtype`).
      batched_bn: featurize all views in one call in train mode too
        (train-mode BatchNorm then normalizes across views; the JAX
        package's option of that name).
      hyp_axis: the mesh axis to shard the hypotheses over (module
        docstring), or None.
      seed: seed of the random initial weights.
    """

    def __init__(self, aggregation: str = "variance", num_depth: int = 192,
                 sweep_method: str = "auto", dtype=torch.float32,
                 param_dtype=None, batched_bn: bool = False,
                 hyp_axis: str | None = None, seed: int = 0):
        super().__init__()
        agg = aggregation.removeprefix("norm").lstrip("-_") or aggregation
        if agg not in ("variance", "softmin"):
            raise NotImplementedError(f"aggregation: {aggregation}")
        if sweep_method not in SWEEP_METHODS:
            raise ValueError(f"sweep_method {sweep_method!r} not in "
                             f"{SWEEP_METHODS}")
        self.aggregation = aggregation
        self.agg = agg
        self.num_depth = num_depth
        self.sweep_method = sweep_method
        self.batched_bn = batched_bn
        self.hyp_axis = hyp_axis
        self.feature = FeatureNet(dtype)
        self.cost_regularization = CostRegNet(dtype=dtype)
        if agg == "softmin":
            self.temp = nn.Parameter(torch.ones(1))
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

    def forward(self, imgs, K, R, t, depth_min, depth_max,
                reference_frame: int = 0):
        views, ragged = view_list(imgs)
        n = len(views)
        b = views[0].shape[0]
        for v in views:
            vh, vw = v.shape[1:3]
            if vh % 32 or vw % 32:
                raise ValueError(
                    f"MVSNet input images must be /32 multiples (the 3D "
                    f"UNet's three stride-2 levels at 1/4 feature res), got "
                    f"{vh}x{vw}")

        # projections at 1/4 feature resolution, f32
        proj = build_proj_matrices(scale_K(K.float(), 0.25), R.float(),
                                   t.float())                 # [B, N, 4, 4]
        steps = torch.arange(self.num_depth, dtype=torch.float32,
                             device=proj.device)
        interval = (depth_max - depth_min).float() / (self.num_depth - 1)
        depth_values = (depth_min.float()[..., None]
                        + interval[..., None] * steps)       # [B, N, D]

        with span(f"{SPAN}.features"):
            if ragged or (self.training and not self.batched_bn):
                # per-view calls: train-mode BatchNorm statistics per view,
                # running statistics updated once per view in view order
                feats_l = [self.feature(v) for v in views]
            else:
                stacked = (imgs if torch.is_tensor(imgs)
                           else torch.stack(views, 1))
                h, w = stacked.shape[2:4]
                feats = self.feature(stacked.reshape(b * n, h, w, 3))
                feats = feats.reshape((b, n) + feats.shape[1:])
                feats_l = [feats[:, i] for i in range(n)]
            if self.aggregation.startswith("norm"):
                feats_l = [f / torch.linalg.vector_norm(
                    f, dim=-1, keepdim=True).clamp_min(1e-12)
                    for f in feats_l]

        src_idx = [i for i in range(n) if i != reference_frame]
        ref_feature = feats_l[reference_frame]
        method = self.resolve_sweep(ref_feature.dtype, ref_feature.device,
                                    ragged)
        ref_depths = depth_values[:, reference_frame].contiguous()  # [B, D]
        hyp = active_axis(self.hyp_axis)
        slab = depth_slab(self.num_depth, hyp)
        sweep_depths = ref_depths
        if slab is not None:
            sweep_depths = ref_depths[:, slab.lo:slab.hi]
            method = "fused" if method == "rect" else method
        with span(f"{SPAN}.sweep"):
            cost_volume = sweep_cost_volume(
                ref_feature, [feats_l[i] for i in src_idx],
                [proj[:, i] for i in src_idx], proj[:, reference_frame],
                sweep_depths, method, self.agg,
                self.temp if self.agg == "softmin" else None)
        with depth_partitioned(self.cost_regularization, hyp,
                               self.num_depth):
            with span(f"{SPAN}.regularize"):
                cost_reg = self.cost_regularization(cost_volume)[..., 0]
        with span(f"{SPAN}.regress"):
            # [B, D, H, W]
            prob_volume = softmax_depth(cost_reg.float(), slab)
            depth = depth_regression(prob_volume, ref_depths, slab)
            confidence = photometric_confidence(prob_volume.detach(), slab)
        return {
            "depth": depth,
            "depth_est_list": [depth],
            "depth_pair_list": [],
            "photometric_confidence": confidence,
        }
