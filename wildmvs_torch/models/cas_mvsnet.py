"""CasMVSNet: a cascade of three cost volumes over FPN features.

Gu, Fan, Zhu, Dai, Tan and Tan, "Cascade Cost Volume for High-Resolution
Multi-View Stereo and Stereo Matching", CVPR 2020 (arXiv:1912.06378); the
published code is cascade-stereo's CasMVSNet/models/cas_mvsnet.py and
module.py, at its DTU test settings (ndepths 48, 32, 8; depth_inter_r
4, 2, 1; cr_base_chs 8, 8, 8; the FPN feature net with 8 base channels).
Eval forward:
  FPN features (CBR = conv without bias, BatchNorm, ReLU):
    conv0 = CBR(3 -> 8), CBR(8 -> 8)                        full resolution
    conv1 = CBR(8 -> 16, 5x5, stride 2), CBR(16), CBR(16)   1/2
    conv2 = CBR(16 -> 32, 5x5, stride 2), CBR(32), CBR(32)  1/4
    f1 = out1(conv2)                     1x1 conv 32 -> 32, no bias
    i = nearest2x(conv2) + inner1(conv1) (1x1 conv 16 -> 32, bias)
    f2 = out2(i)                         3x3 conv 32 -> 16, no bias
    i = nearest2x(i) + inner2(conv0)     (1x1 conv 8 -> 32, bias)
    f3 = out3(i)                         3x3 conv 32 -> 8, no bias
  stage k = 1, 2, 3 on f_k at 1/4, 1/2 and 1 of the image, the intrinsics
  scaled to match:
    hypotheses: stage 1 linspace(d_min, d_max) over 48 fronto-parallel
      planes; stage k >= 2 (D = 32, 8; r = 2, 1), with
      delta = (d_max - d_min) / 192 (cascade-stereo's depth_interval) and
      d^ the previous stage's depth, detached and bilinearly upsampled to
      the image (align_corners False):
        s_j = d^ - (D / 2) r delta + j (D r delta) / (D - 1), no clamp,
      resized trilinearly (align_corners False) to the stage's resolution
    volume: the variance over the reference and the sources, each warped
      by MVSNet's homography convention (models/mvsnet.sweep_cost_volume)
    regularizer: the stage's own CostRegNet (models/mvsnet.py; 32-, 16-
      and 8-channel input, score head without bias)
    regression: softmax over depth, depth = sum p s
  photometric confidence of stage 3 (ops/volumes.photometric_confidence)
  "depth" is stage 3's, at the image's resolution; "depth_est_list" holds
  every stage's, the finest first.

Departures from cascade-stereo, none of which changes the function:
  * the trilinear resize of a stage's samples is taken of d^ alone: the
    samples are d^ plus a per-stage constant, and the resize keeps D, so
    resizing d^ bilinearly and adding the offsets gives the same volume
    (up to rounding) without building it at the image's resolution first;
  * stage 1's planes go to the sweep as [B, D] depths, not expanded to
    every pixel (the same hypotheses);
  * only stage 3's photometric confidence is computed (cascade-stereo's
    test script keeps only the last stage's);
  * features are channels-last, and every view is featurized in one
    batched call (the views must share one size).
Loading a cascade-stereo checkpoint by name is not supported: its
transposed-conv blocks are Deconv3d modules (`<block>.conv.weight`,
`<block>.bn.*`), where CostRegNet's are Sequentials (`<block>.0.weight`,
`<block>.1.*`), and there is no key mapping yet.

Cost-volume backends (`sweep_method`), per stage: "gather" (the exact f32
gather), "fused" (one `fused_cost_volume` launch), "auto" ("fused" for
bf16 features on the card, else "gather"). Training (the published loss
weighs the stages 0.5, 1, 2) is not ported.

Precision: `dtype` / `param_dtype` as in models/mvsnet.py; geometry,
hypotheses, softmax and regression are f32.

Trace spans (utils/monitor.span, recorded only under a profiler):
`wildmvs_torch.cas_mvsnet.features` and, per stage k (1 the coarsest: the
call order), `wildmvs_torch.cas_mvsnet.stage<k>.hypotheses` (the stage's
projections and hypotheses), `.sweep` (the cost volume), `.regularize`
(the stage's CostRegNet call and nothing else) and `.regress` (softmax and
regression; the confidence at stage 3). No counter: the forward has no
data-dependent branch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.projective import build_proj_matrices, scale_K
from ..nn.blocks import ConvBnReLU, cast_convs, init_weights
from ..ops.volumes import (depth_regression, photometric_confidence,
                           softmax_depth)
from ..utils.monitor import span
from .api import register_model, view_list
from .mvsnet import CostRegNet, compute_in, sweep_cost_volume

SPAN = "wildmvs_torch.cas_mvsnet"
SWEEP_METHODS = ("auto", "gather", "fused")
#: hypotheses of each stage, the coarsest first (cascade-stereo's ndepths)
NDEPTHS = (48, 32, 8)
#: each stage's interval over delta (depth_inter_r; stage 1's is unused:
#: its planes span the whole range)
INTERVAL_RATIOS = (4.0, 2.0, 1.0)
#: stage 1's range over this many intervals is delta (cascade-stereo's
#: `depth_interval`, the DTU test set's 192 depth values)
BASE_DEPTHS = 192
#: each stage's features and depth map over the image's resolution
STAGE_SCALES = (0.25, 0.5, 1.0)
#: the FPN's base channels (cascade-stereo's FeatureNet(base_channels=8))
BASE_CHANNELS = 8


class FPNFeatureNet(nn.Module):
    """[M, H, W, 3] -> [f1 [M, H/4, W/4, 32], f2 [M, H/2, W/2, 16],
    f3 [M, H, W, 8]] channels-last (cascade-stereo module.py FeatureNet,
    arch_mode "fpn", num_stage 3)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        b = BASE_CHANNELS
        self.conv0 = nn.Sequential(ConvBnReLU(3, b), ConvBnReLU(b, b))
        self.conv1 = nn.Sequential(ConvBnReLU(b, 2 * b, 5, 2, 2),
                                   ConvBnReLU(2 * b, 2 * b),
                                   ConvBnReLU(2 * b, 2 * b))
        self.conv2 = nn.Sequential(ConvBnReLU(2 * b, 4 * b, 5, 2, 2),
                                   ConvBnReLU(4 * b, 4 * b),
                                   ConvBnReLU(4 * b, 4 * b))
        self.out1 = nn.Conv2d(4 * b, 4 * b, 1, bias=False)
        self.inner1 = nn.Conv2d(2 * b, 4 * b, 1, bias=True)
        self.inner2 = nn.Conv2d(b, 4 * b, 1, bias=True)
        self.out2 = nn.Conv2d(4 * b, 2 * b, 3, padding=1, bias=False)
        self.out3 = nn.Conv2d(4 * b, b, 3, padding=1, bias=False)
        #: the channels of f1, f2, f3
        self.out_channels = (4 * b, 2 * b, b)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        with compute_in(self.dtype, self.out1.weight):
            c0 = self.conv0(x)
            c1 = self.conv1(c0)
            c2 = self.conv2(c1)
            f1 = self.out1(c2)
            inner = F.interpolate(c2, scale_factor=2, mode="nearest") \
                + self.inner1(c1)
            f2 = self.out2(inner)
            inner = F.interpolate(inner, scale_factor=2, mode="nearest") \
                + self.inner2(c0)
            f3 = self.out3(inner)
        return [f.permute(0, 2, 3, 1).contiguous() for f in (f1, f2, f3)]


def stage_hypotheses(prev: torch.Tensor, image_hw: tuple, stage_hw: tuple,
                     ndepth: int, ratio: float,
                     delta: torch.Tensor) -> torch.Tensor:
    """The per-pixel hypotheses [B, D, h, w] f32 of a stage after the
    first: the previous stage's depth prev [B, h', w'] (detached) upsampled
    bilinearly to the image size `image_hw`, resized to `stage_hw` (the
    trilinear resize of the samples, taken of their centre), then
    ndepth samples r delta D / (D - 1) apart, centred on it; delta [B]."""
    up = F.interpolate(prev.detach().float()[:, None], size=tuple(image_hw),
                       mode="bilinear", align_corners=False)
    if tuple(stage_hw) != tuple(image_hw):
        up = F.interpolate(up, size=tuple(stage_hw), mode="bilinear",
                           align_corners=False)
    j = torch.arange(ndepth, dtype=torch.float32, device=up.device)
    offs = (j * (ndepth / (ndepth - 1)) - ndepth / 2)[None] \
        * (ratio * delta.float())[:, None]                       # [B, D]
    return up + offs[..., None, None]


@register_model("cas_mvsnet")
class CasMVSNet(nn.Module):
    """CasMVSNet under the uniform model contract (models/api.py), eval
    forward, views of one size.

    Args:
      sweep_method: see the module docstring.
      dtype, param_dtype, seed: as models/mvsnet.py.
    """

    def __init__(self, sweep_method: str = "auto", dtype=torch.float32,
                 param_dtype=None, seed: int = 0):
        super().__init__()
        if sweep_method not in SWEEP_METHODS:
            raise ValueError(f"sweep_method {sweep_method!r} not in "
                             f"{SWEEP_METHODS}")
        self.sweep_method = sweep_method
        self.feature = FPNFeatureNet(dtype)
        self.cost_regularization = nn.ModuleList(
            CostRegNet(c, dtype, prob_bias=False)
            for c in self.feature.out_channels)
        init_weights(self, torch.Generator().manual_seed(seed))
        cast_convs(self, dtype if param_dtype is None else param_dtype)

    def resolve_sweep(self, feats_dtype: torch.dtype,
                      device: torch.device) -> str:
        """The cost-volume backend this forward takes."""
        if self.sweep_method != "auto":
            return self.sweep_method
        return ("fused" if device.type == "cuda"
                and feats_dtype == torch.bfloat16 else "gather")

    def forward(self, imgs, K, R, t, depth_min, depth_max,
                reference_frame: int = 0):
        views, ragged = view_list(imgs)
        if ragged:
            raise ValueError("CasMVSNet takes views of one size")
        n = len(views)
        b, h, w = views[0].shape[:3]
        if h % 32 or w % 32:
            raise ValueError(
                f"CasMVSNet input images must be /32 multiples (stage 1's "
                f"3D UNet: three stride-2 levels at 1/4 resolution), got "
                f"{h}x{w}")
        ref = reference_frame
        order = [ref] + [i for i in range(n) if i != ref]

        # per stage, every view's features, reference first
        with span(f"{SPAN}.features"):
            stacked = imgs if torch.is_tensor(imgs) else torch.stack(views, 1)
            feats = []
            for f in self.feature(stacked.reshape(b * n, h, w, 3)):
                f = f.reshape((b, n) + f.shape[1:])
                feats.append([f[:, i] for i in order])

        Ko, Ro, to = (a[:, order].float() for a in (K, R, t))
        dmin = depth_min[:, ref].float()
        dmax = depth_max[:, ref].float()
        delta = (dmax - dmin) / BASE_DEPTHS
        method = self.resolve_sweep(feats[0][0].dtype, feats[0][0].device)
        depths, depth, conf = [], None, None
        for k, (scale, nd, ratio, reg, f) in enumerate(zip(
                STAGE_SCALES, NDEPTHS, INTERVAL_RATIOS,
                self.cost_regularization, feats), start=1):
            name = f"{SPAN}.stage{k}"
            with span(f"{name}.hypotheses"):
                proj = build_proj_matrices(scale_K(Ko, scale), Ro, to)
                if depth is None:
                    steps = torch.arange(nd, dtype=torch.float32,
                                         device=dmin.device)
                    hyp = dmin[:, None] + steps * ((dmax - dmin)
                                                   / (nd - 1))[:, None]
                else:
                    hyp = stage_hypotheses(depth, (h, w),
                                           tuple(f[0].shape[1:3]), nd, ratio,
                                           delta)
            with span(f"{name}.sweep"):
                cost = sweep_cost_volume(
                    f[0], f[1:], [proj[:, i] for i in range(1, n)],
                    proj[:, 0], hyp.contiguous(), method)
            with span(f"{name}.regularize"):
                logits = reg(cost)[..., 0]
            with span(f"{name}.regress"):
                prob = softmax_depth(logits.float())
                depth = depth_regression(prob, hyp)
                if k == len(NDEPTHS):
                    conf = photometric_confidence(prob.detach())
            depths.append(depth)

        return {
            "depth": depth,
            "depth_est_list": depths[::-1],              # finest first
            "depth_pair_list": [],
            "photometric_confidence": conf,
        }
