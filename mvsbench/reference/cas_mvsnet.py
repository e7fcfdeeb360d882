"""Plain CasMVSNet (Gu, Fan, Zhu, Dai, Tan and Tan, CVPR 2020,
arXiv:1912.06378), eval forward, float32, after the published code
(cascade-stereo's CasMVSNet/models/cas_mvsnet.py and module.py) at its DTU
test settings.

  FeatureNet, arch_mode "fpn", 8 base channels: conv0 = two 3x3
    conv-BN-ReLU (3 -> 8 -> 8), conv1 = a 5x5 stride-2 one and two 3x3
    (8 -> 16), conv2 likewise (16 -> 32); out1 (1x1, 32 -> 32, no bias) of
    conv2 is stage 1's feature; the nearest 2x upsample of conv2 plus
    inner1 (1x1, 16 -> 32, bias) of conv1 gives out2 (3x3, 32 -> 16, no
    bias), stage 2's; its 2x upsample plus inner2 (1x1, 8 -> 32) of conv0
    gives out3 (3x3, 32 -> 8, no bias), stage 3's; one call per view
  depth_interval = (depth_values[-1] - depth_values[0]) / 192
  stage 1: 48 fronto-parallel planes from depth_min to depth_max
  stage k = 2, 3 (ndepth D = 32, 8; depth_inter_r r = 2, 1): the coarser
    depth (detached) upsampled bilinearly to the image (align_corners
    False), D samples from cur - D/2 r itv to cur + D/2 r itv per pixel
    (get_cur_depth_range_samples, no clamp), resized trilinearly to the
    stage's resolution (align_corners False)
  at each stage: each source's features warped onto the samples (MVSNet's
    homography warp, bilinear grid_sample, zero padding, align_corners
    True), the variance over the views, the stage's own CostRegNet
    (MVSNet's 3D U-Net 8-16-32-64 over 32, 16 or 8 input channels, a 3D
    conv to one channel without bias), softmax over depth and the expected
    depth; the photometric confidence (the four probabilities around the
    expected index) of the last stage

Departures from the published code: the warp sends a point behind the
source camera to pixel -10 and clamps the normalised grid to [-10, 10]
(the published one divides by z; no point of the benchmark's rigs is
behind a camera); the key names are those of the measured program's state
dict, which the benchmark loads into both: the transposed convs are
Sequentials (`<block>.0.weight`, `<block>.1.*`), not Deconv3d modules.
Everything is f32 with TF32 off, nothing is fused or kept in another
layout.

`forward(..., centres=(d_1, d_2))` builds stages 2 and 3 around the given
coarser depths instead of its own: the benchmark follows the served
program's cascade stage by stage with it. The forward has no Python branch
on a tensor's value, so it runs on the meta device (the flops of a request
are counted there).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..work import Launches, fused_work, live_mask
from .common import (ConvBnReLU, deconv_bn_relu, mvsnet_coords, projection,
                     scale_intrinsics)
# the same sweep, soft-argmin and confidence as CVP-MVSNet's reference
from .cvp_mvsnet import confidence, regress, variance_volume

#: the DTU test set's depth values, over which stage 1's range is divided
BASE_DEPTHS = 192
#: each stage's resolution over the image's
SCALES = (4, 2, 1)
BASE = 8
#: channels of each stage's features
FEATURES = (4 * BASE, 2 * BASE, BASE)


class FeatureNet(nn.Module):
    """[M, 3, H, W] -> [stage 1 [M, 32, H/4, W/4], stage 2 [M, 16, H/2,
    W/2], stage 3 [M, 8, H, W]]."""

    def __init__(self):
        super().__init__()
        b = BASE
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

    def forward(self, x):
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        intra = F.interpolate(conv2, scale_factor=2, mode="nearest") \
            + self.inner1(conv1)
        stage2 = self.out2(intra)
        intra = F.interpolate(intra, scale_factor=2, mode="nearest") \
            + self.inner2(conv0)
        return [self.out1(conv2), stage2, self.out3(intra)]


class CostRegNet(nn.Module):
    """A stage's regularizer: variance [B, C, D, H, W] -> [B, 1, D, H, W]."""

    def __init__(self, in_channels):
        super().__init__()
        b = BASE
        self.conv0 = ConvBnReLU(in_channels, b, dim=3)
        self.conv1 = ConvBnReLU(b, 2 * b, stride=2, dim=3)
        self.conv2 = ConvBnReLU(2 * b, 2 * b, dim=3)
        self.conv3 = ConvBnReLU(2 * b, 4 * b, stride=2, dim=3)
        self.conv4 = ConvBnReLU(4 * b, 4 * b, dim=3)
        self.conv5 = ConvBnReLU(4 * b, 8 * b, stride=2, dim=3)
        self.conv6 = ConvBnReLU(8 * b, 8 * b, dim=3)
        self.conv7 = deconv_bn_relu(8 * b, 4 * b)
        self.conv9 = deconv_bn_relu(4 * b, 2 * b)
        self.conv11 = deconv_bn_relu(2 * b, b)
        self.prob = nn.Conv3d(b, 1, 3, stride=1, padding=1, bias=False)

    def forward(self, x):
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return self.prob(x)


# ---------------------------------------------------------------------------
# hypotheses
# ---------------------------------------------------------------------------

class Cascade:
    """The geometry of one request: each stage's projections and
    hypotheses. x: batched f32 tensors (imgs [B, N, H, W, 3], K, R, t,
    depth_min, depth_max); ndepths and ratios a stage each."""

    def __init__(self, x: dict, ndepths, ratios):
        self.K, self.R, self.t = x["K"], x["R"], x["t"]
        self.dmin = x["depth_min"][:, 0]
        self.dmax = x["depth_max"][:, 0]
        self.hw = tuple(x["imgs"].shape[2:4])
        self.ndepths, self.ratios = list(ndepths), list(ratios)
        self.interval = (self.dmax - self.dmin) / BASE_DEPTHS

    def stage_hw(self, k: int) -> tuple:
        return (self.hw[0] // SCALES[k], self.hw[1] // SCALES[k])

    def projs(self, k: int) -> torch.Tensor:
        return projection(scale_intrinsics(self.K, 1.0 / SCALES[k]),
                          self.R, self.t)

    def planes(self) -> torch.Tensor:
        """Stage 1's depths [B, D]."""
        d = self.ndepths[0]
        steps = torch.arange(d, dtype=torch.float32, device=self.dmin.device)
        return self.dmin[:, None] + steps * ((self.dmax - self.dmin)
                                             / (d - 1))[:, None]

    def hypotheses(self, k: int, prev=None) -> torch.Tensor:
        """Stage k's (0 the coarsest) samples [B, D, h, w]; after stage 1
        around the coarser depth prev [B, h', w']."""
        h, w = self.stage_hw(k)
        d = self.ndepths[k]
        if k == 0:
            return self.planes()[:, :, None, None].expand(-1, -1, h, w)
        cur = F.interpolate(prev.detach().float()[:, None], size=self.hw,
                            mode="bilinear", align_corners=False)[:, 0]
        itv = self.ratios[k] * self.interval[:, None, None]
        lo = cur - d / 2 * itv
        new_interval = (cur + d / 2 * itv - lo) / (d - 1)
        steps = torch.arange(d, dtype=torch.float32,
                             device=cur.device).reshape(1, -1, 1, 1)
        samples = lo[:, None] + steps * new_interval[:, None]
        return F.interpolate(samples[:, None], size=(d, h, w),
                             mode="trilinear", align_corners=False)[:, 0]


class CasMVSNet(nn.Module):
    """forward(imgs [B, N, H, W, 3] in [0, 1], K, R [B, N, 3, 3], t [B, N,
    3, 1], depth_min, depth_max [B, N], centres=None) -> {"depth" [B, H, W]
    (stage 3's), "stage_depths" and "scores" (logits [B, D, h, w]) of each
    stage, coarsest first, "confidence" [B, H, W]}; view 0 is the
    reference. `regress_dtype` is the precision of the softmax and
    regression."""

    def __init__(self, ndepths=(48, 32, 8), ratios=(4.0, 2.0, 1.0)):
        super().__init__()
        self.ndepths, self.ratios = tuple(ndepths), tuple(ratios)
        self.regress_dtype = torch.float32
        self.feature = FeatureNet()
        self.cost_regularization = nn.ModuleList(
            CostRegNet(c) for c in FEATURES)

    def forward(self, imgs, K, R, t, depth_min, depth_max, centres=None):
        n = imgs.shape[1]
        x = {"imgs": imgs, "K": K, "R": R, "t": t, "depth_min": depth_min,
             "depth_max": depth_max}
        geo = Cascade(x, self.ndepths, self.ratios)
        per_view = [self.feature(imgs[:, i].permute(0, 3, 1, 2))
                    for i in range(n)]
        depths, scores = [], []
        for k, reg in enumerate(self.cost_regularization):
            prev = None
            if k:
                prev = depths[-1] if centres is None else centres[k - 1]
            hyp = geo.hypotheses(k, prev)
            feats = torch.stack([f[k] for f in per_view], 1)
            score = reg(variance_volume(feats, geo.projs(k), hyp))[:, 0]
            prob, depth = regress(score, hyp, self.regress_dtype)
            depths.append(depth)
            scores.append(score)
        return {"depth": depths[-1], "stage_depths": depths,
                "scores": scores, "confidence": confidence(prob)}


# ---------------------------------------------------------------------------
# what the benchmark asks of an architecture's reference
# ---------------------------------------------------------------------------

def build(cfg: dict) -> CasMVSNet:
    return CasMVSNet(cfg["ndepths"], cfg["depth_interval_ratios"])


def intervals(cfg: dict, depth_min: float, depth_max: float) -> list:
    """Each stage's hypothesis spacing, coarsest first: stage 1's planes
    (max - min) / (D - 1) apart, each later stage's D r itv / (D - 1)."""
    nds, ratios = cfg["ndepths"], cfg["depth_interval_ratios"]
    itv = (depth_max - depth_min) / BASE_DEPTHS
    return [(depth_max - depth_min) / (nds[0] - 1)] + [
        d * r * itv / (d - 1) for d, r in zip(nds[1:], ratios[1:])]


def _tensor_centres(centres, device):
    return (None if centres is None else
            [torch.as_tensor(c, device=device)[None] for c in centres])


@torch.no_grad()
def serve(model: CasMVSNet, x: dict, centres=None) -> dict:
    """One request (batched f32 tensors) -> {"depths": every stage's
    depth [h, w], coarsest first, "confidence" [H, W]} numpy and "scores":
    every stage's logits [D, h, w] on the device; `centres` (the program's
    depths of stages 1 and 2, numpy) centre stages 2 and 3 as the
    program's cascade did."""
    out = model(x["imgs"], x["K"], x["R"], x["t"], x["depth_min"],
                x["depth_max"],
                centres=_tensor_centres(centres, x["imgs"].device))
    return {"depths": [d[0].float().cpu().numpy()
                       for d in out["stage_depths"]],
            "confidence": out["confidence"][0].float().cpu().numpy(),
            "scores": [s[0].float() for s in out["scores"]]}


@torch.no_grad()
def regress_scores(cfg: dict, x: dict, scores: list, centres=None,
                   dtype=torch.float32) -> dict:
    """The depths and confidence that `regress` makes of given logits
    (scores: [D, h, w] a stage, coarsest first), each later stage around
    `centres` (numpy, as `serve` takes them) or, without them, around the
    depth this regression made of the stage before; as `serve` returns
    them."""
    dev = scores[0].device
    x = {k: v.to(dev) for k, v in x.items()}
    geo = Cascade(x, cfg["ndepths"], cfg["depth_interval_ratios"])
    centres = _tensor_centres(centres, dev)
    depths = []
    for k, score in enumerate(scores):
        prev = None
        if k:
            prev = depths[-1] if centres is None else centres[k - 1]
        prob, depth = regress(score.float()[None], geo.hypotheses(k, prev),
                              dtype)
        depths.append(depth.float())
    return {"depths": [d[0].cpu().numpy() for d in depths],
            "confidence": confidence(prob)[0].float().cpu().numpy()}


def stage_depths(cfg: dict, x: dict, scores: list) -> list:
    """The program's depth of every stage from its own logits: each
    stage's f32 regression over the samples built from the stage before's,
    regressed alike (numpy, coarsest first)."""
    return regress_scores(cfg, x, scores)["depths"]


@torch.no_grad()
def serve_jobs(cfg: dict, x: dict) -> dict:
    """The fused kernel's jobs of one request, one launch a stage, each
    source warped and variance-aggregated. Stage 1's live samples are
    counted on its planes. A later stage's samples follow the program's
    depths, so its live samples are counted from below: a pixel counts
    with all its D samples where it is live in every source at both ends
    of the widest range its samples can take (stage 1's planes widened by
    D r itv / 2 at each later stage), since the samples of one pixel lie
    on a segment of its epipolar line between those ends."""
    nds, ratios = cfg["ndepths"], cfg["depth_interval_ratios"]
    n = x["imgs"].shape[1]
    geo = Cascade(x, nds, ratios)
    jobs, lo, hi = [], geo.dmin, geo.dmax
    for k in range(len(SCALES)):
        hw = geo.stage_hw(k)
        projs = geo.projs(k)
        if k == 0:
            depth = geo.planes()
        else:
            half = nds[k] / 2 * ratios[k] * geo.interval
            lo, hi = lo - half, hi + half
            depth = torch.stack([lo, hi], 1)
        live = 0
        for i in range(1, n):
            sx, sy = mvsnet_coords(projs[:, i], projs[:, 0], depth, hw)
            ok = live_mask(sx, sy, *hw)
            live += int(ok.sum() if k == 0 else ok.all(1).sum() * nds[k])
        jobs.append(fused_work(FEATURES[k], n - 1, hw, (nds[k],) + hw, live))
    return {"fused_cost_volume": Launches(jobs)}
