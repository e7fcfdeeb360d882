"""Plain MVSNet (Yao et al., ECCV 2018, arXiv:1804.02505, sections 3-4),
float32, in the published PyTorch code's layout and key names.

  FeatureNet: eight 2D convs (3 -> 8 -> 16 -> 32, two stride-2) -> 1/4
    resolution, 32 channels; one call per view, as published
  cost volume: homography warping of each source over the reference
    view's D fronto-parallel depths, variance aggregation
  CostRegNet: 3D U-Net 8-16-32-64 with additive skips, 8 -> 1 probability
    conv
  softmax over depth -> expected depth; photometric confidence: the sum
    of the four probabilities around the expected index (truncated)

The supervised loss is the masked L1 in units of (max - min) / 128 at the
depth map's 1/4 resolution.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..work import (Work, fused_work, live_mask, warp_backward_work,
                    warp_work)
from .common import (ConvBnReLU, deconv_bn_relu, masked_l1_interval,
                     mvsnet_coords, mvsnet_warp, projection,
                     scale_intrinsics)


def regress(cost, depth, dtype=torch.float32):
    """Score volume [B, D, H, W] and hypotheses [B, D] -> (expected depth,
    confidence) [B, H, W], computed in `dtype` (f32 as the configuration
    states; the control takes bf16). The confidence is taken without
    gradient."""
    cost, depth = cost.to(dtype), depth.to(dtype)
    prob = F.softmax(cost, dim=1)
    out_depth = (prob * depth[:, :, None, None]).sum(1)
    with torch.no_grad():
        d = prob.shape[1]
        pad = F.pad(prob, (0, 0, 0, 0, 1, 2))
        sum4 = (pad[:, 0:d] + pad[:, 1:d + 1] + pad[:, 2:d + 2]
                + pad[:, 3:d + 3])
        index = (prob * torch.arange(d, dtype=dtype,
                                     device=prob.device)[:, None, None]
                 ).sum(1).long().clamp(0, d - 1)
        conf = torch.gather(sum4, 1, index[:, None])[:, 0]
    return out_depth, conf


def depth_values(num_depth, depth_min, depth_max):
    """The reference view's D depths [B, D], evenly from min to max."""
    steps = torch.arange(num_depth, dtype=torch.float32,
                         device=depth_min.device)
    interval = (depth_max[:, 0] - depth_min[:, 0]) / (num_depth - 1)
    return depth_min[:, 0, None] + interval[:, None] * steps


class FeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU(3, 8, 3, 1, 1)
        self.conv1 = ConvBnReLU(8, 8, 3, 1, 1)
        self.conv2 = ConvBnReLU(8, 16, 5, 2, 2)
        self.conv3 = ConvBnReLU(16, 16, 3, 1, 1)
        self.conv4 = ConvBnReLU(16, 16, 3, 1, 1)
        self.conv5 = ConvBnReLU(16, 32, 5, 2, 2)
        self.conv6 = ConvBnReLU(32, 32, 3, 1, 1)
        self.feature = nn.Conv2d(32, 32, 3, 1, 1)

    def forward(self, x):
        x = self.conv1(self.conv0(x))
        x = self.conv4(self.conv3(self.conv2(x)))
        return self.feature(self.conv6(self.conv5(x)))


class CostRegNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU(32, 8, dim=3)
        self.conv1 = ConvBnReLU(8, 16, stride=2, dim=3)
        self.conv2 = ConvBnReLU(16, 16, dim=3)
        self.conv3 = ConvBnReLU(16, 32, stride=2, dim=3)
        self.conv4 = ConvBnReLU(32, 32, dim=3)
        self.conv5 = ConvBnReLU(32, 64, stride=2, dim=3)
        self.conv6 = ConvBnReLU(64, 64, dim=3)
        self.conv7 = deconv_bn_relu(64, 32)
        self.conv9 = deconv_bn_relu(32, 16)
        self.conv11 = deconv_bn_relu(16, 8)
        self.prob = nn.Conv3d(8, 1, 3, 1, 1)

    def forward(self, x):
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        x = self.conv6(self.conv5(c4))
        x = c4 + self.conv7(x)
        x = c2 + self.conv9(x)
        x = c0 + self.conv11(x)
        return self.prob(x)


class MVSNet(nn.Module):
    """forward(imgs [B, N, H, W, 3] in [0, 1], K, R [B, N, 3, 3],
    t [B, N, 3, 1], depth_min, depth_max [B, N]) -> {"depth",
    "confidence"} [B, H/4, W/4] and the regularized "score" [B, D, H/4,
    W/4]; view 0 is the reference. `regress_dtype` is the precision of the
    softmax and regression (`regress`)."""

    def __init__(self, num_depth: int = 192):
        super().__init__()
        self.num_depth = num_depth
        self.regress_dtype = torch.float32
        self.feature = FeatureNet()
        self.cost_regularization = CostRegNet()

    def forward(self, imgs, K, R, t, depth_min, depth_max):
        n = imgs.shape[1]
        feats = [self.feature(imgs[:, i].permute(0, 3, 1, 2))
                 for i in range(n)]
        proj = projection(scale_intrinsics(K, 0.25), R, t)      # [B, N, 4, 4]
        depth = depth_values(self.num_depth, depth_min, depth_max)
        hw = tuple(feats[0].shape[2:])
        ref = feats[0][:, :, None]                       # [B, C, 1, H, W]
        vol_sum = ref.expand(-1, -1, self.num_depth, -1, -1).clone()
        vol_sq = vol_sum ** 2
        for i in range(1, n):
            warped = mvsnet_warp(feats[i], proj[:, i], proj[:, 0], depth, hw)
            vol_sum = vol_sum + warped
            vol_sq = vol_sq + warped ** 2
            del warped
        variance = vol_sq / n - (vol_sum / n) ** 2
        del vol_sum, vol_sq
        cost = self.cost_regularization(variance)[:, 0]       # [B, D, H, W]
        out_depth, conf = regress(cost, depth, self.regress_dtype)
        return {"depth": out_depth, "confidence": conf, "score": cost}


def loss(model: MVSNet, sample: dict):
    """The supervised training loss of one sample (dict of f32 tensors:
    imgs, K, R, t, depth_min, depth_max, depth and mask at the depth map's
    resolution), and the forward's depth [B, H/4, W/4]."""
    out = model(sample["imgs"], sample["K"], sample["R"], sample["t"],
                sample["depth_min"], sample["depth_max"])
    interval = (sample["depth_max"] - sample["depth_min"])[:, 0] / 128.0
    return masked_l1_interval(out["depth"], sample["depth"], sample["mask"],
                              interval), out["depth"]


# ---------------------------------------------------------------------------
# what the benchmark asks of an architecture's reference
# ---------------------------------------------------------------------------

#: channels of the features the sweep warps
FEATURES = 32


def build(cfg: dict) -> MVSNet:
    return MVSNet(cfg["num_depth"])


def intervals(cfg: dict, depth_min: float, depth_max: float) -> list:
    """The hypothesis interval of each depth map compared (one)."""
    return [(depth_max - depth_min) / (cfg["num_depth"] - 1)]


@torch.no_grad()
def serve(model: MVSNet, x: dict, centres=None) -> dict:
    """One request (batched f32 tensors) -> {"depths": [depth],
    "confidence"} numpy and "scores": [the score volume [D, h, w]] on the
    device; `centres` is unused (one stage)."""
    out = model(x["imgs"], x["K"], x["R"], x["t"], x["depth_min"],
                x["depth_max"])
    return {"depths": [out["depth"][0].float().cpu().numpy()],
            "confidence": out["confidence"][0].float().cpu().numpy(),
            "scores": [out["score"][0].float()]}


@torch.no_grad()
def regress_scores(cfg: dict, x: dict, scores: list, centres=None,
                   dtype=torch.float32) -> dict:
    """The depth and confidence that `regress` makes of a given score
    volume (scores: [[D, h, w]]), as `serve` returns them."""
    depth = depth_values(cfg["num_depth"], x["depth_min"], x["depth_max"])
    d, c = regress(scores[0].float()[None], depth, dtype)
    return {"depths": [d[0].float().cpu().numpy()],
            "confidence": c[0].float().cpu().numpy()}


@torch.no_grad()
def _live(cfg: dict, x: dict) -> tuple:
    """Live samples of each source's sweep over the reference's D depths
    at 1/4 resolution, and the (D, H, W) grid."""
    h, w = x["imgs"].shape[2] // 4, x["imgs"].shape[3] // 4
    proj = projection(scale_intrinsics(x["K"], 0.25), x["R"], x["t"])
    depth = depth_values(cfg["num_depth"], x["depth_min"], x["depth_max"])
    lives = []
    for i in range(1, x["imgs"].shape[1]):
        sx, sy = mvsnet_coords(proj[:, i], proj[:, 0], depth, (h, w))
        lives.append(int(live_mask(sx, sy, h, w).sum()))
    return lives, (cfg["num_depth"], h, w)


def serve_jobs(cfg: dict, x: dict) -> dict:
    """The sweep kernel's job of one request: every source warped and
    variance-aggregated in one pass."""
    lives, grid = _live(cfg, x)
    hw = grid[1:]
    return {"fused_cost_volume": fused_work(FEATURES, len(lives), hw, grid,
                                            sum(lives))}


def train_jobs(cfg: dict, x: dict) -> dict:
    """The jobs of one training step: each source warped, and the warp's
    transpose for each."""
    lives, grid = _live(cfg, x)
    hw = grid[1:]
    return {"sweep_warp": sum((warp_work(FEATURES, hw, grid, n)
                               for n in lives), Work(0, 0)),
            "sweep_warp_backward": sum(
                (warp_backward_work(FEATURES, hw, grid, n) for n in lives),
                Work(0, 0))}
