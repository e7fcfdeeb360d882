"""Plain Vis-MVSNet (Zhang et al., BMVC 2020, arXiv:2008.07928), eval
forward, float32, in the published PyTorch code's layout and key names.

  FeatExt: a stride-2 5x5 conv and a three-scale 2D UNet -> 32-channel
    features at 1/8, 1/4 and 1/2 of the input
  per stage, per source view: group-wise correlation (8 groups of 4
    channels, summed) of the reference features with the source warped by
    plane-induced homographies; `reg` (a 3D UNet) and `reg_pair` (8 -> 1)
    give the pair's depth by soft-argmin and its entropy, which `uncert_net`
    turns into an uncertainty u; the pairs' regularized volumes are fused
    with weights softmax(-u) over the pairs and scored by `reg_fuse`;
    the stage depth is the soft-argmin, its confidence the probability
    mass within +-2 hypotheses of it
  cascade: (64, 32, 16) hypotheses at interval scales (2, 1, 0.5) of
    (max - min) / 128; stage 1 sweeps from depth_min, stages 2 and 3 a
    slab centred on the bilinearly upsampled previous depth

`forward(..., centres=(d1, d2))` re-centres stages 2 and 3 on the given
stage depths instead of its own: the benchmark follows the served
program's cascade stage by stage with it (a last bit of a stage depth
moves the next stage's hypotheses).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..work import F32_FLOPS, HBM_BYTES_PER_S, Work, gwc_work
from .common import UNet, resize_bilinear, scale_intrinsics, vis_warp

DEPTH_NUMS = (64, 32, 16)
INTERVAL_SCALES = (2.0, 1.0, 0.5)
GROUPS = 8


def conv_bn_relu(cin, cout, k, stride, pad):
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, pad, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU(inplace=True))


class FeatExt(nn.Module):
    def __init__(self):
        super().__init__()
        self.init_conv = conv_bn_relu(3, 16, 5, 2, 2)
        self.unet = UNet(16, 2, 1, (32, 64, 128), "2d", 2, dim=2)
        self.final_conv_1 = nn.Conv2d(128, 32, 3, 1, 1, bias=False)
        self.final_conv_2 = nn.Conv2d(64, 32, 3, 1, 1, bias=False)
        self.final_conv_3 = nn.Conv2d(32, 32, 3, 1, 1, bias=False)

    def forward(self, x):
        f8, f4, f2 = self.unet(self.init_conv(x), multi_scale=3)
        return (self.final_conv_1(f8), self.final_conv_2(f4),
                self.final_conv_3(f2))


class Reg(nn.Module):
    def __init__(self):
        super().__init__()
        self.unet = UNet(8, 1, 0, (8, 16), "reg1", 4, dim=3)

    def forward(self, x):
        return self.unet(x)


class RegPair(nn.Module):
    def __init__(self):
        super().__init__()
        self.final_conv = nn.Conv3d(8, 1, 3, 1, 1, bias=False)

    def forward(self, x):
        return self.final_conv(x)


class RegFuse(nn.Module):
    def __init__(self):
        super().__init__()
        self.unet = UNet(8, 1, 0, (8, 16), "reg2", 4, dim=3)
        self.final_conv = nn.Conv3d(8, 1, 3, 1, 1, bias=False)

    def forward(self, x):
        return self.final_conv(self.unet(x))


class UncertNet(nn.Module):
    """Entropy [B, 1, H, W] -> uncertainty; the 1-channel input is added
    to the 8-channel features by broadcast, as published."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv_bn_relu(1, 8, 3, 1, 1)
        self.conv2 = conv_bn_relu(8, 8, 3, 1, 1)
        self.head_convs = nn.Sequential(nn.Conv2d(8, 1, 3, 1, 1, bias=False))

    def forward(self, x):
        return self.head_convs(self.conv2(self.conv1(x)) + x)


def soft_argmin(score):
    """score [B, D, H, W] -> (prob, expected index [B, H, W])."""
    prob = F.softmax(score, dim=1)
    idx = torch.arange(score.shape[1], dtype=prob.dtype,
                       device=prob.device)[:, None, None]
    return prob, (prob * idx).sum(1)


def stage_regress(score, depth_start, interval, dtype=torch.float32):
    """A stage's score volume [B, D, H, W] -> (depth, confidence) [B, H, W]
    in `dtype` (f32 as the configuration states; the control takes bf16):
    the soft-argmin over the hypotheses depth_start [B, 1, H, W] +
    interval [B] * i, and the probability mass within +-2 hypotheses of
    the expected one."""
    prob, est = soft_argmin(score.to(dtype))
    idx = torch.arange(score.shape[1], dtype=dtype,
                       device=prob.device)[:, None, None]
    prob_map = (prob * ((idx - est[:, None]).abs() <= 2)).sum(1)
    out = (est * interval.to(dtype)[:, None, None]
           + depth_start[:, 0].to(dtype))
    return out, prob_map


def stage_start(k, prev, interval, depth_min, hw):
    """Stage k's first hypothesis [B, 1, H, W]: depth_min for the first
    stage; later, a slab centred on the bilinearly upsampled previous
    depth `prev` [B, h, w]. interval: the base (max - min) / 128 [B]."""
    if k == 0:
        return depth_min[:, 0].reshape(-1, 1, 1, 1).expand(
            -1, -1, *hw)
    up = resize_bilinear(prev, hw)
    return (up - DEPTH_NUMS[k] * interval[:, None, None]
            * INTERVAL_SCALES[k] / 2.0)[:, None]


class SingleStage(nn.Module):
    def __init__(self):
        super().__init__()
        self.reg = Reg()
        self.reg_pair = RegPair()
        self.uncert_net = UncertNet()
        self.reg_fuse = RegFuse()

    def forward(self, ref, srcs, cams, depth_start, interval, depth_num,
                s_scale, regress_dtype=torch.float32):
        """ref [B, C, H, W]; srcs: [B, C, h, w] each; cams (K, R, t) with
        the reference first; depth_start [B, 1, H, W]; interval [B].
        Returns (depth [B, H, W], prob_map [B, H, W], the fused score
        volume [B, D, H, W])."""
        K, R, t = cams
        K = scale_intrinsics(K, 1.0 / s_scale)
        h, w = ref.shape[2:]
        steps = torch.arange(depth_num, dtype=torch.float32,
                             device=ref.device)[:, None, None]
        depth = depth_start + interval[:, None, None, None] * steps
        depth = depth.expand(-1, -1, h, w)                    # [B, D, H, W]
        interms, uncerts = [], []
        for i, src in enumerate(srcs, start=1):
            warped = vis_warp(src, K[:, 0], R[:, 0], t[:, 0], K[:, i],
                              R[:, i], t[:, i], depth, (h, w))
            b, c = ref.shape[:2]
            cost = (ref[:, :, None] * warped).reshape(
                b, GROUPS, c // GROUPS, depth_num, h, w).sum(2)
            del warped
            interm = self.reg(cost)
            prob, _ = soft_argmin(self.reg_pair(interm)[:, 0])
            ent = -(prob * torch.log(prob.clamp(1e-9, 1.0))).sum(1)
            uncerts.append(self.uncert_net(ent[:, None])[:, 0])
            interms.append(interm)
        u = torch.stack(uncerts)                              # [S, B, H, W]
        weight = torch.softmax(-u, dim=0)[:, :, None, None]   # [S,B,1,1,H,W]
        fused = (torch.stack(interms) * weight).sum(0)
        score = self.reg_fuse(fused)[:, 0]
        out, prob_map = stage_regress(score, depth_start, interval,
                                      regress_dtype)
        return out, prob_map, score


class VisMVSNet(nn.Module):
    """forward(imgs [B, N, H, W, 3], K, R, t, depth_min, depth_max,
    centres=None) -> {"depth" [B, H/2, W/2], "stage_depths" (1/8, 1/4,
    1/2), "confidence" [B, 3, H/2, W/2], "scores" (each stage's fused
    score volume)}; view 0 is the reference. `regress_dtype` is the
    precision of the stages' soft-argmin (`stage_regress`)."""

    def __init__(self):
        super().__init__()
        self.regress_dtype = torch.float32
        self.feat_ext = FeatExt()
        self.stage1 = SingleStage()
        self.stage2 = SingleStage()
        self.stage3 = SingleStage()

    def forward(self, imgs, K, R, t, depth_min, depth_max, centres=None):
        b, n = imgs.shape[:2]
        x = imgs.reshape((b * n,) + imgs.shape[2:]).permute(0, 3, 1, 2)
        feats = [f.reshape((b, n) + f.shape[1:]) for f in self.feat_ext(x)]
        cams = (K, R, t)
        interval = (depth_max[:, 0] - depth_min[:, 0]) / 128.0
        depths, probs, scores = [], [], []
        for k, (stage, s_scale) in enumerate(
                ((self.stage1, 8), (self.stage2, 4), (self.stage3, 2))):
            f = feats[k]
            prev = None
            if k:
                prev = depths[-1] if centres is None else centres[k - 1]
            start = stage_start(k, prev, interval, depth_min,
                                tuple(f.shape[3:]))
            d, p, s = stage(f[:, 0], [f[:, i] for i in range(1, n)], cams,
                            start, interval * INTERVAL_SCALES[k],
                            DEPTH_NUMS[k], s_scale, self.regress_dtype)
            depths.append(d)
            probs.append(p)
            scores.append(s)
        return {"depth": depths[2], "stage_depths": depths,
                "confidence": confidence(probs), "scores": scores}


def confidence(probs):
    """The three stages' confidence maps [B, h, w] at the last stage's
    resolution, [B, 3, h, w]."""
    hw = tuple(probs[2].shape[1:])
    return torch.stack([resize_bilinear(probs[0], hw),
                        resize_bilinear(probs[1], hw), probs[2]], 1)


# ---------------------------------------------------------------------------
# what the benchmark asks of an architecture's reference
# ---------------------------------------------------------------------------

#: channels of the features the sweep warps
FEATURES = 32


def build(cfg: dict) -> VisMVSNet:
    if (tuple(cfg["depth_nums"]) != DEPTH_NUMS
            or tuple(cfg["interval_scales"]) != INTERVAL_SCALES
            or cfg["groups"] != GROUPS):
        raise ValueError("the reference serves (64, 32, 16) hypotheses at "
                         "scales (2, 1, 0.5) with 8 groups")
    return VisMVSNet()


def intervals(cfg: dict, depth_min: float, depth_max: float) -> list:
    """Each stage's hypothesis interval."""
    base = (depth_max - depth_min) / 128.0
    return [base * s for s in cfg["interval_scales"]]


@torch.no_grad()
def serve(model: VisMVSNet, x: dict, centres=None) -> dict:
    """One request (batched f32 tensors) -> {"depths": the three stage
    depths, "confidence" [3, h, w]} numpy and "scores": each stage's score
    volume [D, h, w] on the device; `centres` (stage-1 and stage-2 depths
    [h, w] numpy of the program) re-centre stages 2 and 3 as the program's
    cascade did."""
    if centres is not None:
        centres = [torch.as_tensor(c, device=x["imgs"].device)[None]
                   for c in centres]
    out = model(x["imgs"], x["K"], x["R"], x["t"], x["depth_min"],
                x["depth_max"], centres=centres)
    return {"depths": [d[0].float().cpu().numpy()
                       for d in out["stage_depths"]],
            "confidence": out["confidence"][0].float().cpu().numpy(),
            "scores": [s[0].float() for s in out["scores"]]}


@torch.no_grad()
def regress_scores(cfg: dict, x: dict, scores: list, centres: list,
                   dtype=torch.float32) -> dict:
    """The stage depths and confidence that `stage_regress` makes of given
    score volumes (scores: [D, h, w] a stage), stages 2 and 3 centred on
    `centres` (the stage-1 and stage-2 depths [h, w] numpy), as `serve`
    returns them."""
    dev = scores[0].device
    dmin, dmax = x["depth_min"].to(dev), x["depth_max"].to(dev)
    interval = (dmax[:, 0] - dmin[:, 0]) / 128.0
    depths, probs = [], []
    for k, score in enumerate(scores):
        prev = (torch.as_tensor(centres[k - 1], device=dev)[None]
                if k else None)
        start = stage_start(k, prev, interval, dmin,
                            tuple(score.shape[1:]))
        d, p = stage_regress(score.float()[None], start,
                             interval * INTERVAL_SCALES[k], dtype)
        depths.append(d[0].float().cpu().numpy())
        probs.append(p.float())
    return {"depths": depths,
            "confidence": confidence(probs)[0].cpu().numpy()}


def serve_jobs(cfg: dict, x: dict) -> dict:
    """The sweep kernel's jobs of one request: each stage's pairs through
    the warp fused with the correlation. The bytes bind at every stage of
    these shapes even if every sample were live (checked here), so the
    bound does not depend on the cascade's data-dependent hypotheses."""
    h, w = x["imgs"].shape[2:4]
    pairs = x["imgs"].shape[1] - 1
    total = Work(0, 0)
    for k, (d, s) in enumerate(zip(cfg["depth_nums"], (8, 4, 2))):
        hw = (h // s, w // s)
        grid = (d,) + hw
        job = gwc_work(FEATURES, hw, grid, d * hw[0] * hw[1], k > 0,
                       cfg["groups"])
        if job.operations / F32_FLOPS > job.bytes / HBM_BYTES_PER_S:
            return {}
        total = total + Work(job.bytes * pairs, 0)
    return {"sweep_gwc": total}
