"""Plain CVP-MVSNet (Yang et al., CVPR 2020, arXiv:1912.08329), eval and
train forward, float32, in the published PyTorch code's layout and key
names (models/net.py, modules.py).

  image pyramid: nscale levels, each a bilinear halving of the one above
  FeaturePyramidNet: nine 3x3 convs with bias and LeakyReLU(0.1)
    (3 -> 64 -> 64 -> 64 -> 32 -> 32 -> 32 -> 16 -> 16 -> 16), run on every
    view at every level's full resolution -> 16-channel features
  coarsest level: a fronto-parallel sweep of 96 hypotheses at eval (48 in
    train mode), interval (max - min) / D, variance aggregation
  each finer level: the coarser depth upsampled 2x (bicubic), +-4
    hypotheses per pixel around it; the step is, at eval, the median over
    the valid pixels of the depth change that moves the first source's
    projection one pixel along its epipolar line (`cal_depth_hypo`), and
    in train mode (max - min) / 48 / 2^(k+1) at refinement level k
  one 3D regularizer (CVPCostRegNet: 16/32/64 channels, one stride-2
    level, a 16 -> 1 conv) shared by every level; softmax over depth and
    the expected depth; the finest level's photometric confidence (the
    four probabilities around the expected index)

Departures from the published code, each the port's (wildmvs_torch's
models/cvp_mvsnet.py), so that the two compute the same function:
  * the 2x upsampling is jax.image.resize's cubic (Keys a = -0.5,
    half-pixel centres, taps outside the map dropped and the rest
    renormalised), not F.interpolate's bicubic (a = -0.75, edges clamped);
  * the sweep is MVSNet's homography warp (integer pixel grid,
    align_corners=True, behind the source camera to pixel -10, the grid
    clamped to [-10, 10]) for the fronto-parallel and the per-pixel
    hypotheses alike;
  * `cal_depth_hypo` is computed in f32 with guards against degenerate
    points (a zero epipolar direction, a point behind either camera, a
    singular 2x2 system), and where no pixel is valid the step is
    (max - min) / 128;
  * the median is the lower-middle one of the valid pixels.
Departures from the port: the sweep is the exact `grid_sample` gather at
every level (the port's "rect" canvas resample and its kernels are the
program's paths, not this one's), everything is f32 with TF32 off, and
nothing is partitioned or recomputed.

`forward(..., centres=(d_1, ..., d_{nscale-1}))` refines each level around
the given coarser depth instead of its own: the benchmark follows the
served program's cascade level by level with it. The forward has no
Python branch on a tensor's value, so it runs on the meta device (the
flops of a request are counted there).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..work import F32_FLOPS, HBM_BYTES_PER_S, Launches, fused_work, live_mask
from .common import ConvBnReLU, projection, scale_intrinsics

#: hypotheses of the coarsest level (eval, train) and of each finer one
COARSE_DEPTHS = {False: 96, True: 48}
REFINE_HALF = 4
PYRAMID = (("conv0aa", 3, 64), ("conv0ba", 64, 64), ("conv0bb", 64, 64),
           ("conv0bc", 64, 32), ("conv0bd", 32, 32), ("conv0be", 32, 32),
           ("conv0bf", 32, 16), ("conv0bg", 16, 16), ("conv0bh", 16, 16))
#: channels of the features the sweep warps
FEATURES = 16


class FeaturePyramidNet(nn.Module):
    """[M, 3, H, W] -> [M, 16, H, W]."""

    def __init__(self):
        super().__init__()
        for name, cin, cout in PYRAMID:
            setattr(self, name, nn.Sequential(
                nn.Conv2d(cin, cout, 3, 1, 1, bias=True), nn.LeakyReLU(0.1)))

    def forward(self, x):
        for name, _, _ in PYRAMID:
            x = getattr(self, name)(x)
        return x


def deconv_bn_relu(cin, cout, stride, output_padding):
    return nn.Sequential(
        nn.ConvTranspose3d(cin, cout, 3, stride=stride, padding=1,
                           output_padding=output_padding, bias=False),
        nn.BatchNorm3d(cout), nn.ReLU(inplace=True))


class CVPCostRegNet(nn.Module):
    """The shared regularizer: a variance volume [B, 16, D, H, W] ->
    logits [B, D, H, W]."""

    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU(16, 16, dim=3)
        self.conv0a = ConvBnReLU(16, 16, dim=3)
        self.conv1 = ConvBnReLU(16, 32, stride=2, dim=3)
        self.conv2 = ConvBnReLU(32, 32, dim=3)
        self.conv2a = ConvBnReLU(32, 32, dim=3)
        self.conv3 = ConvBnReLU(32, 64, dim=3)
        self.conv4 = ConvBnReLU(64, 64, dim=3)
        self.conv4a = ConvBnReLU(64, 64, dim=3)
        self.conv5 = deconv_bn_relu(64, 32, 1, 0)
        self.conv6 = deconv_bn_relu(32, 16, 2, 1)
        self.prob0 = nn.Conv3d(16, 1, 3, 1, 1, bias=True)

    def forward(self, x):
        c0 = self.conv0a(self.conv0(x))
        c2 = self.conv2a(self.conv2(self.conv1(c0)))
        c4 = self.conv4a(self.conv4(self.conv3(c2)))
        c5 = c2 + self.conv5(c4)
        c6 = c0 + self.conv6(c5)
        return self.prob0(c6)[:, 0]


# ---------------------------------------------------------------------------
# resizes, hypotheses, sweep
# ---------------------------------------------------------------------------

def bilinear_half(x):
    """[M, C, H, W] -> [M, C, H // 2, W // 2], bilinear, half-pixel
    centres, no antialiasing."""
    return F.interpolate(x, size=(x.shape[2] // 2, x.shape[3] // 2),
                         mode="bilinear", align_corners=False)


def _cubic_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out]: the Keys kernel (a = -0.5) at half-pixel centres,
    each output's taps inside the map renormalised to sum 1."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * (n_in / n_out) - 0.5
    dist = (pos[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    near = ((1.5 * dist - 2.5) * dist) * dist + 1.0
    far = ((-0.5 * dist + 2.5) * dist - 4.0) * dist + 2.0
    w = torch.where(dist < 1.0, near,
                    torch.where(dist < 2.0, far, torch.zeros_like(dist)))
    return w / w.sum(0, keepdim=True)


def bicubic_double(depth):
    """[B, H, W] -> [B, 2H, 2W]."""
    h, w = depth.shape[1:]
    wy = _cubic_weights(h, 2 * h, depth.device)
    wx = _cubic_weights(w, 2 * w, depth.device)
    return torch.einsum("bhw,hH,wW->bHW", depth, wy, wx)


def masked_median(values, valid):
    """The lower-middle median over dims 1.. of the valid entries of
    values [B, ...] -> [B]."""
    flat = values.flatten(1)
    ok = valid.flatten(1) & ~torch.isnan(flat)
    ordered = torch.sort(torch.where(ok, flat, torch.full_like(flat,
                                                               float("inf"))),
                         dim=1).values
    rank = ((ok.sum(1) - 1) // 2).clamp_min(0)
    return ordered.gather(1, rank[:, None])[:, 0]


def epipolar_step(depth, K_ref, K_src, R_ref, t_ref, R_src, t_src,
                  depth_min, depth_max):
    """The eval refinement step [B] (reference modules.py cal_depth_hypo):
    at every pixel, the change of the depth [B, H, W] that moves its
    projection in the first source one pixel along the epipolar line; the
    median over the valid pixels, (max - min) / 128 where none is."""
    h, w = depth.shape[1:]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=depth.device),
        torch.arange(w, dtype=torch.float32, device=depth.device),
        indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1)     # [H, W, 3]
    ray = pix @ torch.linalg.inv(K_ref).transpose(-1, -2)[:, None]
    cam_t = t_ref[:, None, None, :, 0]

    def project(d):                     # [B, H, W, 3] homogeneous source
        world = (ray * d[..., None] - cam_t) @ R_ref[:, None]
        cam = world @ R_src.transpose(-1, -2)[:, None] \
            + t_src[:, None, None, :, 0]
        return cam @ K_src.transpose(-1, -2)[:, None]

    p1, p2 = project(depth), project(depth + 1.0)
    z1, z2 = p1[..., 2], p2[..., 2]
    n1, n2 = p1 / z1[..., None], p2 / z2[..., None]
    direction = n2 - n1
    length = torch.linalg.vector_norm(direction, dim=-1)
    n3 = n1 + direction / length.clamp_min(1e-8)[..., None]
    A = (K_ref @ R_ref @ torch.linalg.inv(K_src @ R_src))[:, None]
    u = z1[..., None] * (n1 @ A.transpose(-1, -2))
    v = n3 @ A.transpose(-1, -2)
    # the 2x2 system [pix[1:], v[1:]] (depth step, s) = u[1:], by Cramer
    det = pix[..., 1] * v[..., 2] - v[..., 1] * pix[..., 2]
    valid = ((length > 1e-8) & (z1 > 1e-8) & (z2 > 1e-8)
             & (det.abs() > 1e-8))
    det = torch.where(det.abs() > 1e-8, det, torch.ones_like(det))
    step = ((u[..., 1] * v[..., 2] - v[..., 1] * u[..., 2]) / det).abs()
    nvalid = (valid & ~torch.isnan(step)).flatten(1).sum(1)
    return torch.where(nvalid > 0, masked_median(step, valid),
                       (depth_max - depth_min) / 128.0)


def sweep_coords(src_proj, ref_proj, depth):
    """Source pixels (x, y) [B, D, H, W] of the integer reference grid at
    the per-pixel depths [B, D, H, W] (MVSNet's homography warp; behind
    the source camera: pixel -10)."""
    h, w = depth.shape[2:]
    proj = src_proj @ torch.linalg.inv(ref_proj)
    rot, trans = proj[:, :3, :3], proj[:, :3, 3]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=depth.device),
        torch.arange(w, dtype=torch.float32, device=depth.device),
        indexing="ij")
    xyz = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
    ray = (rot @ xyz).reshape(-1, 3, 1, h, w)                # [B, 3, 1, H, W]
    p = ray * depth[:, None] + trans[:, :, None, None, None]
    z = p[:, 2]
    x = torch.where(z > 0, p[:, 0] / z, -10.0)
    y = torch.where(z > 0, p[:, 1] / z, -10.0)
    return x, y


def variance_volume(feats, projs, hyp):
    """feats [B, N, C, H, W] (reference first), projs [B, N, 4, 4], hyp
    [B, D, H, W] -> the variance over the views [B, C, D, H, W]."""
    b, n, c, h, w = feats.shape
    d = hyp.shape[1]
    ref = feats[:, 0, :, None]
    vol_sum = ref.expand(-1, -1, d, -1, -1).clone()
    vol_sq = vol_sum ** 2
    for i in range(1, n):
        x, y = sweep_coords(projs[:, i], projs[:, 0], hyp)
        xn = (x / ((w - 1) / 2.0) - 1.0).clamp(-10.0, 10.0)
        yn = (y / ((h - 1) / 2.0) - 1.0).clamp(-10.0, 10.0)
        grid = torch.stack([xn, yn], -1).reshape(b, d * h, w, 2)
        warped = F.grid_sample(feats[:, i], grid, mode="bilinear",
                               padding_mode="zeros", align_corners=True)
        warped = warped.reshape(b, c, d, h, w)
        vol_sum = vol_sum + warped
        vol_sq = vol_sq + warped ** 2
        del warped
    return vol_sq / n - (vol_sum / n) ** 2


def regress(score, hyp, dtype=torch.float32):
    """Logits [B, D, H, W] over hypotheses [B, D, H, W] -> (prob, expected
    depth [B, H, W]), in `dtype` (f32 as the configuration states; the
    control takes bf16)."""
    prob = torch.softmax(score.to(dtype), dim=1)
    return prob, (prob * hyp.to(dtype)).sum(1)


def confidence(prob):
    """The sum of the four probabilities around the expected index
    (truncated), prob [B, D, H, W] -> [B, H, W]."""
    d = prob.shape[1]
    pad = F.pad(prob, (0, 0, 0, 0, 1, 2))
    sum4 = pad[:, 0:d] + pad[:, 1:d + 1] + pad[:, 2:d + 2] + pad[:, 3:d + 3]
    index = (prob * torch.arange(d, dtype=prob.dtype, device=prob.device)
             [:, None, None]).sum(1).long().clamp(0, d - 1)
    return torch.gather(sum4, 1, index[:, None])[:, 0]


class Cascade:
    """The geometry of one request's pyramid: each level's projections and
    the hypotheses of each level from the coarser depth. x: batched f32
    tensors (imgs [B, N, H, W, 3], K, R, t, depth_min, depth_max)."""

    def __init__(self, x: dict, training: bool):
        self.K, self.R, self.t = x["K"], x["R"], x["t"]
        self.dmin = x["depth_min"][:, 0]
        self.dmax = x["depth_max"][:, 0]
        self.h = x["imgs"].shape[2]
        self.training = training

    def level_K(self, hw) -> torch.Tensor:
        return scale_intrinsics(self.K, hw[0] / self.h)

    def projs(self, hw) -> torch.Tensor:
        return projection(self.level_K(hw), self.R, self.t)

    def coarse(self, hw) -> tuple:
        """(hypotheses [B, D, H, W], interval [B]) of the coarsest level."""
        d = COARSE_DEPTHS[self.training]
        step = (self.dmax - self.dmin) / d
        steps = torch.arange(d, dtype=torch.float32, device=step.device)
        hyp = self.dmin[:, None] + steps * step[:, None]
        return hyp[:, :, None, None].expand(-1, -1, *hw), step

    def refine(self, k: int, prev) -> tuple:
        """(hypotheses [B, 8, 2h, 2w], interval [B]) of refinement level
        k = 1, 2, ... around the coarser depth prev [B, h, w] (the control
        regresses it in bf16; the geometry is f32)."""
        up = bicubic_double(prev.float())
        if self.training:
            step = (self.dmax - self.dmin) / 48.0 / 2.0 ** k
        else:
            K = self.level_K(up.shape[1:])
            step = epipolar_step(up, K[:, 0], K[:, 1], self.R[:, 0],
                                 self.t[:, 0], self.R[:, 1], self.t[:, 1],
                                 self.dmin, self.dmax)
        offs = torch.arange(-REFINE_HALF, REFINE_HALF, dtype=torch.float32,
                            device=up.device)[None, :, None, None]
        return up[:, None] + offs * step[:, None, None, None], step


class CVPMVSNet(nn.Module):
    """forward(imgs [B, N, H, W, 3] in [0, 1], K, R [B, N, 3, 3], t [B, N,
    3, 1], depth_min, depth_max [B, N], centres=None) -> {"depth" [B, H, W]
    (the finest level's), "stage_depths", "scores" (logits [B, D, h, w])
    and "intervals" ([B]) of each level, coarsest first, "confidence"
    [B, H, W]}; view 0 is the reference, view 1 the first source.
    `regress_dtype` is the precision of the softmax and regression."""

    def __init__(self, nscale: int):
        super().__init__()
        self.nscale = nscale
        self.regress_dtype = torch.float32
        self.featurePyramid = FeaturePyramidNet()
        self.cost_reg_refine = CVPCostRegNet()

    def forward(self, imgs, K, R, t, depth_min, depth_max, centres=None):
        b, n = imgs.shape[:2]
        x = {"imgs": imgs, "K": K, "R": R, "t": t, "depth_min": depth_min,
             "depth_max": depth_max}
        geo = Cascade(x, self.training)
        levels = [imgs.reshape((b * n,) + imgs.shape[2:]).permute(0, 3, 1, 2)]
        for _ in range(self.nscale - 1):
            levels.append(bilinear_half(levels[-1]))
        depths, scores, steps = [], [], []
        for k, img in enumerate(reversed(levels)):
            feats = self.featurePyramid(img)
            feats = feats.reshape((b, n) + feats.shape[1:])
            hw = tuple(feats.shape[3:])
            if k == 0:
                hyp, step = geo.coarse(hw)
            else:
                prev = depths[-1] if centres is None else centres[k - 1]
                hyp, step = geo.refine(k, prev)
            score = self.cost_reg_refine(
                variance_volume(feats, geo.projs(hw), hyp))
            prob, depth = regress(score, hyp, self.regress_dtype)
            depths.append(depth)
            scores.append(score)
            steps.append(step)
        return {"depth": depths[-1], "stage_depths": depths,
                "scores": scores, "intervals": steps,
                "confidence": confidence(prob)}


# ---------------------------------------------------------------------------
# what the benchmark asks of an architecture's reference
# ---------------------------------------------------------------------------

def build(cfg: dict) -> CVPMVSNet:
    """The model at the configuration's pyramid depth, which the
    configuration states as Predictor's `cvp_nscale`."""
    return CVPMVSNet(cfg["predictor"]["cvp_nscale"])


def intervals(cfg: dict, depth_min: float, depth_max: float) -> list:
    """Each level's interval where it does not depend on the request: the
    training forward's, coarsest first. A served request's own intervals
    come with `serve`."""
    base = (depth_max - depth_min) / COARSE_DEPTHS[True]
    return [base] + [base / 2.0 ** k for k in
                     range(1, cfg["predictor"]["cvp_nscale"])]


def _tensor_centres(centres, device):
    return (None if centres is None else
            [torch.as_tensor(c, device=device)[None] for c in centres])


@torch.no_grad()
def serve(model: CVPMVSNet, x: dict, centres=None) -> dict:
    """One request (batched f32 tensors) -> {"depths": every level's depth
    [h, w], coarsest first, "confidence" [H, W], "intervals": every
    level's step (floats)} and "scores": every level's logits [D, h, w]
    on the device; `centres` (the program's depths of every level but the
    finest, numpy) re-centre the refinement levels as the program's
    cascade did."""
    out = model(x["imgs"], x["K"], x["R"], x["t"], x["depth_min"],
                x["depth_max"],
                centres=_tensor_centres(centres, x["imgs"].device))
    return {"depths": [d[0].float().cpu().numpy()
                       for d in out["stage_depths"]],
            "confidence": out["confidence"][0].float().cpu().numpy(),
            "scores": [s[0].float() for s in out["scores"]],
            "intervals": [float(s[0]) for s in out["intervals"]]}


@torch.no_grad()
def regress_scores(cfg: dict, x: dict, scores: list, centres=None,
                   dtype=torch.float32) -> dict:
    """The depths and confidence that `regress` makes of given logits
    (scores: [D, h, w] a level, coarsest first), each refinement level
    around `centres` (numpy, as `serve` takes them) or, without them,
    around the depth this regression made of the level before; as `serve`
    returns them."""
    dev = scores[0].device
    x = {k: v.to(dev) for k, v in x.items()}
    geo = Cascade(x, training=False)
    centres = _tensor_centres(centres, dev)
    depths = []
    for k, score in enumerate(scores):
        if k == 0:
            hyp, _ = geo.coarse(tuple(score.shape[1:]))
        else:
            prev = depths[-1] if centres is None else centres[k - 1]
            hyp, _ = geo.refine(k, prev)
        prob, depth = regress(score.float()[None], hyp, dtype)
        depths.append(depth.float())
    return {"depths": [d[0].cpu().numpy() for d in depths],
            "confidence": confidence(prob)[0].float().cpu().numpy()}


def stage_depths(cfg: dict, x: dict, scores: list) -> list:
    """The program's depth of every level from its own logits: each
    level's f32 regression over the hypotheses built from the level
    before's, regressed alike (numpy, coarsest first)."""
    return regress_scores(cfg, x, scores)["depths"]


@torch.no_grad()
def serve_jobs(cfg: dict, x: dict) -> dict:
    """The fused kernel's jobs of one request, one launch a level: every
    source warped and variance-aggregated. The coarsest level's operations
    bind and its live samples are counted; at every finer level the bytes
    bind even if every sample were live (checked here), so the bound does
    not depend on the cascade's data-dependent hypotheses."""
    nscale = cfg["predictor"]["cvp_nscale"]
    n, h, w = x["imgs"].shape[1:4]
    geo = Cascade(x, training=False)
    sizes = [(h, w)]
    for _ in range(nscale - 1):
        sizes.append((sizes[-1][0] // 2, sizes[-1][1] // 2))
    coarse = sizes[-1]
    hyp, _ = geo.coarse(coarse)
    projs = geo.projs(coarse)
    live = 0
    for i in range(1, n):
        sx, sy = sweep_coords(projs[:, i], projs[:, 0], hyp)
        live += int(live_mask(sx, sy, *coarse).sum())
    jobs = [fused_work(FEATURES, n - 1, coarse, (hyp.shape[1],) + coarse,
                       live)]
    for hw in reversed(sizes[:-1]):
        grid = (2 * REFINE_HALF,) + hw
        job = fused_work(FEATURES, n - 1, hw, grid,
                         (n - 1) * grid[0] * hw[0] * hw[1])
        if job.operations / F32_FLOPS > job.bytes / HBM_BYTES_PER_S:
            return {}
        jobs.append(job)
    return {"fused_cost_volume": Launches(jobs)}
