"""Building blocks of the plain references: layers, geometry, sampling,
losses, Adam and the lower-precision control.

Plain PyTorch in the published models' layout (NCHW / NCDHW), float32,
with the torch key names of the published code (`<block>.conv.weight`,
`<block>.bn.*`, Sequential indices). Nothing here imports the measured
program. Matrix products and convolutions run with TF32 off
(`f32_flags`), so that float32 means float32 on the card.
"""
from __future__ import annotations

import contextlib
import copy

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize


@contextlib.contextmanager
def f32_flags():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    kept = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = kept


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

CONVS = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)
_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_DECONV = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_BN = {2: nn.BatchNorm2d, 3: nn.BatchNorm3d}


class ConvBnReLU(nn.Module):
    """conv (no bias) -> BN -> ReLU (MVSNet module.py)."""

    def __init__(self, cin, cout, k=3, stride=1, pad=1, dim=2):
        super().__init__()
        self.conv = _CONV[dim](cin, cout, k, stride, pad, bias=False)
        self.bn = _BN[dim](cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def deconv_bn_relu(cin, cout):
    """MVSNet's up block: ConvTranspose3d stride 2 -> BN -> ReLU."""
    return nn.Sequential(
        nn.ConvTranspose3d(cin, cout, 3, stride=2, padding=1,
                           output_padding=1, bias=False),
        nn.BatchNorm3d(cout), nn.ReLU(inplace=True))


class BasicBlock(nn.Module):
    """ResNet BasicBlock (Vis-MVSNet nn_utils.py), 2D or 3D."""

    def __init__(self, cin, cout, stride=1, dim=2):
        super().__init__()
        self.conv1 = _CONV[dim](cin, cout, 3, stride, 1, bias=False)
        self.bn1 = _BN[dim](cout)
        self.conv2 = _CONV[dim](cout, cout, 3, 1, 1, bias=False)
        self.bn2 = _BN[dim](cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                _CONV[dim](cin, cout, 1, stride, 0, bias=False),
                _BN[dim](cout))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


def res_layer(cin, cout, blocks, stride, dim):
    return nn.Sequential(*[BasicBlock(cin if i == 0 else cout, cout,
                                      stride if i == 0 else 1, dim)
                           for i in range(blocks)])


class UNet(nn.Module):
    """Vis-MVSNet's UNet (nn_utils.py): ResLayer encoder, stride 1 then 2;
    decoder of a stride-2 transposed conv, concatenation with the encoder
    output of that scale, a 3x3 conv and `dec_blocks` BasicBlocks. Keys
    `{prefix}{scale}_{idx}`. `multi_scale` k returns the last k decoder
    outputs, coarsest first."""

    def __init__(self, cin, enc_blocks, dec_blocks, filters, prefix,
                 initial_scale, dim):
        super().__init__()
        self.enc_blocks = nn.ModuleDict()
        self.dec_blocks = nn.ModuleDict()
        scale, prev = initial_scale, cin
        for idx, f in enumerate(filters):
            self.enc_blocks[f"{prefix}{scale}_{idx}"] = res_layer(
                prev, f, enc_blocks, 1 if idx == 0 else 2, dim)
            scale, prev = scale * 2, f
        idx = len(filters)
        for f in list(filters)[-2::-1]:
            parts = [_DECONV[dim](prev, f, 3, stride=2, padding=1,
                                  output_padding=1, bias=False),
                     _CONV[dim](2 * f, f, 3, 1, 1, bias=False)]
            if dec_blocks:
                parts.append(res_layer(f, f, dec_blocks, 1, dim))
            self.dec_blocks[f"{prefix}{scale}_{idx}"] = nn.Sequential(*parts)
            scale, prev, idx = scale // 2, f, idx + 1

    def forward(self, x, multi_scale=1):
        enc = []
        for layer in self.enc_blocks.values():
            x = layer(x)
            enc.append(x)
        outs = [x]
        for i, block in enumerate(self.dec_blocks.values()):
            x = block[1](torch.cat([block[0](x), enc[-2 - i]], 1))
            if len(block) > 2:
                x = block[2](x)
            outs.append(x)
        return x if multi_scale == 1 else outs[-multi_scale:]


# ---------------------------------------------------------------------------
# geometry and sampling
# ---------------------------------------------------------------------------

def scale_intrinsics(K, factor):
    """K with its first two rows scaled (a resolution change)."""
    K = K.clone()
    K[..., :2, :] = K[..., :2, :] * factor
    return K


def projection(K, R, t):
    """4x4 P = [[K R, K t], [0 0 0 1]]."""
    top = torch.cat([K @ R, K @ t], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def mvsnet_coords(src_proj, ref_proj, depth, hw):
    """MVSNet homography warping's sampling coordinates (MVSNet
    module.py homo_warping): source pixels (x, y), each [B, D, H, W], of
    the integer reference grid at the fronto-parallel depths [B, D]. A
    point behind the source camera goes to pixel -10 (the reference
    divides by its z; no point of the benchmark's rigs is behind one)."""
    h, w = hw
    proj = src_proj @ torch.linalg.inv(ref_proj)
    rot, trans = proj[:, :3, :3], proj[:, :3, 3]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=depth.device),
                            torch.arange(w, dtype=torch.float32,
                                         device=depth.device), indexing="ij")
    xyz = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
    rot_xyz = rot @ xyz                                      # [B, 3, HW]
    p = rot_xyz[:, :, None] * depth[:, None, :, None] + trans[:, :, None, None]
    z = p[:, 2]
    x = torch.where(z > 0, p[:, 0] / z, -10.0)
    y = torch.where(z > 0, p[:, 1] / z, -10.0)
    b, d = depth.shape
    return x.reshape(b, d, h, w), y.reshape(b, d, h, w)


def mvsnet_warp(src, src_proj, ref_proj, depth, hw):
    """Source features [B, C, h, w] -> [B, C, D, H, W] by bilinear,
    zero-padded, align_corners=True sampling (grid_sample)."""
    b, c, sh, sw = src.shape
    x, y = mvsnet_coords(src_proj, ref_proj, depth, hw)
    xn = (x / ((sw - 1) / 2.0) - 1.0).clamp(-10.0, 10.0)
    yn = (y / ((sh - 1) / 2.0) - 1.0).clamp(-10.0, 10.0)
    d, h, w = x.shape[1:]
    grid = torch.stack([xn, yn], -1).reshape(b, d * h, w, 2)
    out = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.reshape(b, c, d, h, w)


def vis_homographies(K_ref, R_ref, t_ref, K_src, R_src, t_src, depth):
    """Plane-induced homographies (Vis-MVSNet homography.py
    get_homographies): depth [B, D, H, W] -> [B, D, H, W, 3, 3],
    H(d) = K_src R_src (I - c_rel f^T / (d + 1e-9)) R_ref^T K_ref^-1,
    c_rel the source centre minus the reference centre, f the reference's
    fronto direction."""
    R_ref_T = R_ref.transpose(-1, -2)
    c_rel = (-R_src.transpose(-1, -2) @ t_src) - (-R_ref_T @ t_ref)
    fronto = R_ref[:, 2:3, :]
    eye = torch.eye(3, dtype=depth.dtype, device=depth.device)
    mid = eye - (c_rel @ fronto)[:, None, None, None] / (
        depth[..., None, None] + 1e-9)
    left = (K_src @ R_src)[:, None, None, None]
    right = (R_ref_T @ torch.linalg.inv(K_ref))[:, None, None, None]
    return left @ mid @ right


def vis_warp(src, K_ref, R_ref, t_ref, K_src, R_src, t_src, depth, hw):
    """Vis-MVSNet homography warping (homography.py): the pixel-centre
    reference grid (+0.5) through H(d), normalized by the source size
    (2 x / w - 1), clamped to [-1.1, 1.1] (behind the camera: pixel -10),
    sampled with grid_sample align_corners=True. src [B, C, h, w], depth
    [B, D, H, W] -> [B, C, D, H, W]."""
    b, c, sh, sw = src.shape
    h, w = hw
    d = depth.shape[1]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=src.device) + 0.5,
                            torch.arange(w, dtype=torch.float32,
                                         device=src.device) + 0.5,
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1)     # [H, W, 3]
    Hm = vis_homographies(K_ref, R_ref, t_ref, K_src, R_src, t_src, depth)
    p = (Hm @ pix[None, None, :, :, :, None])[..., 0]        # [B,D,H,W,3]
    z = p[..., 2]
    zs = z.clamp_min(1e-9)
    x = torch.where(z > 0, p[..., 0] / zs, -10.0)
    y = torch.where(z > 0, p[..., 1] / zs, -10.0)
    xn = (x / sw * 2.0 - 1.0).clamp(-1.1, 1.1)
    yn = (y / sh * 2.0 - 1.0).clamp(-1.1, 1.1)
    grid = torch.stack([xn, yn], -1).reshape(b, d * h, w, 2)
    out = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.reshape(b, c, d, h, w)


def resize_bilinear(x, hw):
    """[B, H, W] bilinear resize, half-pixel centres, no antialiasing."""
    return F.interpolate(x[:, None], size=tuple(hw), mode="bilinear",
                         align_corners=False)[:, 0]


# ---------------------------------------------------------------------------
# losses and the optimizer
# ---------------------------------------------------------------------------

def masked_l1_interval(depth, gt, mask, interval):
    """Masked mean of |depth - gt| in units of the interval (range / 128),
    the supervised loss of the trainer this benchmark follows."""
    l1 = (depth - gt).abs() / interval[:, None, None]
    return (l1 * mask).sum() / mask.sum().clamp_min(1.0)


class Adam:
    """Adam (betas 0.9 / 0.999, eps 1e-8, no weight decay), written out:
    m <- b1 m + (1 - b1) g, v <- b2 v + (1 - b2) g^2,
    p <- p - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        self.params = list(params)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                continue
            g = p.grad
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            mhat = m / (1 - b1 ** self.t)
            vhat = v / (1 - b2 ** self.t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + self.eps))


# ---------------------------------------------------------------------------
# the lower-precision control
# ---------------------------------------------------------------------------

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per tensor (amax / 448), as
    a per-tensor fp8 recipe would store it, returned in x's dtype."""
    amax = x.detach().abs().amax().clamp_min(1e-12)
    scale = amax / FP8_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


class _FP8(torch.autograd.Function):
    """fp8_round in the forward and of the gradient in the backward."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


def fp8_ste(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8; in the backward its gradient rounded to fp8."""
    return _FP8.apply(x)


class _FP8Weight(nn.Module):
    def forward(self, w):
        return fp8_ste(w)


def fp8_control(model: nn.Module) -> nn.Module:
    """A copy of a reference model that computes its convolutions in fp8:
    each call rounds the conv's weight and input to fp8, and the backward
    rounds the gradients that reach them to fp8; the products accumulate
    in f32. The configurations
    state bf16 compute, so fp8 is the next precision below: the control
    that has to fail. Its parameters are named as the model's with
    `.parametrizations.weight.original` for a conv's `.weight`
    (`plain_name`)."""
    ctl = copy.deepcopy(model)
    for m in ctl.modules():
        if isinstance(m, CONVS):
            parametrize.register_parametrization(m, "weight", _FP8Weight())
            m.register_forward_pre_hook(
                lambda _m, args: (fp8_ste(args[0]),) + args[1:])
    return ctl


def plain_name(name: str) -> str:
    """A parameter's name without fp8_control's parametrization."""
    return name.replace(".parametrizations.weight.original", ".weight")


def crop32(imgs: torch.Tensor) -> torch.Tensor:
    """[B, N, H, W, 3] cropped from the top left to multiples of 32 (the
    networks' three stride-2 levels below 1/4; the crop keeps K)."""
    h, w = imgs.shape[2:4]
    return imgs[:, :, :h // 32 * 32, :w // 32 * 32]
