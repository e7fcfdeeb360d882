"""The classical (non-learned) plane-sweep stereo baseline.

Counterpart of wildmvs/pipeline/classic.py. The reference evaluates
COLMAP's patch-match stereo as its classical baseline (`--colmap`,
utils/colmap_utils.py:282-322); the JAX package replaces it with a dense
ZNCC sweep over the whole depth slab, winner-take-all with a parabolic
sub-hypothesis refinement, and so does the port. It runs no kernel of
csrc/: the warp is the exact gather `ops/plane_sweep.plane_sweep_warp`
(the JAX package uses its XLA gather there too, no Pallas kernel), the
window statistics are `F.avg_pool2d`, and the rest is elementwise.

Precision: every step is f32. ZNCC takes each variance as a difference of
two near-equal window means, so the box filter must not run in TF32
(cuDNN convolutions on Hopper do by default); `F.avg_pool2d` is a pooling
kernel, not a convolution, and accumulates in f32.

The output matches the learned models' stage-1 npz ({depthmap,
probability}, run_depthmaps), so stages 2-4 of the pipeline run on it
unchanged.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..geometry.projective import build_proj_matrices, scale_K
from ..models.api import view_list
from ..ops.plane_sweep import plane_sweep_warp


def _box_filter(x: torch.Tensor, window: int) -> torch.Tensor:
    """Mean over the in-image part of each window x window neighbourhood
    ("SAME": (window - 1) // 2 before, window // 2 after), [N, C, H, W] ->
    the same shape: the window's sum over its count of in-image pixels, as
    the JAX package's separable sum divided by the box of ones."""
    lo, hi = (window - 1) // 2, window // 2
    if lo == hi:
        return F.avg_pool2d(x, window, 1, lo, count_include_pad=False)
    pad = (lo, hi, lo, hi)
    num = F.avg_pool2d(F.pad(x, pad), window, 1)
    den = F.avg_pool2d(F.pad(torch.ones_like(x[:, :1]), pad), window, 1)
    return num / den


def _gray(view: torch.Tensor, downscale: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, H // d, W // d] gray, the channel mean resized
    bilinearly with antialiasing (jax.image.resize "bilinear", whose
    default antialias=True widens the triangle by 1 / scale when it
    shrinks; F.interpolate's antialias computes the same weights)."""
    g = view.float().mean(dim=-1)
    if downscale > 1:
        h, w = g.shape[1:3]
        g = F.interpolate(g[:, None], size=(h // downscale, w // downscale),
                          mode="bilinear", align_corners=False,
                          antialias=True)[:, 0]
    return g


def classic_depthmap(imgs, K: torch.Tensor, R: torch.Tensor,
                     t: torch.Tensor, depth_min: torch.Tensor,
                     depth_max: torch.Tensor, num_depth: int = 192,
                     window: int = 7, downscale: int = 2):
    """ZNCC plane-sweep depthmap of reference view 0, on the device of the
    inputs.

    Args:
      imgs: [B, N, H, W, 3] in [0, 1] (view 0 the reference), or a list /
        tuple of per-view [B, Hi, Wi, 3] tensors of different sizes.
      K, R: [B, N, 3, 3]; t: [B, N, 3, 1]; depth_min/max: [B, N].
      num_depth: hypotheses, evenly spaced over the reference's range.
      window: ZNCC window size (COLMAP's patches are 5-11 px).
      downscale: the resolution divisor the sweep runs at (1 = full).
    Returns:
      depth [B, H/d, W/d] f32 and the photometric confidence [B, H/d, W/d]
      in [0, 1]: (best ZNCC + 1) / 2, the source views' mean.
    """
    views, _ = view_list(imgs)
    b = views[0].shape[0]
    grays = [_gray(v, downscale) for v in views]
    K, R, t = K.float(), R.float(), t.float()
    depth_min, depth_max = depth_min.float(), depth_max.float()
    if downscale > 1:
        K = scale_K(K, 1.0 / downscale)
    h, w = grays[0].shape[1:3]
    proj = build_proj_matrices(K, R, t)                     # [B, N, 4, 4]
    steps = torch.arange(num_depth, device=K.device)[None, :]
    dvals = (depth_min[:, 0, None]
             + (depth_max[:, 0, None] - depth_min[:, 0, None]) * steps
             / (num_depth - 1))                              # [B, D]
    # [B * D, 1, H, W] planes, so that the box filter is one 2D pooling
    rs = grays[0][:, None, None].expand(b, num_depth, 1, h, w).reshape(
        b * num_depth, 1, h, w)

    eps = 1e-6
    score_sum = torch.zeros(b, num_depth, h, w, device=K.device)
    weight_sum = torch.zeros(b, num_depth, h, w, device=K.device)
    for v in range(1, len(grays)):
        # the gray and a validity plane warped in one pass (zero outside
        # the source frustum)
        src = torch.stack([grays[v], torch.ones_like(grays[v])], -1)
        warped = plane_sweep_warp(src, proj[:, v], proj[:, 0], dvals,
                                  ref_hw=(h, w))            # [B, D, H, W, 2]
        s = warped[..., 0].reshape(b * num_depth, 1, h, w)
        m = warped[..., 1].reshape(b * num_depth, 1, h, w)
        # each [B * D, 1, H, W] plane is 0.36 GB at 1184x1600 (D192, half
        # resolution): free every source's temporaries before the next
        del warped
        # window statistics over the valid (in-frustum) pixels, in the JAX
        # package's order of operations
        mw = _box_filter(m, window)
        den = mw + eps
        s_mean = _box_filter(s * m, window) / den
        s_var = torch.clamp_min(_box_filter(s * s * m, window) / den
                                - s_mean ** 2, 0.0)
        rs_mean = _box_filter(rs * m, window) / den
        r_var = torch.clamp_min(_box_filter(rs * rs * m, window) / den
                                - rs_mean ** 2, 0.0)
        cross = _box_filter(rs * s * m, window) / den
        del s, m, den
        zncc = (cross - rs_mean * s_mean) / torch.sqrt(r_var * s_var + eps)
        del cross, rs_mean, s_mean, r_var, s_var
        valid = (mw > 0.5).float()
        score_sum += (zncc * valid).reshape(b, num_depth, h, w)
        weight_sum += valid.reshape(b, num_depth, h, w)
        del zncc, valid, mw

    score = score_sum / torch.clamp_min(weight_sum, 1.0)   # [B, D, H, W]
    score = torch.where(weight_sum > 0, score, torch.full_like(score, -1.0))
    del score_sum, weight_sum
    best = torch.argmax(score, dim=1)                      # [B, H, W]

    def at(idx):
        return torch.gather(score, 1, idx[:, None])[:, 0]

    # parabolic refinement around the peak
    # (wildmvs/pipeline/classic.py:127-148)
    d_idx = torch.clamp(best, 1, num_depth - 2)
    y0, y1, y2 = at(d_idx - 1), at(d_idx), at(d_idx + 1)
    denom = y0 - 2.0 * y1 + y2
    peaked = denom.abs() > eps
    safe_denom = torch.where(peaked, denom, torch.ones_like(denom))
    offset = torch.where(peaked, 0.5 * (y0 - y2) / safe_denom,
                         torch.zeros_like(denom))
    offset = torch.clamp(offset, -1.0, 1.0)
    step = (depth_max[:, 0] - depth_min[:, 0]) / (num_depth - 1)
    depth = (depth_min[:, 0, None, None]
             + (d_idx.float() + offset) * step[:, None, None])
    confidence = torch.clamp((at(best) + 1.0) * 0.5, 0.0, 1.0)
    return depth, confidence


def run_classic_depthmaps(dataset, depth_dir: str | Path,
                          num_depth: int = 192, window: int = 7,
                          downscale: int = 2, override: bool = False,
                          debug: bool = False, process_index: int = 0,
                          process_count: int = 1,
                          device: str | torch.device | None = None):
    """Stage 1 of the classical baseline: one `<name>_out.npz`
    {depthmap, probability} a reference view, a finished.txt sentinel and
    per-file existence checks, as run_depthmaps. process_index /
    process_count: this process's shard (view i when i % process_count ==
    process_index; a sharded run leaves the sentinel to the unsharded
    pass). debug: stop after the first depthmap written."""
    dev = resolve_device(device)
    depth_dir = Path(depth_dir)
    depth_dir.mkdir(parents=True, exist_ok=True)
    if (depth_dir / "finished.txt").exists() and not override:
        return

    def batch1(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)[None]

    for i in range(len(dataset)):
        if i % process_count != process_index:
            continue
        s = dataset[i]
        name = s["filename"].replace("/", "_")
        f = depth_dir / f"{name}_out.npz"
        if f.exists() and not override:
            continue
        imgs = s["imgs"]
        imgs = (tuple(batch1(v) for v in imgs) if isinstance(imgs, list)
                else batch1(imgs))
        with torch.inference_mode():
            depth, conf = classic_depthmap(
                imgs, *(batch1(s[k]) for k in
                        ("K", "R", "t", "depth_min", "depth_max")),
                num_depth=num_depth, window=window, downscale=downscale)
        np.savez_compressed(f, depthmap=depth[0].cpu().numpy(),
                            probability=conf[0].cpu().numpy())
        if debug:
            return
    if process_count == 1:
        (depth_dir / "finished.txt").write_text("finished\n")
