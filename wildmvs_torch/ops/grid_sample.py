"""Bilinear border-zero sampling, channels-last, gather-based torch code.

Counterpart of wildmvs/ops/grid_sample.py:17-116. Semantics match
torch.nn.functional.grid_sample(mode='bilinear', padding_mode='zeros') for
both align_corners conventions, on channels-last images with the (x, y)
normalized coordinates given as two separate planes. The bilinear weights
are computed in the grid's precision and cast to the image dtype for the
combine, as the JAX function does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def unnormalize_coords_xy(gx: torch.Tensor, gy: torch.Tensor, h: int, w: int,
                          align_corners: bool):
    """[-1,1] NDC -> continuous pixel coords, torch grid_sample convention."""
    if align_corners:
        x = (gx + 1.0) * 0.5 * (w - 1)
        y = (gy + 1.0) * 0.5 * (h - 1)
    else:
        x = ((gx + 1.0) * w - 1.0) * 0.5
        y = ((gy + 1.0) * h - 1.0) * 0.5
    return x, y


def grid_sample_xy(img: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                   align_corners: bool = True) -> torch.Tensor:
    """Bilinear zero-padded sampling of a batch of images.

    Args:
      img: [B, h, w, C].
      gx, gy: [B, ...] normalized x and y in [-1, 1] (outside -> zeros).
      align_corners: torch convention selector.
    Returns:
      [B, ..., C] sampled values in the image dtype.
    """
    b, h, w, c = img.shape
    x, y = unnormalize_coords_xy(gx, gy, h, w, align_corners)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx1 = x - x0f
    wy1 = y - y0f
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    # a zero ring (2 before, 3 after) makes every out-of-bounds corner read
    # an exact zero: far-out coords clip onto the ring, and the +1 corner of
    # the last ring index stays inside the padded image
    padded = F.pad(img, (0, 0, 2, 3, 2, 3))           # [B, h+5, w+5, C]
    pw = w + 5
    # the float clip bounds finite coords; the integer clamp also bounds
    # NaN/Inf inputs (their int cast is undefined), whose NaN weights still
    # give a NaN output
    iy = (torch.clamp(y0f, -2, h + 1) + 2).to(torch.int64).clamp(0, h + 3)
    ix = (torch.clamp(x0f, -2, w + 1) + 2).to(torch.int64).clamp(0, w + 3)
    flat = padded.reshape(b, -1, c)
    idx = (iy * pw + ix).reshape(b, -1)
    rows = torch.arange(b, device=img.device)[:, None]

    def corner(off):
        return flat[rows, idx + off].reshape(x.shape + (c,))

    dtype = img.dtype
    w00 = (wy0 * wx0).to(dtype)[..., None]
    w01 = (wy0 * wx1).to(dtype)[..., None]
    w10 = (wy1 * wx0).to(dtype)[..., None]
    w11 = (wy1 * wx1).to(dtype)[..., None]
    return (corner(0) * w00 + corner(1) * w01
            + corner(pw) * w10 + corner(pw + 1) * w11)
