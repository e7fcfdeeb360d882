"""DSSIM map for the unsupervised photometric loss.

Counterpart of wildmvs/losses/ssim.py (reference utils/ssimLoss.py): an
11x11 Gaussian window (sigma 1.5), depthwise convolution with zero padding
window // 2, C1 = 0.01^2, C2 = 0.03^2; returns 1 - SSIM per pixel and
channel. Channels-last.

The blurs run on contiguous NCHW copies, which PyTorch convolves with its
own f32 depthwise kernel on the card. A permuted channels-last tensor goes
to cuDNN instead, and under PyTorch's default flags
(torch.backends.cudnn.allow_tf32) cuDNN may take a TF32 engine: sigma^2 =
blur(x^2) - mu^2 is a difference of near-equal window means, and TF32
moved the DSSIM map by 0.2 of its scale at 128x160 on an H100
(chip_smoke.py, phase 12c).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2.0 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    return np.outer(g, g)


def _depthwise_blur(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] depthwise conv with the window, zero padding k // 2."""
    c = x.shape[1]
    k = window.shape[0]
    kern = window.expand(c, 1, k, k)
    return F.conv2d(x, kern, padding=k // 2, groups=c)


def dssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
          sigma: float = 1.5) -> torch.Tensor:
    """1 - SSIM(img1, img2), elementwise.

    Args:
      img1, img2: [B, H, W, C].
    Returns:
      [B, H, W, C] DSSIM map.
    """
    window = torch.as_tensor(_gaussian_window(window_size, sigma),
                             dtype=img1.dtype, device=img1.device)
    x1 = img1.permute(0, 3, 1, 2).contiguous()
    x2 = img2.permute(0, 3, 1, 2).contiguous()
    mu1 = _depthwise_blur(x1, window)
    mu2 = _depthwise_blur(x2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(x1 * x1, window) - mu1_sq
    sigma2_sq = _depthwise_blur(x2 * x2, window) - mu2_sq
    sigma12 = _depthwise_blur(x1 * x2, window) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return (1.0 - ssim).permute(0, 2, 3, 1)
