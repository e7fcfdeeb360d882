"""Projective geometry core, batched torch functions over channels-last data.

Counterpart of wildmvs/geometry/projective.py:18-44, 103-112. Conventions:

  * pixel coordinates are (x, y); x goes along width, y along height
  * a pinhole view is (K [3,3], R [3,3], t [3,1]); world->cam: Xc = R Xw + t
  * projection matrices P are 4x4 with [:3,:4] = K [R|t] and P[3,3] = 1
  * depth is z in the camera frame
"""
from __future__ import annotations

import torch


def build_proj_matrices(K: torch.Tensor, R: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
    """4x4 projection matrices P = [[K R, K t], [0, 0, 0, 1]].

    Args:
      K: [..., 3, 3] intrinsics.
      R: [..., 3, 3] rotations.
      t: [..., 3, 1] translations.
    Returns:
      [..., 4, 4] projection matrices.
    """
    top = torch.cat([K @ R, K @ t], dim=-1)             # [..., 3, 4]
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def scale_K(K: torch.Tensor, factor) -> torch.Tensor:
    """Scale the first two rows of K by `factor` (resolution change).

    `factor` may be a scalar or a broadcastable tensor: rows 0, 1 *= factor.
    """
    factor = torch.as_tensor(factor, dtype=K.dtype, device=K.device)
    row_scale = torch.stack([factor, factor, torch.ones_like(factor)], -1)
    return K * row_scale[..., :, None]


def pixel_grid(h: int, w: int, dtype=torch.float32, device=None,
               offset: float = 0.0) -> torch.Tensor:
    """[h, w, 2] grid of (x, y) pixel coordinates, optionally center-offset.

    offset=0.0 is the MVSNet integer grid; offset=0.5 the Vis-MVSNet
    pixel-center grid.
    """
    ys = torch.arange(h, dtype=dtype, device=device) + offset
    xs = torch.arange(w, dtype=dtype, device=device) + offset
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)
