"""Masked order statistics.

Counterpart of wildmvs/ops/select.py: the lower-middle median of the valid
entries, the element at rank (nvalid - 1) // 2 (torch.median's rank,
reference CVP-MVSNet modules.py:216). The JAX package finds it by a 32-step
bisection over the float bit patterns, which spares the TPU a sort; here
the invalid entries are keyed above every value, the keys sorted, and the
rank gathered, with no host synchronisation (no boolean indexing).
"""
from __future__ import annotations

import torch

# above every key of a non-NaN float32 (+inf keys to 0x7F800000)
_SENTINEL = 0x7FFFFFFF


def _float_to_key(x: torch.Tensor) -> torch.Tensor:
    """Monotonic int32 key of float32 values: key(a) < key(b) iff a < b for
    all non-NaN a, b, with -0.0 below +0.0 (the JAX package's order). The
    negative floats' low 31 bits are flipped, reversing their magnitudes."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _key_to_float(key: torch.Tensor) -> torch.Tensor:
    return torch.where(key < 0, key ^ 0x7FFFFFFF, key).view(torch.float32)


def masked_median(values: torch.Tensor, valid: torch.Tensor,
                  start_dim: int = 0) -> torch.Tensor:
    """Lower-middle median of the valid, non-NaN entries of `values`,
    reduced over the dims from `start_dim` on (the dims before it are a
    batch). Bitwise the element of that rank; unspecified where nothing is
    valid (guard at the call site).

    Args:
      values: float tensor (computed in float32).
      valid: bool tensor of the same shape.
      start_dim: first reduced dim.
    Returns:
      float32 tensor of shape values.shape[:start_dim].
    """
    x = values.float()
    ok = (valid & ~torch.isnan(x)).flatten(start_dim)
    keys = torch.where(ok, _float_to_key(x).flatten(start_dim),
                       torch.full_like(ok, _SENTINEL, dtype=torch.int32))
    rank = ((ok.sum(-1) - 1) // 2).clamp_min(0)
    ordered = torch.sort(keys, dim=-1).values
    return _key_to_float(ordered.gather(-1, rank[..., None])[..., 0])
