"""Device resolution for the port's entry points.

"cuda" is the default and raises when no card is present; the CPU is used
only when the caller asks for it (the tests do). There is no silent fallback
from the card to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the torch.device an entry point runs on.

    Args:
      device: None or "cuda[:i]" (the card, default) or "cpu".
    Raises:
      RuntimeError: a CUDA device was requested and none is available.
      ValueError: any other device type.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "wildmvs_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device: {dev}")
