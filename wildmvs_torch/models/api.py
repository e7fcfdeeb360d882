"""The uniform model contract and the architecture registry.

Counterpart of wildmvs/models/api.py. Every model is called as
    model(imgs, K, R, t, depth_min, depth_max, reference_frame=0)
and returns {"depth", "depth_est_list", "depth_pair_list",
"photometric_confidence"}. Inputs are channels-last: imgs [B, N, H, W, 3]
(or a list of per-view [B, Hi, Wi, 3] tensors whose sizes may differ), K/R
[B, N, 3, 3], t [B, N, 3, 1], depth_min/max [B, N].
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..device import resolve_device

MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {}


def view_list(imgs):
    """(views, ragged): per-view [B, Hi, Wi, C] tensors and whether their
    sizes differ. A uniform list is not restacked."""
    if isinstance(imgs, (list, tuple)):
        views = list(imgs)
        return views, len({tuple(v.shape[1:3]) for v in views}) > 1
    return [imgs[:, i] for i in range(imgs.shape[1])], False


def register_model(name: str):
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        return cls
    return deco


def build_model(architecture: str, device: str | torch.device | None = None,
                seed: int = 0, **kwargs):
    """Build a model by the reference's architecture string (mvsnet |
    mvsnet-s | vis_mvsnet | cvp_mvsnet) with seeded random weights, on `device` ("cuda"
    by default; "cpu" only when asked). kwargs go to the model's
    constructor."""
    dev = resolve_device(device)
    if architecture == "mvsnet":
        kwargs = {"aggregation": "variance", **kwargs}
        architecture = "mvsnet"
    elif architecture == "mvsnet-s":
        kwargs = {"aggregation": "softmin", **kwargs}
        architecture = "mvsnet"
    if architecture not in MODEL_REGISTRY:
        raise ValueError(f"unknown architecture: {architecture}")
    return MODEL_REGISTRY[architecture](seed=seed, **kwargs).to(dev)
