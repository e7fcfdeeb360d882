"""Stage 1: depthmap inference over an eval dataset, cached per view.

Counterpart of wildmvs/pipeline/depthmaps.py:23-154 (reference
evaluation/run_depthmaps.py:27-74 and pipeline_utils.py:88-154): one npz
{depthmap, probability} per reference view, a finished.txt sentinel, and
per-file existence checks.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def eval_model_kwargs(architecture: str, bf16: bool = True,
                      sweep_method: str = "auto") -> dict:
    """Eval-time model constructor overrides and the output depthmap scale
    (depth resolution = image resolution / downscale). Inference defaults
    to bf16 networks. vis_mvsnet sweeps (64, 32, 16) hypotheses at interval
    scales (2, 1, 0.5) (reference pipeline_utils.py:142-144; the JAX
    package's eval_model_kwargs, depthmaps.py:60-74). cvp_mvsnet's depth
    is at full resolution.

    An explicit sweep_method wins. cvp_mvsnet's "auto" is the rectified
    sweep in the JAX package (depthmaps.py:50-59), an approximation that is
    not ported yet, so it raises rather than give other numerics under the
    same name."""
    if architecture not in ("mvsnet", "mvsnet-s", "vis_mvsnet",
                            "cvp_mvsnet"):
        raise ValueError(f"unknown architecture: {architecture}")
    kwargs = {"sweep_method": sweep_method}
    if bf16:
        kwargs["dtype"] = torch.bfloat16
    if architecture == "cvp_mvsnet":
        if sweep_method == "auto":
            raise NotImplementedError(
                "cvp_mvsnet's eval default sweep_method 'auto' is the "
                "rectified sweep, which is not ported yet (ROADMAP Queue 1, "
                "item 2); pass sweep_method='fused' (exact, the kernel) or "
                "'gather' (exact, plain PyTorch)")
        return {"kwargs": kwargs, "downscale": 1}
    if architecture == "vis_mvsnet":
        kwargs.update(depth_nums=(64, 32, 16),
                      interval_scales=(2.0, 1.0, 0.5))
        return {"kwargs": kwargs, "downscale": 2}
    return {"kwargs": kwargs, "downscale": 4}


def run_depthmaps(dataset, model: torch.nn.Module, out_dir: str | Path,
                  override: bool = False, cvp_nscale: int | None = None):
    """Run the eval forward for every reference view and cache npz outputs.

    `dataset` is anything with len() and [i] that yields the eval sample
    dict: imgs [N, H, W, 3] (or a list of per-view [Hi, Wi, 3]), K, R, t,
    depth_min, depth_max (numpy or tensors, no batch axis) and filename.
    The model runs on the device its parameters are on; `cvp_nscale`, if
    given, goes to the forward as `nscale` (cvp_mvsnet's pyramid levels).
    (The JAX package's multi-host sharding of the view list is not ported
    yet, ROADMAP Queue 1, item 6.)
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if (out_dir / "finished.txt").exists() and not override:
        return
    device = next(model.parameters()).device
    model.eval()
    extra = {} if cvp_nscale is None else {"nscale": cvp_nscale}

    def batch1(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)[None]

    for i in range(len(dataset)):
        sample = dataset[i]
        filename = sample["filename"].replace("/", "_")
        out_file = out_dir / f"{filename}_out.npz"
        if out_file.exists() and not override:
            continue
        imgs = sample["imgs"]
        imgs = ([batch1(v) for v in imgs] if isinstance(imgs, list)
                else batch1(imgs))
        with torch.inference_mode():
            out = model(imgs, *(batch1(sample[k]) for k in
                                ("K", "R", "t", "depth_min", "depth_max")),
                        **extra)
        np.savez_compressed(
            out_file,
            depthmap=out["depth"][0].float().cpu().numpy(),
            probability=out["photometric_confidence"][0].float().cpu()
            .numpy())
    (out_dir / "finished.txt").write_text(" ")


def get_mask_invalid(prob: np.ndarray, prob_threshold: float = 0.8,
                     geo_mask: np.ndarray | None = None) -> np.ndarray:
    """Invalid-pixel mask from probability (+ optional geometric mask).
    Multi-stage probabilities pass if ANY stage clears the threshold."""
    if prob.ndim > 2:
        mask_invalid = (prob < prob_threshold).all(axis=0)
    else:
        mask_invalid = prob < prob_threshold
    if geo_mask is not None:
        mask_invalid = mask_invalid | ~geo_mask
    return mask_invalid
