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
    package's eval_model_kwargs, depthmaps.py:23-75). cvp_mvsnet's depth
    is at full resolution.

    An explicit sweep_method wins; "auto" leaves the model's default
    (no "sweep_method" key), except for cvp_mvsnet, whose eval default is
    the rectified sweep "rect", as in the JAX package: an approximation
    of the exact sweep (ops/rect_sweep.py), announced by one printed
    note. vis_mvsnet with "rect" prints a note as well: its exact default
    "auto" is the per-architecture choice of the JAX package."""
    if architecture not in ("mvsnet", "mvsnet-s", "vis_mvsnet",
                            "cvp_mvsnet"):
        raise ValueError(f"unknown architecture: {architecture}")
    kwargs = {} if sweep_method == "auto" else {"sweep_method": sweep_method}
    if bf16:
        kwargs["dtype"] = torch.bfloat16
    if architecture == "cvp_mvsnet":
        if sweep_method == "auto":
            print("[wildmvs_torch] cvp_mvsnet eval sweep_method 'auto' -> "
                  "'rect' (the H_inf-factored sweep, an approximation of "
                  "the exact sweep; pass sweep_method='fused' or 'gather' "
                  "for the exact path)", flush=True)
            kwargs["sweep_method"] = "rect"
        return {"kwargs": kwargs, "downscale": 1}
    if architecture == "vis_mvsnet":
        if sweep_method == "rect":
            print("[wildmvs_torch] vis_mvsnet with sweep_method='rect' "
                  "serves the approximate rectified sweep; 'auto' (the "
                  "exact sweep) is its per-architecture default", flush=True)
        kwargs.update(depth_nums=(64, 32, 16),
                      interval_scales=(2.0, 1.0, 0.5))
        return {"kwargs": kwargs, "downscale": 2}
    return {"kwargs": kwargs, "downscale": 4}


def run_depthmaps(dataset, model: torch.nn.Module, out_dir: str | Path,
                  override: bool = False, debug: bool = False,
                  process_index: int = 0, process_count: int = 1,
                  cvp_nscale: int | None = None):
    """Run the eval forward for every reference view and cache npz outputs.

    `dataset` is anything with len() and [i] that yields the eval sample
    dict: imgs [N, H, W, 3] (or a list of per-view [Hi, Wi, 3]), K, R, t,
    depth_min, depth_max (numpy or tensors, no batch axis) and filename.
    The model runs on the device its parameters are on; `cvp_nscale`, if
    given, goes to the forward as `nscale` (cvp_mvsnet's pyramid levels).

    debug: stop after the first depthmap written. process_index /
    process_count: this process's shard of the views (view i when
    i % process_count == process_index); a sharded run does not write the
    finished.txt sentinel, so that a later unsharded pass checks every
    cached file and then marks the stage complete.
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
        if i % process_count != process_index:
            continue
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
        if debug:
            return
    if process_count == 1:
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
