"""The reconstruction pipeline: depthmaps -> geometric filtering -> fusion ->
3D metrics.

Counterpart of wildmvs/pipeline/reconstruction.py (reference
reconstruction_pipeline.py and evaluation/pipeline_utils.py:30-80): stage
selection and file caching between stages, with the reference's external
fusion binaries replaced by the port's fusion on the device
(pipeline/fusion.py). Stages 1-3 run on the card unless the caller passes
device="cpu"; the metrics are numpy/scipy on the host.

Usage:
  python -m wildmvs_torch.pipeline.reconstruction --dataset synthetic \
      --debug --device cpu
  python -m wildmvs_torch.pipeline.reconstruction --dataset synthetic \
      --architecture oracle --compute_metrics
  python -m wildmvs_torch.pipeline.reconstruction --dataset synthetic \
      --classic --compute_metrics
  python -m wildmvs_torch.pipeline.reconstruction --dataset dtu \
      --data_path <root> --scene scan1 --model <checkpoint>

--dataset dtu reads <data_path>/<scene>/{pair.txt,images,cams}
(data/loaders.DTUEvalDataset), --dataset yfcc the COLMAP model
<data_path>/sparse/<scene> and <data_path>/images/<scene>
(YFCCSceneDataset).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..data.ply import ply_xyz, write_ply
from ..device import resolve_device
from ..models import build_model
from ..train.checkpoint import resolve_checkpoint
from ..train.jax_import import load_weights
from ..utils.monitor import StageTimer
from .classic import run_classic_depthmaps
from .depthmaps import eval_model_kwargs, get_mask_invalid, run_depthmaps
from .filtering import geometric_filter
from .fusion import fuse_depthmaps


def load_network(model_dir: str | Path | None, architecture: str | None,
                 sample: dict, dataset_name: str, sweep_method: str = "auto",
                 device: str | torch.device | None = None):
    """Build the eval network (eval_model_kwargs) and load its weights.

    Args:
      model_dir: a torch checkpoint file, a JAX `save_params_npz` file or
        orbax checkpoint directory, a logdir of them (the newest
        `model_*.ckpt` or `model_*/` is read), or None for seeded random
        weights (seed 0).
      architecture: used when the checkpoint names none.
      sample: an eval sample (its image sizes set cvp_mvsnet's levels).
      dataset_name: "dtu" evaluates cvp_mvsnet at 5 levels, others at 4.
    Returns:
      (model in eval mode, architecture, cvp_nscale or None).
    """
    dev = resolve_device(device)
    state_dict = None
    if model_dir is not None:
        state_dict, ckpt_arch = load_weights(resolve_checkpoint(model_dir))
        architecture = ckpt_arch or architecture
    if architecture is None:
        raise ValueError("need a checkpoint that names its architecture, or "
                         "an architecture")
    cfg = eval_model_kwargs(architecture, sweep_method=sweep_method)
    model = build_model(architecture, device=dev, **cfg["kwargs"])
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.eval()
    cvp_nscale = None
    if architecture == "cvp_mvsnet":
        # reference pipeline_utils.py:133-138 (5 on dtu, 4 elsewhere),
        # clamped so that the coarsest level keeps >= 32 px on its short
        # side: below that the one-pixel epipolar interval of
        # cal_depth_hypo degenerates (the JAX package's rule)
        base = 5 if dataset_name == "dtu" else 4
        imgs = sample["imgs"]
        views = imgs if isinstance(imgs, list) else [imgs[0]]
        ih = min(min(np.shape(v)[0], np.shape(v)[1]) for v in views)
        fit = max(1, int(np.floor(np.log2(max(ih // 32, 1)))) + 1)
        cvp_nscale = min(base, fit)
    return model, architecture, cvp_nscale


def _upsample_nearest(depth: np.ndarray, factor: int) -> np.ndarray:
    """Nearest-neighbour upsample by an integer factor (reference
    filtering.py:54-57, F.interpolate's default mode)."""
    return np.repeat(np.repeat(depth, factor, axis=0), factor, axis=1)


def run_pipeline(dataset, work_dir: Path, model_dir: str | None = None,
                 architecture: str = "mvsnet", dataset_name: str = "synthetic",
                 scene: str = "scene", do_filter: bool = True,
                 prob_threshold: float = 0.8, max_reproj_error: float = 1.0,
                 depth_threshold: float = 0.01, min_tri_angle: float = 1.0,
                 num_consistent: int = 3, fusion_disp_threshold: float = 0.01,
                 fusion_num_consistent: int = 3, override: bool = False,
                 debug: bool = False, compute_metrics: bool = False,
                 data_path: str | None = None, upsample: bool = False,
                 filter_num_views: int | None = None,
                 chunked_eval: bool = False,
                 fusion_max_reproj_error: float | None = None,
                 process_index: int = 0, process_count: int = 1,
                 sweep_method: str = "auto",
                 device: str | torch.device | None = None) -> dict:
    """Run the four stages over an eval dataset, caching each stage's
    files under work_dir (IntRes/depthmaps, IntRes/geometric_filtering,
    Points/<scene>.ply).

    architecture: a model's name, "classic" (the ZNCC plane sweep of
    pipeline/classic.py, at half resolution) or "oracle" (the samples' GT
    depths as the depthmaps: stages 2-4 without a network). override: recompute
    every stage, invalidating the downstream caches first. process_index /
    process_count > 1: this process's shard of stage 1 only (rerun
    unsharded to filter, fuse and evaluate from the caches). debug: one
    depthmap, one filtered view, then stop. Returns a dict with the
    point count, the PLY path, per-stage timings and the metrics.
    """
    dev = resolve_device(device)
    work_dir = Path(work_dir)
    depth_dir = work_dir / "IntRes" / "depthmaps" / scene
    filter_dir = work_dir / "IntRes" / "geometric_filtering" / scene
    points_dir = work_dir / "Points"
    timer = StageTimer(dev)
    sample0 = dataset[0]

    if override:
        # invalidate every downstream cache up front, so that a sharded
        # override rerun leaves no stale sentinel or PLY behind
        for stale in (depth_dir / "finished.txt",
                      filter_dir / "finished.txt",
                      points_dir / f"{scene}.ply"):
            stale.unlink(missing_ok=True)

    # ---- stage 1: depthmaps ----
    if architecture == "oracle":
        depth_dir.mkdir(parents=True, exist_ok=True)
        for i in range(len(dataset)):
            if i % process_count != process_index:
                continue
            s = dataset[i]
            name = s["filename"].replace("/", "_")
            f = depth_dir / f"{name}_out.npz"
            if not f.exists() or override:
                np.savez_compressed(f, depthmap=s["depth"],
                                    probability=np.ones_like(s["depth"]))
    elif architecture == "classic":
        # the non-learned ZNCC sweep (the reference's --colmap patch-match
        # role, reconstruction_pipeline.py:30-31)
        run_classic_depthmaps(dataset, depth_dir, override=override,
                              debug=debug, process_index=process_index,
                              process_count=process_count, device=dev)
    else:
        model, architecture, cvp_nscale = load_network(
            model_dir, architecture, sample0, dataset_name,
            sweep_method=sweep_method, device=dev)
        run_depthmaps(dataset, model, depth_dir, override=override,
                      debug=debug, process_index=process_index,
                      process_count=process_count, cvp_nscale=cvp_nscale)
        del model
    timer.mark("depthmaps")
    if process_count > 1:
        return {"scene": scene, "architecture": architecture,
                "stage1_shard": f"{process_index}/{process_count}",
                "stage_timings": timer.summary()}

    # ---- stage 2: geometric filtering ----
    results = {"scene": scene, "architecture": architecture}
    n = len(dataset)
    names = [dataset[i]["filename"].replace("/", "_") for i in range(n)]

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    if do_filter and (not (filter_dir / "finished.txt").exists() or override):
        filter_dir.mkdir(parents=True, exist_ok=True)
        # filtering may consider more source views than prediction did
        # (reference reconstruction_pipeline.py:36), never more than there
        # are depthmaps
        old_nviews = getattr(dataset, "nviews", None)
        if filter_num_views is not None and old_nviews is not None:
            dataset.nviews = min(filter_num_views, len(dataset))
            if getattr(dataset, "src_imgs", None) is not None:
                print("note: --filter_num_views has no effect on datasets "
                      "with precomputed source selection (reference parity)")
        for i in range(n):
            sample = dataset[i]
            ref_depth = np.load(depth_dir / f"{names[i]}_out.npz")["depthmap"]
            src_names = [s.replace("/", "_") for s in sample["src_filenames"]]
            rows = list(range(len(src_names) + 1))
            if debug:
                # debug stage 1 wrote only the first depthmap(s): filter
                # against what exists
                keep = [j for j, s in enumerate(src_names)
                        if (depth_dir / f"{s}_out.npz").exists()]
                if not keep:
                    break
                src_names = [src_names[j] for j in keep]
                rows = [0] + [j + 1 for j in keep]
            sample_K, sample_R, sample_t = (sample["K"][rows],
                                            sample["R"][rows],
                                            sample["t"][rows])
            src_depths = [np.load(depth_dir / f"{s}_out.npz")["depthmap"]
                          for s in src_names]
            img_h = [sample["imgs"][v].shape[0] for v in rows]
            if upsample:
                # filter at full image resolution, each view by its own
                # factor (reference filtering.py:51-57)
                factor = img_h[0] // ref_depth.shape[0]
                if factor > 1:
                    ref_depth = _upsample_nearest(ref_depth, factor)
                src_depths = [
                    _upsample_nearest(d, img_h[k + 1] // d.shape[0])
                    if img_h[k + 1] // d.shape[0] > 1 else d
                    for k, d in enumerate(src_depths)]
            # each view's camera at its own depthmap's resolution
            K = sample_K.copy()
            K[0, :2] *= ref_depth.shape[0] / img_h[0]
            for k, d in enumerate(src_depths):
                K[k + 1, :2] *= d.shape[0] / img_h[k + 1]
            masks = geometric_filter(
                tensor(ref_depth), [tensor(d) for d in src_depths],
                tensor(K), tensor(sample_R), tensor(sample_t),
                max_reproj_error=max_reproj_error,
                depth_threshold=depth_threshold,
                min_tri_angle=min_tri_angle, num_consistent=num_consistent)
            np.savez_compressed(
                filter_dir / f"{names[i]}_out.npz",
                **{k: v.cpu().numpy() for k, v in masks.items()})
            if debug:
                break
        if old_nviews is not None:
            dataset.nviews = old_nviews
        if not debug:
            (filter_dir / "finished.txt").write_text(" ")
    timer.mark("filtering")
    if debug:
        results["stage_timings"] = timer.summary()
        return results

    # ---- stage 3: fusion ----
    points_dir.mkdir(parents=True, exist_ok=True)
    ply_path = points_dir / f"{scene}.ply"
    if not ply_path.exists() or override:
        depths, colors, Ks, Rs, ts = [], [], [], [], []
        for i in range(n):
            sample = dataset[i]
            npz = np.load(depth_dir / f"{names[i]}_out.npz")
            depth = npz["depthmap"].copy()
            prob = npz["probability"]
            if upsample:
                # fuse at full resolution (reference colmap_utils.py:363)
                factor = sample["imgs"][0].shape[0] // depth.shape[0]
                if factor > 1:
                    depth = _upsample_nearest(depth, factor)
                    prob = (np.stack([_upsample_nearest(p, factor)
                                      for p in prob]) if prob.ndim > 2
                            else _upsample_nearest(prob, factor))
            geo = None
            if do_filter:
                geo = np.load(filter_dir / f"{names[i]}_out.npz")["geo_mask"]
                if geo.shape != depth.shape:
                    geo = _upsample_nearest(geo,
                                            depth.shape[0] // geo.shape[0])
            depth[get_mask_invalid(prob, prob_threshold, geo)] = 0.0
            depths.append(depth)
            img = sample["imgs"][0]
            K = sample["K"][0].copy()
            K[:2] *= depth.shape[0] / img.shape[0]
            Ks.append(K)
            Rs.append(sample["R"][0])
            ts.append(sample["t"][0])
            step = max(img.shape[0] // depth.shape[0], 1)
            colors.append(img[::step, ::step][:depth.shape[0],
                                              :depth.shape[1]])
        points, cols = fuse_depthmaps(
            depths, np.stack(Ks), np.stack(Rs), np.stack(ts), colors=colors,
            disp_threshold=fusion_disp_threshold,
            num_consistent=fusion_num_consistent,
            max_reproj_error=fusion_max_reproj_error, device=dev)
        write_ply(ply_path, points, colors=cols)
        results["num_points"] = int(points.shape[0])
    else:
        results["num_points"] = int(ply_xyz(ply_path).shape[0])
    results["ply"] = str(ply_path)
    timer.mark("fusion")

    # ---- stage 4: metrics ----
    if compute_metrics:
        from . import metrics3d
        pred = ply_xyz(ply_path)
        if dataset_name == "dtu":
            gt, mask, bb, res, plane = metrics3d.load_dtu_gt(data_path, scene)
            raw = metrics3d.eval_dtu(pred, gt, mask, bb, float(res), plane,
                                     chunked=chunked_eval)
            metrics3d.save_raw(work_dir / "IntRes" / "chamfer", scene, raw)
            results["metrics"] = metrics3d.summarize_dtu(raw)
        elif hasattr(dataset, "gt_points"):
            res = getattr(dataset, "gt_resolution", 1.0)
            raw = metrics3d.eval_yfcc(pred, dataset.gt_points, res)
            results["metrics"] = {
                "chamfer_pred_to_gt": float(np.mean(np.minimum(
                    raw["dist_predToGt"], 10 * res))),
                "chamfer_gt_to_pred": float(np.mean(np.minimum(
                    raw["dist_gtToPred"], 10 * res))),
            }
        timer.mark("metrics")
    results["stage_timings"] = timer.summary()
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description="wildmvs_torch 3D reconstruction")
    p.add_argument("--dataset", default="synthetic",
                   choices=["dtu", "yfcc", "synthetic"])
    p.add_argument("--scene", default="scene")
    p.add_argument("--model", default=None,
                   help="a checkpoint file or directory, or a JAX npz")
    p.add_argument("--architecture", default="mvsnet",
                   help="model architecture, 'classic' (the ZNCC sweep) or "
                        "'oracle' (GT depths)")
    p.add_argument("--sweep_method", default="auto",
                   choices=["auto", "rect", "gather", "fused"],
                   help="cost-volume backend ('auto': each architecture's "
                        "eval default, the rectified sweep for cvp_mvsnet)")
    p.add_argument("--classic", action="store_true",
                   help="the classic ZNCC plane sweep instead of a network "
                        "(the reference's --colmap baseline)")
    p.add_argument("--data_path", default=None)
    p.add_argument("--work_dir", default="recon_out")
    p.add_argument("--nviews", type=int, default=5,
                   help="views per depthmap prediction")
    p.add_argument("--upsample", action="store_true",
                   help="upsample depthmaps to full resolution before "
                        "filtering and fusion")
    p.add_argument("--filter", action="store_true", default=True)
    p.add_argument("--no_filter", dest="filter", action="store_false")
    p.add_argument("--prob_threshold", type=float, default=0.8)
    p.add_argument("--max_reproj_error", type=float, default=1.0)
    p.add_argument("--depth_threshold", type=float, default=0.01)
    p.add_argument("--min_tri_angle", type=float, default=1.0)
    p.add_argument("--num_consistent", type=int, default=3)
    p.add_argument("--filter_num_views", type=int, default=10,
                   help="views considered while filtering")
    p.add_argument("--fusion", default="native",
                   choices=["native", "fusibile", "colmap", "simple"],
                   help="all run the port's fusion; 'colmap' also applies "
                        "the reprojection-error gate")
    p.add_argument("--fusion_depth_threshold", type=float, default=0.01)
    p.add_argument("--fusion_num_consistent", type=int, default=3)
    p.add_argument("--fusion_max_reproj_error", type=float, default=None,
                   help="max back-projection error in px (COLMAP fusion; "
                        "default off)")
    p.add_argument("--compute_metrics", action="store_true")
    p.add_argument("--chunked_eval", action="store_true",
                   help="slower, low-memory DTU metric evaluation")
    p.add_argument("--override", action="store_true")
    p.add_argument("--process_index", type=int, default=0,
                   help="this process's shard of the depthmap stage")
    p.add_argument("--process_count", type=int, default=1,
                   help="processes sharding the depthmap stage; when > 1 "
                        "the run stops after stage 1")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    a = p.parse_args(argv)
    if a.classic:
        if a.model is not None:
            p.error("cannot use both a model and --classic")
        a.architecture = "classic"
    if a.fusion == "colmap" and a.fusion_max_reproj_error is None:
        a.fusion_max_reproj_error = 1.0       # COLMAP fusion's default
    if a.dataset == "synthetic":
        from ..data.synthetic import SyntheticSceneDataset
        dataset = SyntheticSceneDataset(num_views=a.nviews, height=64,
                                        width=96)
    else:
        from ..data import loaders
        dataset = loaders.build_eval_dataset(a.dataset, a.data_path, a.scene,
                                             nviews=a.nviews)
    results = run_pipeline(
        dataset, Path(a.work_dir), model_dir=a.model,
        architecture=a.architecture, dataset_name=a.dataset, scene=a.scene,
        do_filter=a.filter, prob_threshold=a.prob_threshold,
        max_reproj_error=a.max_reproj_error,
        depth_threshold=a.depth_threshold, min_tri_angle=a.min_tri_angle,
        num_consistent=a.num_consistent,
        fusion_disp_threshold=a.fusion_depth_threshold,
        fusion_num_consistent=a.fusion_num_consistent,
        override=a.override, debug=a.debug,
        compute_metrics=a.compute_metrics, data_path=a.data_path,
        upsample=a.upsample, filter_num_views=a.filter_num_views,
        chunked_eval=a.chunked_eval,
        fusion_max_reproj_error=a.fusion_max_reproj_error,
        process_index=a.process_index, process_count=a.process_count,
        sweep_method=a.sweep_method, device=a.device)
    print(json.dumps(results, default=str))
    return results


if __name__ == "__main__":
    main()
