"""The depthmap benchmark CLI: EPE / 1 px / 3 px on YFCC or BlendedMVS.

Counterpart of wildmvs/pipeline/depthmap_eval.py (reference
depthmap_eval.py:70-171): per-sample metrics with estimate and GT both
divided by (depth_max - depth_min) / 128, the estimate bilinearly resized
to the GT resolution, averaged over the dataset and written as JSON to
<out_dir>/<dataset>_depthmaps/<model>_<nb_imgs>.json. A sharded run
(view i when i % process_count == process_index) writes
`<model>_<nb_imgs>.part<i>.json`; `--merge` combines the parts. The file
names and the part layout are the JAX package's, so either CLI merges the
other's parts.

Usage:
  python -m wildmvs_torch.pipeline.depthmap_eval --dataset synthetic \
      --device cpu
  python -m wildmvs_torch.pipeline.depthmap_eval --dataset yfcc \
      --data_path <root> --model <checkpoint>
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..losses.supervised import resize_bilinear
from ..train.metrics import depth_metrics
from .reconstruction import load_network

YFCC_SCENES = [
    "trevi_fountain", "sacre_coeur", "taj_mahal", "buckingham_palace",
    "palace_of_westminster", "brandenburg_gate", "st_peters_square",
    "hagia_sophia_interior", "pantheon_exterior", "temple_nara_japan",
    "colosseum_exterior", "notre_dame_front_facade",
    "prague_old_town_square", "westminster_abbey", "grand_place_brussels",
]


def _debug_visu(sample, est_up, out_dir):
    """--debug panels (reference depthmap_eval.py:55-67, :112-130): the
    reference and source images, predicted and GT depth, the GT mask and
    the error in intervals (/3, clipped) as jpgs under out_dir/visu."""
    from ..utils.monitor import Logger
    logger = Logger(Path(out_dir) / "visu")
    n = len(sample["imgs"])
    ims = {"im_ref": np.asarray(sample["imgs"][0])}
    for i in range(1, n):
        ims[f"im_src_{i - 1}"] = np.asarray(sample["imgs"][i])
    logger.plot_ims(ims)
    vmin = float(sample["depth_min"][0])
    vmax = float(sample["depth_max"][0])
    logger.depth_panel(est_up, vmin, vmax, name="pred")
    logger.depth_panel(np.asarray(sample["depth"]), vmin, vmax, name="gt")
    logger.plot_ims({"mask_gt": np.asarray(sample["mask"])})
    step = (vmax - vmin) / 128.0
    diff = np.abs(np.asarray(est_up) - np.asarray(sample["depth"])) / step
    logger.plot_ims({"diff": np.clip(diff / 3.0, 0, 1)})


def evaluate(dataset, model: torch.nn.Module, cvp_nscale: int | None = None,
             process_index: int = 0, process_count: int = 1,
             debug: bool = False, out_dir=None) -> dict:
    """Mean EPE / 1pxError / 3pxError over this process's samples, with
    their `count` and the wall-clock `seconds`. The model runs in eval
    mode on the device of its parameters."""
    device = next(model.parameters()).device
    model.eval()
    extra = {} if cvp_nscale is None else {"nscale": cvp_nscale}

    def batch1(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)[None]

    sums = {}
    count = 0
    t0 = time.time()
    for i in range(len(dataset)):
        if i % process_count != process_index:
            continue
        s = dataset[i]
        imgs = s["imgs"]
        imgs = ([batch1(v) for v in imgs] if isinstance(imgs, list)
                else batch1(imgs))
        args = [batch1(s[k]) for k in
                ("K", "R", "t", "depth_min", "depth_max")]
        with torch.inference_mode():
            depth = model(imgs, *args, **extra)["depth"].float()
            gt, mask = batch1(s["depth"]), batch1(s["mask"])
            est = resize_bilinear(depth, tuple(gt.shape[1:3]))
            m = depth_metrics(est, gt, mask, args[3][:, 0], args[4][:, 0])
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        count += 1
        if debug:
            if out_dir is not None:
                _debug_visu(s, est[0].cpu().numpy(), out_dir)
            break
    return {**{k: v / max(count, 1) for k, v in sums.items()},
            "count": count, "seconds": time.time() - t0}


def merge_parts(base: Path) -> dict:
    """Combine `{base}.part{i}.json` shard results into `{base}.json`:
    count-weighted means (the reference's dist.reduce(SUM) over
    len(dataset), depthmap_eval.py:155-164), the slowest part's seconds."""
    base = Path(base)
    parts = sorted(base.parent.glob(base.name + ".part*.json"))
    if not parts:
        raise FileNotFoundError(f"no {base.name}.part*.json in {base.parent}")
    # a missing part would bias the benchmark silently: the shard indices
    # must be 0..N-1
    idxs = sorted(int(p.name[len(base.name) + 5:-5]) for p in parts)
    if idxs != list(range(len(idxs))) or idxs[-1] != len(parts) - 1:
        raise ValueError(f"incomplete shard set {idxs}: expected parts "
                         f"0..{idxs[-1]}; rerun the missing processes")
    sums, count, seconds = {}, 0, 0.0
    for p in parts:
        r = json.loads(p.read_text())
        for k, v in r.items():
            if k == "count":
                count += r["count"]
            elif k == "seconds":
                seconds = max(seconds, r["seconds"])  # parts ran at once
            else:
                sums[k] = sums.get(k, 0.0) + v * r["count"]
    res = {**{k: v / max(count, 1) for k, v in sums.items()},
           "count": count, "seconds": seconds, "merged_parts": len(parts)}
    # base.name + ".json", not with_suffix: a dotted model name
    # ("vis.bf16_5") must not lose its tail
    with open(base.parent / (base.name + ".json"), "w") as f:
        json.dump(res, f)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description="wildmvs_torch depthmap "
                                            "benchmark")
    p.add_argument("--merge", default=None, metavar="BASE",
                   help="merge BASE.part*.json shard results into BASE.json "
                        "and exit (e.g. results/yfcc_depthmaps/model_5)")
    p.add_argument("--dataset", default="yfcc",
                   choices=["yfcc", "blended", "synthetic"])
    p.add_argument("--model", default=None,
                   help="a checkpoint file or directory, or a JAX npz")
    p.add_argument("--architecture", default="mvsnet")
    p.add_argument("--data_path", default=None)
    p.add_argument("--nb_imgs", type=int, default=5)
    p.add_argument("--out_dir", default="results")
    p.add_argument("--process_index", type=int, default=0,
                   help="this process's shard of the samples")
    p.add_argument("--process_count", type=int, default=1,
                   help="processes sharding the samples")
    p.add_argument("--sweep_method", default="auto",
                   choices=["auto", "rect", "gather", "fused"],
                   help="cost-volume backend ('auto': each architecture's "
                        "eval default)")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    if a.merge:
        res = merge_parts(Path(a.merge))
        print(json.dumps(res))
        return res

    if a.dataset == "blended":
        from ..data.loaders import BlendedMVSDataset, scene_list
        root = a.data_path or "datasets/blended"
        dataset = BlendedMVSDataset(root, scene_list("blended_val"), "test",
                                    a.nb_imgs)
    elif a.dataset == "yfcc":
        from ..data.loaders import MegaDepthDataset
        root = a.data_path or "datasets/yfcc_depthmaps"
        dataset = MegaDepthDataset(root, YFCC_SCENES, "test", a.nb_imgs)
    else:
        from ..data.synthetic import SyntheticMVSDataset
        dataset = SyntheticMVSDataset(num_samples=4, num_views=a.nb_imgs,
                                      height=64, width=96, seed=7)

    model, architecture, cvp_nscale = load_network(
        a.model, a.architecture, dataset[0], a.dataset,
        sweep_method=a.sweep_method, device=a.device)
    out = Path(a.out_dir) / f"{a.dataset}_depthmaps"
    res = evaluate(dataset, model, cvp_nscale,
                   process_index=a.process_index,
                   process_count=a.process_count, debug=a.debug,
                   out_dir=out)
    name = Path(a.model).name if a.model else architecture
    out.mkdir(parents=True, exist_ok=True)
    suffix = (f"_{a.nb_imgs}" if a.process_count == 1
              else f"_{a.nb_imgs}.part{a.process_index}")
    with open(out / f"{name}{suffix}.json", "w") as f:
        json.dump(res, f)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
