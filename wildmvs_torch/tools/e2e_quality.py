"""End-to-end quality drive: networks trained by the port's CLI,
reconstructing a held-out scene through all four pipeline stages.

Counterpart of tools/e2e_quality.py:
  1. trains each architecture on the synthetic dataset with the real
     training CLI in a subprocess, as a user would (`python -m
     wildmvs_torch.train.cli --dataset synthetic --supervised ...`), which
     writes its checkpoints to a logdir;
  2. reconstructs a held-out rendered 5-view scene (64x96, scene seed 0)
     through pipeline/reconstruction.run_pipeline from that logdir (the
     architecture read from the checkpoint): depthmaps -> geometric filter
     -> fusion -> PLY;
  3. scores the fused cloud's chamfer accuracy (pred -> GT) and
     completeness (GT -> pred) against the GT surface points, as
     fusion_sensitivity.py does, so a network's row compares with the
     oracle-depth noise ladder; and the stage-1 depth EPE (intervals of
     (max - min) / 128) and the median confidence from the depthmap files;
  4. an `oracle` row (the GT depths through stages 2-4) gives the
     pipeline's ceiling on this scene.

  python -m wildmvs_torch.tools.e2e_quality --epochs 40 \
      --prob_threshold 0.05                       # on the card
  python -m wildmvs_torch.tools.e2e_quality --device cpu --epochs 1 \
      --archs oracle,mvsnet --prob_threshold 0.05

Prints one JSON row per architecture and threshold, with the JAX tool's
keys (arch, num_points, interval, depth_epe_itv, conf_median, acc, comp,
prob_threshold, train_s), then a summary line. A failing architecture
gives an `error` row and the others go on, as in the JAX tool.
The trainings run at once, each a process (the JAX tool trains one
after another): on one card they share it, and train_s is each one's
wall time among the others. `--workdir DIR` keeps the logdirs (`DIR/train_<arch>`) and the pipeline's files; by default they go
to a temporary directory that is removed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..data.ply import ply_xyz
from ..data.synthetic import SyntheticSceneDataset
from ..device import resolve_device
from ..pipeline.metrics3d import chamfer_nn
from ..pipeline.reconstruction import run_pipeline
from .fusion_sensitivity import gt_points

REPO = Path(__file__).resolve().parents[2]

#: the JAX tool's supervised recipes on the synthetic set
TRAIN_ARGS = {
    "mvsnet": ["--num_depth", "48", "--lr", "3e-3"],
    "vis_mvsnet": ["--lr", "1e-3"],
    "cvp_mvsnet": ["--lr", "1e-3"],
}
ARCHS = ("oracle", "mvsnet", "vis_mvsnet", "cvp_mvsnet")
#: the held-out scene
SCENE = dict(num_views=5, height=64, width=96, seed=0)
#: fusion at the sensitivity study's high-noise optimum (BASELINE.md's
#: round-3 table): a briefly trained net sits in that noise regime, and
#: the DTU defaults (0.01 / 3), tuned for converged networks, gate nearly
#: every point here
FUSION = dict(fusion_disp_threshold=0.04, fusion_num_consistent=2)


def train_arch(arch: str, logdir: Path, epochs: int, device) -> float:
    """Train `arch` with the port's CLI in a subprocess on `device`;
    returns its wall seconds."""
    t0 = time.time()
    dev = resolve_device(device)
    cmd = [sys.executable, "-m", "wildmvs_torch.train.cli", "--dataset",
           "synthetic", "--architecture", arch, "--supervised", "--epochs",
           str(epochs), "--logdir", str(logdir), "--device", dev.type,
           "--print_every", "100"] + TRAIN_ARGS[arch]
    r = subprocess.run(cmd, cwd=REPO, env=dict(os.environ),
                       capture_output=True, text=True, timeout=7200)
    if r.returncode != 0:
        raise RuntimeError(f"train {arch} rc={r.returncode}\n"
                           f"{r.stderr[-2000:]}")
    return time.time() - t0


def depth_scores(scene, depth_dir: Path, interval: float) -> dict:
    """The stage-1 depth EPE in intervals on the GT's valid range and the
    median confidence, each averaged over the views' npz files (the
    depthmaps at the network's output resolution, the GT subsampled to
    it)."""
    epes, confs = [], []
    for i in range(len(scene)):
        s = scene[i]
        f = depth_dir / f"{s['filename'].replace('/', '_')}_out.npz"
        if not f.exists():
            continue
        z = np.load(f)
        d = z["depthmap"]
        gt_d = s["depth"]
        if d.shape != gt_d.shape:
            r = gt_d.shape[0] // d.shape[0]
            gt_d = gt_d[::r, ::r][:d.shape[0], :d.shape[1]]
        m = (gt_d > scene.z_range[0]) & (gt_d < scene.z_range[1])
        epes.append(float(np.abs(d - gt_d)[m].mean() / interval))
        confs.append(float(np.median(z["probability"])))
    if not epes:
        return {}
    return {"depth_epe_itv": round(float(np.mean(epes)), 2),
            "conf_median": round(float(np.mean(confs)), 3)}


def reconstruct_and_score(arch: str, model_dir, work_dir: Path,
                          prob_threshold: float, device=None) -> dict:
    """The four stages from `model_dir` (a logdir, or None for the
    oracle) on the held-out scene, scored as the JAX tool scores them."""
    scene = SyntheticSceneDataset(**SCENE)
    res = run_pipeline(scene, work_dir, model_dir=model_dir,
                       architecture=arch, dataset_name="synthetic",
                       scene=f"e2e_{arch}", prob_threshold=prob_threshold,
                       upsample=True, override=True, device=device, **FUSION)
    pred = ply_xyz(Path(res["ply"]))
    gt = gt_points(scene)
    interval = (scene.z_range[1] - scene.z_range[0]) / 128.0
    row = {"arch": arch, "num_points": res["num_points"],
           "interval": round(interval, 4)}
    if arch != "oracle":
        row.update(depth_scores(
            scene, Path(work_dir) / "IntRes" / "depthmaps" / f"e2e_{arch}",
            interval))
    if len(pred) >= 10:
        row["acc"] = round(float(np.mean(chamfer_nn(pred, gt))), 5)
        row["comp"] = round(float(np.mean(chamfer_nn(gt, pred))), 5)
    else:
        row["acc"] = row["comp"] = None
    return row


def run(archs, epochs: int, thresholds, root: Path, device) -> list:
    """Train every architecture under `root`, all at once, and score each,
    in `archs` order, once it has trained; returns the rows (printed as
    they come)."""
    rows = []
    nets = [a for a in archs if a != "oracle"]
    with ThreadPoolExecutor(max_workers=max(len(nets), 1)) as pool:
        training = {a: pool.submit(train_arch, a, root / f"train_{a}",
                                   epochs, device) for a in nets}
        for arch in archs:
            logdir = None
            train_s = None
            if arch != "oracle":
                try:
                    logdir = root / f"train_{arch}"
                    train_s = training[arch].result()
                except Exception as e:
                    row = {"arch": arch, "error": str(e)[:500]}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
                    continue
            rows += score(arch, logdir, train_s, thresholds, root, device)
    return rows


def score(arch: str, logdir, train_s, thresholds, root: Path,
          device) -> list:
    """One architecture's rows, one a threshold (printed as they come)."""
    rows = []
    for thr in thresholds:
        try:
            row = reconstruct_and_score(
                arch, str(logdir) if logdir else None,
                root / f"work_{thr}", thr, device=device)
            row["prob_threshold"] = thr
            if train_s is not None:
                row["train_s"] = round(train_s, 1)
        except Exception as e:          # keep the other rows on one failure
            row = {"arch": arch, "prob_threshold": thr,
                   "error": str(e)[:500]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--prob_threshold", default="0.8",
                   help="comma list: each net is trained once and scored "
                        "at every threshold (the confidence gate is the "
                        "dominant knob for briefly trained nets)")
    p.add_argument("--archs", default=",".join(ARCHS))
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu: the training "
                        "subprocess and the pipeline run there")
    p.add_argument("--workdir", default=None,
                   help="keep the logdirs and the pipeline's files here "
                        "(default: a temporary directory, removed)")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    thresholds = [float(x) for x in str(a.prob_threshold).split(",")]
    archs = a.archs.split(",")
    if a.workdir is not None:
        root = Path(a.workdir)
        root.mkdir(parents=True, exist_ok=True)
        rows = run(archs, a.epochs, thresholds, root, dev)
    else:
        with tempfile.TemporaryDirectory() as td:
            rows = run(archs, a.epochs, thresholds, Path(td), dev)
    print(json.dumps({"e2e_quality": rows, "epochs": a.epochs,
                      "prob_thresholds": thresholds}), flush=True)
    return rows


if __name__ == "__main__":
    main()
