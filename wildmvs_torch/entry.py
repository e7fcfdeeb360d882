"""Entry points: the flagship forward, and a dry run of every sharded mode
over n ranks.

Counterpart of the JAX package's __graft_entry__.py:

  entry()                  (forward, example_args): MVSNet, num_depth=32,
                           on a tiny synthetic batch
  dryrun_multichip(n)      the JAX dryrun's four phases over n ranks
                           (spawned processes, gloo): a data x hyp
                           supervised step, a view-parallel
                           occlusion-masked step, a Vis-MVSNet view x hyp
                           eval and a CVP-MVSNet hyp eval; one line each,
                           all finite

  python -m wildmvs_torch.entry 4 --device cpu

Both run on "cuda" unless device="cpu" is asked for; the dry run's ranks
share the cards round-robin.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .data.synthetic import SyntheticMVSDataset, collate
from .device import resolve_device
from .dist import mesh as M
from .dist.view_parallel import make_view_parallel_train_step
from .models import build_model
from .train import trainer as T
from .train.config import TrainConfig


def _tiny_batch(b, device, n=3, h=32, w=64):
    ds = SyntheticMVSDataset(num_samples=b, num_views=n, height=h, width=w,
                             seed=0)
    return T.batch_to_device(collate([ds[i] for i in range(b)]), device)


def _args(batch):
    return tuple(batch[k] for k in ("imgs", "K", "R", "t", "depth_min",
                                    "depth_max"))


def entry(device=None):
    """(forward, example_args): the eval forward of MVSNet (num_depth=32,
    seeded weights) returning the depth, and a one-sample 32x64 N3
    batch, on `device` ("cuda" unless "cpu")."""
    dev = resolve_device(device)
    model = build_model("mvsnet", device=dev, num_depth=32).eval()

    @torch.no_grad()
    def forward(imgs, K, R, t, depth_min, depth_max):
        return model(imgs, K, R, t, depth_min, depth_max)["depth"]

    return forward, _args(_tiny_batch(1, dev))


def _phases(n: int, device) -> list:
    """The dry run's phases on this rank; the lines to print."""
    lines = []
    head = f"dryrun_multichip({n})"

    # phase 1: data x hyp, the supervised data-parallel step (BatchNorm
    # synced over data) with the hypotheses over hyp: each rank keeps its
    # slab through the depth-partitioned regularizer, whose BatchNorm
    # normalizes over the data x hyp plane
    hyp = 2 if n % 2 == 0 and n > 1 else 1
    mesh = M.make_mesh(data=n // hyp, view=1, hyp=hyp)
    cfg = TrainConfig(architecture="mvsnet", dataset="synthetic",
                      supervised=True, num_depth=16,
                      hyp_axis="hyp" if hyp > 1 else None,
                      batch_size=mesh.shape["data"])
    state = T.create_train_state(cfg, device)
    batch = M.shard_batch(_tiny_batch(mesh.shape["data"], device), mesh)
    _, m = T.train_step(state, batch, cfg, mesh)
    loss = float(m["train_loss"])
    assert np.isfinite(loss), loss
    lines.append(f"{head} phase1: mesh={mesh.shape} supervised DP + "
                 f"depth-partitioned train_loss={loss:.4f} OK")

    # phase 2: data x view, the view-parallel occlusion-masked step
    if n % 4 == 0:
        mesh = M.make_mesh(data=n // 4, view=4, hyp=1)
        cfg = TrainConfig(architecture="mvsnet", dataset="synthetic",
                          supervised=False, occ_masking=True,
                          num_im_train=4, num_depth=8,
                          batch_size=mesh.shape["data"])
        state = T.create_train_state(cfg, device)
        batch = M.shard_batch(_tiny_batch(mesh.shape["data"], device, n=4),
                              mesh)
        _, m = make_view_parallel_train_step(mesh, cfg)(state, batch)
        loss = float(m["train_loss"])
        assert np.isfinite(loss), loss
        lines.append(f"{head} phase2: mesh={mesh.shape} view-parallel "
                     f"occ_masking train_loss={loss:.4f} OK")

    # phase 3: view x hyp, Vis-MVSNet eval with the source pairs over view
    # and each pair's volumes depth-partitioned over hyp
    if n % 2 == 0:
        mesh = M.make_mesh(data=1, view=2, hyp=n // 2)
        model = build_model("vis_mvsnet", device=device,
                            depth_nums=(8, 8, 8),
                            interval_scales=(4.0, 2.0, 1.0),
                            view_axis="view", hyp_axis="hyp").eval()
        with torch.no_grad(), M.use_mesh(mesh):
            depth = model(*_args(_tiny_batch(1, device)))["depth"]
        assert torch.isfinite(depth).all()
        lines.append(f"{head} phase3: mesh={mesh.shape} vis_mvsnet "
                     f"pair-sharded, depth-partitioned eval OK")

    # phase 4: CVP-MVSNet eval with the coarse level depth-partitioned over
    # hyp
    if n % 2 == 0:
        data = 2 if n % 4 == 0 else 1
        mesh = M.make_mesh(data=data, view=1, hyp=n // data)
        model = build_model("cvp_mvsnet", device=device, nscale=2,
                            hyp_axis="hyp").eval()
        with torch.no_grad(), M.use_mesh(mesh):
            depth = model(*_args(_tiny_batch(1, device)))["depth"]
        assert torch.isfinite(depth).all()
        lines.append(f"{head} phase4: mesh={mesh.shape} cvp_mvsnet "
                     f"depth-partitioned eval OK")
    return lines


def _dryrun_rank(rank, n, device_type):
    return _phases(n, torch.device("cuda", torch.cuda.current_device())
                   if device_type == "cuda" else torch.device("cpu"))


def dryrun_multichip(n: int, device=None) -> None:
    """Run the four phases over n spawned gloo ranks (on `device`, "cuda"
    unless "cpu"; ranks share the cards round-robin) and print rank 0's
    lines."""
    dev = resolve_device(device)
    if n == 1:
        lines = _phases(1, dev)
    else:
        lines = M.spawn(_dryrun_rank, n, n, dev.type, device=dev.type)[0]
    for line in lines:
        print(line, flush=True)

if __name__ == "__main__":
    p = argparse.ArgumentParser(description="dry run of the sharded modes")
    p.add_argument("n", type=int, nargs="?", default=4)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    dryrun_multichip(a.n, a.device)
