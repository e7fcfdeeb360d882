"""Training CLI: the epoch loop, on one card or over torch.distributed.

Counterpart of wildmvs/train/cli.py:51-340 (reference train.py:64-252) for
MVSNet, Vis-MVSNet and CVP-MVSNet, supervised or unsupervised
(photometric, optionally occlusion-masked), on DTU, MegaDepth, BlendedMVS
(data/loaders.py) or the synthetic dataset:

  python -m wildmvs_torch.train.cli --dataset synthetic --num_depth 16 --debug
  python -m wildmvs_torch.train.cli --device cpu --dataset synthetic \
      --num_depth 16 --debug
  python -m wildmvs_torch.train.cli --device cpu --dataset synthetic \
      --architecture vis_mvsnet --unsupervised --occ_masking --debug
  python -m wildmvs_torch.train.cli --dataset md --data_path <root> \
      --unsupervised --occ_masking --bf16 --world_size 3
  python -m wildmvs_torch.train.cli --device cpu --world_size 2 \
      --dist_backend gloo --num_depth 16 --batch_size 2 --debug

Runs on "cuda" unless `--device cpu` is given. `--world_size N` starts N
ranks (torch.multiprocessing, rank r on cuda:r, or on the CPU), or joins
the ranks that `torchrun` started (RANK, WORLD_SIZE, LOCAL_RANK, and
MASTER_ADDR/MASTER_PORT in the environment): under occlusion masking one
mesh (data 1, view N) spreads the reference views over the ranks
(dist/view_parallel.py; num_im_train % N == 0); otherwise the batch splits
over (data N) with BatchNorm synced over it (batch_size % N == 0; each
rank loads its rows, dist/mesh.process_local_order). `--dist_backend`
is nccl on the card and gloo on the CPU by default; with fewer cards
than ranks only gloo runs, the ranks sharing the cards round-robin. Only
rank 0 logs and writes checkpoints; validation and testing split the
samples over the ranks and average them. `--trace` writes a
torch.profiler trace of the run (utils/monitor.profiler_trace).

Samples are loaded by
`--num_workers` threads ahead of the step (0: in line). Each epoch trains
(every `--print_every` steps it prints the running means and writes the
training images, utils/monitor.training_panels, and the predicted depth as
jpgs to the logdir), writes `<logdir>/model_{epoch:06d}.ckpt` every
`--save_freq` epochs, then runs the validation loss and the test metrics;
scalar logs go to `<logdir>/logs.txt`. `--remat` recomputes the forward's
activations in the backward (train/trainer.forward).
"""
from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..data.prefetch import iterate_batches
from ..data.synthetic import SyntheticMVSDataset, collate
from ..device import resolve_device
from ..dist.mesh import (all_reduce, initialize, make_mesh,
                         process_local_order, replicate, spawn, world)
from ..utils.monitor import Logger, MeterSet, profiler_trace, training_panels
from . import trainer as T
from .checkpoint import (latest_checkpoint, load_model_weights,
                         restore_checkpoint, save_checkpoint)
from .config import TrainConfig

#: the test metrics (train/metrics.depth_metrics), in the order the ranks
#: add them
METRIC_KEYS = ("EPE", "1pxError", "3pxError")


def build_datasets(config: TrainConfig):
    """(train, val, test) datasets (reference train.py:67-104)."""
    if config.dataset == "synthetic":
        n = config.num_im_train
        return (SyntheticMVSDataset(num_samples=8, num_views=n, seed=1),
                SyntheticMVSDataset(num_samples=2, num_views=n, seed=2),
                SyntheticMVSDataset(num_samples=2, num_views=n, seed=3))
    from ..data import loaders
    return loaders.build_datasets(config)


def batches(dataset, batch_size: int, order, device, num_workers: int = 0):
    """Collated batches of `dataset` in `order` (the last one partial),
    loaded by `num_workers` threads ahead of the step, as tensors on
    `device`."""
    for b in iterate_batches(dataset, order, batch_size, collate,
                             num_workers=num_workers):
        yield T.batch_to_device(b, device)


def training_mesh(config: TrainConfig, size: int):
    """The mesh of a run over `size` ranks (the JAX package's
    make_mesh_step, cli.py:51-95): the reference views over `view` under
    occlusion masking, else the batch over `data`."""
    if T._occ_masked(config):
        assert config.num_im_train % size == 0, (
            "occ_masking needs num_im_train % world_size == 0 "
            f"(got {config.num_im_train} vs {size}); parity train.py:311")
        return make_mesh(data=1, view=size)
    assert config.batch_size % size == 0, (
        f"batch_size {config.batch_size} is not a multiple of world_size "
        f"{size}")
    return make_mesh(data=size)


def run(config: TrainConfig, max_epochs: int | None = None,
        resume: bool = False, loadckpt: str | None = None,
        device=None) -> dict:
    """Train `config`; returns {"train_loss", "val_loss", "test"} per
    epoch. `device` is "cuda" (default; raises without a card) or "cpu".
    Inside a torch.distributed process group of several ranks, every rank
    calls it: the run is data- or view-parallel (`training_mesh`)."""
    if resume and loadckpt:
        raise ValueError("--resume and --loadckpt are exclusive "
                         "(reference train.py:298-299)")
    dev = resolve_device(device)
    size, rank = world()
    train_ds, val_ds, test_ds = build_datasets(config)
    if len(train_ds) == 0:
        raise ValueError("the training dataset is empty: check --data_path")
    state = T.create_train_state(config, dev)

    logdir = Path(config.logdir)
    start_epoch = 0
    if loadckpt:
        load_model_weights(loadckpt, state.model)
        print(f"warm-started from {loadckpt}")
    if resume and (ckpt := latest_checkpoint(logdir)) is not None:
        start_epoch = restore_checkpoint(ckpt, state) + 1
        print(f"resumed from {ckpt} at epoch {start_epoch}")

    data_sharded = not T._occ_masked(config)
    mesh = training_mesh(config, size) if size > 1 else None
    if mesh is not None:
        replicate(state.model, mesh)

    def step(state, batch):
        return T.train_step(state, batch, config, mesh)

    logger = Logger(logdir) if rank == 0 else None
    meters = MeterSet()
    history = {"train_loss": [], "val_loss": [], "test": []}
    end_epoch = max_epochs if max_epochs is not None else config.epochs
    for epoch in range(start_epoch, end_epoch):
        T.set_epoch_lr(state, config, epoch)
        # the epoch-seeded permutation of the JAX package's loop; each rank
        # loads its rows of every batch (all of it under occ_masking)
        order = np.random.default_rng(config.seed * 1000 + epoch).permutation(
            len(train_ds))
        local_bs = config.batch_size
        if size > 1 and data_sharded:
            order, local_bs = process_local_order(order, config.batch_size)
        t0 = time.time()
        ep_losses = []
        for i, batch in enumerate(batches(train_ds, local_bs, order, dev,
                                          config.num_workers)):
            state, m = step(state, batch)
            depth_est = m.pop("depth_est")
            ep_losses.append(float(m["train_loss"]))
            meters.update(m)
            if (i + 1) % config.print_every == 0 and logger is not None:
                print(f"  iter {i + 1}: {meters.means()}")
                # the training images and the depth-warped sources
                # (reference models/trainer.py:78-92, :258-276)
                logger.plot_ims(training_panels(batch, depth_est),
                                prefix=f"e{epoch}_")
                logger.depth_panel(depth_est[0].float().cpu().numpy(),
                                   float(batch["depth_min"][0, 0]),
                                   float(batch["depth_max"][0, 0]),
                                   name=f"e{epoch}_depth_est")
            if config.debug:
                break
        history["train_loss"].append(float(np.mean(ep_losses)))
        means = meters.reset()
        if logger is not None:
            logger.log({"epoch": epoch, **means,
                        "lr": config.lr_at_epoch(epoch),
                        "seconds": round(time.time() - t0, 2)})
            print(f"epoch {epoch}: train_loss="
                  f"{history['train_loss'][-1]:.4f} "
                  f"({time.time() - t0:.1f}s)")

        if epoch % config.save_freq == 0:
            if rank == 0:
                save_checkpoint(logdir, epoch, state, config.architecture)
            val_loss, avg = evaluate(state, config, val_ds, test_ds, dev,
                                     mesh)
            history["val_loss"].append(val_loss)
            history["test"].append(avg)
            if logger is not None:
                logger.log({"epoch": epoch, "val_loss": val_loss, **avg})
                print(f"  val_loss={val_loss:.4f} test={avg}")
        if config.debug:
            break
    return history


def evaluate(state, config: TrainConfig, val_ds, test_ds, dev, mesh=None):
    """(validation loss, {test metric: mean}) over the datasets; over a
    mesh each rank takes samples rank::size and the sums and counts are
    added over the ranks (the JAX package's process_allgather, the
    reference's all_reduce / world_size, utils/trainer.py:25-35)."""
    size, rank = (1, 0) if mesh is None else (mesh.size,
                                              mesh.index("all"))
    v_losses = []
    for batch in batches(val_ds, config.batch_size,
                         np.arange(len(val_ds))[rank::size], dev,
                         config.num_workers):
        v_losses.append(float(T.eval_step(state, batch, config)["val_loss"]))
        if config.debug:
            break
    t_metrics = []
    for batch in batches(test_ds, 1, np.arange(len(test_ds))[rank::size],
                         dev, config.num_workers):
        t_metrics.append({k: float(v) for k, v in
                          T.test_step(state, batch, config).items()})
        if config.debug:
            break
    keys = METRIC_KEYS
    sums = torch.tensor([np.sum(v_losses), len(v_losses), len(t_metrics)]
                        + [np.sum([m[k] for m in t_metrics]) for k in keys],
                        dtype=torch.float64, device=dev)
    if mesh is not None:
        sums = all_reduce(sums, mesh.axis("all"))
    sums = sums.tolist()
    return (sums[0] / max(sums[1], 1.0),
            {k: sums[3 + j] / max(sums[2], 1.0) for j, k in enumerate(keys)})


def main(argv=None):
    p = argparse.ArgumentParser(description="wildmvs_torch training")
    p.add_argument("--dataset", default="synthetic",
                   choices=["dtu", "md", "blended", "synthetic"])
    p.add_argument("--architecture", default="mvsnet",
                   choices=["mvsnet", "mvsnet-s", "vis_mvsnet", "cvp_mvsnet"])
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lrepochs", default="13:10")
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_im_train", type=int, default=3)
    p.add_argument("--num_depth", type=int, default=192,
                   help="hypotheses of mvsnet and mvsnet-s (vis_mvsnet and "
                        "cvp_mvsnet sweep their own per-level counts)")
    p.add_argument("--upsample_training", action="store_true",
                   dest="upsample_training")
    p.add_argument("--no_upsample_training", action="store_false",
                   dest="upsample_training")
    p.set_defaults(upsample_training=False)
    p.add_argument("--occ_masking", action="store_true",
                   help="unsupervised: every view as the reference in one "
                        "step, each masked by the others' depths")
    p.add_argument("--geom_clamping", type=float, default=0.05,
                   help="the occlusion mask's relative depth agreement")
    sup = p.add_mutually_exclusive_group()
    sup.add_argument("--supervised", dest="supervised", action="store_true")
    sup.add_argument("--unsupervised", dest="supervised",
                     action="store_false")
    p.set_defaults(supervised=True)
    p.add_argument("--logdir", default="trained_models/debug")
    p.add_argument("--data_path", default=None,
                   help="dataset root (default: the reference's layouts "
                        "under datasets/)")
    p.add_argument("--loadckpt", default=None,
                   help="warm-start the model from a torch checkpoint or a "
                        "JAX npz file")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in logdir")
    p.add_argument("--save_freq", type=int, default=1)
    p.add_argument("--print_every", type=int, default=20)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--world_size", type=int, default=1,
                   help="ranks: under occ_masking each takes num_im_train / "
                        "N reference views, otherwise batch_size / N rows")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend (default: nccl on the "
                        "card, gloo on the CPU)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward's activations in the "
                        "backward (torch.utils.checkpoint)")
    p.add_argument("--remat_levels", action="store_true",
                   help="cvp_mvsnet: recompute each pyramid level's cost "
                        "volume and regularizer in the backward")
    p.add_argument("--packed_training", action="store_true",
                   help="cvp_mvsnet: accepted; the port's regularizer is "
                        "unpacked either way (same math)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 network compute (f32 parameters, optimizer "
                        "state and loss)")
    p.add_argument("--num_workers", type=int, default=4,
                   help="threads loading samples ahead of the step (0: in "
                        "line)")
    p.add_argument("--trace", action="store_true",
                   help="write a torch.profiler trace of the run to "
                        "logdir/torch_trace/")
    p.add_argument("--debug", action="store_true",
                   help="one batch per epoch and phase, one epoch")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    a = p.parse_args(argv)
    if a.supervised and a.dataset == "dtu" and not a.upsample_training:
        # reference train.py:305-309: DTU's GT depth is stored at 1/4
        raise SystemExit("dtu supervised training requires "
                         "--upsample_training (GT is x4 downsampled)")
    config = TrainConfig(
        architecture=a.architecture, dataset=a.dataset,
        supervised=a.supervised, occ_masking=a.occ_masking,
        upsample_training=a.upsample_training,
        num_im_train=a.num_im_train, batch_size=a.batch_size,
        epochs=a.epochs, lr=a.lr, lrepochs=a.lrepochs, weight_decay=a.wd,
        geom_clamping=a.geom_clamping, seed=a.seed, save_freq=a.save_freq,
        print_every=a.print_every, logdir=a.logdir, debug=a.debug,
        data_path=a.data_path, num_workers=a.num_workers,
        num_depth=a.num_depth,
        train_dtype="bfloat16" if a.bf16 else "float32", remat=a.remat,
        remat_levels=a.remat_levels, packed_training=a.packed_training)
    on_card = torch.device(a.device).type == "cuda"
    backend = a.dist_backend or ("nccl" if on_card else "gloo")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:        # under torchrun
        size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = a.device
        if on_card:
            # this node's ranks on this node's cards
            _check_cards(backend, int(os.environ.get(
                "LOCAL_WORLD_SIZE", size)), local == 0)
            device = f"cuda:{local % torch.cuda.device_count()}"
            torch.cuda.set_device(device)
        initialize(backend, "env://", size, rank)
        try:
            return _train(rank, config, a, device)
        finally:
            torch.distributed.destroy_process_group()
    if a.world_size > 1:
        if on_card:
            _check_cards(backend, a.world_size, True)
        return spawn(_train, a.world_size, config, a, backend=backend,
                     device="cuda" if on_card else "cpu")[0]
    return _train(0, config, a, a.device)


def _check_cards(backend: str, ranks: int, say: bool) -> None:
    """NCCL takes one card a rank; gloo lets `ranks` share the cards (and
    says so where `say`)."""
    cards = torch.cuda.device_count()
    if cards < ranks:
        if backend != "gloo":
            raise RuntimeError(
                f"{ranks} ranks on {cards} card(s): nccl takes one card a "
                f"rank; pass --dist_backend gloo to share them")
        if say:
            print(f"{ranks} gloo ranks share {cards} card(s) round-robin",
                  flush=True)


def _train(rank, config, a, device=None):
    """One rank's run (or the only one) under `--trace`: on `device`, by
    default the card `spawn` gave this rank or the CPU."""
    if device is None:
        device = (f"cuda:{torch.cuda.current_device()}"
                  if torch.device(a.device).type == "cuda" else "cpu")
    with profiler_trace(a.logdir, enabled=a.trace):
        return run(config, resume=a.resume, loadckpt=a.loadckpt,
                   device=device)

if __name__ == "__main__":
    main()
