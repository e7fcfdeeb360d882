"""Training CLI: the epoch loop on one card.

Counterpart of wildmvs/train/cli.py:97-340 (reference train.py:64-252) for
MVSNet, Vis-MVSNet and CVP-MVSNet, supervised or unsupervised
(photometric, optionally occlusion-masked), on DTU, MegaDepth, BlendedMVS
(data/loaders.py) or the synthetic dataset:

  python -m wildmvs_torch.train.cli --dataset synthetic --num_depth 16 --debug
  python -m wildmvs_torch.train.cli --device cpu --dataset synthetic \
      --num_depth 16 --debug
  python -m wildmvs_torch.train.cli --device cpu --dataset synthetic \
      --architecture vis_mvsnet --unsupervised --occ_masking --debug
  python -m wildmvs_torch.train.cli --dataset md --data_path <root> \
      --unsupervised --occ_masking --bf16

Runs on "cuda" unless `--device cpu` is given. Samples are loaded by
`--num_workers` threads ahead of the step (0: in line). Each epoch trains
(every `--print_every` steps it prints the running means and writes the
training images, utils/monitor.training_panels, and the predicted depth as
jpgs to the logdir), writes `<logdir>/model_{epoch:06d}.ckpt` every
`--save_freq` epochs, then runs the validation loss and the test metrics;
scalar logs go to `<logdir>/logs.txt`. Not ported yet, and raising
NotImplementedError with their ROADMAP item: --world_size > 1, --remat
and --trace.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from ..data.prefetch import iterate_batches
from ..data.synthetic import SyntheticMVSDataset, collate
from ..device import resolve_device
from ..utils.monitor import Logger, MeterSet, training_panels
from . import trainer as T
from .checkpoint import (latest_checkpoint, load_model_weights,
                         restore_checkpoint, save_checkpoint)
from .config import TrainConfig


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


def run(config: TrainConfig, max_epochs: int | None = None,
        resume: bool = False, loadckpt: str | None = None,
        device=None) -> dict:
    """Train `config`; returns {"train_loss", "val_loss", "test"} per
    epoch. `device` is "cuda" (default; raises without a card) or "cpu"."""
    if resume and loadckpt:
        raise ValueError("--resume and --loadckpt are exclusive "
                         "(reference train.py:298-299)")
    dev = resolve_device(device)
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

    logger = Logger(logdir)
    meters = MeterSet()
    history = {"train_loss": [], "val_loss": [], "test": []}
    end_epoch = max_epochs if max_epochs is not None else config.epochs
    for epoch in range(start_epoch, end_epoch):
        T.set_epoch_lr(state, config, epoch)
        # the epoch-seeded permutation of the JAX package's loop
        order = np.random.default_rng(config.seed * 1000 + epoch).permutation(
            len(train_ds))
        t0 = time.time()
        ep_losses = []
        for i, batch in enumerate(batches(train_ds, config.batch_size, order,
                                          dev, config.num_workers)):
            state, m = T.train_step(state, batch, config)
            depth_est = m.pop("depth_est")
            ep_losses.append(float(m["train_loss"]))
            meters.update(m)
            if (i + 1) % config.print_every == 0:
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
        logger.log({"epoch": epoch, **meters.reset(),
                    "lr": config.lr_at_epoch(epoch),
                    "seconds": round(time.time() - t0, 2)})
        print(f"epoch {epoch}: train_loss={history['train_loss'][-1]:.4f} "
              f"({time.time() - t0:.1f}s)")

        if epoch % config.save_freq == 0:
            save_checkpoint(logdir, epoch, state, config.architecture)
            v_losses = []
            for batch in batches(val_ds, config.batch_size,
                                 np.arange(len(val_ds)), dev,
                                 config.num_workers):
                v_losses.append(float(T.eval_step(state, batch,
                                                  config)["val_loss"]))
                if config.debug:
                    break
            t_metrics = []
            for batch in batches(test_ds, 1, np.arange(len(test_ds)), dev,
                                 config.num_workers):
                t_metrics.append({k: float(v) for k, v in
                                  T.test_step(state, batch, config).items()})
                if config.debug:
                    break
            history["val_loss"].append(float(np.mean(v_losses)))
            avg = {k: float(np.mean([m[k] for m in t_metrics]))
                   for k in t_metrics[0]}
            history["test"].append(avg)
            logger.log({"epoch": epoch, "val_loss": history["val_loss"][-1],
                        **avg})
            print(f"  val_loss={history['val_loss'][-1]:.4f} test={avg}")
        if config.debug:
            break
    return history


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
    p.add_argument("--world_size", type=int, default=1)
    p.add_argument("--remat", action="store_true")
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
    p.add_argument("--trace", action="store_true")
    p.add_argument("--debug", action="store_true",
                   help="one batch per epoch and phase, one epoch")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    a = p.parse_args(argv)
    if a.world_size > 1:
        raise NotImplementedError(
            "--world_size > 1 (torch.distributed training) is not ported "
            "yet (ROADMAP Queue 1, item 5)")
    if a.trace:
        raise NotImplementedError(
            "--trace (torch.profiler capture) is not ported yet (ROADMAP "
            "Queue 1, item 7)")
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
    return run(config, resume=a.resume, loadckpt=a.loadckpt,
               device=a.device)


if __name__ == "__main__":
    main()
