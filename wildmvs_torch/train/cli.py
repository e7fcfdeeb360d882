"""Training CLI: the epoch loop on one card.

Counterpart of wildmvs/train/cli.py:97-340 (reference train.py:64-252) for
MVSNet supervised training on the synthetic dataset:

  python -m wildmvs_torch.train.cli --dataset synthetic --num_depth 16 --debug
  python -m wildmvs_torch.train.cli --device cpu --dataset synthetic \
      --num_depth 16 --debug

Runs on "cuda" unless `--device cpu` is given. Each epoch trains, writes
`<logdir>/model_{epoch:06d}.ckpt` every `--save_freq` epochs, then runs the
validation loss and the test metrics; scalar logs go to `<logdir>/logs.txt`.
Not ported yet, and raising NotImplementedError with their ROADMAP item:
real datasets (dtu, md, blended), --unsupervised and --occ_masking,
--world_size > 1, --remat and --trace.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from ..data.synthetic import SyntheticMVSDataset, collate
from ..device import resolve_device
from ..utils.monitor import Logger, MeterSet
from . import trainer as T
from .checkpoint import (latest_checkpoint, load_model_weights,
                         restore_checkpoint, save_checkpoint)
from .config import TrainConfig


def build_datasets(config: TrainConfig):
    """(train, val, test) datasets (reference train.py:67-104)."""
    if config.dataset != "synthetic":
        raise NotImplementedError(
            f"--dataset {config.dataset}: the port's data loaders are not "
            f"ported yet (ROADMAP Queue 1 #8); use --dataset synthetic")
    n = config.num_im_train
    return (SyntheticMVSDataset(num_samples=8, num_views=n, seed=1),
            SyntheticMVSDataset(num_samples=2, num_views=n, seed=2),
            SyntheticMVSDataset(num_samples=2, num_views=n, seed=3))


def batches(dataset, batch_size: int, order, device):
    """Collated batches of `dataset` in `order`, as tensors on `device`."""
    for i in range(0, len(order), batch_size):
        samples = [dataset[int(j)] for j in order[i:i + batch_size]]
        yield T.batch_to_device(collate(samples), device)


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
                                          dev)):
            state, m = T.train_step(state, batch, config)
            m.pop("depth_est")
            ep_losses.append(float(m["train_loss"]))
            meters.update(m)
            if (i + 1) % config.print_every == 0:
                print(f"  iter {i + 1}: {meters.means()}")
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
                                 np.arange(len(val_ds)), dev):
                v_losses.append(float(T.eval_step(state, batch,
                                                  config)["val_loss"]))
                if config.debug:
                    break
            t_metrics = []
            for batch in batches(test_ds, 1, np.arange(len(test_ds)), dev):
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
    p.add_argument("--num_depth", type=int, default=192)
    p.add_argument("--occ_masking", action="store_true")
    sup = p.add_mutually_exclusive_group()
    sup.add_argument("--supervised", dest="supervised", action="store_true")
    sup.add_argument("--unsupervised", dest="supervised",
                     action="store_false")
    p.set_defaults(supervised=True)
    p.add_argument("--logdir", default="trained_models/debug")
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
    p.add_argument("--bf16", action="store_true",
                   help="bf16 network compute (f32 parameters, optimizer "
                        "state and loss)")
    p.add_argument("--trace", action="store_true")
    p.add_argument("--debug", action="store_true",
                   help="one batch per epoch and phase, one epoch")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    a = p.parse_args(argv)
    if not a.supervised or a.occ_masking:
        raise NotImplementedError(
            "unsupervised and occlusion-masked training are not ported yet "
            "(ROADMAP Queue 1 #12)")
    if a.world_size > 1:
        raise NotImplementedError(
            "--world_size > 1 (torch.distributed training) is not ported "
            "yet (ROADMAP Queue 1 #12)")
    if a.trace:
        raise NotImplementedError(
            "--trace (torch.profiler capture) is not ported yet (ROADMAP "
            "Queue 1 #14)")
    config = TrainConfig(
        architecture=a.architecture, dataset=a.dataset,
        supervised=a.supervised, occ_masking=a.occ_masking,
        num_im_train=a.num_im_train, batch_size=a.batch_size,
        epochs=a.epochs, lr=a.lr, lrepochs=a.lrepochs, weight_decay=a.wd,
        seed=a.seed, save_freq=a.save_freq, print_every=a.print_every,
        logdir=a.logdir, debug=a.debug, num_depth=a.num_depth,
        train_dtype="bfloat16" if a.bf16 else "float32", remat=a.remat)
    return run(config, resume=a.resume, loadckpt=a.loadckpt,
               device=a.device)


if __name__ == "__main__":
    main()
