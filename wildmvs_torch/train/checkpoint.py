"""Training checkpoints in the reference torch format.

`<logdir>/model_{epoch:06d}.ckpt` holds {"model": state_dict,
"architecture", "optimizer": optimizer state_dict, "epoch"}, as the
reference train.py:202-210 writes it. `jax_import.load_weights` reads that
format, so `Predictor` serves a checkpoint the port trained; it also reads
a JAX `save_params_npz` file and the JAX trainer's orbax directories
`<logdir>/model_{epoch:06d}/` (train/orbax_read.py), whose model variables
serve or warm-start training (`--loadckpt`).
"""
from __future__ import annotations

import re
from pathlib import Path

import torch

from .jax_import import load_weights

_CKPT_RE = re.compile(r"model_(\d+)\.ckpt$")
_ORBAX_RE = re.compile(r"model_(\d+)$")


def save_checkpoint(logdir: str | Path, epoch: int, state,
                    architecture: str) -> Path:
    """Write `model_{epoch:06d}.ckpt` under logdir; returns its path."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / f"model_{epoch:06d}.ckpt"
    tmp = path.with_suffix(".tmp")
    torch.save({"model": state.model.state_dict(),
                "architecture": architecture,
                "optimizer": state.optimizer.state_dict(),
                "epoch": epoch}, tmp)
    tmp.replace(path)
    return path


def latest_checkpoint(logdir: str | Path) -> Path | None:
    """The highest-numbered checkpoint under logdir (reference
    train.py:151-155): a `model_*.ckpt` file of the port, or a `model_*`
    directory holding `metadata.json` (an orbax checkpoint of the JAX
    trainer); None if there is neither."""
    logdir = Path(logdir)
    if not logdir.is_dir():
        return None
    cands = [(int(m.group(1)), p) for p in logdir.iterdir()
             if (m := _CKPT_RE.match(p.name))
             or ((m := _ORBAX_RE.match(p.name))
                 and (p / "metadata.json").is_file())]
    return max(cands)[1] if cands else None


def resolve_checkpoint(path: str | Path) -> Path:
    """A checkpoint path as given, or the newest checkpoint under a
    directory that holds them (a logdir)."""
    path = Path(path)
    return (latest_checkpoint(path) or path) if path.is_dir() else path


def restore_checkpoint(path: str | Path, state) -> int:
    """Load the model and optimizer of a checkpoint into `state`; returns
    the epoch it was written after."""
    if Path(path).is_dir():
        raise ValueError(f"{path} is an orbax checkpoint of the JAX "
                         f"trainer: its optimizer state does not carry "
                         f"over; warm-start from it with --loadckpt")
    device = next(state.model.parameters()).device
    ckpt = torch.load(Path(path), map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    return int(ckpt["epoch"])


def load_model_weights(path: str | Path, model: torch.nn.Module) -> None:
    """Warm start: the model variables of a torch checkpoint, a JAX npz
    file or orbax directory, or the newest checkpoint of a logdir, without
    optimizer state (reference train.py:160-164)."""
    state_dict, _ = load_weights(resolve_checkpoint(path))
    model.load_state_dict(state_dict)
