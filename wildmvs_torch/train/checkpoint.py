"""Training checkpoints in the reference torch format.

`<logdir>/model_{epoch:06d}.ckpt` holds {"model": state_dict,
"architecture", "optimizer": optimizer state_dict, "epoch"}, as the
reference train.py:202-210 writes it. `jax_import.load_weights` reads that
format, so `Predictor` serves a checkpoint the port trained; it also reads
a JAX `save_params_npz` file, which warm-starts training (`--loadckpt`).
(The JAX package writes orbax directories; the port does not read those
yet, ROADMAP Queue 1, item 8.)
"""
from __future__ import annotations

import re
from pathlib import Path

import torch

from .jax_import import load_weights

_CKPT_RE = re.compile(r"model_(\d+)\.ckpt$")


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
    """The highest-numbered `model_*.ckpt` under logdir (reference
    train.py:151-155), or None."""
    logdir = Path(logdir)
    if not logdir.is_dir():
        return None
    cands = [(int(m.group(1)), p) for p in logdir.iterdir()
             if (m := _CKPT_RE.match(p.name))]
    return max(cands)[1] if cands else None


def restore_checkpoint(path: str | Path, state) -> int:
    """Load the model and optimizer of a checkpoint into `state`; returns
    the epoch it was written after."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(Path(path), map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    return int(ckpt["epoch"])


def load_model_weights(path: str | Path, model: torch.nn.Module) -> None:
    """Warm start: the model variables of a torch checkpoint or a JAX npz
    file, without optimizer state (reference train.py:160-164)."""
    state_dict, _ = load_weights(path)
    model.load_state_dict(state_dict)
