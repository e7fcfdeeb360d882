"""Carry weights into the port: JAX variables, npz checkpoints, torch
checkpoints.

The JAX package keeps flax parameter trees; the port keeps the reference's
torch state_dict keys. `state_dict_from_jax` maps one onto the other with
numpy alone (the port never imports jax or wildmvs):

  conv       kernel [k.., I, O]           -> weight [O, I, k..]
  deconv     kernel [k.., I, O]           -> weight [I, O, k..]
  BatchNorm  scale / bias / mean / var    -> weight / bias / running_mean /
                                             running_var (+ num_batches_tracked 0)

Path rules (flax module names mirror the reference's):
  <m>/deconv/kernel      -> <m>.0.weight       (transposed Sequential block)
  <m>/bn/bn/<leaf>       -> <m>.1.<leaf'> when <m> is a transposed block,
                            else <m>.bn.<leaf'>
  2D <m>/conv/kernel     -> <m>.weight         (flax nests nn.Conv as "conv")
  3D <m>/kernel          -> <m>.weight
  temp                   -> temp
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def state_dict_from_jax(params: dict, batch_stats: dict) -> dict:
    """JAX (params, batch_stats) trees of numpy arrays -> the port's
    state_dict (torch tensors, f32 as stored)."""
    leaves = list(_flatten(params)) + list(_flatten(batch_stats))
    deconv_blocks = {path[:-2] for path, _ in leaves
                     if len(path) >= 2 and path[-2] == "deconv"}
    sd = {}
    for path, val in leaves:
        val = np.asarray(val)
        *mods, leaf = path
        if mods and mods[-1] == "deconv":
            nd = val.ndim - 2
            key = mods[:-1] + ["0", "weight"]
            val = val.transpose((nd, nd + 1) + tuple(range(nd)))
        elif mods[-2:] == ["bn", "bn"]:
            block = tuple(mods[:-2])
            key = list(block) + ["1" if block in deconv_blocks else "bn",
                                 _BN_LEAVES[leaf]]
            if leaf == "mean":
                sd[".".join(key[:-1] + ["num_batches_tracked"])] = \
                    torch.tensor(0)
        elif leaf in ("kernel", "bias"):
            if mods[-1] == "conv" and (leaf == "bias" or val.ndim == 4):
                mods = mods[:-1]          # flax's inner nn.Conv of a 2D conv
            if leaf == "kernel":
                nd = val.ndim - 2
                val = val.transpose((nd + 1, nd) + tuple(range(nd)))
            key = mods + ["weight" if leaf == "kernel" else "bias"]
        else:
            key = mods + [leaf]
        sd[".".join(key)] = torch.from_numpy(np.ascontiguousarray(val))
    return sd


def load_params_npz(path: str | Path):
    """Read a `save_params_npz` file (keys "params/...", "stats/...",
    "__metadata__"; wildmvs/train/checkpoint.py:109-151) with numpy alone
    -> (params, batch_stats, metadata)."""
    with np.load(Path(path)) as z:
        meta = json.loads(bytes(z["__metadata__"]).decode())
        trees = {"params": {}, "stats": {}}
        for key in z.files:
            prefix, _, rest = key.partition("/")
            if prefix not in trees:
                continue
            *mods, leaf = rest.split("/")
            node = trees[prefix]
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = z[key]
    return trees["params"], trees["stats"], meta


def load_weights(path: str | Path):
    """A checkpoint file -> (state_dict, architecture or None).

    `.npz`: a JAX `save_params_npz` file, carried by `state_dict_from_jax`.
    Any other file: a reference torch checkpoint ({"model": state_dict,
    "architecture": ...} or a bare state_dict, DDP "module." prefixes
    dropped), whose keys are the port's already. Orbax directories are not
    read yet (ROADMAP Queue 1 #7).
    """
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint); the port reads "
            f"npz and torch checkpoints only (ROADMAP Queue 1 #7)")
    if path.suffix == ".npz":
        params, stats, meta = load_params_npz(path)
        return state_dict_from_jax(params, stats), meta.get("architecture")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    sd = {k.removeprefix("module."): v for k, v in sd.items()
          if torch.is_tensor(v)}
    return sd, ckpt.get("architecture")
