"""Carry weights into the port: JAX variables, npz and orbax checkpoints,
torch checkpoints.

The JAX package keeps flax parameter trees; the port keeps the reference's
torch state_dict keys. `state_dict_from_jax` maps one onto the other with
numpy alone (the port never imports jax or wildmvs):

  conv       kernel [k.., I, O]           -> weight [O, I, k..]
  deconv     kernel [k.., I, O]           -> weight [I, O, k..]
  BatchNorm  scale / bias / mean / var    -> weight / bias / running_mean /
                                             running_var (+ num_batches_tracked 0)

Path rules (flax module names mirror the reference's):
  <m>/deconv/kernel      -> <m>.0.weight       (transposed Sequential block)
  <m>/<x>_deconv/kernel  -> <m>.<x>_deconv.weight, transposed layout
  <m>/bn/bn/<leaf>       -> <m>.1.<leaf'> when <m> is a transposed block,
                            else <m>.bn.<leaf'>
  <m>/bn/<leaf>          -> <m>.<leaf'>        (a bare BatchNorm wrapper)
  2D <m>/conv/kernel     -> <m>.weight         (flax nests nn.Conv as "conv")
  3D <m>/kernel          -> <m>.weight
  temp                   -> temp
and then the module names become the reference's (`_RULES`). CVP-MVSNet:
feature_pyramid/<conv> -> featurePyramid.<conv>.0 (a Sequential(Conv2d,
LeakyReLU), net.py:21-47; its regularizer's keys are the generic ones).
Vis-MVSNet:
  UNet enc<i>/block<j> -> enc_blocks.<prefix><scale>_<i>.<j>,
  dec<i>_deconv / dec<i>_conv / dec<i>_res/block<j> ->
  dec_blocks.<prefix><scale>_<i>.0 / .1 / .2.<j> (prefix and scales of the
  reference's registration, nn_utils.py:196-255); BasicBlock conv1/bn,
  conv2/bn, downsample_conv, downsample_bn -> conv1, bn1, conv2, bn2,
  downsample.0, downsample.1; init_conv and UncertNet conv<k>
  Sequentials -> .0 / .1; UncertNet head<k> -> head_convs.<k>; the bare
  reg_pair conv -> reg_pair.final_conv. These are the keys of the JAX
  package's model of the reference (tests/test_torch_import.py
  `reference_vis_state_dict`); no reference Vis-MVSNet checkpoint was at
  hand to check them against.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import torch

from .orbax_read import load_orbax_params

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


# Vis-MVSNet UNets: (reference registration prefix, initial scale, encoder
# levels), by the module that owns the UNet (model_cas.py:18-74)
_VIS_UNETS = {"feat_ext": ("2d", 2, 3), "reg": ("reg1", 4, 2),
              "reg_fuse": ("reg2", 4, 2)}


def _unet_key(m: re.Match) -> str:
    prefix, scale0, levels = _VIS_UNETS[m.group(1)]
    kind, idx = m.group(2), int(m.group(3))
    if kind == "enc":
        return f"{m.group(1)}.unet.enc_blocks.{prefix}{scale0 << idx}_{idx}."
    scale = scale0 << (2 * levels - idx)
    part = {"_deconv": "0", "_conv": "1", "_res": "2"}[m.group(4)]
    return f"{m.group(1)}.unet.dec_blocks.{prefix}{scale}_{idx}.{part}."


# generic key -> reference key, in order
_RULES = [
    (re.compile(r"^\.feature_pyramid\.(conv\w+)\."), r".featurePyramid.\1.0."),
    (re.compile(r"(?<=\.)(feat_ext|reg|reg_fuse)\.unet\.(enc|dec)(\d+)"
                r"(_deconv|_conv|_res)?\."), _unet_key),
    (re.compile(r"\.block(\d+)\.conv([12])\.conv\."), r".\1.conv\2."),
    (re.compile(r"\.block(\d+)\.conv([12])\.bn\."), r".\1.bn\2."),
    (re.compile(r"\.block(\d+)\.downsample_conv\."), r".\1.downsample.0."),
    (re.compile(r"\.block(\d+)\.downsample_bn\."), r".\1.downsample.1."),
    (re.compile(r"(\.unet\.dec_blocks\.[^.]+\.2\.)block(\d+)\."), r"\1\2."),
    (re.compile(r"\.(init_conv|uncert_net\.conv\d)\.conv\."), r".\1.0."),
    (re.compile(r"\.(init_conv|uncert_net\.conv\d)\.bn\."), r".\1.1."),
    (re.compile(r"\.uncert_net\.head(\d+)\."), r".uncert_net.head_convs.\1."),
    (re.compile(r"\.reg_pair\.weight$"), ".reg_pair.final_conv.weight"),
]


def _reference_key(key: str) -> str:
    key = "." + key                   # every module name after a dot
    for pat, repl in _RULES:
        key = pat.sub(repl, key)
    return key[1:]


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
        if mods and mods[-1].endswith("deconv"):
            nd = val.ndim - 2
            key = (mods[:-1] + ["0", "weight"] if mods[-1] == "deconv"
                   else mods + ["weight"])
            val = val.transpose((nd, nd + 1) + tuple(range(nd)))
        elif mods[-1:] == ["bn"] and leaf in _BN_LEAVES:
            if mods[-2:] == ["bn", "bn"]:
                block = tuple(mods[:-2])
                key = list(block) + ["1" if block in deconv_blocks else "bn",
                                     _BN_LEAVES[leaf]]
            else:                         # a bare BatchNorm wrapper
                key = mods[:-1] + [_BN_LEAVES[leaf]]
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
    return {_reference_key(k): v for k, v in sd.items()}


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
    """A checkpoint -> (state_dict, architecture or None).

    A directory: an orbax checkpoint of the JAX package
    (`orbax_read.load_orbax_params`, needs tensorstore). `.npz`: a JAX
    `save_params_npz` file. Both are carried by `state_dict_from_jax`.
    Any other file: a reference torch checkpoint ({"model": state_dict,
    "architecture": ...} or a bare state_dict; the DDP "module." prefix and
    the Vis-MVSNet Frontend's "model." prefix are dropped), whose keys are
    the port's already.
    """
    path = Path(path)
    if path.is_dir():
        params, stats, meta = load_orbax_params(path)
        return state_dict_from_jax(params, stats), meta.get("architecture")
    if path.suffix == ".npz":
        params, stats, meta = load_params_npz(path)
        return state_dict_from_jax(params, stats), meta.get("architecture")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    sd = {k.removeprefix("module.").removeprefix("model."): v
          for k, v in sd.items() if torch.is_tensor(v)}
    return sd, ckpt.get("architecture")
