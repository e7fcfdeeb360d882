"""Read the model variables of an orbax checkpoint directory without JAX.

The JAX package writes every training checkpoint as a directory
(wildmvs/train/checkpoint.py:22-55): orbax's `StandardCheckpointer` tree
{"params", "batch_stats", "opt_state", "step"} (or {"params",
"batch_stats"} from `save_params`) beside a `metadata.json` that names the
architecture. orbax 0.11 stores the arrays as zarr v2 arrays in one OCDBT
key-value store under the directory, one array a leaf, keyed by the
leaf's tree path joined with "."; `_METADATA` lists each leaf's tree path
as a list of keys. tensorstore reads that store directly, so the port
needs neither orbax nor JAX. Only the "params" and "batch_stats" subtrees
are read, as the JAX package's `restore_params` selects them.

tensorstore is imported when a checkpoint is read; without it the reader
raises an ImportError that names it.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

_SUBTREES = ("params", "batch_stats")


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading an orbax checkpoint directory needs the `tensorstore` "
            "package; or convert it with the JAX package's "
            "wildmvs.train.checkpoint.save_params_npz") from e
    return tensorstore


def load_orbax_params(path: str | Path):
    """An orbax checkpoint directory -> (params, batch_stats, metadata):
    the two trees as nested dicts of numpy arrays, metadata the parsed
    `metadata.json` (its "architecture" names the model)."""
    path = Path(path).resolve()
    if not ((path / "_METADATA").is_file()
            and (path / "metadata.json").is_file()):
        raise FileNotFoundError(f"{path} is not an orbax checkpoint "
                                f"directory (no _METADATA / metadata.json)")
    ts = _tensorstore()
    meta = json.loads((path / "metadata.json").read_text())
    tree_meta = json.loads((path / "_METADATA").read_text())
    if not tree_meta.get("use_ocdbt") or tree_meta.get("use_zarr3"):
        raise ValueError(f"{path}: only orbax's default layout (an OCDBT "
                         f"store of zarr v2 arrays) is read")
    trees = {name: {} for name in _SUBTREES}
    for leaf in tree_meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in leaf["key_metadata"]]
        if keys[0] not in trees:
            continue                    # opt_state, step
        name = ".".join(keys)
        arr = ts.open({"driver": "zarr",
                       "kvstore": {"driver": "ocdbt",
                                   "base": f"file://{path}",
                                   "path": f"{name}/"}},
                      open=True).result().read().result()
        node = trees[keys[0]]
        for k in keys[1:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(arr)
    return trees["params"], trees["batch_stats"], meta
