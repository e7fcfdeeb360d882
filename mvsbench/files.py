"""Finding the benchmark's data by name: `BENCHMARK.json` at the checkout's
root, `configs/<config>.json`, `workloads/<cell>.json`,
`metrics/<metric>.py` and `reference/<architecture>.py`."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def workload(name: str) -> dict:
    return json.loads((HERE / "workloads" / f"{name}.json").read_text())


def reference(architecture: str):
    """The plain reference module of an architecture."""
    return importlib.import_module(f"mvsbench.reference.{architecture}")


def metric(name: str):
    """The reader module of a per-layer metric (file names keep the
    metric's dots, so it is loaded by path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"mvsbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` entries that a cell reports: those
    that list it, and those with no `workloads` key."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]
