"""Run one cell of the benchmark and print its result line.

    python3 -m mvsbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `wildmvs_torch`. The cell's
traffic is `mvsbench/workloads/<cell>.json`, its configuration
`mvsbench/configs/<config>.json`; which metrics it reports comes from
`BENCHMARK.json`. `--trace 0` prints the cell's end-to-end metrics,
`--trace 1` its per-layer metrics (from `mvsbench/metrics/<name>.py`),
the device's busy time and the breakdown. Every run checks what the timed
path produced against the plain reference; the last stderr lines and the
result's last key give each number beside its limit.

Exit codes: 0 with a result line; 2 without a card (or too few), or
without the program beside the benchmark; 3 when the process holds a
module of JAX or of the JAX package once the window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout (the
# port's own nvcc cache is build/kernels/, fixed by wildmvs_torch._build)
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = str(ROOT / "build" / _sub)

import torch  # noqa: E402

from . import check, files, stats  # noqa: E402
from .trace import top  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "wildmvs")
#: what a non-finite reading (a failed request's latency, a non-finite
#: output) prints as: JSON has no infinity
NOT_FINITE = sys.float_info.max


def finite(x: float) -> float:
    return x if x == x and abs(x) != float("inf") else NOT_FINITE


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not hold,
    compared whole (`wildmvs_torch` is the program, `wildmvs` is not)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m mvsbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def make_cell(cell: dict, seed: int, device):
    cfg = files.config(cell["config"])
    ref_mod = files.reference(cfg["architecture"])
    if cell["mode"] == "serve":
        from .serve import ServeCell
        return ServeCell(cell, cfg, ref_mod, seed, device)
    from .train import TrainCell
    return TrainCell(cell, cfg, ref_mod, seed, device)


def per_layer(bench: dict, name: str, tr) -> dict:
    out = {}
    for m in files.cell_metrics(bench, name, "per_layer"):
        value = files.metric(m["name"]).read(tr)
        if value is not None:
            out[m["name"]] = {"value": finite(value), "unit": m["unit"]}
    return out


def main(argv=None, device=None, cell=None) -> int:
    """Run a cell. Tests pass `device` (the CPU) and a `cell` dict to run
    without a card; the benchmark's runs pass neither."""
    args = parse(argv)
    bench = files.benchmark()
    cell = cell or files.workload(args.workload)
    if device is None:
        if not torch.cuda.is_available() or (torch.cuda.device_count()
                                             < cell["chips"]):
            print(f"mvsbench: cell {args.workload} needs {cell['chips']} "
                  "CUDA card(s)", file=sys.stderr)
            return 2
        device = torch.device("cuda")
    try:
        import wildmvs_torch  # noqa: F401
    except ImportError as e:
        print(f"mvsbench: the program is not beside the benchmark: {e}",
              file=sys.stderr)
        return 2

    run = make_cell(cell, args.seed, device)
    run.warm()
    # the reference's BatchNorm calibration is the benchmark's, not set-up
    setup_s = time.perf_counter() - T0 - run.reference_s
    window_s, tr = run.window(args.seconds, cell["trace_units"]
                              if args.trace else 0)
    run.sync()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    bad = forbidden_modules()
    if bad:
        print(f"mvsbench: the run loaded {bad}", file=sys.stderr)
        return 3

    if cell["mode"] == "serve":
        lat = run.latencies()
        attempted = len(lat)
        failed = sum(1 for x in lat if x == float("inf"))
        e2e = stats.serve_metrics(lat, window_s)
    else:
        attempted, failed = run.attempted, run.failed
        e2e = stats.train_metrics(run.done, 1, window_s)
    run.free_program()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    if tr is not None:
        run.trace_extras(tr)
        metrics = per_layer(bench, args.workload, tr)
    else:
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": finite(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in files.cell_metrics(bench, args.workload,
                                               "end_to_end")}

    limits = cell["limits"]
    numbers = run.numbers()
    correct = failed == 0 and check.verdict(numbers, limits)
    bad = forbidden_modules()
    if bad:
        print(f"mvsbench: the run loaded {bad}", file=sys.stderr)
        return 3

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": cell["chips"],
                         "memory_peak_bytes": int(peak)}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": top(tr.device_ops),
                               "idle_gaps": top(tr.idle_gaps)}
    if device.type == "cuda":
        result["power_limit"] = power_limit()
    result["checks"] = {k: {"value": finite(v["value"]), "limit": v["limit"]}
                        for k, v in check.report(numbers, limits).items()}
    for k, v in result["checks"].items():
        ok = "ok" if v["value"] <= v["limit"] else "FAIL"
        print(f"check {k} {v['value']!r} limit {v['limit']!r} {ok}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
