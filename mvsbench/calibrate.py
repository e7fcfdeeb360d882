"""Readings that the limits of `correct` are set from.

    python3 -m mvsbench.calibrate --workload <cell> --seeds 1 2 3 ...
        [--control] [--out FILE]

For each seed: set-up as a run makes it, then the program's numbers (a
serving cell: `check_requests` requests through the window's own call; a
training cell: the three checked steps) and, with --control, the fp8
control's numbers on the same requests or steps; --fault unchanged_state
plants a training step that leaves the state unchanged. One JSON line a
seed on stdout (and appended to FILE). Runs on the card only.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import files
from .run import forbidden_modules, make_cell, power_limit


def reading(cell: dict, seed: int, control: bool, device,
            fault: str | None = None) -> dict:
    run = make_cell(cell, seed, device)
    if fault == "unchanged_state":      # Adam's step leaves the state
        step = torch.optim.Adam.step
        torch.optim.Adam.step = lambda self, closure=None: None
        try:
            run.warm()
        finally:
            torch.optim.Adam.step = step
    else:
        run.warm()
    if cell["mode"] == "serve":
        for _ in range(cell["check_requests"]):
            run.one()
        confs = [float(out["confidence"].mean()) for _, out in run.kept]
        run.free_program()
        out = {"program": run.numbers(),
               "mean_confidence": sum(confs) / len(confs)}
        if control:
            out["control"] = run.numbers(control=True)
    else:
        run.free_program()
        out = {"program": run.numbers(), "losses": run.checked_losses}
        if control:
            out["control"] = run.numbers(control=True)
    del run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mvsbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("unchanged_state",),
                    help="plant a fault in the program's checked steps")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mvsbench.calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = files.workload(args.workload)
    device = torch.device("cuda")
    card = f"{torch.cuda.get_device_name(0)}, {power_limit()}"
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed, "card": card,
                "fault": args.fault,
                **reading(cell, seed, args.control, device, args.fault),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    bad = forbidden_modules()
    if bad:
        print(f"mvsbench.calibrate: loaded {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
