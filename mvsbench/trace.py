"""The traced sub-window: torch.profiler over a steady run of requests or
steps inside the measured window, reduced to what the per-layer readers
and the result's `device` and `breakdown` need.

The sub-window is the span `mvsbench.window` that the harness records
around its units, each preceded and followed by a card synchronisation.
Device activity is every kernel, memcpy and memset record of the trace;
`busy_s` is the length of their union inside the span. An idle gap is
named by the innermost host record (operator, runtime call, or a span
the harness records around the program's entry: `Predictor.__call__`,
`batch_to_device`, `train_step`, `loss.item`) running at its middle: a
gap named by a span alone is host Python outside any operator.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "mvsbench.window"
SHORT_GAP_US = 5.0


@dataclasses.dataclass
class Trace:
    """What the readers read. Times in seconds."""
    window_s: float
    busy_s: float
    units: int                       # requests or steps in the window
    device_ops: dict                 # name -> seconds
    memcpy_s: float
    kernels: list                    # (name, seconds) of each kernel
    idle_gaps: dict                  # host label -> seconds
    flops_per_unit: float | None = None
    regularizer_s: float | None = None
    jobs: dict = dataclasses.field(default_factory=dict)  # kernel -> bound s

    def kernel_s(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(s for name, s in self.kernels if rx.search(name))

    def roofline_pct(self, kernel: str, pattern: str):
        """The job's bound over the device time of the kernels matching
        `pattern`, in percent; None where there is no such kernel or no
        bound."""
        spent = self.kernel_s(pattern)
        bound = self.jobs.get(kernel)
        if spent <= 0 or not bound:
            return None
        return 100.0 * bound / spent


def span(name: str, on: bool):
    """A host span for the trace (`record_function`) while `on`; nothing
    otherwise, so untraced runs carry no instrumentation."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label(host, starts, mid):
    """The innermost host record containing `mid`."""
    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(i - 400, -1), -1):
        ts, end, name = host[j]
        if end >= mid:
            return name
    return "no host record"


def reduce_events(events: list, units: int) -> Trace:
    """A Trace from chrome-trace events (dicts with cat, name, ts, dur in
    microseconds)."""
    spans = [e for e in events if e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError("the trace has no mvsbench.window span")
    w0 = spans[0]["ts"]
    w1 = w0 + spans[0]["dur"]
    dev, kernels, ops = [], [], {}
    memcpy = 0.0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        dev.append((a, b))
        s = (b - a) * 1e-6
        name = e["name"]
        ops[name[:120]] = ops.get(name[:120], 0.0) + s
        if e["cat"] == "kernel":
            kernels.append((name, s))
        elif e["cat"] == "gpu_memcpy":
            memcpy += s
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
                  for e in events if e.get("cat") in HOST_CATS
                  and e.get("name") != WINDOW and "dur" in e)
    starts = [h[0] for h in host]
    gaps, prev = {}, w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            length = a - prev
            label = (_label(host, starts, (a + prev) / 2)
                     if length >= SHORT_GAP_US
                     else f"gaps under {SHORT_GAP_US:g} us")
            gaps[label[:120]] = gaps.get(label[:120], 0.0) + length * 1e-6
        prev = max(prev, b)
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy_s, units=units,
                 device_ops=ops, memcpy_s=memcpy, kernels=kernels,
                 idle_gaps=gaps)


def profile(run_units, units: int, sync) -> Trace:
    """Profile `run_units()` (which runs `units` requests or steps) with
    CPU and CUDA activities inside the `mvsbench.window` span; the chrome
    trace goes to a temporary file under TMPDIR and is deleted once
    read."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts) as prof:
        sync()
        with record_function(WINDOW):
            run_units()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events, units)


def top(d: dict, k: int = 10) -> list:
    return [[n, s] for n, s in sorted(d.items(), key=lambda x: -x[1])[:k]]
