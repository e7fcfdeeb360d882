"""End-to-end arithmetic over a measured window."""
from __future__ import annotations

import math


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default rule); inf values (failed requests) sort
    last."""
    xs = sorted(values)
    if not xs:
        return math.inf
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(done: int, window_s: float) -> float:
    """Completed units a second over the whole window."""
    return done / window_s if window_s > 0 else 0.0


def serve_metrics(latencies_s: list[float], window_s: float) -> dict:
    """maps_per_s: completed depthmaps over the window; request_p90_ms:
    the 90th percentile of every request's latency. A failed request
    enters as inf: it completes nothing and misses every limit."""
    done = sum(1 for x in latencies_s if math.isfinite(x))
    return {"maps_per_s": rate(done, window_s),
            "request_p90_ms": percentile(latencies_s, 90) * 1e3}


def train_metrics(steps: int, batch: int, window_s: float) -> dict:
    """train_samples_per_s: optimizer steps times batch over the window."""
    return {"train_samples_per_s": rate(steps * batch, window_s)}
