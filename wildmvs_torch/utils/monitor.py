"""Training logs and stage timing: running means of scalar metrics, a
JSON-lines log, and the pipeline's per-stage wall clock.

Counterpart of wildmvs/utils/monitor.py's `MeterSet`, `Logger.log` and
`StageTimer` (reference utils/monitor.py:23-45, utils/trainer.py:18-48).
Image panels and the profiler trace are not ported yet (ROADMAP Queue 1,
item 7).
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import torch


class Logger:
    """Append metric dicts to `<logdir>/logs.txt`, one JSON object a line."""

    def __init__(self, logdir):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.log_file = self.logdir / "logs.txt"

    def log(self, metrics: dict):
        line = json.dumps({k: (float(v) if hasattr(v, "__float__") else v)
                           for k, v in metrics.items()})
        with open(self.log_file, "a") as f:
            f.write(line + "\n")


class MeterSet:
    """Running means of scalar metrics, reduced per epoch."""

    def __init__(self):
        self._sums: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    def update(self, metrics: dict):
        for k, v in metrics.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)
            self._counts[k] = self._counts.get(k, 0) + 1

    def means(self) -> dict:
        return {k: self._sums[k] / max(self._counts[k], 1)
                for k in self._sums}

    def reset(self) -> dict:
        out = self.means()
        self._sums.clear()
        self._counts.clear()
        return out


class StageTimer:
    """Wall clock per pipeline stage, summarized as a dict. With a CUDA
    `device`, each mark synchronizes the card before it reads the clock
    (one host sync a mark), so a stage's time includes its device work."""

    def __init__(self, device: str | torch.device | None = None):
        self.device = None if device is None else torch.device(device)
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._last = self._now()

    def _now(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _add(self, name: str, dt: float):
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def mark(self, name: str):
        """Attribute the time since the previous mark (or construction) to
        `name`."""
        now = self._now()
        self._add(name, now - self._last)
        self._last = now

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the block as `name`."""
        t0 = self._now()
        try:
            yield
        finally:
            self._add(name, self._now() - t0)

    def summary(self) -> dict:
        return {k: {"total_s": round(self.totals[k], 4),
                    "count": self.counts[k],
                    "mean_s": round(self.totals[k] / self.counts[k], 4)}
                for k in self.totals}
