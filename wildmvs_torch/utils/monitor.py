"""Training logs: running means of scalar metrics and a JSON-lines log.

Counterpart of the scalar part of wildmvs/utils/monitor.py (`MeterSet`,
`Logger.log`; reference utils/monitor.py:23-45, utils/trainer.py:18-48).
Image panels are not ported yet (ROADMAP Queue 1, item 7).
"""
from __future__ import annotations

import json
from pathlib import Path


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
