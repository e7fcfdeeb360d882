"""Training logs, stage timing and tracing: running means of scalar
metrics, a JSON-lines log with image panels, the pipeline's per-stage wall
clock, a torch.profiler capture and the program's trace spans.

Counterpart of wildmvs/utils/monitor.py's `MeterSet`, `Logger`,
`training_panels`, `StageTimer` and `profiler_trace` (reference
utils/monitor.py:23-45, utils/trainer.py:18-48, models/trainer.py:78-92
and :258-276).

`span(name)` marks a range of the program for a torch.profiler trace
(`record_function`), and only while a profiler is recording: otherwise it
is one shared `nullcontext` (about half a microsecond, against about ten
for an unrecorded `record_function`). Every span's name starts with
`wildmvs_torch.` (then the module or class, then the part), so a trace
tells the program's ranges from its caller's. The spans sit at the
layer boundaries: `Predictor.request` (`.prepare`, `.upload`,
`.forward`, `.fetch`), the MVSNet and Vis-MVSNet forwards (`features`,
`sweep`, `regularize`, `fuse`, `regress`), `batch_to_device` and
`train_step` (`.forward`, `.loss`, `.backward`, `.optimizer`). Their
ranges share the trace's clock with the device records, so the idle
gaps and device time between launches can be put down to them.

Beside the spans: `Predictor` stages its inputs in pinned host buffers
from PyTorch's caching host allocator, and `torch.cuda.host_memory_stats()`
counts that allocator's blocks; its `num_host_alloc` grows only when a
request finds no freed block to reuse.
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

_UNTRACED = contextlib.nullcontext()


def span(name: str):
    """A trace range named `name` (`wildmvs_torch.<module>.<part>`) while a
    torch.profiler is recording; a shared no-op context otherwise."""
    if not torch._C._autograd._profiler_enabled():
        return _UNTRACED
    return torch.profiler.record_function(name)


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

    def plot_ims(self, ims: dict, prefix: str = ""):
        """Save [H, W, C], [H, W] or [B, H, W, C] arrays in [0, 1] (the
        first of a batch) as `<logdir>/<prefix><name>.jpg` (needs PIL)."""
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("Logger.plot_ims writes jpgs with PIL "
                              "(the `pillow` package)") from e
        for name, im in ims.items():
            arr = np.asarray(im)
            if arr.ndim == 4:
                arr = arr[0]
            if arr.ndim == 2:
                arr = np.repeat(arr[..., None], 3, axis=-1)
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            Image.fromarray(arr).save(self.logdir / f"{prefix}{name}.jpg")

    def depth_panel(self, depth, depth_min: float, depth_max: float,
                    name: str = "depth_est"):
        """A depthmap ([H, W] or the first of [B, H, W]) normalized to the
        depth range (reference models/trainer.py:86-92)."""
        d = np.asarray(depth)
        if d.ndim == 3:
            d = d[0]
        norm = np.clip((d - depth_min) / max(depth_max - depth_min, 1e-9),
                       0, 1)
        self.plot_ims({name: norm})


def training_panels(batch: dict, depth_est=None, ref_idx: int = 0) -> dict:
    """The training images logged every print_every steps: ref_img,
    src_img_{k} (reference models/trainer.py:78-85) and, with a predicted
    depth, the source views warped into the reference by it,
    `warped_ref{r}src_{i}` (models/trainer.py:258-276), zero outside the
    source's frustum. `batch` holds tensors or arrays ([B, N, H, W, C]
    images, K/R/t at image resolution); returns numpy arrays of the first
    batch element."""
    from ..geometry.projective import build_proj_matrices
    from ..losses.photometric import warped_src_views
    from ..losses.supervised import resize_bilinear

    def f32(x):                                   # on the host, f32
        return (x.detach().cpu() if torch.is_tensor(x)
                else torch.as_tensor(np.asarray(x))).float()
    imgs = f32(batch["imgs"])                     # [B, N, H, W, C]
    n, h, w = imgs.shape[1:4]
    src = [i for i in range(n) if i != ref_idx]
    out = {"ref_img": imgs[0, ref_idx].numpy()}
    for k, i in enumerate(src):
        out[f"src_img_{k}"] = imgs[0, i].numpy()
    if depth_est is not None:
        d = resize_bilinear(f32(depth_est), (h, w))
        proj = build_proj_matrices(f32(batch["K"]), f32(batch["R"]),
                                   f32(batch["t"]))
        warped, inside = warped_src_views(imgs, d, proj, ref_idx)
        for k, i in enumerate(src):
            out[f"warped_ref{ref_idx}src_{i}"] = torch.clamp(
                warped[0, k] * inside[0, k][..., None], 0.0, 1.0).numpy()
    return out


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


@contextlib.contextmanager
def profiler_trace(logdir, enabled: bool = True):
    """Capture a torch.profiler trace of the block (host and, with a card,
    device activity) into `<logdir>/torch_trace/rank<r>.json`, a Chrome
    trace (chrome://tracing, Perfetto); r is the torch.distributed rank (0
    without a process group). Counterpart of the JAX package's jax.profiler
    capture (wildmvs/utils/monitor.py:143-154)."""
    if not enabled:
        yield
        return
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    rank = dist.get_rank() if dist.is_initialized() else 0
    path = Path(logdir) / "torch_trace" / f"rank{rank}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(path))
