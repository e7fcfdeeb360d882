"""One-call inference API: load a model once, predict depthmaps.

Counterpart of wildmvs/infer.py:30-157. The architecture comes from the
checkpoint (or is given), eval-time overrides are applied, and inputs are
cropped from the top-left to the /32 multiple the network needs (a
top-left crop leaves K unchanged).

    from wildmvs_torch.infer import Predictor
    pred = Predictor("weights.npz")                 # or architecture="mvsnet"
    out = pred(imgs, K, R, t, depth_min, depth_max) # imgs [N, H, W, 3]
    out["depth"], out["confidence"]                 # numpy, f32

Runs on the card ("cuda") unless constructed with device="cpu". With a
`mesh` (dist/mesh.py), every rank of it builds the predictor and calls it
with the same request, which is sharded over the ranks: over "hyp" each
rank sweeps its slab of the depth hypotheses and keeps it through the
depth-partitioned 3D regularizer (dist/depth_parallel.py), over "view"
Vis-MVSNet's source pairs; every rank returns the whole result.
"""
from __future__ import annotations

import os
import queue
import sys
import threading
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device
from .dist.mesh import use_mesh, world
from .models import build_model
from .pipeline.depthmaps import eval_model_kwargs
from .train.checkpoint import resolve_checkpoint
from .train.jax_import import load_weights
from .utils.monitor import span

SPAN = "wildmvs_torch.Predictor"


class Predictor:
    """A loaded eval network with input normalization.

    Args:
      model_path: an npz (JAX `save_params_npz`) or torch checkpoint
        file, a JAX orbax checkpoint directory, or a logdir (its newest
        checkpoint); None for seeded random weights (seed 0; smoke and
        performance runs).
      architecture: mvsnet | mvsnet-s | vis_mvsnet | cvp_mvsnet |
        cas_mvsnet; read from the checkpoint if None.
      bf16: run the networks in bf16 (default) or f32.
      cvp_nscale: cvp_mvsnet's pyramid levels (default 4; the reference
        evaluates DTU at 5 and other scenes at 4, pipeline_utils.py:133-139).
      sweep_method: cost-volume backend (models/mvsnet.py,
        models/vis_mvsnet.py, models/cvp_mvsnet.py,
        models/cas_mvsnet.py); "auto" is each
        architecture's eval default (`eval_model_kwargs`: the rectified
        sweep "rect" for cvp_mvsnet).
      device: "cuda" (default; raises without a card) or "cpu".
      mesh: a dist.mesh.Mesh to shard each request over (module
        docstring), or None.
    """

    def __init__(self, model_path: str | Path | None = None,
                 architecture: str | None = None, bf16: bool = True,
                 cvp_nscale: int | None = None, sweep_method: str = "auto",
                 device: str | torch.device | None = None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        state_dict = None
        if model_path is not None:
            state_dict, ckpt_arch = load_weights(
                resolve_checkpoint(model_path))
            architecture = architecture or ckpt_arch
        if architecture is None:
            raise ValueError("need model_path or architecture")
        self.architecture = architecture
        cfg = eval_model_kwargs(architecture, bf16=bf16,
                                sweep_method=sweep_method)
        kwargs = dict(cfg["kwargs"])
        if mesh is not None:
            kwargs["hyp_axis"] = "hyp"
            if architecture == "vis_mvsnet":
                kwargs["view_axis"] = "view"
        self.model = build_model(architecture, device=self.device, **kwargs)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.eval()
        #: output resolution = input resolution / downscale
        self.downscale = cfg["downscale"]
        #: forward kwargs of the architecture's eval configuration
        self.forward_kwargs = {}
        if architecture == "cvp_mvsnet":
            self.forward_kwargs["nscale"] = (4 if cvp_nscale is None
                                             else cvp_nscale)

    @staticmethod
    def _crop32(imgs: np.ndarray) -> np.ndarray:
        """Top-left crop of [..., H, W, 3] to /32 multiples."""
        h, w = imgs.shape[-3:-1]
        nh, nw = (h // 32) * 32, (w // 32) * 32
        if nh == 0 or nw == 0:
            raise ValueError(f"images too small: {h}x{w} (need >= 32x32)")
        return imgs[..., :nh, :nw, :]

    @classmethod
    def _views(cls, imgs) -> tuple[list, bool, bool]:
        """(views, ragged, batched): the request's views, each [B, h, w, 3]
        cropped to /32 without a copy; whether they came as a list of
        different sizes (each then cropped on its own and handed to the
        model as a list); whether the input had a batch axis."""
        if isinstance(imgs, (list, tuple)):
            views = [np.asarray(v) for v in imgs]
            ragged = len({v.shape[-3:-1] for v in views}) > 1
        else:
            a = np.asarray(imgs)
            views = ([a[:, i] for i in range(a.shape[1])] if a.ndim == 5
                     else list(a))
            ragged = False
        batched = views[0].ndim == 4
        return ([cls._crop32(v if batched else v[None]) for v in views],
                ragged, batched)

    @staticmethod
    def _cams(K, R, t, depth_min, depth_max, nb: int, n: int) -> list:
        """K, R, t as f32 [B, N, r, c] (missing leading axes as 1) and the
        depth range as f32 [B, N] (scalars broadcast)."""
        def prep(a):                 # [., N, r, c] -> [B, N, r, c]
            a = np.asarray(a, np.float32)
            while a.ndim < 4:
                a = a[None]
            return a

        def prep_range(a):
            a = np.asarray(a, np.float32)
            return np.broadcast_to(a, (nb, n)) if a.ndim < 2 else a

        return [prep(K), prep(R), prep(t), prep_range(depth_min),
                prep_range(depth_max)]

    def __call__(self, imgs, K, R, t, depth_min, depth_max,
                 reference_frame: int = 0) -> dict:
        """imgs [N, H, W, 3] or [B, N, H, W, 3] float in [0, 1], or a list
        of per-view [Hi, Wi, 3] / [B, Hi, Wi, 3] arrays of different sizes
        (each cropped on its own); K/R [., N, 3, 3], t [., N, 3, 1],
        depth_min/max [., N] or scalars. Returns numpy f32 {depth,
        confidence} (vis_mvsnet: one confidence per stage, [3, h, w]),
        without the batch axis when the input had none.

        Each input is copied once, straight from the caller's array, into
        a host buffer of this request's own and uploaded asynchronously
        (`_stage`). So a call leaves nothing in the Predictor: threads
        that share one do not share its inputs' buffers. (The model's
        forward is not tested under concurrent calls, and a `mesh` is
        ambient to the whole process: serve a mesh from one thread.)

        Under a profiler a call records the span
        `wildmvs_torch.Predictor.request` and, inside it, `.prepare` (the
        views' crop; the host buffers and the cameras' copy into theirs;
        each view's copy into its slot, or for a large view the calling
        thread's share of it and its wait for the copy team's), `.upload`
        (the enqueue of the cameras' asynchronous copy, then of each
        view's after its `.prepare`), `.forward` and `.fetch`. The copy
        team's threads record no span."""
        with span(f"{SPAN}.request"):
            with span(f"{SPAN}.prepare"):
                views, ragged, batched = self._views(imgs)
                nb, n = views[0].shape[0], len(views)
                cams = self._cams(K, R, t, depth_min, depth_max, nb, n)
            with torch.inference_mode(), use_mesh(self.mesh):
                x, cams = _stage(views, ragged, cams, self.device)
                with span(f"{SPAN}.forward"):
                    out = self.model(x, *cams,
                                     reference_frame=reference_frame,
                                     **self.forward_kwargs)
                with span(f"{SPAN}.fetch"):
                    depth = out["depth"].float().cpu().numpy()
                    conf = out["photometric_confidence"].float().cpu().numpy()
        if not batched:
            depth, conf = depth[0], conf[0]
        return {"depth": depth, "confidence": conf}


#: each camera array starts on a multiple of this many f32 (256 bytes) of
#: the flat buffer, as aligned as a tensor of its own, since a kernel that
#: reads it may choose its path by alignment
_ALIGN = 64
#: a view of at least this many f32 bytes (over its batch) is copied by
#: the copy team and the calling thread together, a smaller one by the
#: calling thread alone. On an 8-core H100 host (tools/time_stage.py) a
#: team of 4 took a 5-view request's copies from 23.1 to 6.3 ms at 22.7 MB
#: a view (p90 25.3 to 7.1). At 3.9 MB (512x640) one such host gained
#: (4.1 to 1.6 ms) and another lost (3 views: 2.4 to 3.3 ms, p90 2.7 to
#: 4.8; and at every size down to 1 MB), so views up to 512x640 at B 2
#: (7.9 MB) stay on the calling thread.
_TEAM_MIN_BYTES = 8 << 20
#: a team view's copy is split into row ranges of about this many bytes
#: (1, 2 and 4 MiB measured alike within 10 % there)
_CHUNK_BYTES = 2 << 20
#: the most workers the copy team takes: 4 were fastest of 1-6 on that
#: host, and 3 served the 1184x1600 cell 8 % slower than 4
_TEAM_MAX = 4

_STATS = dict.fromkeys(("requests", "team_requests", "chunks",
                        "worker_chunks"), 0)
_STATS_LOCK = threading.Lock()
_TEAM = [None]                  # (pid, workers, queue) of the running team
_TEAM_LOCK = threading.Lock()


def staging_stats() -> dict:
    """The process's tally of `_stage`: requests staged, requests whose
    views went through the copy team, chunks copied on the team's path,
    and those of them that workers copied (the rest the calling
    threads)."""
    with _STATS_LOCK:
        return dict(_STATS)


def _team_workers() -> int:
    """Copy workers this process may run: half of its share of the cores
    it may use, the default group's ranks taken to share this host (a
    serving mesh spans one host's cards), and at most `_TEAM_MAX`. The
    other half is left to the calling thread and the CUDA runtime's."""
    share = len(os.sched_getaffinity(0)) // world()[0]
    return min(_TEAM_MAX, share // 2)


def _team(workers: int):
    """The copy team's queue, with `workers` threads waiting on it: started
    on first use, and again in a forked child (its parent's threads did
    not follow it) or when the size the process may run has changed."""
    pid = os.getpid()
    with _TEAM_LOCK:
        team = _TEAM[0]
        if team is None or team[:2] != (pid, workers):
            if team is not None and team[0] == pid:
                for _ in range(team[1]):
                    team[2].put(None)               # retires a worker
            q = queue.SimpleQueue()
            for _ in range(workers):
                threading.Thread(target=_copy_worker, args=(q,), daemon=True,
                                 name="wildmvs_torch.stage").start()
            _TEAM[0] = team = (pid, workers, q)
        return team[2]


def _copy_worker(q) -> None:
    """A team thread: wait for a request's copies (a blocking wait, never a
    spin), copy its chunks until none is left unclaimed, wait again."""
    while (copies := q.get()) is not None:
        copies.run(worker=True)


class _Copies:
    """One request's chunk copies, (unit, destination, source) in unit
    order, a unit being one batch item of one view (uploaded as one).
    The calling thread and the team's workers claim them one at a time;
    numpy's assignment releases the GIL for the copy itself. The calling
    thread copies chunks up to the unit it waits for, then waits for that
    unit's chunks in flight. The first error a chunk meets stops further
    claims and is raised on the calling thread; `close` stops claims,
    waits for the chunks in flight and drops every reference, so a worker
    that finds this object in the queue later holds nothing of the
    request."""

    def __init__(self, chunks: list, units: int):
        self.chunks = chunks
        self.next = 0                           # the first unclaimed chunk
        self.left = [0] * units                 # chunks not finished, a unit
        for c in chunks:
            self.left[c[0]] += 1
        self.by_workers = 0
        self.error = None
        self.cond = threading.Condition()

    def _claim(self, last: int):
        with self.cond:
            if (self.next < len(self.chunks)
                    and self.chunks[self.next][0] <= last):
                self.next += 1
                return self.chunks[self.next - 1]
        return None

    def _cancel(self) -> None:
        """Forget the unclaimed chunks (under `cond`)."""
        for c in self.chunks[self.next:]:
            self.left[c[0]] -= 1
        self.next = len(self.chunks)

    def run(self, last: int = sys.maxsize, worker: bool = False) -> None:
        """Copy unclaimed chunks of the units up to `last`, in order."""
        while (chunk := self._claim(last)) is not None:
            unit, dst, src = chunk
            error = None
            try:
                dst[...] = src
            except Exception as e:              # raised by `wait`
                error = e
            finally:
                with self.cond:
                    self.left[unit] -= 1
                    self.by_workers += worker
                    if error is not None and self.error is None:
                        self.error = error
                        self._cancel()
                    if self.error is not None or not self.left[unit]:
                        self.cond.notify_all()

    def wait(self, unit: int) -> None:
        """Copy up to `unit`, then wait until its chunks are done; raise
        the error a chunk met."""
        self.run(unit)
        with self.cond:
            self.cond.wait_for(
                lambda: self.error is not None or not self.left[unit])
            if self.error is not None:
                raise self.error

    def close(self) -> None:
        with self.cond:
            self._cancel()
            self.cond.wait_for(lambda: not any(self.left))
            self.chunks, self.error = [], None


def _stage(views: list, ragged: bool, cams: list,
           device: torch.device) -> tuple:
    """Views [B, h, w, 3] (any dtype; one size unless `ragged`) and f32
    camera arrays to `device`, each copied once on the host. Returns (the
    images [B, N, h, w, 3], or a list of [B, h_i, w_i, 3] when `ragged`;
    the cameras as tensors of their shapes).

    Each view is copied, cast to f32 by numpy's assignment, into its slot
    of a host buffer of this request's own: one [B, N, h, w, 3] for
    stacked views, one [B, h_i, w_i, 3] each for ragged ones. A view of
    `_TEAM_MIN_BYTES` or more is split into row ranges of about
    `_CHUNK_BYTES`, which the calling thread and a process-wide copy team
    (`_team`: a few threads that block while idle) claim one at a time,
    view after view; a smaller view is copied on the calling thread
    alone. Torch's own copy would split it over the intra-op OpenMP team,
    one thread a core, which spin after each region and each take an
    equal share: where other threads share the cores (the CUDA runtime's,
    other processes'), one preempted member holds the whole copy back,
    and on an 8-core H100 host a tenth of the 512x640 requests took 1.5x
    the median. A preempted team worker holds back only the chunk it
    claimed. `staging_stats()` counts how often the team engages. The
    cameras share one flat buffer and one upload and are sliced on the
    device. On the card the buffers are pinned, and each slot's upload is
    enqueued by the calling thread with `non_blocking=True` as soon as its
    chunks are done, so its DMA overlaps the copy of the next view.
    PyTorch's caching host allocator keeps a freed pinned block for the
    next request (`torch.cuda.host_memory_stats()["num_host_alloc"]`
    counts the blocks it had to allocate) and records an event on every
    asynchronous copy out of it, so it hands the block out again only
    once those copies are done. The device tensors are new ones from the
    caching allocator. On the CPU the host buffers are the model's inputs,
    and each upload is a copy onto itself, which returns at once.
    """
    if ragged:
        shapes = [tuple(v.shape) for v in views]
    else:
        if len({v.shape for v in views}) > 1:
            raise ValueError("all input arrays must have the same shape")
        shapes = [(views[0].shape[0], len(views)) + views[0].shape[1:]]
    starts = [0]
    for c in cams:
        starts.append(starts[-1] + -(-c.size // _ALIGN) * _ALIGN)
    nb = views[0].shape[0]
    workers = _team_workers()
    big = {i for i, v in enumerate(views)
           if workers and 4 * v.size >= _TEAM_MIN_BYTES}
    pin = device.type == "cuda"
    with span(f"{SPAN}.prepare"):
        host = [torch.empty(s, dtype=torch.float32, pin_memory=pin)
                for s in shapes]
        flat = torch.empty(starts[-1], dtype=torch.float32, pin_memory=pin)
        flat_np = flat.numpy()
        for c, o in zip(cams, starts):
            flat_np[o:o + c.size] = c.reshape(-1)
        slots = [host[i] if ragged else host[0][:, i]
                 for i in range(len(views))]
        chunks = []
        for i in sorted(big):
            for b in range(nb):
                dst, src = slots[i][b].numpy(), views[i][b]
                k = -(-dst.nbytes // _CHUNK_BYTES)
                rows = [len(dst) * j // k for j in range(k + 1)]
                chunks += [(i * nb + b, dst[r0:r1], src[r0:r1])
                           for r0, r1 in zip(rows, rows[1:])]
        copies = _Copies(chunks, len(views) * nb)
        if big:
            q = _team(workers)
            for _ in range(workers):
                q.put(copies)
    try:
        with span(f"{SPAN}.upload"):
            flat = flat.to(device, non_blocking=True)
        dev = ([torch.empty(s, dtype=torch.float32, device=device)
                for s in shapes] if pin else host)
        for i, v in enumerate(views):
            out = dev[i] if ragged else dev[0][:, i]
            for b in range(nb):
                with span(f"{SPAN}.prepare"):
                    if i in big:
                        copies.wait(i * nb + b)
                    else:
                        slots[i][b].numpy()[...] = v[b]
                with span(f"{SPAN}.upload"):
                    out[b].copy_(slots[i][b], non_blocking=True)
    finally:
        copies.close()
    with _STATS_LOCK:
        _STATS["requests"] += 1
        _STATS["team_requests"] += bool(big)
        _STATS["chunks"] += len(chunks)
        _STATS["worker_chunks"] += copies.by_workers
    return (dev if ragged else dev[0],
            [flat[o:o + c.size].view(c.shape) for c, o in zip(cams, starts)])
