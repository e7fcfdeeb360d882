"""Named process groups over the ranks, and the collectives the sharded
paths use: the port's counterpart of wildmvs/dist/mesh.py.

Axes, as in the JAX package:
  data  the batch split over ranks (DistributedSampler + DDP's gradient
        mean in the reference, train.py:112-136); with data > 1 the
        plain train step syncs BatchNorm over it (nn/blocks.py
        `synced_batch_norm`), so the step equals the single-program step
        on the whole batch, as JAX's SPMD step does.
  view  reference views (view-parallel occlusion-masked training,
        dist/view_parallel.py) or Vis-MVSNet's source pairs (serving).
  hyp   the depth hypotheses: each rank sweeps a contiguous slab and keeps
        it through the 3D regularizer (dist/depth_parallel.py: each conv
        fetches its boundary planes from the neighbouring slabs,
        `fetch_range`) and the reductions over depth (ops/volumes.py,
        `Slab`).
  data_hyp  the data x hyp plane of ranks that share a view index: a
        partitioned regularizer's train-mode BatchNorm normalizes over it
        when the step syncs BatchNorm over data.

JAX's one SPMD program over a device mesh becomes one process a rank, on
torch.distributed (gloo or nccl): `spawn` starts the ranks as processes
(the training CLI, entry.dryrun_multichip), or torchrun does and each
calls `initialize`. `make_mesh` builds a process group for each line of
the (data, view, hyp) grid; `use_mesh` makes a mesh ambient,
as `jax.set_mesh` does, so that a model built with `hyp_axis="hyp"` shards
inside the context and runs unsharded outside it.

Every collective here is an all_reduce or a broadcast, which gloo serves
for CPU and CUDA tensors alike (its all_gather and send/recv take CPU
tensors only): a gather is an all_reduce(SUM) of a zero-filled tensor into
which each rank wrote its own slab, which adds zeros only and so equals a
gather bit for bit; `fetch_range` does the same with a buffer the size of
the halos. Each rank counts the bytes it hands to collectives
(`collective_bytes`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import socket
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "view", "hyp")

_BYTES = [0]


def collective_bytes() -> int:
    """Bytes this process has handed to all_reduce and broadcast since the
    last `reset_collective_bytes` (each call's buffer, once)."""
    return _BYTES[0]


def reset_collective_bytes() -> None:
    _BYTES[0] = 0


def _all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    """dist.all_reduce in place, counted."""
    _BYTES[0] += t.numel() * t.element_size()
    dist.all_reduce(t, op=op, group=group)


def initialize(backend: str = "gloo", init_method: str = "env://",
               world_size: int = 1, rank: int = 0,
               timeout_s: Optional[int] = None) -> None:
    """Join the default process group (a no-op for one process or when it
    is already joined). Counterpart of jax.distributed.initialize; the
    reference's gloo init (train.py:52-62) with the address given, e.g.
    init_method="tcp://localhost:29500"."""
    if world_size <= 1 or dist.is_initialized():
        return
    kw = ({} if timeout_s is None
          else {"timeout": datetime.timedelta(seconds=timeout_s)})
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)


def world() -> tuple[int, int]:
    """(size, rank) of the default group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _spawned(rank, fn, n, backend, init_method, device, path, args):
    """One rank started by `spawn`: take its card (or a share of the CPU's
    threads), join the group, run fn, leave; save what fn returned."""
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    initialize(backend, init_method, n, rank)
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(path, f"rank{rank}.pt"))


def spawn(fn, n: int, *args, backend: str = "gloo", device: str = "cpu"):
    """Run fn(rank, *args) on n processes (torch.multiprocessing, spawn)
    joined over `backend` at a free localhost port; rank r on
    cuda:(r % cards) with device="cuda", else on the CPU. fn must be a
    module-level function. Returns the n return values, in rank order;
    raises if a rank failed."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(
            _spawned, args=(fn, n, backend, f"tcp://127.0.0.1:{port}",
                            device, tmp, args),
            nprocs=n, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """This rank's line along one axis: its process group (None when the
    axis has size 1), the axis size, this rank's index on it and the
    global ranks of the line, in axis order."""
    name: str
    group: object
    size: int
    index: int
    ranks: tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, view, hyp) grid of every rank of the default group. `axes`
    holds this rank's line along each of the three and "all", every
    rank."""
    shape: dict
    axes: dict

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def axis(self, name: str) -> MeshAxis:
        return self.axes[name]

    def index(self, name: str) -> int:
        return self.axes[name].index


def _new_group(ranks):
    """The default group when `ranks` are all of it, else a new group (which
    every rank of the default group must create, members or not)."""
    size, _ = world()
    if len(ranks) == size:
        return dist.group.WORLD
    return dist.new_group(ranks=list(ranks))


def make_mesh(data: int = 0, view: int = 1, hyp: int = 1) -> Mesh:
    """A (data, view, hyp) mesh over every rank of the default group (this
    process alone without one); data=0 takes the ranks left over. Every
    rank must call it, with the same arguments, in the same order
    (process groups are created collectively)."""
    n, me = world()
    if data == 0:
        assert n % (view * hyp) == 0, (n, view, hyp)
        data = n // (view * hyp)
    assert data * view * hyp == n, (data, view, hyp, n)
    grid = np.arange(n).reshape(data, view, hyp)
    shape = {"data": data, "view": view, "hyp": hyp}
    where = tuple(int(c[0]) for c in np.nonzero(grid == me))
    axes = {}
    for a, name in enumerate(AXES):
        mine = (None, (me,))
        if shape[name] > 1:
            lines = np.moveaxis(grid, a, -1).reshape(-1, shape[name])
            for line in lines:           # collective: every rank, every line
                line = tuple(int(r) for r in line)
                g = _new_group(line)
                if me in line:
                    mine = (g, line)
        axes[name] = MeshAxis(name, mine[0], shape[name], where[a], mine[1])
    axes["data_hyp"] = _plane(grid, where, axes)
    axes["all"] = MeshAxis("all", dist.group.WORLD if n > 1 else None, n, me,
                           tuple(range(n)))
    return Mesh(shape, axes)


def _plane(grid, where, axes) -> MeshAxis:
    """This rank's data x hyp plane (the ranks of its view index, in
    (data, hyp) order): the data or hyp axis itself when the other has size
    1, else a group of its own (every rank creates every plane's)."""
    data, hyp = axes["data"], axes["hyp"]
    if data.size == 1 or hyp.size == 1:
        line = hyp if data.size == 1 else data
        return dataclasses.replace(line, name="data_hyp")
    mine = None
    for v in range(grid.shape[1]):
        ranks = tuple(int(r) for r in grid[:, v, :].reshape(-1))
        g = _new_group(ranks)
        if v == where[1]:
            mine = (g, ranks)
    return MeshAxis("data_hyp", mine[0], len(mine[1]),
                    where[0] * hyp.size + where[2], mine[1])


def process_local_order(order, global_batch_size: int,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None):
    """Per-process slice of the epoch's shared permutation (a copy of
    wildmvs/dist/mesh.py:process_local_order).

    Every process derives the same permutation (same seed), so each global
    batch is a row of order.reshape(-1, B); process p loads columns
    [p*B/P, (p+1)*B/P) of every row — its local shard of each global batch.
    Tail samples are wrap-padded so all processes hold equal counts (parity:
    DistributedSampler's pad-to-even behavior behind train.py:112-116).

    Returns (local_order, local_batch_size). Identity when P == 1.
    """
    size, rank = world()
    procs = size if num_processes is None else num_processes
    pid = rank if process_id is None else process_id
    order = np.asarray(order)
    if procs == 1:
        return order, global_batch_size
    B = global_batch_size
    assert B % procs == 0, (B, procs)
    if len(order) % B:
        pad = B - len(order) % B
        order = np.concatenate([order, order[:pad]])
    per = B // procs
    rows = order.reshape(-1, B)[:, pid * per:(pid + 1) * per]
    return rows.reshape(-1), per


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a (whole) batch, its leading dim split over
    `data`; the file names stay with their rows."""
    ax = mesh.axis("data")
    if ax.size == 1:
        return batch
    out = {}
    for k, v in batch.items():
        per = len(v) // ax.size
        assert per * ax.size == len(v), (k, len(v), ax.size)
        out[k] = v[ax.index * per:(ax.index + 1) * per]
    return out


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Give every rank of the mesh the parameters and buffers of its first
    rank: one broadcast of them all."""
    ax = mesh.axis("all")
    if ax.group is None:
        return module
    tensors = list(module.parameters()) + list(module.buffers())
    flat = torch.cat([t.detach().reshape(-1).double() for t in tensors])
    _BYTES[0] += flat.numel() * flat.element_size()
    dist.broadcast(flat, src=ax.ranks[0], group=ax.group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return module


# ---------------------------------------------------------------------------
# the ambient mesh (jax.set_mesh)
# ---------------------------------------------------------------------------

_AMBIENT: list = []


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make `mesh` ambient within the block (None: leave as is)."""
    if mesh is None:
        yield None
        return
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def active_axis(name: Optional[str]) -> Optional[MeshAxis]:
    """The ambient mesh's axis `name` when it spans more than one rank,
    else None (no ambient mesh, no such axis, or size 1): a model then
    runs unsharded, as the JAX models do outside jax.set_mesh."""
    if name is None or not _AMBIENT:
        return None
    ax = _AMBIENT[-1].axes.get(name)
    return ax if ax is not None and ax.size > 1 else None


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce(x: torch.Tensor, axis: Optional[MeshAxis],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of `x` over the axis (no autograd); `x` itself when
    the axis spans one rank."""
    if axis is None or axis.group is None:
        return x
    y = x.detach().contiguous().clone()
    _all_reduce_(y, axis.group, op)
    return y


class _AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) whose backward is the all_reduce(SUM) of the
    cotangent: the sum's adjoint on every rank, each rank's loss counting
    for its own. Where every rank of the axis holds the same loss, each
    must back-propagate loss / ranks (train/trainer.py's rule)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


def all_reduce_sum(x: torch.Tensor, axis: Optional[MeshAxis]):
    """all_reduce(SUM) over the axis, differentiable (see _AllReduceSum)."""
    if axis is None or axis.group is None:
        return x
    return _AllReduceSum.apply(x, axis)


@torch.no_grad()
def sum_gradients(module: torch.nn.Module, axis: Optional[MeshAxis]) -> None:
    """Sum the parameters' gradients over the axis, in f32, with one
    all_reduce of them all. Every rank runs the same graph, so a parameter
    has a gradient on every rank or on none."""
    if axis is None or axis.group is None:
        return
    params = [p for p in module.parameters() if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1).float() for p in params])
    _all_reduce_(flat, axis.group)
    offset = 0
    for p in params:
        p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()


def slab_bounds(n: int, axis: Optional[MeshAxis]) -> list:
    """[(lo, hi)] of each rank's contiguous slab of n items over the axis
    (np.array_split's sizes: the first n % size slabs one longer)."""
    size = 1 if axis is None else axis.size
    edges = np.cumsum([0] + [len(s) for s in
                             np.array_split(np.arange(n), size)])
    return [(int(edges[i]), int(edges[i + 1])) for i in range(size)]


def my_slab(n: int, axis: Optional[MeshAxis]) -> tuple[int, int]:
    """(lo, hi) of this rank's slab of n items over the axis."""
    return slab_bounds(n, axis)[0 if axis is None else axis.index]


def _scatter_slab(slab, axis, dim, n):
    lo, hi = my_slab(n, axis)
    assert slab.shape[dim] == hi - lo, (slab.shape, dim, lo, hi)
    shape = list(slab.shape)
    shape[dim] = n
    # the gather runs in f32 (exact for bf16 and f16 slabs: zeros added)
    full = slab.new_zeros(shape, dtype=torch.promote_types(slab.dtype,
                                                           torch.float32))
    full.narrow(dim, lo, hi - lo).copy_(slab)
    return full, lo, hi


class _GatherSlabs(torch.autograd.Function):
    """Concatenate every rank's slab along `dim`; the backward sums the
    cotangent over the axis and keeps this rank's slab (reduce-scatter,
    all_gather's adjoint)."""

    @staticmethod
    def forward(ctx, slab, axis, dim, n):
        full, lo, hi = _scatter_slab(slab, axis, dim, n)
        _all_reduce_(full, axis.group)
        ctx.axis, ctx.dim, ctx.lo, ctx.hi = axis, dim, lo, hi
        ctx.dtype = slab.dtype
        return full.to(slab.dtype)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.float(), ctx.axis)
        return (g.narrow(ctx.dim, ctx.lo, ctx.hi - ctx.lo).to(ctx.dtype),
                None, None, None)


def gather_slabs(slab: torch.Tensor, axis: Optional[MeshAxis], dim: int,
                 n: int) -> torch.Tensor:
    """The whole of a tensor split over the axis along `dim` into the
    contiguous slabs of `slab_bounds(n, axis)`, this rank's being `slab`;
    differentiable when `slab` requires grad."""
    if axis is None or axis.group is None:
        return slab
    return _GatherSlabs.apply(slab, axis, dim, n)


# ---------------------------------------------------------------------------
# depth slabs: this rank's slab, and the halos of its neighbours
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Slab:
    """This rank's slab [lo, hi) of n items split over `axis` by
    `slab_bounds`: what a reduction over the split dimension needs to
    number its items globally and to sum over the axis."""
    axis: MeshAxis
    n: int
    lo: int
    hi: int


def depth_slab(n: int, axis: Optional[MeshAxis]) -> Optional[Slab]:
    """This rank's Slab of n items over the axis; None when the axis spans
    one rank (the unsharded program)."""
    if axis is None or axis.group is None:
        return None
    return Slab(axis, n, *my_slab(n, axis))


def _halo_segments(bounds, wants, n):
    """The planes each rank wants within [0, n) but does not own, as
    (rank, lo, hi, offset) runs of one buffer, in rank order; and the
    buffer's length."""
    segs, off = [], 0
    for r, ((own_lo, own_hi), (lo, hi)) in enumerate(zip(bounds, wants)):
        lo, hi = max(lo, 0), min(hi, n)
        for a, b in ((lo, min(hi, own_lo)), (max(lo, own_hi), hi)):
            if b > a:
                segs.append((r, a, b, off))
                off += b - a
    return segs, off


def _zeros_as(x: torch.Tensor, dim: int, length: int) -> torch.Tensor:
    """Zeros shaped as x with `length` along dim, in x's memory format."""
    shape = list(x.shape)
    shape[dim] = length
    fmt = (torch.channels_last_3d if x.dim() == 5 and not x.is_contiguous()
           and x.is_contiguous(memory_format=torch.channels_last_3d)
           else torch.contiguous_format)
    return torch.empty(shape, dtype=x.dtype, device=x.device,
                       memory_format=fmt).zero_()


class _FetchRange(torch.autograd.Function):
    """Planes [lo, hi) of a tensor split into slabs along `dim`: this
    rank's own planes, its neighbours' through one all_reduce of a
    zero-filled buffer the size of every rank's halos, zeros outside
    [0, n). The backward returns each borrowed plane's cotangent to its
    owner, which adds it, through the same buffer."""

    @staticmethod
    def forward(ctx, x, axis, dim, n, wants, segs, total):
        bounds = slab_bounds(n, axis)
        me = axis.index
        own_lo, own_hi = bounds[me]
        buf = _zeros_as(x, dim, total)
        for r, a, b, off in segs:
            lo, hi = max(a, own_lo), min(b, own_hi)
            if r != me and hi > lo:
                buf.narrow(dim, off + lo - a, hi - lo).copy_(
                    x.narrow(dim, lo - own_lo, hi - lo))
        _all_reduce_(buf, axis.group)
        lo, hi = wants[me]
        out = _zeros_as(x, dim, hi - lo)
        a, b = max(lo, own_lo), min(hi, own_hi)
        if b > a:
            out.narrow(dim, a - lo, b - a).copy_(
                x.narrow(dim, a - own_lo, b - a))
        for r, a, b, off in segs:
            if r == me:
                out.narrow(dim, a - lo, b - a).copy_(
                    buf.narrow(dim, off, b - a))
        ctx.args = (axis, dim, n, wants, segs, total)
        ctx.x_shape = x.shape
        return out

    @staticmethod
    def backward(ctx, g):
        axis, dim, n, wants, segs, total = ctx.args
        me = axis.index
        own_lo, own_hi = slab_bounds(n, axis)[me]
        lo, hi = wants[me]
        buf = _zeros_as(g, dim, total)
        for r, a, b, off in segs:
            if r == me:
                buf.narrow(dim, off, b - a).copy_(g.narrow(dim, a - lo, b - a))
        _all_reduce_(buf, axis.group)
        gx = g.new_zeros(ctx.x_shape)
        a, b = max(lo, own_lo), min(hi, own_hi)
        if b > a:
            gx.narrow(dim, a - own_lo, b - a).copy_(
                g.narrow(dim, a - lo, b - a))
        for r, a, b, off in segs:
            lo2, hi2 = max(a, own_lo), min(b, own_hi)
            if r != me and hi2 > lo2:
                gx.narrow(dim, lo2 - own_lo, hi2 - lo2).add_(
                    buf.narrow(dim, off + lo2 - a, hi2 - lo2))
        return gx, None, None, None, None, None, None


def fetch_range(x: torch.Tensor, axis: MeshAxis, dim: int, n: int,
                lo: int, hi: int, wants) -> torch.Tensor:
    """Planes [lo, hi) along `dim` of an n-long dimension split over the axis
    by `slab_bounds`, of which `x` is this rank's slab; planes outside
    [0, n) are zeros (a convolution's zero padding). Differentiable: each
    borrowed plane's cotangent returns to its owner.

    Every rank of the axis calls it, each with its own range; `wants` is
    every rank's (lo, hi) in axis order, which each rank needs for the
    layout of the shared halo buffer. When no rank wants a plane it does
    not own, no collective runs."""
    own = my_slab(n, axis)
    assert tuple(wants[axis.index]) == (lo, hi), (wants, lo, hi)
    assert x.shape[dim] == own[1] - own[0], (x.shape, dim, own)
    segs, total = _halo_segments(slab_bounds(n, axis), wants, n)
    if total:
        return _FetchRange.apply(x, axis, dim, n, tuple(wants), tuple(segs),
                                 total)
    # nothing to borrow on any rank: this rank's planes and zeros
    a, b = max(lo, own[0]), min(hi, own[1])
    start = a - own[0]
    if b <= a:                                   # all outside [0, n)
        a = b = hi
        start = 0
    pad = [0, 0] * (x.dim() - 1 - dim) + [a - lo, hi - b]
    return torch.nn.functional.pad(x.narrow(dim, start, b - a), pad)
