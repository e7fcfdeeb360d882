"""Depth-partitioned 3D convolutions: a regularizer run on this rank's slab
of the hypotheses, as the JAX package's SPMD program partitions its 3D
convs over the `hyp` axis (wildmvs/models/mvsnet.py:279-287: XLA's
collective-permutes of the depth halos).

Inside `depth_partitioned(module, axis, depth)`, module(x) takes this
rank's slab of a channels-last volume [B, D, H, W, C] whose depth D is
`depth` long and split over the axis by `slab_bounds`, and returns its
slab of the output, as the regularizers take and return them.
Every level of the network is split the same way, by `slab_bounds` of that
level's own length, so a skip addition or a concatenation of two tensors
of one level adds slabs that line up, uneven ones too; only the
convolutions read across slab edges:

  Conv3d(k, s, p)                output planes [olo, ohi) read input planes
                                 [s olo - p, s (ohi - 1) - p + k)
  ConvTranspose3d(k, s, p, op)   the planes that map onto [olo, ohi):
                                 [ceil((olo + p - k + 1) / s),
                                  floor((ohi - 1 + p) / s) + 1)

Each fetches that range (`dist.mesh.fetch_range`: its own planes, its
neighbours' boundary planes through one all_reduce the size of the halos,
zeros outside the volume) and runs with depth padding 0, H and W keeping
theirs; the transposed conv then keeps the planes [olo, ohi) of its
output. A rank whose output slab is empty (a level shorter than the axis)
convolves one plane of zeros and keeps none of it, so that every rank
runs the same operations and joins every collective, in the same order,
forward and backward.

A level's length is not known from a slab alone (4 planes of 8 and of 7
look alike), so the first call of a network at a given input shape runs
it on the meta device at the whole volume's shape and records each conv's
input depth, kept for the network's later calls.

BatchNorm: in eval mode it stays local. In train mode it normalizes over
the slabs of every rank of the axis (nn/blocks `_synced_bn_forward`), and
where the step already syncs BatchNorm over `data` (`synced_batch_norm`),
over the data x hyp plane of the ambient mesh: the whole batch's volume,
as the unsharded program's.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import _synced_bn_forward
from .mesh import MeshAxis, active_axis, fetch_range, slab_bounds


def _depth(conv) -> tuple[int, int, int]:
    """(kernel, stride, padding) of a 3D conv along depth."""
    assert conv.dilation[0] == 1 and conv.padding_mode == "zeros", conv
    return conv.kernel_size[0], conv.stride[0], conv.padding[0]


def output_depth(conv, n: int) -> int:
    """The conv's output length along depth for an input n long."""
    k, s, p = _depth(conv)
    if isinstance(conv, nn.ConvTranspose3d):
        return (n - 1) * s - 2 * p + k + conv.output_padding[0]
    return (n + 2 * p - k) // s + 1


def input_range(conv, olo: int, ohi: int) -> tuple[int, int]:
    """The input planes [lo, hi) that output planes [olo, ohi) read (module
    docstring); an empty range for an empty output."""
    k, s, p = _depth(conv)
    if isinstance(conv, nn.ConvTranspose3d):
        assert k >= s, conv
        lo = -((k - 1 - olo - p) // s)               # ceil((olo+p-k+1)/s)
        if ohi <= olo:
            return lo, lo
        return lo, (ohi - 1 + p) // s + 1
    lo = s * olo - p
    return (lo, lo) if ohi <= olo else (lo, s * (ohi - 1) - p + k)


#: network -> {whole input shape: {conv: its input depth}}
_PLANS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


class _State:
    """One `depth_partitioned` block: the axis, the module's input depth,
    and the running call's conv input depths."""

    def __init__(self, axis: MeshAxis, depth: int):
        self.axis, self.depth = axis, depth
        self.plan: Optional[dict] = None
        self.planning = False


def _conv_forward(conv, state: _State, x):
    """The conv on this rank's slab x (N C D H W) of its input level: this
    rank's slab of its output level."""
    transposed = isinstance(conv, nn.ConvTranspose3d)
    if state.planning:                   # the meta pass: record, then shape
        assert state.plan.setdefault(conv, x.shape[2]) == x.shape[2], conv
        w = conv.weight.to(device="meta", dtype=x.dtype)
        if transposed:
            return F.conv_transpose3d(x, w, None, conv.stride, conv.padding,
                                      conv.output_padding, conv.groups)
        return F.conv3d(x, w, None, conv.stride, conv.padding, 1,
                        conv.groups)
    axis = state.axis
    n = state.plan[conv]
    outs = slab_bounds(output_depth(conv, n), axis)
    olo, ohi = outs[axis.index]
    wants = [input_range(conv, a, b) for a, b in outs]
    lo, hi = wants[axis.index]
    xin = fetch_range(x, axis, 2, n, lo, hi, wants)
    k, s, _ = _depth(conv)
    if ohi <= olo:
        # an empty output slab: one output plane's worth of zeros in
        xin = F.pad(xin, (0, 0, 0, 0, 0, 1 if transposed else k))
    pad = (0,) + tuple(conv.padding[1:])
    stride = (s,) + tuple(conv.stride[1:])
    if transposed:
        y = F.conv_transpose3d(xin, conv.weight, conv.bias, stride, pad,
                               (0,) + tuple(conv.output_padding[1:]),
                               conv.groups, conv.dilation)
        start = olo - (s * lo - conv.padding[0])
        return y.narrow(2, start if ohi > olo else 0, ohi - olo)
    y = F.conv3d(xin, conv.weight, conv.bias, stride, pad, conv.dilation,
                 conv.groups)
    return y.narrow(2, 0, ohi - olo)


def _module_forward(module, forward, state: _State, x, *args, **kwargs):
    """module(x) on this rank's slab x: the conv input depths of x's shape
    (a meta pass at the whole volume's shape, the first time), then the
    partitioned forward."""
    key = (x.shape[0], state.depth) + tuple(x.shape[2:])
    plans = _PLANS.setdefault(module, {})
    if key not in plans:
        state.plan, state.planning = {}, True
        try:
            with torch.no_grad():
                forward(torch.empty(key, dtype=x.dtype, device="meta"),
                        *args, **kwargs)
        finally:
            state.planning = False
        plans[key] = state.plan
    state.plan = plans[key]
    return forward(x, *args, **kwargs)


def _bn_forward(bn, state: _State, axis, x):
    if state.planning:
        return x
    return _synced_bn_forward(bn, axis, x)


def _bn_axis(bn, hyp: MeshAxis):
    """The ranks a train-mode BatchNorm inside the partition normalizes
    over: hyp, or the data x hyp plane where it was synced over data."""
    prev = bn.__dict__.get("forward")
    if not (isinstance(prev, functools.partial)
            and prev.func is _synced_bn_forward):
        return hyp
    plane = active_axis("data_hyp")
    assert plane is not None and plane.size == prev.args[1].size * hyp.size, (
        "a data-synced BatchNorm inside a depth partition needs the "
        "ambient mesh's data x hyp plane")
    return plane


@contextlib.contextmanager
def depth_partitioned(module: nn.Module, axis: Optional[MeshAxis],
                      depth: int):
    """Within the block, module(x) runs on this rank's slab x of a
    [B, D, H, W, C] volume `depth` long, split over the axis by
    `slab_bounds`, and returns this rank's slab of its output (module
    docstring). Every rank of the axis must call it alike.
    None or one rank: nothing changes. The backward must run inside the
    block too when it recomputes forwards (remat)."""
    if axis is None or axis.group is None:
        yield
        return
    state = _State(axis, depth)
    kept = {module: module.__dict__.get("forward")}
    for m in module.modules():
        if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
            fwd = functools.partial(_conv_forward, m, state)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            fwd = functools.partial(_bn_forward, m, state, _bn_axis(m, axis))
        else:
            continue
        kept.setdefault(m, m.__dict__.get("forward"))
        m.forward = fwd
    module.forward = functools.partial(_module_forward, module,
                                       module.forward, state)
    try:
        yield
    finally:
        for m, prev in kept.items():
            if prev is None:
                m.__dict__.pop("forward", None)
            else:
                m.forward = prev
