"""The yardstick's arithmetic: the H100's peaks, the work of each sweep
kernel's job and the bound it sets, and the flops of a request or step.

The kernel rules are copies of the port's `ops/sweep_kernels.*_work`
(bytes: each input read once and the output written once; operations in
f32 from the live samples) with what a smarter kernel need not do taken
out, so that an honest later kernel never reads above its roofline:
  * the projection planes P, Q [3, H, W] and a per-pixel hypothesis
    volume are not inputs: both follow from the 3x3 camera matrices and,
    per pixel, the [H, W] start depth of a cascade stage, which is
    counted instead;
  * the 20 operations a sample for its coordinates are not counted: they
    can be shared between hypotheses.
What stays: 8 operations a live sample and channel (four taps, multiply
and add), the group product and sum of the correlation (2), the
variance's combine (3 a view and channel, 4 a channel). The bound is the
larger of the bytes at 3.35 TB/s and the operations at 67 TFLOP/s.

The flops of a request or a step are those of the benchmark's own plain
reference at the cell's shapes, counted once by
`torch.utils.flop_counter` on the meta device (convolutions and matrix
products), whatever the program dispatches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.flop_counter import FlopCounterMode

#: NVIDIA H100 SXM data sheet, dense, at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

BF16, F32 = 2, 4


class Work(NamedTuple):
    bytes: int
    operations: int

    def bound_s(self) -> float:
        return max(self.bytes / HBM_BYTES_PER_S, self.operations / F32_FLOPS)

    def __add__(self, other):
        return Work(self.bytes + other.bytes,
                    self.operations + other.operations)


class Launches(tuple):
    """The jobs of several launches of one kernel, one after another: the
    bound is the sum of each launch's."""

    def bound_s(self) -> float:
        return sum(job.bound_s() for job in self)


def live_mask(x: torch.Tensor, y: torch.Tensor, h: int, w: int):
    """Samples at source pixels (x, y) with a corner inside an h x w map:
    floor(x) in [-1, w - 1] and floor(y) in [-1, h - 1]."""
    x0, y0 = torch.floor(x), torch.floor(y)
    return (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)


def warp_work(c: int, src_hw, grid: tuple, live: int) -> Work:
    """One source warped over the hypotheses: grid = (D, H, W)."""
    d, hh, ww = grid
    n = d * hh * ww
    return Work(src_hw[0] * src_hw[1] * c * BF16 + n * c * BF16, live * c * 8)


def warp_backward_work(c: int, src_hw, grid: tuple, live: int) -> Work:
    """The warp's transpose: reads the bf16 gradient volume, writes the
    f32 source gradient."""
    d, hh, ww = grid
    n = d * hh * ww
    return Work(n * c * BF16 + src_hw[0] * src_hw[1] * c * F32, live * c * 8)


def gwc_work(c: int, src_hw, grid: tuple, live: int, per_pixel: bool,
             groups: int = 8) -> Work:
    """One pair's warp fused with the group-wise correlation: reads the
    source and reference features (and a stage's [H, W] start depth),
    writes [D, H, W, groups] bf16."""
    d, hh, ww = grid
    n = d * hh * ww
    start = hh * ww * F32 if per_pixel else 0
    return Work(src_hw[0] * src_hw[1] * c * BF16 + hh * ww * c * BF16 + start
                + n * groups * BF16, live * c * 10)


def fused_work(c: int, nv: int, src_hw, grid: tuple, live: int) -> Work:
    """All nv sources warped and variance-aggregated with the reference:
    reads nv + 1 feature maps, writes the [D, H, W, C] bf16 volume."""
    d, hh, ww = grid
    n = d * hh * ww
    return Work((nv * src_hw[0] * src_hw[1] + hh * ww) * c * BF16
                + n * c * BF16, live * c * 8 + n * c * (nv * 3 + 4))


def count_flops(fn) -> int:
    """Flops that `fn()` dispatches (convolutions, matrix products, their
    backward), counted by torch.utils.flop_counter."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())
