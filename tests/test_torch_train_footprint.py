"""The footprint plan and rule of the port's training sweep kernels
(csrc/footprint.cuh; `sweep_warp` in csrc/warp.cu, `sweep_warp_backward`
in csrc/sweep.cu), and the plain model of the backward's atomics.

`sweep_warp` copies each stage's source footprint into shared memory and
samples from there, as the other forward kernels do; a sample outside it
reads device memory, so the rule decides speed, not results.
`sweep_warp_backward` shares the warp's tile and run but stages nothing:
it adds each sample's corners into device memory with 16-byte atomics
when the sample changes cell. These tests hold, on the CPU, the launch
plans to the H100's shared memory, the rule under the warp's own tile,
run and budget to what the kernel needs (every corner that a staged
stage's samples read lies in its box), the training shapes of
chip_smoke.py to being staged, and the plain model of the backward's
atomics (chip_smoke.backward_atomics, against which chip_smoke.py holds
the kernel's own count on the card) to a walk of each thread's flushes.
The kernels are held to their plain versions on the card by
chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_footprint import (assert_conservative, cameras,
                                        hypotheses, mvsnet_sweep)
from wildmvs_torch.ops import sweep_kernels as sk

torch.set_num_threads(1)

#: an H100 SM's shared memory and what each resident block reserves of it
SM_BYTES, BLOCK_RESERVED = 228 * 1024, 1024
#: the training shapes of chip_smoke.py: (stage, D, per-pixel hypotheses)
VIS_STAGES = {"vis stage 1": (1, 32, False), "vis stage 2": (2, 16, True),
              "vis stage 3": (3, 8, True)}


def sweep(rng, vis, per_pixel, ref_hw, src_hw, D, **kw):
    """(P, Q, s, scale, clamp) of a random rig in either convention."""
    cams = cameras(rng, ref_hw, src_hw, **kw)
    depths = hypotheses(rng, D, ref_hw, per_pixel,
                        *(() if "back" not in kw else (300.0, 1200.0)))
    if vis:
        P, Q, scale, clamp = sk.vis_planes(*cams, ref_hw, src_hw)
        return P, Q, sk.inverse_depths(depths), scale, clamp
    return (*mvsnet_sweep(cams, ref_hw), depths, sk.UNIT_SCALE, None)


def training_rig(name):
    """(P, Q, s, scale, clamp, src_hw) of one training shape of
    chip_smoke.py on the CPU: the MVSNet headline or a Vis stage."""
    cpu = torch.device("cpu")
    if name == "headline":
        _, srcs, P, Q, s, *_ = chip_smoke.kernel_inputs(chip_smoke.HEADLINE,
                                                        cpu)
        return (P[:, 0].contiguous(), Q[:, 0].contiguous(), s, sk.UNIT_SCALE,
                None, tuple(srcs.shape[2:4]))
    hl = chip_smoke.HEADLINE
    src, _, P, Q, s, scale, clamp = chip_smoke.vis_kernel_inputs(
        cpu, dict(n=3, h=hl["h"], w=hl["w"], f=hl["f"]), *VIS_STAGES[name])
    return P, Q, s, scale, clamp, tuple(src.shape[1:3])


@pytest.mark.parametrize("c", [8, 16, 32, 64, 128, 256])
def test_training_plans_fit_the_card(c):
    """The warp's block keeps the 4 blocks of its __launch_bounds__ on an
    SM with sweep_gwc's 32 KB stage buffer, which holds whole tile
    footprints; the backward's (the same tile, no stage buffer) keeps the
    3 of its own. Both are within 256 threads in whole warps."""
    tile_h, cells_max = sk.footprint_plan(c)
    threads = tile_h * sk.FOOTPRINT_TILE_W * (c // 8)
    assert threads <= 256 and threads % 32 == 0
    smem = sk.footprint_smem_bytes(1, cells_max, c, tile_h)
    assert 4 * (smem + BLOCK_RESERVED) <= SM_BYTES
    assert cells_max * c * 2 == sk.GWC_VIEW_BYTES
    assert cells_max >= (tile_h + 3) * (sk.FOOTPRINT_TILE_W + 3)
    assert sk._tile_rows(c) == tile_h
    smem = sk.footprint_smem_bytes(1, 0, c, tile_h)
    assert 3 * (smem + BLOCK_RESERVED) <= SM_BYTES


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("vis", [False, True])
def test_warp_boxes_are_conservative(seed, per_pixel, vis):
    """Random rigs of both conventions, per-plane and per-pixel
    hypotheses, D = 40 (runs of FOOTPRINT_D_RUN, the last one ragged),
    the warp's tile and a budget of the median box: every live sample of
    a staged stage reads its four corners inside the stage's box, and the
    budget leaves some stages global."""
    rng = np.random.default_rng(30 + seed)
    ref_hw, src_hw = (20, 27), (22, 26)
    P, Q, s, scale, clamp = sweep(rng, vis, per_pixel, ref_hw, src_hw, 40)
    tile = (sk.footprint_plan(32)[0], sk.FOOTPRINT_TILE_W)
    free, box = sk.sweep_footprints(P, Q, s, tile, src_hw, scale, clamp,
                                    sk.FOOTPRINT_D_RUN)
    cells = ((box[..., 2] - box[..., 0] + 1).clamp(min=0)
             * (box[..., 3] - box[..., 1] + 1).clamp(min=0))
    limit = int(cells.float().median())
    share = assert_conservative(P, Q, s, tile, src_hw, scale, clamp,
                                sk.FOOTPRINT_D_RUN, cells_max=limit)
    assert bool(free.all()) and 0.0 < share < 1.0


@pytest.mark.parametrize("vis", [False, True])
def test_warp_behind_camera_stages_are_global(vis):
    """A source camera 600 mm ahead along the reference axis, D = 40 over
    300-1200 mm: under the warp's plan every stage whose samples reach
    behind it is global, every other stage is staged, and the staged ones
    are conservative."""
    rng = np.random.default_rng(4)
    ref_hw = src_hw = (16, 24)
    P, Q, s, scale, clamp = sweep(rng, vis, False, ref_hw, src_hw, 40,
                                  spread=0.0, baseline=20.0, back=600.0)
    tile_h, cells_max = sk.footprint_plan(32)
    run = sk.FOOTPRINT_D_RUN
    staged, _ = sk.sweep_footprints(P, Q, s, (tile_h, sk.FOOTPRINT_TILE_W),
                                    src_hw, scale, clamp, run, cells_max)
    rz = sk._project(P, Q, s)[2][0]                       # [D, H, W]
    n_st = -(-rz.shape[0] // run)
    rz = rz[torch.arange(n_st * run).clamp(max=rz.shape[0] - 1)]
    behind = (rz <= 0).reshape(n_st, run, 16 // tile_h, tile_h, 3,
                               sk.FOOTPRINT_TILE_W).any(5).any(3).any(1)
    assert bool(behind.any()) and not bool(behind.all())
    assert torch.equal(staged[0], ~behind)
    assert_conservative(P, Q, s, (tile_h, sk.FOOTPRINT_TILE_W), src_hw,
                        scale, clamp, run, cells_max)


@pytest.mark.parametrize("rig", ["headline", *VIS_STAGES])
def test_training_rigs_stage_nearly_every_tile(rig):
    """chip_smoke.py's MVSNet headline and Vis training stages at the
    warp's tile, run and budget: >= 95 % of the stages staged, and the
    staged ones conservative (the headline on its first 48 hypotheses)."""
    P, Q, s, scale, clamp, src_hw = training_rig(rig)
    tile_h, cells_max = sk.footprint_plan(32)
    tile = (tile_h, sk.FOOTPRINT_TILE_W)
    staged, _ = sk.sweep_footprints(P, Q, s, tile, src_hw, scale, clamp,
                                    sk.FOOTPRINT_D_RUN, cells_max)
    assert staged.float().mean().item() >= 0.95
    if rig == "headline":
        s = s[:, :48]
    assert_conservative(P, Q, s, tile, src_hw, scale, clamp,
                        sk.FOOTPRINT_D_RUN, cells_max)


def walk_atomics(P, Q, s, src_hw, C, scale, clamp, d_run, keep):
    """The 16-byte atomics into device memory of one sweep_warp_backward
    launch, counted by walking each thread's runs of d_run hypotheses (B =
    1). A thread sums its sample's four corners while the sample stays in
    one cell; when it moves, the corners that the new cell does not share
    (all four unless `keep` and the move is of one cell) leave, and at the
    run's end the last cell's four. Each corner that leaves and lies
    inside the image costs two atomics an 8-channel slice."""
    h, w = src_hw
    x, y = sk.source_coords(*sk._project(P, Q, s), scale, clamp)
    x0 = torch.floor(x[0]).long().numpy()
    y0 = torch.floor(y[0]).long().numpy()
    D, H, W = x0.shape

    def corners(cx, cy):
        return {(cx + k % 2, cy + k // 2) for k in range(4)}

    def inside(cells):
        return sum(0 <= a < w and 0 <= b < h for a, b in cells)

    n = 0
    for r in range(-(-D // d_run)):
        for yy in range(H):
            for xx in range(W):
                cur = None
                for d in range(r * d_run, min(D, (r + 1) * d_run)):
                    cx, cy = x0[d, yy, xx], y0[d, yy, xx]
                    if not (-1 <= cx <= w - 1 and -1 <= cy <= h - 1):
                        continue                            # dead
                    if cur is not None and (cx, cy) != cur:
                        left = corners(*cur)
                        if keep and abs(cx - cur[0]) + abs(cy - cur[1]) == 1:
                            left -= corners(cx, cy)
                        n += 2 * (C // 8) * inside(left)
                    cur = (cx, cy)
                if cur is not None:
                    n += 2 * (C // 8) * inside(corners(*cur))
    return n


@pytest.mark.parametrize("vis", [False, True])
def test_backward_atomics_count_the_kernels_flushes(vis):
    """chip_smoke.backward_atomics on a small rig of each convention
    equals the walk of each thread's flushes, for this design (kept
    corners, runs of FOOTPRINT_D_RUN) and for the first design (all four
    corners, runs of FIRST_BACKWARD_RUN); keeping the corners leaves
    fewer atomics."""
    rng = np.random.default_rng(40)
    ref_hw, src_hw, C = (12, 18), (14, 17), 16
    P, Q, s, scale, clamp = sweep(rng, vis, True, ref_hw, src_hw, 37,
                                  spread=0.3, baseline=150.0)
    new, first = chip_smoke.backward_atomics(P, Q, s, src_hw, C, scale,
                                             clamp)
    assert new == walk_atomics(P, Q, s, src_hw, C, scale, clamp,
                               sk.FOOTPRINT_D_RUN, True)
    assert first == walk_atomics(P, Q, s, src_hw, C, scale, clamp,
                                 chip_smoke.FIRST_BACKWARD_RUN, False)
    assert 0 < new < first


def test_backward_atomics_fall_on_the_headline():
    """At the headline (128x160, C = 32, D = 192) the kept corners cut the
    plain model's count of the backward's 16-byte atomics into device
    memory from the first design's 28.0 M to 18.4 M."""
    P, Q, s, scale, clamp, src_hw = training_rig("headline")
    new, first = chip_smoke.backward_atomics(P, Q, s, src_hw, 32)
    assert (new, first) == (18383464, 28040752)
