"""The footprint rule of the port's forward sweep kernels
(`sweep_kernels.sweep_footprints`, csrc/footprint.cuh).

`fused_cost_volume` and `sweep_gwc` copy each stage's source footprint into
shared memory and sample from there; a sample whose corners fall outside
it reads device memory instead, so the rule decides speed, not results.
These tests hold the rule to what the kernels need of it on the CPU: on
rigs built through `mvsnet_planes` and `vis_planes` it is conservative
(every live sample of a staged stage has its four corners in the box),
rigs with a corner behind the source camera or footprints over the budget
are not staged, and on the DTU-like rigs of chip_smoke.py nearly every
stage is staged. The kernels themselves are held to their plain versions
on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from wildmvs_torch.ops import sweep_kernels as sk

torch.set_num_threads(1)


def rot(rng, spread):
    """A random rotation of about `spread` radians."""
    a = rng.uniform(-spread, spread, 3)
    cx, sx, cy, sy, cz, sz = (np.cos(a[0]), np.sin(a[0]), np.cos(a[1]),
                              np.sin(a[1]), np.cos(a[2]), np.sin(a[2]))
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rx @ Ry @ Rz


def cameras(rng, ref_hw, src_hw, spread=0.15, baseline=60.0, back=0.0):
    """(K_ref, R_ref, t_ref, K_src, R_src, t_src) [1, ...] f32 torch: a
    reference camera at the origin and a source camera turned by up to
    `spread` radians, moved by up to `baseline` sideways and `back` along
    the reference axis (a positive `back` puts it in front of the
    reference, so that near hypotheses lie behind it)."""
    (H, W), (h, w) = ref_hw, src_hw
    f = rng.uniform(0.8, 1.5)
    K_ref = np.array([[f * W, 0, W / 2], [0, f * W, H / 2], [0, 0, 1]])
    K_src = np.array([[f * w, 0, w / 2], [0, f * w, h / 2], [0, 0, 1]])
    R = rot(rng, spread)
    c = np.array([*rng.uniform(-baseline, baseline, 2), back])
    t = -R @ c[:, None]
    out = (K_ref, np.eye(3), np.zeros((3, 1)), K_src, R, t)
    return tuple(torch.tensor(a, dtype=torch.float32)[None] for a in out)


def mvsnet_sweep(cams, ref_hw):
    K_ref, R_ref, t_ref, K_src, R_src, t_src = cams

    def proj(K, R, t):
        m = torch.eye(4)[None].repeat(1, 1, 1)
        m[:, :3, :3] = K @ R
        m[:, :3, 3:] = K @ t
        return m
    return sk.mvsnet_planes(proj(K_src, R_src, t_src),
                            proj(K_ref, R_ref, t_ref), ref_hw)


def hypotheses(rng, D, ref_hw, per_pixel, near=400.0, far=900.0):
    """[1, D] depths, or a per-pixel slab [1, D, H, W] around a smooth
    surface with random jitter."""
    d = torch.linspace(near, far, D)[None]
    if not per_pixel:
        return d
    H, W = ref_hw
    yy, xx = np.meshgrid(np.linspace(0, 3, H), np.linspace(0, 2, W),
                         indexing="ij")
    base = 600.0 + 80.0 * np.sin(yy) * np.cos(xx) \
        + 15.0 * rng.standard_normal((H, W))
    slab = base[None] + np.linspace(-40.0, 40.0, D)[:, None, None]
    return torch.tensor(slab, dtype=torch.float32)[None]


def assert_conservative(P, Q, s, tile, src_hw, scale=sk.UNIT_SCALE,
                        clamp=None, d_run=1):
    """Every live sample of a staged stage has its four corners in the
    stage's box. Returns the share of staged stages."""
    staged, box = sk.sweep_footprints(P, Q, s, tile, src_hw, scale, clamp,
                                      d_run)
    h, w = src_hw
    x, y = sk.source_coords(*sk._project(P, Q, s), scale, clamp)
    x0, y0 = torch.floor(x), torch.floor(y)
    live = (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
    D, H, W = x.shape[1:]
    d_idx = (torch.arange(D) // d_run)[:, None, None].expand(D, H, W)
    y_idx = (torch.arange(H) // tile[0])[None, :, None].expand(D, H, W)
    x_idx = (torch.arange(W) // tile[1])[None, None, :].expand(D, H, W)
    st = staged[0, d_idx, y_idx, x_idx]
    bx = box[0, d_idx, y_idx, x_idx]
    inside = ((x0[0] >= bx[..., 0]) & (x0[0] + 1 <= bx[..., 2])
              & (y0[0] >= bx[..., 1]) & (y0[0] + 1 <= bx[..., 3]))
    check = live[0] & st
    assert int(check.sum()) > 0, "no live sample in a staged stage"
    assert bool(inside[check].all()), (
        f"{int((check & ~inside).sum())} live samples of staged stages "
        f"leave their footprint")
    # boxes lie in the zero ring
    assert bool(((box[..., 0] >= -1) & (box[..., 2] <= w)
                 & (box[..., 1] >= -1) & (box[..., 3] <= h)).all())
    return staged.float().mean().item()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("per_pixel", [False, True])
def test_mvsnet_footprints_are_conservative(seed, per_pixel):
    rng = np.random.default_rng(seed)
    ref_hw, src_hw = (20, 27), (18 + seed, 30 - seed)
    P, Q = mvsnet_sweep(cameras(rng, ref_hw, src_hw), ref_hw)
    s = hypotheses(rng, 7, ref_hw, per_pixel)
    share = assert_conservative(P, Q, s, (8, 8), src_hw,
                                d_run=1 + seed % 3)
    assert share > 0.5


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("per_pixel", [False, True])
def test_vis_footprints_are_conservative(seed, per_pixel):
    rng = np.random.default_rng(10 + seed)
    ref_hw, src_hw = (24, 19), (22, 26)
    cams = cameras(rng, ref_hw, src_hw)
    P, Q, scale, clamp = sk.vis_planes(*cams, ref_hw, src_hw)
    s = sk.inverse_depths(hypotheses(rng, 9, ref_hw, per_pixel))
    share = assert_conservative(P, Q, s, (4, 8), src_hw, scale, clamp,
                                d_run=2)
    assert share > 0.5


def test_small_source_with_the_clamp():
    """An 8x10 source (the clamp lies inside (-1, 0)), a wide pair: samples
    leave the source and are clamped back, inside their boxes."""
    rng = np.random.default_rng(3)
    ref_hw, src_hw = (8, 10), (8, 10)
    cams = cameras(rng, ref_hw, src_hw, spread=0.3, baseline=150.0)
    P, Q, scale, clamp = sk.vis_planes(*cams, ref_hw, src_hw)
    s = sk.inverse_depths(hypotheses(rng, 32, ref_hw, False, 200.0, 900.0))
    x, _ = sk.source_coords(*sk._project(P, Q, s), scale)
    assert bool(((x < clamp[0]) | (x > clamp[1])).any())
    assert_conservative(P, Q, s, (8, 8), src_hw, scale, clamp, d_run=4)


@pytest.mark.parametrize("vis", [False, True])
def test_behind_camera_stages_are_global(vis):
    """A source camera 600 mm ahead along the reference axis: the stages
    whose hypotheses reach behind it are not staged, the far ones are."""
    rng = np.random.default_rng(4)
    ref_hw = src_hw = (16, 24)
    cams = cameras(rng, ref_hw, src_hw, spread=0.0, baseline=20.0,
                   back=600.0)
    depths = hypotheses(rng, 12, ref_hw, False, 300.0, 1200.0)
    if vis:
        P, Q, scale, clamp = sk.vis_planes(*cams, ref_hw, src_hw)
        s = sk.inverse_depths(depths)
    else:
        (P, Q), scale, clamp = mvsnet_sweep(cams, ref_hw), sk.UNIT_SCALE, None
        s = depths
    staged, _ = sk.sweep_footprints(P, Q, s, (8, 8), src_hw, scale, clamp)
    rz = sk._project(P, Q, s)[2]
    behind = (rz <= 0).flatten(2).any(-1)[0]                  # [D]
    assert bool(behind.any()) and not bool(behind.all())
    assert not bool(staged[0, behind].any())
    assert bool(staged[0, ~behind].all())
    if vis:
        assert_conservative(P, Q, s, (8, 8), src_hw, scale, clamp)


def test_oversize_footprints_are_global():
    rng = np.random.default_rng(5)
    ref_hw, src_hw = (24, 32), (24, 32)
    P, Q = mvsnet_sweep(cameras(rng, ref_hw, src_hw), ref_hw)
    s = hypotheses(rng, 6, ref_hw, True)
    staged, box = sk.sweep_footprints(P, Q, s, (8, 8), src_hw, d_run=2)
    cells = (box[..., 2] - box[..., 0] + 1) * (box[..., 3] - box[..., 1] + 1)
    limit = int(cells.float().median())
    small, _ = sk.sweep_footprints(P, Q, s, (8, 8), src_hw, d_run=2,
                                   cells_max=limit)
    assert bool(staged.all())
    assert torch.equal(small, staged & (cells <= limit))
    assert 0 < int(small.sum()) < small.numel()


def test_arbitrary_planes_flag_non_finite_corners():
    """Planes that no rig builds (NaN at a corner pixel) flag the stage
    global instead of producing a box from NaN."""
    rng = np.random.default_rng(6)
    ref_hw = src_hw = (16, 16)
    P, Q = mvsnet_sweep(cameras(rng, ref_hw, src_hw), ref_hw)
    P = P.clone()
    P[0, 0, 0, 0] = float("nan")
    staged, _ = sk.sweep_footprints(P, Q, hypotheses(rng, 4, ref_hw, False),
                                    (8, 8), src_hw)
    assert not bool(staged[0, :, 0, 0].any())
    assert bool(staged[0, :, 1:, 1:].all())


@pytest.mark.parametrize("cfg", ["headline", "eval"])
def test_dtu_rigs_stage_nearly_every_tile(cfg):
    """chip_smoke.py's DTU-like rigs at the fused kernel's own tile, run
    and budget: >= 95 % of the headline's stages staged, and conservative."""
    scene = chip_smoke.HEADLINE if cfg == "headline" else chip_smoke.EVAL
    ref, srcs, P, Q, s, *_ = chip_smoke.kernel_inputs(
        scene, torch.device("cpu"), C=32)
    src_hw = tuple(srcs.shape[2:4])
    tile_h, cells_max = sk.fused_plan(32, P.shape[1])
    tile = (tile_h, sk.FOOTPRINT_TILE_W)
    staged, _ = sk.sweep_footprints(P, Q, s, tile, src_hw,
                                    d_run=sk.FOOTPRINT_D_RUN,
                                    cells_max=cells_max)
    share = staged.float().mean().item()
    # the eval's 12-degree pairs move further along their epipolar lines
    # over a run, and its four views share a buffer sized for occupancy:
    # the last view's larger footprints do not all fit
    assert share >= (0.95 if cfg == "headline" else 0.85), share
    if cfg == "headline":
        for v in range(P.shape[1]):
            assert_conservative(P[:, v], Q[:, v], s[:, :48], tile, src_hw,
                                d_run=sk.FOOTPRINT_D_RUN)


@pytest.mark.parametrize("c", [8, 16, 32, 64, 128, 256])
def test_footprint_plans_fit_the_card(c):
    """For every view count up to 256, the plan the wrappers launch with
    keeps a block within 256 threads in whole warps and its shared memory
    within the H100's limit; the fused block keeps 3 blocks on an SM while
    its planes leave room (NV <= 4 keeps 16 KB a view at C <= 64), and a
    sweep_gwc block keeps 4."""
    for nv in range(1, 257):
        tile_h, cells_max = sk.fused_plan(c, nv)
        threads = tile_h * sk.FOOTPRINT_TILE_W * (c // 8)
        assert threads <= 256 and threads % 32 == 0, (nv, tile_h)
        smem = sk.footprint_smem_bytes(nv, cells_max, c, tile_h)
        assert smem <= sk.SMEM_LIMIT, (nv, smem)
        assert cells_max * c * 2 <= nv * sk.FUSED_VIEW_BYTES
        if sk.footprint_smem_bytes(nv, 0, c, tile_h) <= sk.FUSED_BLOCK_BYTES:
            assert smem <= sk.FUSED_BLOCK_BYTES, (nv, smem)
        if nv <= 4 and c <= 64:
            assert cells_max * c * 2 == nv * sk.FUSED_VIEW_BYTES, (nv,
                                                                  cells_max)
        # a buffer is whole tile footprints or nothing
        assert cells_max == 0 or cells_max >= (tile_h + 3) * (
            sk.FOOTPRINT_TILE_W + 3)
    if c <= 64:
        tile_h, cells_max = sk.footprint_plan(c)
        smem = sk.footprint_smem_bytes(1, cells_max, c, tile_h)
        assert cells_max * c * 2 == sk.GWC_VIEW_BYTES
        assert 4 * (smem + 1024) <= 228 * 1024, smem


def test_more_views_share_the_same_bytes():
    """The fused block's stage buffer grows with NV up to the bytes that
    keep 3 blocks an SM, then shrinks as the views' planes take room, and
    is 0 (every sample from device memory) once it would hold less than a
    tile's footprint."""
    cells = [sk.fused_plan(32, nv)[1] for nv in range(1, 64)]
    assert cells[:4] == [256, 512, 768, 1024]
    assert all(a >= b for a, b in zip(cells[3:], cells[4:]))
    assert cells[31] > 121 and cells[-1] == 0


@pytest.mark.parametrize("seed", range(2))
def test_views_share_the_stage_buffer(seed):
    """Two views, one buffer that holds one and a half of their boxes: in
    each stage a view is staged when its box fits after the staged boxes of
    the views before it, as the kernels place them."""
    rng = np.random.default_rng(20 + seed)
    ref_hw = src_hw = (24, 32)
    planes = [mvsnet_sweep(cameras(rng, ref_hw, src_hw), ref_hw)
              for _ in range(2)]
    P = torch.stack([p for p, _ in planes], 1)
    Q = torch.stack([q for _, q in planes], 1)
    s = hypotheses(rng, 8, ref_hw, False)
    free, box = sk.sweep_footprints(P, Q, s, (8, 8), src_hw, d_run=2)
    cells = (box[..., 2] - box[..., 0] + 1) * (box[..., 3] - box[..., 1] + 1)
    limit = int(cells.float().median() * 1.5)
    staged, _ = sk.sweep_footprints(P, Q, s, (8, 8), src_hw, d_run=2,
                                    cells_max=limit)
    first = free[:, 0] & (cells[:, 0] <= limit)
    used = torch.where(first, cells[:, 0], 0)
    assert torch.equal(staged[:, 0], first)
    assert torch.equal(staged[:, 1], free[:, 1] & (used + cells[:, 1]
                                                     <= limit))
    assert bool(staged[:, 1].any()) and not bool(staged[:, 1].all())


def test_counting_tiles_is_scoped():
    assert sk._tile_counter is None
    with sk.counting_tiles(torch.device("cpu")) as counter:
        assert sk._tile_counter is counter
        assert counter.tolist() == [0, 0]
    assert sk._tile_counter is None
