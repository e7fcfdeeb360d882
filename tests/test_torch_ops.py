"""The port's geometry, exact gather sweep and volume ops vs the JAX package.

Same inputs (numpy, from a seed) go through the JAX function and its
counterpart in wildmvs_torch, on the CPU. Each comparison states its
tolerance and why.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wildmvs.geometry import projective as jproj
from wildmvs.ops import plane_sweep as jps
from wildmvs.ops import volumes as jvol
from wildmvs.ops.mosaic_sweep import rot_planes, sweep_spans
from wildmvs_torch.geometry import projective as tproj
from wildmvs_torch.ops import plane_sweep as tps
from wildmvs_torch.ops import volumes as tvol
from wildmvs_torch.ops.sweep_kernels import mvsnet_planes, sweep_warp_plain

torch.set_num_threads(1)


def rig(H, W, yaw=0.02, roll=0.0, baseline=(2.0, 0.5, 0.0), f=60.0):
    """(src_proj, ref_proj) [4, 4] f32: a source camera rotated by yaw
    (about y) and roll (about z) and shifted by `baseline`."""
    Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                   [-np.sin(yaw), 0, np.cos(yaw)]])
    Rz = np.array([[np.cos(roll), -np.sin(roll), 0],
                   [np.sin(roll), np.cos(roll), 0], [0, 0, 1]])
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    ref_proj = np.eye(4)
    ref_proj[:3, :3] = K
    src_proj = np.eye(4)
    src_proj[:3, :3] = K @ Rz @ Ry
    src_proj[:3, 3] = K @ np.asarray(baseline)
    return src_proj.astype(np.float32), ref_proj.astype(np.float32)


def sweep_inputs(B=2, H=16, W=24, C=8, D=6, per_pixel=False, seed=0,
                 **rig_kw):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((B, H, W, C)).astype(np.float32)
    sp, rp = rig(H, W, **rig_kw)
    src_proj = np.stack([sp] * B)
    ref_proj = np.stack([rp] * B)
    depths = np.stack([np.linspace(425.0, 935.0, D)] * B).astype(np.float32)
    if per_pixel:
        depths = (depths[:, :, None, None] + 20.0 * rng.standard_normal(
            (B, D, H, W))).astype(np.float32)
    return src, src_proj, ref_proj, depths


def jax_gather(src, src_proj, ref_proj, depths, hw):
    return np.asarray(jax.jit(jps.plane_sweep_warp, static_argnums=4)(
        src, src_proj, ref_proj, depths, hw))


def port_gather(src, src_proj, ref_proj, depths, hw):
    t = torch.from_numpy
    return tps.plane_sweep_warp(t(src), t(src_proj), t(ref_proj), t(depths),
                                hw).numpy()


def port_plain_warp(src, src_proj, ref_proj, depths, hw):
    t = torch.from_numpy
    P, Q = mvsnet_planes(t(src_proj), t(ref_proj), hw)
    return sweep_warp_plain(t(src).to(torch.bfloat16), P, Q,
                            t(depths)).float().numpy()


def test_build_proj_matrices_and_scale_K():
    rng = np.random.default_rng(0)
    K = rng.standard_normal((2, 3, 3, 3)).astype(np.float32)
    R = rng.standard_normal((2, 3, 3, 3)).astype(np.float32)
    t = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    for f in (0.25, np.float32(2.0)):
        # exact: a per-row scale by a float32 factor
        np.testing.assert_array_equal(
            tproj.scale_K(torch.from_numpy(K), f).numpy(),
            np.asarray(jproj.scale_K(K, f)))
    # 3x3 f32 products summed in another order: a few ulps
    np.testing.assert_allclose(
        tproj.build_proj_matrices(*map(torch.from_numpy, (K, R, t))).numpy(),
        np.asarray(jproj.build_proj_matrices(K, R, t)), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_array_equal(tproj.pixel_grid(3, 4).numpy(),
                                  np.asarray(jproj.pixel_grid(3, 4)))


@pytest.mark.parametrize("per_pixel", [False, True], ids=["D", "DHW"])
def test_plane_sweep_warp_matches_jax(per_pixel):
    src, sp, rp, depths = sweep_inputs(per_pixel=per_pixel)
    ref = jax_gather(src, sp, rp, depths, (16, 24))
    out = port_gather(src, sp, rp, depths, (16, 24))
    assert out.shape == ref.shape == (2, 6, 16, 24, 8)
    assert (np.abs(ref) > 0).mean() > 0.5, "the rig must warp something"
    # f32 both ways; the 4x4 inverse and the projection round differently
    # in the last bits, which moves a coordinate by ~1e-5 px: ~1e-4 in a
    # unit-variance feature
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)


def test_depth_chunked_gather_equals_one_slab(monkeypatch):
    src, sp, rp, depths = sweep_inputs()
    one = port_gather(src, sp, rp, depths, (16, 24))
    limit = 16 * 24 * (4 * 8 * 4 + 64) * 4                    # 4 planes
    assert tps.gather_chunk_planes(6, (16, 24), 8, limit) == 4
    monkeypatch.setattr(tps, "GATHER_CHUNK_BYTES", limit)
    chunked = port_gather(src, sp, rp, depths, (16, 24))
    # the same arithmetic per plane: exact
    np.testing.assert_array_equal(chunked, one)


def test_wide_row_span_rig_is_exact():
    # a rolled rig whose per-chunk source-row span exceeds 7: the TPU
    # kernel's widest window (KY=8) cannot hold it and falls back to the
    # gather; the port's gather and the Hopper kernel's plain version are
    # exact there
    src, sp, rp, depths = sweep_inputs(B=1, H=16, W=40, roll=0.6)
    rxyz, trans = rot_planes(jnp.asarray(sp[0]), jnp.asarray(rp[0]),
                             (16, 40))
    _, span = sweep_spans(rxyz, trans, jnp.asarray(depths[0]), (16, 40))
    assert int(span) > 7, int(span)
    ref = jax_gather(src, sp, rp, depths, (16, 40))
    assert (np.abs(ref) > 0).mean() > 0.3
    np.testing.assert_allclose(port_gather(src, sp, rp, depths, (16, 40)),
                               ref, atol=2e-4, rtol=0)
    # plain kernel version: bf16 features and one bf16 rounding of the f32
    # combine; |features| < 5, so bf16 (8 bits) errors stay below 0.05
    np.testing.assert_allclose(port_plain_warp(src, sp, rp, depths,
                                               (16, 40)), ref, atol=0.05,
                               rtol=0)


def test_behind_camera_rig():
    # the source camera turned by 100 degrees: part of every hypothesis
    # plane lies behind it (z <= 0), which the gather parks at pixel -10
    # and the kernel marks invalid; both read exact zeros there
    src, sp, rp, depths = sweep_inputs(B=1, yaw=np.deg2rad(100.0),
                                       baseline=(300.0, 0.0, 0.0))
    P, Q = mvsnet_planes(torch.from_numpy(sp), torch.from_numpy(rp),
                         (16, 24))
    rz = P[:, 2, None] * torch.from_numpy(depths)[:, :, None, None] \
        + Q[:, 2, None]
    z_behind = (rz <= 0).numpy()
    assert 0 < z_behind.mean() < 1, z_behind.mean()
    ref = jax_gather(src, sp, rp, depths, (16, 24))
    out = port_gather(src, sp, rp, depths, (16, 24))
    plain = port_plain_warp(src, sp, rp, depths, (16, 24))
    assert (ref[z_behind] == 0).all()
    assert (out[z_behind] == 0).all() and (plain[z_behind] == 0).all()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
    # zeros agree exactly: validity is the same test on both sides
    np.testing.assert_array_equal(plain == 0, ref == 0)


def test_variance_and_softmin_match_jax():
    rng = np.random.default_rng(3)
    ref = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    warped = [rng.standard_normal((2, 4, 5, 6, 8)).astype(np.float32)
              for _ in range(3)]
    tw = [torch.from_numpy(w) for w in warped]
    var_j = jvol.variance_cost_volume(ref, warped, num_depth=4)
    var_t = tvol.variance_cost_volume(torch.from_numpy(ref), tw,
                                      num_depth=4)
    # f32 sums of 4 unit-variance terms in another order: ~1e-6
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), atol=1e-5)
    temp = np.array([0.3], np.float32)
    sm_j = jvol.softmin_cost_volume(ref, warped, temperature=temp)
    sm_t = tvol.softmin_cost_volume(torch.from_numpy(ref), tw,
                                    temperature=torch.from_numpy(temp))
    np.testing.assert_allclose(sm_t.numpy(), np.asarray(sm_j), atol=1e-5,
                               rtol=1e-5)
    # no source views: the variance of the reference alone is zero
    assert not tvol.variance_cost_volume(torch.from_numpy(ref), [],
                                         num_depth=4).any()


def test_depth_regression_and_confidence_match_jax():
    rng = np.random.default_rng(4)
    logits = 4.0 * rng.standard_normal((2, 12, 5, 7)).astype(np.float32)
    prob = np.array(jax.nn.softmax(logits, axis=1))
    depths = np.stack([np.linspace(2.0, 6.0, 12)] * 2).astype(np.float32)
    tp = torch.from_numpy(prob)
    for dv in (depths, np.broadcast_to(depths[:, :, None, None],
                                       (2, 12, 5, 7)).copy()):
        np.testing.assert_allclose(
            tvol.depth_regression(tp, torch.from_numpy(dv)).numpy(),
            np.asarray(jvol.depth_regression(prob, dv)), rtol=1e-6)
    conf_j = np.asarray(jvol.photometric_confidence(prob))
    conf_t = tvol.photometric_confidence(tp).numpy()
    # the same truncated index on both sides; the 4-tap sums differ only
    # by the JAX cumsum-difference rounding (~1e-7)
    np.testing.assert_allclose(conf_t, conf_j, atol=1e-6)
    assert conf_t.min() >= 0 and conf_t.max() <= 1 + 1e-6


# ---------------------------------------------------------------------------
# the Vis-MVSNet half: homographies, homography warps, group-wise
# correlation, soft-argmin with its window, entropy
# ---------------------------------------------------------------------------

def vis_cams(h, w, yaw=0.03, baseline=(1.5, 0.3, 0.2), f=50.0):
    """(K_ref, R_ref, t_ref, K_src, R_src, t_src) [1, ...] f32 numpy."""
    Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                   [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    return (K[None], np.eye(3, dtype=np.float32)[None],
            np.zeros((1, 3, 1), np.float32), K[None], Ry[None],
            np.asarray(baseline, np.float32).reshape(1, 3, 1))


@pytest.mark.parametrize("per_pixel", [False, True], ids=["D", "DHW"])
@pytest.mark.parametrize("inverse_depth", [False, True])
def test_homographies_and_homography_warp_match_jax(per_pixel,
                                                     inverse_depth):
    h, w, c, D = 12, 16, 4, 5
    rng = np.random.default_rng(23)
    cams = vis_cams(h, w)
    start = (np.full((1, 1, 1, 1), 30.0) if not per_pixel else
             30.0 + rng.uniform(-3, 3, (1, 1, h, w))).astype(np.float32)
    interval = np.full((1, 1, 1, 1), 2.5, np.float32)
    want = np.asarray(jps.get_homographies(
        *map(jnp.asarray, cams), D, jnp.asarray(start),
        jnp.asarray(interval), inverse_depth=inverse_depth))
    got = tps.get_homographies(*map(torch.from_numpy, cams), D,
                               torch.from_numpy(start),
                               torch.from_numpy(interval),
                               inverse_depth=inverse_depth).numpy()
    assert got.shape == want.shape
    # f32 3x3 products in another order: ~1e-6 relative
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # warp by the homography of one hypothesis ([B,3,3] or per pixel)
    src = rng.standard_normal((1, h, w, c)).astype(np.float32)
    H = want[:, 2, 0, 0] if not per_pixel else want[:, 2]
    jw = np.asarray(jps.homography_warp(jnp.asarray(src), jnp.asarray(H)))
    tw = tps.homography_warp(torch.from_numpy(src),
                             torch.from_numpy(H.copy())).numpy()
    assert (np.abs(jw) > 0).mean() > 0.5
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-4)


@pytest.mark.parametrize("per_pixel", [False, True], ids=["D", "DHW"])
def test_homography_sweep_warp_matches_jax(per_pixel, monkeypatch):
    """The f32 Vis gather sweep, whole and in depth slabs, against JAX."""
    h, w, c, D = 10, 14, 8, 6
    rng = np.random.default_rng(24)
    cams = vis_cams(h, w, baseline=(2.0, 0.4, 0.0))
    start = (np.full((1, 1, 1, 1), 25.0) if not per_pixel else
             25.0 + rng.uniform(-2, 2, (1, 1, h, w))).astype(np.float32)
    interval = np.full((1, 1, 1, 1), 1.5, np.float32)
    src = rng.standard_normal((1, h, w, c)).astype(np.float32)
    want = np.asarray(jps.homography_sweep_warp(
        jnp.asarray(src), *map(jnp.asarray, cams), D, jnp.asarray(start),
        jnp.asarray(interval), (h, w)))
    args = (torch.from_numpy(src), *map(torch.from_numpy, cams), D,
            torch.from_numpy(start), torch.from_numpy(interval), (h, w))
    got = tps.homography_sweep_warp(*args).numpy()
    assert (np.abs(want) > 0).mean() > 0.5
    # f32 throughout: ~1e-6 relative coordinate rounding
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    monkeypatch.setattr(tps, "GATHER_CHUNK_BYTES", 1)   # one plane a slab
    np.testing.assert_array_equal(tps.homography_sweep_warp(*args).numpy(),
                                  got)
    # the grid carries no gradient, the features do
    x = args[0].clone().requires_grad_()
    tps.homography_sweep_warp(x, *args[1:]).sum().backward()
    assert x.grad.abs().sum() > 0


@pytest.mark.parametrize("window", [None, 2])
def test_groupwise_correlation_soft_argmin_entropy_match_jax(window):
    rng = np.random.default_rng(25)
    a = rng.standard_normal((1, 4, 3, 5, 32)).astype(np.float32)
    b = rng.standard_normal((1, 4, 3, 5, 32)).astype(np.float32)
    np.testing.assert_allclose(
        tvol.groupwise_correlation(torch.from_numpy(a), torch.from_numpy(b),
                                   8).numpy(),
        np.asarray(jvol.groupwise_correlation(a, b, 8)), rtol=1e-6,
        atol=1e-5)
    score = (4.0 * rng.standard_normal((2, 9, 6, 7))).astype(np.float32)
    want = jvol.soft_argmin(jnp.asarray(score), window=window)
    got = tvol.soft_argmin(torch.from_numpy(score), window=window)
    assert len(got) == len(want) == (2 if window is None else 3)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-6)
    prob = got[0]
    np.testing.assert_allclose(
        tvol.entropy(prob, axis=1).numpy(),
        np.asarray(jvol.entropy(jnp.asarray(prob.numpy()), axis=1)),
        rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="groups"):
        tvol.groupwise_correlation(torch.from_numpy(a), torch.from_numpy(b),
                                   5)
