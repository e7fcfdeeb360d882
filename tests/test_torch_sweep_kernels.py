"""The port's sweep kernels (ops/sweep_kernels.py) vs the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which repeats the
CUDA kernel's arithmetic (f32 coordinates, weights and combine over bf16
features, one bf16 rounding). It is held to the JAX Pallas kernels run by
the Pallas interpreter (bf16 weights and a bf16 combine) and to the JAX f32
exact gather, in both sweep conventions (MVSNet; Vis-MVSNet with its
coordinate scale and clamp). The CUDA kernels themselves are compared with the plain
versions on the card by the `gpu`-marked tests here and by chip_smoke.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wildmvs.ops.mosaic_sweep import (_plan_fit, fused_cost_volume_px,
                                      mosaic_sweep_warp,
                                      mosaic_sweep_warp_px,
                                      mosaic_sweep_warp_px_gwc, rot_planes,
                                      sweep_spans, sweep_spans_px)
from wildmvs.ops.mosaic_sweep import vis_planes as jax_vis_planes
from wildmvs.ops.plane_sweep import homography_sweep_warp, plane_sweep_warp
from wildmvs.ops.volumes import groupwise_correlation
from wildmvs_torch.ops import sweep_kernels as sk

torch.set_num_threads(1)

H, W, C, D = 8, 40, 16, 6


def rig(yaw=0.02, baseline=(2.0, 0.5, 0.0), f=60.0):
    """(src_proj, ref_proj) [4, 4] f32 of a slightly turned source camera
    (the geometry the JAX kernels' narrow windows hold)."""
    Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                   [-np.sin(yaw), 0, np.cos(yaw)]])
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    ref_proj = np.eye(4)
    ref_proj[:3, :3] = K
    src_proj = np.eye(4)
    src_proj[:3, :3] = K @ Ry
    src_proj[:3, 3] = K @ np.asarray(baseline)
    return src_proj.astype(np.float32), ref_proj.astype(np.float32)


def bf16_features(rng, shape):
    """Features exactly representable in bf16, as numpy f32."""
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def hypotheses(per_pixel):
    d = np.linspace(425.0, 935.0, D).astype(np.float32)[None]
    if not per_pixel:
        return d
    base = 600.0 + 30.0 * np.sin(np.linspace(0, 3, H))[:, None] \
        + 10.0 * np.cos(np.linspace(0, 2, W))[None, :]
    return (base[None, None] + np.linspace(-15, 15, D)[None, :, None, None]
            ).astype(np.float32)


def port_planes(src_proj, ref_proj):
    return sk.mvsnet_planes(torch.from_numpy(src_proj)[None],
                            torch.from_numpy(ref_proj)[None], (H, W))


def test_sweep_warp_plain_matches_pallas_and_gather():
    rng = np.random.default_rng(0)
    src = bf16_features(rng, (H, W, C))
    sp, rp = rig()
    depths = hypotheses(False)[0]
    rxyz, trans = rot_planes(jnp.asarray(sp), jnp.asarray(rp), (H, W))
    ybase, span = sweep_spans(rxyz, trans, jnp.asarray(depths), (H, W))
    assert int(span) <= 1
    pallas = mosaic_sweep_warp(jnp.asarray(src, jnp.bfloat16), rxyz, trans,
                               jnp.asarray(depths), ybase, KY=2,
                               interpret=True)               # [D, H, C, W]
    pallas = np.asarray(jnp.transpose(pallas, (0, 1, 3, 2)), np.float32)
    gather = np.asarray(plane_sweep_warp(
        src[None], sp[None], rp[None], depths[None], (H, W)))[0]

    P, Q = port_planes(sp, rp)
    out = sk.sweep_warp(torch.from_numpy(src)[None].to(torch.bfloat16), P, Q,
                        torch.from_numpy(depths)[None])
    assert out.dtype == torch.bfloat16 and out.shape == (1, D, H, W, C)
    out = out[0].float().numpy()
    assert (np.abs(gather) > 0).mean() > 0.5
    # against the f32 gather: one bf16 rounding of values below ~5 (2^-8
    # relative, <= 0.02) plus ~1e-5 px coordinate differences
    np.testing.assert_allclose(out, gather, atol=0.03, rtol=0)
    # against the Pallas kernel, which rounds its weights and its combine
    # to bf16 as well: a few bf16 ulps of values below ~5
    np.testing.assert_allclose(out, pallas, atol=0.08, rtol=0)
    assert np.abs(out - pallas).mean() < 4e-3
    # outside the source frustum both read exact zeros
    assert (out[gather == 0] == 0).all()


@pytest.mark.parametrize("agg", ["variance", "softmin"])
@pytest.mark.parametrize("per_pixel", [False, True], ids=["D", "DHW"])
def test_fused_cost_volume_plain_matches_pallas_and_gather(agg, per_pixel):
    rng = np.random.default_rng(11)
    feats = [bf16_features(rng, (1, H, W, C)) for _ in range(3)]
    sp, rp = rig()
    sp2 = sp.copy()
    sp2[:3, 3] *= 0.5
    proj = np.stack([rp, sp, sp2])[None]                     # ref first
    hyp = hypotheses(per_pixel)
    temp = np.array([0.05], np.float32)
    dh = hyp.shape[1]

    sentinel = jnp.full((dh, H, W, C), -7.0, jnp.bfloat16)
    pallas = fused_cost_volume_px(
        [jnp.asarray(f, jnp.bfloat16) for f in feats], jnp.asarray(proj),
        jnp.asarray(hyp), (H, W), agg=agg, temp=jnp.asarray(temp), KR=10,
        fallback=lambda bb: sentinel, interpret=True)
    pallas = np.asarray(pallas, np.float32)
    assert (pallas != -7.0).any(), "the Pallas kernel fell back"

    warped = [np.asarray(plane_sweep_warp(feats[i], proj[:, i], proj[:, 0],
                                          hyp, (H, W))) for i in (1, 2)]
    ref32 = feats[0][:, None]
    if agg == "variance":
        stack = np.concatenate([np.broadcast_to(ref32, warped[0].shape)[None]]
                               + [w[None] for w in warped])
        gather = stack.var(axis=0)
    else:
        diffs = [(ref32 - w) ** 2 for w in warped]
        es = [np.exp(-temp[0] * d.sum(-1, keepdims=True)) for d in diffs]
        gather = sum(e * d for e, d in zip(es, diffs)) / (sum(es) + 1e-6)

    planes = [port_planes(p, rp) for p in (sp, sp2)]
    out = sk.fused_cost_volume(
        torch.from_numpy(feats[0]).to(torch.bfloat16),
        torch.from_numpy(np.stack(feats[1:], 1)).to(torch.bfloat16),
        torch.stack([p for p, _ in planes], 1),
        torch.stack([q for _, q in planes], 1), torch.from_numpy(hyp),
        torch.from_numpy(temp), agg)
    assert out.dtype == torch.bfloat16 and out.shape == (1, dh, H, W, C)
    out = out.float().numpy()
    scale = np.abs(gather).max()
    assert scale > 0.5
    # against the exact f32 aggregation (numpy over the f32 gather): one
    # bf16 rounding of the result (2^-8 relative) plus f32 ordering
    np.testing.assert_allclose(out, gather, atol=0.01 * scale, rtol=0)
    # against the Pallas kernel, whose per-view warped values are rounded
    # to bf16 before they are aggregated: a few bf16 ulps of the scale
    np.testing.assert_allclose(out, pallas, atol=0.04 * scale, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(2)
    src = torch.from_numpy(bf16_features(rng, (1, H, W, C))).to(
        torch.bfloat16)
    P, Q = port_planes(*rig())
    s = torch.from_numpy(hypotheses(False))
    before = sk.launch_counts()
    out = sk.sweep_warp(src, P, Q, s)
    torch.testing.assert_close(out, sk.sweep_warp_plain(src, P, Q, s),
                               rtol=0, atol=0)
    cv = sk.fused_cost_volume(src, src[:, None], P[:, None], Q[:, None], s)
    torch.testing.assert_close(cv, sk.fused_cost_volume_plain(
        src, src[:, None], P[:, None], Q[:, None], s), rtol=0, atol=0)
    assert sk.launch_counts() == before


@pytest.mark.parametrize("bad, match", [
    (lambda a: {**a, "src": a["src"].float()}, "bfloat16"),
    (lambda a: {**a, "src": a["src"][..., :12].contiguous()}, "channels"),
    (lambda a: {**a, "P": a["P"].double()}, "float32"),
    (lambda a: {**a, "Q": a["Q"][:, :2]}, "Q"),
    (lambda a: {**a, "s": a["s"][:, :, None]}, r"\[B, D\]"),
    (lambda a: {**a, "src": a["src"].transpose(1, 2)}, "contiguous"),
])
def test_wrapper_rejects_bad_arguments(bad, match):
    src = torch.zeros((1, H, W, C), dtype=torch.bfloat16)
    P, Q = port_planes(*rig())
    args = bad({"src": src, "P": P, "Q": Q,
                "s": torch.from_numpy(hypotheses(False))})
    with pytest.raises(ValueError, match=match):
        sk.sweep_warp(**args)
    with pytest.raises(ValueError, match="agg"):
        sk.fused_cost_volume(src, src[:, None], P[:, None], Q[:, None],
                             args["s"], agg="mean")


@pytest.mark.gpu
@pytest.mark.parametrize("agg", [None, "variance", "softmin", "backward"])
def test_cuda_kernel_matches_plain(agg):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc "
                    "and run only there (chip_smoke.py runs them)")
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    feats = torch.from_numpy(bf16_features(rng, (1, 3, H, W, C))).to(
        dev, torch.bfloat16)
    sp, rp = rig()
    P, Q = (t.to(dev) for t in port_planes(sp, rp))
    s = torch.from_numpy(hypotheses(True)).to(dev)
    if agg is None:
        n0 = sk.sweep_warp.launches
        got = sk.sweep_warp(feats[:, 1].contiguous(), P, Q, s)
        want = sk.sweep_warp_plain(feats[:, 1].contiguous(), P, Q, s)
        assert sk.sweep_warp.launches == n0 + 1
    elif agg == "backward":
        g = torch.from_numpy(bf16_features(rng, (1, D, H, W, C))).to(
            dev, torch.bfloat16)
        n0 = sk.sweep_warp_backward.launches
        got = sk.sweep_warp_backward(g, P, Q, s, (H, W), torch.float32)
        want = sk.sweep_warp_backward_plain(g, P, Q, s, (H, W))
        assert sk.sweep_warp_backward.launches == n0 + 1
        torch.cuda.synchronize()
        # f32 sums of a few terms each, added in another (atomic) order
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-4 * scale
        return
    else:
        P2, Q2 = torch.stack([P, P], 1), torch.stack([Q, Q], 1)
        temp = torch.full((1,), 0.05, device=dev)
        args = (feats[:, 0].contiguous(), feats[:, 1:].contiguous(), P2, Q2,
                s, temp, agg)
        got = sk.fused_cost_volume(*args)
        want = sk.fused_cost_volume_plain(*args)
    torch.cuda.synchronize()
    # the same f32 arithmetic up to FMA contraction and summation order:
    # at most one bf16 ulp (2^-8 relative) of the largest value
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -7 * scale


# ---------------------------------------------------------------------------
# the Vis-MVSNet convention: vis_planes, sweep_warp (kernel #2, _kernel_px)
# and sweep_gwc (kernel #3, _kernel_px_gwc)
# ---------------------------------------------------------------------------

VH, VW, VD, G = 32, 48, 6, 8


def vis_cams(hw=(VH, VW), yaw=0.02, baseline=(2.0, 0.5, 0.0), f=60.0):
    """(K_ref, R_ref, t_ref, K_src, R_src, t_src) as [1, ...] f32 numpy:
    the rig of tests/test_mosaic_sweep.py's Vis tests; a baseline with a
    z part moves the source camera along the reference axis."""
    h, w = hw
    Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                   [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    t = np.asarray(baseline, np.float32).reshape(1, 3, 1)
    return (K[None], np.eye(3, dtype=np.float32)[None],
            np.zeros((1, 3, 1), np.float32), K[None], Ry[None], t)


def vis_slab(per_pixel, hw=(VH, VW), start=425.0):
    """(depth_start [1,1,1,1] or [1,1,H,W], interval [1,1,1,1])."""
    h, w = hw
    if per_pixel:
        s0 = (start + 75.0 + 30.0 * np.sin(np.linspace(0, 3, h * w)))
        s0 = s0.reshape(1, 1, h, w).astype(np.float32)
    else:
        s0 = np.full((1, 1, 1, 1), start, np.float32)
    return s0, np.full((1, 1, 1, 1), 40.0, np.float32)


def port_vis_sweep(cams, s0, interval, ref_hw, src_hw, D=VD):
    """The port's (P, Q, s, scale, clamp) of a Vis sweep."""
    P, Q, scale, clamp = sk.vis_planes(*map(torch.from_numpy, cams),
                                       ref_hw, src_hw)
    depth = (torch.from_numpy(s0) + torch.from_numpy(interval)
             * torch.arange(D, dtype=torch.float32).reshape(1, D, 1, 1))
    s = sk.inverse_depths(depth)
    s = s[:, :, 0, 0] if s0.size == 1 else s.contiguous()
    return P, Q, s, scale, clamp


def jax_vis_gather(src, ref, cams, s0, interval, ref_hw, D=VD):
    """The JAX f32 homography gather and its group-wise correlation."""
    warped = homography_sweep_warp(jnp.asarray(src), *map(jnp.asarray, cams),
                                   D, jnp.asarray(s0), jnp.asarray(interval),
                                   ref_hw)
    corr = groupwise_correlation(
        jnp.broadcast_to(jnp.asarray(ref)[:, None], warped.shape), warped, G)
    return np.asarray(warped), np.asarray(corr)


def test_vis_planes_match_jax():
    cams = vis_cams()
    P, Q, scale, clamp = sk.vis_planes(*map(torch.from_numpy, cams),
                                       (VH, VW), (20, 30))
    Pj, Qj, sx, sy = jax_vis_planes(*(jnp.asarray(c[0]) for c in cams),
                                    (VH, VW), (20, 30))
    # the same f32 matrix products in another order: ~1e-6 relative
    np.testing.assert_allclose(P[0].numpy(), np.asarray(Pj), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(Pj)).max())
    np.testing.assert_allclose(Q[0].numpy(), np.asarray(Qj), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(Qj)).max())
    assert scale == pytest.approx((sx, sy))
    # the reference's normalized [-1.1, 1.1] clamp in source pixels
    assert clamp == pytest.approx((-0.05 * 29, 1.05 * 29, -0.05 * 19,
                                   1.05 * 19))


@pytest.mark.parametrize("per_pixel", [False, True], ids=["D", "DHW"])
def test_vis_warp_and_gwc_plain_match_pallas_and_gather(per_pixel):
    """sweep_warp_plain (Vis convention) against mosaic_sweep_warp_px and
    sweep_gwc_plain against mosaic_sweep_warp_px_gwc, both in the Pallas
    interpreter on a plan that fits its window, and both against the JAX
    f32 gather (+ groupwise_correlation)."""
    rng = np.random.default_rng(13)
    src = bf16_features(rng, (1, VH, VW, C))
    ref = bf16_features(rng, (1, VH, VW, C))
    cams = vis_cams()
    s0, interval = vis_slab(per_pixel)
    P, Q, s, scale, clamp = port_vis_sweep(cams, s0, interval, (VH, VW),
                                           (VH, VW))

    Pj, Qj, sx, sy = jax_vis_planes(*(jnp.asarray(c[0]) for c in cams),
                                    (VH, VW), (VH, VW))
    sv = jnp.asarray(s[0].numpy())
    plan = sweep_spans_px(Pj, Qj, sv, (VH, VW), sx=sx, sy=sy)
    KR = VH + 2
    assert bool(_plan_fit(plan, 2, KR, 2, VH + 2)), "the plan must fit"
    src_bf = jnp.asarray(src[0], jnp.bfloat16)
    pallas = np.asarray(jnp.transpose(mosaic_sweep_warp_px(
        src_bf, Pj, Qj, sv, plan, KY=2, KR=KR, sx=sx, sy=sy,
        interpret=True), (0, 1, 3, 2)), np.float32)
    pallas_gwc = np.asarray(jnp.transpose(mosaic_sweep_warp_px_gwc(
        src_bf, jnp.transpose(jnp.asarray(ref[0], jnp.bfloat16), (0, 2, 1)),
        Pj, Qj, sv, plan, groups=G, KY=2, KR=KR, sx=sx, sy=sy,
        interpret=True), (0, 1, 3, 2)), np.float32)
    warped, corr = jax_vis_gather(src, ref, cams, s0, interval, (VH, VW))

    t_src = torch.from_numpy(src).to(torch.bfloat16)
    t_ref = torch.from_numpy(ref).to(torch.bfloat16)
    out = sk.sweep_warp(t_src, P, Q, s, scale, clamp)
    assert out.dtype == torch.bfloat16 and out.shape == (1, VD, VH, VW, C)
    out = out[0].float().numpy()
    cv = sk.sweep_gwc(t_src, t_ref, P, Q, s, scale, clamp)
    assert cv.dtype == torch.bfloat16 and cv.shape == (1, VD, VH, VW, G)
    cv = cv[0].float().numpy()
    assert (np.abs(warped) > 0).mean() > 0.5
    # warp: one bf16 rounding of values below ~5 (<= 0.02) plus ~1e-5 px
    # coordinate differences against the f32 gather; against the Pallas
    # kernel, which also rounds its weights and its combine to bf16, a few
    # bf16 ulps
    np.testing.assert_allclose(out, warped[0], atol=0.03, rtol=0)
    np.testing.assert_allclose(out, pallas, atol=0.08, rtol=0)
    assert (out[warped[0] == 0] == 0).all()
    # correlation: sums of C/G = 2 products of values below ~5 (|corr| up
    # to ~20), rounded once to bf16 (2^-8 relative, <= 0.08) against the
    # f32 truth; the Pallas kernel rounds each warped value to bf16 first
    scale_c = np.abs(corr).max()
    np.testing.assert_allclose(cv, corr[0], atol=2 ** -7 * scale_c, rtol=0)
    np.testing.assert_allclose(cv, pallas_gwc, atol=0.02 * scale_c, rtol=0)
    # and the port is at least as close to the truth as the Pallas kernel
    assert np.abs(cv - corr[0]).max() <= np.abs(pallas_gwc
                                                - corr[0]).max() + 1e-6


@pytest.mark.parametrize("case", ["small-source", "behind-camera"])
def test_vis_edge_rigs_match_the_gather(case):
    """Where the JAX package keeps the Vis kernels off (a source under 21
    px, whose normalized clamp lands samples on pixel 0) and a source
    camera ahead of part of the sweep (behind-camera samples), only the
    exact gather is the reference: the port's plain versions match it."""
    rng = np.random.default_rng(17)
    if case == "small-source":
        ref_hw, src_hw = (8, 10), (8, 10)
        cams = vis_cams(ref_hw, yaw=0.3, baseline=(6.0, 1.0, 0.0), f=12.0)
        s0, interval = vis_slab(True, ref_hw, start=20.0)
        interval = interval / 20.0
    else:
        ref_hw = src_hw = (VH, VW)
        # 600 units ahead: hypotheses 425..625 lie partly behind the source
        cams = vis_cams(baseline=(2.0, 0.5, -600.0))
        s0, interval = vis_slab(False)
    src = bf16_features(rng, (1,) + src_hw + (C,))
    ref = bf16_features(rng, (1,) + ref_hw + (C,))
    P, Q, s, scale, clamp = port_vis_sweep(cams, s0, interval, ref_hw,
                                           src_hw)
    warped, corr = jax_vis_gather(src, ref, cams, s0, interval, ref_hw)
    t_src = torch.from_numpy(src).to(torch.bfloat16)
    out = sk.sweep_warp(t_src, P, Q, s, scale, clamp)[0].float().numpy()
    cv = sk.sweep_gwc(t_src, torch.from_numpy(ref).to(torch.bfloat16), P, Q,
                      s, scale, clamp)[0].float().numpy()
    np.testing.assert_allclose(out, warped[0], atol=0.03, rtol=0)
    np.testing.assert_allclose(cv, corr[0], rtol=0,
                               atol=2 ** -7 * np.abs(corr).max())
    rx, ry, rz = sk._project(P, Q, s)
    x, _ = sk.source_coords(rx, ry, rz, scale)           # before the clamp
    if case == "small-source":
        # samples beyond the image that the clamp brings back onto it: the
        # rule matters here, and without it the result differs
        assert ((x < -1) | (x >= src_hw[1])).any()
        assert (np.abs(warped) > 0).mean() > 0.99
        bare = sk.sweep_warp_plain(t_src, P, Q, s, scale)[0].float().numpy()
        assert np.abs(bare - warped[0]).max() > 0.1
    else:
        behind = (rz <= 0)[0].numpy()
        assert 0 < behind.mean() < 1
        # behind the camera the gather reads pixel -10: exact zeros
        assert (out[behind] == 0).all() and (warped[0][behind] == 0).all()


# the plain sampler as it was before the Vis convention, kept verbatim:
# the MVSNet plain versions must give bitwise what it gave with the default
# (unit scale, no clamp) convention
def _taps_mvsnet_only(rx, ry, rz, h, w):
    b = rx.shape[0]
    pos = rz > 0
    safe_z = torch.where(pos, rz, torch.ones_like(rz))
    x = rx / safe_z
    y = ry / safe_z
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    live = (pos & (x0f >= -1) & (x0f <= w - 1)
            & (y0f >= -1) & (y0f <= h - 1))
    fx = x - x0f
    fy = y - y0f
    zero = torch.zeros_like(fx)
    wts = [torch.where(live, wt, zero)[..., None]
           for wt in ((1 - fy) * (1 - fx), (1 - fy) * fx,
                      fy * (1 - fx), fy * fx)]
    ix = torch.where(live, x0f + 1, zero).long()
    iy = torch.where(live, y0f + 1, zero).long()
    idx = (iy * (w + 2) + ix).reshape(b, -1)
    return idx, (0, 1, w + 2, w + 3), wts


@pytest.mark.parametrize("rig_case", ["D", "DHW", "behind-camera"])
def test_mvsnet_plain_versions_are_unchanged_bitwise(rig_case, monkeypatch):
    """With the default convention the warp, its backward and the fused
    volume give exactly what the sampler gave before the Vis convention."""
    rng = np.random.default_rng(19)
    feats = torch.from_numpy(bf16_features(rng, (1, 3, H, W, C))).to(
        torch.bfloat16)
    if rig_case == "behind-camera":
        sp, rp = rig(baseline=(2.0, 0.5, -700.0))
    else:
        sp, rp = rig()
    P, Q = port_planes(sp, rp)
    s = torch.from_numpy(hypotheses(rig_case == "DHW"))
    if rig_case == "behind-camera":
        assert (sk._project(P, Q, s)[2] <= 0).any()
    g = torch.from_numpy(bf16_features(rng, (1, D, H, W, C))).to(
        torch.bfloat16)
    P2, Q2 = torch.stack([P, P * 0.9], 1), torch.stack([Q, Q], 1)
    temp = torch.tensor([0.05])
    src = feats[:, 1].contiguous()

    def run(**conv):
        return (sk.sweep_warp_plain(src, P, Q, s, **conv),
                sk.sweep_warp_backward_plain(g, P, Q, s, (H, W), **conv),
                sk.fused_cost_volume_plain(feats[:, 0], feats[:, 1:], P2, Q2,
                                           s, None, "variance"),
                sk.fused_cost_volume_plain(feats[:, 0], feats[:, 1:], P2, Q2,
                                           s, temp, "softmin"))
    now = run()
    explicit = run(scale=sk.UNIT_SCALE, clamp=None)
    monkeypatch.setattr(sk, "_taps", lambda rx, ry, rz, h, w, scale=None,
                        clamp=None: _taps_mvsnet_only(rx, ry, rz, h, w))
    before = run()
    for a, b, c in zip(now, explicit, before):
        assert torch.equal(a, c) and torch.equal(b, c)


def test_gwc_wrapper_checks_and_counts_nothing_on_the_cpu():
    src = torch.zeros((1, VH, VW, C), dtype=torch.bfloat16)
    P, Q, s, scale, clamp = port_vis_sweep(vis_cams(), *vis_slab(False),
                                           (VH, VW), (VH, VW))
    before = sk.launch_counts()
    assert set(before) == {"sweep_warp", "sweep_warp_backward",
                           "fused_cost_volume", "sweep_gwc", "conv3d_head"}
    out = sk.sweep_gwc(src, src, P, Q, s, scale, clamp)
    assert out.shape == (1, VD, VH, VW, G) and sk.launch_counts() == before
    with pytest.raises(ValueError, match="groups"):
        sk.sweep_gwc(src, src, P, Q, s, scale, clamp, groups=4)
    with pytest.raises(ValueError, match="bfloat16"):
        sk.sweep_gwc(src, src.float(), P, Q, s, scale, clamp)
    with pytest.raises(ValueError, match="channels"):
        sk.sweep_gwc(src[..., :8].repeat(1, 1, 1, 16), src[..., :8].repeat(
            1, 1, 1, 16), P, Q, s)
    with pytest.raises(ValueError, match="does not match"):
        sk.sweep_gwc(src, src[:, :16], P, Q, s)
    with pytest.raises(ValueError, match="clamp"):
        sk.sweep_gwc(src, src, P, Q, s, scale, (1.0, 0.0, 0.0, 1.0))
    with pytest.raises(ValueError, match="no backward"):
        sk.sweep_gwc(src.requires_grad_(), src, P, Q, s)
