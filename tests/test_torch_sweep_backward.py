"""The warp's backward (ops/sweep_kernels.py `sweep_warp_backward`, the
autograd of `sweep_warp`) and the aggregations' gradients vs the JAX package.

On the CPU the port's wrappers run their plain versions: the backward is an
f32 `index_add_` scatter over the four bilinear corners, the exact
transpose of the plain forward. It is held to the JAX package's custom VJP
`plane_sweep_warp_mosaic` and scatter kernel `mosaic_scatter_px`, run by the
Pallas interpreter (bf16 weights, f32 accumulation), and to the f32 transpose
of the JAX gather (`jax.linear_transpose` of `grid_sample_xy`), in both sweep
conventions (Vis-MVSNet: `mosaic_scatter_px` with (sx, sy), `jax.vjp` of
`homography_sweep_warp`). The CUDA
kernel is compared with the plain version on the card (the `gpu`-marked
test in tests/test_torch_sweep_kernels.py and chip_smoke.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wildmvs.ops import volumes as jax_volumes
from wildmvs.ops.grid_sample import grid_sample_xy
from wildmvs.ops.mosaic_sweep import (_plan_fit_scatter, _warp_mosaic_bwd,
                                      mosaic_scatter_px, mvsnet_planes,
                                      sweep_spans_px)
from wildmvs.ops.mosaic_sweep import vis_planes as jax_vis_planes
from wildmvs.ops.plane_sweep import homography_sweep_warp, sweep_grid_xy
from wildmvs_torch.ops import sweep_kernels as sk
from wildmvs_torch.ops import volumes

torch.set_num_threads(1)

# the rig and sizes of tests/test_mosaic_sweep.py:229-263 and :721-756
H, W, C = 16, 40, 8


def rig(yaw=0.02, baseline=(2.0, 0.5, 0.0), f=60.0):
    Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                   [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    ref_proj = np.eye(4, dtype=np.float32)
    ref_proj[:3, :3] = K
    src_proj = np.eye(4, dtype=np.float32)
    src_proj[:3, :3] = K @ Ry
    src_proj[:3, 3] = K @ np.asarray(baseline, np.float32)
    return src_proj, ref_proj


def per_pixel_hypotheses(D):
    base = 600.0 + 30.0 * np.sin(np.linspace(0, 3, H))[:, None] \
        + 10.0 * np.cos(np.linspace(0, 2, W))[None, :]
    return (base[None] + np.linspace(-15, 15, D)[:, None, None]
            ).astype(np.float32)[None]                     # [1, D, H, W]


def port_planes(src_proj, ref_proj):
    return sk.mvsnet_planes(torch.from_numpy(src_proj)[None],
                            torch.from_numpy(ref_proj)[None], (H, W))


def f32_transpose(src_proj, ref_proj, hyp, g):
    """The exact f32 transpose of the JAX gather warp at cotangent g
    [1, D, H, W, C] (f32 numpy) -> [1, H, W, C]."""
    xn, yn = sweep_grid_xy(jnp.asarray(src_proj)[None],
                           jnp.asarray(ref_proj)[None], jnp.asarray(hyp),
                           (H, W), (H, W))
    tr = jax.linear_transpose(
        lambda im: jax.vmap(lambda i, gx, gy: grid_sample_xy(
            i, gx, gy, align_corners=True))(im, xn, yn),
        jax.ShapeDtypeStruct((1, H, W, C), jnp.float32))
    return np.asarray(tr(jnp.asarray(g))[0])


def test_warp_vjp_matches_pallas_custom_vjp_and_f32_transpose():
    """sweep_warp's autograd (plain scatter on the CPU) against the
    backward rule of the JAX custom VJP plane_sweep_warp_mosaic, which runs
    the Pallas scatter kernel in the interpreter, and against the f32
    transpose. (The rule is called on its residuals directly: the VJP's
    forward, the interpreted warp kernel, adds nothing to the gradient.)"""
    D = 6
    rng = np.random.default_rng(7)
    src = rng.standard_normal((1, H, W, C)).astype(np.float32)
    cot = rng.standard_normal((1, D, H, W, C)).astype(np.float32)
    src_bf = jnp.asarray(src, jnp.bfloat16)
    cot_bf = jnp.asarray(cot, jnp.bfloat16)
    sp, rp = rig()
    depths = np.linspace(425.0, 935.0, D).astype(np.float32)[None]

    # the JAX VJP must take its kernel, not its XLA fallback
    P_j, Q_j, sx, sy = mvsnet_planes(jnp.asarray(sp), jnp.asarray(rp),
                                     (H, W))
    plan = sweep_spans_px(P_j, Q_j, jnp.asarray(depths[0]), (H, W), sx=sx,
                          sy=sy)
    assert bool(_plan_fit_scatter(plan, 2))
    res = (src_bf, jnp.asarray(sp)[None], jnp.asarray(rp)[None],
           jnp.asarray(depths))
    pallas = np.asarray(_warp_mosaic_bwd((H, W), True, res, cot_bf)[0],
                        np.float32)
    truth = f32_transpose(sp, rp, depths,
                          np.asarray(cot_bf.astype(jnp.float32)))

    P, Q = port_planes(sp, rp)
    x = torch.from_numpy(src).to(torch.bfloat16).requires_grad_()
    out = sk.sweep_warp(x, P, Q, torch.from_numpy(depths))
    assert out.requires_grad
    out.backward(torch.from_numpy(np.asarray(cot_bf, np.float32)).to(
        torch.bfloat16))
    assert x.grad.dtype == torch.bfloat16            # cast as the JAX VJP
    got = x.grad.float().numpy()
    scale = np.abs(truth).max()
    assert scale > 1.0 and (np.abs(truth) > 0).mean() > 0.5
    # against the f32 transpose: one bf16 rounding of the result (2^-8
    # relative) plus ~1e-6 px coordinate differences of the normalized
    # grid round trip
    np.testing.assert_allclose(got, truth, rtol=2 ** -8, atol=1e-3 * scale)
    # against the Pallas kernel (bf16 bilinear weights, mosaic_sweep.py
    # :1961-1964): the bound tests/test_mosaic_sweep.py holds it to
    assert np.abs(got - pallas).max() < 0.02 * scale
    # and the port is at least as close to the truth as the Pallas kernel
    assert np.abs(got - truth).max() <= np.abs(pallas - truth).max() + 1e-6


def test_scatter_per_pixel_hypotheses_matches_pallas_and_f32_transpose():
    """sweep_warp_backward with [B, D, H, W] hypotheses against
    mosaic_scatter_px (interpreter) and the f32 transpose."""
    D = 4
    rng = np.random.default_rng(33)
    sp, rp = rig()
    hyp = per_pixel_hypotheses(D)
    g = jnp.asarray(rng.standard_normal((D, H, W, C)), jnp.bfloat16)
    truth = f32_transpose(sp, rp, hyp, np.asarray(g, np.float32)[None])
    P_j, Q_j, sx, sy = mvsnet_planes(jnp.asarray(sp), jnp.asarray(rp),
                                     (H, W))
    plan = sweep_spans_px(P_j, Q_j, jnp.asarray(hyp[0]), (H, W), sx=sx,
                          sy=sy)
    assert bool(_plan_fit_scatter(plan, 2))
    pallas = np.asarray(mosaic_scatter_px(g, P_j, Q_j, jnp.asarray(hyp[0]),
                                          plan, (H, W), interpret=True),
                        np.float32)

    P, Q = port_planes(sp, rp)
    g_t = torch.from_numpy(np.asarray(g, np.float32))[None].to(
        torch.bfloat16)
    s = torch.from_numpy(hyp)
    df32 = sk.sweep_warp_backward(g_t, P, Q, s, (H, W), dtype=torch.float32)
    assert df32.dtype == torch.float32 and df32.shape == (1, H, W, C)
    got = df32[0].numpy()
    scale = max(1.0, np.abs(truth).max())
    # the f32 accumulation against the f32 transpose: summation order and
    # ~1e-6 px coordinate differences only
    np.testing.assert_allclose(got, truth[0], rtol=1e-4, atol=1e-5 * scale)
    assert np.abs(got - pallas).max() < 0.02 * scale
    # the default result is that accumulation rounded once to bf16, and it
    # is what sweep_warp's autograd returns
    df = sk.sweep_warp_backward(g_t, P, Q, s, (H, W))
    torch.testing.assert_close(df, df32.to(torch.bfloat16), rtol=0, atol=0)
    x = torch.zeros((1, H, W, C), dtype=torch.bfloat16, requires_grad=True)
    sk.sweep_warp(x, P, Q, s).backward(g_t)
    torch.testing.assert_close(x.grad, df, rtol=0, atol=0)


class _SampleF64(torch.autograd.Function):
    """The plain sampler and its plain transpose in float64."""

    @staticmethod
    def forward(ctx, img, rx, ry, rz):
        ctx.save_for_backward(rx, ry, rz)
        ctx.hw = tuple(img.shape[1:3])
        return sk._sample_f32(img, rx, ry, rz, dtype=torch.float64)

    @staticmethod
    def backward(ctx, g):
        rx, ry, rz = ctx.saved_tensors
        return (sk._scatter_f32(g, rx, ry, rz, ctx.hw, dtype=torch.float64),
                None, None, None)


def test_plain_backward_is_the_transpose_of_the_plain_forward():
    """gradcheck in float64: the scatter is the exact transpose of the
    sampler (the warp is linear in the features, so finite differences are
    exact up to f64 rounding), on a rig whose samples leave the image on
    every side and lie partly behind the source camera."""
    rng = np.random.default_rng(3)
    h, w, c, d, Hr, Wr = 5, 7, 2, 3, 4, 6
    src_proj = np.eye(4, dtype=np.float32)
    src_proj[:3, :3] = [[6.0, 0.0, 3.0], [0.0, 6.0, 2.0], [0.0, 0.0, 1.0]]
    src_proj[:3, 3] = [4.0, -2.0, -3.0]            # 3 units ahead of ref
    ref_proj = np.eye(4, dtype=np.float32)
    ref_proj[:3, :3] = [[2.0, 0.0, 3.0], [0.0, 2.0, 2.0], [0.0, 0.0, 1.0]]
    P, Q = sk.mvsnet_planes(torch.from_numpy(src_proj)[None],
                            torch.from_numpy(ref_proj)[None], (Hr, Wr))
    s = torch.tensor([[1.5, 5.0, 9.0]])
    rx, ry, rz = sk._project(P, Q, s)
    assert (rz <= 0).any() and (rz > 0).any()
    img = torch.from_numpy(rng.standard_normal((1, h, w, c))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda im: _SampleF64.apply(im, rx, ry, rz), (img,))
    # and <A x, g> == <x, A^T g> at the f32 wrapper's plain versions
    g = torch.from_numpy(rng.standard_normal((1, d, Hr, Wr, c)))
    lhs = (sk._sample_f32(img.detach(), rx, ry, rz, torch.float64) * g).sum()
    rhs = (img.detach() * sk._scatter_f32(g, rx, ry, rz, (h, w),
                                          torch.float64)).sum()
    assert abs(lhs.item() - rhs.item()) < 1e-12 * max(1.0, abs(lhs.item()))


@pytest.mark.parametrize("agg", ["variance", "softmin"])
def test_aggregation_gradients_match_jax(agg):
    """variance/softmin_cost_volume gradients (ref, each warped volume and
    the softmin temperature) against jax.vjp of wildmvs/ops/volumes.py."""
    D, h, w, c = 6, 8, 10, 8
    rng = np.random.default_rng(21)
    ref = rng.standard_normal((1, h, w, c)).astype(np.float32)
    warped = [rng.standard_normal((1, D, h, w, c)).astype(np.float32)
              for _ in range(2)]
    cot = rng.standard_normal((1, D, h, w, c)).astype(np.float32)
    temp = np.array([0.07], np.float32)

    if agg == "variance":
        def jfn(r, w0, w1, t):
            return jax_volumes.variance_cost_volume(r, [w0, w1], num_depth=D)
    else:
        def jfn(r, w0, w1, t):
            return jax_volumes.softmin_cost_volume(r, [w0, w1], temperature=t)
    want, vjp = jax.vjp(jfn, ref, *warped, temp)
    want_grads = [np.asarray(x) for x in vjp(jnp.asarray(cot))]

    inputs = [torch.from_numpy(x).requires_grad_() for x in
              (ref, *warped, temp)]
    r, w0, w1, t = inputs
    if agg == "variance":
        got = volumes.variance_cost_volume(r, [w0, w1], num_depth=D)
    else:
        got = volumes.softmin_cost_volume(r, [w0, w1], temperature=t)
    got.backward(torch.from_numpy(cot))
    # f32 throughout: rounding only
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    n_grads = 4 if agg == "softmin" else 3
    for x, wg in zip(inputs[:n_grads], want_grads):
        np.testing.assert_allclose(x.grad.numpy(), wg, rtol=1e-4,
                                   atol=1e-5 * np.abs(wg).max())
    # without grad the in-place path gives the same values, up to the f32
    # rounding of addcmul_'s fused multiply-add
    with torch.no_grad():
        fn = (volumes.variance_cost_volume if agg == "variance" else
              volumes.softmin_cost_volume)
        kw = {"num_depth": D} if agg == "variance" else {"temperature": t}
        again = fn(r, [w0, w1], **kw)
    torch.testing.assert_close(again, got.detach(), rtol=1e-6, atol=0)


def test_fused_cost_volume_refuses_inputs_that_require_grad():
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.standard_normal((1, H, W, C)).astype(
        np.float32)).to(torch.bfloat16)
    P, Q = port_planes(*rig())
    s = torch.linspace(425.0, 935.0, 4)[None]
    temp = torch.ones(1, requires_grad=True)
    args = (feats, feats[:, None], P[:, None], Q[:, None], s, temp,
            "softmin")
    with pytest.raises(ValueError, match="no backward"):
        sk.fused_cost_volume(*args)
    with pytest.raises(ValueError, match="no backward"):
        sk.fused_cost_volume(feats.requires_grad_(), *args[1:5])
    with torch.no_grad():
        assert sk.fused_cost_volume(*args).shape == (1, 4, H, W, C)


def test_backward_wrapper_checks_and_counts_nothing_on_the_cpu():
    P, Q = port_planes(*rig())
    s = torch.linspace(425.0, 935.0, 4)[None]
    g = torch.zeros((1, 4, H, W, C), dtype=torch.bfloat16)
    before = sk.launch_counts()
    assert set(before) == {"sweep_warp", "sweep_warp_backward",
                           "fused_cost_volume", "sweep_gwc", "conv3d_head"}
    df = sk.sweep_warp_backward(g, P, Q, s, (5, 7))
    assert df.shape == (1, 5, 7, C) and df.dtype == torch.bfloat16
    assert sk.launch_counts() == before
    with pytest.raises(ValueError, match="bfloat16"):
        sk.sweep_warp_backward(g.float(), P, Q, s, (5, 7))
    with pytest.raises(ValueError, match="does not match"):
        sk.sweep_warp_backward(g[:, :3], P, Q, s, (5, 7))


# ---------------------------------------------------------------------------
# the Vis-MVSNet convention: the scatter with the (sx, sy) scale and clamp
# ---------------------------------------------------------------------------

VH, VW = 32, 48


def vis_sweep(case, D=6):
    """numpy cams, slab and sizes of one Vis sweep, and the port's (P, Q,
    s, scale, clamp)."""
    ref_hw = src_hw = (VH, VW)
    yaw, base, f, start, step = 0.02, (2.0, 0.5, 0.0), 60.0, 425.0, 40.0
    if case == "small-source":
        ref_hw = src_hw = (8, 10)
        yaw, base, f, start, step = 0.3, (6.0, 1.0, 0.0), 12.0, 20.0, 2.0
    elif case == "behind-camera":
        # 600 units ahead: hypotheses 425..925 lie partly behind the source
        base, step = (2.0, 0.5, -600.0), 100.0
    h, w = ref_hw
    Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                   [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    cams = (K[None], np.eye(3, dtype=np.float32)[None],
            np.zeros((1, 3, 1), np.float32), K[None], Ry[None],
            np.asarray(base, np.float32).reshape(1, 3, 1))
    if case == "DHW" or case == "small-source":
        s0 = (start + 30.0 * np.sin(np.linspace(0, 3, h * w))).reshape(
            1, 1, h, w).astype(np.float32)
    else:
        s0 = np.full((1, 1, 1, 1), start, np.float32)
    interval = np.full((1, 1, 1, 1), step, np.float32)
    P, Q, scale, clamp = sk.vis_planes(*map(torch.from_numpy, cams), ref_hw,
                                       src_hw)
    depth = (torch.from_numpy(s0) + torch.from_numpy(interval)
             * torch.arange(D, dtype=torch.float32).reshape(1, D, 1, 1))
    s = sk.inverse_depths(depth)
    s = s[:, :, 0, 0] if s0.size == 1 else s.contiguous()
    return cams, s0, interval, ref_hw, src_hw, (P, Q, s, scale, clamp)


@pytest.mark.parametrize("case", ["D", "DHW", "small-source",
                                  "behind-camera"])
def test_vis_warp_vjp_matches_pallas_scatter_and_jax_vjp(case):
    """sweep_warp's autograd in the Vis convention (the plain scatter with
    the coordinate scale and clamp) against jax.vjp of the JAX f32
    homography_sweep_warp and, where the JAX package runs its kernel (a
    source of 21 px or more whose plan fits), against mosaic_scatter_px
    with (sx, sy) in the Pallas interpreter."""
    D = 6
    rng = np.random.default_rng(29)
    cams, s0, interval, ref_hw, src_hw, (P, Q, s, scale, clamp) = \
        vis_sweep(case, D)
    src = rng.standard_normal((1,) + src_hw + (C,)).astype(np.float32)
    g = jnp.asarray(rng.standard_normal((1, D) + ref_hw + (C,)),
                    jnp.bfloat16)
    g32 = np.asarray(g, np.float32)
    _, vjp = jax.vjp(lambda f: homography_sweep_warp(
        f, *map(jnp.asarray, cams), D, jnp.asarray(s0),
        jnp.asarray(interval), ref_hw), jnp.asarray(src))
    truth = np.asarray(vjp(jnp.asarray(g32))[0])

    x = torch.from_numpy(src).to(torch.bfloat16).requires_grad_()
    out = sk.sweep_warp(x, P, Q, s, scale, clamp)
    out.backward(torch.from_numpy(g32).to(torch.bfloat16))
    df32 = sk.sweep_warp_backward(torch.from_numpy(g32).to(torch.bfloat16),
                                  P, Q, s, src_hw, torch.float32,
                                  scale=scale, clamp=clamp)[0].numpy()
    scale_g = max(1.0, np.abs(truth).max())
    assert (np.abs(truth) > 0).mean() > 0.1
    if case == "behind-camera":
        assert 0 < (sk._project(P, Q, s)[2] <= 0).float().mean() < 1
    # the f32 accumulation against the f32 transpose: summation order and
    # ~1e-5 px coordinate differences of the normalized grid round trip
    np.testing.assert_allclose(df32, truth[0], rtol=1e-4,
                               atol=1e-4 * scale_g)
    # autograd returns that accumulation rounded once to bf16
    torch.testing.assert_close(x.grad[0], torch.from_numpy(df32).to(
        torch.bfloat16), rtol=0, atol=0)
    if case in ("D", "DHW"):
        Pj, Qj, sx, sy = jax_vis_planes(*(jnp.asarray(c[0]) for c in cams),
                                        ref_hw, src_hw)
        sv = jnp.asarray(s[0].numpy())
        plan = sweep_spans_px(Pj, Qj, sv, src_hw, sx=sx, sy=sy)
        assert bool(_plan_fit_scatter(plan, 2))
        pallas = np.asarray(mosaic_scatter_px(g[0], Pj, Qj, sv, plan, src_hw,
                                              sx=sx, sy=sy, interpret=True),
                            np.float32)
        # the Pallas kernel takes bf16 bilinear weights (mosaic_sweep.py
        # :1961-1964): the bound tests/test_mosaic_sweep.py holds it to
        assert np.abs(df32 - pallas).max() < 0.02 * scale_g
        assert np.abs(df32 - truth[0]).max() <= \
            np.abs(pallas - truth[0]).max() + 1e-6
