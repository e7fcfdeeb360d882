"""The port's sweep kernels (ops/sweep_kernels.py) vs the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which repeats the
CUDA kernel's arithmetic (f32 coordinates, weights and combine over bf16
features, one bf16 rounding). It is held to the JAX Pallas kernels run by
the Pallas interpreter (bf16 weights and a bf16 combine) and to the JAX f32
exact gather. The CUDA kernels themselves are compared with the plain
versions on the card by the `gpu`-marked tests here and by chip_smoke.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wildmvs.ops.mosaic_sweep import (fused_cost_volume_px,
                                      mosaic_sweep_warp, rot_planes,
                                      sweep_spans)
from wildmvs.ops.plane_sweep import plane_sweep_warp
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
