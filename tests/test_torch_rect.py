"""The port's rectified sweep (wildmvs_torch/ops/rect_sweep.py) vs the JAX
package's (wildmvs/ops/rect_sweep.py), on the CPU.

Inputs are numpy arrays from a seed. The JAX rect volumes run their Pallas
kernels in interpret mode (`interpret=True`), on rigs where the JAX window
plan fits (asserted through `_plan_fit`), so that both sides take the
rectified branch; the port's volumes run the plain versions of its kernels.

Tolerances:
  * geometry (A, e, planes, canvases): f32, 1e-5 of the scale (the same
    f32 arithmetic in another order); shifts and coverage exactly;
  * volumes: 2^-7 of the scale: the Pallas kernel rounds each warped
    sample to bf16 and combines with bf16 weights, the port's fused kernel
    keeps its sums in f32 (an expected difference, ROADMAP Queue 3);
    softmin's squared differences, and the correlation's products of
    once-rounded samples, double it: 2^-6; every mean within 2^-9;
  * model forwards (f32 networks, rect at every eligible level): depths
    within a mean of 0.1 and 95 % of pixels within 0.5 of the finest
    hypothesis interval, as tests/test_torch_mvsnet.py holds the kernel
    paths to the gather.
The JAX models take rect on the CPU only under the monkeypatch of their
TPU-backend gate (`mosaic_px_supported`), with the Pallas calls forced to
interpret mode, as tests/test_rect_sweep.py does.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import wildmvs.ops.mosaic_sweep as jms
import wildmvs.ops.rect_sweep as jrs
from wildmvs.models import build_model as jax_build_model
from wildmvs.pipeline.depthmaps import eval_model_kwargs as jax_eval_kwargs
from wildmvs_torch.models import build_model
from wildmvs_torch.ops import rect_sweep as rs
from wildmvs_torch.ops import sweep_kernels as sk
from wildmvs_torch.pipeline.depthmaps import eval_model_kwargs
from wildmvs_torch.train.jax_import import state_dict_from_jax
from tests.test_torch_cvp import cvp_scene
from tests.test_torch_cvp import fill as cvp_fill
from tests.test_torch_mvsnet import jax_variables, scene
from tests.test_torch_vis import fill_tree

torch.set_num_threads(1)

H, W, C, D = 16, 24, 8, 8
F = 30.0
ROT = 2.0 ** -7          # volumes: one bf16 rounding of the scale


def rot(yaw, roll):
    cy, sy = np.cos(yaw), np.sin(yaw)
    cr, sr = np.cos(roll), np.sin(roll)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return (Rz @ Ry).astype(np.float32)


def rig(n=2, h=H, w=W, f=F, yaw=0.03, roll=0.01, base=0.12):
    """K [N, 3, 3], R [N, 3, 3], t [N, 3, 1]: the reference at the origin,
    view i rotated by i*(yaw, roll) and moved i*base sideways (depths
    2..6)."""
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    R = np.stack([rot(i * yaw, i * roll) for i in range(n)])
    t = np.stack([np.array([[base * i], [0.3 * base * i], [0.02 * i]],
                           np.float32) for i in range(n)])
    return np.stack([K] * n), R, t


def projections(K, R, t):
    P = np.tile(np.eye(4, dtype=np.float32), (K.shape[0], 1, 1))
    P[:, :3, :3] = K @ R
    P[:, :3, 3:] = K @ t
    return P


def hypotheses(per_pixel, h=H, w=W, d=D):
    """[D] depths 2..6, or per-pixel [D, H, W] slabs on a tilted plane."""
    if not per_pixel:
        return np.linspace(2.0, 6.0, d).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 3.0 + 0.02 * xs + 0.01 * ys
    return (base[None] + 0.1 * np.arange(d)[:, None, None]).astype(
        np.float32)


def features(seed, n, h=H, w=W, c=C):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, h, w, c)).astype(np.float32)
            for _ in range(n)]


def t32(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rel=1e-5, mean_rel=None):
    """max |got - want| <= rel x the scale (max |want|), and the mean
    within mean_rel x the scale where given."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want)
    assert err.max() <= rel * scale, (err.max(), scale)
    if mean_rel is not None:
        assert err.mean() <= mean_rel * scale, (err.mean(), scale)
    return err.max()


# --- geometry ------------------------------------------------------------

def test_rect_decompose_and_margin_match_jax():
    K, R, t = rig(3)
    P = projections(K, R, t)
    for i in (1, 2):
        A, e = rs.rect_decompose(t32(P[i]), t32(P[0]))
        Aj, ej = jrs.rect_decompose(jnp.asarray(P[i]), jnp.asarray(P[0]))
        close(A, Aj)
        close(e, ej)
    # batched over [B, NV] as the port's volumes call it
    A, e = rs.rect_decompose(t32(P[None, 1:]), t32(P[None, :1]))
    assert A.shape == (1, 2, 3, 3) and e.shape == (1, 2, 3)
    close(e[0, 1], jrs.rect_decompose(jnp.asarray(P[2]),
                                      jnp.asarray(P[0]))[1])
    for hw in ((16, 24), (74, 100), (296, 400), (1184, 1600), (8, 8)):
        assert rs.rect_margin(hw) == jrs.rect_margin(hw)


def test_vis_rect_decompose_matches_jax():
    K, R, t = rig(2)
    A, e = rs.vis_rect_decompose(*(t32(a[0]) for a in (K, R, t)),
                                 *(t32(a[1]) for a in (K, R, t)))
    Aj, ej = jrs.vis_rect_decompose(*(jnp.asarray(a[0]) for a in (K, R, t)),
                                    *(jnp.asarray(a[1]) for a in (K, R, t)))
    close(A, Aj)
    close(e, ej)


@pytest.mark.parametrize("offset", [0.0, 0.5])
def test_rect_shift_and_planes_match_jax(offset):
    rng = np.random.default_rng(1)
    for per_pixel in (False, True):
        e = (rng.standard_normal(3) * [20.0, 10.0, 0.05]).astype(np.float32)
        s = 1.0 / hypotheses(per_pixel)
        shift = rs.rect_shift(t32(e), t32(s), (H, W), offset)
        shift_j = jrs.rect_shift(jnp.asarray(e), jnp.asarray(s), (H, W),
                                 offset)
        np.testing.assert_array_equal(shift.numpy(), np.asarray(shift_j))
        P, Q = rs.rect_planes(t32(e), (H, W), 32, shift, offset)
        Pj, Qj = jrs.rect_planes(jnp.asarray(e), (H, W), 32, shift_j, offset)
        close(P, Pj)
        close(Q, Qj)
    P, Q = rs.rect_planes(t32(e), (H, W), 32)
    Pj, Qj = jrs.rect_planes(jnp.asarray(e), (H, W), 32)
    close(P, Pj)
    close(Q, Qj)


def test_rect_shift_rounds_half_to_even():
    # e_z = 0, one hypothesis s = 0.5: the mid-sweep disparity is e_xy / 2,
    # which lies half-way: (0.5, 1.5) -> (0, 2) and (2.5, 3.5) -> (2, 4), as
    # jnp.round does (what keeps a pure-translation rig bit-exact)
    s = np.array([0.5], np.float32)
    for e, want in (([1.0, 3.0, 0.0], [0.0, 2.0]),
                    ([5.0, 7.0, 0.0], [2.0, 4.0]),
                    ([-1.0, -3.0, 0.0], [-0.0, -2.0])):
        e = np.array(e, np.float32)
        got = rs.rect_shift(t32(e), t32(s), (H, W))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jrs.rect_shift(jnp.asarray(e),
                                                   jnp.asarray(s), (H, W))))


def test_rect_coverage_matches_jax_and_fails_closed():
    K, R, t = rig(2)
    P = projections(K, R, t)
    s = 1.0 / hypotheses(False)
    A, e = jrs.rect_decompose(jnp.asarray(P[1]), jnp.asarray(P[0]))
    cases = {"covered": (np.asarray(A), np.asarray(e), 32, True),
             "margin too small": (np.asarray(A),
                                  np.asarray(e) * [6.0, 6.0, 1.0], 2,
                                  False),
             # 1 + e_z s crosses zero inside the sweep (s in 1/6..1/2)
             "denominator crosses zero": (np.asarray(A),
                                          np.array([0.1, 0.1, -3.0]), 32,
                                          False)}
    for name, (a, ev, margin, want) in cases.items():
        ev = ev.astype(np.float32)
        for offset in (0.0, 0.5):
            shift = jrs.rect_shift(jnp.asarray(ev), jnp.asarray(s), (H, W),
                                   offset)
            got = rs.rect_coverage_ok(t32(ev), t32(a), t32(s), (H, W),
                                      margin, (H, W), t32(np.asarray(shift)),
                                      offset)
            ref = jrs.rect_coverage_ok(jnp.asarray(ev), jnp.asarray(a),
                                       jnp.asarray(s), (H, W), margin,
                                       (H, W), shift, offset)
            assert bool(got) == bool(ref) == want, name


@pytest.mark.parametrize("norm", ["mvsnet", "vis"])
def test_canvas_resample_matches_jax(norm):
    K, R, t = rig(2)
    A, _ = rs.rect_decompose(*(t32(p) for p in projections(K, R, t)[::-1]))
    src = features(2, 1)[0]
    shift = np.array([3.0, -2.0], np.float32)
    port = rs.rect_resample if norm == "mvsnet" else rs.vis_rect_resample
    jax_fn = jrs.rect_resample if norm == "mvsnet" else jrs.vis_rect_resample
    for dtype, jdtype, rel in ((torch.float32, jnp.float32, 1e-5),
                               (torch.bfloat16, jnp.bfloat16, ROT)):
        got = port(t32(src).to(dtype), A[None], (H, W), 8, t32(shift)[None])
        want = jax_fn(jnp.asarray(src[0], jdtype), jnp.asarray(A.numpy()),
                      (H, W), 8, jnp.asarray(shift))
        assert got.dtype == dtype and got.shape == (1, H + 16, W + 16, C)
        close(got[0].float(), np.asarray(want, np.float32), rel)


# --- volumes ---------------------------------------------------------------

def jax_plan_fits(e, A, svals, hw, src_hw, offset=0.0):
    """The JAX kernel branch's own gate: the KY=2 window plan fits and the
    canvas covers the sweep (rect_sweep.py:268-276)."""
    M = jrs.rect_margin(hw)
    Hm, Wm = hw[0] + 2 * M, hw[1] + 2 * M
    shift = jrs.rect_shift(e, svals, hw, offset)
    P, Q = jrs.rect_planes(e, hw, M, shift, offset)
    plan = jms.sweep_spans_px(P, Q, svals, (Hm, Wm))
    KR = jms.tier_b_kr((Hm, Wm), C)
    cover = jrs.rect_coverage_ok(e, A, svals, hw, M, src_hw, shift, offset)
    return bool(jms._plan_fit(plan, 2, KR, 2, Hm + 2) & cover)


@functools.lru_cache(maxsize=None)
def jax_rect_volume(agg):
    return jax.jit(functools.partial(jrs.rect_cost_volume, ref_hw=(H, W),
                                     agg=agg, interpret=True))


@pytest.mark.parametrize("agg", ["variance", "softmin"])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_rect_cost_volume_matches_jax(agg, per_pixel):
    K, R, t = rig(2)
    P = projections(K, R, t)[None]
    feats = features(3, 2)
    depth = hypotheses(per_pixel)[None]
    temp = np.array([0.5], np.float32)
    A, e = jrs.rect_decompose(jnp.asarray(P[0, 1]), jnp.asarray(P[0, 0]))
    assert jax_plan_fits(e, A, jnp.asarray(1.0 / depth[0]), (H, W), (H, W))
    A_t, e_t = rs.rect_decompose(t32(P[:, 1:]), t32(P[:, :1]))
    s_t = 1.0 / t32(depth)[:, None]
    assert bool(rs.rect_coverage_ok(
        e_t, A_t, s_t, (H, W), rs.rect_margin((H, W)), (H, W),
        rs.rect_shift(e_t, s_t, (H, W))).all())
    want = jax_rect_volume(agg)(
        [jnp.asarray(f, jnp.bfloat16) for f in feats], jnp.asarray(P),
        jnp.asarray(depth), temp=jnp.asarray(temp))
    got = rs.rect_cost_volume([t32(f).to(torch.bfloat16) for f in feats],
                              t32(P), t32(depth), (H, W), agg, t32(temp))
    assert got.dtype == torch.bfloat16 and got.shape == (1, D, H, W, C)
    # softmin's value is a squared difference, which doubles the relative
    # size of the warped sample's bf16 rounding (the Pallas kernel rounds
    # each sample, the port's does not): 2^-6 of the scale there
    close(got.float(), np.asarray(want, np.float32),
          ROT if agg == "variance" else 2 * ROT, ROT / 4)


def test_rect_cost_volume_falls_back_to_the_exact_path():
    """A margin too small for the rig's disparity spread: the element takes
    the exact fused volume (the original projections), bitwise; in a batch
    of two, only the element whose coverage fails does."""
    K, R, t = rig(3, base=0.3)
    P = projections(K, R, t)
    feats = features(4, 3)
    depth = hypotheses(False)
    # batch element 0: the rig; element 1: the same rig with the sources'
    # baselines scaled down 20x, which a margin of 1 covers
    t_near = t.copy()
    t_near[1:] /= 20.0
    P2 = np.stack([P, projections(K, R, t_near)])
    f2 = [np.concatenate([f, f]) for f in feats]
    d2 = np.stack([depth, depth])
    args = ([t32(f).to(torch.bfloat16) for f in f2], t32(P2), t32(d2),
            (H, W))
    A, e = rs.rect_decompose(t32(P2[:, 1:]), t32(P2[:, :1]))
    s = 1.0 / t32(d2)[:, None]
    ok = rs.rect_coverage_ok(e, A, s, (H, W), 1, (H, W),
                             rs.rect_shift(e, s, (H, W))).all(1)
    assert ok.tolist() == [False, True]
    got = rs.rect_cost_volume(*args, margin=1)
    f16 = [a.to(torch.bfloat16) for a in args[0]]
    exact = rs.exact_fused_volume(
        f16[0], torch.stack(f16[1:], 1), [t32(P2[:, i]) for i in (1, 2)],
        t32(P2[:, 0]), t32(d2))
    torch.testing.assert_close(got[0], exact[0], rtol=0, atol=0)
    alone = rs.rect_cost_volume([f[1:] for f in args[0]], args[1][1:],
                                args[2][1:], (H, W), margin=1)
    torch.testing.assert_close(got[1], alone[0], rtol=0, atol=0)
    assert not torch.equal(alone[0], exact[1])


@functools.lru_cache(maxsize=None)
def jax_gwc(per_pixel):
    del per_pixel                        # one compile for each layout
    return jax.jit(functools.partial(jrs.rect_gwc_volume, ref_hw=(H, W),
                                     interpret=True), static_argnums=(8,))


@pytest.mark.parametrize("per_pixel", [False, True])
def test_rect_gwc_volume_matches_jax(per_pixel):
    K, R, t = rig(3, yaw=0.02, base=0.1)
    src, ref = features(5, 2, c=32)
    start = (hypotheses(True)[0][None, None] if per_pixel
             else np.full((1, 1, 1, 1), 2.5, np.float32))
    interval = np.full((1, 1, 1, 1), 0.25, np.float32)
    A, e = jrs.vis_rect_decompose(*(jnp.asarray(a[0]) for a in (K, R, t)),
                                  *(jnp.asarray(a[2]) for a in (K, R, t)))
    s = 1.0 / (jnp.asarray(start[0, 0]) + 0.25 * jnp.arange(D)[:, None, None]
               + 1e-9)
    assert jax_plan_fits(e, A, s if per_pixel else s[:, 0, 0], (H, W),
                         (H, W), offset=0.5)
    cams = [jnp.asarray(a[None, k]) for k in (0, 2) for a in (K, R, t)]
    want = jax_gwc(per_pixel)(
        jnp.asarray(src, jnp.bfloat16), jnp.asarray(ref, jnp.bfloat16),
        *cams, D, jnp.asarray(start), jnp.asarray(interval))
    got = rs.rect_gwc_volume([t32(src).to(torch.bfloat16)],
                             t32(ref).to(torch.bfloat16),
                             t32(K[None, ::2]), t32(R[None, ::2]),
                             t32(t[None, ::2]), D, t32(start),
                             t32(interval), (H, W))
    assert len(got) == 1 and got[0].shape == (1, D, H, W, 8)
    # the Pallas kernel rounds each warped sample to bf16 before the
    # group's products; with the output's own rounding a value near the
    # scale may differ by two bf16 steps: 2^-6 of the scale, and a mean
    # within 2^-9
    close(got[0].float(), np.asarray(want, np.float32), 2 * ROT, ROT / 4)
    # a 3x wider baseline under a margin of 1 px: coverage fails, and the
    # pair takes the exact sweep_gwc volume, bitwise
    K, R, t = (t32(a[None, ::2]) for a in rig(3, yaw=0.02, base=0.3))
    s_t = sk.vis_svals(D, t32(start), t32(interval), (H, W))
    A, e = rs.vis_rect_decompose(K[:, :1], R[:, :1], t[:, :1], K[:, 1:],
                                 R[:, 1:], t[:, 1:])
    shift = rs.rect_shift(e, s_t[:, None], (H, W), 0.5)
    assert not rs.rect_coverage_ok(e, A, s_t[:, None], (H, W), 1, (H, W),
                                   shift, 0.5).any()
    got = rs.rect_gwc_volume([t32(src)], t32(ref), K, R, t, D, t32(start),
                             t32(interval), (H, W), margin=1)[0]
    exact = rs.exact_gwc_volume(
        t32(src).to(torch.bfloat16), t32(ref).to(torch.bfloat16), K, R, t,
        1, s_t, (H, W))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, exact.float(), rtol=0, atol=0)


# --- the models ------------------------------------------------------------

@pytest.fixture
def jax_rect(monkeypatch):
    """The JAX models take rect on the CPU: the TPU-backend gate patched,
    every Pallas call of the rect arms in interpret mode."""
    monkeypatch.setattr(jms, "mosaic_px_supported", lambda *a, **k: True)
    for mod, name in ((jrs, "mosaic_sweep_warp_px"),
                      (jms, "mosaic_sweep_warp_px_gwc")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, functools.partial(
            lambda *a, _f=orig, **k: _f(*a, **{**k, "interpret": True})))


def assert_depth_agrees(got, want, interval):
    err = np.abs(np.asarray(got) - np.asarray(want)) / interval
    assert err.mean() < 0.1 and (err < 0.5).mean() > 0.95, (
        err.mean(), (err < 0.5).mean())


def count_calls(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(module, name, counting)
    return calls


def test_mvsnet_rect_forward_matches_jax(jax_rect, monkeypatch):
    params, stats = jax_variables("mvsnet")
    args = scene(seed=2)
    model = jax_build_model("mvsnet", num_depth=16, sweep_method="rect")
    want = jax.jit(lambda *a: model.apply(
        {"params": params, "batch_stats": stats}, *a, train=False))(*args)
    port = build_model("mvsnet", device="cpu", num_depth=16,
                       sweep_method="rect")
    port.load_state_dict(state_dict_from_jax(params, stats))
    calls = count_calls(monkeypatch, sk, "fused_cost_volume_plain")
    with torch.inference_mode():
        got = port.eval()(*(t32(a) for a in args))
    assert len(calls) == 1                     # one launch a forward
    assert_depth_agrees(got["depth"].numpy(), want["depth"], 5.0 / 15)


def test_vis_rect_forward_matches_jax(jax_rect, monkeypatch):
    # 96x128: stage 1 (12x16) is under 21 px and takes the exact path on
    # both sides, stages 2 (24x32) and 3 (48x64) the rectified sweep; one
    # source view (each JAX rect pair compiles two Pallas window tiers)
    kw = dict(depth_nums=(8, 4, 4), interval_scales=(4.0, 2.0, 1.0))
    args = scene(seed=3, n=2, h=96, w=128)
    model = jax_build_model("vis_mvsnet", sweep_method="rect", **kw)
    shapes = jax.eval_shape(
        lambda *a: model.init(jax.random.PRNGKey(0), *a, train=False), *args)
    v = fill_tree(shapes, seed=0)
    want = jax.jit(lambda *a: model.apply(v, *a, train=False))(*args)
    port = build_model("vis_mvsnet", device="cpu", sweep_method="rect", **kw)
    port.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]))
    rect_calls = count_calls(monkeypatch, rs, "vis_rect_resample")
    with torch.inference_mode():
        got = port.eval()(*(t32(a) for a in args))
    assert len(rect_calls) == 2                # stages 2-3, one pair each
    assert_depth_agrees(got["depth"].numpy(), want["depth"],
                        5.0 / 128 * kw["interval_scales"][2])


def test_cvp_rect_forward_matches_jax(jax_rect, monkeypatch):
    args = cvp_scene(seed=4, n=2)             # one source: see above
    model = jax_build_model("cvp_mvsnet", sweep_method="rect")
    shapes = jax.eval_shape(
        lambda *a: model.init(jax.random.PRNGKey(0), *a, train=False), *args)
    v = cvp_fill(shapes, seed=0)
    want = jax.jit(lambda *a: model.apply(v, *a, train=False,
                                          nscale=2))(*args)
    port = build_model("cvp_mvsnet", device="cpu", sweep_method="rect")
    port.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]))
    calls = count_calls(monkeypatch, rs, "rect_resample")
    with torch.inference_mode():
        got = port.eval()(*(t32(a) for a in args), nscale=2)
    assert len(calls) == 2                     # every level, one call each
    # the refinement interval: the finest level's hypothesis spacing
    hyp_interval = 5.0 / 96 / 2
    for g, w in zip(got["depth_est_list"], want["depth_est_list"]):
        assert_depth_agrees(g.numpy(), w, hyp_interval)


# --- the eval configuration ---------------------------------------------

def test_eval_model_kwargs_per_arch_sweep_defaults(capsys):
    # tests/test_pipeline.py::test_eval_model_kwargs_per_arch_sweep_defaults
    assert eval_model_kwargs("cvp_mvsnet")["kwargs"][
        "sweep_method"] == "rect"
    assert "rect" in capsys.readouterr().out          # the printed note
    assert "sweep_method" not in eval_model_kwargs("mvsnet")["kwargs"]
    assert "sweep_method" not in eval_model_kwargs("vis_mvsnet")["kwargs"]
    assert eval_model_kwargs("cvp_mvsnet", sweep_method="gather")[
        "kwargs"]["sweep_method"] == "gather"
    assert eval_model_kwargs("mvsnet", sweep_method="rect")["kwargs"][
        "sweep_method"] == "rect"
    eval_model_kwargs("vis_mvsnet", sweep_method="rect")
    assert "rect" in capsys.readouterr().out
    # every architecture and method against the JAX package's
    for arch in ("mvsnet", "mvsnet-s", "vis_mvsnet", "cvp_mvsnet"):
        for method in ("auto", "rect", "gather"):
            for bf16 in (True, False):
                got = eval_model_kwargs(arch, bf16=bf16, sweep_method=method)
                want = jax_eval_kwargs(arch, bf16=bf16, sweep_method=method)
                assert got["downscale"] == want["downscale"]
                assert set(got["kwargs"]) == set(want["kwargs"])
                for k, v in want["kwargs"].items():
                    if k == "dtype":
                        assert got["kwargs"][k] == torch.bfloat16
                    else:
                        assert got["kwargs"][k] == v, (arch, method, k)
