"""The port's CVP-MVSNet (weights carried from JAX) vs the JAX CVP-MVSNet, on
the CPU.

The JAX parameter tree comes from the JAX model itself (`jax.eval_shape` of
its init), filled with seeded numpy values; `state_dict_from_jax` carries
it into the port. Inputs are numpy arrays from a seed. Both sides run f32;
on the CPU the JAX package takes its exact gather (`mosaic_px_supported` is
False there) and so does the port's "gather"; the port's kernel backends
run their plain versions. One jitted JAX forward serves each
configuration.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wildmvs.models import build_model as jax_build_model
from wildmvs.models.cvp_mvsnet import _bicubic_double, _bilinear_half
from wildmvs.models.cvp_mvsnet import cal_depth_hypo as jax_cal_depth_hypo
from wildmvs.ops.select import masked_median as jax_masked_median
from wildmvs.train import trainer as JT
from wildmvs.train.config import TrainConfig as JaxConfig
from wildmvs.train.torch_import import convert_state_dict
from wildmvs_torch.data.synthetic import SyntheticMVSDataset, collate
from wildmvs_torch.infer import Predictor
from wildmvs_torch.models import build_model
from wildmvs_torch.models.cvp_mvsnet import cal_depth_hypo
from wildmvs_torch.ops.resize import bicubic_double, bilinear_half
from wildmvs_torch.ops.select import masked_median
from wildmvs_torch.pipeline.depthmaps import eval_model_kwargs, run_depthmaps
from wildmvs_torch.train import cli
from wildmvs_torch.train import trainer as T
from wildmvs_torch.train.config import TrainConfig
from wildmvs_torch.train.jax_import import load_weights, state_dict_from_jax
from chip_smoke import record_levels
from tests.test_torch_import import reference_cvp_state_dict
from tests.test_torch_mvsnet import scene
from tests.test_torch_train import (MOMENTUM, bn_modules, jax_tree_to_port,
                                    synthetic_batch)

torch.set_num_threads(1)

B, N, H, W = 1, 3, 64, 96
# the last conv's weights are scaled up so the random network's depth
# probabilities are peaked rather than flat
PROB_GAIN = 10.0


def cvp_scene(seed=0, b=B, n=N, h=H, w=W):
    """tests/test_torch_mvsnet.py's rig with a 4x wider baseline (1.6
    between views at depths 5..10). With the narrow one, the one-pixel
    epipolar step at these small sizes is ~2 depth units, so the +-4
    hypotheses of cal_depth_hypo reach behind the cameras, where sampling
    is discontinuous: there the JAX package alone, jitted or not, moves
    the finest depth by 0.02."""
    imgs, K, R, t, dmin, dmax = scene(seed, b=b, n=n, h=h, w=w)
    t = t.copy()
    t[:, :, 0, 0] *= 4.0
    return imgs, K, R, t, dmin, dmax


def fill(shapes, seed):
    """Seeded values for a JAX variables tree of ShapeDtypeStructs:
    He-normal kernels (prob0's times PROB_GAIN), BatchNorm near
    identity."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        names = [getattr(k, "key", str(k)) for k in path]
        if names[-1] == "kernel":
            v = rng.standard_normal(x.shape) * np.sqrt(
                2.0 / int(np.prod(x.shape[:-1])))
            if "prob0" in names:
                v *= PROB_GAIN
        elif names[-1] == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(x.shape)
        elif names[-1] in ("bias", "mean"):
            v = 0.1 * rng.standard_normal(x.shape)
        else:                                            # var
            v = rng.uniform(0.5, 1.5, x.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def jax_cvp():
    """The JAX model, its seeded variables and one jitted f32 eval forward
    per pyramid depth (compiled on first use)."""
    model = jax_build_model("cvp_mvsnet")
    shapes = jax.eval_shape(
        lambda *a: model.init(jax.random.PRNGKey(0), *a, train=False),
        *cvp_scene())
    v = fill(shapes, seed=0)
    fwds = {}

    def forward(nscale, *args):
        if nscale not in fwds:
            fwds[nscale] = jax.jit(lambda v, *a: model.apply(
                v, *a, train=False, nscale=nscale))
        return fwds[nscale](v, *args)
    return v["params"], v["batch_stats"], forward


@pytest.fixture(scope="module")
def jax_outputs(jax_cvp):
    """The JAX eval outputs on the module's scene, by nscale."""
    args = cvp_scene(seed=1)
    return args, {ns: jax_cvp[2](ns, *args) for ns in (2, 3)}


def port_model(params, stats, **kw):
    model = build_model("cvp_mvsnet", device="cpu", **kw)
    model.load_state_dict(state_dict_from_jax(params, stats))   # strict
    return model.eval()


def run_port(model, args, **kw):
    with torch.inference_mode():
        return model(*[[torch.from_numpy(np.ascontiguousarray(v)) for v in a]
                       if isinstance(a, (list, tuple)) else
                       torch.from_numpy(a) for a in args], **kw)


def assert_depths_close(got, want, atol):
    """f32 convolutions and gathers in other orders (~1e-6 relative per op)
    move the coarse depth by ~1e-5; the median of cal_depth_hypo may then
    take a neighbouring element, which moves the finer levels' hypotheses
    and depths by a few 1e-4 (the JAX package jitted against not jitted
    differs by up to 3.7e-4 on this rig): 98 % of pixels within `atol`,
    every pixel within 20 `atol`."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= atol).mean() >= 0.98, err.max()
    assert err.max() < 20 * atol, err.max()


# --- the median ---------------------------------------------------------

def _median_case(name, rng):
    x = rng.standard_normal(301).astype(np.float32)
    valid = rng.random(301) < 0.7
    if name == "nans":
        x[rng.random(301) < 0.2] = np.nan
    elif name == "negatives":
        x = -np.abs(x)
    elif name == "ties":
        x = np.round(x * 2) / 2
        x[:40] = 0.0
        x[40:60] = -0.0
    elif name == "infinities":
        x[:30] = np.inf
        x[30:50] = -np.inf
    elif name == "even count":
        valid[:] = False
        valid[:100] = True
    elif name == "odd count":
        valid[:] = False
        valid[:101] = True
    elif name == "one valid":
        valid[:] = False
        valid[7] = True
    return x.reshape(7, 43), valid.reshape(7, 43)


@pytest.mark.parametrize("case", ["nans", "negatives", "ties", "infinities",
                                  "even count", "odd count", "one valid"])
def test_masked_median_equals_jax_bitwise(case):
    x, valid = _median_case(case, np.random.default_rng(len(case)))
    want = np.asarray(jax_masked_median(jnp.asarray(x), jnp.asarray(valid)))
    got = masked_median(torch.from_numpy(x), torch.from_numpy(valid))
    assert got.numpy().view(np.uint32) == want.view(np.uint32), (got, want)
    # the batched form: the dims from start_dim on are reduced
    xb = np.stack([x, x[::-1]])
    vb = np.stack([valid, valid[::-1]])
    gb = masked_median(torch.from_numpy(xb), torch.from_numpy(vb), 1)
    assert gb.numpy().view(np.uint32).tolist() == [want.view(np.uint32)] * 2


# --- the two resizes ----------------------------------------------------

@pytest.mark.parametrize("hw", [(6, 7), (5, 9), (16, 20), (33, 17)])
def test_resizes_match_jax(hw):
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    x = rng.standard_normal((2,) + hw).astype(np.float32)
    want = np.asarray(_bicubic_double(jnp.asarray(x)))
    got = bicubic_double(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    img = rng.random((2,) + hw + (3,)).astype(np.float32)
    want = np.asarray(_bilinear_half(jnp.asarray(img)))
    got = bilinear_half(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, hw[0] // 2, hw[1] // 2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # torch's own bicubic (a = -0.75, clamped edges) is another kernel
    if hw == (6, 7):
        theirs = torch.nn.functional.interpolate(
            torch.from_numpy(x)[:, None], scale_factor=2, mode="bicubic",
            align_corners=False)[:, 0].numpy()
        assert np.abs(theirs - np.asarray(_bicubic_double(jnp.asarray(x)))
                      ).max() > 0.01


# --- cal_depth_hypo -----------------------------------------------------

@pytest.mark.parametrize("rig", ["random", "degenerate"])
def test_cal_depth_hypo_matches_jax(rig):
    imgs, K, R, t, dmin, dmax = scene(seed=4, b=2, n=2, h=24, w=32)
    rng = np.random.default_rng(5)
    depth = rng.uniform(5.0, 10.0, (2, 24, 32)).astype(np.float32)
    if rig == "degenerate":
        # the source camera looks the other way: every point lies behind
        # it, no pixel is valid, and the interval is (max-min)/128
        R[:, 1] = np.diag([-1.0, 1.0, -1.0]).astype(np.float32) @ R[:, 0]
    args = (depth, K[:, 0], K[:, 1], R[:, 0], t[:, 0], R[:, 1], t[:, 1],
            dmin[:, 0], dmax[:, 0])
    want = np.asarray(jax_cal_depth_hypo(*(jnp.asarray(a) for a in args)))
    got = cal_depth_hypo(*(torch.from_numpy(a) for a in args)).numpy()
    assert got.shape == want.shape == (2, 8, 24, 32)
    step, want_step = got[:, 1] - got[:, 0], want[:, 1] - want[:, 0]
    if rig == "degenerate":
        np.testing.assert_allclose(step, 5.0 / 128, rtol=1e-5)
    else:
        assert (step > 1e-3).all() and (np.abs(step - 5.0 / 128) > 1e-4).all()
    # the per-pixel steps, computed in f32 in other orders (Cramer's rule
    # cancels), differ by a few f32 ulps; so does their median
    np.testing.assert_allclose(step, want_step, rtol=2e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# --- weights ------------------------------------------------------------

@pytest.mark.parametrize("prefix", ["", "module.", "module.model."])
def test_reference_checkpoint_loads_strictly(tmp_path, prefix):
    ref = reference_cvp_state_dict(prefix="")
    keys = {k.removeprefix("model."): v for k, v in ref.items()}
    model = build_model("cvp_mvsnet", device="cpu")
    assert sorted(model.state_dict()) == sorted(keys)
    ckpt = tmp_path / "model_000002.ckpt"
    torch.save({"model": {prefix + k: torch.from_numpy(np.asarray(v))
                          for k, v in keys.items()},
                "architecture": "cvp_mvsnet"}, ckpt)
    sd, arch = load_weights(ckpt)
    assert arch == "cvp_mvsnet"
    model.load_state_dict(sd)                                    # strict
    np.testing.assert_array_equal(
        model.featurePyramid.conv0aa[0].weight.detach().numpy(),
        keys["featurePyramid.conv0aa.0.weight"])
    np.testing.assert_array_equal(
        model.cost_reg_refine.conv6[0].weight.detach().numpy(),
        keys["cost_reg_refine.conv6.0.weight"])


def test_state_dict_from_jax_round_trips(jax_cvp):
    params, stats, _ = jax_cvp
    sd = state_dict_from_jax(params, stats)
    model = build_model("cvp_mvsnet", device="cpu")
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict(sd)
    # back through the JAX package's own torch importer: exact
    back_p, back_s = convert_state_dict(
        {k: v.detach().numpy() for k, v in model.state_dict().items()},
        params, stats)
    for want, got in ((params, back_p), (stats, back_s)):
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]), leaf,
                                          err_msg=str(path))


# --- the eval forward ---------------------------------------------------

@pytest.mark.parametrize("nscale", [2, 3])
def test_eval_forward_matches_jax(jax_cvp, jax_outputs, nscale):
    params, stats, _ = jax_cvp
    args, outs = jax_outputs
    want = outs[nscale]
    got = run_port(port_model(params, stats, sweep_method="gather"), args,
                   nscale=nscale)
    assert len(got["depth_est_list"]) == nscale
    # every level, finest first; the coarse level's tolerance is a
    # thousandth of its 5/96 hypothesis interval
    for i, (g, w) in enumerate(zip(got["depth_est_list"],
                                   want["depth_est_list"])):
        assert g.shape == (B, H >> i, W >> i)
        assert_depths_close(g.numpy(), w, atol=5e-5 if i == nscale - 1
                            else 5e-4)
    np.testing.assert_array_equal(got["depth"].numpy(),
                                  got["depth_est_list"][0].numpy())
    np.testing.assert_allclose(got["photometric_confidence"].numpy(),
                               np.asarray(want["photometric_confidence"]),
                               atol=2e-3)
    assert got["depth_pair_list"] == []
    # the network is not flat: the depth spreads over the range
    assert got["depth"].std() > 0.1


def test_ragged_views_match_jax(jax_cvp):
    """Views of different sizes: one image pyramid per view, each with its
    own intrinsics ratio, swept by the exact gather in both packages; the
    port's warp kernel (plain version) takes the views "fused" chose."""
    params, stats, forward = jax_cvp
    imgs, K, R, t, dmin, dmax = cvp_scene(seed=3)
    views = (imgs[:, 0], imgs[:, 1, :, :64], imgs[:, 2, :32])
    want = forward(2, views, K, R, t, dmin, dmax)
    args = (list(views), K, R, t, dmin, dmax)
    got = run_port(port_model(params, stats, sweep_method="gather"), args,
                   nscale=2)
    for g, w in zip(got["depth_est_list"], want["depth_est_list"]):
        assert_depths_close(g.numpy(), w, atol=5e-4)
    fused = run_port(port_model(params, stats, sweep_method="fused"), args,
                     nscale=2)
    err = np.abs(fused["depth"].numpy() - got["depth"].numpy())
    assert np.median(err) < 5e-3, err


@pytest.mark.parametrize("method", ["warp", "fused"])
def test_kernel_backends_match_the_gather(jax_cvp, method):
    """The kernel backends (their plain versions on the CPU; they take bf16
    features and round their result to bf16) against the exact gather on
    each level's own inputs (features, projections, hypotheses): the cost
    volume, and the finest depth regressed from each."""
    params, stats, _ = jax_cvp
    args = cvp_scene(seed=2)
    model = port_model(params, stats, sweep_method=method)
    levels, undo = record_levels(model)
    try:
        out = run_port(model, args, nscale=3)
    finally:
        undo()
    assert len(levels) == 3
    with torch.inference_mode():
        for lv in levels:
            hyp = lv["hyp"]
            cv_g = model.cost_volume(lv["flevel"], lv["proj"], hyp,
                                     "gather").float()
            scale = cv_g.abs().max().item()
            err = (lv["cv"].float() - cv_g).abs()
            # bf16 rounding of the features and the result, as MVSNet's
            assert err.max().item() < 0.03 * scale, (err.max(), scale)
            assert err.mean().item() < 2e-3 * scale
        _, depth_g = model.regress(cv_g, hyp)
    interval = (hyp[:, 1] - hyp[:, 0])[:, None]
    derr = (out["depth"] - depth_g).abs() / interval
    assert derr.mean() < 0.1 and (derr < 0.5).float().mean() > 0.95


# --- training -----------------------------------------------------------

def _bn_calls(model):
    """Hooks that record, per BatchNorm call in train mode, the input's
    elements per channel and biased per-channel variance."""
    calls = {}

    def hook(name):
        def fn(mod, inp):
            x = inp[0].detach().float()
            dims = [0] + list(range(2, x.dim()))
            calls.setdefault(name, []).append(
                (x.numel() // x.shape[1], x.var(dims, unbiased=False)))
        return fn
    hooks = [m.register_forward_pre_hook(hook(n))
             for n, m in bn_modules(model).items()]
    return calls, hooks


def _jax_step(params, stats, jcfg, jbatch):
    jmodel = JT.create_model(jcfg)

    def loss_fn(p):
        out, mut = jmodel.apply({"params": p, "batch_stats": stats},
                                *JT.forward_args(jbatch, jcfg),
                                reference_frame=0, train=True,
                                mutable=["batch_stats"])
        return JT.loss_from_outputs(out, jbatch, jcfg, 0), mut
    (loss, mut), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    tx = JT.make_optimizer(jcfg)
    st = JT.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params), tx=tx)
    st1 = jax.jit(lambda st, g, bs: st.apply_gradients(
        grads=g, batch_stats=bs))(st, grads, mut["batch_stats"])
    return float(loss), grads, st1


def test_train_step_matches_jax(jax_cvp):
    """One supervised f32 train step (nscale 2: a 48-hypothesis coarse
    sweep, one +-4 refinement) against the JAX trainer from the same
    variables and batch: the loss, every gradient, the BatchNorm running
    statistics (one update a level) and the parameters after Adam."""
    params, stats, _ = jax_cvp
    kw = dict(architecture="cvp_mvsnet", dataset="synthetic", lr=1e-3,
              weight_decay=1e-4)
    jcfg, cfg = JaxConfig(**kw), TrainConfig(**kw)
    nb = synthetic_batch(seed=2)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items() if k != "filename"}
    batch = T.batch_to_device(nb, "cpu")
    j_loss, j_grads, jstate1 = _jax_step(params, stats, jcfg, jbatch)

    model = build_model("cvp_mvsnet", device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats))
    state = T.create_train_state(cfg, model=model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    calls, hooks = _bn_calls(model)
    state, m = T.train_step(state, batch, cfg)
    for hk in hooks:
        hk.remove()
    loss = m["train_loss"].item()
    assert np.isfinite(loss) and loss > 0.5
    np.testing.assert_allclose(loss, j_loss, rtol=2e-4)

    want_g = jax_tree_to_port(j_grads, {})
    got_g = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got_g) == sorted(want_g)
    gmax = max(np.abs(w).max() for w in want_g.values())
    rel = {n: np.linalg.norm(g.numpy() - want_g[n])
           / max(np.linalg.norm(want_g[n]), 1e-4 * gmax)
           for n, g in got_g.items()}
    # relative L2, as tests/test_torch_train.py: f32 rounding grows through
    # the backward, and a ReLU pre-activation within rounding of zero may
    # fall on either side in the two packages
    worst = max(rel, key=rel.get)
    assert rel[worst] < 0.05, (worst, rel[worst])
    assert np.median(list(rel.values())) < 0.01, rel
    assert np.abs(want_g["featurePyramid.conv0aa.0.weight"]).max() \
        > 1e-3 * gmax

    want_s = jax_tree_to_port(jstate1.params, jstate1.batch_stats)
    got_s = model.state_dict()
    for name in bn_modules(model):
        seen = calls[name]
        assert len(seen) == 2                 # once a level, coarse first
        np.testing.assert_allclose(got_s[f"{name}.running_mean"].numpy(),
                                   want_s[f"{name}.running_mean"],
                                   rtol=1e-4, atol=1e-5)
        # torch adds the unbiased batch variance, flax the biased one:
        # take the difference of each level's update back out
        rv = got_s[f"{name}.running_var"].clone()
        for k, (n, var) in enumerate(seen):
            weight = (1 - MOMENTUM) * MOMENTUM ** (len(seen) - 1 - k)
            rv -= weight * var * (n / (n - 1) - 1)
        np.testing.assert_allclose(rv.numpy(), want_s[f"{name}.running_var"],
                                   rtol=1e-4, atol=1e-6)
        assert got_s[f"{name}.num_batches_tracked"].item() == 2
    for name, p in model.named_parameters():
        want_p, g = want_s[name], want_g[name]
        diff = np.abs(p.detach().numpy() - want_p)
        firm = np.abs(g) > 0.1 * np.abs(g).max()
        assert diff[firm].max(initial=0.0) <= 1e-5, name
        assert diff.max() <= 2e-3 + 1e-5, name
        assert not torch.equal(p.detach(), before[name]), name


def test_remat_levels_and_packed_training_change_nothing(jax_cvp):
    """remat_levels recomputes each level in the backward and
    packed_training is accepted: the loss, the gradients and the running
    statistics of one step equal the plain step's."""
    params, stats, _ = jax_cvp
    batch = T.batch_to_device(synthetic_batch(seed=2), "cpu")
    results = {}
    for flags in ({}, {"remat_levels": True}, {"packed_training": True}):
        cfg = TrainConfig(architecture="cvp_mvsnet", dataset="synthetic",
                          **flags)
        model = T.create_model(cfg, "cpu")
        assert all(getattr(model, k) == v for k, v in flags.items())
        model.load_state_dict(state_dict_from_jax(params, stats))
        state = T.create_train_state(cfg, model=model)
        state, m = T.train_step(state, batch, cfg)
        results[tuple(flags)] = (
            m["train_loss"].item(),
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k or "num_batches" in k})
    (loss0, g0, s0) = results[()]
    for key in (("remat_levels",), ("packed_training",)):
        loss, g, s = results[key]
        assert loss == pytest.approx(loss0, rel=1e-6), key
        for n in g0:
            torch.testing.assert_close(g[n], g0[n], rtol=1e-5, atol=1e-7)
        for k in s0:
            torch.testing.assert_close(s[k], s0[k], rtol=1e-6, atol=0)


def test_train_mode_and_unported_options():
    args = [torch.from_numpy(a) for a in cvp_scene(h=32, w=32)]
    fused = build_model("cvp_mvsnet", device="cpu", sweep_method="fused")
    with pytest.raises(ValueError, match="eval only"):
        fused.train()(*args)
    model = build_model("cvp_mvsnet", device="cpu")
    for training, want in ((False, "fused"), (True, "warp")):
        model.train(training)
        assert model.resolve_sweep(torch.bfloat16, torch.device("cuda"),
                                   False) == want
        assert model.resolve_sweep(torch.bfloat16, torch.device("cpu"),
                                   False) == "gather"
        assert model.resolve_sweep(torch.float32, torch.device("cuda"),
                                   False) == "gather"
    assert fused.eval().resolve_sweep(torch.bfloat16, torch.device("cpu"),
                                      True) == "warp"
    # the hypothesis count follows the mode: 48 in training, 96 at eval
    seen = []
    hook = model.cost_reg_refine.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].shape[1]))
    model.train()(*args)
    with torch.no_grad():
        model.eval()(*args)
    hook.remove()
    assert seen == [48, 8, 96, 8]
    # "rect" is ported (tests/test_torch_rect.py holds it to JAX): it
    # serves at eval, and resolves as "auto" in train mode or when ragged
    rect = build_model("cvp_mvsnet", device="cpu", sweep_method="rect")
    with torch.no_grad():
        assert torch.isfinite(rect.eval()(*args)["depth"]).all()
    assert rect.resolve_sweep(torch.bfloat16, torch.device("cuda"),
                              True) == "warp"
    assert rect.train().resolve_sweep(torch.float32, torch.device("cpu"),
                                      False) == "gather"
    # hyp_axis is ported (tests/test_torch_dist.py shards it over two
    # ranks): outside a mesh the model runs unsharded, bit for bit
    sharded = build_model("cvp_mvsnet", device="cpu", hyp_axis="hyp")
    with torch.no_grad():
        torch.testing.assert_close(
            sharded.eval()(*args)["depth"],
            build_model("cvp_mvsnet", device="cpu").eval()(*args)["depth"],
            rtol=0, atol=0)
    # remat recomputes the forward in the backward: the same step, loss,
    # gradients and BatchNorm buffers (the recomputation leaves the
    # running statistics alone)
    cfg = TrainConfig(architecture="cvp_mvsnet", dataset="synthetic")
    batch = T.batch_to_device(collate([SyntheticMVSDataset(
        num_samples=1, num_views=3, height=32, width=32)[0]]), "cpu")
    steps = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        state, m = T.train_step(T.create_train_state(c, "cpu"), batch, c)
        steps.append((m["train_loss"], state.model))
    (l0, m0), (l1, m1) = steps
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    for (n, p0), p1 in zip(m0.named_parameters(), m1.parameters()):
        torch.testing.assert_close(p1.grad, p0.grad, rtol=1e-6, atol=1e-9,
                                   msg=n)
    for (n, b0), b1 in zip(m0.named_buffers(), m1.buffers()):
        torch.testing.assert_close(b1, b0, rtol=1e-6, atol=0, msg=n)


# --- serving and the pipeline ------------------------------------------

def test_predictor_and_run_depthmaps_serve_cvp(tmp_path, jax_cvp,
                                               jax_outputs):
    params, stats, _ = jax_cvp
    args, outs = jax_outputs
    want = np.asarray(outs[2]["depth"])[0]
    ckpt = tmp_path / "model_000000.ckpt"
    torch.save({"model": state_dict_from_jax(params, stats),
                "architecture": "cvp_mvsnet"}, ckpt)
    pred = Predictor(ckpt, bf16=False, sweep_method="gather", cvp_nscale=2,
                     device="cpu")
    assert pred.architecture == "cvp_mvsnet" and pred.downscale == 1
    imgs, K, R, t, dmin, dmax = (a[0] for a in args)
    out = pred(imgs, K, R, t, dmin, dmax)
    assert out["depth"].shape == out["confidence"].shape == (H, W)
    assert_depths_close(out["depth"], want, atol=5e-4)
    # the default is 4 levels
    assert Predictor(ckpt, bf16=False, sweep_method="gather",
                     device="cpu").forward_kwargs == {"nscale": 4}
    samples = [dict(imgs=imgs, K=K, R=R, t=t, depth_min=dmin,
                    depth_max=dmax, filename=f"scan3/{i:08d}")
               for i in range(2)]
    run_depthmaps(samples, pred.model, tmp_path / "out", cvp_nscale=2)
    files = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert files == ["finished.txt", "scan3_00000000_out.npz",
                     "scan3_00000001_out.npz"]
    with np.load(tmp_path / "out" / files[1]) as z:
        assert_depths_close(z["depthmap"], want, atol=5e-4)
        assert z["probability"].shape == (H, W)


def test_eval_model_kwargs_cvp():
    # the eval default "auto" is the rectified sweep, as in the JAX package
    assert eval_model_kwargs("cvp_mvsnet") == {
        "kwargs": {"sweep_method": "rect", "dtype": torch.bfloat16},
        "downscale": 1}
    for method in ("fused", "gather"):
        cfg = eval_model_kwargs("cvp_mvsnet", sweep_method=method)
        assert cfg == {"kwargs": {"sweep_method": method,
                                  "dtype": torch.bfloat16}, "downscale": 1}
    pred = Predictor(architecture="cvp_mvsnet", device="cpu")
    assert pred.model.sweep_method == "rect"
    assert pred.forward_kwargs == {"nscale": 4}


def test_cli_trains_cvp(tmp_path):
    hist = cli.main(["--architecture", "cvp_mvsnet", "--device", "cpu",
                     "--debug", "--remat_levels", "--logdir",
                     str(tmp_path)])
    assert np.isfinite(hist["train_loss"]).all()
    assert np.isfinite(hist["val_loss"]).all()
    assert (tmp_path / "model_000000.ckpt").exists()
    pred = Predictor(tmp_path / "model_000000.ckpt", sweep_method="gather",
                     cvp_nscale=2, device="cpu")
    imgs, K, R, t, dmin, dmax = (a[0] for a in cvp_scene())
    assert np.isfinite(pred(imgs, K, R, t, dmin, dmax)["depth"]).all()
