"""The port's Vis-MVSNet (weights carried from JAX) vs the JAX Vis-MVSNet, on
the CPU.

The JAX parameter tree comes from the JAX model itself (`jax.eval_shape` of
its init), filled with seeded numpy values, or from the trained asset
assets/vis_synth_trained.npz, or from the reference-keyed state dict of
tests/test_torch_import.py; the port takes it through `state_dict_from_jax`
or loads the reference keys as they are. Inputs are numpy arrays from a
seed. Both sides run f32 through the exact gather (the JAX package's CPU
path); the port's kernel paths (their plain versions on the CPU) are held
to the port's gather.
"""
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from wildmvs.models import build_model as jax_build_model
from wildmvs.models.vis_mvsnet import SingleStage as JaxSingleStage
from wildmvs.pipeline.depthmaps import get_mask_invalid as jax_mask_invalid
from wildmvs.train.checkpoint import load_params_npz as jax_load_npz
from wildmvs.train.torch_import import convert_state_dict
from wildmvs_torch.infer import Predictor
from wildmvs_torch.models import build_model
from wildmvs_torch.models.vis_mvsnet import SingleStage
from wildmvs_torch.pipeline.depthmaps import (get_mask_invalid,
                                              run_depthmaps)
from wildmvs_torch.train.jax_import import load_weights, state_dict_from_jax
from tests.test_torch_import import reference_vis_state_dict
from tests.test_torch_mvsnet import scene

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ASSET = REPO / "assets" / "vis_synth_trained.npz"
B, N, H, W = 1, 3, 64, 96
# the eval configuration (pipeline/depthmaps.eval_model_kwargs)
EVAL_KW = dict(depth_nums=(64, 32, 16), interval_scales=(2.0, 1.0, 0.5))


def vis_scene(seed=0, n=N, h=H, w=W):
    """tests/test_torch_mvsnet.py's rig (depth range 5..10) at Vis sizes."""
    return scene(seed, b=B, n=n, h=h, w=w)


def fill_tree(shapes, seed):
    """Seeded values for a JAX variables tree of ShapeDtypeStructs:
    He-normal kernels, BatchNorm near identity."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = leaf.shape
        if name == "kernel":
            v = rng.standard_normal(shape) * np.sqrt(
                2.0 / int(np.prod(shape[:-1])))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("bias", "mean"):
            v = 0.1 * rng.standard_normal(shape)
        else:                                            # var
            v = rng.uniform(0.5, 1.5, shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def jax_eval():
    """The JAX eval-configuration model and its jitted f32 forward (one
    compile, shared by every weight set)."""
    model = jax_build_model("vis_mvsnet", **EVAL_KW)
    shapes = jax.eval_shape(
        lambda *a: model.init(jax.random.PRNGKey(0), *a, train=False),
        *vis_scene())
    fwd = jax.jit(lambda v, *a: model.apply(v, *a, train=False))
    return model, shapes, fwd


@pytest.fixture(scope="module")
def random_variables(jax_eval):
    v = fill_tree(jax_eval[1], seed=0)
    return v["params"], v["batch_stats"]


def port_model(params, stats, **kw):
    model = build_model("vis_mvsnet", device="cpu", **{**EVAL_KW, **kw})
    model.load_state_dict(state_dict_from_jax(params, stats))   # strict
    return model.eval()


def run_port(model, args):
    with torch.inference_mode():
        return model(*[[torch.from_numpy(np.ascontiguousarray(v))
                        for v in a] if isinstance(a, (list, tuple))
                       else torch.from_numpy(a) for a in args])


def assert_depth_close(got, want, atol=2e-3, worst=5.0 / 128 * 0.5 / 2):
    """f32 convolutions and gathers in other orders (~1e-6 relative per op)
    move depths in 5..10 by a few 1e-4 through the cascade; where a stage's
    depth probabilities are near a tie the regression moves further: 98 %
    of pixels within `atol`, every pixel within half the finest hypothesis
    interval (5/128 * 0.5)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= atol).mean() >= 0.98 and err.max() < worst, err.max()


def assert_outputs_match(got, want):
    """Depth, the three stage depths, the 3-stage confidence and every
    pair's depth and uncertainty of two Vis outputs (port, JAX)."""
    for g, w in zip(got["depth_est_list"], want["depth_est_list"]):
        assert_depth_close(g.numpy(), w)
    np.testing.assert_array_equal(got["depth"].numpy(),
                                  got["depth_est_list"][0].numpy())
    conf_j = np.asarray(want["photometric_confidence"])
    assert got["photometric_confidence"].shape == conf_j.shape
    # the confidence sums the probabilities within +-2 of the expected
    # index: where that index sits on a window edge a bin may fall on the
    # other side, so 99 % of pixels within 5e-3 (as tests/test_torch_mvsnet
    # holds MVSNet's 4-tap confidence)
    err = np.abs(got["photometric_confidence"].numpy() - conf_j)
    assert (err <= 5e-3).mean() >= 0.99
    for stage_g, stage_w in zip(got["depth_pair_list"],
                                want["depth_pair_list"]):
        assert len(stage_g) == len(stage_w) == N - 1
        for (dg, (ug,)), (dw, (uw,)) in zip(stage_g, stage_w):
            assert_depth_close(dg.numpy(), dw)
            # the same rounding through the pair's entropy and UncertNet:
            # 98 % within 1e-3 of the scale, every value within 1e-2
            uw = np.asarray(uw)
            scale = max(1.0, np.abs(uw).max())
            err = np.abs(ug.numpy() - uw)
            assert (err <= 1e-3 * scale).mean() >= 0.98
            assert err.max() < 1e-2 * scale, err.max()


def test_port_keys_are_the_reference_keys():
    """The reference's Vis keys (the JAX package's model of them) load into
    the port as they are, once the DDP "module." and Frontend "model."
    prefixes are stripped, as load_weights strips them."""
    ref = reference_vis_state_dict()
    model = build_model("vis_mvsnet", device="cpu")
    stripped = {k.removeprefix("module.").removeprefix("model."): v
                for k, v in ref.items()}
    assert sorted(model.state_dict()) == sorted(stripped)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in stripped.items()})        # strict
    np.testing.assert_array_equal(
        model.stage2.reg.unet.dec_blocks["reg116_2"][0].weight.detach().numpy(),
        ref["module.model.stage2.reg.unet.dec_blocks.reg116_2.0.weight"])


def test_state_dict_from_jax_round_trips(random_variables):
    """JAX tree -> port keys -> the JAX package's own torch importer:
    every leaf back exactly (deconv, BasicBlock, UNet and bare-conv
    layouts)."""
    params, stats = random_variables
    sd = state_dict_from_jax(params, stats)
    model = build_model("vis_mvsnet", device="cpu")
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict(sd)
    back_p, back_s = convert_state_dict(
        {k: v.detach().numpy() for k, v in model.state_dict().items()},
        params, stats)
    for want, got in ((params, back_p), (stats, back_s)):
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g) > 100
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]), leaf,
                                          err_msg=str(path))


def test_eval_forward_matches_jax(jax_eval, random_variables):
    """The whole eval forward, f32, seeded weights: depth, the stage depths
    (stages 2-3 on per-pixel slabs), the 3-stage confidence, and every
    pair's depth and uncertainty."""
    params, stats = random_variables
    args = vis_scene(seed=1)
    want = jax_eval[2]({"params": params, "batch_stats": stats}, *args)
    got = run_port(port_model(params, stats), args)
    assert got["depth"].shape == (B, H // 2, W // 2)
    assert got["photometric_confidence"].shape == (B, 3, H // 2, W // 2)
    # the network must have an opinion, or the comparison is vacuous
    assert np.asarray(want["depth"]).std() > 0.05
    assert_outputs_match(got, want)


def test_asset_weights_load_strictly_and_match_jax(jax_eval):
    """assets/vis_synth_trained.npz, read by numpy alone, loads strictly
    and computes what JAX computes with the same file."""
    params, stats, meta = jax_load_npz(ASSET)
    assert meta["architecture"] == "vis_mvsnet"
    sd, arch = load_weights(ASSET)
    assert arch == "vis_mvsnet"
    model = build_model("vis_mvsnet", device="cpu", **EVAL_KW)
    model.load_state_dict(sd)                                   # strict
    args = vis_scene(seed=2)
    want = jax_eval[2]({"params": params, "batch_stats": stats}, *args)
    assert_outputs_match(run_port(model.eval(), args), want)


def test_reference_state_dict_loads_and_matches_jax(jax_eval, tmp_path):
    """A reference-keyed checkpoint (module.model.* keys) served by the
    port's Predictor computes what JAX computes after convert_state_dict
    of the same dict."""
    sd = reference_vis_state_dict(seed=3)
    shapes = jax_eval[1]
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    params, stats = convert_state_dict(sd, template["params"],
                                       template["batch_stats"])
    ckpt = tmp_path / "model_000000.ckpt"
    torch.save({"model": {k: torch.from_numpy(np.asarray(v).copy())
                          for k, v in sd.items()},
                "architecture": "vis_mvsnet"}, ckpt)
    pred = Predictor(ckpt, device="cpu", bf16=False)
    assert pred.architecture == "vis_mvsnet" and pred.downscale == 2
    args = vis_scene(seed=4)
    want = jax_eval[2]({"params": params, "batch_stats": stats}, *args)
    got = pred(*(a[0] for a in args))
    assert_depth_close(got["depth"], np.asarray(want["depth"])[0])
    err = np.abs(got["confidence"]
                 - np.asarray(want["photometric_confidence"])[0])
    assert (err <= 5e-3).mean() >= 0.99


def test_ragged_views_match_jax(random_variables):
    """Views of different sizes: per-view features, pairs swept one by one
    and fused sequentially (bare exp weights), as in the JAX package."""
    params, stats = random_variables
    imgs, K, R, t, dmin, dmax = vis_scene(seed=5)
    views = (imgs[:, 0], imgs[:, 1, :, :48], imgs[:, 2, :32])
    jmodel = jax_build_model("vis_mvsnet", **EVAL_KW)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        {"params": params, "batch_stats": stats}, views, K, R, t, dmin,
        dmax)
    model = port_model(params, stats)
    got = run_port(model, (views, K, R, t, dmin, dmax))
    assert_outputs_match(got, want)
    # the gwc path (its plain version here) takes any source size: its
    # cost volumes against the gather's on each stage's own inputs
    for cv, cv_g, *_ in stage_forced(model, (views, K, R, t, dmin, dmax),
                                     "gwc").values():
        for a, b in zip(cv, cv_g):
            scale = b.abs().max().item()
            assert (a - b).abs().max().item() < 0.03 * scale


@pytest.mark.parametrize("ragged", [False, True], ids=["stacked",
                                                       "sequential"])
@pytest.mark.parametrize("mode", ["soft", "hard", "average", "uwta",
                                  "maxpool"])
def test_fusion_modes_match_jax_single_stage(mode, ragged):
    """One eval stage in each fusion mode, on a per-pixel slab: the stacked
    form (sources of one size) and the sequential one (sources of
    different sizes), against the JAX SingleStage."""
    rng = np.random.default_rng(6)
    h, w, c, D = 16, 20, 32, 4
    ref = rng.standard_normal((1, h, w, c)).astype(np.float32)
    src_hw = [(h, w), (12, 14) if ragged else (h, w)]
    srcs = [rng.standard_normal((1,) + hw + (c,)).astype(np.float32)
            for hw in src_hw]
    _, K, R, t, _, _ = vis_scene(seed=7)
    start = (5.5 + 0.2 * rng.standard_normal((1, 1, h, w))).astype(
        np.float32)
    interval = np.full((1, 1, 1, 1), 0.08, np.float32)
    jstage = JaxSingleStage(mode=mode)
    cams = {"K": K, "R": R, "t": t}
    jargs = (ref, srcs, cams, D, start, interval, 4)
    shapes = jax.eval_shape(lambda: jstage.init(jax.random.PRNGKey(0),
                                                *jargs, train=False))
    v = fill_tree(shapes, seed=8)
    est, prob, pairs = jstage.apply(v, *jargs, train=False)

    stage = SingleStage(mode)
    stage.load_state_dict(state_dict_from_jax(v["params"],
                                              v["batch_stats"]))
    stage.eval()
    tt = torch.from_numpy
    with torch.inference_mode():
        g_est, g_prob, g_pairs = stage(
            tt(ref), [tt(s) for s in srcs],
            {k: tt(a) for k, a in cams.items()}, D, tt(start),
            tt(interval), 4, "gather")
    assert np.asarray(est).std() > 1e-3
    np.testing.assert_allclose(g_est.numpy(), np.asarray(est), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(g_prob.numpy(), np.asarray(prob), rtol=0,
                               atol=1e-4)
    for (dg, (ug,)), (dw, (uw,)) in zip(g_pairs, pairs):
        np.testing.assert_allclose(dg.numpy(), np.asarray(dw), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(ug.numpy(), np.asarray(uw), rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(uw).max()))


def keep_first(store: dict, key):
    """A forward (pre-)hook that keeps the first call's inputs (or output)
    under `key` and returns None, so that it changes nothing: a later call
    of the module, on the kept inputs, neither overwrites them nor gets
    them back in place of its own result."""
    def hook(module, *args):
        if key not in store:
            store[key] = args[-1]
    return hook


def stage_forced(model, args, method):
    """Run `model` with `method`, then each stage again through the exact
    gather on the very inputs that stage received (features, cameras and
    its slab): {stage: (method's cost volumes, gather's cost volumes,
    method's depth, gather's depth, hypothesis interval)}. Holding each
    stage on its own inputs keeps the cascade's re-centring, which
    amplifies any difference, out of the comparison."""
    model.sweep_method = method
    inputs, outputs, costs = {}, {}, {}
    hooks = []
    for i in (1, 2, 3):
        st = getattr(model, f"stage{i}")
        hooks += [
            st.register_forward_pre_hook(
                keep_first(inputs, i)),
            st.register_forward_hook(
                keep_first(outputs, i)),
            st.reg.register_forward_pre_hook(
                lambda m, a, i=i: costs.setdefault(i, []).append(
                    a[0].float()))]
    try:
        run_port(model, args)
        got = {}
        for i in (1, 2, 3):
            n_pairs = len(costs[i])
            with torch.inference_mode():
                est, _, _ = getattr(model, f"stage{i}")(*inputs[i][:-1],
                                                        "gather")
            got[i] = (costs[i][:n_pairs], costs[i][n_pairs:],
                      outputs[i][0], est, inputs[i][5].flatten()[0].item())
    finally:
        for hk in hooks:
            hk.remove()
    return got


@pytest.mark.parametrize("method", ["warp", "gwc"])
def test_kernel_paths_agree_with_the_gather_on_cpu(method):
    """The warp and gwc paths (the kernels' plain versions, which take bf16
    features and round their result once to bf16) against the exact gather,
    stage by stage on the same inputs, with the trained asset."""
    sd, _ = load_weights(ASSET)
    model = build_model("vis_mvsnet", device="cpu", **EVAL_KW)
    model.load_state_dict(sd)
    for stage, (cv, cv_g, est, est_g, interval) in stage_forced(
            model.eval(), vis_scene(seed=9), method).items():
        assert len(cv) == len(cv_g) == N - 1
        for a, b in zip(cv, cv_g):
            # bf16 roundings (features, result) of sums of 4 products: a
            # few 2^-8 of the volume's scale
            scale = b.abs().max().item()
            err = (a - b).abs()
            assert err.max().item() < 0.03 * scale, (stage, err.max())
            assert err.mean().item() < 2e-3 * scale, (stage, err.mean())
        if stage == 3:
            derr = (est - est_g).abs() / interval
            assert derr.mean() < 0.25 and (derr < 1).float().mean() > 0.95


def test_predictor_and_run_depthmaps_serve_vis(tmp_path, jax_eval):
    """Predictor serves the asset at the eval configuration (what JAX
    computes, f32); run_depthmaps writes the 3-stage probability, which
    get_mask_invalid reads as the JAX package does."""
    pred = Predictor(ASSET, device="cpu", bf16=False)
    assert pred.architecture == "vis_mvsnet" and pred.downscale == 2
    assert pred.model.depth_nums == EVAL_KW["depth_nums"]
    imgs, K, R, t, dmin, dmax = (a[0] for a in vis_scene(seed=10))
    got = pred(imgs, K, R, t, dmin, dmax)
    params, stats, _ = jax_load_npz(ASSET)
    want = jax_eval[2]({"params": params, "batch_stats": stats},
                       *vis_scene(seed=10))
    assert got["depth"].shape == (H // 2, W // 2)
    assert got["confidence"].shape == (3, H // 2, W // 2)
    assert_depth_close(got["depth"], np.asarray(want["depth"])[0])
    samples = [{"imgs": imgs, "K": K, "R": R, "t": t, "depth_min": dmin,
                "depth_max": dmax, "filename": "scan1/00000000"}]
    run_depthmaps(samples, pred.model, tmp_path)
    with np.load(tmp_path / "scan1_00000000_out.npz") as z:
        np.testing.assert_array_equal(z["depthmap"], got["depth"])
        prob = z["probability"]
    assert prob.shape == (3, H // 2, W // 2)
    for a in ((prob,), (prob, 0.5)):
        np.testing.assert_array_equal(get_mask_invalid(*a),
                                      jax_mask_invalid(*a))


def test_unported_paths_and_options_raise():
    args = [torch.from_numpy(a) for a in vis_scene()]
    # "rect" is ported (tests/test_torch_rect.py holds it to JAX): it
    # serves at eval and resolves as "auto" in train mode
    rect = build_model("vis_mvsnet", device="cpu", depth_nums=(8, 4, 4),
                       sweep_method="rect").eval()
    with torch.inference_mode():
        assert torch.isfinite(rect(*args)["depth"]).all()
    assert rect.resolve_sweep(torch.float32, torch.device("cpu")) == "rect"
    assert rect.train().resolve_sweep(torch.bfloat16,
                                      torch.device("cuda")) == "warp"
    model = build_model("vis_mvsnet", device="cpu", depth_nums=(8, 4, 4),
                        sweep_method="gwc")
    with pytest.raises(ValueError, match="eval only"):
        model.train()(*args)
    with pytest.raises(ValueError, match="sweep_method"):
        build_model("vis_mvsnet", device="cpu", sweep_method="mosaic")
    with pytest.raises(NotImplementedError, match="fusion mode"):
        build_model("vis_mvsnet", device="cpu", mode="median")
    # auto takes the exact gather on the CPU, the kernels on the card
    auto = build_model("vis_mvsnet", device="cpu")
    assert auto.eval().resolve_sweep(torch.bfloat16,
                                     torch.device("cpu")) == "gather"
    assert auto.eval().resolve_sweep(torch.bfloat16,
                                     torch.device("cuda")) == "gwc"
    assert auto.train().resolve_sweep(torch.bfloat16,
                                      torch.device("cuda")) == "warp"
    assert auto.resolve_sweep(torch.float32, torch.device("cuda")) == \
        "gather"
