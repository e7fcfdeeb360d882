"""The port's MVSNet (weights carried from JAX) vs the JAX MVSNet, on the CPU.

The JAX parameter tree comes from the JAX model itself (`jax.eval_shape` of
its init), filled with seeded numpy values; `state_dict_from_jax` carries
it into the port. Inputs are numpy arrays from a seed. Both sides run f32.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wildmvs.models import build_model as jax_build_model
from wildmvs.models.mvsnet import MVSNet as JaxMVSNet
from wildmvs.models.mvsnet import CostRegNet as JaxCostRegNet
from wildmvs.models.mvsnet import FeatureNet as JaxFeatureNet
from wildmvs.train.torch_import import convert_state_dict
from wildmvs_torch.models import build_model
from wildmvs_torch.train.jax_import import state_dict_from_jax
from tests.test_torch_import import reference_mvsnet_state_dict

torch.set_num_threads(1)

B, N, H, W, D = 1, 3, 64, 96, 16
# the last conv's weights are scaled up so the random network's depth
# probabilities are peaked (unit-scale logits would give a flat softmax and
# make every depth the mid-range one, whatever the cost volume)
PROB_GAIN = 60.0


def scene(seed=0, b=B, n=N, h=H, w=W):
    """A seeded rig: views shifted sideways, depth range 5..10."""
    rng = np.random.default_rng(seed)
    imgs = rng.random((b, n, h, w, 3)).astype(np.float32)
    K = np.tile(np.array([[80.0, 0, w / 2], [0, 80.0, h / 2], [0, 0, 1]],
                         np.float32), (b, n, 1, 1))
    R = np.tile(np.eye(3, dtype=np.float32), (b, n, 1, 1))
    t = np.zeros((b, n, 3, 1), np.float32)
    t[:, :, 0, 0] = 0.4 * (np.arange(n) - (n - 1) / 2)
    t[:, :, 1, 0] = 0.1 * rng.standard_normal((b, n))
    return (imgs, K, R, t, np.full((b, n), 5.0, np.float32),
            np.full((b, n), 10.0, np.float32))


def jax_variables(arch="mvsnet-s", seed=0):
    """The JAX model's (params, batch_stats) tree with seeded values."""
    model = jax_build_model(arch, num_depth=D)
    shapes = jax.eval_shape(
        lambda *a: model.init(jax.random.PRNGKey(0), *a, train=False),
        *scene())
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [getattr(k, "key", str(k)) for k in path]
        shape, leaf_name = leaf.shape, names[-1]
        if leaf_name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
            if "prob" in names:
                v *= PROB_GAIN
        elif leaf_name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf_name in ("bias", "mean"):
            v = 0.1 * rng.standard_normal(shape)
        elif leaf_name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:                                            # softmin temp
            v = np.full(shape, 0.5)
        return v.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return v["params"], v["batch_stats"]


@pytest.fixture(scope="module")
def variables():
    return jax_variables()


def port_model(params, stats, arch="mvsnet-s", **kw):
    model = build_model(arch, device="cpu", num_depth=D, **kw)
    model.load_state_dict(state_dict_from_jax(params, stats))
    return model.eval()


def drop_temp(params):
    return {k: v for k, v in params.items() if k != "temp"}


def test_port_keys_are_the_reference_keys():
    # the reference checkpoint layout (tests/test_torch_import.py oracle)
    # loads into the port as it is
    for arch, softmin in (("mvsnet", False), ("mvsnet-s", True)):
        ref = reference_mvsnet_state_dict(softmin=softmin)
        model = build_model(arch, device="cpu", num_depth=D)
        assert sorted(model.state_dict()) == sorted(ref)
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in ref.items()})
        np.testing.assert_array_equal(
            model.cost_regularization.conv7[0].weight.detach().numpy(),
            ref["cost_regularization.conv7.0.weight"])


def test_state_dict_from_jax_round_trips(variables):
    params, stats = variables
    sd = state_dict_from_jax(params, stats)
    model = build_model("mvsnet-s", device="cpu", num_depth=D)
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict(sd)               # strict: every key, every shape
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


def test_feature_and_cost_regularization_nets_match_jax(variables):
    params, stats = variables
    model = port_model(params, stats)
    rng = np.random.default_rng(1)
    x = rng.random((2, 32, 64, 3)).astype(np.float32)
    want = JaxFeatureNet().apply(
        {"params": params["feature"], "batch_stats": stats["feature"]}, x,
        False)
    with torch.inference_mode():
        got = model.feature(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 8, 16, 32)
    # f32 convolutions (XLA vs oneDNN) accumulate in other orders: ~1e-6
    # relative per layer over 8 layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())

    vol = rng.standard_normal((1, 8, 8, 16, 32)).astype(np.float32)
    want = jax.jit(lambda v: JaxCostRegNet().apply(
        {"params": params["cost_regularization"],
         "batch_stats": stats["cost_regularization"]}, v, False))(vol)
    with torch.inference_mode():
        got = model.cost_regularization(torch.from_numpy(vol))
    assert got.shape == want.shape == (1, 8, 8, 16, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("aggregation", ["variance", "softmin",
                                         "norm-variance"])
def test_mvsnet_forward_matches_jax(variables, aggregation):
    params, stats = variables
    if aggregation != "softmin":
        params = drop_temp(params)
    jmodel = JaxMVSNet(num_depth=D, aggregation=aggregation)
    args = scene()
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        {"params": params, "batch_stats": stats}, *args)
    model = build_model("mvsnet", device="cpu", num_depth=D,
                        aggregation=aggregation)
    model.load_state_dict(state_dict_from_jax(params, stats))
    model.eval()
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, args))
    depth_j = np.asarray(want["depth"])
    conf_j = np.asarray(want["photometric_confidence"])
    assert got["depth"].shape == depth_j.shape == (B, H // 4, W // 4)
    # the network must have an opinion, or the comparison is vacuous
    assert depth_j.std() > 0.2 and conf_j.mean() > 1.25 * 4 / D
    # f32 throughout; conv and gather rounding (~1e-5 relative) grows
    # through the softmax's x60 logits; 1e-3 of the 5-unit range is 0.003
    # of a depth interval (5/15)
    np.testing.assert_allclose(got["depth"].numpy(), depth_j, atol=5e-3)
    # the 4-tap confidence reads at a truncated index: a pixel whose
    # index sits on an integer may read the neighbouring window
    conf = got["photometric_confidence"].numpy()
    close = np.abs(conf - conf_j) < 1e-3
    assert close.mean() > 0.99, close.mean()


def run_capturing_cost_volume(model, args):
    """(output dict, the cost volume the regularizer received)."""
    seen = []
    hook = model.cost_regularization.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].float()))
    try:
        with torch.inference_mode():
            out = model(*args)
    finally:
        hook.remove()
    return out, seen[0]


def test_sweep_methods_agree_on_cpu(variables):
    # gather (exact f32) = warp = fused (the kernels' plain versions; the
    # kernels take bf16 features, so those two round the features and
    # their result to bf16)
    params, stats = variables
    args = [torch.from_numpy(a) for a in scene(seed=2)]
    out, cv = {}, {}
    for method in ("gather", "warp", "fused"):
        model = port_model(params, stats, sweep_method=method)
        out[method], cv[method] = run_capturing_cost_volume(model, args)
    scale = cv["gather"].abs().max().item()
    interval = 5.0 / (D - 1)
    for method in ("warp", "fused"):
        # two bf16 roundings (features, result) of the squared-difference
        # sums: a few 2^-8 of the volume's scale
        err = (cv[method] - cv["gather"]).abs()
        assert err.max().item() < 0.03 * scale, (method, err.max(), scale)
        assert err.mean().item() < 2e-3 * scale
        # the x60 logits magnify those roundings: depths agree to a tenth
        # of an interval on average, within half an interval almost
        # everywhere
        derr = ((out[method]["depth"] - out["gather"]["depth"]).abs()
                / interval)
        assert derr.mean() < 0.1, method
        assert (derr < 0.5).float().mean() > 0.95, method


def test_ragged_views_match_jax(variables):
    # per-view sizes differ: each view is featurized on its own and swept
    # with the exact gather on the CPU, as in the JAX package
    params, stats = variables
    params = drop_temp(params)
    imgs, K, R, t, dmin, dmax = scene(seed=3)
    views = [imgs[:, 0], imgs[:, 1, :, :64], imgs[:, 2, :32]]
    jmodel = jax_build_model("mvsnet", num_depth=D)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        {"params": params, "batch_stats": stats}, tuple(views), K, R, t,
        dmin, dmax)
    tv = [torch.from_numpy(np.ascontiguousarray(v)) for v in views]
    rest = [torch.from_numpy(a) for a in (K, R, t, dmin, dmax)]
    got = {}
    for method in ("gather", "warp"):
        model = port_model(params, stats, arch="mvsnet", sweep_method=method)
        with torch.inference_mode():
            got[method] = model(tv, *rest)["depth"].numpy()
    np.testing.assert_allclose(got["gather"], np.asarray(want["depth"]),
                               atol=5e-3)
    err = np.abs(got["warp"] - got["gather"]) / (5.0 / (D - 1))
    assert err.mean() < 0.1 and (err < 0.5).mean() > 0.95


def test_unported_paths_raise(variables):
    params, stats = variables
    args = [torch.from_numpy(a) for a in scene()]
    model = port_model(params, stats, sweep_method="rect")
    # "rect" is ported (tests/test_torch_rect.py holds it to JAX): it
    # serves at eval, and in train mode or with views of different sizes
    # it resolves as "auto"
    with torch.inference_mode():
        assert torch.isfinite(model(*args)["depth"]).all()
    assert torch.isfinite(model.train()(*args)["depth"]).all()
    for training, ragged, dev, dtype, want in (
            (True, False, "cpu", torch.float32, "gather"),
            (True, False, "cuda", torch.bfloat16, "warp"),
            (False, True, "cuda", torch.bfloat16, "warp"),
            (False, False, "cuda", torch.bfloat16, "rect"),
            (False, False, "cpu", torch.float32, "rect")):
        model.train(training)
        assert model.resolve_sweep(dtype, torch.device(dev), ragged) == want
    with pytest.raises(ValueError, match="sweep_method"):
        build_model("mvsnet", device="cpu", sweep_method="mosaic")
    with pytest.raises(ValueError, match="/32"):
        model.eval()(args[0][:, :, :40], *args[1:])
