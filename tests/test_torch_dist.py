"""The port's distribution layer (wildmvs_torch/dist/, the data-parallel
step with synced BatchNorm, the hyp and view sharding of the three
models, entry.dryrun_multichip) on the CPU, over gloo.

Three spawns of gloo ranks (`ranks`, module-scoped: 3, 2 and 4 of them,
through dist/mesh.spawn) run every sharded case and hand rank 0's
results back; each test holds one of them to the port's
single-program step or forward, computed here from the same weights and
batch, and one holds the view-parallel step to JAX's own
make_view_parallel_train_step on the 8-device CPU mesh of
tests/conftest.py. The models are MVSNet D8 at 32x64 with 3-4 views, the
CVP and Vis models at their small test sizes, all f32 through the exact
gather. The 2-process checks of tests/test_multihost.py and the
metamorphic checks of tests/test_view_parallel.py are the model.

This module imports neither jax nor wildmvs at its top: the spawned ranks
import it to find their entry point.
"""
import dataclasses

import numpy as np
import pytest
import torch

from wildmvs_torch import entry
from wildmvs_torch.data.synthetic import SyntheticMVSDataset, collate
from wildmvs_torch.dist import mesh as M
from wildmvs_torch.dist.view_parallel import make_view_parallel_train_step
from wildmvs_torch.models import build_model
from wildmvs_torch.models.vis_mvsnet import FUSION_MODES
from wildmvs_torch.nn.blocks import synced_batch_norm
from wildmvs_torch.train import trainer as T
from wildmvs_torch.train.config import TrainConfig

torch.set_num_threads(1)

WORLD = 4
H, W = 32, 64
VIS_KW = dict(depth_nums=(8, 8, 8), interval_scales=(4.0, 2.0, 1.0))


def make_batch(seeds, n):
    """A collated numpy batch, one synthetic sample from each seed."""
    samples = [SyntheticMVSDataset(num_samples=1, num_views=n, height=H,
                                   width=W, seed=s)[0] for s in seeds]
    return {k: v for k, v in collate(samples).items() if k != "filename"}


def occ_config(n, b=1):
    return TrainConfig(architecture="mvsnet", dataset="synthetic",
                       supervised=False, occ_masking=True, num_im_train=n,
                       num_depth=8, batch_size=b, lr=1e-3)


def sup_config(b=2, **kw):
    return TrainConfig(architecture="mvsnet", dataset="synthetic",
                       num_depth=8, batch_size=b, lr=1e-3, **kw)


def new_state(config, state_dict=None):
    state = T.create_train_state(config, "cpu")
    if state_dict is not None:
        state.model.load_state_dict(state_dict)
    return state


def snapshot(state, loss):
    """(loss, state_dict, gradients) after a step, on the CPU."""
    return (float(loss), {k: v.detach().clone() for k, v in
                          state.model.state_dict().items()},
            {n: p.grad.detach().clone()
             for n, p in state.model.named_parameters()})


def eval_args(seed=0):
    b = make_batch([seed], 3)
    return [torch.from_numpy(b[k]) for k in ("imgs", "K", "R", "t",
                                             "depth_min", "depth_max")]


@torch.no_grad()
def forward_outputs(model, args, mesh=None):
    with M.use_mesh(mesh):
        out = model.eval()(*args)
    return {"depth": out["depth"].clone(),
            "pairs": [[(d.clone(), u[0].clone()) for d, u in stage]
                      for stage in out["depth_pair_list"]]}


def uneven_masks(batch):
    """The batch with its second sample's mask cut to its lower half: the
    two samples' masks then count different numbers of pixels."""
    batch["mask"][1, :H // 2] = 0
    return batch


def _view3(rank, weights):
    """(i) view-parallel, data 1 x view 3: one view a rank."""
    torch.set_num_threads(1)
    mesh = M.make_mesh(data=1, view=3)
    cfg = occ_config(3)
    state = new_state(cfg, weights)
    step = make_view_parallel_train_step(mesh, cfg)
    batch = T.batch_to_device(make_batch([0], 3), "cpu")
    state, m = step(state, batch)
    return {"view3": snapshot(state, m["train_loss"])}


def _two_ranks(rank):
    """(iii) the data-parallel supervised step with synced BatchNorm, data
    2, on masks of equal and of uneven counts; (iv) hyp = 2: MVSNet and
    CVP forwards and an MVSNet step."""
    torch.set_num_threads(1)
    res = {}
    mesh = M.make_mesh(data=2)
    cfg = sup_config()
    for masks, prep in (("equal", dict), ("uneven", uneven_masks)):
        state = new_state(cfg)
        batch = T.batch_to_device(M.shard_batch(
            prep(make_batch((0, 5), 3)), mesh), "cpu")
        state, m = T.train_step(state, batch, cfg, mesh)
        res[f"data2_{masks}"] = snapshot(state, m["train_loss"])

    mesh = M.make_mesh(hyp=2)
    model = build_model("mvsnet", device="cpu", num_depth=8,
                        hyp_axis="hyp", seed=3)
    res["mvsnet_hyp2"] = forward_outputs(model, eval_args(), mesh)
    cfg = sup_config(b=1, hyp_axis="hyp")
    state = new_state(cfg)
    state, m = T.train_step(state, T.batch_to_device(
        make_batch([0], 3), "cpu"), cfg, mesh)
    res["mvsnet_hyp2_step"] = snapshot(state, m["train_loss"])
    model = build_model("cvp_mvsnet", device="cpu", nscale=2,
                        hyp_axis="hyp", seed=3)
    res["cvp_hyp2"] = forward_outputs(model, eval_args(), mesh)
    return res


def _four_ranks(rank):
    """(ii) data 2 x view 2, four views: two identical samples, then two
    distinct ones (each data rank holds one); Vis-MVSNet at view 2 x hyp
    2, a pair and half the hypotheses a rank, in every fusion mode."""
    torch.set_num_threads(1)
    res = {}
    mesh = M.make_mesh(data=2, view=2)
    cfg = occ_config(4, b=2)
    step = make_view_parallel_train_step(mesh, cfg)
    for name, seeds in (("same", (0, 0)), ("mixed", (0, 5))):
        state = new_state(cfg)
        batch = T.batch_to_device(M.shard_batch(make_batch(seeds, 4), mesh),
                                  "cpu")
        state, m = step(state, batch)
        res[f"data2_view2_{name}"] = snapshot(state, m["train_loss"])

    mesh = M.make_mesh(data=1, view=2, hyp=2)
    model = build_model("vis_mvsnet", device="cpu", view_axis="view",
                        hyp_axis="hyp", seed=3, **VIS_KW)
    res["vis_view2_hyp2"] = forward_outputs(model, eval_args(), mesh)
    # outside the mesh the sharded model runs unsharded
    res["vis_unsharded"] = forward_outputs(model, eval_args())
    for mode in FUSION_MODES[1:]:
        model = build_model("vis_mvsnet", device="cpu", view_axis="view",
                            hyp_axis="hyp", seed=3, mode=mode, **VIS_KW)
        res[f"vis_{mode}"] = forward_outputs(model, eval_args(), mesh)
    return res


@pytest.fixture(scope="module")
def jax_state():
    """The JAX view-parallel configuration's TrainState, with seeded
    weights and BatchNorm statistics off identity (tests/test_torch_cvp.py
    `fill`, from the variables' shapes: an init would run the train
    forward op by op), and those weights as the port's state_dict."""
    import jax
    import jax.numpy as jnp
    from wildmvs.train import trainer as JT
    from wildmvs.train.config import TrainConfig as JaxConfig
    from wildmvs_torch.train.jax_import import state_dict_from_jax
    from tests.test_torch_cvp import fill
    cfg = JaxConfig(**dataclasses.asdict(occ_config(3)))
    model = JT.create_model(cfg)
    batch = {k: jnp.asarray(v) for k, v in make_batch([0], 3).items()}
    shapes = jax.eval_shape(lambda b: model.init(
        jax.random.PRNGKey(0), *JT.forward_args(b, cfg), train=False), batch)
    v = fill(shapes, seed=0)
    tx = JT.make_optimizer(cfg)
    state = JT.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"],
                          opt_state=tx.init(v["params"]), tx=tx)
    params = {k: w for k, w in v["params"].items() if k != "temp"}
    return cfg, state, state_dict_from_jax(params, v["batch_stats"])


@pytest.fixture(scope="module")
def ranks(jax_state):
    """The results of the sharded cases, from rank 0 of three spawns of
    gloo ranks (3, 2 and 4 of them)."""
    res = {}
    for fn, n, args in ((_view3, 3, (jax_state[2],)), (_two_ranks, 2, ()),
                        (_four_ranks, 4, ())):
        res.update(M.spawn(fn, n, *args)[0])
    return res


def single_step(config, batch, state_dict=None, calls=None):
    """The single-program step; `calls` (a dict) receives each BatchNorm's
    calls, (elements per channel, biased batch variance, momentum)."""
    state = new_state(config, state_dict)
    hooks = []
    if calls is not None:
        from tests.test_torch_unsup import bn_recorder
        seen, hooks = bn_recorder(state.model)
    state, m = T.train_step(state, T.batch_to_device(batch, "cpu"), config)
    for hk in hooks:
        hk.remove()
    if calls is not None:
        calls.update(seen)
    return snapshot(state, m["train_loss"])


def unbiased_shift(calls, n_of):
    """What each BatchNorm's running variance gains when every updating
    call's unbiased correction n / (n - 1) is taken with n_of(n) elements
    instead of n (torch adds the unbiased batch variance)."""
    shift = {}
    for name, seen in calls.items():
        total = 0.0
        for k, (n, var, mom) in enumerate(seen):
            later = np.prod([1 - mj for *_, mj in seen[k + 1:]])
            m = n_of(n)
            total = total + mom * later * var * (m / (m - 1) - n / (n - 1))
        shift[f"{name}.running_var"] = total
    return shift


def bn_stat_keys(sd):
    return [k for k in sd if k.endswith(("running_mean", "running_var"))]


def grad_rel(got, want):
    """Each parameter's gradient error in relative L2 (against its norm,
    or 1e-4 of the largest gradient where that is larger)."""
    gmax = max(g.abs().max().item() for g in want.values())
    return {n: ((got[n] - g).norm() / max(g.norm().item(), 1e-4 * gmax))
            .item() for n, g in want.items()}


def firm(g, grads):
    """The elements of gradient g well away from 0: Adam's first step moves
    a parameter by lr * sign(gradient), so a gradient within rounding of 0
    may flip its step (tests/test_multihost.py:102-111). A tensor whose
    gradient vanishes (a bias the softmax over depth cancels) has none."""
    gmax = max(v.abs().max().item() for v in grads.values())
    big = g.abs().max().item()
    return g.abs() > max(0.1 * big, 1e-3 * gmax)


def assert_step_equal(got, want, loss_rtol, param_atol, stat_atol,
                      lr=1e-3, grads=True):
    """Loss, gradients, BatchNorm statistics and parameters after a step.
    The gradients in relative L2, as tests/test_torch_train.py holds
    them: f32 rounding grows through the backward, and a ReLU input or a
    gate of the occlusion mask within rounding of its threshold may fall
    on the other side (the single-program step on 1 and on 2 identical
    samples differs by 0.8 % there). The parameters within `param_atol`
    where the gradient is firm, within Adam's sign flip (2 lr) everywhere,
    99.9 % of them within 2e-5. grads=False, where the two steps'
    batches differ in composition, leaves out the gradients and the
    99.9 %: their rounding noise is larger there, and Adam's flips less
    rare."""
    np.testing.assert_allclose(got[0], want[0], rtol=loss_rtol)
    for k in bn_stat_keys(want[1]):
        np.testing.assert_allclose(got[1][k].numpy(), want[1][k].numpy(),
                                   rtol=0, atol=stat_atol, err_msg=k)
    if grads:
        rel = grad_rel(got[2], want[2])
        worst = max(rel, key=rel.get)
        assert rel[worst] < 0.05, (worst, rel[worst])
        assert np.median(list(rel.values())) < 0.01, rel
    diffs = []
    for n, g in want[2].items():
        diff = (got[1][n] - want[1][n]).abs()
        held = diff[firm(g, want[2])]
        assert held.numel() == 0 or held.max() <= param_atol, n
        diffs.append(diff.reshape(-1))
    diffs = torch.cat(diffs)
    assert diffs.max() < 2.5 * lr, diffs.max()
    if grads:
        assert (diffs < 2e-5).float().mean() > 0.999


def test_view_parallel_step_equals_single_program(ranks, jax_state):
    """Data 1 x view 3: the loss, every parameter after Adam and every
    BatchNorm statistic (reference view 0's) equal the single-program
    occlusion-masked step's, with the JAX package's tolerances
    (tests/test_view_parallel.py: loss rtol 2e-4, statistics 2e-5; the
    parameters 1e-3, its data x view bound). The gradients too: each
    view's is computed by the same operations and scale, summed in
    another order."""
    weights = jax_state[2]
    want = single_step(occ_config(3), make_batch([0], 3), weights)
    got = ranks["view3"]
    assert_step_equal(got, want, 2e-4, 1e-3, 2e-5)
    assert max((got[1][k] - weights[k]).abs().max().item()
               for k in bn_stat_keys(weights)) > 0


def test_data_by_view_step_with_identical_samples(ranks):
    """Data 2 x view 2 on two identical samples: each data rank computes
    the single-program step on one of them, which the step equals,
    gradients included. Each data rank's BatchNorm over its one sample
    normalizes as the whole batch's, so the step also equals the
    single-program step on both (test_view_parallel.py:110-151): the
    loss, the statistics and the parameters, the running variances
    apart from torch's unbiased correction, taken over one sample's
    elements instead of two (flax adds the biased variance, where the two
    agree), which is added to the want. The gradients are not held there:
    the single-program step on one sample and on two identical ones
    already differ by 1.5 % (relative L2, CostRegNet), through the
    occlusion mask's gates and ReLU inputs within rounding of their
    thresholds."""
    got = ranks["data2_view2_same"]
    assert_step_equal(got, single_step(occ_config(4), make_batch([0], 4)),
                      2e-4, 1e-3, 2e-5)
    calls = {}
    want = single_step(occ_config(4, b=2), make_batch((0, 0), 4),
                       calls=calls)
    for k, v in unbiased_shift(calls, lambda n: n // 2).items():
        want[1][k] = want[1][k] + v
    assert_step_equal(got, want, 2e-4, 1e-3, 2e-5, grads=False)


def test_data_by_view_step_averages_distinct_samples(ranks):
    """Two distinct samples, one a data rank: BatchNorm is not synced in
    the view-parallel step (each data rank normalizes its own rows, as in
    JAX's shard_map), so the loss is the mean of the two single-sample
    losses (test_view_parallel.py:153-161) and the running statistics the
    mean of theirs; the gradient the mean of theirs."""
    singles = [single_step(occ_config(4, b=1), make_batch([s], 4))
               for s in (0, 5)]
    got = ranks["data2_view2_mixed"]
    np.testing.assert_allclose(got[0], np.mean([s[0] for s in singles]),
                               rtol=2e-4)
    for k in bn_stat_keys(got[1]):
        np.testing.assert_allclose(
            got[1][k].numpy(), (singles[0][1][k] + singles[1][1][k]).numpy()
            / 2, rtol=0, atol=2e-5, err_msg=k)
    rel = grad_rel(got[2], {n: (singles[0][2][n] + singles[1][2][n]) / 2
                            for n in got[2]})
    assert max(rel.values()) < 0.05 and np.median(list(rel.values())) < 0.01


@pytest.mark.parametrize("masks", ["equal", "uneven"])
def test_data_parallel_step_syncs_batch_norm(ranks, masks):
    """The supervised data-parallel step (data 2, a sample a rank, BatchNorm
    synced over data) equals the single step on the whole batch
    (tests/test_multihost.py:73-112): the loss within 1e-5, the gradients
    within f32 summation order, the BatchNorm statistics within 1e-6 and
    the parameters after Adam within 2e-5 but for its sign flips
    (`assert_step_equal`). Each rank's masked mean counts its mask over
    the whole batch, so this holds where the two samples' masks count
    different numbers of pixels too, which the mean of the ranks' own
    masked means (DDP's) would not."""
    batch = make_batch((0, 5), 3)
    if masks == "uneven":
        batch = uneven_masks(batch)
    counts = batch["mask"].reshape(2, -1).sum(1)
    assert (counts[0] == counts[1]) == (masks == "equal")
    want = single_step(sup_config(), batch)
    assert_step_equal(ranks[f"data2_{masks}"], want, 1e-5, 2e-5, 2e-5)
    # without the sync each rank would normalize its own sample: the step
    # would differ
    unsynced = [single_step(sup_config(b=1), make_batch([s], 3))
                for s in (0, 5)]
    assert abs(np.mean([u[0] for u in unsynced]) - want[0]) > 1e-3
    if masks == "uneven":
        # the mean of the two samples' own masked means, on the step's
        # forward, is another loss
        cfg = sup_config()
        b = T.batch_to_device(batch, "cpu")
        with torch.no_grad():
            out = new_state(cfg).model.train()(*T.forward_args(b, cfg))
        assert not out["depth_pair_list"]
        per = [T.loss_from_outputs(
            {"depth_est_list": [d[i:i + 1] for d in out["depth_est_list"]],
             "depth_pair_list": []},
            {k: v[i:i + 1] for k, v in b.items()}, cfg).item()
            for i in range(2)]
        assert abs(np.mean(per) - want[0]) > 1e-2 * want[0], (per, want[0])


def test_mvsnet_and_cvp_hyp_slabs_equal_unsharded(ranks):
    """hyp = 2: each rank sweeps half the hypotheses and keeps its slab
    through the depth-partitioned regularizer, the softmax and regression
    reduced over the slabs; the depth equals the unsharded forward's
    within 1e-4 (tests/test_view_parallel.py:70-106, :202-243)."""
    args = eval_args()
    for name, arch, kw in (("mvsnet_hyp2", "mvsnet", dict(num_depth=8)),
                           ("cvp_hyp2", "cvp_mvsnet", dict(nscale=2))):
        want = forward_outputs(build_model(arch, device="cpu", seed=3, **kw),
                               args)["depth"]
        got = ranks[name]["depth"]
        assert torch.isfinite(want).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_mvsnet_hyp_step_gradients_equal_unsharded(ranks):
    """A supervised MVSNet step at hyp = 2: each rank back-propagates half
    the loss, the reductions over depth add the halves back up for each
    slab, each rank holds its slab's share of the regularizer's gradient
    (train/trainer.py's rule), and the sum over the ranks equals the
    unsharded step's gradient (within f32 summation order); so do the
    loss and the BatchNorm statistics, the regularizer's normalized over
    both slabs."""
    want = single_step(sup_config(b=1), make_batch([0], 3))
    assert all(g.abs().max() > 0 for g in want[2].values())
    assert_step_equal(ranks["mvsnet_hyp2_step"], want, 1e-6, 2e-5, 2e-5)


def test_vis_view_by_hyp_equals_unsharded(ranks):
    """Vis-MVSNet at view 2 x hyp 2: a source pair and half of each stage's
    hypotheses a rank, kept through the depth-partitioned Reg, RegPair and
    RegFuse; the fused volume's sums added over the view ranks.
    The depth and every pair's depth and uncertainty equal the unsharded
    forward's within 1e-4 (tests/test_view_parallel.py:164-199); outside
    the mesh the same model runs unsharded."""
    model = build_model("vis_mvsnet", device="cpu", seed=3, **VIS_KW)
    want = forward_outputs(model, eval_args())
    for got in (ranks["vis_view2_hyp2"], ranks["vis_unsharded"]):
        np.testing.assert_allclose(got["depth"].numpy(),
                                   want["depth"].numpy(), rtol=0, atol=1e-4)
        assert len(got["pairs"]) == 3
        for gs, ws in zip(got["pairs"], want["pairs"]):
            assert len(gs) == len(ws) == 2
            for (gd, gu), (wd, wu) in zip(gs, ws):
                np.testing.assert_allclose(gd.numpy(), wd.numpy(), atol=1e-4)
                np.testing.assert_allclose(gu.numpy(), wu.numpy(), atol=1e-4)
    np.testing.assert_array_equal(ranks["vis_unsharded"]["depth"].numpy(),
                                  want["depth"].numpy())


@pytest.mark.parametrize("mode", FUSION_MODES[1:])
def test_vis_view_sharded_fusion_modes(ranks, mode):
    """The other four fusion modes at view 2 x hyp 2: hard and average add
    their sums over the view ranks, maxpool takes the max, uwta the first
    pair of least uncertainty (a min of the uncertainty, then of the pair
    index). The depth equals the unsharded forward's within 1e-4."""
    model = build_model("vis_mvsnet", device="cpu", seed=3, mode=mode,
                        **VIS_KW)
    want = forward_outputs(model, eval_args())["depth"]
    got = ranks[f"vis_{mode}"]["depth"]
    assert torch.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


def test_view_parallel_step_matches_jax(ranks, jax_state):
    """The port's view-parallel step (data 1 x view 3, from the JAX
    weights) against JAX's make_view_parallel_train_step on three devices
    of the CPU mesh, one jitted step: the loss (rtol 2e-4), every
    BatchNorm statistic (flax adds the biased batch variance, torch the
    unbiased one: that difference is taken back out) and the parameters
    after Adam, whose first step moves each by lr * sign(gradient):
    within 1e-5 where the gradient is well determined and within the
    step's size everywhere."""
    import jax
    from wildmvs.dist.mesh import make_mesh, replicate, shard_batch
    from wildmvs.dist.view_parallel import (
        make_view_parallel_train_step as jax_step)
    from tests.test_torch_train import jax_tree_to_port
    cfg, state, weights = jax_state
    mesh = make_mesh(data=1, view=3, hyp=1, devices=jax.devices()[:3])
    rstate = state.replace(step=replicate(state.step, mesh),
                           params=replicate(state.params, mesh),
                           batch_stats=replicate(state.batch_stats, mesh),
                           opt_state=replicate(state.opt_state, mesh))
    new, metrics = jax_step(mesh, cfg)(rstate, shard_batch(
        make_batch([0], 3), mesh))
    want = {k: np.asarray(v, np.float32) for k, v in jax_tree_to_port(
        jax.device_get(new.params), jax.device_get(new.batch_stats)).items()}
    loss, got, grads = ranks["view3"]
    np.testing.assert_allclose(loss, float(metrics["train_loss"]), rtol=2e-4)
    # reference view 0's BatchNorm calls (FeatureNet runs once a view), to
    # take torch's unbiased correction back out of the running variance
    from tests.test_torch_unsup import bn_recorder
    model = new_state(occ_config(3), weights).model.train()
    calls, hooks = bn_recorder(model)
    with torch.no_grad():
        b = T.batch_to_device(make_batch([0], 3), "cpu")
        model(*T.forward_args(b, occ_config(3)), reference_frame=0)
    for hk in hooks:
        hk.remove()
    for name, seen in calls.items():
        np.testing.assert_allclose(got[f"{name}.running_mean"].numpy(),
                                   want[f"{name}.running_mean"], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        rv = got[f"{name}.running_var"].clone()
        for k, (n, var, mom) in enumerate(seen):
            later = np.prod([1 - mj for *_, mj in seen[k + 1:]])
            rv -= mom * later * var * (n / (n - 1) - 1)
        np.testing.assert_allclose(rv.numpy(), want[f"{name}.running_var"],
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    for name, g in grads.items():
        diff = np.abs(got[name].numpy() - want[name])
        assert diff[firm(g, grads).numpy()].max(initial=0.0) <= 1e-5, name
        assert diff.max() <= 2 * cfg.lr + 1e-5, name


@pytest.mark.parametrize("n, B, P", [(23, 4, 2), (24, 6, 3), (7, 4, 4)])
def test_process_local_order_equals_jax(n, B, P):
    """The port's copy of process_local_order gives the JAX package's
    local orders (tests/test_multihost.py:26-53), each process's rows
    disjoint and together every global batch."""
    from wildmvs.dist.mesh import process_local_order as jax_order
    order = np.random.default_rng(n).permutation(n)
    for p in range(P):
        got = M.process_local_order(order, B, num_processes=P, process_id=p)
        want = jax_order(order, B, num_processes=P, process_id=p)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == B // P
    lo, lbs = M.process_local_order(order, B)     # one process: identity
    np.testing.assert_array_equal(lo, order)
    assert lbs == B
    with pytest.raises(AssertionError):
        M.process_local_order(order, B + 1, num_processes=P, process_id=0)


def test_mesh_without_a_process_group_runs_unsharded():
    """One process: every axis spans one rank, the collectives are the
    identity, a sharded model runs unsharded and synced BatchNorm is torch's
    own; the slabs split as np.array_split."""
    mesh = M.make_mesh()
    assert mesh.shape == {"data": 1, "view": 1, "hyp": 1}
    assert all(ax.group is None for ax in mesh.axes.values())
    x = torch.arange(6.0)
    assert M.all_reduce(x, mesh.axis("data")) is x
    assert M.gather_slabs(x, None, 0, 6) is x
    assert M.slab_bounds(10, M.MeshAxis("hyp", None, 3, 0, (0,))) == [
        (0, 4), (4, 7), (7, 10)]
    assert M.shard_batch({"a": x}, mesh)["a"] is x
    with M.use_mesh(mesh):
        assert M.active_axis("hyp") is None
    model = build_model("mvsnet", device="cpu", num_depth=8,
                        hyp_axis="hyp", seed=3)
    with synced_batch_norm(model, mesh.axis("data")):
        got = forward_outputs(model, eval_args(), mesh)["depth"]
    np.testing.assert_array_equal(
        got.numpy(), forward_outputs(build_model(
            "mvsnet", device="cpu", num_depth=8, seed=3), eval_args())[
            "depth"].numpy())


def test_dryrun_multichip_runs_its_four_phases(capsys):
    """entry.dryrun_multichip(4) on the CPU: a data x hyp supervised step,
    a view-parallel occlusion-masked step, the Vis view x hyp and CVP hyp
    evals, one line each, finite."""
    entry.dryrun_multichip(4, "cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        f"dryrun_multichip(4) phase{i}" for i in range(1, 5)]
    assert all(ln.endswith("OK") for ln in lines), lines


def test_entry_forward_is_the_flagship_mvsnet():
    """entry("cpu"): MVSNet with 32 hypotheses on a one-sample 32x64 batch
    of three views, as the JAX package's __graft_entry__.entry()."""
    forward, args = entry.entry("cpu")
    assert args[0].shape == (1, 3, H, W, 3)
    depth = forward(*args)
    assert depth.shape == (1, H // 4, W // 4) and torch.isfinite(depth).all()
    dmin, dmax = args[4][0, 0].item(), args[5][0, 0].item()
    assert dmin <= depth.min().item() and depth.max().item() <= dmax


def test_torchrun_counts_this_nodes_cards(monkeypatch):
    """Under torchrun with nccl the card check counts this node's ranks
    (LOCAL_WORLD_SIZE), not the world's: two nodes of 8 cards run 16
    ranks, rank 9 on its node's cuda:1; 8 ranks on a node of 4 cards
    raise. No process group is joined here (initialize is stubbed)."""
    from wildmvs_torch.train import cli
    seen = {}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.setdefault("card", d))
    monkeypatch.setattr(cli, "initialize",
                        lambda *a: seen.setdefault("init", a))
    monkeypatch.setattr(cli, "_train", lambda rank, config, a, device: device)
    monkeypatch.setattr(torch.distributed, "destroy_process_group",
                        lambda: None)
    for k, v in dict(WORLD_SIZE="16", RANK="9", LOCAL_RANK="1",
                     LOCAL_WORLD_SIZE="8").items():
        monkeypatch.setenv(k, v)
    assert cli.main(["--num_depth", "8"]) == "cuda:1"
    assert seen == {"card": "cuda:1", "init": ("nccl", "env://", 16, 9)}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(RuntimeError, match="nccl takes one card a rank"):
        cli.main(["--num_depth", "8"])
