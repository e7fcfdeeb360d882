"""Depth-partitioned regularization under `hyp` sharding
(wildmvs_torch/dist/depth_parallel.py, dist/mesh.fetch_range, the slab
reductions of ops/volumes.py) on the CPU, over gloo.

One spawn of gloo ranks per world size (2, 3 and 4, module-scoped, through
dist/mesh.spawn) runs every sharded case and hands each rank's results
back; each test holds them to the unsharded port, computed here from the
same weights and inputs, and the model forwards also to the JAX package's
own hyp-sharded forward on the 8-device CPU mesh of tests/conftest.py. All
f32 through the exact gather:

  (a) the five 3D conv cases of the regularizers at D 5, 8, 12 and 16
      over 2, 3 and 4 ranks (uneven and empty slabs): the forward within
      1e-6 of the unsharded conv, the input and weight gradients, summed
      over the ranks, within 1e-5;
  (b) the reductions over depth against their unsharded selves, with a
      truncated index whose window straddles a slab edge and ties in the
      maximum;
  (c) MVSNet D8 and CVP-MVSNet nscale 2 at hyp 2, Vis-MVSNet (8, 8, 8) at
      view 2 x hyp 2: the depth within 1e-4 of the unsharded port and of
      JAX's sharded forward;
  (d) every regularizer's first conv sees this rank's slab, never the
      whole volume;
  (e) supervised CVP-MVSNet (also under remat_levels) and Vis-MVSNet
      steps at hyp 2, and an MVSNet step at data 2 x hyp 2, equal the
      single program's (tests/test_torch_dist.py's bounds; MVSNet's hyp 2
      step is there).

This module imports neither jax nor wildmvs at its top: the spawned ranks
import it to find their entry points.
"""
import threading

import numpy as np
import pytest
import torch
from torch import nn

from wildmvs_torch.dist import mesh as M
from wildmvs_torch.dist.depth_parallel import depth_partitioned
from wildmvs_torch.models import build_model
from wildmvs_torch.ops import volumes as V
from wildmvs_torch.train import trainer as T
from wildmvs_torch.train.config import TrainConfig
from tests.test_torch_dist import (VIS_KW, assert_step_equal, eval_args,
                                   forward_outputs, make_batch, new_state,
                                   single_step, snapshot, sup_config)

torch.set_num_threads(1)

DEPTHS = (5, 8, 12, 16)
WORLDS = (2, 3, 4)
#: the regularizers' 3D conv cases: (transposed, kernel, stride, padding,
#: output_padding)
CONVS = {
    "k3s1p1": (False, 3, 1, 1, 0),          # every ConvBnReLU, prob
    "k3s2p1": (False, 3, 2, 1, 0),          # MVSNet conv1/3/5, CVP conv1
    "k1s2p0": (False, 1, 2, 0, 0),          # the Vis BasicBlock downsample
    "t_k3s2p1op1": (True, 3, 2, 1, 1),      # ConvTransposeBnReLU, UNet
    "t_k3s1p1op0": (True, 3, 1, 1, 0),      # CVP conv5
}
FIRST_CONVS = {"mvsnet": "cost_regularization.conv0.conv",
               "cvp": "cost_reg_refine.conv0.conv"}


class ChannelsLast(nn.Module):
    """One conv on [B, D, H, W, C] volumes, as the regularizers take them."""

    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        return self.conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


def conv_of(name, seed=0):
    transposed, k, s, p, op = CONVS[name]
    torch.manual_seed(seed)
    if transposed:
        return ChannelsLast(nn.ConvTranspose3d(3, 2, k, s, p,
                                               output_padding=op))
    return ChannelsLast(nn.Conv3d(3, 2, k, s, p))


def conv_io(name, d):
    """The input [1, d, 4, 5, 3] and the cotangent of the output."""
    net = conv_of(name)
    gen = torch.Generator().manual_seed(d)
    x = torch.randn((1, d, 4, 5, 3), generator=gen)
    with torch.no_grad():
        shape = net(x).shape
    return x, torch.randn(shape, generator=gen)


def conv_case(name, d, axis):
    """This rank's output slab and the gradients of <out, g> for its input
    slab and the conv's weight and bias."""
    x, g = conv_io(name, d)
    net = conv_of(name)
    lo, hi = M.my_slab(d, axis)
    xs = x[:, lo:hi].clone().requires_grad_(True)
    with depth_partitioned(net, axis, d):
        y = net(xs)
    olo, ohi = M.my_slab(g.shape[1], axis)
    (y * g[:, olo:ohi]).sum().backward()
    return dict(y=y.detach(), gx=xs.grad, gw=net.conv.weight.grad,
                gb=net.conv.bias.grad)


def score_volume(d, seed=0):
    """[2, d, 3, 5] scores: a smooth random volume, with pixel (0, 0, 0)
    peaked so that its expected index is about d / 2 - 0.4 (its window-4
    taps and its +-2 window straddle the slab edge at d / 2 when two ranks
    split d) and pixel (1, 0, 1) with two equal maxima in different
    slabs."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((2, d, 3, 5), generator=gen, dtype=torch.float64)
    c = d / 2 - 0.4
    x[0, :, 0, 0] = -0.8 * (torch.arange(d, dtype=torch.float64) - c) ** 2
    x[1, :, 0, 1] = -1.0
    x[1, 1, 0, 1] = x[1, d - 2, 0, 1] = 3.0
    return x.float()


def reductions(x, depth_values, slab=None):
    """Every reduction over depth of x, and the gradients of a weighted sum
    of the differentiable ones with respect to x. With a slab every rank
    holds the same sum and back-propagates its share, sum / ranks, as a
    train step does (train/trainer.py)."""
    x = x.clone().requires_grad_(True)
    prob, idx, pmap = V.soft_argmin(x, window=2, slab=slab)
    out = dict(prob=prob, idx=idx, pmap=pmap,
               ent=V.entropy(prob, axis=1, slab=slab),
               depth=V.depth_regression(prob, depth_values, slab),
               depth_hw=V.depth_regression(
                   prob, depth_values[..., None, None].expand(
                       -1, -1, *x.shape[2:]) * 1.0, slab),
               conf=V.photometric_confidence(prob.detach(), slab),
               softmax=V.softmax_depth(x, slab))
    ranks = 1 if slab is None else slab.axis.size
    ((out["idx"].sum() + 0.5 * out["ent"].sum() + out["depth"].sum()
      + 0.25 * out["pmap"].sum()) / ranks).backward()
    out = {k: v.detach() for k, v in out.items()}
    out["grad"] = x.grad
    return out


def reduction_case(d, axis):
    x, dv = score_volume(d), torch.linspace(2.0, 6.0, d)[None].repeat(2, 1)
    slab = M.depth_slab(d, axis)
    return reductions(x[:, slab.lo:slab.hi], dv, slab)


def slab_hooks(model, names, depth, axis):
    """Forward pre-hooks on the named convs: each call's input depth against
    this rank's slab of `depth` (a list of (got, slab length)); the meta
    pass that plans the partition (no data) is left out."""
    seen = []
    mods = dict(model.named_modules())
    n = M.my_slab(depth, axis)

    def hook(module, args):
        if not args[0].is_meta:
            seen.append((args[0].shape[2], n[1] - n[0]))
    for name in names:
        mods[name].register_forward_pre_hook(hook)
    return seen


def vis_first_convs(model):
    """Each stage's Reg, RegPair and RegFuse first conv."""
    names = []
    for i in (1, 2, 3):
        for net in ("reg", "reg_pair", "reg_fuse"):
            first = next(n for n, m in getattr(model, f"stage{i}")
                         .get_submodule(net).named_modules()
                         if isinstance(m, nn.Conv3d))
            names.append(f"stage{i}.{net}.{first}")
    return names


def step_config(arch, **kw):
    return TrainConfig(architecture=arch, dataset="synthetic", batch_size=1,
                       lr=1e-3, **kw)


def _conv_results(world, axis):
    return {(name, d): conv_case(name, d, axis) for name in CONVS
            for d in DEPTHS}


def model_args(case):
    """A model case's forward inputs as tensors."""
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in case["args"]]


def _two_ranks(rank, cases):
    """hyp = 2: the conv cases, the reductions, the MVSNet and CVP forwards
    from JAX's weights with the first convs hooked, CVP and Vis steps."""
    torch.set_num_threads(1)
    mesh = M.make_mesh(hyp=2)
    hyp = mesh.axis("hyp")
    res = {"convs": _conv_results(2, hyp),
           "reductions": {d: reduction_case(d, hyp) for d in DEPTHS}}
    for name, depth in (("mvsnet", 8), ("cvp", 96)):
        case = cases[name]
        model = build_model(case["arch"], device="cpu", hyp_axis="hyp",
                            **case["kw"])
        model.load_state_dict(case["weights"])
        seen = slab_hooks(model, [FIRST_CONVS[name]], depth, hyp)
        res[name] = forward_outputs(model, model_args(case), mesh)
        res[f"{name}_seen"] = seen
    for name, arch, kw in (("cvp_mvsnet", "cvp_mvsnet", {}),
                           ("cvp_remat", "cvp_mvsnet",
                            dict(remat_levels=True)),
                           ("vis_mvsnet", "vis_mvsnet", {})):
        cfg = step_config(arch, hyp_axis="hyp", **kw)
        state = new_state(cfg)
        state, m = T.train_step(state, T.batch_to_device(
            make_batch([0], 3), "cpu"), cfg, mesh)
        res[f"{name}_step"] = snapshot(state, m["train_loss"])
    return res


def _three_ranks(rank):
    torch.set_num_threads(1)
    hyp = M.make_mesh(hyp=3).axis("hyp")
    return {"convs": _conv_results(3, hyp),
            "reductions": {d: reduction_case(d, hyp) for d in DEPTHS}}


def _four_ranks(rank, cases):
    """hyp = 4: the conv cases; data 2 x hyp 2: a supervised MVSNet step
    (BatchNorm synced over data, the regularizer's over the data x hyp
    plane); view 2 x hyp 2: the Vis forward from JAX's weights, every
    stage's 3D first convs hooked."""
    torch.set_num_threads(1)
    hyp = M.make_mesh(hyp=4).axis("hyp")
    res = {"convs": _conv_results(4, hyp)}
    mesh = M.make_mesh(data=2, hyp=2)
    cfg = sup_config(hyp_axis="hyp")
    state = new_state(cfg)
    batch = T.batch_to_device(M.shard_batch(make_batch((0, 5), 3), mesh),
                              "cpu")
    state, m = T.train_step(state, batch, cfg, mesh)
    res["data2_hyp2_step"] = snapshot(state, m["train_loss"])
    mesh = M.make_mesh(data=1, view=2, hyp=2)
    case = cases["vis"]
    model = build_model("vis_mvsnet", device="cpu", view_axis="view",
                        hyp_axis="hyp", **case["kw"])
    model.load_state_dict(case["weights"])
    res["vis_seen"] = slab_hooks(model, vis_first_convs(model), 8,
                                 mesh.axis("hyp"))
    res["vis"] = forward_outputs(model, model_args(case), mesh)
    return res


#: the model cases: (architecture, keyword arguments, the JAX mesh's axes)
MODELS = {"mvsnet": ("mvsnet", dict(num_depth=8), dict(hyp=2)),
          "cvp": ("cvp_mvsnet", dict(nscale=2), dict(hyp=2)),
          "vis": ("vis_mvsnet", VIS_KW, dict(view=2, hyp=2))}


def jax_case(name):
    """A model case: the JAX model built sharded (hyp, and view for Vis),
    its seeded weights (BatchNorm statistics off identity;
    tests/test_torch_cvp.py `fill`) carried to the port by
    state_dict_from_jax, and its inputs: the synthetic 32x64 rig, CVP on
    tests/test_torch_cvp.py's wide-baseline 64x96 rig (on the narrow one
    its hypotheses reach behind the cameras and JAX alone moves the finest
    depth by 0.02)."""
    import jax
    from wildmvs.models import build_model as jax_build_model
    from wildmvs_torch.train.jax_import import state_dict_from_jax
    from tests.test_torch_cvp import cvp_scene, fill
    arch, kw, mesh = MODELS[name]
    args = (cvp_scene() if name == "cvp"
            else tuple(a.numpy() for a in eval_args()))
    model = jax_build_model(arch, **kw, **{f"{a}_axis": a for a in mesh})
    v = fill(jax.eval_shape(lambda *a: model.init(
        jax.random.PRNGKey(0), *a, train=False), *args), seed=1)
    weights = state_dict_from_jax(
        {k: w for k, w in v["params"].items() if k != "temp"},
        v["batch_stats"])
    return dict(arch=arch, kw=kw, args=args, mesh=mesh, weights=weights,
                model=model, variables=v)


def jax_sharded_depth(case):
    """JAX's own sharded eval depth of a case, on as many devices of the
    CPU mesh as its axes take."""
    import jax
    from wildmvs.dist.mesh import make_mesh
    n = int(np.prod(list(case["mesh"].values())))
    model = case["model"]
    with jax.set_mesh(make_mesh(data=1, devices=jax.devices()[:n],
                                **case["mesh"])):
        return np.asarray(jax.jit(lambda v, *a: model.apply(
            v, *a, train=False)["depth"])(case["variables"], *case["args"]))


@pytest.fixture(scope="module")
def cases():
    """Each model's jax_case with JAX's sharded depth, and each world size's
    rank results in rank order. The ranks run in a thread while JAX
    traces and compiles (one jitted function a model): 3 ranks at once,
    2 and 4 as soon as their models' weights are there."""
    sent, ranks, failed = {}, {}, []
    ready = {2: threading.Event(), 4: threading.Event()}

    def spawn_all():
        try:
            ranks[3] = M.spawn(_three_ranks, 3)
            for world, fn in ((2, _two_ranks), (4, _four_ranks)):
                ready[world].wait()
                if failed:
                    return
                ranks[world] = M.spawn(fn, world, sent)
        except Exception as e:                   # re-raised below
            failed.append(e)
    thread = threading.Thread(target=spawn_all)
    thread.start()
    cases = {}
    try:
        for name, world in (("mvsnet", None), ("cvp", 2), ("vis", 4)):
            cases[name] = jax_case(name)
            sent[name] = {k: cases[name][k]
                          for k in ("arch", "kw", "args", "weights")}
            if world:
                ready[world].set()
        for c in cases.values():
            c["jax_depth"] = jax_sharded_depth(c)
    except Exception as e:
        failed.append(e)
        raise
    finally:
        for e in ready.values():
            e.set()
        thread.join()
    if failed:
        raise failed[0]
    return cases, ranks


@pytest.fixture(scope="module")
def ranks(cases):
    return cases[1]


def cat_slabs(per_rank, key, dim):
    return torch.cat([r[key] for r in per_rank], dim)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CONVS))
def test_partitioned_conv_equals_unsharded(ranks, name, world):
    """Each conv case over `world` ranks at every D: the output slabs,
    concatenated, within 1e-6 of the unsharded conv; the input gradient
    slabs within 1e-5 of the unsharded gradient, and the weight gradient,
    summed over the ranks, within 1e-5 of the unsharded one (the bias
    gradient within 1e-5 + 1e-6 of its size).
    The slabs are uneven where D does not divide; at D 5 over 4 ranks the
    stride-2 output has 3 planes and one rank none."""
    for d in DEPTHS:
        got = [r["convs"][(name, d)] for r in ranks[world]]
        x, g = conv_io(name, d)
        x.requires_grad_(True)
        net = conv_of(name)
        y = net(x)
        (y * g).sum().backward()
        np.testing.assert_allclose(cat_slabs(got, "y", 1).numpy(),
                                   y.detach().numpy(), rtol=0, atol=1e-6,
                                   err_msg=f"{name} D{d}")
        np.testing.assert_allclose(cat_slabs(got, "gx", 1).numpy(),
                                   x.grad.numpy(), rtol=0, atol=1e-5)
        # the bias gradient sums every output element (~60): f32 ulps
        for key, want, rtol in (("gw", net.conv.weight.grad, 0),
                                ("gb", net.conv.bias.grad, 1e-6)):
            np.testing.assert_allclose(sum(r[key] for r in got).numpy(),
                                       want.numpy(), rtol=rtol, atol=1e-5,
                                       err_msg=f"{name} D{d} {key}")
        if world == 4 and d == 5 and CONVS[name][2] == 2 and not CONVS[
                name][0]:
            assert [r["y"].shape[1] for r in got] == [1, 1, 1, 0]


@pytest.mark.parametrize("world", (2, 3))
def test_slab_reductions_equal_unsharded(ranks, world):
    """softmax_depth, soft_argmin (and its window=2 mass), entropy,
    depth_regression ([B, D] and [B, D, H, W] hypotheses) and
    photometric_confidence over `world` ranks against their unsharded
    selves: whole results within 1e-6 + 1e-6 of their size (a few f32
    ulps: the sums over D add in another order), the probability slabs
    within 1e-6 and the gradient slabs within 1e-5, as the conv cases'.
    score_volume's peaked pixel reads its window-4 sum across the slab
    edge, its tied pixel has its two maxima in two slabs."""
    for d in DEPTHS:
        x = score_volume(d)
        dv = torch.linspace(2.0, 6.0, d)[None].repeat(2, 1)
        want = reductions(x, dv)
        per_rank = [r["reductions"][d] for r in ranks[world]]
        # the peaked pixel's window-4 taps reach across the first slab edge
        edge = M.slab_bounds(d, M.MeshAxis("hyp", None, world, 0, ()))[0][1]
        idx = int(want["idx"][0, 0, 0].item())
        assert idx - 1 < edge <= idx + 2 or world == 3, (d, idx, edge)
        for key in ("prob", "softmax", "grad"):
            np.testing.assert_allclose(cat_slabs(per_rank, key, 1).numpy(),
                                       want[key].numpy(), rtol=0,
                                       atol=1e-5 if key == "grad" else 1e-6,
                                       err_msg=f"D{d} {key}")
        for key in ("idx", "pmap", "ent", "depth", "depth_hw", "conf"):
            for r in per_rank:
                np.testing.assert_allclose(
                    r[key].numpy(), want[key].numpy(), rtol=1e-6,
                    atol=1e-6, err_msg=f"D{d} {key}")
        # the tied pixel: both maxima carry the same probability
        p = want["prob"][1, :, 0, 1]
        assert p[1] == p[d - 2] == p.max()


@pytest.mark.parametrize("name", ["mvsnet", "cvp", "vis"])
def test_partitioned_forward_equals_unsharded_and_jax(cases, name):
    """MVSNet D8 and CVP-MVSNet nscale 2 at hyp 2, Vis-MVSNet at view 2 x
    hyp 2, from JAX's weights: every rank's depth within 1e-4 of the
    unsharded port's (tests/test_torch_dist.py's bound; Vis's pair depths
    and uncertainties too) and of JAX's own sharded forward. Against JAX,
    CVP and Vis are held by their port-vs-JAX rules
    (tests/test_torch_cvp.py `assert_depths_close` at the finest level's
    5e-4, tests/test_torch_vis.py `assert_depth_close`): their cascades
    carry f32 summation-order differences from one level to the next, the
    unsharded port against unsharded JAX as much as here."""
    from tests.test_torch_cvp import assert_depths_close
    from tests.test_torch_vis import assert_depth_close
    case = cases[0][name]
    world = 4 if name == "vis" else 2
    model = build_model(case["arch"], device="cpu", **case["kw"])
    model.load_state_dict(case["weights"])
    want = forward_outputs(model, model_args(case))
    assert torch.isfinite(want["depth"]).all() and want["depth"].std() > 0
    for r in cases[1][world]:
        got = r[name]
        np.testing.assert_allclose(got["depth"].numpy(),
                                   want["depth"].numpy(), rtol=0, atol=1e-4)
        for gs, ws in zip(got["pairs"], want["pairs"]):
            for (gd, gu), (wd, wu) in zip(gs, ws):
                np.testing.assert_allclose(gd.numpy(), wd.numpy(), atol=1e-4)
                np.testing.assert_allclose(gu.numpy(), wu.numpy(), atol=1e-4)
        if name == "mvsnet":
            np.testing.assert_allclose(got["depth"].numpy(),
                                       case["jax_depth"], rtol=0, atol=1e-4)
        elif name == "cvp":
            assert_depths_close(got["depth"].numpy(), case["jax_depth"],
                                atol=5e-4)
        else:
            assert_depth_close(got["depth"].numpy(), case["jax_depth"])


@pytest.mark.parametrize("name", ["mvsnet", "cvp", "vis"])
def test_regularizers_see_their_slab_only(ranks, name):
    """Every call of each regularizer's first conv (Vis: Reg, RegPair and
    RegFuse of every stage, each pair) takes at most this rank's slab of
    the hypotheses, never the gathered volume: the halo planes are fetched
    inside the conv. The first call (CVP's coarse level; its refinement
    levels run their 8 hypotheses unsharded) takes the slab itself."""
    world = 4 if name == "vis" else 2
    for r in ranks[world]:
        seen = r[f"{name}_seen"]
        assert seen and seen[0][0] == seen[0][1] > 0, (name, seen)
        for got, slab in seen:
            assert got <= slab, (name, got, slab)


@pytest.mark.parametrize("name", ["cvp_mvsnet", "cvp_remat", "vis_mvsnet"])
def test_hyp_step_equals_unsharded(ranks, name):
    """A supervised step at hyp 2 (the regularizers partitioned, their
    train-mode BatchNorm over both slabs): the loss within 1e-6, the
    gradients, BatchNorm statistics within 2e-5 and parameters after Adam
    equal the unsharded step's (assert_step_equal). cvp_remat recomputes
    each level in the backward (remat_levels), the coarse level's halo
    exchanges with it, on both ranks in the same order; it equals the
    plain unsharded step."""
    arch = "cvp_mvsnet" if name == "cvp_remat" else name
    want = single_step(step_config(arch), make_batch([0], 3))
    assert all(g.abs().max() > 0 for g in want[2].values())
    for r in ranks[2]:
        assert_step_equal(r[f"{name}_step"], want, 1e-6, 2e-5, 2e-5)


def test_data_by_hyp_step_equals_single_program(ranks):
    """Data 2 x hyp 2, a sample a data rank: FeatureNet's BatchNorm syncs
    over data, CostRegNet's over the data x hyp plane (each rank holds one
    sample's slab), so the step equals the single program's on the whole
    batch within the data-parallel step's bounds
    (tests/test_torch_dist.py: loss 1e-5, parameters and statistics
    2e-5)."""
    want = single_step(sup_config(), make_batch((0, 5), 3))
    for r in ranks[4]:
        assert_step_equal(r["data2_hyp2_step"], want, 1e-5, 2e-5, 2e-5)


def test_vis_cascade_magnifies_a_reordered_sum(monkeypatch):
    """Why the hyp-partitioned Vis-MVSNet gathers its 1-channel scores and
    reduces them whole instead of summing over the slabs: the unsharded
    model (tests/test_torch_dist.py's seed and rig) with only the order of
    its entropy sums over depth reversed moves its third stage's pair
    uncertainties by the order of the 1e-4 to which
    test_vis_view_by_hyp_equals_unsharded holds the sharded forward
    (1.02e-4 on the host where this was written), each stage's depth
    re-centring the next and the entropy weighting the fusion."""
    from wildmvs_torch.models import vis_mvsnet

    def reversed_entropy(p, axis=1, keepdims=False, slab=None):
        terms = -p * torch.log(p.clamp(1e-9, 1.0))
        return terms.flip(axis).sum(axis, keepdim=keepdims)
    model = build_model("vis_mvsnet", device="cpu", seed=3, **VIS_KW)
    want = forward_outputs(model, eval_args())
    monkeypatch.setattr(vis_mvsnet, "entropy", reversed_entropy)
    got = forward_outputs(model, eval_args())
    moved = max((gu - wu).abs().max().item()
                for (_, gu), (_, wu) in zip(got["pairs"][0], want["pairs"][0]))
    print(f"stage-3 pair uncertainties moved by {moved:.4g}")
    assert moved > 1e-5, moved
