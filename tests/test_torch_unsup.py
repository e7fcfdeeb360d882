"""The port's photometric losses and its unsupervised and occlusion-masked
training (wildmvs_torch/losses/ssim.py, losses/photometric.py,
train/trainer.py, utils/monitor.training_panels) vs the JAX package's, on
the CPU.

Inputs are made from a seed with numpy and go through both packages as
numpy arrays; weights move by `state_dict_from_jax`. Everything runs f32
through the exact gather. One jitted JAX step serves each configuration.
"""
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wildmvs.data.synthetic import SyntheticSceneDataset as JaxScene
from wildmvs.geometry.projective import build_proj_matrices as jax_proj
from wildmvs.losses import photometric as jphoto
from wildmvs.losses import ssim as jssim
from wildmvs.models import build_model as jax_build_model
from wildmvs.train import trainer as JT
from wildmvs.train.checkpoint import load_params_npz as jax_load_npz
from wildmvs.train.config import TrainConfig as JaxConfig
from wildmvs.utils.monitor import training_panels as jax_training_panels
from wildmvs_torch.losses import photometric as photo
from wildmvs_torch.losses import ssim
from wildmvs_torch.losses.supervised import masked_mean
from wildmvs_torch.models import build_model
from wildmvs_torch.train import trainer as T
from wildmvs_torch.train.config import TrainConfig
from wildmvs_torch.train.jax_import import state_dict_from_jax
from wildmvs_torch.utils.monitor import training_panels
from tests.test_torch_cvp import cvp_scene, fill
from tests.test_torch_mvsnet import jax_variables
from tests.test_torch_train import bn_modules, jax_tree_to_port, \
    synthetic_batch

torch.set_num_threads(1)

ASSET = Path(__file__).resolve().parent.parent / "assets" / \
    "vis_synth_trained.npz"
SH, SW = 32, 48                 # the loss tests' image size


def t32(x):
    return torch.tensor(np.asarray(x, np.float32))


def test_dssim_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.random((2, 20, 28, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    b[1, :, :10] = 0.0                        # a flat region: sigma ~ 0
    got = ssim.dssim(t32(a), t32(b)).numpy()
    want = np.asarray(jssim.dssim(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape == a.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the window is JAX's, bit for bit
    np.testing.assert_array_equal(ssim._gaussian_window(11, 1.5),
                                  jssim._gaussian_window(11, 1.5))


@pytest.fixture(scope="module")
def scene():
    """Three views of the synthetic plane (per-view GT depths) at 32x48."""
    s = JaxScene(num_views=3, height=SH, width=SW, seed=4)
    imgs = s.imgs[None].astype(np.float32)           # [1, 3, H, W, 3]
    proj = np.asarray(jax_proj(s.K, s.R, s.t))[None]  # [1, 3, 4, 4]
    return imgs, proj, np.stack(s.depths)[None].astype(np.float32)


def rigged_depth(depth):
    """The reference depth with a patch behind the cameras and a patch so
    near that it projects outside the sources' frustums."""
    d = depth.copy()
    d[..., 4:10, 4:12] = -2.0
    d[..., 20:26, 30:40] = 0.05
    return d


# The DSSIM's variances are E[x^2] - mu^2 over an 11x11 window: on the
# smooth synthetic texture they are ~1e-4 against terms of ~0.25, so the
# order of the convolutions' f32 sums shows. Against a float64 DSSIM of the
# same warped views the port is 5.2e-5 off and JAX 1.5e-5 at the worst
# pixel: the maps are held to 1e-4 (the random, high-variance images of
# test_dssim_matches_jax to 1e-5).
DSSIM_ATOL = 1e-4


def test_photometric_loss_matches_jax(scene):
    """f32: the flows (align_corners=True) sampled with align_corners=False,
    behind-camera points at -10, the strict frustum mask; and the gradient
    of the masked mean with respect to the depth, through the bilinear
    weights (the training signal)."""
    imgs, proj, depths = scene
    d = rigged_depth(depths[:, 0])
    flows, sdepth = photo.get_flow_from_depthmap(t32(d), t32(proj), (SH, SW),
                                                 0)
    jflows, jsdepth = jphoto.get_flow_from_depthmap(
        jnp.asarray(d), jnp.asarray(proj), (SH, SW), 0)
    np.testing.assert_allclose(flows.numpy(), np.asarray(jflows), atol=1e-5)
    np.testing.assert_allclose(sdepth.numpy(), np.asarray(jsdepth),
                               rtol=1e-5, atol=1e-5)
    assert (sdepth <= 0).any() and (flows == -10.0).any()

    got, mask = photo.photometric_loss(t32(imgs), t32(d), t32(proj))
    want, jmask = jphoto.photometric_loss(jnp.asarray(imgs), jnp.asarray(d),
                                          jnp.asarray(proj))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DSSIM_ATOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    # pixels outside the frustum with positive source depth, and inside
    out = (mask == 0) & (sdepth > 0)
    assert out.any() and 0.3 < mask.mean() < 0.95

    x = t32(d).requires_grad_()
    g, m = photo.photometric_loss(t32(imgs), x, t32(proj))
    masked_mean(g, m).backward()
    jgrad = jax.grad(lambda dd: jphoto.masked_mean(*jphoto.photometric_loss(
        jnp.asarray(imgs), dd, jnp.asarray(proj))))(jnp.asarray(d))
    jgrad = np.asarray(jgrad)
    assert np.abs(jgrad).max() > 0
    np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=0,
                               atol=1e-4 * np.abs(jgrad).max())


@pytest.mark.parametrize("ref_idx", [0, 2])
def test_masked_photometric_loss_matches_jax(scene, ref_idx):
    """geom_clamping 0.05 against the other views' noisy depths: the
    reprojection gate drops some pixels and keeps most; the gradient
    reaches only the reference view's depth."""
    imgs, proj, depths = scene
    rng = np.random.default_rng(ref_idx)
    noisy = (depths * (1 + 0.04 * rng.standard_normal(depths.shape))).astype(
        np.float32)
    noisy[:, ref_idx] = rigged_depth(noisy[:, ref_idx])
    got, mask = photo.masked_photometric_loss(t32(imgs), t32(noisy),
                                              t32(proj), ref_idx, 0.05)
    want, jmask = jphoto.masked_photometric_loss(
        jnp.asarray(imgs), jnp.asarray(noisy), jnp.asarray(proj), ref_idx,
        0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DSSIM_ATOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    inside = photo.get_flow_from_depthmap(t32(noisy[:, ref_idx]), t32(proj),
                                          (SH, SW), ref_idx)[0]
    inside = ((inside < 1) & (inside > -1)).all(-1)
    kept = mask.bool()
    assert (inside & ~kept).any() and kept.float().mean() > 0.3

    x = t32(noisy).requires_grad_()
    masked_mean(*photo.masked_photometric_loss(t32(imgs), x, t32(proj),
                                               ref_idx, 0.05)).backward()

    def jloss(dd):
        return jphoto.masked_mean(*jphoto.masked_photometric_loss(
            jnp.asarray(imgs), dd, jnp.asarray(proj), ref_idx, 0.05))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(noisy)))
    scale = np.abs(jgrad).max()
    assert scale > 0
    np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=0,
                               atol=1e-4 * scale)
    others = [i for i in range(3) if i != ref_idx]
    assert not x.grad[:, others].any()


def test_warped_src_views_and_training_panels_match_jax(scene):
    imgs, proj, depths = scene
    d = depths[:, 1]
    got, inside = photo.warped_src_views(t32(imgs), t32(d), t32(proj), 1)
    want, jinside = jphoto.warped_src_views(jnp.asarray(imgs), jnp.asarray(d),
                                            jnp.asarray(proj), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(inside.numpy(), np.asarray(jinside))

    s = JaxScene(num_views=3, height=SH, width=SW, seed=4)[0]
    batch = {k: s[k][None] for k in ("imgs", "K", "R", "t")}
    depth = s["depth"][None, ::2, ::2]          # upsampled to the image
    panels = training_panels({k: t32(v) for k, v in batch.items()},
                             t32(depth))
    want = jax_training_panels(batch, depth)
    assert sorted(panels) == sorted(want) == [
        "ref_img", "src_img_0", "src_img_1", "warped_ref0src_1",
        "warped_ref0src_2"]
    for k, v in want.items():
        np.testing.assert_allclose(panels[k], np.asarray(v), atol=1e-5,
                                   err_msg=k)
    # the GT depth's warps reconstruct the reference where they land
    for k in ("warped_ref0src_1", "warped_ref0src_2"):
        m = panels[k].sum(-1) > 0
        assert m.mean() > 0.5
        assert np.abs(panels[k] - panels["ref_img"])[m].mean() < 0.1


# --- train steps ------------------------------------------------------------

# arch: (views, config kwargs, port model kwargs). Vis-MVSNet takes two
# views: its JAX train forward traces for ~40 s a reference view on the
# CPU, so three views would not fit the suite's time.
CASES = {
    "mvsnet": (3, dict(num_depth=8), dict(num_depth=8)),
    "vis_mvsnet": (2, {}, {}),
    "cvp_mvsnet": (3, {}, {}),
}


def jax_weights(arch):
    if arch == "mvsnet":
        params, stats = jax_variables("mvsnet")
        return {k: v for k, v in params.items() if k != "temp"}, stats
    if arch == "vis_mvsnet":
        params, stats, _ = jax_load_npz(ASSET)
        return params, stats
    shapes = jax.eval_shape(
        lambda *a: jax_build_model("cvp_mvsnet").init(
            jax.random.PRNGKey(0), *a, train=False), *cvp_scene())
    v = fill(shapes, seed=0)
    return v["params"], v["batch_stats"]


def config_kwargs(arch):
    return dict(architecture=arch, dataset="synthetic", supervised=False,
                lr=1e-3, weight_decay=1e-4, **CASES[arch][1])


@pytest.fixture(scope="module", params=list(CASES))
def reference(request):
    """The JAX trainer's unsupervised and occlusion-masked steps on one
    batch, in float64: wildmvs/train/trainer.py:train_step's loss (both
    branches, from the same N train-mode forwards: reference 0's is also
    the unmasked step's, and its BatchNorm statistics are the ones both
    keep) under jax.vjp, then its Adam update; one jit for both.

    float64 because the JAX f32 step is the noisier side: on the MVSNet
    occlusion-masked step its gradients sit 2.8 % (median, relative L2)
    from both packages' float64 gradients, the port's f32 ones 0.1 %.
    The DSSIM window is cast to float64 with the rest (it is built f32)."""
    arch = request.param
    n = CASES[arch][0]
    params, stats = jax_weights(arch)
    nb = synthetic_batch(seed=2, n=n)
    cfg = JaxConfig(**config_kwargs(arch))
    occ_cfg = JaxConfig(**config_kwargs(arch), occ_masking=True)
    model = JT.create_model(cfg)
    window = jssim._gaussian_window
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssim, "_gaussian_window",
                   lambda k, sigma: window(k, sigma).astype(np.float64))
        p64, s64 = jax.tree_util.tree_map(
            lambda v: jnp.asarray(np.asarray(v, np.float64)), (params, stats))
        jbatch = {k: jnp.asarray(np.asarray(v, np.float64))
                  for k, v in nb.items() if k != "filename"}
        h, w = jbatch["imgs"].shape[2:4]

        def losses(p):
            variables = {"params": p, "batch_stats": s64}
            args = JT.forward_args(jbatch, cfg)
            outs = []
            for r in range(n):
                out_r, mut = model.apply(variables, *args, reference_frame=r,
                                         train=True, mutable=["batch_stats"])
                kept = mut["batch_stats"] if r == 0 else kept
                outs.append(out_r)
            unsup = JT.loss_from_outputs(outs[0], jbatch, cfg, 0)
            all_d = JT._per_scale_gather(outs, (h // cfg.output_down,
                                                w // cfg.output_down))
            occ = sum(JT.loss_from_outputs(outs[r], jbatch, occ_cfg, r,
                                           all_depthmaps=all_d)
                      for r in range(n)) / n
            return (unsup, occ), kept

        def step(p):
            (unsup, occ), vjp, kept = jax.vjp(losses, p, has_aux=True)
            one, zero = jnp.ones_like(unsup), jnp.zeros_like(unsup)
            tx = JT.make_optimizer(cfg)
            st = JT.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                               batch_stats=s64, opt_state=tx.init(p), tx=tx)
            out = {}
            for name, loss, ct in (("unsup", unsup, (one, zero)),
                                   ("occ", occ, (zero, one))):
                (g,) = vjp(ct)
                out[name] = (loss, g, st.apply_gradients(grads=g,
                                                          batch_stats=kept))
            return out
        out = jax.tree_util.tree_map(np.asarray, jax.jit(step)(p64))
    return arch, params, stats, nb, out

def bn_recorder(model):
    """Per BatchNorm call: elements per channel, the biased batch variance
    and the momentum it ran with (0 under frozen_running_stats)."""
    calls = {}

    def hook(name):
        def fn(mod, inp):
            x = inp[0].detach().float()
            dims = [0] + list(range(2, x.dim()))
            calls.setdefault(name, []).append(
                (x.numel() // x.shape[1], x.var(dims, unbiased=False),
                 mod.momentum))
        return fn
    return calls, [m.register_forward_pre_hook(hook(n))
                   for n, m in bn_modules(model).items()]


@pytest.mark.parametrize("occ", [False, True], ids=["unsup", "occ"])
def test_unsupervised_train_step_matches_jax(reference, occ):
    """One unsupervised f32 train step (occlusion-masked: every view as the
    reference, reference frames other than 0 included, the loss averaged)
    against the JAX trainer's (float64) from the same variables and batch:
    the loss, every gradient, every BatchNorm buffer after the step (JAX
    keeps the statistics of reference 0's forward) and the parameters
    after Adam."""
    arch, params, stats, nb, out = reference
    mkw = CASES[arch][2]
    cfg = TrainConfig(**config_kwargs(arch), occ_masking=occ)
    j_loss, j_grads, jstate1 = out["occ" if occ else "unsup"]
    batch = T.batch_to_device(nb, "cpu")

    model = build_model(arch, device="cpu", **mkw)
    model.load_state_dict(state_dict_from_jax(params, stats))
    state = T.create_train_state(cfg, model=model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    calls, hooks = bn_recorder(model)
    state, m = T.train_step(state, batch, cfg)
    for hk in hooks:
        hk.remove()
    loss = m["train_loss"].item()
    assert np.isfinite(loss) and loss > 0.01
    # the port's f32 rounding against float64, and a gate of the occlusion
    # mask (or CVP's median of the coarse depth) within rounding of its
    # threshold
    np.testing.assert_allclose(loss, float(j_loss), rtol=2e-4)

    want_g = {k: v.astype(np.float32)
              for k, v in jax_tree_to_port(j_grads, {}).items()}
    got_g = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got_g) == sorted(want_g)
    gmax = max(np.abs(w).max() for w in want_g.values())
    assert gmax > 0
    rel = {n: np.linalg.norm(g.numpy() - want_g[n])
           / max(np.linalg.norm(want_g[n]), 1e-4 * gmax)
           for n, g in got_g.items()}
    # relative L2, as tests/test_torch_train.py: f32 rounding grows through
    # the backward, and a ReLU input or a gate of the occlusion mask within
    # rounding of its threshold may fall on the other side
    worst = max(rel, key=rel.get)
    assert rel[worst] < 0.05, (worst, rel[worst])
    assert np.median(list(rel.values())) < 0.01, rel

    want_s = {k: v.astype(np.float32) for k, v in jax_tree_to_port(
        jstate1.params, jstate1.batch_stats).items()}
    got_s = model.state_dict()
    for name in bn_modules(model):
        seen = calls[name]
        if occ:                       # the views after 0 update nothing
            assert any(mom == 0.0 for *_, mom in seen), name
        np.testing.assert_allclose(got_s[f"{name}.running_mean"].numpy(),
                                   want_s[f"{name}.running_mean"],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        # torch adds the unbiased batch variance, flax the biased one: take
        # the difference of each updating call back out
        rv = got_s[f"{name}.running_var"].clone()
        for k, (n, var, mom) in enumerate(seen):
            later = np.prod([1 - mj for *_, mj in seen[k + 1:]])
            rv -= mom * later * var * (n / (n - 1) - 1)
        np.testing.assert_allclose(rv.numpy(), want_s[f"{name}.running_var"],
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        updates = sum(mom > 0 for *_, mom in seen)
        assert got_s[f"{name}.num_batches_tracked"].item() == updates
        assert updates > 0
    # the parameters after one Adam step (lr 1e-3, coupled L2): the first
    # step moves each by lr * e / (|e| + eps), e the gradient plus the
    # decay, which a sign change of a near-zero e flips; hold the
    # well-determined ones tightly and every one to the step's size
    for name, p in model.named_parameters():
        e = want_g[name] + cfg.weight_decay * before[name].numpy()
        diff = np.abs(p.detach().numpy() - want_s[name])
        firm = np.abs(e) > 0.1 * np.abs(e).max()
        assert diff[firm].max(initial=0.0) <= 1e-5, name
        assert diff.max() <= 2e-3 + 1e-5, name
        assert not torch.equal(p.detach(), before[name]), name


def test_occlusion_masked_eval_step_matches_jax():
    """The occlusion-masked validation loss of MVSNet (every reference
    view, running statistics, no gradient) against the JAX eval_step, and
    unlike the unmasked loss (tests/test_trainer.py's check)."""
    arch = "mvsnet"
    mkw = CASES[arch][2]
    kw = {**config_kwargs(arch), "occ_masking": True}
    jcfg, cfg = JaxConfig(**kw), TrainConfig(**kw)
    params, stats = jax_weights(arch)
    nb = synthetic_batch(seed=3)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items() if k != "filename"}
    tx = JT.make_optimizer(jcfg)
    jstate = JT.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats, opt_state=tx.init(params),
                           tx=tx)
    want = float(JT.eval_step(jstate, jbatch, jcfg)["val_loss"])

    model = build_model(arch, device="cpu", **mkw)
    model.load_state_dict(state_dict_from_jax(params, stats))
    state = T.create_train_state(cfg, model=model)
    buffers = {k: v.clone() for k, v in model.state_dict().items()}
    batch = T.batch_to_device(nb, "cpu")
    got = T.eval_step(state, batch, cfg)["val_loss"].item()
    np.testing.assert_allclose(got, want, rtol=2e-4)
    for k, v in model.state_dict().items():
        assert torch.equal(v, buffers[k]), k
    plain = T.eval_step(state, batch, TrainConfig(**{**kw,
                                                     "occ_masking": False}))
    assert got != pytest.approx(plain["val_loss"].item(), rel=1e-6)
