"""The port's MVSNet supervised training (wildmvs_torch/train, losses, data)
vs the JAX package's, on the CPU.

The same seeded JAX variables (tests/test_torch_mvsnet.py `jax_variables`,
carried by `state_dict_from_jax`) and the same synthetic batch go through
the JAX trainer and the port's; both run f32 through the exact gather.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wildmvs.data.synthetic import SyntheticMVSDataset as JaxDataset
from wildmvs.data.synthetic import collate as jax_collate
from wildmvs.losses import supervised as jax_sup
from wildmvs.train import metrics as jax_metrics
from wildmvs.train import trainer as JT
from wildmvs.train.config import TrainConfig as JaxConfig
from wildmvs_torch.data.synthetic import SyntheticMVSDataset, collate
from wildmvs_torch.infer import Predictor
from wildmvs_torch.losses import supervised as sup
from wildmvs_torch.models import build_model
from wildmvs_torch.train import cli
from wildmvs_torch.train import metrics
from wildmvs_torch.train import trainer as T
from wildmvs_torch.train.config import TrainConfig
from wildmvs_torch.train.jax_import import state_dict_from_jax
from tests.test_torch_mvsnet import D, jax_variables

torch.set_num_threads(1)

HW = (64, 64)
MOMENTUM = 0.9                  # running-statistics decay of both packages


def synthetic_batch(seed=0, n=3):
    ds = SyntheticMVSDataset(num_samples=1, num_views=n, height=HW[0],
                             width=HW[1], seed=seed)
    return collate([ds[0]])


@pytest.mark.parametrize("hw, kw", [((64, 96), {}),
                                    ((32, 64), {"num_views": 2, "seed": 5})])
def test_synthetic_dataset_and_collate_equal_jax(hw, kw):
    args = dict(num_samples=2, height=hw[0], width=hw[1], **kw)
    ours, theirs = SyntheticMVSDataset(**args), JaxDataset(**args)
    assert len(ours) == len(theirs) == 2
    got = collate([ours[i] for i in range(2)])
    want = jax_collate([theirs[i] for i in range(2)])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k == "filename":
            assert got[k] == v
        else:
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("shape, hw", [((2, 64, 96), (16, 24)),
                                       ((2, 16, 24), (64, 96)),
                                       ((1, 20, 28, 3), (20, 28)),
                                       ((1, 20, 28, 3), (10, 7))])
def test_resize_bilinear_matches_jax(shape, hw):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    want = np.asarray(jax_sup.resize_bilinear(jnp.asarray(x), hw))
    got = sup.resize_bilinear(torch.from_numpy(x), hw).numpy()
    assert got.shape == want.shape
    # the same half-pixel bilinear, edges included: f32 rounding only
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_losses_and_metrics_match_jax():
    rng = np.random.default_rng(1)
    b = synthetic_batch()
    gt, mask = b["depth"], b["mask"]
    mask[:, :9] = 0.0                        # a border the mask leaves out
    est = (gt[:, ::4, ::4] + rng.normal(0, 0.05, (1, 16, 16))).astype(
        np.float32)
    unc = rng.normal(0, 0.3, est.shape).astype(np.float32)
    interval = np.array([4.0 / 128], np.float32)
    t = {k: torch.from_numpy(v) for k, v in
         dict(gt=gt, mask=mask, est=est, unc=unc, interval=interval).items()}

    g_d, m_d = sup.downsample_gt(t["gt"], t["mask"], (16, 16))
    jg, jm = jax_sup.downsample_gt(gt, mask, (16, 16))
    np.testing.assert_allclose(g_d.numpy(), np.asarray(jg), atol=1e-6)
    # the exact == 1.0 test: equal masks, some pixels dropped at the border
    np.testing.assert_array_equal(m_d.numpy(), np.asarray(jm))
    assert 0 < m_d.sum() < m_d.numel()

    got = sup.masked_l1_interval(t["est"], g_d, m_d, t["interval"])
    want = jax_sup.masked_l1_interval(est, jg, jm, interval)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    l1 = (t["est"] - g_d).abs() / t["interval"][:, None, None]
    got = sup.bayesian_loss(l1, t["unc"], m_d)
    want = jax_sup.bayesian_loss(np.asarray(l1), unc, jm)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # an empty mask gives 0 with a graph
    x = t["est"].clone().requires_grad_()
    zero = sup.masked_mean(x, torch.zeros_like(x))
    assert zero.item() == 0.0 and zero.requires_grad

    up = sup.resize_bilinear(t["est"], HW)
    got = metrics.depth_metrics(up, t["gt"], t["mask"],
                                torch.tensor([2.0]), torch.tensor([6.0]))
    want = jax_metrics.depth_metrics(np.asarray(up), gt, mask,
                                     np.array([2.0], np.float32),
                                     np.array([6.0], np.float32))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5)
    assert 0.0 < got["1pxError"].item() < 1.0
    # an image with an empty mask gives NaN, as the reference's mean
    empty = metrics.depth_metrics(up, t["gt"], torch.zeros_like(t["mask"]),
                                  torch.tensor([2.0]), torch.tensor([6.0]))
    assert np.isnan(empty["EPE"].item())


def bn_modules(model):
    return {n: m for n, m in model.named_modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}


def jax_tree_to_port(params, stats):
    """A JAX (params, batch_stats) pair of trees -> {port key: numpy}."""
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                             jax.tree_util.tree_map(np.asarray, stats))
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def variables():
    """Seeded JAX (params, batch_stats) by architecture, made once."""
    made = {}

    def get(arch):
        if arch not in made:
            params, stats = jax_variables(arch)
            if arch == "mvsnet":
                params = {k: v for k, v in params.items() if k != "temp"}
            made[arch] = params, stats
        return made[arch]
    return get


@pytest.mark.parametrize("arch", ["mvsnet", "mvsnet-s"])
def test_train_step_matches_jax(arch, variables):
    """One supervised f32 train step, then an eval and a test step, against
    the JAX trainer from the same variables and batch: the loss, every
    parameter's gradient, the BatchNorm running statistics and the
    parameters after one Adam step."""
    params, stats = variables(arch)
    kw = dict(architecture=arch, dataset="synthetic", num_depth=D, lr=1e-3,
              weight_decay=1e-4)
    jcfg, cfg = JaxConfig(**kw), TrainConfig(**kw)
    nb = synthetic_batch(seed=2)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items() if k != "filename"}
    batch = T.batch_to_device(nb, "cpu")

    # JAX: the loss of trainer.py:221-247 under jax.value_and_grad, then
    # the optimizer step of its train_step (TrainState.apply_gradients,
    # trainer.py:249-251) with JAX's own Adam
    jmodel = JT.create_model(jcfg)

    def loss_fn(p):
        out, mut = jmodel.apply({"params": p, "batch_stats": stats},
                                *JT.forward_args(jbatch, jcfg),
                                reference_frame=0, train=True,
                                mutable=["batch_stats"])
        return JT.loss_from_outputs(out, jbatch, jcfg, 0), mut
    (j_loss, mut), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    tx = JT.make_optimizer(jcfg)
    jstate = JT.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats, opt_state=tx.init(params),
                           tx=tx)
    jstate1 = jax.jit(lambda st, g, bs: st.apply_gradients(
        grads=g, batch_stats=bs))(jstate, j_grads, mut["batch_stats"])

    model = build_model(arch, device="cpu", num_depth=D)
    model.load_state_dict(state_dict_from_jax(params, stats))
    state = T.create_train_state(cfg, model=model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bn_elems = {}                    # BN name -> elements per channel

    def count(name):
        def hook(mod, inp):
            bn_elems[name] = inp[0].numel() // inp[0].shape[1]
        return hook
    hooks = [m.register_forward_pre_hook(count(name))
             for name, m in bn_modules(model).items()]
    state, m = T.train_step(state, batch, cfg)
    for h in hooks:
        h.remove()
    assert state.step == 1 and set(m) == {"train_loss", "depth_est"}

    loss = m["train_loss"].item()
    assert np.isfinite(loss) and loss > 0.5
    # f32 convolutions and gathers in other orders (~1e-6 relative per op)
    # through 8 + 14 layers and the x60 logits
    np.testing.assert_allclose(loss, float(j_loss), rtol=2e-4)

    want_g = jax_tree_to_port(j_grads, {})
    got_g = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got_g) == sorted(want_g)
    assert all(g is not None and g.dtype == torch.float32
               for g in got_g.values())
    gmax = max(np.abs(w).max() for w in want_g.values())
    rel = {}
    for name, g in got_g.items():
        want = want_g[name]
        # relative L2 error; a gradient that vanishes in exact arithmetic
        # (the prob conv's bias: the softmax over depth ignores a shift) is
        # held to 1e-4 of the largest gradient instead
        rel[name] = (np.linalg.norm(g.numpy() - want)
                     / max(np.linalg.norm(want), 1e-4 * gmax))
    # f32 rounding (~1e-6 relative per op) grows through the backward to
    # ~1e-3. Beyond that, a pre-activation within rounding of zero may fall
    # on either side of a ReLU in the two packages and move the gradients
    # of every layer below it by that element's whole contribution (seen:
    # up to 3 % in L2 on the CPU). So: every parameter within 5 % in L2,
    # and the median parameter within 1 %
    worst = max(rel, key=rel.get)
    assert rel[worst] < 0.05, (worst, rel[worst])
    assert np.median(list(rel.values())) < 0.01, rel
    assert np.abs(want_g["feature.conv0.conv.weight"]).max() > 0.1 * gmax

    want_s = jax_tree_to_port(jstate1.params, jstate1.batch_stats)
    got_s = model.state_dict()
    for name, mod in bn_modules(model).items():
        # FeatureNet runs once per view in train mode: N updates per step
        k = batch["imgs"].shape[1] if name.startswith("feature.") else 1
        n = bn_elems[name]
        decay = MOMENTUM ** k
        np.testing.assert_allclose(
            got_s[f"{name}.running_mean"].numpy(),
            want_s[f"{name}.running_mean"], rtol=1e-4, atol=1e-5)
        # torch updates running_var with the unbiased batch variance, flax
        # with the biased one: undo n / (n - 1) on the part the step added
        rv0 = before[f"{name}.running_var"].numpy()
        rv = got_s[f"{name}.running_var"].numpy()
        biased = decay * rv0 + (rv - decay * rv0) * (n - 1) / n
        np.testing.assert_allclose(biased, want_s[f"{name}.running_var"],
                                   rtol=1e-4, atol=1e-6)
        assert got_s[f"{name}.num_batches_tracked"].item() == k

    # the parameters after one Adam step (lr 1e-3, coupled L2): the first
    # step moves each by lr * g / (|g| + eps), which a sign change of a
    # near-zero gradient flips; hold the well-determined ones tightly and
    # every one to the step's size
    for name, p in model.named_parameters():
        want_p, g = want_s[name], want_g[name]
        diff = np.abs(p.detach().numpy() - want_p)
        firm = np.abs(g) > 0.1 * np.abs(g).max()
        assert diff[firm].max(initial=0.0) <= 1e-5, name
        assert diff.max() <= 2e-3 + 1e-5, name
        assert np.abs(p.detach().numpy() - before[name].numpy()).max() > 0

    # eval and test steps from the updated state, against JAX's
    ev = T.eval_step(state, batch, cfg)
    jev = JT.eval_step(jstate1, jbatch, jcfg)
    np.testing.assert_allclose(ev["val_loss"].item(), float(jev["val_loss"]),
                               rtol=2e-3)
    assert not model.training
    tm = T.test_step(state, batch, cfg)
    jtm = JT.test_step(jstate1, jbatch, jcfg)
    assert sorted(tm) == sorted(jtm)
    np.testing.assert_allclose(tm["EPE"].item(), float(jtm["EPE"]),
                               rtol=2e-3)
    for k in ("1pxError", "3pxError"):
        # a pixel whose error sits at a threshold may land on either side
        assert abs(tm[k].item() - float(jtm[k])) <= 0.01, k


def test_bf16_training_keeps_f32_parameters():
    """train_dtype="bfloat16": bf16 convolutions under autocast, f32
    parameters, statistics, gradients and loss; the loss goes down."""
    cfg = TrainConfig(architecture="mvsnet", dataset="synthetic",
                      num_depth=8, lr=1e-3, train_dtype="bfloat16")
    state = T.create_train_state(cfg, "cpu")
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    seen = []
    hook = state.model.cost_regularization.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].dtype))
    batch = T.batch_to_device(synthetic_batch(seed=3), "cpu")
    losses = []
    for _ in range(4):
        state, m = T.train_step(state, batch, cfg)
        losses.append(m["train_loss"].item())
    hook.remove()
    assert seen[0] == torch.bfloat16                  # bf16 features
    assert m["train_loss"].dtype == torch.float32
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in state.model.parameters())
    assert all(b.dtype in (torch.float32, torch.int64)
               for b in state.model.buffers())
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_train_mode_options_and_unported_paths():
    args = [torch.from_numpy(v) for k, v in synthetic_batch().items()
            if k in ("imgs", "K", "R", "t", "depth_min", "depth_max")]
    fused = build_model("mvsnet", device="cpu", num_depth=8,
                        sweep_method="fused")
    with pytest.raises(ValueError, match="eval only"):
        fused.train()(*args)
    with torch.no_grad():
        assert fused.eval()(*args)["depth"].shape == (1, 16, 16)
    # train mode featurizes per view unless batched_bn is set
    for batched, calls in ((False, 3), (True, 1)):
        model = build_model("mvsnet", device="cpu", num_depth=8,
                            batched_bn=batched)
        n = []
        model.feature.register_forward_hook(lambda *a: n.append(1))
        assert model.resolve_sweep(torch.bfloat16, torch.device("cpu"),
                                   False) == "gather"
        model.train()(*args)
        assert len(n) == calls
    cfg = TrainConfig(dataset="synthetic", num_depth=8)
    for bad in (dict(architecture="vis_mvsnet"), dict(remat=True),
                dict(hyp_axis="hyp")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.create_model(dataclasses.replace(cfg, **bad), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.loss_from_outputs({}, {}, dataclasses.replace(
            cfg, supervised=False))
    for argv in (["--unsupervised"], ["--world_size", "2"], ["--trace"],
                 ["--dataset", "dtu", "--device", "cpu"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cli.main(argv)
    assert cfg.lr_at_epoch(13) == pytest.approx(1e-4)


def test_cli_trains_resumes_and_serves_a_checkpoint(tmp_path):
    """One --debug epoch on the CPU writes a checkpoint in the reference
    torch format; --resume continues after it; Predictor serves it."""
    base = ["--device", "cpu", "--dataset", "synthetic", "--num_depth", "8",
            "--logdir", str(tmp_path), "--debug"]
    hist = cli.main(base)
    assert np.isfinite(hist["train_loss"][0])
    assert np.isfinite(hist["val_loss"][0])
    assert set(hist["test"][0]) == {"EPE", "1pxError", "3pxError"}
    ckpt = tmp_path / "model_000000.ckpt"
    saved = torch.load(ckpt, weights_only=True)
    assert sorted(saved) == ["architecture", "epoch", "model", "optimizer"]
    assert saved["architecture"] == "mvsnet" and saved["epoch"] == 0
    log = (tmp_path / "logs.txt").read_text().splitlines()
    assert len(log) == 2 and "train_loss" in log[0] and "EPE" in log[1]

    hist = cli.main(base + ["--resume", "--epochs", "2"])
    assert len(hist["train_loss"]) == 1 and (tmp_path /
                                             "model_000001.ckpt").exists()
    with pytest.raises(ValueError, match="exclusive"):
        cli.main(base + ["--resume", "--loadckpt", str(ckpt)])

    pred = Predictor(ckpt, device="cpu", bf16=False)
    assert pred.architecture == "mvsnet"
    for k, v in saved["model"].items():
        torch.testing.assert_close(pred.model.state_dict()[k], v, rtol=0,
                                   atol=0)
    b = synthetic_batch()
    out = pred(b["imgs"][0], b["K"][0], b["R"][0], b["t"][0],
               b["depth_min"][0], b["depth_max"][0])
    assert out["depth"].shape == (16, 16) and np.isfinite(out["depth"]).all()


def test_cli_warm_starts_from_a_jax_npz(tmp_path, variables):
    from wildmvs.train.checkpoint import save_params_npz
    params, stats = variables("mvsnet")
    npz = save_params_npz(tmp_path / "w.npz", params, stats,
                          architecture="mvsnet")
    cfg = TrainConfig(dataset="synthetic", num_depth=8)
    state = T.create_train_state(cfg, "cpu")
    from wildmvs_torch.train.checkpoint import load_model_weights
    load_model_weights(npz, state.model)
    want = state_dict_from_jax(params, stats)
    for k, v in want.items():
        torch.testing.assert_close(state.model.state_dict()[k], v, rtol=0,
                                   atol=0)
    hist = cli.main(["--device", "cpu", "--num_depth", "8", "--logdir",
                     str(tmp_path / "run"), "--debug", "--loadckpt",
                     str(npz)])
    assert np.isfinite(hist["train_loss"][0])
