"""The port's MVSNet and Vis-MVSNet supervised training (wildmvs_torch/train,
losses, data) vs the JAX package's, on the CPU.

The same JAX variables (seeded, tests/test_torch_mvsnet.py `jax_variables`,
or the trained Vis asset), carried by `state_dict_from_jax`, and the same
synthetic batch go through the JAX trainer and the port's; both run f32
through the exact gather.
"""
from pathlib import Path

import dataclasses
import json

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
from wildmvs.train.checkpoint import load_params_npz as jax_load_npz
from wildmvs.train.config import TrainConfig as JaxConfig
from wildmvs_torch.data import loaders
from wildmvs_torch.data.synthetic import SyntheticMVSDataset, collate
from wildmvs_torch.infer import Predictor
from wildmvs_torch.losses import supervised as sup
from wildmvs_torch.models import build_model
from wildmvs_torch.train import cli
from wildmvs_torch.train import metrics
from wildmvs_torch.train import trainer as T
from wildmvs_torch.train.config import TrainConfig
from wildmvs_torch.train.jax_import import state_dict_from_jax
from tests.test_torch_loaders import dtu_train_root
from tests.test_torch_mvsnet import D, jax_variables

ASSET = Path(__file__).resolve().parent.parent / "assets" / \
    "vis_synth_trained.npz"

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


def test_train_mode_options_and_unported_paths(tmp_path):
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
    # remat and hyp_axis are ported (test_remat_step_equals_plain_step,
    # tests/test_torch_dist.py): the models take the sharding axis and run
    # unsharded outside a mesh
    for arch in ("mvsnet", "vis_mvsnet", "cvp_mvsnet"):
        model = T.create_model(dataclasses.replace(
            cfg, architecture=arch, hyp_axis="hyp", remat=True), "cpu")
        assert model.hyp_axis == "hyp"
    # unsupervised training runs (tests/test_torch_unsup.py holds it to
    # JAX): the photometric loss of a forward, the CLI on synthetic data
    # and on a DTU training layout read from --data_path
    model = build_model("mvsnet", device="cpu", num_depth=8)
    batch = T.batch_to_device(synthetic_batch(), "cpu")
    loss = T.loss_from_outputs(model.train()(*args), batch,
                               dataclasses.replace(cfg, supervised=False))
    assert loss.requires_grad and 0 < loss.item() < 1
    base = ["--device", "cpu", "--num_depth", "8", "--debug",
            "--num_workers", "0", "--print_every", "1"]
    hist = cli.main(base + ["--unsupervised", "--occ_masking", "--logdir",
                            str(tmp_path / "synthetic")])
    assert np.isfinite(hist["train_loss"][0] + hist["val_loss"][0])
    assert (tmp_path / "synthetic" / "e0_warped_ref0src_2.jpg").exists()
    dtu_train_root(tmp_path / "dtu", scans=tuple(int(s) for s in (
        loaders.scene_list("dtu_train") + loaders.scene_list("dtu_val"))),
        h=512, w=640)
    dtu = ["--dataset", "dtu", "--data_path", str(tmp_path / "dtu")]
    hist = cli.main(base + dtu + ["--unsupervised", "--logdir",
                                  str(tmp_path / "run")])
    assert np.isfinite(hist["train_loss"][0] + hist["val_loss"][0])
    assert set(hist["test"][0]) == {"EPE", "1pxError", "3pxError"}
    with pytest.raises(SystemExit, match="upsample_training"):
        cli.main(base + dtu)             # supervised DTU: GT is at 1/4
    # two gloo ranks on the CPU, data-parallel (a sample a rank, BatchNorm
    # synced), rank 0 logging and checkpointing
    hist = cli.main(base + ["--world_size", "2", "--dist_backend", "gloo",
                            "--batch_size", "2", "--logdir",
                            str(tmp_path / "two")])
    assert np.isfinite(hist["train_loss"][0] + hist["val_loss"][0])
    assert set(hist["test"][0]) == {"EPE", "1pxError", "3pxError"}
    assert (tmp_path / "two" / "model_000000.ckpt").exists()
    assert len((tmp_path / "two" / "logs.txt").read_text().splitlines()) == 2
    # --trace: a torch.profiler Chrome trace of the run
    cli.main(base + ["--trace", "--logdir", str(tmp_path / "trace")])
    trace = tmp_path / "trace" / "torch_trace" / "rank0.json"
    assert trace.stat().st_size > 0
    assert "traceEvents" in json.loads(trace.read_text())
    assert cfg.lr_at_epoch(13) == pytest.approx(1e-4)


@pytest.mark.parametrize("occ", [False, True], ids=["supervised", "occ"])
def test_remat_step_equals_plain_step(occ):
    """--remat recomputes each forward in the backward
    (torch.utils.checkpoint): the loss, every gradient and every BatchNorm
    buffer after one step equal the plain step's. The recomputation runs
    the train-mode BatchNorm again and must leave the running statistics
    alone (jax.checkpoint cannot update them twice); under occlusion
    masking the views after 0 leave them alone in both runs."""
    cfg = TrainConfig(dataset="synthetic", num_depth=8, supervised=not occ,
                      occ_masking=occ)
    batch = T.batch_to_device(synthetic_batch(), "cpu")
    runs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        state = T.create_train_state(c, "cpu")
        calls = []
        hook = state.model.feature.conv0.register_forward_hook(
            lambda *a: calls.append(1))
        state, m = T.train_step(state, batch, c)
        hook.remove()
        runs.append((m["train_loss"], state.model, len(calls)))
    (l0, m0, n0), (l1, m1, n1) = runs
    assert n1 == 2 * n0                     # each forward ran twice
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    for (n, p0), p1 in zip(m0.named_parameters(), m1.parameters()):
        torch.testing.assert_close(p1.grad, p0.grad, rtol=1e-6, atol=1e-9,
                                   msg=n)
    for (n, b0), b1 in zip(m0.named_buffers(), m1.buffers()):
        torch.testing.assert_close(b1, b0, rtol=1e-6, atol=0, msg=n)


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


def test_vis_train_step_matches_jax():
    """One supervised f32 Vis-MVSNet train step from the trained asset
    against the JAX trainer: the loss (three scales weighted by
    factors_loss, and the Bayesian terms of every pair), every parameter's
    gradient, and the BatchNorm running statistics (FeatExt once per view,
    Reg and UncertNet once per pair, RegFuse once per stage). Then an eval
    step and a test step, which sweeps the test-time (64, 32, 16) /
    (2, 1, 0.5) as forward kwargs, its slabs re-centred with the module's
    (4, 2, 1)."""
    params, stats, _ = jax_load_npz(ASSET)
    kw = dict(architecture="vis_mvsnet", dataset="synthetic", lr=1e-3)
    jcfg, cfg = JaxConfig(**kw), TrainConfig(**kw)
    nb = synthetic_batch(seed=2)
    n = nb["imgs"].shape[1]
    jbatch = {k: jnp.asarray(v) for k, v in nb.items() if k != "filename"}
    batch = T.batch_to_device(nb, "cpu")

    jmodel = JT.create_model(jcfg)

    def loss_fn(p):
        out, mut = jmodel.apply({"params": p, "batch_stats": stats},
                                *JT.forward_args(jbatch, jcfg),
                                reference_frame=0, train=True,
                                mutable=["batch_stats"])
        return JT.loss_from_outputs(out, jbatch, jcfg, 0), mut
    (j_loss, mut), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    model = T.create_model(cfg, "cpu")
    assert model.depth_nums == (32, 16, 8)
    assert model.interval_scales == (4.0, 2.0, 1.0)
    model.load_state_dict(state_dict_from_jax(params, stats))
    state = T.create_train_state(cfg, model=model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bn_elems, bn_calls = {}, {}

    def count(name):
        def hook(mod, inp):
            bn_elems[name] = inp[0].numel() // inp[0].shape[1]
            bn_calls[name] = bn_calls.get(name, 0) + 1
        return hook
    hooks = [m.register_forward_pre_hook(count(name))
             for name, m in bn_modules(model).items()]
    state, m = T.train_step(state, batch, cfg)
    for h in hooks:
        h.remove()

    loss = m["train_loss"].item()
    assert np.isfinite(loss) and loss > 0.1
    # f32 convolutions and gathers in other orders through three cascaded
    # stages (the loss sums 3 depth terms and 6 pair terms)
    np.testing.assert_allclose(loss, float(j_loss), rtol=2e-4)

    want_g = jax_tree_to_port(j_grads, {})
    got_g = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got_g) == sorted(want_g)
    gmax = max(np.abs(w).max() for w in want_g.values())
    rel = {}
    for name, g in got_g.items():
        want = want_g[name]
        rel[name] = (np.linalg.norm(g.numpy() - want)
                     / max(np.linalg.norm(want), 1e-4 * gmax))
    # as the MVSNet step: rounding grows through the backward to ~1e-3,
    # and a ReLU input within rounding of zero may fall on the other side
    # in the two packages: every parameter within 5 % in L2, the median
    # within 1 %
    worst = max(rel, key=rel.get)
    assert rel[worst] < 0.05, (worst, rel[worst])
    assert np.median(list(rel.values())) < 0.01, rel

    want_s = jax_tree_to_port(params, mut["batch_stats"])
    got_s = model.state_dict()
    for name, mod in bn_modules(model).items():
        k = bn_calls[name]
        expect = (n if name.startswith("feat_ext.") else
                  1 if ".reg_fuse." in name else n - 1)
        assert k == expect, (name, k)
        nel, decay = bn_elems[name], MOMENTUM ** k
        np.testing.assert_allclose(
            got_s[f"{name}.running_mean"].numpy(),
            want_s[f"{name}.running_mean"], rtol=1e-4, atol=1e-5)
        # torch's running variance takes the unbiased batch variance,
        # flax's the biased one: undo n / (n - 1) on what the step added
        rv0 = before[f"{name}.running_var"].numpy()
        rv = got_s[f"{name}.running_var"].numpy()
        biased = decay * rv0 + (rv - decay * rv0) * (nel - 1) / nel
        np.testing.assert_allclose(biased, want_s[f"{name}.running_var"],
                                   rtol=1e-4, atol=1e-6)

    # eval and test steps from the asset's variables, against JAX's (the
    # first Adam step moves a near-zero gradient's parameter by a full lr
    # either way, which the cascade's loss magnifies; the MVSNet test holds
    # the update itself)
    tx = JT.make_optimizer(jcfg)
    jstate = JT.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats, opt_state=tx.init(params),
                           tx=tx)
    model.load_state_dict(state_dict_from_jax(params, stats))
    ev = T.eval_step(state, batch, cfg)
    jev = JT.eval_step(jstate, jbatch, jcfg)
    np.testing.assert_allclose(ev["val_loss"].item(), float(jev["val_loss"]),
                               rtol=2e-3)
    seen = []
    hook = model.stage1.register_forward_pre_hook(
        lambda mod, a: seen.append((a[3], a[5].flatten()[0].item())))
    tm = T.test_step(state, batch, cfg)
    hook.remove()
    # the test-time sweep: 64 stage-1 hypotheses of 2 x (4/128) each
    assert seen[0][0] == 64
    assert seen[0][1] == pytest.approx(2.0 * 4.0 / 128)
    jtm = JT.test_step(jstate, jbatch, jcfg)
    assert sorted(tm) == sorted(jtm)
    np.testing.assert_allclose(tm["EPE"].item(), float(jtm["EPE"]),
                               rtol=2e-3)
    for k in ("1pxError", "3pxError"):
        assert abs(tm[k].item() - float(jtm[k])) <= 0.01, k


def test_vis_cli_trains_and_serves_a_checkpoint(tmp_path):
    """--architecture vis_mvsnet: one --debug epoch on the CPU writes a
    vis_mvsnet checkpoint that Predictor serves at the eval
    configuration; a bf16 step keeps f32 parameters and a finite loss."""
    hist = cli.main(["--device", "cpu", "--dataset", "synthetic",
                     "--architecture", "vis_mvsnet", "--logdir",
                     str(tmp_path), "--debug"])
    assert np.isfinite(hist["train_loss"][0])
    assert set(hist["test"][0]) == {"EPE", "1pxError", "3pxError"}
    ckpt = tmp_path / "model_000000.ckpt"
    saved = torch.load(ckpt, weights_only=True)
    assert saved["architecture"] == "vis_mvsnet"
    pred = Predictor(ckpt, device="cpu", bf16=False)
    assert pred.architecture == "vis_mvsnet"
    assert pred.model.depth_nums == (64, 32, 16)
    b = synthetic_batch()
    out = pred(b["imgs"][0], b["K"][0], b["R"][0], b["t"][0],
               b["depth_min"][0], b["depth_max"][0])
    assert out["depth"].shape == (32, 32) and np.isfinite(out["depth"]).all()
    assert out["confidence"].shape == (3, 32, 32)

    cfg = TrainConfig(architecture="vis_mvsnet", dataset="synthetic",
                      train_dtype="bfloat16")
    state = T.create_train_state(cfg, "cpu")
    state, m = T.train_step(state, T.batch_to_device(synthetic_batch(seed=3),
                                                     "cpu"), cfg)
    assert m["train_loss"].dtype == torch.float32
    assert np.isfinite(m["train_loss"].item())
    assert all(p.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in state.model.parameters())
