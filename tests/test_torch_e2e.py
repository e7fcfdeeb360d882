"""The port's quality drive (wildmvs_torch/tools) and its training CLI over a
whole run, against the JAX package's, on the CPU.

(a) The CLI's trajectory: MVSNet on the synthetic set, D8, 3 epochs with
the LR milestone at epoch 2, seed 1, in line loading. The JAX CLI
(`wildmvs.train.cli.main`) runs from its own initial variables; the port's
CLI runs from the same variables, saved with the JAX package's
`save_params_npz` and read through `--loadckpt`. Each epoch's train loss,
val loss and test metrics, the final parameters and the final BatchNorm
statistics (torch's unbiased running variance brought back to flax's
biased one) are compared.
  Tolerance: the JAX run against itself with every initial parameter
  moved by one ulp (up or down at random), for ULP_SEEDS draws. A step of
  f32 rounding shifts a pre-activation across a ReLU now and then, and
  Adam's first steps move a parameter by lr whatever its gradient's size,
  so such a kick grows over a run; the port rounds differently at every
  op, so it is held to TRAJ_K times the largest drift of the draws, each
  quantity on its own. The run takes lr 1e-4: at the CLI's default 1e-3
  one ulp moves the epoch losses by up to 2 % and a milestone a whole
  epoch late stays within 3x of that; at 1e-4 the late milestone lands
  far outside the tolerance, and a test shows it
  (`test_cli_comparison_catches_a_late_milestone`).
  JAX's `create_train_state` runs flax's init op by op (about 45 s on the
  CPU); the test jits the same `model.init` with the same key and batch
  (the variables come out bitwise equal) and builds one optimizer, so the
  ulp runs reuse the first run's compiled step.
(b) Fresh training weights: every conv and transposed-conv kernel of
`create_train_state`'s model has flax's `lecun_normal` statistics: the
fan-in flax reckons for the same kernel (read off the JAX model's
parameter shapes), std within 3 % of sqrt(1 / fan_in) over each
architecture's kernels pooled (per kernel where it holds >= 20 000
values: the sample std of n draws is off by ~1/sqrt(2n)), no value beyond
2 / 0.8796 = 2.2737 sqrt(1 / fan_in); the seeded serving weights
(`init_weights`) bitwise as the He-normal rule draws them.
(c) `fusion_sensitivity.run_grid` at noise 1 interval with 5 % outliers:
the port's fusion and NN distances against the JAX tool's, point counts
equal, acc and comp within 1e-6 relative (the same arithmetic in f32 and
f64 in another order).
(d) `e2e_quality.main` on the CPU, 1 epoch of MVSNet and the oracle: the
JAX tool's keys; the oracle row equal to the JAX tool's
`reconstruct_and_score("oracle", ...)` (points equal, chamfer within 1e-6
relative).
"""
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from tools import e2e_quality as jax_e2e
from tools import fusion_sensitivity as jax_fs
from wildmvs.train import cli as jax_cli
from wildmvs.train import trainer as JT
from wildmvs.train.checkpoint import save_params, save_params_npz
from wildmvs.train.config import TrainConfig as JaxConfig
from wildmvs_torch.models import build_model
from wildmvs_torch.nn.blocks import CONVS, TRUNC_STD, conv_fan_in
from wildmvs_torch.tools import e2e_quality, fusion_sensitivity
from wildmvs_torch.train import cli
from wildmvs_torch.train import trainer as T
from wildmvs_torch.train.config import TrainConfig
from wildmvs_torch.train.jax_import import state_dict_from_jax

torch.set_num_threads(1)

TRAJ_ARGS = ["--dataset", "synthetic", "--architecture", "mvsnet",
             "--supervised", "--num_depth", "8", "--epochs", "3",
             "--lrepochs", "2:10", "--lr", "1e-4", "--seed", "1",
             "--num_workers", "0", "--print_every", "100"]
EPOCHS = 3
ULP_SEEDS = (0, 1, 2, 3)
TRAJ_K = 4.0
#: a test-set error rate is a share of pixels: one pixel of the 2 x 64 x 96
#: test pixels may sit on a threshold
ONE_PIXEL = 1.0 / (2 * 64 * 96)
MOMENTUM = 0.1                              # torch's running-stat momentum
LOG_KEYS = ("train_loss", "val_loss", "EPE", "1pxError", "3pxError")


def epoch_logs(logdir: Path) -> dict:
    """{key: [value a epoch]} and {"lr": [...]} from a CLI's logs.txt."""
    out = {}
    for line in (logdir / "logs.txt").read_text().splitlines():
        for k, v in json.loads(line).items():
            if k in LOG_KEYS or k == "lr":
                out.setdefault(k, []).append(v)
    return out


def jax_final(logdir: Path) -> dict:
    """The JAX CLI's last orbax checkpoint as port-keyed numpy arrays."""
    tree = ocp.StandardCheckpointer().restore(
        (logdir / f"model_{EPOCHS - 1:06d}").resolve())
    sd = state_dict_from_jax(jax.tree.map(np.asarray, tree["params"]),
                             jax.tree.map(np.asarray, tree["batch_stats"]))
    return {k: v.numpy() for k, v in sd.items()}


def one_ulp(tree, seed: int):
    """Every value moved by one f32 ulp, up or down at random."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        up = rng.random(a.shape) < 0.5
        return np.where(up, np.nextafter(a, np.float32(np.inf)),
                        np.nextafter(a, np.float32(-np.inf))).astype(
                            np.float32)
    return jax.tree.map(move, tree)


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """{"jax", "ulp<i>", "port"} -> (epoch logs, final state dict), and the
    initial state dict and BatchNorm element counts."""
    root = tmp_path_factory.mktemp("trajectory")
    made = {}

    def create_train_state(config, rng, sample):
        if "init" not in made:
            model = JT.create_model(config)
            v = jax.jit(lambda r, *a: model.init(r, *a, train=True))(
                rng, *JT.forward_args(sample, config))
            made["init"] = v["params"], v["batch_stats"]
            made["tx"] = JT.make_optimizer(config)
        params, stats = made["init"]
        tx = made["tx"]
        return JT.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats=stats, opt_state=tx.init(params),
                             tx=tx)

    runs = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(JT, "create_train_state", create_train_state)
    try:
        # one logdir for every JAX run: the config (a static argument of
        # the jitted steps) stays equal, so the steps compile once
        jdir = root / "jax"

        def jax_run(extra=()):
            shutil.rmtree(jdir, ignore_errors=True)
            jax_cli.main(TRAJ_ARGS + ["--logdir", str(jdir), *extra])
            return epoch_logs(jdir), jax_final(jdir)
        runs["jax"] = jax_run()
        params, stats = (jax.tree.map(np.asarray, t) for t in made["init"])
        for seed in ULP_SEEDS:
            ckpt = save_params(root / f"ulp{seed}", one_ulp(params, seed),
                               stats, "mvsnet")
            runs[f"ulp{seed}"] = jax_run(["--loadckpt", str(ckpt)])
    finally:
        mp.undo()
    npz = save_params_npz(root / "init.npz", params, stats, "mvsnet")

    def port_run(name, extra=()):
        pdir = root / name
        history = cli.main(TRAJ_ARGS + ["--logdir", str(pdir), "--device",
                                        "cpu", "--loadckpt", str(npz),
                                        *extra])
        ckpt = torch.load(pdir / f"model_{EPOCHS - 1:06d}.ckpt",
                          weights_only=True)
        return history, ckpt, (epoch_logs(pdir), {
            k: v.numpy() for k, v in ckpt["model"].items()})
    history, ckpt, runs["port"] = port_run("port")
    # a schedule fault the comparison must catch: the milestone an epoch late
    runs["late"] = port_run("late", ["--lrepochs", "3:10"])[2]
    init = {k: v.numpy() for k, v in state_dict_from_jax(params,
                                                         stats).items()}
    return runs, init, history, bn_elements(), ckpt


def bn_elements() -> dict:
    """Elements per channel of every BatchNorm's input in the run's
    forward (64x96 views, D8)."""
    from wildmvs_torch.data.synthetic import SyntheticMVSDataset, collate
    model = build_model("mvsnet", device="cpu", num_depth=8)
    cfg = TrainConfig(architecture="mvsnet", dataset="synthetic",
                      num_depth=8)
    batch = T.batch_to_device(collate([SyntheticMVSDataset(
        num_samples=1, num_views=3, seed=1)[0]]), "cpu")
    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp, name=name: seen.__setitem__(
            name, inp[0].numel() // inp[0].shape[1]))
        for name, m in model.named_modules()
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    with torch.no_grad():
        model.eval()
        model(*T.forward_args(batch, cfg))
    for h in hooks:
        h.remove()
    return seen


def drift(runs: dict, quantity, port: str = "port") -> tuple[float, float]:
    """(the port's distance from JAX, the largest ulp draw's) under
    `quantity(run, jax_run)`."""
    want = runs["jax"]
    ulp = max(quantity(runs[f"ulp{s}"], want) for s in ULP_SEEDS)
    return quantity(runs[port], want), ulp


def epoch_drift(key):
    """The largest relative difference over the epochs of one logged
    value."""
    def rel(run, jax_run):
        got, want = np.array(run[0][key]), np.array(jax_run[0][key])
        assert got.shape == want.shape == (EPOCHS,)
        return float(np.max(np.abs(got - want)
                            / np.maximum(np.abs(want), 1e-12)))
    return rel


@pytest.mark.parametrize("key", LOG_KEYS)
def test_cli_epochs_follow_jax(trajectories, key):
    """Every epoch's train loss, val loss and test metric of the port's
    CLI within TRAJ_K of the one-ulp drift of JAX's."""
    runs, _, history, _, _ = trajectories
    port, ulp = drift(runs, epoch_drift(key))
    print(f"{key}: port {port:.3g}, largest one-ulp drift {ulp:.3g}")
    floor = ONE_PIXEL if key.endswith("pxError") else 0.0
    assert port <= TRAJ_K * ulp + floor, (key, port, ulp)
    assert np.all(np.isfinite(runs["port"][0][key]))
    if key == "train_loss":
        # the port's returned history is what it logged
        np.testing.assert_allclose(history["train_loss"],
                                   runs["port"][0]["train_loss"])
        assert runs["port"][0][key][-1] < runs["port"][0][key][0]


@pytest.mark.parametrize("key", ["train_loss", "val_loss"])
def test_cli_comparison_catches_a_late_milestone(trajectories, key):
    """The comparison has the power to see a schedule fault: the port's run
    with the milestone an epoch late (--lrepochs 3:10) falls outside the
    tolerance by a margin (measured: train loss 7x, val loss 36x the
    largest ulp drift)."""
    late, ulp = drift(trajectories[0], epoch_drift(key), port="late")
    print(f"{key}: late milestone {late:.3g}, largest one-ulp drift "
          f"{ulp:.3g}")
    assert late > 1.5 * TRAJ_K * ulp, (key, late, ulp)


def test_cli_crosses_the_lr_milestone_as_jax():
    """The schedule itself, without a run: --lrepochs 2:10 at lr 1e-4
    gives 1e-4, 1e-4, 1e-5 in both packages (MultiStepLR)."""
    kw = dict(lr=1e-4, lrepochs="2:10")
    for epoch, want in enumerate((1e-4, 1e-4, 1e-5)):
        assert TrainConfig(**kw).lr_at_epoch(epoch) == pytest.approx(want)
        assert JaxConfig(**kw).lr_at_epoch(epoch) == pytest.approx(want)


def test_cli_logs_the_lr_of_each_epoch(trajectories):
    runs = trajectories[0]
    np.testing.assert_allclose(runs["port"][0]["lr"], [1e-4, 1e-4, 1e-5])
    np.testing.assert_allclose(runs["port"][0]["lr"], runs["jax"][0]["lr"])


def conv_weights(sd: dict) -> list:
    return sorted(k for k in sd if k.endswith("weight") and sd[k].ndim > 1)


def test_cli_final_parameters_follow_jax(trajectories):
    """Every conv kernel after the run: the median over the kernels of the
    relative L2 distance to JAX's within TRAJ_K of the one-ulp drift's,
    and each kernel's distance within TRAJ_K of the largest drift of any
    kernel; the run moved every kernel."""
    runs, init, _, _, ckpt = trajectories
    keys = conv_weights(runs["jax"][1])
    assert keys == conv_weights(runs["port"][1]) and len(keys) > 10

    def rel(run, jax_run):
        return np.array([np.linalg.norm(run[1][k] - jax_run[1][k])
                         / np.linalg.norm(jax_run[1][k]) for k in keys])
    for stat in (np.median, np.max):
        port, ulp = drift(runs, lambda r, j: float(stat(rel(r, j))))
        print(f"kernels' {stat.__name__} relative L2: port {port:.3g}, "
              f"largest one-ulp drift {ulp:.3g}")
        assert port <= TRAJ_K * ulp, (stat.__name__, port, ulp)
    for k in keys:
        assert np.abs(runs["port"][1][k] - init[k]).max() > 0, k
    # the checkpoint carries the optimizer's state at the last step
    steps = {int(s["step"]) for s in ckpt["optimizer"]["state"].values()}
    assert steps == {8 * EPOCHS} and ckpt["epoch"] == EPOCHS - 1


def test_cli_final_batchnorm_statistics_follow_jax(trajectories):
    """The running statistics after the run (FeatureNet's BatchNorms take
    one update a view, 3 a step; the regularizer's one a step): the means,
    and the variances brought to flax's biased update, each within TRAJ_K
    of the one-ulp drift (median over the BatchNorms of the relative L2
    distance)."""
    runs, _, _, elems, _ = trajectories
    port_sd = runs["port"][1]
    names = sorted(elems)
    assert names and all(f"{n}.running_var" in runs["jax"][1] for n in names)
    biased = {}
    for name in names:
        k = 3 if name.startswith("feature.") else 1
        updates = 8 * EPOCHS * k
        assert int(port_sd[f"{name}.num_batches_tracked"]) == updates
        n = elems[name]
        decay = (1.0 - MOMENTUM) ** updates
        rv = port_sd[f"{name}.running_var"]
        # rv = decay * 1 + sum of (1 - decay) shares of n / (n - 1) times
        # the biased batch variances: undo the factor on the added part
        biased[name] = decay + (rv - decay) * (n - 1) / n
    for stat in ("running_mean", "running_var"):
        def rel(run, jax_run, stat=stat):
            out = []
            for name in names:
                got = (biased[name] if run is runs["port"]
                       and stat == "running_var"
                       else run[1][f"{name}.{stat}"])
                want = jax_run[1][f"{name}.{stat}"]
                out.append(np.linalg.norm(got - want)
                           / np.linalg.norm(want))
            return float(np.median(out))
        port, ulp = drift(runs, rel)
        print(f"BatchNorm {stat}: port {port:.3g}, largest one-ulp drift "
              f"{ulp:.3g}")
        assert port <= TRAJ_K * ulp, (stat, port, ulp)


ARCHS = ("mvsnet", "mvsnet-s", "vis_mvsnet", "cvp_mvsnet")


def flax_fan_ins(arch: str) -> dict:
    """{port weight key: the fan-in flax reckons for that kernel} from the
    JAX training model's parameter shapes (kernel [*k, I, O]: prod of all
    but the last)."""
    from wildmvs.data.synthetic import SyntheticMVSDataset, collate
    cfg = JaxConfig(architecture=arch, dataset="synthetic", num_depth=8)
    batch = collate([SyntheticMVSDataset(num_samples=1, num_views=3,
                                         seed=1)[0]])
    batch = {k: jnp.asarray(v) for k, v in batch.items() if k != "filename"}
    model = JT.create_model(cfg)
    shapes = jax.eval_shape(
        lambda r, *a: model.init(r, *a, train=True), jax.random.PRNGKey(0),
        *JT.forward_args(batch, cfg))

    def fill(path, leaf):
        fan = np.prod(leaf.shape[:-1]) if path[-1].key == "kernel" else 0
        return np.full(leaf.shape, fan, np.float32)
    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    stats = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         shapes["batch_stats"])
    sd = state_dict_from_jax(params, stats)
    return {k: int(v.reshape(-1)[0]) for k, v in sd.items()
            if k.endswith("weight") and v.dim() > 1}


@pytest.mark.parametrize("arch", ARCHS)
def test_fresh_training_weights_are_lecun_normal(arch):
    cfg = TrainConfig(architecture=arch, dataset="synthetic", num_depth=8)
    model = T.create_train_state(cfg, "cpu").model
    fans = flax_fan_ins(arch)
    convs = {n: m for n, m in model.named_modules() if isinstance(m, CONVS)}
    assert {f"{n}.weight" for n in convs} == set(fans)
    pooled = []
    for name, m in convs.items():
        fan = conv_fan_in(m)
        assert fan == fans[f"{name}.weight"], name
        z = m.weight.detach().numpy().ravel() * np.sqrt(fan)
        assert np.abs(z).max() <= 2.0 / TRUNC_STD, name
        if z.size >= 20_000:
            assert abs(z.std() - 1.0) < 0.03, (name, z.std())
        pooled.append(z)
        if m.bias is not None:
            assert not m.bias.detach().any(), name
    z = np.concatenate(pooled)
    assert abs(z.std() - 1.0) < 0.03 and abs(z.mean()) < 0.01, z.std()
    # the cut sits at 2 of the normal's scales: values come within 1 %
    assert np.abs(z).max() > 0.99 * 2.0 / TRUNC_STD
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert not m.bias.any() and not m.running_mean.any()
            assert torch.equal(m.running_var, torch.ones_like(m.running_var))
    if arch == "mvsnet-s":
        # flax's `temp` is nn.initializers.ones (models/mvsnet.py:223)
        assert torch.equal(model.temp, torch.ones(1))
    # the draw follows the run's seed
    again = T.create_train_state(cfg, "cpu").model
    other = T.create_train_state(TrainConfig(
        architecture=arch, dataset="synthetic", num_depth=8, seed=2),
        "cpu").model
    name = next(iter(convs))
    w = convs[name].weight
    assert torch.equal(dict(again.named_modules())[name].weight, w)
    assert not torch.equal(dict(other.named_modules())[name].weight, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_weights_stay_he_normal(arch):
    """build_model's seeded weights, bitwise the He-normal draw: conv
    kernels N(0, 2 / fan_in) from a CPU generator seeded with the seed, in
    module order; create_train_state(model=...) keeps a given model's."""
    kw = {"num_depth": 8} if arch.startswith("mvsnet") else {}
    model = build_model(arch, device="cpu", seed=3, **kw)
    gen = torch.Generator().manual_seed(3)
    for m in model.modules():
        if isinstance(m, CONVS):
            w = m.weight
            deconv = isinstance(m, (torch.nn.ConvTranspose2d,
                                    torch.nn.ConvTranspose3d))
            fan_in = (w.shape[0] * w[0, 0].numel() if deconv
                      else w[0].numel())
            want = torch.randn(w.shape, generator=gen) * (2.0 / fan_in) ** 0.5
            assert torch.equal(w, want)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = TrainConfig(architecture=arch, dataset="synthetic", num_depth=8)
    T.create_train_state(cfg, model=model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.fixture(scope="module")
def jax_grid():
    return jax_fs.run_grid(sigma=1.0, outlier_frac=0.05)


def test_fusion_grid_equals_the_jax_tool(jax_grid):
    rows, n_px = fusion_sensitivity.run_grid(sigma=1.0, outlier_frac=0.05,
                                             device="cpu")
    want_rows, want_px = jax_grid
    assert n_px == want_px == 5 * 64 * 96
    assert len(rows) == len(want_rows) == 15
    for got, want in zip(rows, want_rows):
        assert got[:3] == want[:3], (got, want)
        assert got[2] >= 10
        np.testing.assert_allclose(got[3:], want[3:], rtol=1e-6)


def test_fusion_noise_helpers_equal_the_jax_tool():
    scene = e2e_quality.SyntheticSceneDataset(**e2e_quality.SCENE)
    from wildmvs.data.synthetic import SyntheticSceneDataset as JaxScene
    jscene = JaxScene(**e2e_quality.SCENE)
    for got, want in zip(
            fusion_sensitivity.noisy_scene_depths(scene, 2.0, 0.1, seed=4),
            jax_fs.noisy_scene_depths(jscene, 2.0, 0.1, seed=4)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fusion_sensitivity.gt_points(scene, 2),
                                  jax_fs.gt_points(jscene, 2))


#: the JAX tool's row keys (tools/e2e_quality.py:95-124, :157-160)
ORACLE_KEYS = ["arch", "num_points", "interval", "acc", "comp",
               "prob_threshold"]
NET_KEYS = ["arch", "num_points", "interval", "depth_epe_itv",
            "conf_median", "acc", "comp", "prob_threshold", "train_s"]


@pytest.fixture(scope="module")
def e2e_rows(tmp_path_factory):
    """The drive's rows and its --workdir."""
    work = tmp_path_factory.mktemp("e2e")
    return e2e_quality.main(["--device", "cpu", "--epochs", "1", "--archs",
                             "oracle,mvsnet", "--prob_threshold", "0.05",
                             "--workdir", str(work)]), work


def test_quality_drive_rows_have_the_jax_tool_keys(e2e_rows):
    rows, _ = e2e_rows
    assert [r["arch"] for r in rows] == ["oracle", "mvsnet"]
    oracle, net = rows
    assert list(oracle) == ORACLE_KEYS
    assert list(net) == NET_KEYS, net
    assert net["prob_threshold"] == 0.05 and net["train_s"] > 0
    assert np.isfinite(net["depth_epe_itv"]) and net["depth_epe_itv"] > 0
    assert 0.0 <= net["conf_median"] <= 1.0
    assert net["interval"] == oracle["interval"] == round(4.0 / 128, 4)


def test_quality_drive_oracle_row_equals_the_jax_tool(e2e_rows, tmp_path,
                                                       jax_grid):
    # (after jax_grid: the JAX fusion's compiled programs are reused)
    want = jax_e2e.reconstruct_and_score("oracle", None, tmp_path, 0.05)
    got = e2e_rows[0][0]
    assert list(want) == ORACLE_KEYS[:-1]
    assert got["num_points"] == want["num_points"] > 5000
    for k in ("acc", "comp"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    assert got["interval"] == want["interval"]


def test_quality_drive_keeps_what_it_trained(e2e_rows):
    """--workdir keeps DIR/train_<arch>, the CLI's logdir that the
    pipeline served, and each threshold's pipeline files."""
    _, work = e2e_rows
    logdir = work / "train_mvsnet"
    ckpt = torch.load(logdir / "model_000000.ckpt", weights_only=True)
    assert ckpt["architecture"] == "mvsnet" and ckpt["epoch"] == 0
    assert len(epoch_logs(logdir)["train_loss"]) == 1
    for arch in ("oracle", "mvsnet"):
        assert (work / "work_0.05" / "Points" / f"e2e_{arch}.ply").exists()


def test_quality_drive_thresholds_and_device(tmp_path):
    """A comma list scores one reconstruction at each threshold; the tools
    run on the card unless asked for the CPU."""
    rows = e2e_quality.main(["--device", "cpu", "--archs", "oracle",
                             "--prob_threshold", "0.05,0.5",
                             "--workdir", str(tmp_path)])
    assert [r["prob_threshold"] for r in rows] == [0.05, 0.5]
    assert rows[0] == rows[1] | {"prob_threshold": 0.05}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            e2e_quality.main(["--archs", "oracle"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fusion_sensitivity.main([])
