"""The port's benchmark (wildmvs_torch.bench) against bench.py, on the CPU.

The rigs are held bitwise to bench.py's; the MVSNet and CVP-MVSNet forwards
on those rigs to JAX's, with JAX's own `small_init` parameters carried
across by `state_dict_from_jax`, both in f32 (JAX on the CPU takes its
exact gather, and so does the port); the launch hook and the kernels'
work counts on small rigs; `main(["--device", "cpu"])` with every field
shrunk to a tiny configuration under the same keys.
"""
import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

import bench as jax_bench
from wildmvs.models import build_model as jax_build_model
from wildmvs_torch import bench
from wildmvs_torch.models import build_model
from wildmvs_torch.ops import sweep_kernels as sk
from wildmvs_torch.train.jax_import import state_dict_from_jax

torch.set_num_threads(1)

H, W, D = 64, 96, 16
#: the headline's 720 px focal length and the DTU rig's 1156.8 at 512x640,
#: scaled to 64x96's height
F_SCENE, F_DTU = 720.0 * H / 512, 1156.8 * H / 512
RANGE = bench.DEPTH_RANGE[1] - bench.DEPTH_RANGE[0]
BENCH_PY = Path(__file__).resolve().parents[1] / "bench.py"
FIELDS = bench.fields
#: small_init's probability conv, scaled so that the random MVSNet's depth
#: probabilities are peaked (as tests/test_torch_mvsnet.py's PROB_GAIN):
#: small_init's own give logits within ~1e-3 of each other, a flat softmax
#: and every depth within 0.1 of the mid-range, whatever the cost volume
PROB_GAIN = 1e4


def to_port(variables):
    v = jax.device_get(variables)
    return state_dict_from_jax(v["params"], v["batch_stats"])


@pytest.mark.parametrize("rig", ["scene", "scene_dtu"])
@pytest.mark.parametrize("shape", [(1, 3, H, W, F_SCENE),
                                   (2, 5, 32, 64, 2892.0 / 37)])
def test_rigs_equal_bench_py_bitwise(rig, shape):
    want = getattr(jax_bench, rig)(*shape)
    got = getattr(bench, rig)(*shape)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.device.type == "cpu" and g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.fixture(scope="module")
def jax_mvsnet():
    """JAX's MVSNet D16 on scene_dtu at 64x96 N3 with bench.py's
    small_init variables, the probability conv's kernel times PROB_GAIN:
    (args, variables, outputs), one compile."""
    args = jax_bench.scene_dtu(1, 3, H, W, F_DTU)
    model = jax_build_model("mvsnet", num_depth=D)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, x: x * PROB_GAIN if "'prob'" in jax.tree_util.keystr(
            path) and "kernel" in jax.tree_util.keystr(path) else x,
        jax_bench.small_init(model, args, {}))
    forward = jax.jit(lambda v, *a: model.apply(v, *a, train=False))
    return args, variables, forward(variables, *args)


def port_mvsnet(variables):
    model = build_model("mvsnet", device="cpu", num_depth=D)
    model.load_state_dict(to_port(variables))          # strict
    return model.eval()


def test_mvsnet_bench_forward_matches_jax(jax_mvsnet):
    _, variables, want = jax_mvsnet
    with torch.inference_mode():
        got = port_mvsnet(variables)(*bench.scene_dtu(1, 3, H, W, F_DTU))
    depth_j = np.asarray(want["depth"])
    conf_j = np.asarray(want["photometric_confidence"])
    assert got["depth"].shape == depth_j.shape == (1, H // 4, W // 4)
    # the network must have an opinion, or the comparison is vacuous
    # (tests/test_torch_mvsnet.py's limits, its 0.2 of a 5-unit range
    # scaled to this one)
    assert depth_j.std() > 0.2 / 5 * RANGE and conf_j.mean() > 1.25 * 4 / D
    # tests/test_torch_mvsnet.py's tolerance, 5e-3 on its 5-unit range:
    # 1e-3 of the range, and its confidence limits
    np.testing.assert_allclose(got["depth"].numpy(), depth_j,
                               atol=1e-3 * RANGE)
    conf = got["photometric_confidence"].numpy()
    close = np.abs(conf - conf_j) < 1e-3
    assert close.mean() > 0.99, close.mean()


def test_cvp_on_the_headline_rig_matches_jax():
    """CVP-MVSNet nscale 2 on bench.py's `scene` rig, whose views are
    0.1 mm apart: the refinement level's per-pixel hypothesis intervals
    come from an almost degenerate epipolar geometry. The NaN pattern of
    every level must equal JAX's, the rest within tests/test_torch_cvp.py's
    tolerances scaled from its 5-unit range to this one: 5e-5 x 102 at the
    coarse level, 5e-4 x 102 at the finer, on 98 % of pixels and 20x that
    on every pixel."""
    args = jax_bench.scene(1, 3, H, W, F_SCENE)
    model = jax_build_model("cvp_mvsnet")
    variables = jax_bench.small_init(model, args, {"nscale": 2})
    want = jax.jit(lambda v, *a: model.apply(v, *a, train=False, nscale=2))(
        variables, *args)
    port = build_model("cvp_mvsnet", device="cpu")
    port.load_state_dict(to_port(variables))
    with torch.inference_mode():
        got = port.eval()(*bench.scene(1, 3, H, W, F_SCENE), nscale=2)
    scale = RANGE / 5.0
    for i, (g, w) in enumerate(zip(got["depth_est_list"],
                                   want["depth_est_list"])):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (1, H >> i, W >> i)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        ok = ~np.isnan(w)
        atol = (5e-5 if i == 1 else 5e-4) * scale
        err = np.abs(g[ok] - w[ok])
        assert (err <= atol).mean() >= 0.98, err.max()
        assert err.max() < 20 * atol, err.max()


# --- the launch hook and the kernels' work ----------------------------

def test_on_launch_nests_and_the_cpu_launches_nothing():
    """The hook is restored on exit, also under an exception; a wrapper
    given CPU tensors takes its plain version and calls no hook."""
    seen = []
    src = torch.zeros(1, 5, 6, 8, dtype=torch.bfloat16)
    P = torch.randn(1, 3, 4, 5)
    s = torch.linspace(0.5, 2.0, 3)[None]
    with sk.on_launch(lambda *a: seen.append("outer")):
        outer = sk._launch_hook
        with pytest.raises(ZeroDivisionError), \
                sk.on_launch(lambda *a: seen.append("inner")):
            assert sk._launch_hook is not outer
            1 / 0
        assert sk._launch_hook is outer
        sk.sweep_warp(src, P, P + 3.0, s)
    assert sk._launch_hook is None and seen == []


def wrapper_inputs():
    """Each kernel's inputs in the order its wrapper hands them to an
    `on_launch` hook (sweep_kernels.py, ops/conv_head.py), on a small
    seeded rig."""
    rng = np.random.default_rng(2)
    bf = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, np.float32)).to(torch.bfloat16)
    src, ref, srcs = bf(1, 7, 9, 8), bf(1, 6, 8, 8), bf(1, 2, 7, 9, 8)
    P = torch.from_numpy(rng.standard_normal((1, 2, 3, 6, 8), np.float32))
    Q = P + 3.0
    s = torch.linspace(0.5, 2.0, 4)[None]
    P1, Q1 = P[:, 0].contiguous(), Q[:, 0].contiguous()
    vis = (sk.UNIT_SCALE, None)
    g = sk.sweep_warp_plain(src, P1, Q1, s)
    return {"sweep_warp": (src, P1, Q1, s, *vis),
            "sweep_warp_backward": (g, P1, Q1, s, (7, 9), *vis),
            "sweep_gwc": (src, ref, P1, Q1, s, *vis, sk.GWC_GROUPS),
            "fused_cost_volume": (ref, srcs, P, Q, s, torch.zeros(1),
                                  "variance"),
            "conv3d_head": (bf(1, 8, 4, 6, 8).contiguous(
                memory_format=torch.channels_last_3d), bf(1, 8, 3, 3, 3),
                None)}


#: the output shape of each kernel's plain version on wrapper_inputs
PLAIN_SHAPES = {"sweep_warp": (1, 4, 6, 8, 8),
                "sweep_warp_backward": (1, 7, 9, 8),
                "sweep_gwc": (1, 4, 6, 8, sk.GWC_GROUPS),
                "fused_cost_volume": (1, 4, 6, 8, 8),
                "conv3d_head": (1, 1, 4, 6, 8)}


@pytest.mark.parametrize("name", sorted(sk.KERNELS))
def test_plain_takes_the_hook_inputs(name):
    """sweep_kernels.PLAIN names every kernel and takes the inputs its
    wrapper hands the hook: chip_smoke.py holds each launch to
    PLAIN[name](*inputs)."""
    assert set(sk.PLAIN) == set(sk.KERNELS)
    out = sk.PLAIN[name](*wrapper_inputs()[name])
    assert tuple(out.shape) == PLAIN_SHAPES[name]


def work_cases():
    """{kernel: (its *_work on a small seeded rig, the inputs it reads,
    the output its plain version writes, the operations it must count
    from the live samples)}, C = 16, D = 4 on a 6x8 grid, 7x9 sources."""
    rng = np.random.default_rng(1)
    bf = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, np.float32)).to(torch.bfloat16)
    src, ref, srcs = bf(1, 7, 9, 16), bf(1, 6, 8, 16), bf(1, 2, 7, 9, 16)
    P = torch.from_numpy(rng.standard_normal((1, 2, 3, 6, 8), np.float32))
    Q = P + 3.0
    s = torch.linspace(0.5, 2.0, 4)[None]
    P1, Q1 = P[:, 0].contiguous(), Q[:, 0].contiguous()
    g = sk.sweep_warp_plain(src, P1, Q1, s)
    n, c = 4 * 6 * 8, 16
    return {
        "sweep_warp": (sk.warp_work(src, P1, Q1, s), (src, P1, Q1, s), g,
                       lambda live: live * c * 8 + n * 20),
        "sweep_warp_backward": (
            sk.warp_backward_work(g, P1, Q1, s, (7, 9)), (g, P1, Q1, s),
            sk.sweep_warp_backward_plain(g, P1, Q1, s, (7, 9)),
            lambda live: live * c * 8 + n * 20),
        "sweep_gwc": (sk.gwc_work(src, ref, P1, Q1, s),
                      (src, ref, P1, Q1, s),
                      sk.sweep_gwc_plain(src, ref, P1, Q1, s),
                      lambda live: live * c * 10 + n * 20),
        "fused_cost_volume": (
            sk.fused_work(ref, srcs, P, Q, s), (ref, srcs, P, Q, s),
            sk.fused_cost_volume_plain(ref, srcs, P, Q, s),
            lambda live: live * c * 8 + 2 * n * 20 + n * c * (2 * 3 + 4))}


@pytest.mark.parametrize("name", ["sweep_warp", "sweep_warp_backward",
                                  "sweep_gwc", "fused_cost_volume"])
def test_kernel_work_counts_the_outputs_the_kernels_write(name):
    """Each *_work: every input read once and the output that the kernel's
    plain version returns written once; its operations from its live
    samples, of which it finds some but not more than the samples."""
    work, inputs, out, operations = work_cases()[name]
    assert work.bytes == sk.nbytes(*inputs, out)
    views = 2 if name == "fused_cost_volume" else 1
    assert 0 < work.live_samples <= views * 4 * 6 * 8
    assert work.operations == operations(work.live_samples)


# --- main ----------------------------------------------------------------

def tiny_fields(method="auto", extras=True, evalres=True):
    """bench.fields under their own keys, each at 64x96 with few
    hypotheses, CVP at nscale 2."""
    out = []
    for f in FIELDS(method, extras, evalres):
        name, b, n, h, _, fl = f.rig
        model = dict(f.model)
        if "num_depth" in model:
            model["num_depth"] = 8
        if "depth_nums" in model:
            model["depth_nums"] = (8, 8, 4)
        forward = {**f.forward, "nscale": 2} if f.forward else {}
        out.append(dataclasses.replace(f, rig=(name, b, n, H, W, fl * H / h),
                                       model=model, forward=forward))
    return out


def bench_py_fields():
    """bench.py's record keys: its headline metric and each measure()."""
    src = BENCH_PY.read_text()
    return (re.findall(r'"metric": "(\w+)"', src),
            re.findall(r'measure\(\s*"(\w+)"', src))


def run_main(monkeypatch, capsys, fields=tiny_fields):
    monkeypatch.setattr(bench, "fields", fields)
    monkeypatch.setenv("WILDMVS_BENCH_SMOKE", "1")
    for k in ("METHOD", "EXTRAS", "EVALRES", "DEADLINE"):
        monkeypatch.delenv(f"WILDMVS_BENCH_{k}", raising=False)
    rc = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, [json.loads(line) for line in lines]


def test_main_prints_a_complete_record_after_every_field(monkeypatch,
                                                         capsys):
    rc, records = run_main(monkeypatch, capsys)
    assert rc == 0
    (headline,), keys = bench_py_fields()
    assert [f.key for f in FIELDS()] == [headline] + keys
    assert len(keys) == 9 and len(records) == 10
    last = records[-1]
    assert last["metric"] == headline and last["unit"] == "depthmaps/s"
    assert last["device"] == "cpu" and "card" not in last
    assert not [k for k in last if "vs_baseline" in k or k.endswith(
        ("_error", "_skipped"))]
    for i, rec in enumerate(records):       # one field more a line
        assert set(keys[:i]) <= set(rec) and not set(keys[i:]) & set(rec)
    for prefix, value in [("headline", last["value"])] + [
            (k, last[k]) for k in keys]:
        assert value > 0 and np.isfinite(value), prefix
        # these and no others: no cost figures (the benchmark, mvsbench,
        # reads those on the card), and no peak_gib, a device figure
        assert {k[len(prefix) + 1:] for k in last
                if k.startswith(prefix + "_")} == {
            "spread_pct", "median_ms", "launches", "finite_share"}, prefix
        assert last[f"{prefix}_launches"] == {}     # the CPU: plain paths
        assert last[f"{prefix}_finite_share"] == 1.0


def test_a_failed_field_is_recorded_and_exits_1(monkeypatch, capsys):
    def fields(*a):
        out = tiny_fields(*a)
        return [out[0], dataclasses.replace(out[1], architecture="nope")] + \
            out[2:3]
    rc, records = run_main(monkeypatch, capsys, fields)
    assert rc == 1 and len(records) == 3
    key = FIELDS()[1].key
    assert records[-1][f"{key}_error"].startswith("ValueError")
    assert key not in records[-1]
    assert records[-1][FIELDS()[2].key] > 0


def test_main_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
