"""The port's CasMVSNet (models/cas_mvsnet.py) on the CPU: served through
`Predictor` against the benchmark's plain reference
(mvsbench/reference/cas_mvsnet.py) at the published 48/32/8 hypotheses and
widths, with the benchmark's seeded weights (mvsbench/weights.py), on a
64x96 request of N = 3 views of the benchmark's DTU rig; the hypotheses
against the hand formula and cascade-stereo's trilinear resize; the FPN's
shapes; MVSNet's CostRegNet keys unchanged; the architecture in the
normal path; the trace spans; and the benchmark's readers of the cell.
Neither this file nor the reference imports JAX or the JAX package."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile, record_function

from mvsbench import check, files, traffic, weights
from mvsbench.reference import cas_mvsnet as ref_cas
from mvsbench.serve import request_tensors
from mvsbench.trace import Trace
from wildmvs_torch.infer import Predictor
from wildmvs_torch.models import build_model
from wildmvs_torch.models.cas_mvsnet import (INTERVAL_RATIOS, NDEPTHS,
                                             SPAN, FPNFeatureNet,
                                             stage_hypotheses)
from wildmvs_torch.models.mvsnet import MVSNet
from wildmvs_torch.pipeline.depthmaps import eval_model_kwargs, run_depthmaps

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
CONFIG = "cas_mvsnet_48_32_8"
CELL = f"{CONFIG}.serve_1184x1600_n5"
H, W, N = 64, 96, 3
SEED = 3000000024
#: the reference camera of the compared request (the probe that sets the
#: BatchNorm statistics is the grid's centre, camera 24)
CAMERA = 10

#: Tolerances, in each stage's hypothesis spacing (10.85, 5.48 and 3.04 mm
#: on the rig), from readings over seeds 1-8 of this rig and request (each
#: seed its own weights and images):
#: f32: both sides are f32 and sum in other orders (the variance over the
#: views, the softmax, the 3D convs; the port resizes a stage's centre
#: where the reference resizes its samples): a score volume read at most
#: 1e-5 of its centred RMS off and a depth's 99th percentile 1.2e-4 of a
#: spacing, so 1e-4 and, on the largest error, 1e-2.
#: bf16: the program's features and regularizers round every activation to
#: 8 mantissa bits. Its score volumes read at most 0.100, 0.080, 0.064 off
#: and its mean depth errors at most 0.69, 0.35, 0.10 spacings (stages 1-3);
#: the reference one precision lower (fp8 convolutions, bf16 soft-argmin:
#: the benchmark's control) read at least 0.58, 0.52, 0.47 and 4.2, 2.5,
#: 0.77 on the same seeds. The limits lie between.
LIMITS = {
    torch.float32: {"score_err": (1e-4,) * 3, "depth_max_itv": (1e-2,) * 3},
    torch.bfloat16: {"score_err": (0.3, 0.3, 0.25),
                     "depth_mean_itv": (2.0, 1.2, 0.35)},
}


def rig(h: int, w: int):
    """The cell's DTU rig at h x w (the focal length scaled with the
    width)."""
    cell = files.workload(CELL)
    return traffic.dtu_rig(dict(cell["rig"],
                                focal={f"{h}x{w}": 2892.0 * w / 1600}), h, w)


def case(seed: int) -> tuple:
    """(the configuration; the f32 reference holding the seeded state, in
    eval mode; the state; one request). The BatchNorm statistics are set on
    the grid centre's request of the same size. `Predictor` builds the
    configuration's default sweep, "auto": the exact gather on the CPU."""
    cfg = files.config(CONFIG)
    r = rig(H, W)
    imgs = traffic.images(seed, r.cameras, H, W, CPU)
    probe = request_tensors(traffic.request(r, imgs, 24, N), CPU)
    state, _ = weights.cell_weights(ref_cas, cfg, seed, CPU, probe)
    model = ref_cas.build(cfg)
    model.load_state_dict(state)
    return cfg, model.eval(), state, traffic.request(r, imgs, CAMERA, N)


@pytest.fixture(scope="module")
def setup():
    return case(SEED)


def served(cfg, state, req, bf16: bool) -> dict:
    """The port's request through `Predictor` as the benchmark's cell
    builds it: every stage's score volume [D, h, w] (its regularizer's
    output, coarsest first) and depth [h, w], the returned depth and
    confidence."""
    pred = Predictor(architecture=cfg["architecture"], device="cpu",
                     bf16=bf16, **cfg.get("predictor", {}))
    pred.model.load_state_dict(state)
    scores, stages = [], []
    for name in cfg["score_modules"]:
        pred.model.get_submodule(name).register_forward_hook(
            lambda _m, _a, out: scores.append(out[0, ..., 0].float()))
    pred.model.register_forward_hook(
        lambda _m, _a, out: stages.extend(
            d[0].float().numpy() for d in reversed(out["depth_est_list"])))
    out = pred(req["imgs"], req["K"], req["R"], req["t"], req["depth_min"],
               req["depth_max"])
    return dict(out, scores=scores, depths=stages)


def test_the_configuration_serves_the_published_stages(setup):
    cfg, model, _, _ = setup
    assert cfg["ndepths"] == [48, 32, 8] == list(NDEPTHS)
    assert cfg["depth_interval_ratios"] == [4.0, 2.0, 1.0] == list(
        INTERVAL_RATIOS)
    assert model.ndepths == tuple(NDEPTHS)
    # the cell serves the default sweep, "auto": the exact fused kernel on
    # the card in bf16, the exact gather here
    assert "predictor" not in cfg
    assert cfg["reduced"] == []
    pred = Predictor(architecture="cas_mvsnet", device="cpu")
    assert set(pred.model.state_dict()) == set(model.state_dict())


@torch.no_grad()
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_port_matches_the_reference_stage_by_stage(setup, dtype):
    cfg, model, state, req = setup
    got = served(cfg, state, req, bf16=dtype == torch.bfloat16)
    assert [s.shape for s in got["scores"]] == [
        (48, H // 4, W // 4), (32, H // 2, W // 2), (8, H, W)]
    np.testing.assert_array_equal(got["depths"][-1], got["depth"])
    x = request_tensors(req, CPU)
    mine = ref_cas.serve(model, x, centres=got["depths"][:-1])
    itvs = ref_cas.intervals(cfg, 425.0, 935.0)
    limits = LIMITS[dtype]
    for k in range(3):
        e = np.abs(got["depths"][k] - mine["depths"][k]) / itvs[k]
        err = check.score_err(got["scores"][k], mine["scores"][k])
        assert err < limits["score_err"][k], (k, err)
        if dtype == torch.float32:
            assert e.max() < limits["depth_max_itv"][k], (k, e.max())
        else:
            assert e.mean() < limits["depth_mean_itv"][k], (k, e.mean())
    # the returned depth and confidence are stage 3's, from its own volume
    own = ref_cas.regress_scores(cfg, x, got["scores"], got["depths"][:-1])
    assert np.abs(got["confidence"] - own["confidence"]).max() < 1e-5
    assert (np.abs(got["depth"] - own["depths"][-1]).max() / itvs[-1]
            < 1e-3)


def test_the_fp8_control_misses_the_bf16_limits(setup):
    """The tolerances above are tight enough that the reference one
    precision lower (the benchmark's control) fails them."""
    cfg, model, _, req = setup
    from mvsbench.reference.common import fp8_control
    ctl = fp8_control(model)
    ctl.regress_dtype = torch.bfloat16
    x = request_tensors(req, CPU)
    c = ref_cas.serve(ctl, x)
    mine = ref_cas.serve(model, x, centres=c["depths"][:-1])
    itvs = ref_cas.intervals(cfg, 425.0, 935.0)
    limits = LIMITS[torch.bfloat16]
    missed = [k for k in range(3)
              if check.score_err(c["scores"][k], mine["scores"][k])
              >= limits["score_err"][k]
              or (np.abs(c["depths"][k] - mine["depths"][k]) / itvs[k]).mean()
              >= limits["depth_mean_itv"][k]]
    assert missed == [0, 1, 2]


@pytest.mark.parametrize("stage,ndepth,ratio", [(2, 32, 2.0), (3, 8, 1.0)])
def test_hypotheses_follow_the_hand_formula(stage, ndepth, ratio):
    """s_j = d^ - (D/2) r delta + j D r delta / (D - 1) around the coarser
    depth d^ upsampled bilinearly to the image, resized trilinearly to the
    stage (align_corners False): the port's resize of d^ alone gives
    cascade-stereo's resize of the samples, which the reference builds at
    the image's size, to f32 rounding."""
    g = torch.Generator().manual_seed(stage)
    hw = (32, 64)
    prev_hw = (hw[0] >> (4 - stage), hw[1] >> (4 - stage))
    stage_hw = (hw[0] >> (3 - stage), hw[1] >> (3 - stage))
    prev = 600.0 + 200.0 * torch.rand((2,) + prev_hw, generator=g)
    dmin = torch.tensor([425.0, 300.0])
    dmax = torch.tensor([935.0, 1000.0])
    delta = (dmax - dmin) / 192
    got = stage_hypotheses(prev, hw, stage_hw, ndepth, ratio, delta)
    assert got.shape == (2, ndepth) + stage_hw

    cur = F.interpolate(prev[:, None].double(), size=hw, mode="bilinear",
                        align_corners=False)[:, 0]
    j = torch.arange(ndepth, dtype=torch.float64).reshape(1, -1, 1, 1)
    step = (ratio * delta.double())[:, None, None, None]
    hand = (cur[:, None] - ndepth / 2 * step
            + j * ndepth * step / (ndepth - 1))
    hand = F.interpolate(hand[:, None], size=(ndepth,) + stage_hw,
                         mode="trilinear", align_corners=False)[:, 0]
    np.testing.assert_allclose(got.double(), hand, rtol=0, atol=2e-4)

    x = {"imgs": torch.zeros((2, 3) + hw + (3,)), "K": torch.eye(3).expand(
        2, 3, 3, 3), "R": torch.eye(3).expand(2, 3, 3, 3),
        "t": torch.zeros(2, 3, 3, 1), "depth_min": dmin[:, None].expand(2, 3),
        "depth_max": dmax[:, None].expand(2, 3)}
    geo = ref_cas.Cascade(x, (48, 32, 8), (4.0, 2.0, 1.0))
    plain = geo.hypotheses(stage - 1, prev)
    np.testing.assert_allclose(plain.double(), hand, rtol=0, atol=2e-4)
    # stage 1: 48 planes from min to max
    np.testing.assert_allclose(geo.planes()[:, [0, -1]], torch.stack(
        [dmin, dmax], 1), rtol=1e-6)


def test_fpn_gives_three_stages_at_32_16_8_channels():
    net = FPNFeatureNet()
    assert net.out_channels == (32, 16, 8)
    feats = net(torch.rand(2, 64, 96, 3))
    assert [tuple(f.shape) for f in feats] == [
        (2, 16, 24, 32), (2, 32, 48, 16), (2, 64, 96, 8)]
    assert not any(getattr(net, m).bias is not None
                   for m in ("out1", "out2", "out3"))
    assert net.inner1.bias is not None and net.inner2.bias is not None


def test_cost_regnet_keeps_mvsnet_keys():
    """The score head's bias is a keyword whose default holds: MVSNet's
    checkpoints and its `logit_gain` name load as before; CasMVSNet's
    three heads have no bias."""
    keys = set(MVSNet(num_depth=8).state_dict())
    assert {"cost_regularization.prob.weight",
            "cost_regularization.prob.bias"} <= keys
    cas = build_model("cas_mvsnet", device="cpu")
    heads = {k for k in cas.state_dict() if ".prob." in k}
    assert heads == {f"cost_regularization.{k}.prob.weight"
                     for k in range(3)}
    gains = files.config(CONFIG)["logit_gain"]
    assert set(gains) <= {n for n, _ in cas.named_modules()}
    mvsnet_gains = files.config("mvsnet_d192")["logit_gain"]
    assert set(mvsnet_gains) <= {n for n, _ in MVSNet().named_modules()}


def test_normal_path_accepts_the_architecture(tmp_path):
    cfg = eval_model_kwargs("cas_mvsnet")
    assert cfg == {"kwargs": {"dtype": torch.bfloat16}, "downscale": 1}
    assert eval_model_kwargs("cas_mvsnet", bf16=False,
                             sweep_method="fused")["kwargs"] == {
        "sweep_method": "fused"}
    model = build_model("cas_mvsnet", device="cpu", **cfg["kwargs"]).eval()
    assert model.resolve_sweep(torch.bfloat16, CPU) == "gather"
    assert model.resolve_sweep(torch.bfloat16,
                               torch.device("cuda")) == "fused"
    assert model.resolve_sweep(torch.float32,
                               torch.device("cuda")) == "gather"
    with pytest.raises(ValueError, match="sweep_method"):
        build_model("cas_mvsnet", device="cpu", sweep_method="rect")
    x = torch.rand(1, 64, 96, 3)
    cams = [torch.eye(3)[None, None].expand(1, 2, 3, 3)] * 2 + [
        torch.zeros(1, 2, 3, 1), torch.full((1, 2), 5.0),
        torch.full((1, 2), 9.0)]
    with pytest.raises(ValueError, match="one size"):
        model([x, torch.rand(1, 96, 128, 3)], *cams)
    with pytest.raises(ValueError, match="/32"):
        model(torch.rand(1, 2, 48, 96, 3), *cams)
    # run_depthmaps writes the full-resolution depth and confidence
    r = rig(H, W)
    req = traffic.request(r, traffic.images(1, r.cameras, H, W, CPU), 3, N)
    sample = dict(req, imgs=np.stack(req["imgs"]), filename="scan1/v3")
    run_depthmaps([sample], model, tmp_path, debug=True)
    out = np.load(tmp_path / "scan1_v3_out.npz")
    assert out["depthmap"].shape == out["probability"].shape == (H, W)
    assert np.isfinite(out["depthmap"]).all()


def test_stages_record_in_call_order():
    """One request records `features`, then per stage, the coarsest first,
    its hypotheses, sweep, regularize and regress, each once, inside
    `Predictor.forward`; a module call (recorded as a range by forward
    hooks) lies inside a `.regularize` span exactly when it is one of the
    three CostRegNets or inside one, stage k's inside `stage<k>`'s."""
    pred = Predictor(architecture="cas_mvsnet", device="cpu", bf16=False)
    stack, handles = [], []
    for name, m in pred.model.named_modules():
        if not name:
            continue

        def pre(_m, _a, name=name):
            stack.append(record_function(f"module:{name}"))
            stack[-1].__enter__()

        def post(_m, _a, _o):
            stack.pop().__exit__(None, None, None)

        handles += [m.register_forward_pre_hook(pre),
                    m.register_forward_hook(post)]
    r = rig(H, W)
    req = traffic.request(r, traffic.images(2, r.cameras, H, W, CPU), 5, N)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pred(req["imgs"], req["K"], req["R"], req["t"],
                 req["depth_min"], req["depth_max"])
    finally:
        for h in handles:
            h.remove()
    events = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events())
    cas = [s for s in events if s[2].startswith(SPAN + ".")]
    assert [s[2].removeprefix(SPAN + ".") for s in cas] == ["features"] + [
        f"stage{k}.{p}" for k in (1, 2, 3)
        for p in ("hypotheses", "sweep", "regularize", "regress")]
    [forward] = [s for s in events
                 if s[2] == "wildmvs_torch.Predictor.forward"]
    assert all(forward[0] <= a and b <= forward[1] for a, b, _ in cas)
    assert all(a[1] <= b[0] for a, b in zip(cas, cas[1:]))
    regs = {s[2]: s for s in cas if s[2].endswith(".regularize")}
    for a, b, name in events:
        if not name.startswith("module:"):
            continue
        name = name.removeprefix("module:")
        inside = [r for r, (lo, hi, _) in regs.items() if lo <= a and b <= hi]
        if name.startswith("cost_regularization."):
            k = int(name.split(".")[1]) + 1
            assert inside == [f"{SPAN}.stage{k}.regularize"], name
        else:
            assert inside == [], name


CAS_IDLE = files.metric("cas_stage_idle_ms.serve")


def trace_with(gaps: dict, units: int = 2) -> Trace:
    return Trace(window_s=1.0, busy_s=0.5, units=units, device_ops={},
                 memcpy_s=0.0, kernels=[], idle_gaps=gaps)


def test_stage_idle_reader_sums_the_stage_gaps_a_request():
    tr = trace_with({SPAN + ".features": 1e-3,
                     SPAN + ".stage2.hypotheses": 2e-3,
                     SPAN + ".stage3.regress": 3e-3,
                     "wildmvs_torch.cvp_mvsnet.level1.sweep": 4e-3,
                     "wildmvs_torch.Predictor.prepare": 4e-3,
                     "aten::conv3d": 6e-3})
    assert CAS_IDLE.read(tr) == pytest.approx(3.0)


@pytest.mark.parametrize("gaps", [
    {}, {"wildmvs_torch.Predictor.forward": 1e-3, "aten::copy_": 1e-3}])
def test_stage_idle_reader_reads_none_without_cas_spans(gaps):
    assert CAS_IDLE.read(trace_with(gaps)) is None


def test_serve_jobs_count_three_launches_within_their_bounds():
    """The fused kernel's jobs of a request: one a stage at its own width
    and grid; the later stages' live samples counted from below, so never
    above every sample of the grid."""
    cfg = files.config(CONFIG)
    r = rig(H, W)
    x = request_tensors(traffic.request(
        r, traffic.images(3, r.cameras, H, W, CPU), CAMERA, N), CPU)
    jobs = ref_cas.serve_jobs(cfg, x)["fused_cost_volume"]
    assert len(jobs) == 3
    for job, c, d, (h, w) in zip(jobs, (32, 16, 8), (48, 32, 8),
                                 ((16, 24), (32, 48), (64, 96))):
        n = d * h * w
        full = (N - 1) * n * c * 8 + n * c * ((N - 1) * 3 + 4)
        assert n * c * ((N - 1) * 3 + 4) < job.operations <= full
        assert job.bytes == (N * h * w + n) * c * 2


@torch.no_grad()
def test_chip_smoke_records_each_stage_of_a_request(setup):
    """chip_smoke.record_cas_stages (the card run's per-stage checks) keeps
    each stage's inputs, backend and volume in call order, and its undo
    restores the sweep: each recorded volume is the sweep of the recorded
    inputs, bit for bit."""
    import chip_smoke
    from wildmvs_torch.models import cas_mvsnet as cas_module
    cfg, _, state, req = setup
    real = cas_module.sweep_cost_volume
    stages = []
    undo = chip_smoke.record_cas_stages(stages)
    try:
        served(cfg, state, req, bf16=False)
    finally:
        undo()
    assert cas_module.sweep_cost_volume is real
    assert [st["method"] for st in stages] == ["gather"] * 3
    assert [tuple(st["hyp"].shape) for st in stages] == [
        (1, 48), (1, 32, H // 2, W // 2), (1, 8, H, W)]
    assert [st["ref"].shape[-1] for st in stages] == [32, 16, 8]
    for st in stages:
        assert len(st["srcs"]) == len(st["src_projs"]) == N - 1
        assert torch.equal(real(st["ref"], st["srcs"], st["src_projs"],
                                st["ref_proj"], st["hyp"], "gather"),
                           st["cv"])


def test_reference_imports_nothing_of_the_program():
    """The plain reference, in a fresh process, loads neither the measured
    program nor JAX or the JAX package."""
    code = ("import sys, mvsbench.reference.cas_mvsnet; print(sorted("
            "{m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', "
            "'flax', 'wildmvs', 'wildmvs_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "[]"
