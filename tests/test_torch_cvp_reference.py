"""The port's CVP-MVSNet served through `Predictor` against the benchmark's
plain reference (mvsbench/reference/cvp_mvsnet.py), on the CPU, at the
benchmark configuration's pyramid depth (nscale 5) with N = 3 views of
256x384 (coarsest level 16x24: at a coarsest level of 4x6 a pixel spans
hundreds of mm and the one-pixel epipolar steps swing with the last bits
of the geometry). Both take the benchmark's seeded weights
(mvsbench/weights.py); the program runs the exact "gather" sweep, in f32
and in bf16, and the reference, in f32, refines each level around the
program's own coarser depth (`centres=`), so that every level is compared
on the same hypotheses. Neither this file nor the reference imports JAX
or the JAX package."""
import numpy as np
import pytest
import torch

from mvsbench import check, files, traffic, weights
from mvsbench.serve import request_tensors
from wildmvs_torch.infer import Predictor

CPU = torch.device("cpu")
CONFIG = "cvp_mvsnet_nscale5"
H, W, N = 256, 384, 3
SEED = 3000000020
#: the reference camera of the compared request (the probe that sets the
#: BatchNorm statistics is the grid's centre, camera 24)
CAMERA = 10

#: Tolerances, a level each, in its own hypothesis interval (the request's
#: epipolar step; the coarse level's (935 - 425) / 96 mm), from readings
#: over seeds 1-8 of this rig and request (each seed its own weights and
#: images):
#: f32: both sides are f32 and sum in other orders (the variance over the
#: views, the 96-way softmax, the 3D convs): a score volume read at most
#: 2e-5 of its centred RMS off and a depth 1.2e-3 intervals, so 1e-4 and
#: 1e-2.
#: bf16: the program's extractor and regularizer round every activation
#: to 8 mantissa bits. Its score volumes read at most 0.091 off, its mean
#: depth error at most 0.81 intervals at the coarse level (96 hypotheses
#: share the softmax) and 0.118 at the finer ones. The reference computed
#: one precision lower (fp8 convolutions, bf16 soft-argmin, the benchmark's
#: control) read at least 0.245, 4.50 and 0.29 on the same seeds. The
#: limits lie between: 0.15, 2.0 and 0.2.
LIMITS = {
    torch.float32: {"score_err": 1e-4, "depth_max_itv": 1e-2},
    torch.bfloat16: {"score_err": 0.15, "depth_mean_itv": (2.0, 0.2)},
}


def rig(h: int, w: int):
    """The cell's DTU rig at h x w (the focal length scaled with the
    width)."""
    cell = files.workload(f"{CONFIG}.serve_1184x1600_n5")
    return traffic.dtu_rig(dict(cell["rig"],
                                focal={f"{h}x{w}": 2892.0 * w / 1600}), h, w)


def case(seed: int) -> tuple:
    """(the configuration, its sweep the exact gather for the CPU; the
    plain reference module; the f32 reference holding the seeded state,
    in eval mode; the state; one request). The BatchNorm statistics are
    set on a probe at half the size (a third of the time at the full
    size); the program and the reference share them either way."""
    cfg = files.config(CONFIG)
    cfg["predictor"] = dict(cfg["predictor"], sweep_method="gather")
    ref_mod = files.reference(cfg["architecture"])
    small = rig(H // 2, W // 2)
    probe = request_tensors(traffic.request(
        small, traffic.images(seed, small.cameras, H // 2, W // 2, CPU), 24,
        N), CPU)
    state, _ = weights.cell_weights(ref_mod, cfg, seed, CPU, probe)
    model = ref_mod.build(cfg)
    model.load_state_dict(state)
    full = rig(H, W)
    req = traffic.request(full, traffic.images(seed, full.cameras, H, W, CPU),
                          CAMERA, N)
    return cfg, ref_mod, model.eval(), state, req


@pytest.fixture(scope="module")
def setup():
    return case(SEED)


def served(cfg, state, req, bf16: bool) -> dict:
    """The port's request through `Predictor` as the benchmark's cell
    builds it: every level's score volume [D, h, w] (the shared
    regularizer's output, coarsest first) and depth [h, w], the returned
    depth and confidence."""
    pred = Predictor(architecture=cfg["architecture"], device="cpu",
                     bf16=bf16, **cfg["predictor"])
    pred.model.load_state_dict(state)
    scores, levels = [], []
    pred.model.cost_reg_refine.register_forward_hook(
        lambda _m, _a, out: scores.append(out[0].float()))
    pred.model.register_forward_hook(
        lambda _m, _a, out: levels.extend(
            d[0].float().numpy() for d in reversed(out["depth_est_list"])))
    out = pred(req["imgs"], req["K"], req["R"], req["t"], req["depth_min"],
               req["depth_max"])
    return dict(out, scores=scores, depths=levels)


def test_the_configuration_serves_the_published_pyramid(setup):
    cfg, ref_mod, model, _, _ = setup
    assert cfg["predictor"]["cvp_nscale"] == model.nscale == 5
    assert files.config(CONFIG)["predictor"]["sweep_method"] == "fused"
    assert cfg["reduced"] == []


@torch.no_grad()
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_port_matches_the_reference_level_by_level(setup, dtype):
    cfg, ref_mod, model, state, req = setup
    got = served(cfg, state, req, bf16=dtype == torch.bfloat16)
    nscale = cfg["predictor"]["cvp_nscale"]
    assert len(got["scores"]) == len(got["depths"]) == nscale
    np.testing.assert_array_equal(got["depths"][-1], got["depth"])
    x = request_tensors(req, CPU)
    with torch.no_grad():
        mine = ref_mod.serve(model, x, centres=got["depths"][:-1])
    assert [s.shape[0] for s in got["scores"]] == [96] + [8] * (nscale - 1)
    limits = LIMITS[dtype]
    for k in range(nscale):
        itv = mine["intervals"][k]
        e = np.abs(got["depths"][k] - mine["depths"][k]) / itv
        err = check.score_err(got["scores"][k], mine["scores"][k])
        assert err < limits["score_err"], (k, err)
        if dtype == torch.float32:
            assert e.max() < limits["depth_max_itv"], (k, e.max())
        else:
            coarse, fine = limits["depth_mean_itv"]
            assert e.mean() < (coarse if k == 0 else fine), (k, e.mean())
    # the returned confidence is the finest level's, from its own volume
    own = ref_mod.regress_scores(cfg, x, got["scores"], got["depths"][:-1])
    assert np.abs(got["confidence"] - own["confidence"]).max() < 1e-5
