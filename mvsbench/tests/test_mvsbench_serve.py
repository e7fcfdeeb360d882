"""The serving cell's capture and check on the CPU: a cascade whose levels
share one regularizer (CVP-MVSNet, configuration inline) gives one set of
numbers a level and comes out correct; MVSNet and Vis-MVSNet read what
they read before the capture kept one volume a call."""
import json

import numpy as np
import pytest
import torch

from mvsbench import check, files, run
from mvsbench.calibrate import reading
from mvsbench.serve import Capture, ServeCell

from inline_cvp import CVP_CELL, CVP_CONFIG

CPU = torch.device("cpu")
SEED = 3000000007

#: `calibrate.reading(...)["program"]` of the cells below at SEED, one
#: thread, as the harness read them before the capture kept one volume a
#: call, with each score module's last call kept and its channel axis
#: dropped (the values are of one CPU's float paths: at another thread
#: count or instruction set the last bits may differ)
PINNED = {
    "mvsnet_d192.serve_512x640_n3": {
        "depth_median_itv": 1.4686092002719056,
        "depth_mean_itv": 2.9248416623258904,
        "depth_p99_itv": 19.97169625555307,
        "depth_regress_itv": 0.0,
        "score_err": 0.06737685134532706,
        "conf_mean_abs": 0.05613585627258491,
        "conf_regress_abs": 0.0,
    },
    "vis_mvsnet_64_32_16.serve_1184x1600_n5": {
        "depth_median_itv": 0.15301776960784313,
        "depth_median_itv_stage1": 0.15301776960784313,
        "depth_mean_itv": 0.2218289244408701,
        "depth_mean_itv_stage1": 0.2218289244408701,
        "depth_p99_itv": 1.4756755514705897,
        "depth_p99_itv_stage1": 0.8484892003676459,
        "depth_regress_itv": 0.0,
        "depth_regress_itv_stage1": 0.0,
        "score_err": 0.07654159083578549,
        "score_err_stage1": 0.07654159083578549,
        "depth_median_itv_stage2": 0.11721047794117648,
        "depth_mean_itv_stage2": 0.1608879538143382,
        "depth_p99_itv_stage2": 0.722719975490197,
        "depth_regress_itv_stage2": 0.0,
        "score_err_stage2": 0.02900666221877056,
        "depth_median_itv_stage3": 0.07043504901960784,
        "depth_mean_itv_stage3": 0.18727640388837827,
        "depth_p99_itv_stage3": 1.4756755514705897,
        "depth_regress_itv_stage3": 0.0,
        "score_err_stage3": 0.038345844424595585,
        "conf_mean_abs": 0.011753234619994937,
        "conf_regress_abs": 0.0,
    },
}


def small(name, **kw):
    cell = files.workload(name)
    cell.update(height=64, width=96, warmup_requests=1, check_requests=2,
                **kw)
    cell["rig"] = dict(cell["rig"], focal={"64x96": 173.52})
    return cell


@pytest.mark.parametrize("name", sorted(PINNED))
def test_checks_are_the_ones_read_before(one_thread, name):
    got = reading(small(name), SEED, False, CPU)["program"]
    assert got == PINNED[name]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_capture_keeps_one_volume_a_stage_as_before(name):
    """Every score module of MVSNet and Vis-MVSNet runs once a request:
    the capture keeps one volume a stage, the same tensor the last-call
    hook kept, and a request starts from nothing."""
    cell = small(name)
    cfg = files.config(cell["config"])
    run_ = ServeCell(cell, cfg, files.reference(cfg["architecture"]), 7,
                     CPU)
    last = {}
    mods = dict(run_.pred.model.named_modules())
    for k in cfg["score_modules"]:
        mods[k].register_forward_hook(
            lambda _m, _a, out, k=k: last.__setitem__(k, out[0, ..., 0]))
    for _ in range(2):
        run_.one()
        scores = run_.kept[-1][1]["scores"]
        assert len(scores) == len(cfg["score_modules"])
        for got, k in zip(scores, cfg["score_modules"]):
            assert got.shape == last[k].shape and torch.equal(got, last[k])
        assert len(run_.kept[-1][1]["stages"]) == len(cfg["stage_modules"])
    run_.free_program()


def test_capture_keeps_every_call_in_order():
    """One score module called at every level yields one volume a call,
    coarsest first, without a channel axis when the configuration says
    its output has none."""
    net = torch.nn.Identity()
    cap = Capture(torch.nn.Sequential(net), [], ["0"], [],
                  score_channel_axis=False)
    vols = [torch.randn(1, d, 4, 6) for d in (96, 8, 8)]
    for v in vols:
        net(v)
    assert [tuple(s.shape) for s in cap.scores()] == [(96, 4, 6), (8, 4, 6),
                                                     (8, 4, 6)]
    assert all(torch.equal(s, v[0]) for s, v in zip(cap.scores(), vols))
    cap.reset()
    net(vols[1])
    assert len(cap.scores()) == 1


def test_cvp_cell_is_correct_with_numbers_a_level(cvp, capsys):
    rc = run.main(["--workload", CVP_CELL, "--seed", str(SEED), "--seconds",
                   "0.5", "--trace", "0"], device=CPU, cell=cvp)
    assert rc == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["correct"] is True and got["failed"] == 0
    assert set(got["checks"]) == set(cvp["limits"])


def test_cvp_runs_as_its_configuration_states(cvp):
    """Predictor takes the configuration's settings; the one score module
    yields a volume a level, coarsest first, and a set of numbers each;
    the program's earlier levels' depths are the reference's regression of
    its own score volumes, so the finest level's regression reads 0."""
    cfg = files.config(cvp["config"])
    run_ = ServeCell(cvp, cfg, files.reference(cfg["architecture"]), SEED,
                     CPU)
    for _ in range(2):
        run_.one()
    nscale = CVP_CONFIG["predictor"]["cvp_nscale"]
    got = run_.numbers()
    for k in range(1, nscale + 1):
        assert {f"score_err_stage{k}", f"depth_mean_itv_stage{k}"} <= set(got)
    assert f"score_err_stage{nscale + 1}" not in got
    assert got["depth_regress_itv"] == 0.0
    out = run_.kept[0][1]
    assert len(out["scores"]) == nscale and not out["stages"]
    assert [s.shape[0] for s in out["scores"]] == [96] + [8] * (nscale - 1)
    assert run_.reference_model().nscale == nscale
    assert run_.pred.forward_kwargs == {"nscale": nscale}
    assert run_.pred.model.sweep_method == "gather"
    run_.free_program()


def test_serve_numbers_divide_by_a_requests_own_intervals():
    d = np.zeros((2, 3))
    s = torch.zeros(4, 2, 3)
    prog = {"depths": [d, d + 1.0], "confidence": d, "scores": [s, s]}
    ref = {"depths": [d, d], "confidence": d, "scores": [s, s + 1.0]}
    own = {"depths": [d, d + 1.0], "confidence": d}
    fixed = check.serve_numbers([(prog, ref, own)], [1.0, 4.0])
    assert fixed["depth_mean_itv_stage2"] == 0.25
    mine = check.serve_numbers([(prog, dict(ref, intervals=[1.0, 0.5]),
                                 own)], [1.0, 4.0])
    assert mine["depth_mean_itv_stage2"] == 2.0
