"""The benchmark's data files: BENCHMARK.json, configurations, workloads
and per-layer metric readers agree with each other."""
import json
import re

import pytest

from mvsbench import files

BENCH = files.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mvsbench"]
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    cfg = files.config(entry["name"])
    assert entry["file"] == f"mvsbench/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"] == []
    files.reference(cfg["architecture"])          # a reference exists
    assert isinstance(cfg.get("predictor", {}), dict)   # Predictor(**it)
    assert cfg.get("score_channel_axis", True) in (True, False)


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_file(entry):
    cell = files.workload(entry["name"])
    assert cell["name"] == entry["name"]
    assert cell["config"] == entry["config"]
    assert cell["traffic"] == entry["traffic"]
    assert cell["chips"] == entry["chips"] == 1
    assert cell["why"] == entry["why"] and len(entry["why"]) <= 200
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    assert cell["mode"] in ("serve", "train")
    stats = ("median", "mean", "p99")
    staged = [f"depth_{s}_itv" for s in stats] + ["score_err",
                                                   "depth_regress_itv"]
    keys = (set(staged) | {"conf_mean_abs", "conf_regress_abs"}
            | {f"{n}_stage{k}" for n in staged for k in range(1, 9)}
            if cell["mode"] == "serve" else
            {"depth_mean_itv", "depth_p99_itv", "loss_gap", "grad_gap",
             "grad_gap_median", "change_gap", "change_gap_median"})
    assert cell["limits"] and set(cell["limits"]) <= keys
    e2e = files.cell_metrics(BENCH, entry["name"], "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert files.cell_metrics(BENCH, entry["name"], "per_layer")


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(entry):
    mod = files.metric(entry["name"])
    assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES) == (
        entry["name"], entry["unit"], entry["layer"], entry["moves"])
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(entry["workloads"]) <= cells
    for cell in entry["workloads"]:             # each cell reports `moves`
        e2e = files.cell_metrics(BENCH, cell, "end_to_end")
        assert entry["moves"] in {m["name"] for m in e2e}
    if entry["name"].endswith("_roofline"):
        assert entry["unit"] == "%"
