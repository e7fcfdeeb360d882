"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card (the CPU, a small image
size) and drives the rest of a run with one fault that the cell can
have planted in the program: a depthmap altered where it is produced
(serving), a step that leaves the state unchanged (training). Batch 1
and one card leave no half batch and no exchange between cards to
break."""
import json

import pytest
import torch

from mvsbench import files, run

from inline_cvp import CVP_CELL

CPU = torch.device("cpu")


def small(name, **kw):
    cell = files.workload(name)
    cell.update(height=64, width=96, **kw)
    cell["rig"] = dict(cell["rig"], focal={"64x96": 173.52})
    return cell


def result(capsys, name, cell):
    rc = run.main(["--workload", name, "--seed", "3000000007", "--seconds",
                   "0.5", "--trace", "0"], device=CPU, cell=cell)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name,module", [
    ("mvsnet_d192.serve_512x640_n3", "mvsnet.MVSNet"),
    ("vis_mvsnet_64_32_16.serve_1184x1600_n5", "vis_mvsnet.SingleStage"),
    (CVP_CELL, "cvp_mvsnet.CVPMVSNet")])
def test_altered_depth_is_not_correct(request, monkeypatch, capsys, name,
                                      module):
    """The depth altered where it is produced: a quarter of the rows of
    MVSNet's depthmap, of each of Vis-MVSNet's stage depths, and of
    CVP-MVSNet's finest depth."""
    import importlib
    path, cls_name = module.split(".")
    cls = getattr(importlib.import_module(f"wildmvs_torch.models.{path}"),
                  cls_name)
    forward = cls.forward

    def altered(self, *a, **k):
        out = forward(self, *a, **k)
        d = (out["depth"] if isinstance(out, dict) else out[0]).clone()
        rows = d.shape[1] // 4
        d[:, :rows] += 200.0                     # mm: tens of intervals
        return dict(out, depth=d) if isinstance(out, dict) else (d,) + out[1:]

    monkeypatch.setattr(cls, "forward", altered)
    cell = (request.getfixturevalue("cvp") if name == CVP_CELL
            else small(name, warmup_requests=1, check_requests=2))
    got = result(capsys, name, cell)
    assert got["correct"] is False
    assert any(v["value"] > v["limit"] for v in got["checks"].values())


def test_unchanged_state_is_not_correct(monkeypatch, capsys):
    name = "mvsnet_d192.train_512x640_n3"
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    got = result(capsys, name, small(name, pool=4))
    assert got["correct"] is False
    assert got["checks"]["change_gap_median"]["value"] > 0.9
