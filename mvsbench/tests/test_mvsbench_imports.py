"""What the run path and the reference load, in fresh processes."""
import json
import subprocess
import sys

from mvsbench import files

ROOT = str(files.ROOT)

RUN = """
import json, sys, torch
from mvsbench import files, run
cell = files.workload("mvsnet_d192.serve_512x640_n3")
cell.update(height=64, width=96, warmup_requests=1, check_requests=1)
cell["rig"] = dict(cell["rig"], focal={"64x96": 173.52})
rc = run.main(["--workload", cell["name"], "--seed", "2147483700",
               "--seconds", "0.5", "--trace", "0"],
              device=torch.device("cpu"), cell=cell)
print(json.dumps({"rc": rc, "top": sorted({m.split(".")[0]
                                           for m in sys.modules})}))
"""

REFERENCE = """
import json, sys
import mvsbench.reference.mvsnet, mvsbench.reference.vis_mvsnet
import mvsbench.reference.cvp_mvsnet
import mvsbench.reference.common, mvsbench.work
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _last_json(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_run_path_loads_neither_jax_nor_the_jax_package():
    got = _last_json(RUN)
    assert got["rc"] == 0
    assert "wildmvs_torch" in got["top"]
    assert not {"jax", "jaxlib", "flax", "wildmvs"} & set(got["top"])


def test_reference_loads_nothing_of_the_program():
    top = set(_last_json(REFERENCE))
    assert not {"wildmvs_torch", "wildmvs", "jax", "jaxlib"} & top


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from mvsbench import run
    monkeypatch.setitem(sys.modules, "wildmvs_torch_extra", sys)
    assert "wildmvs" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "wildmvs.ops", sys)
    assert run.forbidden_modules() == ["wildmvs"]


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """Without a card the run exits 2 and prints no result; in a
    directory that holds only the benchmark it does the same."""
    import shutil
    shutil.copytree(files.HERE, tmp_path / "mvsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(files.ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        out = subprocess.run(
            [sys.executable, "-m", "mvsbench.run", "--workload",
             "mvsnet_d192.serve_512x640_n3", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
        assert out.returncode != 0
        assert out.stdout.strip() == ""
