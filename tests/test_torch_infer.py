"""The port's serving entry points (Predictor, run_depthmaps) vs the JAX
package's, on the CPU, plus the port's isolation from JAX."""
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wildmvs.infer import Predictor as JaxPredictor
from wildmvs.models.mvsnet import MVSNet as JaxMVSNet
from wildmvs.pipeline.depthmaps import get_mask_invalid as jax_mask_invalid
from wildmvs.train.checkpoint import save_params_npz
from wildmvs_torch import infer
from wildmvs_torch.infer import Predictor, _stage, staging_stats
from wildmvs_torch.models import build_model
from wildmvs_torch.pipeline.depthmaps import (eval_model_kwargs,
                                              get_mask_invalid, run_depthmaps)
from tests.test_torch_mvsnet import jax_variables, scene

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def variance_weights():
    params, stats = jax_variables()
    return {k: v for k, v in params.items() if k != "temp"}, stats


@pytest.fixture
def npz_checkpoint(tmp_path, variance_weights):
    params, stats = variance_weights
    return save_params_npz(tmp_path / "mvsnet.npz", params, stats,
                           architecture="mvsnet")


def unbatched(seed=0):
    imgs, K, R, t, dmin, dmax = scene(seed)
    return imgs[0], K[0], R[0], t[0], dmin[0], dmax[0]


def test_predictor_matches_jax_predictor(npz_checkpoint, variance_weights,
                                         monkeypatch):
    params, stats = variance_weights
    # the JAX Predictor initializes its own weights; hand it these instead
    # (its eager init would take a minute on this host)
    variables = {"params": params, "batch_stats": stats}
    monkeypatch.setattr(JaxMVSNet, "init",
                        lambda self, *a, **k: variables)
    jpred = JaxPredictor(architecture="mvsnet", bf16=False)
    pred = Predictor(npz_checkpoint, device="cpu", bf16=False)
    assert pred.architecture == "mvsnet" and pred.downscale == 4
    args = unbatched()
    want = jpred(*args)
    got = pred(*args)
    assert got["depth"].dtype == np.float32
    assert got["depth"].shape == want["depth"].shape == (16, 24)
    # the same f32 forward as tests/test_torch_mvsnet.py
    np.testing.assert_allclose(got["depth"], want["depth"], atol=5e-3)
    close = np.abs(got["confidence"] - want["confidence"]) < 1e-3
    assert close.mean() > 0.99


def test_predictor_crops_and_batches(npz_checkpoint):
    pred = Predictor(npz_checkpoint, device="cpu", bf16=False)
    imgs, K, R, t, dmin, dmax = unbatched()
    base = pred(imgs, K, R, t, dmin, dmax)
    # a non-/32 input is cropped from the top-left (K unchanged)
    padded = np.pad(imgs, ((0, 0), (0, 7), (0, 13), (0, 0)))
    cropped = pred(padded, K, R, t, dmin, dmax)
    np.testing.assert_array_equal(cropped["depth"], base["depth"])
    # batched input, scalar depth range, and a list of per-view arrays
    two = pred(np.stack([imgs, imgs]), np.stack([K, K]), np.stack([R, R]),
               np.stack([t, t]), 5.0, 10.0)
    assert two["depth"].shape == (2, 16, 24)
    np.testing.assert_allclose(two["depth"][1], base["depth"], atol=1e-5)
    listed = pred(list(imgs), K, R, t, dmin, dmax)
    np.testing.assert_array_equal(listed["depth"], base["depth"])
    with pytest.raises(ValueError, match="too small"):
        pred(imgs[:, :16, :16], K, R, t, dmin, dmax)


def test_predictor_ragged_views(npz_checkpoint):
    pred = Predictor(npz_checkpoint, device="cpu", bf16=False)
    imgs, K, R, t, dmin, dmax = unbatched()
    views = [imgs[0], imgs[1, :, :70], imgs[2, :40]]     # cropped to /32
    out = pred(views, K, R, t, dmin, dmax)
    assert out["depth"].shape == (16, 24)
    assert np.isfinite(out["depth"]).all()


def parent_inputs(imgs, K, R, t, dmin, dmax):
    """A request's model inputs as Predictor made them before it staged:
    views stacked, cast, cropped, copied to a new f32 array each, then
    `torch.as_tensor`."""
    def crop(a):
        h, w = a.shape[-3:-1]
        return a[..., :h // 32 * 32, :w // 32 * 32, :]

    def tensor(a):
        return torch.as_tensor(np.array(a, np.float32))

    ragged = (isinstance(imgs, (list, tuple))
              and len({tuple(np.asarray(v).shape[-3:-1]) for v in imgs}) > 1)
    if ragged:
        views = [np.asarray(v, np.float32) for v in imgs]
        batched = views[0].ndim == 4
        views = [crop(v if batched else v[None]) for v in views]
        n, nb = len(views), views[0].shape[0]
        x = [tensor(v) for v in views]
    else:
        if isinstance(imgs, (list, tuple)):
            imgs = np.stack([np.asarray(v) for v in imgs],
                            axis=1 if np.asarray(imgs[0]).ndim == 4 else 0)
        imgs = np.asarray(imgs, np.float32)
        imgs = crop(imgs if imgs.ndim == 5 else imgs[None])
        nb, n = imgs.shape[:2]
        x = tensor(imgs)

    def prep(a):
        a = np.asarray(a, np.float32)
        while a.ndim < 4:
            a = a[None]
        return tensor(a)

    def prep_range(a):
        a = np.asarray(a, np.float32)
        return tensor(np.broadcast_to(a, (nb, n)) if a.ndim < 2 else a)

    return x, [prep(K), prep(R), prep(t), prep_range(dmin), prep_range(dmax)]


def staging_request(case, seed):
    """A request of the named layout (random values from `seed`): 3 views
    of 64x96, stacked, batched (B 2, scalar depth range), as a list, ragged
    (unbatched and batched), in float64, or padded to a non-/32 size."""
    rng = np.random.default_rng(seed)
    nb = 2 if case in ("batched", "ragged_batched") else 1
    imgs = rng.random((nb, 3, 64, 96, 3)).astype(np.float32)
    K, R = (rng.random((nb, 3, 3, 3)).astype(np.float32) for _ in "KR")
    t = rng.random((nb, 3, 3, 1)).astype(np.float32)
    dmin, dmax = rng.random((nb, 3)).astype(np.float32), 10.0
    one = (imgs[0], K[0], R[0], t[0], dmin[0], dmax)
    if case == "stacked":
        return one
    if case == "batched":
        return imgs, K, R, t, 5.0, dmax
    if case == "listed":
        return (list(imgs[0]),) + one[1:]
    if case == "ragged":
        return ([imgs[0, 0], imgs[0, 1, :, :70], imgs[0, 2, :40]],) + one[1:]
    if case == "ragged_batched":
        return ([imgs[:, 0], imgs[:, 1, :, :70], imgs[:, 2, :40]], K, R, t,
                dmin, dmax)
    if case == "float64":
        return tuple(np.asarray(a, np.float64) for a in one)
    assert case == "cropped"
    return (np.pad(imgs[0], ((0, 0), (0, 7), (0, 13), (0, 0))),) + one[1:]


def staged(imgs, K, R, t, dmin, dmax):
    """A request's model inputs as `Predictor` stages them on the CPU."""
    views, ragged, _ = Predictor._views(imgs)
    nb, n = views[0].shape[0], len(views)
    cams = Predictor._cams(K, R, t, dmin, dmax, nb, n)
    return _stage(views, ragged, cams, torch.device("cpu"))


def assert_bitwise(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_bitwise(g, w)
        return
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


STAGING_CASES = ["stacked", "batched", "listed", "ragged", "ragged_batched",
                 "float64", "cropped"]


def recording_predictor():
    """A CPU Predictor whose model records its inputs and returns zeros."""
    pred = Predictor(architecture="mvsnet", device="cpu", bf16=False)
    seen = []

    def model(x, *cams, **kwargs):
        seen.append((x, list(cams)))
        nb = (x[0] if isinstance(x, list) else x).shape[0]
        return {"depth": torch.zeros(nb, 2, 3),
                "photometric_confidence": torch.zeros(nb, 2, 3)}

    pred.model = model
    return pred, seen


@pytest.mark.parametrize("case", STAGING_CASES)
def test_staged_inputs_equal_the_parent_path(case):
    """The staging gives the model the parent's tensors bit for bit,
    request after request."""
    pred, seen = recording_predictor()
    for seed in (1, 2):
        req = staging_request(case, seed)
        want_x, want_cams = parent_inputs(*req)
        x, cams = staged(*req)
        assert_bitwise(x, want_x)
        assert_bitwise(cams, want_cams)
        pred(*req)
        assert_bitwise(seen[-1][0], want_x)
        assert_bitwise(seen[-1][1], want_cams)


@pytest.mark.parametrize("case", ["stacked", "ragged"])
def test_staged_inputs_do_not_alias_the_caller_or_the_buffers(case):
    """A staged request's tensors keep their values when the caller
    refills its arrays and the next request is staged."""
    req = staging_request(case, 3)
    want = parent_inputs(*req)
    x, cams = staged(*req)
    for a in (req[0] if isinstance(req[0], list) else [req[0]]) + \
            list(req[1:5]):
        a[...] = -1.0
    staged(*staging_request(case, 4))
    assert_bitwise(x, want[0])
    assert_bitwise(cams, want[1])


@pytest.mark.parametrize("case", ["stacked", "ragged"])
def test_threads_sharing_a_predictor_keep_their_own_inputs(case):
    """Two threads calling one Predictor at once each hand the model their
    own request's inputs: a request's host buffers are its own."""
    pred, seen = recording_predictor()
    reqs = {k: staging_request(case, 10 + k) for k in range(2)}
    want = {k: parent_inputs(*r) for k, r in reqs.items()}
    start = threading.Barrier(2)

    def serve(k):
        start.wait()
        for _ in range(20):
            pred(*reqs[k])

    threads = [threading.Thread(target=serve, args=(k,)) for k in reqs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(seen) == 40
    for x, cams in seen:
        k = 0 if torch.equal(cams[0], want[0][1][0]) else 1
        assert_bitwise(x, want[k][0])
        assert_bitwise(cams, want[k][1])


def large_request(case, seed):
    """A 3-view request whose views reach the copy team's threshold (a
    view 960 wide or wider, at B 1, is at least `_TEAM_MIN_BYTES` of f32):
    stacked, batched (B 2), ragged (two large views and one of half the
    height, under the threshold, copied on the calling thread), or in
    float64 (cast chunk by chunk)."""
    h = 32 * -(-infer._TEAM_MIN_BYTES // (4 * 3 * 960 * 32))
    imgs, K, R, t, dmin, dmax = staging_request(
        "batched" if case == "batched" else "stacked", seed)
    rng = np.random.default_rng(seed)
    nb = 2 if case == "batched" else 1
    big = rng.random((nb, 3, h, 1024, 3), np.float32)
    if case == "batched":
        return (big,) + (K, R, t, dmin, dmax)
    if case == "ragged":
        return ([big[0, 0], big[0, 1, :, :960], big[0, 2, :h // 2]], K, R,
                t, dmin, dmax)
    if case == "float64":
        return (big[0].astype(np.float64), K, R, t, dmin, dmax)
    return (big[0], K, R, t, dmin, dmax)


@pytest.fixture
def team(monkeypatch):
    """The copy team at two workers, whatever the host's cores; returns a
    function that reads what `staging_stats` counted since."""
    monkeypatch.setattr(infer, "_team_workers", lambda: 2)
    start = staging_stats()
    return lambda: {k: v - start[k] for k, v in staging_stats().items()}


def calling_thread_inputs(monkeypatch, req):
    """The request staged with every view copied on the calling thread."""
    with monkeypatch.context() as m:
        m.setattr(infer, "_TEAM_MIN_BYTES", 1 << 62)
        return staged(*req)


@pytest.mark.parametrize("case", ["stacked", "batched", "ragged", "float64"])
def test_the_copy_team_stages_large_views_bit_for_bit(case, team,
                                                      monkeypatch):
    """Views at or above the threshold go through the team and give the
    model the calling-thread path's tensors, and the parent's, bit for
    bit."""
    req = large_request(case, 5)
    want_x, want_cams = calling_thread_inputs(monkeypatch, req)
    assert team()["team_requests"] == 0
    for _ in range(3):
        x, cams = staged(*req)
        assert_bitwise(x, want_x)
        assert_bitwise(cams, want_cams)
    parent_x, parent_cams = parent_inputs(*req)
    assert_bitwise(x, parent_x)
    assert_bitwise(cams, parent_cams)
    counted = team()
    assert counted["requests"] == 4 and counted["team_requests"] == 3
    views = 2 if case == "ragged" else 3
    nb = 2 if case == "batched" else 1
    assert counted["chunks"] >= 3 * views * nb * 4
    assert 0 <= counted["worker_chunks"] <= counted["chunks"]


@pytest.mark.parametrize("case", ["stacked", "ragged_batched", "cell4"])
def test_views_under_the_threshold_never_reach_the_team(case, team):
    """Small views (the tests' 64x96 ones; the 512x640 views of the
    benchmark's 512x640 cell) are copied on the calling thread alone;
    the 1184x1600 views of the DTU cells are over the threshold."""
    assert 4 * 512 * 640 * 3 < infer._TEAM_MIN_BYTES <= 4 * 1184 * 1600 * 3
    if case == "cell4":
        req = staging_request("stacked", 6)
        req = ([np.random.default_rng(6).random((512, 640, 3), np.float32)
                for _ in range(3)],) + req[1:]
    else:
        req = staging_request(case, 6)
    x, cams = staged(*req)
    assert_bitwise(x, parent_inputs(*req)[0])
    assert team() == {"requests": 1, "team_requests": 0, "chunks": 0,
                      "worker_chunks": 0}


@pytest.mark.parametrize("cores,ranks", [(8, 1), (8, 4), (2, 1), (1, 1),
                                         (64, 1), (64, 3)])
def test_the_team_takes_half_of_this_ranks_share_of_the_cores(
        cores, ranks, monkeypatch):
    """The team's size comes from the cores the process may use, shared
    with the other ranks of its group; with none to spare, large views
    stay on the calling thread."""
    monkeypatch.setattr(infer.os, "sched_getaffinity",
                        lambda pid: set(range(cores)))
    monkeypatch.setattr(infer, "world", lambda: (ranks, 0))
    workers = infer._team_workers()
    assert workers == min(infer._TEAM_MAX, cores // ranks // 2)
    start = staging_stats()
    staged(*large_request("stacked", 7))
    used = staging_stats()["team_requests"] - start["team_requests"]
    assert used == (workers > 0)


@pytest.mark.parametrize("where", ["team", "calling_thread"])
def test_a_failing_copy_raises_and_the_team_serves_the_next_request(
        where, team, monkeypatch):
    """A cast that fails in a chunk (a team view) or on the calling thread
    (a small view) raises in the caller; no chunk of that request is left
    running or queued, and the next request is staged bit for bit."""
    imgs, *cams = large_request("stacked", 8)
    views = list(imgs)
    bad = views[1].astype(object)
    bad[-3, 5, 1] = "not a number"
    views[1] = bad if where == "team" else bad[-64:]
    with pytest.raises(ValueError):
        staged(views, *cams)
    copies = []
    queued = infer._TEAM[0][2]
    while not queued.empty():
        copies.append(queued.get())
    assert all(c is None or c.chunks == [] for c in copies)
    req = large_request("ragged", 9)
    x, cams = staged(*req)
    want_x, want_cams = calling_thread_inputs(monkeypatch, req)
    assert_bitwise(x, want_x)
    assert team()["team_requests"] == 1


def test_the_team_keeps_its_threads_over_requests(team):
    """The team starts once: twenty requests leave as many threads alive
    as the first left, and the workers copy chunks of them."""
    req = large_request("stacked", 10)
    staged(*req)
    alive = threading.active_count()
    for _ in range(20):
        staged(*req)
    assert threading.active_count() == alive
    counted = team()
    assert counted["team_requests"] == 21
    assert counted["worker_chunks"] > 0


def test_threads_staging_large_requests_keep_their_own_inputs(team):
    """Two threads staging large requests at once through one Predictor,
    switching often, each hand the model their own inputs, and the tally
    loses no request."""
    pred, seen = recording_predictor()
    reqs = {k: large_request("ragged" if k else "stacked", 11 + k)
            for k in range(2)}
    want = {k: parent_inputs(*r) for k, r in reqs.items()}
    start = threading.Barrier(2)

    def serve(k):
        start.wait()
        for _ in range(5):
            pred(*reqs[k])

    threads = [threading.Thread(target=serve, args=(k,)) for k in reqs]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert len(seen) == 10
    for x, cams in seen:
        k = 1 if isinstance(x, list) else 0
        assert_bitwise(x, want[k][0])
        assert_bitwise(cams, want[k][1])
    assert team()["team_requests"] == 10


def test_run_depthmaps_writes_npz_and_sentinel(tmp_path, npz_checkpoint):
    pred = Predictor(npz_checkpoint, device="cpu", bf16=False)
    samples = []
    for i in range(2):
        imgs, K, R, t, dmin, dmax = unbatched(seed=i)
        samples.append({"imgs": imgs, "K": K, "R": R, "t": t,
                        "depth_min": dmin, "depth_max": dmax,
                        "filename": f"scan1/{i:08d}"})
    out_dir = tmp_path / "depthmaps"
    run_depthmaps(samples, pred.model, out_dir)
    assert (out_dir / "finished.txt").exists()
    for i, s in enumerate(samples):
        with np.load(out_dir / f"scan1_{i:08d}_out.npz") as z:
            assert sorted(z.files) == ["depthmap", "probability"]
            want = pred(*(s[k] for k in ("imgs", "K", "R", "t", "depth_min",
                                         "depth_max")))
            np.testing.assert_array_equal(z["depthmap"], want["depth"])
            np.testing.assert_array_equal(z["probability"],
                                          want["confidence"])
            prob = z["probability"]
    # the sentinel makes a second run a no-op
    (out_dir / f"scan1_{0:08d}_out.npz").unlink()
    run_depthmaps(samples, pred.model, out_dir)
    assert not (out_dir / f"scan1_{0:08d}_out.npz").exists()
    geo = np.random.default_rng(0).random(prob.shape) > 0.3
    for args in ((prob,), (prob, 0.3, geo), (np.stack([prob, 1 - prob]),)):
        np.testing.assert_array_equal(get_mask_invalid(*args),
                                      jax_mask_invalid(*args))


def test_checkpoint_formats(tmp_path, variance_weights):
    params, stats = variance_weights
    model = build_model("mvsnet", device="cpu", seed=1)
    ckpt = tmp_path / "model_000001.ckpt"
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    torch.save({"model": sd, "architecture": "mvsnet"}, ckpt)
    pred = Predictor(ckpt, device="cpu", bf16=False)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(pred.model.state_dict()[k], v, rtol=0,
                                   atol=0)
    # a logdir serves its newest checkpoint; a directory that is neither a
    # logdir nor an orbax checkpoint is refused
    newest = Predictor(tmp_path, device="cpu", bf16=False)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(newest.model.state_dict()[k], v, rtol=0,
                                   atol=0)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="orbax"):
        Predictor(tmp_path / "empty", device="cpu")
    assert eval_model_kwargs("cvp_mvsnet")["kwargs"]["sweep_method"] == \
        "rect"
    with pytest.raises(ValueError, match="architecture"):
        Predictor(device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(architecture="mvsnet")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("mvsnet")
    assert Predictor(architecture="mvsnet-s", device="cpu").model.agg \
        == "softmin"


def test_port_imports_neither_jax_nor_wildmvs():
    code = (
        "import importlib.util, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['wildmvs'] = None\n"
        "import wildmvs_torch\n"
        "assert wildmvs_torch.__version__ == '0.1.0'\n"
        "light = [m for m in sys.modules if m.startswith('wildmvs_torch.')]\n"
        "assert light == ['wildmvs_torch.device'], light\n"
        "from wildmvs_torch.infer import Predictor\n"
        "from wildmvs_torch.models import build_model\n"
        "assert wildmvs_torch.Predictor is Predictor\n"
        "assert wildmvs_torch.build_model is build_model\n"
        "from wildmvs_torch.tools import e2e_quality, fusion_sensitivity\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'wildmvs')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    wildmvs_torch.__path__, 'wildmvs_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke',\n"
        "                                              'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'orbax', 'wildmvs', 'tensorstore',\n"
        "        'PIL', 'h5py')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "from wildmvs_torch import _build, cpp\n"
        "assert _build._lib is None and cpp._LIB is None  # nothing built\n"
        "print(' '.join(names))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 25
    assert {"wildmvs_torch.train.trainer", "wildmvs_torch.train.cli",
            "wildmvs_torch.train.checkpoint", "wildmvs_torch.train.config",
            "wildmvs_torch.train.metrics", "wildmvs_torch.losses.supervised",
            "wildmvs_torch.data.synthetic",
            "wildmvs_torch.utils.monitor", "wildmvs_torch.models.vis_mvsnet",
            "wildmvs_torch.nn.blocks", "wildmvs_torch.ops.plane_sweep",
            "wildmvs_torch.ops.volumes", "wildmvs_torch.data.loaders",
            "wildmvs_torch.data.codecs", "wildmvs_torch.data.colmap_model",
            "wildmvs_torch.data.colmap_utils", "wildmvs_torch.data.prefetch",
            "wildmvs_torch.losses.ssim",
            "wildmvs_torch.losses.photometric",
            "wildmvs_torch.pipeline.classic",
            "wildmvs_torch.pipeline.depthmap_eval",
            "wildmvs_torch.pipeline.export", "wildmvs_torch.data.matching",
            "wildmvs_torch.data.preprocess_megadepth",
            "wildmvs_torch.train.orbax_read", "wildmvs_torch.cpp",
            "wildmvs_torch.geometry.projective",
            "wildmvs_torch.pipeline.metrics3d", "wildmvs_torch.bench",
            "wildmvs_torch.tools",
            "wildmvs_torch.tools.e2e_quality",
            "wildmvs_torch.tools.fusion_sensitivity"} <= names
