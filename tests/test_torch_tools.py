"""The port's offline tools vs the JAX package's, on the CPU: the depthmap
benchmark (pipeline/depthmap_eval.py), the external-fuser exporters
(pipeline/export.py), the matching front end (data/matching.py), MegaDepth
preprocessing (data/preprocess_megadepth.py) and the orbax checkpoint
reader (train/orbax_read.py).

Tolerances:
  * evaluate: both networks f32 from the same weights (state_dict_from_jax);
    EPE within 1e-4 relative (the convolutions' f32 rounding, at 16
    hypotheses), 1pxError and 3pxError within 2e-3 (a pixel whose error
    sits at a threshold may fall on either side; 2e-3 is about 4 of the
    scene's masked pixels); merged parts within 1e-6 relative of the
    unsharded run (the JAX package's own bound, tests/test_pipeline.py:
    229-246), and the two packages' merges of the same parts equal;
  * exporters, matching, preprocessing: the same host numpy code on the
    same inputs, so every written file is byte-identical (npz files,
    which carry a time stamp, are compared array by array) and every
    returned array equal;
  * orbax: the state_dict bitwise equal to `state_dict_from_jax` of the
    saved trees.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildmvs.data import matching as jmatching
from wildmvs.data import preprocess_megadepth as jpre
from wildmvs.models import build_model as jax_build_model
from wildmvs.pipeline import depthmap_eval as jde
from wildmvs.pipeline import export as jexport
from wildmvs.train.checkpoint import save_checkpoint, save_params
from wildmvs.train.config import TrainConfig as JaxTrainConfig
from wildmvs.train.trainer import TrainState, make_optimizer
from wildmvs_torch.data import matching, preprocess_megadepth
from wildmvs_torch.data.synthetic import (SyntheticMVSDataset,
                                          SyntheticSceneDataset)
from wildmvs_torch.pipeline import depthmap_eval, export
from wildmvs_torch.pipeline.reconstruction import load_network
from wildmvs_torch.train import orbax_read
from wildmvs_torch.train.checkpoint import latest_checkpoint
from wildmvs_torch.train.jax_import import load_weights, state_dict_from_jax
from tests.test_loaders import _synthetic_colmap_scene, _write_img
from tests.test_torch_mvsnet import D, jax_variables, port_model

torch.set_num_threads(1)


def same_tree(a, b):
    """Every file under two directories: the same names, the same bytes
    (npz: the same arrays)."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb and fa
    for rel in fa:
        if rel.suffix == ".npz":
            with np.load(a / rel) as x, np.load(b / rel) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


# --- the depthmap benchmark -------------------------------------------------

@pytest.fixture(scope="module")
def bench():
    """Seeded f32 MVSNet variables (test_torch_mvsnet's), the JAX model and
    the port's, and three synthetic samples of three views."""
    params, stats = jax_variables("mvsnet")
    ds = SyntheticMVSDataset(num_samples=3, num_views=3, height=64,
                             width=96, seed=7)
    jmodel = jax_build_model("mvsnet", num_depth=D)
    return (ds, (jmodel, {"params": params, "batch_stats": stats}),
            port_model(params, stats, "mvsnet"))


def metrics_close(got, want):
    assert got["count"] == want["count"]
    assert got["EPE"] == pytest.approx(want["EPE"], rel=1e-4)
    for k in ("1pxError", "3pxError"):
        assert abs(got[k] - want[k]) <= 2e-3, (k, got[k], want[k])


def test_evaluate_matches_jax(bench):
    ds, (jmodel, variables), model = bench
    got = depthmap_eval.evaluate(ds, model)
    want = jde.evaluate(ds, jmodel, variables)
    assert got["count"] == 3 and np.isfinite(got["EPE"])
    metrics_close(got, want)
    for i in range(2):
        metrics_close(depthmap_eval.evaluate(ds, model, process_index=i,
                                             process_count=2),
                      jde.evaluate(ds, jmodel, variables, process_index=i,
                                   process_count=2))


def test_merge_parts_reads_either_package(bench, tmp_path):
    """Parts with JAX's results merged by the port, parts the port's CLI
    wrote merged by JAX: both merges equal, and equal to the unsharded
    run within 1e-6."""
    ds, (jmodel, variables), model = bench
    base = tmp_path / "mvsnet_3"
    for i in range(2):
        res = jde.evaluate(ds, jmodel, variables, process_index=i,
                           process_count=2)
        (tmp_path / f"mvsnet_3.part{i}.json").write_text(json.dumps(res))
    got = depthmap_eval.merge_parts(base)
    assert json.loads((tmp_path / "mvsnet_3.json").read_text()) == got
    assert got == jde.merge_parts(base)
    assert got["count"] == 3 and got["merged_parts"] == 2
    full = jde.evaluate(ds, jmodel, variables)
    for k in ("EPE", "1pxError", "3pxError"):
        assert got[k] == pytest.approx(full[k], rel=1e-6)
    (tmp_path / "mvsnet_3.part1.json").rename(tmp_path /
                                              "mvsnet_3.part2.json")
    with pytest.raises(ValueError, match="incomplete shard set"):
        depthmap_eval.merge_parts(base)


def test_depthmap_eval_sharded_merge(tmp_path):
    """Two sharded CLI runs and --merge give the unsharded metrics (the
    port's run of tests/test_pipeline.py's test), and JAX's merge_parts
    reads the parts the port wrote."""
    base = ["--dataset", "synthetic", "--architecture", "mvsnet",
            "--nb_imgs", "3", "--out_dir", str(tmp_path), "--device", "cpu"]
    for pidx in range(2):
        depthmap_eval.main(base + ["--process_index", str(pidx),
                                   "--process_count", "2"])
    full = depthmap_eval.main(base)
    out = tmp_path / "synthetic_depthmaps"
    assert json.loads((out / "mvsnet_3.json").read_text()) == full
    want = jde.merge_parts(out / "mvsnet_3")
    merged = depthmap_eval.main(["--merge", str(out / "mvsnet_3")])
    assert merged == want
    assert merged["count"] == 4 and merged["merged_parts"] == 2
    for k in ("EPE", "1pxError", "3pxError"):
        assert merged[k] == pytest.approx(full[k], rel=1e-6)
    depthmap_eval.main(base + ["--debug"])
    assert {"pred.jpg", "gt.jpg", "diff.jpg", "im_ref.jpg"} <= {
        p.name for p in (out / "visu").iterdir()}


# --- the exporters -------------------------------------------------------------

@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """tests/test_export.py's scene and stage-1 cache (GT depths with
    random probabilities), plus a geometric mask for view 1."""
    ds = SyntheticSceneDataset(num_views=3, height=24, width=32, seed=0)
    depth_dir = tmp_path_factory.mktemp("depthmaps")
    filter_dir = tmp_path_factory.mktemp("filter")
    rng = np.random.default_rng(0)
    for i in range(len(ds)):
        s = ds[i]
        prob = rng.uniform(0.0, 1.0, s["depth"].shape).astype(np.float32)
        np.savez_compressed(depth_dir / f"{s['filename']}_out.npz",
                            depthmap=s["depth"].astype(np.float32),
                            probability=prob)
    np.savez_compressed(filter_dir / "view_0001_out.npz",
                        geo_mask=rng.random((24, 32)) > 0.3)
    return ds, depth_dir, filter_dir


@pytest.mark.parametrize("kind", ["gipuma", "colmap"])
def test_exporters_write_the_jax_bytes(stage1, tmp_path, kind):
    ds, depth_dir, filter_dir = stage1
    for name, mod in (("port", export), ("jax", jexport)):
        if kind == "gipuma":
            mod.export_gipuma_workspace(ds, depth_dir, tmp_path / name,
                                        filter_dir=filter_dir, downscale=2)
        else:
            mod.export_colmap_workspace(ds, depth_dir, tmp_path / name,
                                        filter_dir=filter_dir)
    same_tree(tmp_path / "port", tmp_path / "jax")
    assert export.fusibile_command(tmp_path, disp_thresh=0.3) == \
        jexport.fusibile_command(tmp_path, disp_thresh=0.3)
    assert export.colmap_fusion_command(tmp_path, "f.ply") == \
        jexport.colmap_fusion_command(tmp_path, "f.ply")


# --- the matching front end ---------------------------------------------------

def test_matching_equals_jax(tmp_path):
    """Keypoints, descriptors, F, matches and tracks of
    tests/test_matching.py's scene, and the sparse model written."""
    scene = SyntheticSceneDataset(num_views=4, height=96, width=128, seed=5)
    grays = [im.mean(-1) for im in scene.imgs]
    kps, descs = [], []
    for g in grays:
        kp = matching.harris_keypoints(g, max_kp=512)
        np.testing.assert_array_equal(kp, jmatching.harris_keypoints(
            g, max_kp=512))
        d = matching.patch_descriptors(g, kp)
        np.testing.assert_array_equal(d, jmatching.patch_descriptors(g, kp))
        kps.append(kp)
        descs.append(d)
    cams = [(scene.K[i], scene.R[i], scene.t[i]) for i in range(2)]
    F = matching.fundamental_from_poses(*cams[0], *cams[1])
    np.testing.assert_array_equal(
        F, jmatching.fundamental_from_poses(*cams[0], *cams[1]))
    m = matching.match_pair(kps[0], descs[0], kps[1], descs[1], F=F)
    assert len(m) > 50
    np.testing.assert_array_equal(m, jmatching.match_pair(
        kps[0], descs[0], kps[1], descs[1], F=F))
    pairs = {(0, 1): m, (1, 2): matching.match_pair(
        kps[1], descs[1], kps[2], descs[2])}
    counts = [len(k) for k in kps[:3]]
    for a, b in zip(matching.build_tracks(counts, pairs),
                    jmatching.build_tracks(counts, pairs)):
        np.testing.assert_array_equal(a, b)
    args = (grays, scene.K, scene.R, scene.t)
    got = matching.create_sparse_from_known_poses(
        *args, max_kp=512, out_dir=tmp_path / "port")
    want = jmatching.create_sparse_from_known_poses(
        *args, max_kp=512, out_dir=tmp_path / "jax")
    assert len(got[2]) > 20 and sorted(got[2]) == sorted(want[2])
    for i, im in got[1].items():
        np.testing.assert_array_equal(im.point3D_ids,
                                      want[1][i].point3D_ids)
    same_tree(tmp_path / "port", tmp_path / "jax")


# --- MegaDepth preprocessing --------------------------------------------------

def test_preprocess_megadepth_equals_jax(tmp_path):
    """process_scene on tests/test_loaders.py's MegaDepth-like tree."""
    import h5py
    from wildmvs.data import colmap_model as cm
    _, _, _, _, images, points = _synthetic_colmap_scene(
        tmp_path / "tmp_scene", n_views=4, n_points=400)
    cm.write_model({1: cm.Camera(1, "PINHOLE", 640, 512,
                                 np.array([600.0, 600.0, 320.0, 256.0]))},
                   images, points, tmp_path / "sfm_root" / "sceneA", ".bin")
    img_root = tmp_path / "imgs"
    for i in range(4):
        _write_img(img_root / "sceneA" / "dense0" / "imgs" / f"im_{i}.jpg",
                   512, 640, i)
        dpath = img_root / "sceneA" / "dense0" / "depths" / f"im_{i}.h5"
        dpath.parent.mkdir(parents=True, exist_ok=True)
        with h5py.File(dpath, "w") as f:
            f["depth"] = np.full((512, 640), 4.0, np.float32)
            f["pad"] = np.zeros(200 * 1024 // 4, np.float32)  # size gate
    counts = []
    for name, mod in (("port", preprocess_megadepth), ("jax", jpre)):
        counts.append(mod.process_scene(
            "sceneA", img_root, tmp_path / "sfm_root", tmp_path / name,
            nb_src=2, nb_per_scene=3, nb_points_thresh=20,
            tri_angle_thresh=1.0))
    assert counts[0] == counts[1] >= 1
    same_tree(tmp_path / "port", tmp_path / "jax")
    assert preprocess_megadepth.resized_size((1000, 700)) == \
        jpre.resized_size((1000, 700))


# --- orbax checkpoints ------------------------------------------------------

def test_orbax_checkpoints_load_bitwise(tmp_path, monkeypatch):
    """A whole JAX TrainState (save_checkpoint) and model variables alone
    (save_params) read back as state_dict_from_jax gives them;
    load_network picks the newest model_* of a logdir; without
    tensorstore the reader says so."""
    params, stats = jax_variables("mvsnet")
    older = jax.tree_util.tree_map(lambda v: v * 2, params)

    def state(p):
        tx = make_optimizer(JaxTrainConfig(dataset="synthetic"))
        return TrainState(step=jnp.zeros((), jnp.int32), params=p,
                          batch_stats=stats, opt_state=tx.init(p), tx=tx)

    logdir = tmp_path / "logdir"
    save_checkpoint(logdir, 1, state(older), "mvsnet")
    newest = save_checkpoint(logdir, 3, state(params), "mvsnet")
    (logdir / "model_000007").mkdir()          # no metadata.json: skipped
    assert latest_checkpoint(logdir) == newest
    want = state_dict_from_jax(params, stats)
    for path in (newest, save_params(tmp_path / "vars", params, stats,
                                     "mvsnet", epoch=2)):
        sd, arch = load_weights(path)
        assert arch == "mvsnet" and sorted(sd) == sorted(want)
        for k, v in want.items():
            assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    sample = SyntheticSceneDataset(num_views=3, height=64, width=96)[0]
    model, arch, _ = load_network(logdir, None, sample, "synthetic",
                                  device="cpu")
    assert arch == "mvsnet"
    for k, v in want.items():                  # the bf16 eval network
        got = model.state_dict()[k]
        assert torch.equal(got, v.to(got.dtype)), k
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        orbax_read.load_orbax_params(newest)
