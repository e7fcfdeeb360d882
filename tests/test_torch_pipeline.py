"""The port's reconstruction pipeline (wildmvs_torch/pipeline/, the rest of
geometry/projective.py, data/ply.py, data/synthetic.SyntheticSceneDataset,
utils/monitor.StageTimer) vs the JAX package's, on the CPU.

Inputs are numpy arrays from a seed, or the synthetic scene both packages
render from one seed. Tolerances:
  * geometry: f32, 1e-5 relative (the same arithmetic in another order;
    arccos near 1 amplifies it, so angles 1e-3 degrees);
  * filter masks and fusion keep masks: equal, pixel for pixel (a mask is
    a comparison of f32 values; the fixtures keep every value away from
    its threshold by far more than the rounding);
  * fused points: the same count, coordinates within 1e-4;
  * PLY: equal bytes; metrics: numpy/scipy on both sides, the same
    dedup, distances within 1e-12 relative (float64 sums in another
    order); the JAX package's native k-d tree returns the cutoff where
    scipy returns inf, so distances are compared clipped at the cutoff.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from wildmvs.data import ply as jply
from wildmvs.data.synthetic import SyntheticSceneDataset as JaxScene
from wildmvs.geometry import projective as jgeo
from wildmvs.pipeline import metrics3d as jmetrics
from wildmvs.pipeline.filtering import geometric_filter as jax_filter
from wildmvs.pipeline.fusion import fuse_depthmaps as jax_fuse
from wildmvs.pipeline.reconstruction import run_pipeline as jax_pipeline
from wildmvs.train.checkpoint import save_params_npz
from wildmvs_torch.data import codecs, ply
from wildmvs_torch.data.synthetic import SyntheticSceneDataset
from wildmvs_torch.geometry import projective as geo
from wildmvs_torch.pipeline import metrics3d, reconstruction
from wildmvs_torch.pipeline.filtering import geometric_filter
from wildmvs_torch.pipeline.fusion import fuse_depthmaps
from wildmvs_torch.pipeline.reconstruction import run_pipeline
from wildmvs_torch.utils.monitor import StageTimer
from tests.conftest import make_scene
from tests.test_torch_mvsnet import jax_variables

torch.set_num_threads(1)

NV, SH, SW = 5, 64, 96
#: float64 distances: scipy's k-d tree queries in parallel chunks, and
#: the JAX package's native tree computes them in another order
F64 = 1e-12


def t32(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, rel=1e-5, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=atol + rel * np.abs(want).max())


@pytest.fixture(scope="module")
def dataset():
    return SyntheticSceneDataset(num_views=NV, height=SH, width=SW)


# --- geometry ------------------------------------------------------------

def test_projective_functions_match_jax():
    rng = np.random.default_rng(0)
    K, R, t = make_scene(rng, n_views=3, h=16, w=24)
    pts = rng.uniform([-1, -1, 3], [1, 1, 6], (7, 5, 3)).astype(np.float32)
    depth = rng.uniform(2, 5, (16, 24)).astype(np.float32)
    grid = jgeo.pixel_grid(16, 24)
    close(geo.add_hom(t32(pts)), jgeo.add_hom(jnp.asarray(pts)))
    for got, want in zip(geo.project(t32(pts), t32(K[1]), t32(R[1]),
                                     t32(t[1])),
                         jgeo.project(jnp.asarray(pts), K[1], R[1], t[1])):
        close(got, want)
    for got, want in zip(geo.project_all(t32(pts), t32(K), t32(R), t32(t)),
                         jgeo.project_all(jnp.asarray(pts), K, R, t)):
        close(got, want)
    world = geo.unproject(t32(np.asarray(grid)), t32(K[0]), t32(R[0]),
                          t32(t[0]), t32(depth))
    close(world, jgeo.unproject(grid, K[0], R[0], t[0], depth))
    proj = jgeo.build_proj_matrices(K, R, t)[None]
    for ref in (0, 2):
        for got, want in zip(
                geo.flows_from_single_depthmap(t32(depth[None]),
                                               t32(np.asarray(proj)), ref),
                jgeo.flows_from_single_depthmap(jnp.asarray(depth[None]),
                                                proj, ref)):
            close(got, want)
    flow = rng.uniform(-5, 30, (4, 6, 2)).astype(np.float32)
    for ac in (False, True):
        for clamp in (None, 1.1):
            close(geo.normalize_flow(t32(flow), 16, 24, ac, clamp),
                  jgeo.normalize_flow(jnp.asarray(flow), 16, 24, ac, clamp))
    close(geo.unnormalize_flow(t32(flow / 30), 16, 24),
          jgeo.unnormalize_flow(jnp.asarray(flow / 30), 16, 24))
    close(geo.compute_triangulation_angles(world, t32(R), t32(t)),
          jgeo.compute_triangulation_angles(jnp.asarray(world.numpy()), R, t),
          atol=1e-3)
    Rr, tr = jgeo.relative_pose(R[0], t[0], R[1], t[1])
    close(geo.compute_triangulation_angle(t32(pts.reshape(-1, 3)),
                                          t32(np.asarray(Rr)),
                                          t32(np.asarray(tr))),
          jgeo.compute_triangulation_angle(jnp.asarray(pts.reshape(-1, 3)),
                                           Rr, tr), atol=1e-3)


# --- the synthetic scene ---------------------------------------------------

def test_synthetic_scene_equals_jax(dataset):
    ref = JaxScene(num_views=NV, height=SH, width=SW)
    assert len(dataset) == len(ref) == NV
    for i in (0, 3):
        got, want = dataset[i], ref[i]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
                assert got[k].dtype == v.dtype, k
            else:
                assert got[k] == v, k


# --- stage 2: filtering ----------------------------------------------------

def noisy_depths(dataset, seed=0):
    """The scene's GT depthmaps with a blob of wrong depths in each view
    (rejected by the filter) and 0.1 % noise elsewhere."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(len(dataset)):
        d = dataset.depths[i] * (1 + 1e-3 * rng.standard_normal(
            dataset.depths[i].shape)).astype(np.float32)
        y, x = rng.integers(8, SH - 24), rng.integers(8, SW - 24)
        d[y:y + 16, x:x + 16] *= 1.3
        out.append(d.astype(np.float32))
    return out


def test_geometric_filter_matches_jax(dataset):
    depths = noisy_depths(dataset)
    s = dataset[0]
    # uniform sources
    masks = geometric_filter(t32(depths[0]), t32(np.stack(depths[1:])),
                             t32(s["K"]), t32(s["R"]), t32(s["t"]))
    want = jax_filter(jnp.asarray(depths[0]), jnp.asarray(np.stack(depths[1:])),
                      s["K"], s["R"], s["t"])
    for k in ("mask_depth", "mask_disp", "geo_mask"):
        assert masks[k].dtype == torch.bool
        np.testing.assert_array_equal(masks[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert 0.5 < masks["geo_mask"].float().mean() < 1.0
    # ragged sources: view 2 at half resolution, its K scaled
    srcs = [depths[1], depths[2][::2, ::2], depths[3], depths[4]]
    K = s["K"].copy()
    K[2, :2] *= 0.5
    kw = dict(max_reproj_error=2.0, depth_threshold=0.02, num_consistent=2)
    masks = geometric_filter(t32(depths[0]), [t32(d) for d in srcs], t32(K),
                             t32(s["R"]), t32(s["t"]), **kw)
    want = jax_filter(jnp.asarray(depths[0]), [jnp.asarray(d) for d in srcs],
                      K, s["R"], s["t"], **kw)
    for k in ("mask_depth", "mask_disp", "geo_mask"):
        np.testing.assert_array_equal(masks[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# --- stage 3: fusion -------------------------------------------------------

def fusion_inputs(dataset, ragged=False):
    depths = noisy_depths(dataset, seed=1)
    for d in depths:
        d[:, :6] = 0.0                           # invalid pixels
    Ks = np.stack([dataset[i]["K"][0] for i in range(NV)])
    if ragged:
        depths[3] = depths[3][::2, ::2].copy()
        Ks[3, :2] *= 0.5
    colors = [dataset.imgs[i][::SH // d.shape[0], ::SH // d.shape[0]]
              for i, d in enumerate(depths)]
    return (depths, Ks, np.stack([dataset[i]["R"][0] for i in range(NV)]),
            np.stack([dataset[i]["t"][0] for i in range(NV)]), colors)


@pytest.mark.parametrize("case", ["uniform", "ragged", "max_reproj_error"])
def test_fuse_depthmaps_matches_jax(dataset, case):
    depths, Ks, Rs, ts, colors = fusion_inputs(dataset, case == "ragged")
    kw = dict(colors=colors, num_consistent=3,
              max_reproj_error=0.3 if case == "max_reproj_error" else None)
    pts, cols = fuse_depthmaps(depths if case == "ragged" else np.stack(depths),
                               Ks, Rs, ts, device="cpu", **kw)
    want_pts, want_cols = jax_fuse(depths if case == "ragged"
                                   else np.stack(depths), Ks, Rs, ts, **kw)
    assert pts.shape == want_pts.shape and pts.shape[0] > 1000
    np.testing.assert_allclose(pts, want_pts, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(cols, want_cols)
    if case == "max_reproj_error":
        loose, _ = fuse_depthmaps(np.stack(depths), Ks, Rs, ts,
                                  device="cpu", colors=colors)
        assert pts.shape[0] < loose.shape[0]           # the gate bites


# --- PLY and metrics -------------------------------------------------------

def test_ply_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((50, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (50, 3)).astype(np.uint8)
    nrm = rng.standard_normal((50, 3)).astype(np.float32)
    for binary in (True, False):
        a, b = tmp_path / f"port{binary}.ply", tmp_path / f"jax{binary}.ply"
        ply.write_ply(a, pts, colors=cols, normals=nrm, binary=binary)
        jply.write_ply(b, pts, colors=cols, normals=nrm, binary=binary)
        assert a.read_bytes() == b.read_bytes()
        got, want = ply.read_ply(b), jply.read_ply(a)
        assert got.dtype.names == want.dtype.names
        for name in want.dtype.names:
            np.testing.assert_array_equal(got[name], want[name])
        np.testing.assert_array_equal(ply.ply_xyz(a), jply.ply_xyz(a))
        np.testing.assert_array_equal(metrics3d.format_point_cloud(got),
                                      jmetrics.format_point_cloud(want))


def test_metrics3d_matches_jax():
    rng = np.random.default_rng(3)
    gt = rng.uniform(0, 100, (3000, 3))
    pred = np.concatenate([gt[:2000] + rng.normal(0, 0.5, (2000, 3)),
                           rng.uniform(0, 100, (300, 3))])
    for chunked in (False, True):
        got, keep = metrics3d.reduce_pts(pred, 2.0, chunked=chunked)
        want, keep_j = jmetrics.reduce_pts(pred, 2.0, chunked=chunked)
        np.testing.assert_array_equal(keep, keep_j)
        np.testing.assert_array_equal(got, want)
    bb = np.array([[0.0, 0.0, 0.0], [100.0, 100.0, 100.0]])
    np.testing.assert_allclose(
        metrics3d.chamfer_cells(pred, gt, bb, 30.0),
        jmetrics.chamfer_cells(pred, gt, bb, 30.0), rtol=F64)
    np.testing.assert_allclose(
        np.minimum(metrics3d.chamfer_nn(pred, gt, 5.0), 5.0),
        np.minimum(jmetrics.chamfer_nn(pred, gt, 5.0), 5.0), rtol=F64)
    mask = rng.random((25, 25, 25)) > 0.3
    plane = np.array([0.0, 0.0, 1.0, -20.0])
    raw = metrics3d.eval_dtu(pred, gt, mask, bb, 4.0, plane, maxdist=30.0)
    raw_j = jmetrics.eval_dtu(pred, gt, mask, bb, 4.0, plane, maxdist=30.0)
    for k, v in raw_j.items():
        np.testing.assert_allclose(raw[k], v, rtol=F64, err_msg=k)
    got, want = metrics3d.summarize_dtu(raw), jmetrics.summarize_dtu(raw_j)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose([got[k] for k in sorted(got)],
                               [want[k] for k in sorted(want)], rtol=F64)
    raw = metrics3d.eval_yfcc(pred, gt, 0.5)
    raw_j = jmetrics.eval_yfcc(pred, gt, 0.5)
    for k in raw_j:
        np.testing.assert_allclose(np.minimum(raw[k], 5.0),
                                   np.minimum(raw_j[k], 5.0), rtol=F64)


def test_stage_timer():
    timer = StageTimer("cpu")
    timer.mark("a")
    with timer.stage("b"):
        pass
    timer.mark("a")
    summary = timer.summary()
    assert summary["a"]["count"] == 2 and summary["b"]["count"] == 1
    assert all(v["total_s"] >= 0 for v in summary.values())


# --- the whole pipeline ----------------------------------------------------

def test_run_pipeline_oracle_matches_jax(dataset, tmp_path):
    got = run_pipeline(dataset, tmp_path / "port", architecture="oracle",
                       compute_metrics=True, device="cpu")
    want = jax_pipeline(JaxScene(num_views=NV, height=SH, width=SW),
                        tmp_path / "jax", architecture="oracle",
                        compute_metrics=True)
    assert got["num_points"] == want["num_points"] > 1000
    assert sorted(got["stage_timings"]) == sorted(want["stage_timings"])
    for i in range(NV):
        name = f"IntRes/geometric_filtering/scene/view_{i:04d}_out.npz"
        with np.load(tmp_path / "port" / name) as a, \
                np.load(tmp_path / "jax" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(ply.ply_xyz(got["ply"]),
                               jply.ply_xyz(want["ply"]), rtol=0, atol=1e-4)
    # a second call reads every stage from its cache
    again = run_pipeline(dataset, tmp_path / "port", architecture="oracle",
                         device="cpu")
    assert again["num_points"] == got["num_points"]
    with pytest.raises(ValueError, match="unknown architecture"):
        run_pipeline(dataset, tmp_path / "c", architecture="patchmatch",
                     device="cpu")


@pytest.fixture(scope="module")
def mvsnet_npz(tmp_path_factory):
    """Seeded JAX MVSNet variables (tests/test_torch_mvsnet.py's, whose
    last conv peaks the depth probabilities) as a save_params_npz file."""
    params, stats = jax_variables("mvsnet")
    path = tmp_path_factory.mktemp("weights") / "mvsnet.npz"
    save_params_npz(path, params, stats, "mvsnet")
    return path


def test_run_pipeline_mvsnet_sharded_then_complete(dataset, mvsnet_npz,
                                                   tmp_path):
    # random weights give depths no two views agree on: every pixel is
    # kept (no probability gate, one view suffices) so that the fused
    # cloud has points to count
    kw = dict(model_dir=mvsnet_npz, architecture="vis_mvsnet",
              prob_threshold=0.0, fusion_num_consistent=1, device="cpu")
    whole = run_pipeline(dataset, tmp_path / "whole", **kw)
    assert whole["architecture"] == "mvsnet"        # the npz's own
    depth_dir = tmp_path / "sharded" / "IntRes" / "depthmaps" / "scene"
    for rank in (0, 1):
        res = run_pipeline(dataset, tmp_path / "sharded", process_index=rank,
                           process_count=2, **kw)
        assert res["stage1_shard"] == f"{rank}/2" and "num_points" not in res
        assert not (depth_dir / "finished.txt").exists()
    assert len(list(depth_dir.glob("*_out.npz"))) == NV
    done = run_pipeline(dataset, tmp_path / "sharded", **kw)
    assert (depth_dir / "finished.txt").exists()
    assert done["num_points"] == whole["num_points"] > 0
    for i in range(NV):
        name = f"IntRes/depthmaps/scene/view_{i:04d}_out.npz"
        with np.load(tmp_path / "whole" / name) as a, \
                np.load(tmp_path / "sharded" / name) as b:
            np.testing.assert_array_equal(a["depthmap"], b["depthmap"])
            assert a["depthmap"].shape == (SH // 4, SW // 4)
            assert np.isfinite(a["depthmap"]).all()
    # the weights came through state_dict_from_jax: the network run
    # directly on view 0 gives the cached depthmap
    model, arch, _ = reconstruction.load_network(
        mvsnet_npz, None, dataset[0], "synthetic", device="cpu")
    s = dataset[0]
    with torch.inference_mode():
        out = model(*(t32(s[k])[None] for k in ("imgs", "K", "R", "t",
                                                "depth_min", "depth_max")))
    with np.load(tmp_path / "whole" / "IntRes/depthmaps/scene/"
                 "view_0000_out.npz") as z:
        np.testing.assert_array_equal(out["depth"][0].float().numpy(),
                                      z["depthmap"])
    # debug: one depthmap, one filtered view, no sentinel, no fusion
    res = run_pipeline(dataset, tmp_path / "debug", debug=True, **kw)
    assert "num_points" not in res
    assert len(list((tmp_path / "debug" / "IntRes" / "depthmaps" / "scene")
                    .glob("*_out.npz"))) == 1


def write_dtu_eval_scan(root, scene, views=3):
    """The synthetic scene as a DTU evaluation scan written by the port's
    codecs: <root>/<scene>/{pair.txt, images/*.jpg, cams/*_cam.txt}, the
    depth range 192 intervals from 2."""
    from PIL import Image
    ds = SyntheticSceneDataset(num_views=views, height=SH, width=SW)
    (root / scene / "images").mkdir(parents=True)
    (root / scene / "cams").mkdir()
    lines = [str(views)]
    for v in range(views):
        srcs = [u for u in range(views) if u != v]
        lines += [str(v), f"{len(srcs)} " + " ".join(f"{u} 1.0"
                                                      for u in srcs)]
        s = ds[v]
        Image.fromarray((s["imgs"][0] * 255).round().astype(np.uint8)).save(
            root / scene / "images" / f"{v:08d}.jpg", quality=95)
        ext = np.eye(4)
        ext[:3, :3], ext[:3, 3:] = s["R"][0], s["t"][0]
        codecs.write_cam_txt(root / scene / "cams" / f"{v:08d}_cam.txt", ext,
                             s["K"][0], 2.0, 4.0 / 192)
    (root / scene / "pair.txt").write_text("\n".join(lines) + "\n")


def test_cli_drives_the_pipeline(tmp_path):
    res = reconstruction.main(["--dataset", "synthetic", "--architecture",
                               "oracle", "--device", "cpu", "--work_dir",
                               str(tmp_path), "--nviews", "3"])
    assert res["num_points"] > 0
    # --dataset dtu reads the scan from --data_path (data/loaders.py)
    write_dtu_eval_scan(tmp_path / "dtu", "scan1")
    res = reconstruction.main(["--dataset", "dtu", "--data_path",
                               str(tmp_path / "dtu"), "--scene", "scan1",
                               "--architecture", "mvsnet", "--device", "cpu",
                               "--work_dir", str(tmp_path / "dtu_out"),
                               "--nviews", "3"])
    assert res["scene"] == "scan1" and res["num_points"] >= 0
    maps = sorted((tmp_path / "dtu_out" / "IntRes" / "depthmaps" / "scan1")
                  .glob("*_out.npz"))
    assert [m.name for m in maps] == [f"{v:08d}_out.npz" for v in range(3)]
    with np.load(maps[0]) as z:
        assert z["depthmap"].shape == (SH // 4, SW // 4)
        assert np.isfinite(z["depthmap"]).all()
