"""The port's data modules (wildmvs_torch/data/codecs.py, colmap_model.py,
colmap_utils.py, loaders.py, prefetch.py, txt/) vs the JAX package's, on
fixtures written into tmp_path in the datasets' own layouts (as
tests/test_loaders.py builds them).

Both packages decode JPEG and PNG through their native module (the same
C++, wildmvs/cpp and wildmvs_torch/cpp) unless WILDMVS_NATIVE_IO=0, and
through PIL, the fallback, when it is 0. Every test here forces the
fallback in both packages (the autouse fixture) unless it says not, and
holds the port to JAX bit for bit either way: PIL against PIL, and native
against native (the MegaDepth resize, the DTU PNGs, the BlendedMVS and
DTU-eval JPEGs).
"""
import threading
import time

import numpy as np
import pytest
from PIL import Image

from wildmvs.data import codecs as jcodecs
from wildmvs.data import colmap_model as jcm
from wildmvs.data import colmap_utils as jcu
from wildmvs.data import loaders as jloaders
from wildmvs.data import prefetch as jprefetch
from wildmvs.train.config import TrainConfig as JaxConfig
from wildmvs_torch.data import codecs, loaders, prefetch
from wildmvs_torch.data import colmap_model as cm
from wildmvs_torch.data import colmap_utils as cu
from wildmvs_torch.train.config import TrainConfig


@pytest.fixture(autouse=True)
def pil_in_jax(monkeypatch):
    """Both packages' loaders take their PIL fallback unless a test says
    not."""
    monkeypatch.setenv("WILDMVS_NATIVE_IO", "0")


def assert_samples_equal(got: dict, want: dict):
    """Every key, array for array (lists of arrays element for element)."""
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k]
        if isinstance(v, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == v.dtype, k
            np.testing.assert_array_equal(g, v, err_msg=k)
        elif isinstance(v, list) and v and isinstance(v[0], np.ndarray):
            assert len(g) == len(v), k
            for a, b in zip(g, v):
                np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert g == v, k


def write_img(path, h, w, seed=0, fmt=None):
    rng = np.random.default_rng(seed)
    # a smooth field plus noise: what a JPEG of a photograph holds
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 100 * np.sin(xx / 17.0 + seed)[..., None] * np.cos(
        yy / 23.0)[..., None]
    img = np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(
        np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(img).save(path, format=fmt)


def yao_cam(path, K, R, t, dmin, dint, count=None, dmax=None):
    ext = np.eye(4)
    ext[:3, :3] = R
    ext[:3, 3:] = t
    codecs.write_cam_txt(path, ext, K, dmin, dint, count, dmax)


# --- codecs, scene lists ----------------------------------------------------

def test_codecs_round_trip_against_jax(tmp_path):
    rng = np.random.default_rng(0)
    gray = rng.random((7, 5)).astype(np.float32)
    color = rng.random((4, 6, 3)).astype(np.float32)
    for name, arr in (("g", gray), ("c", color)):
        codecs.write_pfm(tmp_path / f"{name}.pfm", arr, scale=2.0)
        jcodecs.write_pfm(tmp_path / f"{name}_j.pfm", arr, scale=2.0)
        assert (tmp_path / f"{name}.pfm").read_bytes() == \
            (tmp_path / f"{name}_j.pfm").read_bytes()
        got, scale = codecs.read_pfm(tmp_path / f"{name}_j.pfm")
        np.testing.assert_array_equal(got, arr)
        assert scale == 2.0
    ext = np.eye(4)
    ext[:3, 3] = [0.1, -2.0, 3.5]
    K = np.array([[700.0, 0, 320], [0, 701.0, 256], [0, 0, 1]])
    codecs.write_cam_txt(tmp_path / "cam.txt", ext, K, 425.0, 2.5, 192, 905.0)
    got, want = (codecs.read_cam_txt(tmp_path / "cam.txt"),
                 jcodecs.read_cam_txt(tmp_path / "cam.txt"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    jcodecs.write_cam_txt(tmp_path / "cam_j.txt", ext, K, 425.0, 2.5)
    codecs.write_cam_txt(tmp_path / "cam_p.txt", ext, K, 425.0, 2.5)
    assert (tmp_path / "cam_j.txt").read_text() == \
        (tmp_path / "cam_p.txt").read_text()
    (tmp_path / "pair.txt").write_text(
        "3\n0\n2 1 10.0 2 5.0\n1\n1 0 9.0\n2\n2 0 3.0 1 1.0\n")
    assert codecs.read_pair_txt(tmp_path / "pair.txt") == \
        jcodecs.read_pair_txt(tmp_path / "pair.txt") == \
        [(0, [1, 2]), (1, [0]), (2, [0, 1])]
    for arr in (gray, color):
        codecs.write_dmb(tmp_path / "a.dmb", arr)
        jcodecs.write_dmb(tmp_path / "b.dmb", arr)
        assert (tmp_path / "a.dmb").read_bytes() == \
            (tmp_path / "b.dmb").read_bytes()
        np.testing.assert_array_equal(codecs.read_dmb(tmp_path / "b.dmb"),
                                      arr)
        codecs.write_colmap_array(tmp_path / "a.bin", arr)
        jcodecs.write_colmap_array(tmp_path / "b.bin", arr)
        assert (tmp_path / "a.bin").read_bytes() == \
            (tmp_path / "b.bin").read_bytes()
        np.testing.assert_array_equal(
            codecs.read_colmap_array(tmp_path / "b.bin"), arr)
    with pytest.raises(ValueError, match="not a PFM"):
        codecs.read_pfm(tmp_path / "pair.txt")


def test_scene_lists_are_jax_s():
    for name in ("dtu_train", "dtu_val", "md_train", "md_test",
                 "blended_train", "blended_val"):
        assert loaders.scene_list(name) == jloaders.scene_list(name), name
        assert len(loaders.scene_list(name)) > 0


# --- COLMAP model and scene helpers -----------------------------------------

def colmap_scene(root, n_views=4, n_points=60):
    """A synthetic COLMAP reconstruction written by the port's
    colmap_model, and its images."""
    rng = np.random.default_rng(0)
    w, h = 320, 256
    K = np.array([[300.0, 0, w / 2], [0, 300.0, h / 2], [0, 0, 1]])
    cams = {1: cm.Camera(1, "PINHOLE", w, h,
                         np.array([300.0, 300.0, w / 2, h / 2]))}
    pts = rng.uniform(-1, 1, (n_points, 3)) + [0, 0, 4.0]
    Rs, ts, vis, pxs = [], [], [], []
    for i in range(n_views):
        ang = 0.15 * (i - n_views / 2)
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        t = np.array([-0.5 * i, 0, 0.05 * i]).reshape(3, 1)
        cam = pts @ R.T + t.T
        px = (cam @ K.T)[:, :2] / (cam @ K.T)[:, 2:]
        vis.append((px >= 0).all(1) & (px[:, 0] < w) & (px[:, 1] < h)
                   & (cam[:, 2] > 0))
        Rs.append(R)
        ts.append(t)
        pxs.append(px)
    keep = np.sum(vis, axis=0) >= 2
    images = {}
    for i in range(n_views):
        ids = np.where(vis[i] & keep)[0]
        images[i + 1] = cm.Image(i + 1, cm.rotmat2qvec(Rs[i]), ts[i][:, 0],
                                 1, f"im_{i}.jpg", pxs[i][ids],
                                 ids.astype(np.int64))
    points = {}
    for j in np.where(keep)[0]:
        obs = [(i + 1, int(np.where(images[i + 1].point3D_ids == j)[0][0]))
               for i in range(n_views) if j in images[i + 1].point3D_ids]
        points[int(j)] = cm.Point3D(
            int(j), pts[j], np.array([100, 110, 120]), 0.5,
            np.array([o[0] for o in obs], np.int32),
            np.array([o[1] for o in obs], np.int32))
    cm.write_model(cams, images, points, root / "sparse" / "scene1", ".bin")
    for i in range(n_views):
        write_img(root / "images" / "scene1" / f"im_{i}.jpg", h, w, i)
    return K, np.stack(Rs), np.stack(ts), pts, images, points


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_model_round_trips_against_jax(tmp_path, ext):
    _, _, _, _, images, points = colmap_scene(tmp_path)
    cams = cm.read_model(tmp_path / "sparse" / "scene1")[0]
    cm.write_model(cams, images, points, tmp_path / "m", ext)
    jcm.write_model(*jcm.read_model(tmp_path / "m"), tmp_path / "j", ext)
    for f in ("cameras", "images", "points3D"):
        assert (tmp_path / "m" / f"{f}{ext}").read_bytes() == \
            (tmp_path / "j" / f"{f}{ext}").read_bytes(), f
    got, want = cm.read_model(tmp_path / "j"), jcm.read_model(tmp_path / "m")
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            for field, v in vars(w[key]).items():
                np.testing.assert_array_equal(getattr(g[key], field), v,
                                              err_msg=field)
    q = images[2].qvec
    np.testing.assert_array_equal(cm.qvec2rotmat(q), jcm.qvec2rotmat(q))
    np.testing.assert_array_equal(cm.rotmat2qvec(cm.qvec2rotmat(q)),
                                  jcm.rotmat2qvec(jcm.qvec2rotmat(q)))
    np.testing.assert_allclose(cm.rotmat2qvec(cm.qvec2rotmat(q)), q,
                               atol=1e-12)


def test_colmap_utils_match_jax(tmp_path):
    K, Rs, ts, pts, images, points = colmap_scene(tmp_path, n_points=200)
    cams = cm.read_model(tmp_path / "sparse" / "scene1")[0]
    for g, w in zip(cu.get_calib_from_sparse(cams, images),
                    jcu.get_calib_from_sparse(cams, images)):
        np.testing.assert_array_equal(g, w)
    Kf, Rf, tf, _ = cu.get_calib_from_sparse(cams, images)
    for g, w in zip(cu.compute_min_max_depth(points, images, Kf, Rf, tf),
                    jcu.compute_min_max_depth(points, images, Kf, Rf, tf)):
        np.testing.assert_array_equal(g, w)
    for kw in ({}, {"nb_points_thresh": 20}):
        got = cu.compute_src_images(images, points, Rf, tf, 1.0, 2, **kw)
        assert got == jcu.compute_src_images(images, points, Rf, tf, 1.0, 2,
                                             **kw)
    assert all(len(s) == 2 and i not in s for i, s in enumerate(got))
    Ks = np.tile(K, (len(images), 1, 1))
    tri = cu.triangulate_tracks(images, Ks, Rs, ts)
    jtri = jcu.triangulate_tracks(images, Ks, Rs, ts)
    assert list(tri) == list(jtri) and len(tri) > 100
    for j in tri:
        np.testing.assert_array_equal(tri[j].xyz, jtri[j].xyz)
        np.testing.assert_array_equal(tri[j].image_ids, jtri[j].image_ids)
    assert np.median([np.linalg.norm(tri[j].xyz - pts[j]) for j in tri]) \
        < 1e-6


# --- loaders -----------------------------------------------------------------

def dtu_train_root(root, scans=(1,), h=544, w=672, views=5):
    """Yao's DTU training layout: Cameras/pair.txt and train/ cams (K at
    1/4), Rectified/scan{N}_train PNGs for 7 lights, Depths/ PFMs and
    visual masks at 1/4. Scans past the first link to its directories."""
    K = np.array([[700.0, 0, w / 2], [0, 700.0, h / 2], [0, 0, 1]])
    (root / "Cameras" / "train").mkdir(parents=True)
    lines = [str(views)]
    for v in range(views):
        srcs = [u for u in range(views) if u != v]
        lines += [str(v), f"{len(srcs)} " + " ".join(
            f"{u} {100.0 - u}" for u in srcs)]
    (root / "Cameras" / "pair.txt").write_text("\n".join(lines) + "\n")
    first = f"scan{scans[0]}_train"
    for v in range(views):
        yao_cam(root / "Cameras" / "train" / f"{v:08d}_cam.txt",
                K / np.array([[4], [4], [1]]), np.eye(3),
                np.array([[0.1 * v], [0], [0]]), 425.0, 2.5)
        for light in range(7):
            write_img(root / "Rectified" / first
                      / f"rect_{v + 1:03d}_{light}_r5000.png", h, w,
                      10 * v + light)
        rng = np.random.default_rng(v)
        depth = (600.0 + rng.normal(0, 5, (h // 4, w // 4))).astype(
            np.float32)
        (root / "Depths" / first).mkdir(parents=True, exist_ok=True)
        codecs.write_pfm(root / "Depths" / first
                         / f"depth_map_{v:04d}.pfm", depth)
        write_img(root / "Depths" / first / f"depth_visual_{v:04d}.png",
                  h // 4, w // 4, v)
    for s in scans[1:]:
        for sub in ("Rectified", "Depths"):
            (root / sub / f"scan{s}_train").symlink_to(root / sub / first)


def test_dtu_train_dataset_matches_jax(tmp_path):
    root = tmp_path / "dtu"
    dtu_train_root(root, views=3)
    for mode, nv, rd in (("train", 3, False), ("train", 2, True),
                         ("val", 3, True), ("test", 3, False)):
        got = loaders.DTUTrainDataset(root, [1], mode, nv, return_depth=rd)
        want = jloaders.DTUTrainDataset(root, [1], mode, nv, return_depth=rd)
        assert got.metas == want.metas and len(got) == 21
        for i in (0, 11):
            assert_samples_equal(got[i], want[i])
    assert got[0]["imgs"].shape == (3, 544, 672, 3)    # test: crop to /32
    s = loaders.DTUTrainDataset(root, [1], "train", 3, return_depth=True)[0]
    assert s["imgs"].shape == (3, 512, 640, 3) and s["depth"].shape == \
        (136, 168)
    # K stored at 1/4, times 4, principal point moved by the crop
    assert s["K"][0, 0, 2] == pytest.approx(672 / 2 - (672 - 640) / 2)
    np.testing.assert_allclose(s["depth_max"], 425.0 + 192 * 2.5)


def test_dtu_eval_dataset_matches_jax(tmp_path):
    root = tmp_path / "eval"
    h, w = 300, 400                              # cropped to 288x384
    K = np.array([[600.0, 0, w / 2], [0, 600.0, h / 2], [0, 0, 1]])
    (root / "scan1" / "cams").mkdir(parents=True)
    (root / "scan1" / "pair.txt").write_text(
        "3\n0\n2 1 10.0 2 5.0\n1\n2 0 9.0 2 1.0\n2\n2 0 3.0 1 1.0\n")
    for v in range(3):
        yao_cam(root / "scan1" / "cams" / f"{v:08d}_cam.txt", K, np.eye(3),
                np.array([[0.2 * v], [0], [0]]), 2.0 + v, 0.01)
        write_img(root / "scan1" / "images" / f"{v:08d}.jpg", h, w, v)
    got = loaders.build_eval_dataset("dtu", root, "scan1", 3)
    want = jloaders.build_eval_dataset("dtu", root, "scan1", 3)
    assert isinstance(got, loaders.DTUEvalDataset) and len(got) == 3
    for i in range(3):
        assert_samples_equal(got[i], want[i])
    assert got[1]["imgs"].shape == (3, 288, 384, 3)
    np.testing.assert_allclose(got[1]["depth_max"],
                               np.array([3.0, 2.0, 4.0]) + 0.01 * 192,
                               rtol=1e-6)
    with pytest.raises(ValueError):
        loaders.build_eval_dataset("eth3d", root, "scan1")


def md_root(root, mode, sizes, per_view_depth=False, items=2):
    """MegaDepth n-uplets: im_{i}_{v}.jpg, infos_{i}.npz, depth h5."""
    import h5py
    sp = root / mode / "0000"
    sp.mkdir(parents=True)
    n = len(sizes)
    rng = np.random.default_rng(1)
    for cpt in range(items):
        Ks = []
        for v, (h, w) in enumerate(sizes):
            write_img(sp / f"im_{cpt}_{v}.jpg", h, w, 7 * cpt + v)
            Ks.append([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]])
            if per_view_depth:
                with h5py.File(sp / f"depth_{cpt}_{v}.h5", "w") as f:
                    f["depth"] = rng.uniform(1, 9, (h, w)).astype(np.float32)
        np.savez(sp / f"infos_{cpt}.npz", K=np.array(Ks, np.float32),
                 R=np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)),
                 t=rng.normal(0, 1, (n, 3)).astype(np.float32),
                 min_d=np.full(n, 2.0), max_d=np.full(n, 8.0))
        if not per_view_depth:
            h, w = sizes[0]
            with h5py.File(sp / f"depth_{cpt}.h5", "w") as f:
                f["depth"] = rng.uniform(1, 9, (h, w)).astype(np.float32)


def test_megadepth_dataset_matches_jax(tmp_path):
    """Train: the 512-px min-side LANCZOS resize, the float32 nearest
    depth resize and the 512x512 centre crop; test: views of different
    sizes come back as lists, with per-view depths."""
    root = tmp_path / "md"
    md_root(root, "train", [(600, 800), (640, 700), (560, 900)])
    md_root(root, "test", [(300, 400), (256, 352), (320, 320)],
            per_view_depth=True)
    for mode, nv, rd in (("train", 3, True), ("train", 2, False),
                         ("test", 3, False)):
        got = loaders.MegaDepthDataset(root, ["0000", "9999"], mode, nv,
                                       return_depth=rd)
        want = jloaders.MegaDepthDataset(root, ["0000", "9999"], mode, nv,
                                         return_depth=rd)
        assert got.items == want.items and len(got) == 2
        for i in range(2):
            assert_samples_equal(got[i], want[i])
    s = loaders.MegaDepthDataset(root, ["0000"], "train", 3,
                                 return_depth=True)[0]
    assert s["imgs"].shape == (3, 512, 512, 3) and s["depth"].shape == \
        (512, 512)
    t = got[0]
    assert isinstance(t["imgs"], list)
    assert [im.shape for im in t["imgs"]] == [(288, 384, 3), (256, 352, 3),
                                              (320, 320, 3)]
    assert len(t["depth_list"]) == 3


def test_megadepth_resize_against_the_native_decoder(tmp_path, monkeypatch):
    """Both packages on their default path, the native decoder (libjpeg
    decode, f32 Lanczos-3 resize, one C++ source): the train resize's
    samples equal bit for bit; PIL's 8-bit LANCZOS passes differ from them
    by at most 1/255 on average and 8/255 at worst."""
    from wildmvs import cpp
    from wildmvs_torch import cpp as port_cpp
    if not (cpp.has_image_module() and port_cpp.has_image_module()):
        pytest.skip("the native image module did not build")
    monkeypatch.setenv("WILDMVS_NATIVE_IO", "1")
    root = tmp_path / "md"
    md_root(root, "train", [(600, 800), (640, 700), (560, 900)], items=1)
    got = loaders.MegaDepthDataset(root, ["0000"], "train", 3,
                                   return_depth=True)[0]
    want = jloaders.MegaDepthDataset(root, ["0000"], "train", 3,
                                     return_depth=True)[0]
    assert got["imgs"].shape == (3, 512, 512, 3)
    assert_samples_equal(got, want)
    monkeypatch.setenv("WILDMVS_NATIVE_IO", "0")
    pil = loaders.MegaDepthDataset(root, ["0000"], "train", 3,
                                   return_depth=True)[0]
    diff = np.abs(got["imgs"] - pil["imgs"])
    assert 0 < diff.mean() <= 1 / 255 and diff.max() <= 8 / 255


@pytest.mark.parametrize("dataset", ["dtu_train", "dtu_eval", "blended"])
def test_datasets_on_the_native_decoder_match_jax(tmp_path, monkeypatch,
                                                  dataset):
    """The DTU training PNGs, the DTU eval and BlendedMVS (no augmentation)
    JPEGs through both packages' native decoders: equal bit for bit."""
    from wildmvs_torch import cpp as port_cpp
    if not port_cpp.has_image_module():
        pytest.skip("the native image module did not build")
    monkeypatch.setenv("WILDMVS_NATIVE_IO", "1")
    if dataset == "dtu_train":
        dtu_train_root(tmp_path, views=3, h=160, w=192)
        args = (tmp_path, [1], "test", 3)        # crop to /32
        cls = "DTUTrainDataset"
    elif dataset == "dtu_eval":
        K = np.array([[300.0, 0, 96.0], [0, 300.0, 80.0], [0, 0, 1]])
        (tmp_path / "scan1" / "cams").mkdir(parents=True)
        (tmp_path / "scan1" / "pair.txt").write_text(
            "2\n0\n1 1 10.0\n1\n1 0 9.0\n")
        for v in range(2):
            yao_cam(tmp_path / "scan1" / "cams" / f"{v:08d}_cam.txt", K,
                    np.eye(3), np.array([[0.2 * v], [0], [0]]), 2.0, 0.01)
            write_img(tmp_path / "scan1" / "images" / f"{v:08d}.jpg", 160,
                      192, v)
        args = (tmp_path, "scan1", 2)
        cls = "DTUEvalDataset"
    else:
        blended_root(tmp_path, "scene")
        args = (tmp_path, ["scene"], "val", 3)
        cls = "BlendedMVSDataset"
    got, want = getattr(loaders, cls)(*args), getattr(jloaders, cls)(*args)
    for i in (0, 1):
        assert_samples_equal(got[i], want[i])


def blended_root(root, scene, views=3):
    h, w = 600, 800                                 # cropped to 576x768
    K = np.array([[600.0, 0, w / 2], [0, 600.0, h / 2], [0, 0, 1]])
    (root / scene / "cams").mkdir(parents=True)
    lines = [str(views)]
    for v in range(views):
        srcs = [u for u in range(views) if u != v]
        lines += [str(v), f"{len(srcs)} " + " ".join(f"{u} 10.0"
                                                      for u in srcs)]
    (root / scene / "cams" / "pair.txt").write_text("\n".join(lines) + "\n")
    rng = np.random.default_rng(2)
    for v in range(views):
        name = f"{v:08d}"
        yao_cam(root / scene / "cams" / f"{name}_cam.txt", K, np.eye(3),
                np.array([[0.1 * v], [0], [0]]), 2.0, 0.05, 128,
                2.0 + 128 * 0.05)
        write_img(root / scene / "blended_images" / f"{name}.jpg", h, w, v)
        (root / scene / "rendered_depth_maps").mkdir(parents=True,
                                                     exist_ok=True)
        codecs.write_pfm(root / scene / "rendered_depth_maps" / f"{name}.pfm",
                         rng.uniform(1.0, 9.0, (h, w)).astype(np.float32))


def test_blended_dataset_matches_jax(tmp_path):
    """The augmentation (brightness, contrast, motion blur) draws from an
    explicit Generator: the same seed gives JAX's jitter and blur, sample
    after sample."""
    root = tmp_path / "blended"
    blended_root(root, "5a0271884e62597cdee0d0eb")
    scenes = ["5a0271884e62597cdee0d0eb", "missing"]
    for kw in (dict(augment=False), dict(augment=True, seed=3),
               dict(augment=True, seed=5, return_depth=False),
               dict(mode="test", nviews=3)):
        kw = {"mode": "train", "nviews": 2, **kw}
        got = loaders.BlendedMVSDataset(root, scenes, **kw)
        want = jloaders.BlendedMVSDataset(root, scenes, **kw)
        assert got.metas == want.metas and len(got) == 3
        for i in (0, 2, 1):
            assert_samples_equal(got[i], want[i])
    assert got[0]["imgs"].shape == (3, 576, 800, 3)    # test: crop to /32
    # the augmentation changes the images; train crops to 576x768
    plain = loaders.BlendedMVSDataset(root, scenes, "train", 2,
                                      augment=False)[0]["imgs"]
    aug = loaders.BlendedMVSDataset(root, scenes, "train", 2, augment=True,
                                    seed=3)[0]["imgs"]
    assert plain.shape == aug.shape == (2, 576, 768, 3)
    assert not np.array_equal(plain, aug)


def test_yfcc_scene_dataset_matches_jax(tmp_path):
    colmap_scene(tmp_path)
    got = loaders.build_eval_dataset("yfcc", tmp_path, "scene1", 3)
    want = jloaders.build_eval_dataset("yfcc", tmp_path, "scene1", 3)
    assert isinstance(got, loaders.YFCCSceneDataset) and len(got) == 4
    for i in range(4):
        assert_samples_equal(got[i], want[i])
    s = got[0]
    assert s["imgs"].shape == (3, 256, 320, 3) and s["filename"] == "im_0"
    assert (s["depth_min"] < s["depth_max"]).all()


def test_build_datasets_match_jax(tmp_path):
    root = tmp_path / "dtu"
    scans = [int(s) for s in loaders.scene_list("dtu_train")
             + loaders.scene_list("dtu_val")]
    dtu_train_root(root, scans=tuple(scans))
    for supervised in (True, False):
        kw = dict(dataset="dtu", data_path=str(root), supervised=supervised)
        got = loaders.build_datasets(TrainConfig(**kw))
        want = jloaders.build_datasets(JaxConfig(**kw))
        for g, w in zip(got, want):
            assert g.metas == w.metas and g.nviews == w.nviews
            assert g.return_depth == w.return_depth
    assert len(got[0]) == len(loaders.scene_list("dtu_train")) * 5 * 7
    # val and test: a fixed-seed subset of at most 1000
    assert len(got[2]) == min(1000, len(loaders.scene_list("dtu_val")) * 35)
    assert_samples_equal(got[2][3], want[2][3])
    with pytest.raises(ValueError):
        loaders.build_datasets(TrainConfig(dataset="synthetic"))


# --- prefetch ------------------------------------------------------------------

class SlowDataset:
    """Samples that take longer the lower their index, from many threads."""

    def __init__(self, n):
        self.n = n
        self.threads = set()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.threads.add(threading.get_ident())
        time.sleep(0.002 * (self.n - i))
        return {"x": np.full((2,), i, np.float32), "filename": f"s{i}"}


def collate(samples):
    return {"x": np.stack([s["x"] for s in samples]),
            "filename": [s["filename"] for s in samples]}


@pytest.mark.parametrize("workers", [0, 3])
def test_prefetch_delivers_in_order(workers):
    order = np.random.default_rng(0).permutation(11)
    ds = SlowDataset(11)
    got = [int(s["x"][0]) for s in prefetch.iterate(ds, order,
                                                    num_workers=workers)]
    assert got == list(order)
    batches = list(prefetch.iterate_batches(ds, order, 4, collate,
                                            num_workers=workers))
    want = list(jprefetch.iterate_batches(ds, order, 4, collate,
                                          num_workers=workers))
    assert [b["x"].shape[0] for b in batches] == [4, 4, 3]
    for g, w in zip(batches, want):
        np.testing.assert_array_equal(g["x"], w["x"])
        assert g["filename"] == w["filename"]
    if workers:
        assert len(ds.threads) > 1
