"""The port's classic ZNCC plane sweep (wildmvs_torch/pipeline/classic.py)
and its pipeline wiring vs the JAX package's, on the CPU.

Inputs: the synthetic scene both packages render from one seed (64x96,
3 views; tests/test_torch_pipeline.py holds the two renders equal).
Tolerances:
  * `_box_filter`: 1e-6 relative (the same sums in another order);
  * the antialiased gray resize: 3e-7 absolute (one or two f32 ulps);
  * depth and confidence: `chip_smoke.CLASSIC_LIMITS` (`classic_agreement`):
    depth median within 0.05 hypothesis interval, 99 % within 0.5, at
    most 0.5 % of pixels 2 intervals or more apart (argmax near-ties);
    confidence within 1e-4 on >= 99 % of pixels, all within 1e-3. The
    warp is bitwise equal on both sides; the box filter's sums round in
    another order, and ZNCC's variances and the parabola's offset magnify
    that (the JAX function against itself on images moved by one ulp
    moves the depth by 0.0044 interval at the median and 0.068 at the
    99th percentile at D192, half resolution);
  * against GT: the median relative depth error under 3 % on the mask
    (the JAX package's own bound, tests/test_pipeline.py:249-268);
  * the pipeline: every npz as above; point counts within 1 % + 5 points
    (a point is a pixel whose views agree within a threshold, so those
    sub-interval depth differences move a few pixels across it: 329
    against 325 here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from wildmvs.pipeline import classic as jclassic
from wildmvs.pipeline.reconstruction import run_pipeline as jax_pipeline
from wildmvs_torch.data.synthetic import SyntheticSceneDataset
from wildmvs_torch.pipeline import classic, reconstruction

torch.set_num_threads(1)

NV, SH, SW, D = 3, 64, 96, 64
#: (downscale, window): full resolution, and the JAX default at half
CONFIGS = [(1, 5), (2, 7)]
KEYS = ("imgs", "K", "R", "t", "depth_min", "depth_max")


@pytest.fixture(scope="module")
def scene():
    return SyntheticSceneDataset(num_views=NV, height=SH, width=SW)


def ragged_views(sample):
    """The reference whole and the sources cropped top-left (a top-left
    crop keeps K): three views of three sizes."""
    imgs = sample["imgs"]
    return [imgs[0], imgs[1][:56, :80], imgs[2][:64, :88]]


def run_both(sample, downscale, window, views=None):
    """The JAX and the port's classic_depthmap on one sample (batch 1)."""
    arrs = [np.asarray(sample[k], np.float32)[None] for k in KEYS]
    if views is None:
        jimgs, timgs = jnp.asarray(arrs[0]), torch.from_numpy(arrs[0])
    else:
        jimgs = tuple(jnp.asarray(v[None]) for v in views)
        timgs = tuple(torch.from_numpy(np.ascontiguousarray(v[None]))
                      for v in views)
    want = jclassic.classic_depthmap(
        jimgs, *(jnp.asarray(a) for a in arrs[1:]), num_depth=D,
        window=window, downscale=downscale)
    got = classic.classic_depthmap(
        timgs, *(torch.from_numpy(a) for a in arrs[1:]), num_depth=D,
        window=window, downscale=downscale)
    return ([np.asarray(g[0]) for g in got], [np.asarray(w[0]) for w in want])


def interval(sample, num_depth=D):
    return float(sample["depth_max"][0] - sample["depth_min"][0]) / (
        num_depth - 1)


@pytest.mark.parametrize("window", [5, 7, 4])
def test_box_filter_matches_jax(window):
    x = np.random.default_rng(window).random((3, 20, 30, 1)).astype(
        np.float32)
    want = np.asarray(jclassic._box_filter(jnp.asarray(x), window))
    got = classic._box_filter(torch.from_numpy(x).permute(0, 3, 1, 2),
                              window).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("hw", [(64, 96), (65, 97), (59, 90)])
def test_gray_resize_is_jax_antialiased_bilinear(hw):
    img = np.random.default_rng(1).random((1,) + hw + (3,)).astype(
        np.float32)
    for d in (2, 3):
        g = jnp.asarray(img).mean(axis=-1, keepdims=True)
        want = np.asarray(jax.image.resize(
            g, (1, hw[0] // d, hw[1] // d, 1), "bilinear"))[..., 0]
        got = classic._gray(torch.from_numpy(img), d).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-7)


@pytest.mark.parametrize("downscale,window", CONFIGS)
def test_classic_depthmap_matches_jax(scene, downscale, window):
    s = scene[0]
    got, want = run_both(s, downscale, window)
    assert got[0].shape == (SH // downscale, SW // downscale)
    assert np.isfinite(got[0]).all()
    assert 0.0 <= got[1].min() and got[1].max() <= 1.0
    chip_smoke.classic_agreement(got, want, interval(s))
    gt = scene.depths[0][::downscale, ::downscale]
    mask = np.asarray(s["mask"])[::downscale, ::downscale] > 0.5
    rel = np.abs(got[0] - gt)[mask] / gt[mask]
    assert np.median(rel) < 0.03, np.median(rel)


def test_classic_depthmap_ragged_views_match_jax(scene):
    s = scene[0]
    got, want = run_both(s, 2, 7, views=ragged_views(s))
    assert got[0].shape == (SH // 2, SW // 2)
    chip_smoke.classic_agreement(got, want, interval(s))


def test_classic_pipeline_matches_jax(scene, tmp_path):
    """run_pipeline(architecture="classic") at the defaults (D192, window
    7, half resolution) against the JAX pipeline: every view's npz, the
    point count; the sentinel, and the cache on a second call."""
    got = reconstruction.run_pipeline(scene, tmp_path / "port",
                                      architecture="classic",
                                      min_tri_angle=0.0, device="cpu")
    want = jax_pipeline(SyntheticSceneDataset(num_views=NV, height=SH,
                                              width=SW),
                        tmp_path / "jax", architecture="classic",
                        min_tri_angle=0.0)
    step = interval(scene[0], 192)
    for i in range(NV):
        name = f"IntRes/depthmaps/scene/view_{i:04d}_out.npz"
        with np.load(tmp_path / "port" / name) as a, \
                np.load(tmp_path / "jax" / name) as b:
            assert sorted(a.files) == ["depthmap", "probability"]
            assert a["depthmap"].shape == (SH // 2, SW // 2)
            chip_smoke.classic_agreement(
                (a["depthmap"], a["probability"]),
                (b["depthmap"], b["probability"]), step)
    assert got["architecture"] == "classic"
    assert got["num_points"] > 100
    assert abs(got["num_points"] - want["num_points"]) <= \
        0.01 * want["num_points"] + 5
    depth_dir = tmp_path / "port" / "IntRes" / "depthmaps" / "scene"
    assert (depth_dir / "finished.txt").exists()
    again = reconstruction.run_pipeline(scene, tmp_path / "port",
                                        architecture="classic",
                                        min_tri_angle=0.0, device="cpu")
    assert again["num_points"] == got["num_points"]


def test_classic_sharding_debug_and_cli(scene, tmp_path):
    """Two shards write every view and no sentinel; debug stops after one;
    the CLI's --classic runs stage 1-3 and refuses a model beside it."""
    out = tmp_path / "shards"
    for i in range(2):
        classic.run_classic_depthmaps(scene, out, num_depth=16, window=5,
                                      process_index=i, process_count=2,
                                      device="cpu")
    assert sorted(f.name for f in out.iterdir()) == [
        f"view_{i:04d}_out.npz" for i in range(NV)]
    one = tmp_path / "debug"
    classic.run_classic_depthmaps(scene, one, num_depth=16, debug=True,
                                  device="cpu")
    assert [f.name for f in one.iterdir()] == ["view_0000_out.npz"]
    res = reconstruction.main(["--dataset", "synthetic", "--classic",
                               "--nviews", "3", "--device", "cpu",
                               "--work_dir", str(tmp_path / "cli"),
                               "--min_tri_angle", "0"])
    assert res["architecture"] == "classic" and res["num_points"] > 100
    with pytest.raises(SystemExit):
        reconstruction.main(["--classic", "--model", "x.npz", "--device",
                             "cpu"])
