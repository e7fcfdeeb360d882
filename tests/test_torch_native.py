"""The port's native host helpers (wildmvs_torch/cpp) against the JAX
package's (wildmvs/cpp), on the CPU.

Both packages compile the same C++ with the same flags on this host, so
the k-d tree's NN distances and dedup keep masks, the decoded images,
their resize ratios and the Lanczos resize are held bit for bit; the NN
distances also within 1e-12 of scipy's cKDTree clipped at the cutoff (the
tree returns the cutoff where scipy returns inf), and the keep masks equal
to the Python loop over cKDTree's neighbours. The fall-backs mirror
tests/test_native_image.py: formats the decoder refuses go to PIL, a
missing file raises, WILDMVS_NATIVE_IO=0 takes PIL. The build itself (a
corrupt library rebuilt, two processes building at once, the k-d tree
alone when the image module does not compile) runs on a copy of the
module in a temporary directory, so that the library the other tests load
is never touched.
"""
import importlib.util
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from PIL import Image
from scipy.spatial import cKDTree

from wildmvs import cpp as jcpp
from wildmvs.data import loaders as jloaders
from wildmvs_torch import cpp
from wildmvs_torch.data import loaders

CPP_DIR = Path(cpp.__file__).resolve().parent


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """tests/test_native_image.py's files: RGB PNG and JPEG, gray PNG, BMP."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    base = rng.random((37, 53, 3))
    arr = (np.kron(base, np.ones((8, 8, 1)))[:290, :420] * 255).astype(
        np.uint8)
    Image.fromarray(arr).save(d / "a.png")
    Image.fromarray(arr).save(d / "a.jpg", quality=95)
    gray = np.kron(rng.random((10, 12)), np.ones((8, 8))) * 255
    Image.fromarray(gray[:77, :91].astype(np.uint8)).save(d / "g.png")
    Image.fromarray(arr).save(d / "a.bmp")
    return d


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(0)
    return rng.random((5000, 3)) * 10, rng.random((3000, 3)) * 10


def pil_read(path):
    return np.asarray(Image.open(path), np.float32) / 255.0


# --- the k-d tree -----------------------------------------------------------

@pytest.mark.parametrize("maxdist", [0.3, 2.0, np.inf])
def test_nn_distance_matches_jax_and_scipy(points, maxdist):
    pts, q = points
    got = cpp.NativeKDTree(pts).nn_distance(q, maxdist=maxdist)
    want = jcpp.NativeKDTree(pts).nn_distance(q, maxdist=maxdist)
    np.testing.assert_array_equal(got, want)
    raw = cKDTree(pts).query(q, distance_upper_bound=maxdist)[0]
    np.testing.assert_allclose(got, np.minimum(raw, maxdist), rtol=0,
                               atol=1e-12)
    cut = np.isinf(raw)
    assert (got[cut] == maxdist).all() and (got[~cut] < maxdist).all()
    assert cut.any() == (maxdist == 0.3)


def test_nn_distance_threads_and_empty_tree(points):
    pts, q = points
    tree = cpp.NativeKDTree(pts)
    np.testing.assert_array_equal(tree.nn_distance(q, 1.0, threads=1),
                                  tree.nn_distance(q, 1.0, threads=8))
    empty = cpp.NativeKDTree(np.zeros((0, 3)))
    np.testing.assert_array_equal(empty.nn_distance(q[:5], 4.0),
                                  np.full(5, 4.0))
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        tree.nn_distance(q[:, :2])


def loop_dedup(pts, radius, order):
    """metrics.py:38-64's loop over cKDTree's neighbours."""
    keep = np.ones(len(pts), bool)
    idx = cKDTree(pts).query_ball_point(pts[order], radius)
    for j, pid in enumerate(order):
        if keep[pid]:
            keep[idx[j]] = False
            keep[pid] = True
    return keep


@pytest.mark.parametrize("radius", [0.2, 0.5])
def test_radius_dedup_matches_jax_and_the_loop(points, radius):
    pts, _ = points
    order = np.random.default_rng(1).permutation(len(pts))
    keep = cpp.radius_dedup(pts, radius, order)
    assert keep.dtype == bool and 0 < keep.sum() < len(pts)
    np.testing.assert_array_equal(keep, jcpp.radius_dedup(pts, radius, order))
    np.testing.assert_array_equal(keep, loop_dedup(pts, radius, order))
    with pytest.raises(ValueError, match="order"):
        cpp.radius_dedup(pts, radius, order[:-1])


# --- decode and resize ------------------------------------------------------

@pytest.mark.parametrize("resize_to", [None, (128, 160), (40, 52)])
def test_load_images_bitwise_equal_to_jax(images, resize_to):
    paths = [images / "a.png", images / "g.png", images / "a.jpg"]
    got = cpp.load_images(paths, resize_to, threads=2)
    want = jcpp.load_images(paths, resize_to, threads=2)
    assert [g.shape for g, _ in got] == [w.shape for w, _ in want]
    assert got[1][0].ndim == 2              # gray stays [H, W], as in PIL
    for (g, rg), (w, rw) in zip(got, want):
        assert g.dtype == np.float32 and rg == rw
        np.testing.assert_array_equal(g, w)
    if resize_to is None:
        # x * (1/255) against PIL's x / 255: within an ulp (the JAX test's)
        np.testing.assert_allclose(got[0][0], pil_read(images / "a.png"),
                                   rtol=0, atol=1e-6)
        assert all(r == 1.0 for _, r in got)
    else:
        th, tw = resize_to
        assert min(got[0][0].shape[0] / th, got[0][0].shape[1] / tw) >= 1.0


@pytest.mark.parametrize("shape,out", [((40, 56, 3), (20, 28)),
                                       ((33, 47, 3), (50, 61)),
                                       ((29, 31), (17, 40))])
def test_resize_lanczos_bitwise_equal_to_jax(shape, out):
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    got = cpp.resize_lanczos(img, *out)
    assert got.shape == out + shape[2:]
    np.testing.assert_array_equal(got, jcpp.resize_lanczos(img, *out))


def exotic_pngs(d: Path):
    """16-bit, RGBA and palette PNGs: PIL gives other arrays for them, so
    the native decoder refuses them."""
    rng = np.random.default_rng(1)
    paths = [d / "d16.png", d / "rgba.png", d / "pal.png"]
    Image.fromarray((rng.random((40, 50)) * 65535).astype(np.uint16),
                    mode="I;16").save(paths[0])
    Image.fromarray((rng.random((40, 50, 4)) * 255).astype(np.uint8),
                    mode="RGBA").save(paths[1])
    Image.fromarray((rng.random((40, 50, 3)) * 255).astype(np.uint8)) \
        .convert("P", palette=Image.ADAPTIVE).save(paths[2])
    return paths


def test_exotic_formats_fall_back_to_pil(images, tmp_path, monkeypatch):
    monkeypatch.setenv("WILDMVS_NATIVE_IO", "1")
    for p in exotic_pngs(tmp_path) + [images / "a.bmp"]:
        with pytest.raises(RuntimeError, match="native decode failed"):
            cpp.load_images([p])
        (img, r), = loaders.read_images([p])
        (want, rw), = jloaders.read_images([p])
        np.testing.assert_array_equal(img, pil_read(p))
        np.testing.assert_array_equal(img, want)
        assert r == rw == 1.0


def test_the_first_fall_back_prints_one_line(images, monkeypatch, capsys):
    import threading
    monkeypatch.setenv("WILDMVS_NATIVE_IO", "1")
    monkeypatch.setattr(loaders, "_fell_back", threading.Event())
    loaders.read_images([images / "a.png"])
    assert capsys.readouterr().err == ""
    loaders.read_images([images / "a.bmp"])
    loaders.read_images([images / "a.bmp"])
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and "decoding with PIL" in err[0], err


def test_missing_file_raises(images, monkeypatch):
    monkeypatch.setenv("WILDMVS_NATIVE_IO", "1")
    with pytest.raises(RuntimeError, match="missing"):
        cpp.load_images([images / "missing.png"])
    with pytest.raises(FileNotFoundError):
        loaders.read_images([images / "nope.jpg"])


@pytest.mark.parametrize("name", ["a.png", "a.jpg", "g.png"])
def test_native_io_switch(images, monkeypatch, name):
    """WILDMVS_NATIVE_IO=1 gives the JAX package's native arrays bit for
    bit, =0 PIL's in both packages; the two differ only by the resize's
    f32 arithmetic against PIL's 8-bit passes (and a JPEG IDCT level)."""
    path = images / name
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("WILDMVS_NATIVE_IO", flag)
        got = loaders.read_images([path], resize_to=(96, 96))
        want = jloaders.read_images([path], resize_to=(96, 96))
        for (g, rg), (w, rw) in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert rg == rw
        out[flag] = got[0]
    native, pil = out["1"][0], out["0"][0]
    assert native.shape == pil.shape
    assert np.abs(native - pil).mean() < 1.0 / 255


# --- the build --------------------------------------------------------------

def module_copy(root: Path) -> Path:
    """The cpp module copied to root/pkg/cpp (its library then goes to
    root/build/native); returns the copy's __init__.py."""
    dst = root / "pkg" / "cpp"
    dst.mkdir(parents=True)
    for name in ("__init__.py", "kdtree.cpp", "image.cpp"):
        shutil.copy(CPP_DIR / name, dst / name)
    return dst / "__init__.py"


def load_copy(init: Path):
    spec = importlib.util.spec_from_file_location(
        f"native_copy_{abs(hash(init))}", init)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe(init: Path, png: Path, background: bool = False):
    """A fresh process that loads the copy: prints the variant that loaded
    and decodes png natively when it can."""
    code = textwrap.dedent(f"""
        import importlib.util
        spec = importlib.util.spec_from_file_location("c", {str(init)!r})
        c = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(c)
        v = c.variant()
        if v == "full":
            (img, r), = c.load_images([{str(png)!r}])
            assert img.shape == (290, 420, 3) and r == 1.0
        print("VARIANT", v)
        """)
    args = [sys.executable, "-c", code]
    if background:
        return subprocess.Popen(args, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    return subprocess.run(args, capture_output=True, text=True, timeout=120)


def test_corrupt_library_is_rebuilt_on_the_next_run(images, tmp_path):
    init = module_copy(tmp_path)
    lib = load_copy(init).library_path("full")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"not an elf file")          # a truncated build
    out = probe(init, images / "a.png")
    assert "VARIANT None" in out.stdout, (out.stdout, out.stderr)
    assert "rebuilding next run" in out.stderr
    assert not lib.exists()                      # dropped for the rebuild
    out = probe(init, images / "a.png")
    assert "VARIANT full" in out.stdout, (out.stdout, out.stderr)
    assert lib.exists()


def test_two_processes_building_at_once_leave_one_library(images, tmp_path):
    init = module_copy(tmp_path)
    procs = [probe(init, images / "a.png", background=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all("VARIANT full" in o for o, _ in outs), outs
    built = sorted(p.name for p in (tmp_path / "build" / "native").iterdir())
    assert built == [load_copy(init).library_path("full").name], built
    assert "VARIANT full" in probe(init, images / "a.png").stdout


def test_kdtree_alone_when_the_image_module_does_not_compile(images,
                                                             tmp_path,
                                                             points):
    """Without libjpeg/libpng headers image.cpp does not compile: the
    library holds the k-d tree alone and the loaders take PIL."""
    init = module_copy(tmp_path)
    src = init.parent / "image.cpp"
    src.write_text("#include <no_such_image_header.h>\n" + src.read_text())
    mod = load_copy(init)
    assert mod.variant() == "kdtree" and not mod.has_image_module()
    assert mod.library_path("kdtree").exists()
    assert not mod.library_path("full").exists()
    with pytest.raises(RuntimeError, match="unavailable"):
        mod.load_images([images / "a.png"])
    pts, q = points
    np.testing.assert_array_equal(mod.NativeKDTree(pts).nn_distance(q, 1.0),
                                  cpp.NativeKDTree(pts).nn_distance(q, 1.0))
