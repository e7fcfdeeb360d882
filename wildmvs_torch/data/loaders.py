"""Dataset loaders: DTU (train + eval), MegaDepth, BlendedMVS, YFCC scenes.

The port's own copy of wildmvs/data/loaders.py. JPEG and PNG decode and
resize through the native module (wildmvs_torch/cpp/image.cpp, the JAX
package's decoder) unless WILDMVS_NATIVE_IO=0; anything it refuses (other
formats, PNGs of 16 bits, alpha or a palette), or every file when it did
not build, goes through PIL, the JAX package's fallback, and the first
such fall-back prints one line to stderr. MegaDepth depths are read with
h5py and BlendedMVS's augmentation blurs with cv2; each is imported where
it is used and named in the ImportError if missing.

Reference: data/MVSDataset.py (base crop/resize/augment semantics), dtu_yao.py,
md_yao.py, blended.py, dtu_yao_eval.py, yfcc_scene.py. All host-side numpy;
sample dicts are channels-last:
  imgs [N, H, W, 3] float32 in [0,1], K/R [N,3,3], t [N,3,1],
  depth_min/max [N], optionally depth [H, W] + mask [H, W] (reference view),
  filename / src_filenames for eval datasets.

Differences from the reference kept deliberate:
  * channels-last instead of NCHW
  * GT depth is returned [H, W] (the reference keeps a leading 1-channel)
"""
from __future__ import annotations

import os
import sys
import threading
from pathlib import Path

import numpy as np

from .codecs import read_cam_txt, read_pair_txt, read_pfm

MULTI = 32  # resolutions must be multiples of 32 (MVSDataset.py:28)
_fell_back = threading.Event()     # set at the first native-to-PIL fall-back


def _require(module: str, package: str, what: str):
    """Import `module` or raise an ImportError that names `package`."""
    import importlib
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{what} needs the `{package}` package "
                          f"(import {module})") from e


def _native_io_enabled() -> bool:
    return os.environ.get("WILDMVS_NATIVE_IO", "1") != "0"


def read_image(path, resize_to: tuple | None = None):
    """Load an image -> float32 [H, W, 3] in [0,1]; optional min-side resize
    (LANCZOS) like MVSDataset.read_img (MVSDataset.py:102-118).

    Returns (img, resize_ratio r) with r as the reference defines it
    (original / resized). JPEG/PNG route through the native C++ decoder
    (wildmvs_torch/cpp/image.cpp) when built; anything else (or
    WILDMVS_NATIVE_IO=0) falls back to PIL."""
    return read_images([path], resize_to)[0]


def read_images(paths, resize_to: tuple | None = None):
    """Batched read_image: one native call decodes + resizes all files on a
    thread pool (the C call releases the GIL). Returns [(img, r), ...]."""
    if _native_io_enabled():
        from .. import cpp
        try:
            return cpp.load_images(paths, resize_to)
        except RuntimeError as e:   # module unavailable or exotic format
            if not _fell_back.is_set():
                _fell_back.set()
                print(f"wildmvs_torch.data.loaders: decoding with PIL ({e})",
                      file=sys.stderr)
    Image = _require("PIL.Image", "pillow", "reading images")
    out = []
    for path in paths:
        img = Image.open(path)
        r = 1.0
        if resize_to is not None:
            w, h = img.size
            th, tw = resize_to
            r = min(w / tw, h / th)
            img = img.resize((int(w / r), int(h / r)), resample=Image.LANCZOS)
        out.append((np.asarray(img, dtype=np.float32) / 255.0, r))
    return out


def stack_views(imgs: list):
    """Stack per-view images when they share a shape; otherwise return the
    list unchanged (the reference's in-the-wild test samples carry per-view
    sizes and return lists, md_yao.py:126 / yfcc_scene.py:78; models accept
    both forms)."""
    if len({im.shape for im in imgs}) == 1:
        return np.stack(imgs)
    return imgs


def center_crop(im: np.ndarray, K: np.ndarray | None = None,
                depth: np.ndarray | None = None, mode: str = "train",
                height: int = 512, width: int = 640):
    """Center crop (train) or crop-to-/32 from the top-left (test), adjusting
    the principal point. Parity: MVSDataset.py:68-100."""
    h, w = im.shape[:2]
    if mode == "test":
        nh, nw = (h // MULTI) * MULTI, (w // MULTI) * MULTI
        ch = cw = 0
    else:
        nh, nw = height, width
        ch, cw = (h - nh) // 2, (w - nw) // 2
    out = [im[ch:ch + nh, cw:cw + nw]]
    if K is not None:
        K = K.copy()
        K[0, 2] -= cw
        K[1, 2] -= ch
        out.append(K)
    if depth is not None:
        out.append(depth[ch:ch + nh, cw:cw + nw])
    return out


def rescale_calib(r: float, K: np.ndarray) -> np.ndarray:
    """Scale K for a 1/r image resize. Parity: MVSDataset.py:58-66."""
    out = K.copy()
    out[:2] /= r
    return out


def read_yao_cam(path):
    """Yao cam.txt -> (K, R, t, depth_min, depth_interval).
    Parity: dtu_yao.py:71-82."""
    cam = read_cam_txt(path)
    ext = cam["extrinsic"].astype(np.float32)
    K = cam["intrinsic"].astype(np.float32)
    return (K, ext[:3, :3], ext[:3, 3:],
            float(cam.get("depth_min", 0.0)),
            float(cam.get("depth_interval", 0.0)))


def augment_image(img_pil, rng: np.random.Generator):
    """Color jitter + motion blur (BlendedMVS only).
    Parity: MVSDataset.py:124-150."""
    cv2 = _require("cv2", "opencv-python", "BlendedMVS augmentation")
    ImageEnhance = _require("PIL.ImageEnhance", "pillow",
                            "BlendedMVS augmentation")
    b = 1.0 + (rng.random() * 2 - 1) * (50 / 255)
    c = rng.uniform(0.3, 1.5)
    img_pil = ImageEnhance.Brightness(img_pil).enhance(b)
    img_pil = ImageEnhance.Contrast(img_pil).enhance(c)
    img = np.asarray(img_pil, np.float32) / 255.0
    # motion blur kernel (ksize in {1,3}, gaussian-weighted line)
    ksize = int(rng.integers(0, 2)) * 2 + 1
    if ksize > 1:
        mode = rng.choice(["h", "v", "diag_down", "diag_up"])
        center = (ksize - 1) // 2
        kernel = np.zeros((ksize, ksize))
        if mode == "h":
            kernel[center, :] = 1.0
        elif mode == "v":
            kernel[:, center] = 1.0
        elif mode == "diag_down":
            kernel = np.eye(ksize)
        else:
            kernel = np.flip(np.eye(ksize), 0)
        var = ksize * ksize / 16.0
        grid = np.repeat(np.arange(ksize)[:, None], ksize, axis=-1)
        gauss = np.exp(-((grid - center) ** 2 + (grid.T - center) ** 2)
                       / (2 * var))
        kernel = kernel * gauss
        kernel /= kernel.sum()
        img = cv2.filter2D(img, -1, kernel)
    return img


class DTUTrainDataset:
    """DTU training set (Yao preprocessing). Parity: data/dtu_yao.py.

    Topology: Cameras/pair.txt (49 views), 7 light conditions per view,
    192-interval depth range, 512x640 images, intrinsics stored at 1/4
    (multiplied back by 4)."""

    def __init__(self, datapath, scan_list, mode: str, nviews: int,
                 return_depth: bool = False, subsample_seed: int | None = 0):
        self.datapath = Path(datapath)
        self.mode = mode
        self.nviews = nviews
        self.return_depth = return_depth or mode == "test"
        pairs = read_pair_txt(self.datapath / "Cameras" / "pair.txt")
        self.metas = [(f"scan{s}", light, ref, srcs)
                      for s in scan_list
                      for (ref, srcs) in pairs
                      for light in range(7)]
        if mode != "train":
            # fixed-seed 1000-sample subset (dtu_yao.py:34-35)
            rng = np.random.RandomState(subsample_seed)
            sel = rng.choice(len(self.metas), min(1000, len(self.metas)),
                             replace=False)
            self.metas = [self.metas[i] for i in sel]

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx):
        scan, light, ref, srcs = self.metas[idx]
        view_ids = [ref] + srcs[:self.nviews - 1]
        imgs, Ks, Rs, ts = [], [], [], []
        depth = mask = None
        depth_min = depth_max = 0.0
        decoded = read_images([
            self.datapath / "Rectified" / f"{scan}_train"
            / f"rect_{vid + 1:03d}_{light}_r5000.png" for vid in view_ids])
        for i, vid in enumerate(view_ids):
            cam_file = self.datapath / "Cameras" / "train" / f"{vid:08d}_cam.txt"
            im, _ = decoded[i]
            K, R, t, dmin, dint = read_yao_cam(cam_file)
            K = K.copy()
            K[:2] *= 4  # stored at 1/4 res (dtu_yao.py:107)
            im, K = center_crop(im, K=K, mode=self.mode, height=512, width=640)
            imgs.append(im)
            Ks.append(K)
            Rs.append(R)
            ts.append(t)
            if i == 0:
                depth_min, depth_max = dmin, dmin + 192 * dint
                if self.return_depth:
                    mfile = (self.datapath / "Depths" / f"{scan}_train"
                             / f"depth_visual_{vid:04d}.png")
                    dfile = (self.datapath / "Depths" / f"{scan}_train"
                             / f"depth_map_{vid:04d}.pfm")
                    mask, _ = read_image(mfile)
                    if mask.ndim == 3:
                        mask = mask[..., 0]
                    depth = read_pfm(dfile)[0].astype(np.float32)
        n = self.nviews
        ret = {"imgs": np.stack(imgs), "K": np.stack(Ks), "R": np.stack(Rs),
               "t": np.stack(ts),
               "depth_min": np.full((n,), depth_min, np.float32),
               "depth_max": np.full((n,), depth_max, np.float32)}
        if self.return_depth:
            ret["depth"] = depth
            ret["mask"] = (mask > 0.5).astype(np.float32)
        return ret


class MegaDepthDataset:
    """Preprocessed MegaDepth n-uplets. Parity: data/md_yao.py.

    Files per sample: im_{i}_{v}.jpg, infos_{i}.npz {K,R,t,min_d,max_d},
    depth_{i}[_{v}].h5; 512x512 train crops with LANCZOS min-side resize."""

    def __init__(self, datapath, scene_list, mode: str, nviews: int,
                 return_depth: bool = False, max_per_scene: int = 1000):
        import os
        sub = "test" if mode == "val" else mode
        self.p = Path(datapath) / sub
        self.mode = mode
        self.nviews = nviews
        self.return_depth = return_depth
        self.items = []
        for scene in scene_list:
            sp = self.p / scene
            if not sp.exists():
                continue
            try:
                existing = set(os.listdir(sp))
            except OSError:
                continue
            for cpt in range(max_per_scene):
                ok = all(f"im_{cpt}_{v}.jpg" in existing
                         for v in range(nviews))
                ok = ok and f"infos_{cpt}.npz" in existing
                if mode == "test" and f"depth_{cpt}.h5" not in existing:
                    ok = ok and all(f"depth_{cpt}_{v}.h5" in existing
                                    for v in range(nviews))
                elif return_depth:
                    ok = ok and f"depth_{cpt}.h5" in existing
                if ok:
                    self.items.append((scene, cpt))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        h5py = _require("h5py", "h5py", "MegaDepth depth maps")
        scene, cpt = self.items[idx]
        sp = self.p / scene
        npz = np.load(sp / f"infos_{cpt}.npz")
        n = self.nviews
        K = npz["K"].astype(np.float32)[:n].copy()
        R = npz["R"].astype(np.float32)[:n]
        t = npz["t"].astype(np.float32)[:n]
        if t.ndim == 2:
            t = t[..., None]
        depth = None
        # the reference loads depth only for mode=="train" (md_yao.py:81-84)
        # and then dereferences it for val too (md_yao.py:121-123) — a latent
        # NameError there; we load it for every non-test split, matching the
        # intended behavior (and the reference's own DTU loader).
        if self.return_depth and self.mode != "test":
            with h5py.File(sp / f"depth_{cpt}.h5", "r") as f:
                depth = np.array(f["depth"], np.float32)
        imgs = []
        decoded = read_images([sp / f"im_{cpt}_{v}.jpg" for v in range(n)],
                              resize_to=(512, 512) if self.mode == "train"
                              else None)
        for v in range(n):
            im, r = decoded[v]
            newK = rescale_calib(r, K[v])
            if depth is not None and v == 0:
                # nearest-resize depth to the image, then crop together —
                # index map floor(i * in/out) with the scale AND product in
                # float32, exactly torch's F.interpolate(mode="nearest") CPU
                # kernel (md_yao.py:100-101; bit-for-bit at column 2*out=in
                # boundaries where float64 rounds the other way)
                nh, nw = im.shape[:2]
                dh, dw = depth.shape
                ys = np.floor(np.arange(nh, dtype=np.float32)
                              * (np.float32(dh) / np.float32(nh)))
                xs = np.floor(np.arange(nw, dtype=np.float32)
                              * (np.float32(dw) / np.float32(nw)))
                ys = np.minimum(ys.astype(np.int64), dh - 1)
                xs = np.minimum(xs.astype(np.int64), dw - 1)
                depth = depth[np.ix_(ys, xs)]
                im, newK, depth = center_crop(im, K=newK, depth=depth,
                                              mode=self.mode, height=512,
                                              width=512)
            else:
                im, newK = center_crop(im, K=newK, mode=self.mode,
                                       height=512, width=512)
            K[v] = newK
            imgs.append(im)
        ret = {"imgs": stack_views(imgs), "K": K, "R": R, "t": t,
               "depth_min": npz["min_d"].astype(np.float32)[:n],
               "depth_max": npz["max_d"].astype(np.float32)[:n]}
        if self.mode == "test":
            try:
                depths, masks = [], []
                for v in range(n):
                    with h5py.File(sp / f"depth_{cpt}_{v}.h5", "r") as f:
                        d = np.array(f["depth"], np.float32)
                    depths.append(d)
                    masks.append(d > 0)
            except OSError:
                with h5py.File(sp / f"depth_{cpt}.h5", "r") as f:
                    d = np.array(f["depth"], np.float32)
                depths, masks = [d], [d > 0]
            ret["depth"] = depths[0]
            ret["mask"] = masks[0].astype(np.float32)
            ret["depth_list"] = depths
            ret["mask_list"] = masks
        elif self.return_depth:
            ret["depth"] = depth
            ret["mask"] = ((depth >= ret["depth_min"][0])
                           & (depth < ret["depth_max"][0])).astype(np.float32)
        return ret


class BlendedMVSDataset:
    """BlendedMVS. Parity: data/blended.py — 576x768 crops, cam.txt with an
    asserted 128-interval range, masks = in-range depth, augmentation on for
    training."""

    def __init__(self, datapath, scene_list, mode: str, nviews: int,
                 return_depth: bool = True, augment: bool = True, seed: int = 0):
        self.datapath = Path(datapath)
        self.mode = mode
        self.nviews = nviews
        self.return_depth = return_depth or mode == "test"
        self.augment = augment and mode == "train"
        self.rng = np.random.default_rng(seed)
        self.metas = []
        for scene in scene_list:
            pair_path = self.datapath / scene / "cams" / "pair.txt"
            if not pair_path.exists():
                continue
            for ref, srcs in read_pair_txt(pair_path):
                if len(srcs) >= nviews - 1:
                    self.metas.append((scene, ref, srcs))

    def __len__(self):
        return len(self.metas)

    def _read_cam(self, path):
        cam = read_cam_txt(path)
        assert cam.get("depth_count") == 128, path  # blended.py:80
        ext = cam["extrinsic"].astype(np.float32)
        return (cam["intrinsic"].astype(np.float32), ext[:3, :3], ext[:3, 3:],
                float(cam["depth_min"]), float(cam["depth_interval"]))

    def __getitem__(self, idx):
        scene, ref, srcs = self.metas[idx]
        view_ids = [ref] + srcs[:self.nviews - 1]
        imgs, Ks, Rs, ts, ranges = [], [], [], [], []
        depth = None
        decoded = None
        if not self.augment:
            decoded = read_images([
                self.datapath / scene / "blended_images" / f"{vid:08d}.jpg"
                for vid in view_ids])
        for i, vid in enumerate(view_ids):
            name = f"{vid:08d}"
            img_file = self.datapath / scene / "blended_images" / f"{name}.jpg"
            if self.augment:
                Image = _require("PIL.Image", "pillow", "reading images")
                pil = Image.open(img_file)
                im = augment_image(pil, self.rng)
            else:
                im, _ = decoded[i]
            K, R, t, dmin, dint = self._read_cam(
                self.datapath / scene / "cams" / f"{name}_cam.txt")
            if i == 0 and self.return_depth:
                dfile = (self.datapath / scene / "rendered_depth_maps"
                         / f"{name}.pfm")
                depth = read_pfm(dfile)[0].astype(np.float32)
                im, K, depth = center_crop(im, K=K, depth=depth,
                                           mode=self.mode, height=576,
                                           width=768)
            else:
                im, K = center_crop(im, K=K, mode=self.mode, height=576,
                                    width=768)
            imgs.append(im)
            Ks.append(K)
            Rs.append(R)
            ts.append(t)
            ranges.append((dmin, dint))
        dmin0, dint0 = ranges[0]
        dmax0 = dmin0 + 128 * dint0
        ret = {"imgs": np.stack(imgs), "K": np.stack(Ks), "R": np.stack(Rs),
               "t": np.stack(ts),
               "depth_min": np.array([r[0] for r in ranges], np.float32),
               "depth_max": np.array([r[0] + 128 * r[1] for r in ranges],
                                     np.float32)}
        if self.return_depth:
            ret["depth"] = depth
            ret["mask"] = ((depth < dmax0) & (depth > dmin0)).astype(np.float32)
        return ret


class DTUEvalDataset:
    """DTU evaluation scans at full resolution. Parity: data/dtu_yao_eval.py:
    per-scan layout scan{N}/{pair.txt,images/,cams/} (dtu_yao_eval.py:46-47,
    :88-89), crop to /32, per-view depth range with the interval scaled by
    192/128 then max = min + 128*interval (= min + 192*raw interval,
    dtu_yao_eval.py:73-74,:93)."""

    def __init__(self, datapath, scan: str, nviews: int):
        self.datapath = Path(datapath)
        self.scan = scan
        self.nviews = nviews
        self.pairs = read_pair_txt(self.datapath / scan / "pair.txt")

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx):
        ref, srcs = self.pairs[idx]
        view_ids = [ref] + srcs[:self.nviews - 1]
        imgs, Ks, Rs, ts, dmins, dmaxs = [], [], [], [], [], []
        decoded = read_images([
            self.datapath / self.scan / "images" / f"{vid:08d}.jpg"
            for vid in view_ids])
        for i, vid in enumerate(view_ids):
            cam_file = self.datapath / self.scan / "cams" / f"{vid:08d}_cam.txt"
            im, _ = decoded[i]
            K, R, t, d0, dint = read_yao_cam(cam_file)
            im, K = center_crop(im, K=K, mode="test")
            imgs.append(im)
            Ks.append(K)
            Rs.append(R)
            ts.append(t)
            dmins.append(d0)
            dmaxs.append(d0 + dint * 192)
        return {"imgs": np.stack(imgs), "K": np.stack(Ks), "R": np.stack(Rs),
                "t": np.stack(ts),
                "depth_min": np.array(dmins, np.float32),
                "depth_max": np.array(dmaxs, np.float32),
                "filename": f"{ref:08d}",
                "src_filenames": [f"{v:08d}" for v in srcs[:self.nviews - 1]]}


class YFCCSceneDataset:
    """In-the-wild scene from a COLMAP sparse model. Parity:
    data/yfcc_scene.py + utils/colmap_utils.py:52-155 — view selection by
    co-visible points with a >=75% well-triangulated gate, depth range from
    the 1/99th percentiles of each view's sparse points."""

    def __init__(self, datapath, scene: str, nviews: int,
                 min_triangulation_angle: float = 5.0):
        from . import colmap_model as cm
        from .colmap_utils import (compute_min_max_depth,
                                   compute_src_images, get_calib_from_sparse)
        self.datapath = Path(datapath)
        self.scene = scene
        self.nviews = nviews
        cameras, images, points3d = cm.read_model(
            self.datapath / "sparse" / scene)
        ordered = list(images.keys())
        self.names = [images[i].name for i in ordered]
        self.K, self.R, self.t, _ = get_calib_from_sparse(cameras, images)
        self.src_imgs = compute_src_images(images, points3d, self.R, self.t,
                                           min_triangulation_angle, nviews - 1)
        self.depth_min, self.depth_max = compute_min_max_depth(
            points3d, images, self.K, self.R, self.t)
        self.imgs = []
        for im, _ in read_images(
                [self.datapath / "images" / scene / n for n in self.names]):
            (im,) = center_crop(im, mode="test")
            self.imgs.append(im)

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, idx):
        view_ids = [idx] + list(self.src_imgs[idx])
        return {"imgs": stack_views([self.imgs[i] for i in view_ids]),
                "K": self.K[view_ids], "R": self.R[view_ids],
                "t": self.t[view_ids],
                "depth_min": self.depth_min[view_ids].astype(np.float32),
                "depth_max": self.depth_max[view_ids].astype(np.float32),
                "filename": self.names[idx].split(".")[0],
                "src_filenames": [self.names[i].split(".")[0]
                                  for i in self.src_imgs[idx]]}


# ------------------------- construction helpers ----------------------------

def scene_list(name: str) -> list[str]:
    """Load a scene list shipped with the package (data/txt parity)."""
    p = Path(__file__).parent / "txt" / f"{name}.txt"
    return [l.strip() for l in p.read_text().splitlines() if l.strip()]


def build_datasets(config):
    """(train, val, test) datasets for a TrainConfig. Parity: train.py:67-104."""
    nv = config.num_im_train
    override = getattr(config, "data_path", None)
    if config.dataset == "dtu":
        root = Path(override or "datasets/dtu_training")
        train = DTUTrainDataset(root, scene_list("dtu_train"), "train", nv,
                                return_depth=config.supervised)
        val = DTUTrainDataset(root, scene_list("dtu_val"), "val", nv,
                              return_depth=config.supervised)
        test = DTUTrainDataset(root, scene_list("dtu_val"), "test", 5)
        return train, val, test
    if config.dataset == "md":
        root = Path(override or "datasets/megadepth")
        train = MegaDepthDataset(root, scene_list("md_train"), "train", nv,
                                 return_depth=config.supervised)
        val = MegaDepthDataset(root, scene_list("md_train"), "val", nv,
                               return_depth=config.supervised)
        test = MegaDepthDataset(root, scene_list("md_test"), "test", 5)
        return train, val, test
    if config.dataset == "blended":
        root = Path(override or "datasets/BlendedMVS")
        # the reference forces return_depth=True for BlendedMVS regardless of
        # supervision (blended.py:44) — keep that default; passing
        # return_depth=False explicitly skips the PFM reads (our extension)
        train = BlendedMVSDataset(root, scene_list("blended_train"), "train",
                                  nv)
        val = BlendedMVSDataset(root, scene_list("blended_val"), "val", nv)
        test = BlendedMVSDataset(root, scene_list("blended_val"), "test", 5)
        return train, val, test
    raise ValueError(config.dataset)


def build_eval_dataset(name: str, data_path: str, scene: str, nviews: int = 5):
    if name == "dtu":
        return DTUEvalDataset(data_path, scene, nviews)
    if name == "yfcc":
        return YFCCSceneDataset(data_path, scene, nviews)
    raise ValueError(name)
