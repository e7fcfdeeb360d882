"""wildmvs_torch — the PyTorch/CUDA port of wildmvs for NVIDIA Hopper.

A second package beside `wildmvs/` (the JAX reference). It imports torch and
numpy, never jax and nothing of `wildmvs`. Module names mirror the JAX
package so each counterpart is easy to find:

  device.py                resolve_device ("cuda" unless asked for "cpu")
  geometry/projective.py   build_proj_matrices, scale_K, pixel_grid,
                           project(_all), unproject, flows, triangulation
                           angles, quat_to_rot / rot_to_quat, relative_pose
  ops/grid_sample.py       border-zero bilinear sampling
  ops/plane_sweep.py       the exact gather sweeps, MVSNet and Vis-MVSNet
                           conventions (the reference path)
  ops/volumes.py           variance/softmin aggregation, depth regression,
                           group-wise correlation, soft-argmin, entropy
  ops/sweep_kernels.py     the Hopper kernels' wrappers + plain versions,
                           the warp's autograd (SweepWarpFn), the planes
  ops/rect_sweep.py        the rectified sweep (canvas resample + the
                           fused / gwc kernels on rect planes)
  ops/resize.py            CVP-MVSNet's pyramid resizes
  ops/select.py            masked order statistics (the masked median)
  csrc/, _build.py         the hand-written CUDA kernels (sweep.cu,
                           warp.cu, footprint.cuh, sampler.cuh) and their
                           nvcc build (first use, build/kernels/)
  cpp/                     the native host helpers, g++ on first use into
                           build/native/: k-d tree (NN distance, radius
                           dedup), JPEG/PNG decode, Lanczos-3 resize
  nn/blocks.py             ConvBnReLU / ConvTransposeBnReLU, BasicBlock /
                           ResLayer / UNet, frozen and synced BatchNorm
  models/                  api (registry), MVSNet, Vis-MVSNet and
                           CVP-MVSNet (eval and train forward)
  losses/supervised.py     supervised depth losses, resize_bilinear
  losses/ssim.py           the DSSIM map (11x11 Gaussian window, f32)
  losses/photometric.py    unsupervised photometric losses, occlusion
                           masking
  data/synthetic.py        SyntheticMVSDataset, SyntheticSceneDataset,
                           render_rig_plane, collate
  data/loaders.py          DTU (train, eval), MegaDepth, BlendedMVS and
                           YFCC datasets (native decode, PIL fallback)
  data/prefetch.py         the in-order background sample pool
  data/codecs.py           PFM, Yao cam txt, Gipuma DMB, COLMAP arrays
  data/colmap_model.py,    COLMAP sparse models; calibration, depth
  data/colmap_utils.py     ranges, source-view selection
  data/matching.py         the matching front end (sparse models for
                           scenes with known poses)
  data/preprocess_megadepth.py  the MegaDepth n-uplet generator
  data/ply.py              PLY read / write
  data/txt/                the scene lists
  train/                   config, trainer (steps, remat), metrics,
                           checkpoint, cli (the training loop, one rank or
                           N), jax_import, orbax_read (JAX checkpoints
                           without JAX)
  dist/mesh.py             torch.distributed: (data, view, hyp) process
                           groups, use_mesh, slab gathers, gradient sums
  dist/view_parallel.py    view-parallel occlusion-masked training
  utils/monitor.py         MeterSet, JSON-lines Logger, StageTimer,
                           profiler_trace, span (a trace range while a
                           profiler records, named wildmvs_torch.<part>)
  entry.py                 entry() and dryrun_multichip(n)
  infer.py                 Predictor
  pipeline/depthmaps.py    run_depthmaps, eval_model_kwargs
  pipeline/filtering.py    geometric_filter
  pipeline/fusion.py       fuse_depthmaps
  pipeline/metrics3d.py    DTU and YFCC point-cloud metrics (native
                           k-d tree, scipy fallback)
  pipeline/classic.py      the classic ZNCC plane-sweep baseline
  pipeline/depthmap_eval.py  the depthmap benchmark CLI
  pipeline/export.py       Gipuma / COLMAP workspace exporters
  pipeline/reconstruction.py  run_pipeline and its CLI

Entry points run on "cuda" unless the caller passes device="cpu".
`Predictor` and `build_model` resolve lazily: importing the package loads
no kernel module, no CUDA library and no native library.
"""
from .device import resolve_device

__version__ = "0.1.0"
__all__ = ["Predictor", "build_model", "resolve_device"]


def __getattr__(name):
    # lazy top-level conveniences (PEP 562): keep `import wildmvs_torch` light
    if name == "Predictor":
        from .infer import Predictor
        return Predictor
    if name == "build_model":
        from .models import build_model
        return build_model
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
