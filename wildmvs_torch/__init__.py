"""wildmvs_torch — the PyTorch/CUDA port of wildmvs for NVIDIA Hopper.

A second package beside `wildmvs/` (the JAX reference). It imports torch and
numpy, never jax and nothing of `wildmvs`. Module names mirror the JAX
package so each counterpart is easy to find:

  geometry/projective.py   build_proj_matrices, scale_K, pixel_grid,
                           project(_all), unproject, flows, triangulation
                           angles
  ops/grid_sample.py       border-zero bilinear sampling
  ops/plane_sweep.py       the exact gather sweeps, MVSNet and Vis-MVSNet
                           conventions (the reference path)
  ops/volumes.py           variance/softmin aggregation, depth regression,
                           group-wise correlation, soft-argmin, entropy
  ops/sweep_kernels.py     the Hopper kernels' wrappers + plain versions,
                           the warp's autograd (SweepWarpFn), the planes
  ops/rect_sweep.py        the rectified sweep (canvas resample + the
                           fused / gwc kernels on rect planes)
  csrc/                    the hand-written CUDA kernels (sweep.cu,
                           warp.cu, footprint.cuh, sampler.cuh; built on
                           first use)
  nn/blocks.py             ConvBnReLU / ConvTransposeBnReLU, BasicBlock /
                           ResLayer / UNet, frozen and synced BatchNorm
  models/                  api (registry), MVSNet, Vis-MVSNet and
                           CVP-MVSNet (eval and train forward)
  losses/supervised.py     supervised depth losses, resize_bilinear
  data/synthetic.py        SyntheticMVSDataset, SyntheticSceneDataset,
                           render_rig_plane, collate
  data/ply.py              PLY read / write
  train/                   config, trainer (steps, remat), metrics,
                           checkpoint, cli (the training loop, one rank or
                           N), jax_import
  dist/mesh.py             torch.distributed: (data, view, hyp) process
                           groups, use_mesh, slab gathers, gradient sums
  dist/view_parallel.py    view-parallel occlusion-masked training
  utils/monitor.py         MeterSet, JSON-lines Logger, StageTimer,
                           profiler_trace
  entry.py                 entry() and dryrun_multichip(n)
  infer.py                 Predictor
  pipeline/depthmaps.py    run_depthmaps, eval_model_kwargs
  pipeline/filtering.py    geometric_filter
  pipeline/fusion.py       fuse_depthmaps
  pipeline/metrics3d.py    DTU and YFCC point-cloud metrics
  pipeline/reconstruction.py  run_pipeline and its CLI

Entry points run on "cuda" unless the caller passes device="cpu".
"""
from .device import resolve_device

__all__ = ["resolve_device"]
