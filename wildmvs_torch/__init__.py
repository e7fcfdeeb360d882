"""wildmvs_torch — the PyTorch/CUDA port of wildmvs for NVIDIA Hopper.

A second package beside `wildmvs/` (the JAX reference). It imports torch and
numpy, never jax and nothing of `wildmvs`. Module names mirror the JAX
package so each counterpart is easy to find:

  geometry/projective.py   build_proj_matrices, scale_K, pixel_grid
  ops/grid_sample.py       border-zero bilinear sampling
  ops/plane_sweep.py       the exact gather sweeps, MVSNet and Vis-MVSNet
                           conventions (the reference path)
  ops/volumes.py           variance/softmin aggregation, depth regression,
                           group-wise correlation, soft-argmin, entropy
  ops/sweep_kernels.py     the Hopper kernels' wrappers + plain versions,
                           the warp's autograd (SweepWarpFn), the planes
  csrc/                    the hand-written CUDA kernels (sweep.cu,
                           warp.cu, footprint.cuh, sampler.cuh; built on
                           first use)
  nn/blocks.py             ConvBnReLU / ConvTransposeBnReLU, BasicBlock /
                           ResLayer / UNet
  models/                  api (registry), MVSNet and Vis-MVSNet (eval and
                           train forward)
  losses/supervised.py     supervised depth losses, resize_bilinear
  data/synthetic.py        SyntheticMVSDataset, collate
  train/                   config, trainer (steps), metrics, checkpoint,
                           cli (the training loop), jax_import
  utils/monitor.py         MeterSet, JSON-lines Logger
  infer.py                 Predictor
  pipeline/depthmaps.py    run_depthmaps

Entry points run on "cuda" unless the caller passes device="cpu".
"""
from .device import resolve_device

__all__ = ["resolve_device"]
