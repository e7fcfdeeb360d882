"""wildmvs_torch — the PyTorch/CUDA port of wildmvs for NVIDIA Hopper.

A second package beside `wildmvs/` (the JAX reference). It imports torch and
numpy, never jax and nothing of `wildmvs`. Module names mirror the JAX
package so each counterpart is easy to find:

  geometry/projective.py   build_proj_matrices, scale_K, pixel_grid
  ops/grid_sample.py       border-zero bilinear sampling
  ops/plane_sweep.py       the exact f32 gather sweep (the reference path)
  ops/volumes.py           variance/softmin aggregation, depth regression
  ops/sweep_kernels.py     the Hopper kernels' wrappers + plain versions
  csrc/sweep.cu            the hand-written CUDA kernels (built on first use)
  nn/blocks.py             ConvBnReLU / ConvTransposeBnReLU
  models/                  api (registry) + MVSNet
  train/jax_import.py      JAX params -> port state_dict
  infer.py                 Predictor
  pipeline/depthmaps.py    run_depthmaps

Entry points run on "cuda" unless the caller passes device="cpu".
"""
from .device import resolve_device

__all__ = ["resolve_device"]
