// The bilinear sampler that every plane-sweep kernel of the port shares
// (csrc/sweep.cu, csrc/gwc.cu).
//
// One projection form serves both sweep conventions: for reference pixel
// (y, x) and hypothesis s (per plane [D] or per pixel [D, H, W]),
//   (rx, ry, rz) = P[:, y, x] * s + Q[:, y, x],
//   x = clamp((rz > 0 ? rx / rz : -10) * sx, x_lo, x_hi)   (and y alike)
// in source pixels (mosaic_sweep.py:328-338).
//   MVSNet: integer reference grid, s = depth, unit scale, no clamp
//     (x_lo = -inf, x_hi = +inf): x = rx / rz, and a point behind the
//     camera lands at -10, outside the image.
//   Vis-MVSNet: pixel-centre grid, s = 1 / (depth + 1e-9), scale
//     (sx, sy) = ((w-1)/w, (h-1)/h) and the clamp [-0.05 (w-1),
//     1.05 (w-1)] (the reference's [-1.1, 1.1] normalized clamp,
//     plane_sweep.py:255-256). On a source narrower than 21 px that clamp
//     lies inside (-1, 0) and a clamped or behind-camera sample reads
//     pixel 0, as the gather does; the sampler is exact there too.
// Bilinear, border-zero: a sample is live when floor(x) in [-1, w-1] and
// floor(y) in [-1, h-1] (not NaN), and a corner outside the image reads
// zero. Coordinates (rounded as the plain PyTorch versions round them,
// proj1), weights and the combine are f32; features are bf16 in memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wm {

constexpr int kVec = 8;         // bf16 channels per 16-byte access
constexpr int kThreads = 256;   // threads per block

// The coordinate convention of a sweep (see above).
struct Convention {
  float sx, sy;                 // coordinate scale, after the division
  float x_lo, x_hi, y_lo, y_hi; // clamp in source pixels (+-inf: none)
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// One coordinate of the projective point, p * s + q, rounded after the
// product and after the sum (no fused multiply-add), as the plain PyTorch
// versions compute it: near the camera plane (rz ~ 0) one rounding more or
// less moves the sample visibly, and the kernels must match them there.
__device__ __forceinline__ float proj1(float p, float s, float q) {
  return __fadd_rn(__fmul_rn(p, s), q);
}

// One source coordinate: (rz > 0 ? r / rz : -10) * scale, clamped. A NaN
// stays NaN (dead), as torch.clamp keeps it; with scale 1 and infinite
// bounds the result is r / rz exactly.
__device__ __forceinline__ float coord1(float r, float rz, float scale,
                                        float lo, float hi) {
  const float v = (rz > 0.f ? __fdiv_rn(r, rz) : -10.f) * scale;
  return v < lo ? lo : (v > hi ? hi : v);
}

// True for the MVSNet convention (unit scale, no clamp), which the
// kernels run as their kConv = false instantiation.
inline bool is_identity(const Convention& cv) {
  return cv.sx == 1.f && cv.sy == 1.f && cv.x_lo < -3.0e38f &&
         cv.x_hi > 3.0e38f && cv.y_lo < -3.0e38f && cv.y_hi > 3.0e38f;
}

// The bilinear taps of the sample at (rx, ry, rz): the top-left corner
// (x0, y0) and the fractions (fx, fy). Returns false for a dead sample.
// kConv = false is the MVSNet convention's shorter arithmetic (the same
// result as kConv = true with unit scale and no clamp: a point behind the
// camera is dead either way), which keeps the MVSNet kernels as fast as
// they were without the Vis convention.
template <bool kConv>
__device__ __forceinline__ bool taps(float rx, float ry, float rz,
                                     const Convention& cv, int h, int w,
                                     int& x0, int& y0, float& fx, float& fy) {
  float x, y;
  if (kConv) {
    x = coord1(rx, rz, cv.sx, cv.x_lo, cv.x_hi);
    y = coord1(ry, rz, cv.sy, cv.y_lo, cv.y_hi);
  } else {
    if (!(rz > 0.f)) return false;            // behind the camera
    x = __fdiv_rn(rx, rz);
    y = __fdiv_rn(ry, rz);
  }
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  if (!(x0f >= -1.f && x0f <= (float)(w - 1) &&
        y0f >= -1.f && y0f <= (float)(h - 1)))
    return false;                             // no corner inside (or NaN)
  fx = x - x0f;
  fy = y - y0f;
  x0 = (int)x0f;
  y0 = (int)y0f;
  return true;
}

// The bilinear combine of channels [c0, c0+8) of img [h, w, C] at the taps
// (x0, y0, fx, fy) of a live sample, corners outside the image reading
// zero; adds the result into acc.
__device__ __forceinline__ void corners8(const __nv_bfloat16* __restrict__ img,
                                         int h, int w, int C, int c0, int x0,
                                         int y0, float fx, float fy,
                                         float acc[kVec]) {
  const float wts[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx,
                        fy * (1.f - fx), fy * fx};
  float v[4][kVec];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xi = x0 + (k & 1);
    const int yi = y0 + (k >> 1);
    if (xi >= 0 && xi < w && yi >= 0 && yi < h) {
      load8(img + ((size_t)yi * w + xi) * C + c0, v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[k][i] = 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] += wts[k] * v[k][i];
}

// Bilinear border-zero sample of channels [c0, c0+8) of img [h, w, C] at
// the projective point (rx, ry, rz); adds the result into acc.
template <bool kConv>
__device__ __forceinline__ void sample8(const __nv_bfloat16* __restrict__ img,
                                        int h, int w, int C, int c0,
                                        float rx, float ry, float rz,
                                        const Convention& cv,
                                        float acc[kVec]) {
  int x0, y0;
  float fx, fy;
  if (!taps<kConv>(rx, ry, rz, cv, h, w, x0, y0, fx, fy)) return;
  corners8(img, h, w, C, c0, x0, y0, fx, fy, acc);
}

inline int log2_exact(int g) {
  int l = 0;
  while ((1 << l) < g) ++l;
  return (1 << l) == g ? l : -1;
}

}  // namespace wm
