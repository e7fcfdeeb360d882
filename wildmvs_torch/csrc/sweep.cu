// Plane-sweep kernels for Hopper (sm_90a): the per-view warp and the fused
// multi-view cost volume of the MVSNet depthmap forward.
//
// Both replace Pallas TPU kernels of wildmvs/ops/mosaic_sweep.py:
//   wm_sweep_warp         <- _kernel / mosaic_sweep_warp        (:143-270)
//   wm_fused_cost_volume  <- _kernel_fused / fused_cost_volume_px (:811-1117)
// They compute what those kernels compute, not how: a Hopper gather has no
// lane window and no VMEM budget, so the TPU's corner table, span plans,
// window tiers and exact-gather fallbacks have no counterpart here, and
// both kernels are exact for any rig geometry.
//
// One projection form serves both: for reference pixel (y, x) and
// hypothesis s (a depth; per plane [D] or per pixel [D, H, W]),
//   (rx, ry, rz) = P[:, y, x] * s + Q[:, y, x],   coords = (rx, ry) / rz,
// in source pixel units (MVSNet integer grid). rz <= 0 (behind the camera)
// samples nothing. Bilinear, border-zero: a sample is live when
// floor(x) in [-1, w-1] and floor(y) in [-1, h-1], and a corner outside the
// image reads zero. Coordinates, weights and the combine are f32; features
// are bf16 in memory; outputs are rounded once to bf16 (round to nearest
// even).
//
// Layout: features channels-last [.., h, w, C] bf16; outputs [B, D, H, W, C]
// bf16. One thread owns one (d, y, x, 8-channel group): a group is one
// 16-byte load per corner, and the C/8 threads of a pixel are neighbours,
// so a warp reads each corner of a pixel as one contiguous C*2-byte run and
// writes a contiguous run of output. Both kernels are bound by the bytes
// of the output volume they write (the source maps, 1-10 MB, stay in the
// 50 MB L2).
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;         // bf16 channels per thread (16 bytes)
constexpr int kThreads = 256;   // threads per block

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

// Bilinear border-zero sample of channels [c0, c0+8) of img [h, w, C] at
// the projective point (rx, ry, rz); adds the result into acc.
__device__ __forceinline__ void sample8(const __nv_bfloat16* __restrict__ img,
                                        int h, int w, int C, int c0,
                                        float rx, float ry, float rz,
                                        float acc[kVec]) {
  if (!(rz > 0.f)) return;                    // behind the camera
  const float x = rx / rz;
  const float y = ry / rz;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  if (!(x0f >= -1.f && x0f <= (float)(w - 1) &&
        y0f >= -1.f && y0f <= (float)(h - 1)))
    return;                                   // no corner inside (or NaN)
  const float fx = x - x0f;
  const float fy = y - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
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

// ---------------------------------------------------------------------------
// Per-view warp: src [B, h, w, C] -> out [B, D, H, W, C].
// grid (ceil(H*W*G / kThreads), D, B), G = C / 8 threads per pixel.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sweep_warp_kernel(const __nv_bfloat16* __restrict__ src,
                  const float* __restrict__ P, const float* __restrict__ Q,
                  const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
                  int D, int H, int W, int h, int w, int C, int log2g,
                  int s_per_pixel) {
  const int d = blockIdx.y;
  const int b = blockIdx.z;
  const int hw = H * W;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= (hw << log2g)) return;
  const int g = t & ((1 << log2g) - 1);
  const int pix = t >> log2g;                   // y * W + x

  const size_t plane = (size_t)b * 3 * hw + pix;
  const float sv = s_per_pixel ? s[((size_t)b * D + d) * hw + pix]
                               : s[(size_t)b * D + d];
  const float rx = P[plane] * sv + Q[plane];
  const float ry = P[plane + hw] * sv + Q[plane + hw];
  const float rz = P[plane + 2 * hw] * sv + Q[plane + 2 * hw];

  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
  sample8(src + (size_t)b * h * w * C, h, w, C, g * kVec, rx, ry, rz, acc);
  store8(out + (((size_t)b * D + d) * hw + pix) * C + g * kVec, acc);
}

// ---------------------------------------------------------------------------
// Fused cost volume: ref [B, H, W, C], srcs [B, NV, h, w, C],
// P/Q [B, NV, 3, H, W] -> out [B, D, H, W, C].
//   agg 0 (variance): E[f^2] - E[f]^2 over the NV+1 views, the reference
//     term included (models/MVSNet/model.py:113-139).
//   agg 1 (softmin): sum_v e_v * diff_v / (sum_v e_v + 1e-6), with
//     diff_v = (ref - warped_v)^2 and e_v = exp(-temp * sum_c diff_v)
//     (model.py:141-173). The channel sum crosses the G threads of a pixel
//     by xor-shuffles, so G must be a power of two <= 32.
// Warped values never leave registers; only the final volume is written.
// temp is a device pointer (no host sync for the learned temperature).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
fused_cost_volume_kernel(const __nv_bfloat16* __restrict__ ref,
                         const __nv_bfloat16* __restrict__ srcs,
                         const float* __restrict__ P,
                         const float* __restrict__ Q,
                         const float* __restrict__ s,
                         const float* __restrict__ temp,
                         __nv_bfloat16* __restrict__ out,
                         int NV, int D, int H, int W, int h, int w, int C,
                         int log2g, int s_per_pixel, int agg) {
  const int d = blockIdx.y;
  const int b = blockIdx.z;
  const int hw = H * W;
  const int n_thr = hw << log2g;
  const int t0 = blockIdx.x * kThreads + threadIdx.x;
  // Threads past the end redo the last pixel and store nothing: every lane
  // must reach the shuffles below. n_thr is a multiple of G, so a G-lane
  // group is either wholly live or wholly idle.
  const bool live = t0 < n_thr;
  const int t = live ? t0 : n_thr - 1;
  const int g = t & ((1 << log2g) - 1);
  const int pix = t >> log2g;
  const int c0 = g * kVec;

  float refv[kVec];
  load8(ref + ((size_t)b * hw + pix) * C + c0, refv);
  const float sv = s_per_pixel ? s[((size_t)b * D + d) * hw + pix]
                               : s[(size_t)b * D + d];
  const float tmp = agg ? temp[0] : 0.f;

  float a1[kVec], a2[kVec];   // variance: sum, sum of squares
                              // softmin: a1 = sum e*diff, a2 unused
  float sum_exp = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    a1[i] = agg ? 0.f : refv[i];
    a2[i] = agg ? 0.f : refv[i] * refv[i];
  }
  const size_t src_stride = (size_t)h * w * C;
  for (int v = 0; v < NV; ++v) {
    const size_t bv = (size_t)b * NV + v;
    const size_t plane = bv * 3 * hw + pix;
    const float rx = P[plane] * sv + Q[plane];
    const float ry = P[plane + hw] * sv + Q[plane + hw];
    const float rz = P[plane + 2 * hw] * sv + Q[plane + 2 * hw];
    float wv[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) wv[i] = 0.f;
    sample8(srcs + bv * src_stride, h, w, C, c0, rx, ry, rz, wv);
    if (agg == 0) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        a1[i] += wv[i];
        a2[i] += wv[i] * wv[i];
      }
    } else {
      float diff[kVec];
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float dlt = refv[i] - wv[i];
        diff[i] = dlt * dlt;
        part += diff[i];
      }
      for (int o = (1 << log2g) >> 1; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      const float e = expf(-tmp * part);
      sum_exp += e;
#pragma unroll
      for (int i = 0; i < kVec; ++i) a1[i] += e * diff[i];
    }
  }
  float cv[kVec];
  if (agg == 0) {
    const float n = (float)(NV + 1);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float mean = a1[i] / n;
      cv[i] = a2[i] / n - mean * mean;
    }
  } else {
    const float den = sum_exp + 1e-6f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) cv[i] = a1[i] / den;
  }
  if (live) store8(out + (((size_t)b * D + d) * hw + pix) * C + c0, cv);
}

int log2_exact(int g) {
  int l = 0;
  while ((1 << l) < g) ++l;
  return (1 << l) == g ? l : -1;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success);
// cudaErrorInvalidValue for arguments the kernel does not take.
int wm_sweep_warp(const void* src, const void* P, const void* Q,
                  const void* s, void* out, int B, int D, int H, int W,
                  int h, int w, int C, int s_per_pixel, void* stream) {
  const int log2g = (C % kVec) ? -1 : log2_exact(C / kVec);
  if (log2g < 0 || B <= 0 || D <= 0 || H <= 0 || W <= 0 || h <= 0 ||
      w <= 0 || B > 65535 || D > 65535)
    return (int)cudaErrorInvalidValue;
  const long long n_thr = (long long)H * W << log2g;
  if (n_thr > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_thr + kThreads - 1) / kThreads), D, B);
  sweep_warp_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)src, (const float*)P, (const float*)Q,
      (const float*)s, (__nv_bfloat16*)out, D, H, W, h, w, C, log2g,
      s_per_pixel);
  return (int)cudaGetLastError();
}

int wm_fused_cost_volume(const void* ref, const void* srcs, const void* P,
                         const void* Q, const void* s, const void* temp,
                         void* out, int B, int NV, int D, int H, int W,
                         int h, int w, int C, int s_per_pixel, int agg,
                         void* stream) {
  const int log2g = (C % kVec) ? -1 : log2_exact(C / kVec);
  if (log2g < 0 || log2g > 5 || B <= 0 || NV <= 0 || D <= 0 || H <= 0 ||
      W <= 0 || h <= 0 || w <= 0 || B > 65535 || D > 65535 ||
      (agg != 0 && agg != 1))
    return (int)cudaErrorInvalidValue;
  const long long n_thr = (long long)H * W << log2g;
  if (n_thr > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_thr + kThreads - 1) / kThreads), D, B);
  fused_cost_volume_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)ref, (const __nv_bfloat16*)srcs,
      (const float*)P, (const float*)Q, (const float*)s, (const float*)temp,
      (__nv_bfloat16*)out, NV, D, H, W, h, w, C, log2g, s_per_pixel, agg);
  return (int)cudaGetLastError();
}

}  // extern "C"
