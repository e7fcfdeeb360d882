// Fused warp + group-wise correlation for Hopper (sm_90a): the Vis-MVSNet
// per-pair cost volume of the depthmap forward.
//
// Replaces the Pallas TPU kernel _kernel_px_gwc / mosaic_sweep_warp_px_gwc
// (wildmvs/ops/mosaic_sweep.py:627-791), which computes what
// homography_sweep_warp followed by groupwise_correlation computes
// (reference VisMVSNet model_cas.py:176-187, nn_utils.py:473-490):
//   out[b, d, y, x, g] = sum over the C/G channels c of group g of
//                        ref[b, y, x, c] * warped[b, d, y, x, c],
// with warped the bilinear border-zero sample of src at hypothesis d
// (sampler.cuh: projection, convention, taps). G = 8.
//
// The warped [D, H, W, C] volume never reaches HBM: each warped value is
// formed in f32 registers (not rounded), multiplied by the reference
// feature and summed into its group in f32; each output is rounded once to
// bf16. (The Pallas kernel rounds the warped value to bf16 first.)
//
// Bound: HBM bytes. The output is C/G times smaller than the warped volume
// it replaces; per launch it writes D*H*W*G*2 bytes and reads the reference
// map, the source map, the planes and the hypotheses once (the source map,
// up to 30 MB at the 1184x1600 eval's stage 3, stays in the 50 MB L2 for
// the corner re-reads).
//
// Design (simple and right first): one thread per reference pixel (y, x)
// and run of d_chunk hypotheses. The thread keeps the pixel's C reference
// channels in registers across its run; per hypothesis it reads each corner
// as C/8 16-byte loads, forms the C warped channels and the G group sums,
// and writes them as one 16-byte store (8 bf16). Neighbouring threads hold
// neighbouring pixels, so the reference loads and the output stores are
// contiguous across a warp.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch.
#include "sampler.cuh"

namespace {

using wm::Convention;
using wm::kThreads;
using wm::kVec;
using wm::load8;
using wm::proj1;
using wm::store8;

constexpr int kGroups = 8;

// src [B, h, w, C], ref [B, H, W, C], P/Q [B, 3, H, W], s [B, D] or
// [B, D, H, W] -> out [B, D, H, W, 8].
// grid (ceil(H*W / kThreads), ceil(D / d_chunk), B).
template <int C>
__global__ void __launch_bounds__(kThreads)
sweep_gwc_kernel(const __nv_bfloat16* __restrict__ src,
                 const __nv_bfloat16* __restrict__ ref,
                 const float* __restrict__ P, const float* __restrict__ Q,
                 const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
                 int D, int H, int W, int h, int w, int s_per_pixel,
                 int d_chunk, Convention cv) {
  constexpr int kLoads = C / kVec;              // 16-byte loads per pixel
  constexpr int kPerGroup = C / kGroups;        // channels per group
  const int b = blockIdx.z;
  const int hw = H * W;
  const int pix = blockIdx.x * kThreads + threadIdx.x;   // y * W + x
  if (pix >= hw) return;
  const int d0 = blockIdx.y * d_chunk;
  const int d1 = min(d0 + d_chunk, D);

  float refv[C];
#pragma unroll
  for (int l = 0; l < kLoads; ++l)
    load8(ref + ((size_t)b * hw + pix) * C + l * kVec, refv + l * kVec);
  const size_t plane = (size_t)b * 3 * hw + pix;
  const float px = P[plane], py = P[plane + hw], pz = P[plane + 2 * hw];
  const float qx = Q[plane], qy = Q[plane + hw], qz = Q[plane + 2 * hw];
  const __nv_bfloat16* img = src + (size_t)b * h * w * C;

  for (int d = d0; d < d1; ++d) {
    const float sv = s_per_pixel ? s[((size_t)b * D + d) * hw + pix]
                                 : s[(size_t)b * D + d];
    float corr[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) corr[g] = 0.f;
    int x0, y0;
    float fx, fy;
    if (wm::taps<true>(proj1(px, sv, qx), proj1(py, sv, qy),
                       proj1(pz, sv, qz), cv, h, w, x0, y0, fx, fy)) {
      const float wts[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx,
                            fy * (1.f - fx), fy * fx};
      float warped[C];
#pragma unroll
      for (int c = 0; c < C; ++c) warped[c] = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int xi = x0 + (k & 1);
        const int yi = y0 + (k >> 1);
        if (xi < 0 || xi >= w || yi < 0 || yi >= h) continue;   // zero
        const __nv_bfloat16* corner = img + ((size_t)yi * w + xi) * C;
#pragma unroll
        for (int l = 0; l < kLoads; ++l) {
          float v[kVec];
          load8(corner + l * kVec, v);
#pragma unroll
          for (int i = 0; i < kVec; ++i)
            warped[l * kVec + i] += wts[k] * v[i];
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) corr[c / kPerGroup] += refv[c] * warped[c];
    }
    store8(out + (((size_t)b * D + d) * hw + pix) * kGroups, corr);
  }
}

template <int C>
void launch(const dim3& grid, cudaStream_t stream, const void* src,
            const void* ref, const void* P, const void* Q, const void* s,
            void* out, int D, int H, int W, int h, int w, int s_per_pixel,
            int d_chunk, const Convention& cv) {
  sweep_gwc_kernel<C><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)src, (const __nv_bfloat16*)ref, (const float*)P,
      (const float*)Q, (const float*)s, (__nv_bfloat16*)out, D, H, W, h, w,
      s_per_pixel, d_chunk, cv);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success);
// cudaErrorInvalidValue for arguments the kernel does not take (C must be
// 8, 16, 32 or 64). (sx, sy, x_lo, x_hi, y_lo, y_hi): the coordinate
// convention (sampler.cuh).
int wm_sweep_gwc(const void* src, const void* ref, const void* P,
                 const void* Q, const void* s, void* out, int B, int D, int H,
                 int W, int h, int w, int C, int s_per_pixel, int d_chunk,
                 float sx, float sy, float x_lo, float x_hi, float y_lo,
                 float y_hi, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || h <= 0 || w <= 0 ||
      d_chunk <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long hw = (long long)H * W;
  const long long n_chunks = ((long long)D + d_chunk - 1) / d_chunk;
  if (hw > 0x7fffffffLL || n_chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((hw + kThreads - 1) / kThreads),
                  (unsigned)n_chunks, B);
  const Convention cv{sx, sy, x_lo, x_hi, y_lo, y_hi};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 8:
      launch<8>(grid, st, src, ref, P, Q, s, out, D, H, W, h, w, s_per_pixel,
                d_chunk, cv);
      break;
    case 16:
      launch<16>(grid, st, src, ref, P, Q, s, out, D, H, W, h, w,
                 s_per_pixel, d_chunk, cv);
      break;
    case 32:
      launch<32>(grid, st, src, ref, P, Q, s, out, D, H, W, h, w,
                 s_per_pixel, d_chunk, cv);
      break;
    case 64:
      launch<64>(grid, st, src, ref, P, Q, s, out, D, H, W, h, w,
                 s_per_pixel, d_chunk, cv);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
