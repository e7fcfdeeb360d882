// Plane-sweep kernels for Hopper (sm_90a): the per-view warp and its
// transpose (the MVSNet and Vis-MVSNet training forward and backward) and
// the fused multi-view cost volume of the MVSNet depthmap forward.
//
// Each replaces Pallas TPU kernels of wildmvs/ops/mosaic_sweep.py:
//   wm_sweep_warp           <- _kernel / mosaic_sweep_warp        (:143-270)
//                              _kernel_px / mosaic_sweep_warp_px  (:298-624)
//   wm_sweep_warp_backward  <- _kernel_scatter_px / mosaic_scatter_px
//                                                                (:1930-2088)
//   wm_fused_cost_volume    <- _kernel_fused / fused_cost_volume_px (:811-1117)
// They compute what those kernels compute, not how: a Hopper gather has no
// lane window and no VMEM budget, so the TPU's corner table, span plans,
// window tiers and exact-gather fallbacks have no counterpart here, and
// the kernels are exact for any rig geometry.
//
// The projection, the coordinate convention (MVSNet or Vis-MVSNet) and the
// bilinear border-zero sampler are sampler.cuh's. Outputs are rounded once
// to bf16 (round to nearest even).
//
// Layout: features channels-last [.., h, w, C] bf16; outputs [B, D, H, W, C]
// bf16. In the warp and its backward one thread owns one (d, y, x, 8-channel
// group): a group is one 16-byte load per corner, and the C/8 threads of a
// pixel are neighbours, so a warp reads each corner of a pixel as one
// contiguous C*2-byte run and writes a contiguous run of output. Their bound
// is the bytes of the volume they write or read (the source maps, 1-10 MB,
// stay in the 50 MB L2). The fused kernel stages its tile's source
// footprints in shared memory (footprint.cuh).
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch.
#include "footprint.cuh"
#include "sampler.cuh"

namespace {

using wm::Convention;
using wm::kThreads;
using wm::kVec;
using wm::load8;
using wm::proj1;
using wm::sample8;
using wm::store8;

// ---------------------------------------------------------------------------
// Per-view warp: src [B, h, w, C] -> out [B, D, H, W, C].
// grid (ceil(H*W*G / kThreads), D, B), G = C / 8 threads per pixel.
// ---------------------------------------------------------------------------
template <bool kConv>
__global__ void __launch_bounds__(kThreads)
sweep_warp_kernel(const __nv_bfloat16* __restrict__ src,
                  const float* __restrict__ P, const float* __restrict__ Q,
                  const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
                  int D, int H, int W, int h, int w, int C, int log2g,
                  int s_per_pixel, Convention cv) {
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
  const float rx = proj1(P[plane], sv, Q[plane]);
  const float ry = proj1(P[plane + hw], sv, Q[plane + hw]);
  const float rz = proj1(P[plane + 2 * hw], sv, Q[plane + 2 * hw]);

  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
  sample8<kConv>(src + (size_t)b * h * w * C, h, w, C, g * kVec, rx, ry, rz,
                 cv, acc);
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
// Warped values never leave registers; only the final volume is written,
// with streaming stores. temp is a device pointer (no host sync for the
// learned temperature).
//
// Bound: at the 512x640 headline the 251.7 MB output (HBM bytes, 0.077 ms);
// at the 1184x1600 eval the f32 operations (0.52 ms) and the 1.455 GB
// output (0.45 ms) about equally. On the card it is bound by the
// instructions of its samples instead (two IEEE divisions, 32 bf16
// conversions and 32 FMAs each, and 16 divisions a hypothesis for the
// variance; PERF.md has the times on an H100). Design (footprint.cuh):
// grid (tiles, runs of kDRun hypotheses, B); a block of tile_h x kTileW
// pixels x G threads loads its reference channels, the P/Q planes of every
// view and the run's hypotheses once, copies each view's source footprint
// over the run into shared memory, and then walks the run's hypotheses,
// the views inside, with the statistics of one hypothesis in registers.
// The G threads of a pixel each compute the taps of one view
// (wm::make_tap) and share them by shuffles. Per sample the arithmetic is
// the plain version's (proj1, wm::taps, f32 weights, corners added in the
// order k = 0..3, the IEEE quotient by NV + 1, one bf16 rounding);
// samples outside the staged box read device memory through
// wm::corners8. Outputs go out with streaming stores. The counts of staged
// and global views go to tile_counter[0..1] unless it is null. The views
// share one stage buffer (cells_max cells), which the wrapper sizes so that
// a block's shared memory keeps 3 blocks on an SM for any NV
// (sweep_kernels.fused_plan).
// ---------------------------------------------------------------------------
// 3 blocks an SM (at most 80 registers): faster than 2 at the headline on
// an H100, and 4 spills more and is slower (PERF.md).
template <int kLog2g>
__global__ void __launch_bounds__(wm::kMaxTileThreads, 3)
fused_cost_volume_kernel(const __nv_bfloat16* __restrict__ ref,
                         const __nv_bfloat16* __restrict__ srcs,
                         const float* __restrict__ P,
                         const float* __restrict__ Q,
                         const float* __restrict__ s,
                         const float* __restrict__ temp,
                         __nv_bfloat16* __restrict__ out,
                         unsigned long long* __restrict__ tile_counter,
                         int NV, int D, int H, int W, int h, int w,
                         int s_per_pixel, int agg, int tile_h,
                         int cells_max) {
  constexpr int log2g = kLog2g;
  constexpr int G = 1 << kLog2g;              // threads of a pixel
  constexpr int C = G * kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const wm::Tile t = wm::make_tile(H, W, tile_h, log2g);
  const wm::StageSmem m = wm::carve(smem, NV, cells_max, C, t.npx);
  const int b = blockIdx.z;
  const int hw = H * W;
  const int d0 = blockIdx.y * wm::kDRun;
  const int d_end = min(d0 + wm::kDRun, D);
  const int g = threadIdx.x & (G - 1);
  const int c0 = g * kVec;
  const size_t src_stride = (size_t)h * w * C;
  const __nv_bfloat16* img_b = srcs + (size_t)b * NV * src_stride;

  wm::load_tile_planes(m.pq, P, Q, b, NV, H, W, t);
  wm::hyp_range(m.sred, m.sv, s, s_per_pixel, b, D, hw, d0, d_end, t,
                g == 0);
  float refv[kVec];
  load8(ref + ((size_t)b * hw + t.pix) * C + c0, refv);
  const float tmp = agg ? temp[0] : 0.f;
  const float n = (float)(NV + 1);
  __syncthreads();
  float lo, hi;
  wm::run_range(m.sred, lo, hi);
  wm::block_footprints<false>(m, t, lo, hi, Convention{}, NV, h, w, log2g,
                              cells_max);
  __syncthreads();
  wm::stage_all(m, img_b, src_stride, NV, h, w, C, log2g, cells_max,
                tile_counter);

  // each thread of a pixel computes the taps of one view (wm::make_tap),
  // and the pixel's G threads share them, view by view, by shuffles
  const int lane0 = (threadIdx.x & 31) & ~(G - 1);
  for (int d = d0; d < d_end; ++d) {
    const float sv = m.sv[(d - d0) * t.npx + t.slot];
    float a1[kVec], a2[kVec];   // variance: sum, sum of squares
                                // softmin: a1 = sum e*diff, a2 unused
    float sum_exp = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      a1[i] = agg ? 0.f : refv[i];
      a2[i] = agg ? 0.f : refv[i] * refv[i];
    }
    for (int v0 = 0; v0 < NV; v0 += G) {
      wm::Tap mine{-1, 0.f, 0.f};
      if (v0 + g < NV) {
        const float* pqv = m.pq + (v0 + g) * 6 * t.npx + t.slot;
        mine = wm::make_tap<false>(proj1(pqv[0], sv, pqv[3 * t.npx]),
                                   proj1(pqv[t.npx], sv, pqv[4 * t.npx]),
                                   proj1(pqv[2 * t.npx], sv, pqv[5 * t.npx]),
                                   Convention{}, h, w, m.fps[v0 + g], C);
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int v = v0 + j;
        const wm::Tap tp = wm::shfl_tap(mine, lane0 | j);
        if (v >= NV) break;                        // uniform in the block
        float wv[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) wv[i] = 0.f;
        wm::sample_tap(tp, m.buf + m.fps[v].off, m.fps[v].cols * C,
                       img_b + v * src_stride, h, w, C, c0, wv);
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
#pragma unroll
          for (int o = G >> 1; o > 0; o >>= 1)
            part += __shfl_xor_sync(wm::kFullMask, part, o);
          const float e = expf(-tmp * part);
          sum_exp += e;
#pragma unroll
          for (int i = 0; i < kVec; ++i) a1[i] += e * diff[i];
        }
      }
    }
    float cv[kVec];
    if (agg == 0) {
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
    if (t.live)
      wm::store_bf16_cs<kVec>(out + (((size_t)b * D + d) * hw + t.pix) * C + c0,
                              cv);
  }
}

// ---------------------------------------------------------------------------
// Warp backward (the transpose of sweep_warp_kernel):
//   g [B, D, H, W, C] bf16 -> df [B, h, w, C] f32 (zeroed by the caller),
//   df[corner] += w_corner * g[d, y, x] for each live sample's four corners
//   that lie inside the image.
// grid (ceil(H*W*G / kThreads), ceil(D / d_chunk), B): one thread owns one
// (y, x, 8-channel group) over a run of d_chunk hypotheses. Coordinates,
// the validity test and the f32 weights are sample8's (wm::taps), in the
// forward's convention. A pixel's sample
// moves slowly along D, so the thread sums its four corners' contributions
// in registers while the sample stays in one source cell (x0, y0) and
// flushes them with vector f32 atomics (two 16-byte reductions per corner)
// only when the cell changes and at the end of its run.
// Bound: HBM bytes (g read once, df written once) unless the atomics set the
// pace; df (2.6 MB at 128x160 C=32) stays in L2, where the atomics resolve.
// The order of the atomic adds changes from run to run, so df may differ in
// the last f32 bits between runs.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void red_add8(float* p, const float v[kVec]) {
  atomicAdd(reinterpret_cast<float4*>(p),
            make_float4(v[0], v[1], v[2], v[3]));
  atomicAdd(reinterpret_cast<float4*>(p + 4),
            make_float4(v[4], v[5], v[6], v[7]));
}

__device__ __forceinline__ void flush_cell(float* __restrict__ dfb, int h,
                                           int w, int C, int cx, int cy,
                                           float acc[4][kVec]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xi = cx + (k & 1);
    const int yi = cy + (k >> 1);
    if (xi >= 0 && xi < w && yi >= 0 && yi < h)
      red_add8(dfb + ((size_t)yi * w + xi) * C, acc[k]);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[k][i] = 0.f;
  }
}

template <bool kConv>
__global__ void __launch_bounds__(kThreads)
sweep_warp_backward_kernel(const __nv_bfloat16* __restrict__ g,
                           const float* __restrict__ P,
                           const float* __restrict__ Q,
                           const float* __restrict__ s,
                           float* __restrict__ df,
                           int D, int H, int W, int h, int w, int C,
                           int log2g, int s_per_pixel, int d_chunk,
                           Convention cv) {
  const int b = blockIdx.z;
  const int hw = H * W;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= (hw << log2g)) return;
  const int grp = t & ((1 << log2g) - 1);
  const int pix = t >> log2g;                   // y * W + x
  const int c0 = grp * kVec;
  const int d0 = blockIdx.y * d_chunk;
  const int d1 = min(d0 + d_chunk, D);

  const size_t plane = (size_t)b * 3 * hw + pix;
  const float px = P[plane], py = P[plane + hw], pz = P[plane + 2 * hw];
  const float qx = Q[plane], qy = Q[plane + hw], qz = Q[plane + 2 * hw];
  float* dfb = df + (size_t)b * h * w * C + c0;

  float acc[4][kVec];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[k][i] = 0.f;
  bool have = false;                            // acc holds cell (cx, cy)
  int cx = 0, cy = 0;
  for (int d = d0; d < d1; ++d) {
    const float sv = s_per_pixel ? s[((size_t)b * D + d) * hw + pix]
                                 : s[(size_t)b * D + d];
    // the forward's arithmetic (proj1, wm::taps)
    int x0, y0;
    float fx, fy;
    if (!wm::taps<kConv>(proj1(px, sv, qx), proj1(py, sv, qy),
                         proj1(pz, sv, qz), cv, h, w, x0, y0, fx, fy))
      continue;                                 // a dead sample
    if (have && (x0 != cx || y0 != cy)) flush_cell(dfb, h, w, C, cx, cy, acc);
    have = true;
    cx = x0;
    cy = y0;
    const float wts[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx,
                          fy * (1.f - fx), fy * fx};
    float gv[kVec];
    load8(g + (((size_t)b * D + d) * hw + pix) * C + c0, gv);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[k][i] += wts[k] * gv[i];
  }
  if (have) flush_cell(dfb, h, w, C, cx, cy, acc);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success);
// cudaErrorInvalidValue for arguments the kernel does not take.
// (sx, sy, x_lo, x_hi, y_lo, y_hi): the coordinate convention (sampler.cuh).
int wm_sweep_warp(const void* src, const void* P, const void* Q,
                  const void* s, void* out, int B, int D, int H, int W,
                  int h, int w, int C, int s_per_pixel, float sx, float sy,
                  float x_lo, float x_hi, float y_lo, float y_hi,
                  void* stream) {
  const int log2g = (C % kVec) ? -1 : wm::log2_exact(C / kVec);
  if (log2g < 0 || B <= 0 || D <= 0 || H <= 0 || W <= 0 || h <= 0 ||
      w <= 0 || B > 65535 || D > 65535)
    return (int)cudaErrorInvalidValue;
  const long long n_thr = (long long)H * W << log2g;
  if (n_thr > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_thr + kThreads - 1) / kThreads), D, B);
  const Convention cv{sx, sy, x_lo, x_hi, y_lo, y_hi};
  auto kernel = wm::is_identity(cv) ? sweep_warp_kernel<false>
                                    : sweep_warp_kernel<true>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)src, (const float*)P, (const float*)Q,
      (const float*)s, (__nv_bfloat16*)out, D, H, W, h, w, C, log2g,
      s_per_pixel, cv);
  return (int)cudaGetLastError();
}

// df must be zeroed by the caller; the kernel only adds into it.
int wm_sweep_warp_backward(const void* g, const void* P, const void* Q,
                           const void* s, void* df, int B, int D, int H,
                           int W, int h, int w, int C, int s_per_pixel,
                           int d_chunk, float sx, float sy, float x_lo,
                           float x_hi, float y_lo, float y_hi,
                           void* stream) {
  const int log2g = (C % kVec) ? -1 : wm::log2_exact(C / kVec);
  if (log2g < 0 || B <= 0 || D <= 0 || H <= 0 || W <= 0 || h <= 0 ||
      w <= 0 || d_chunk <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long n_thr = (long long)H * W << log2g;
  const long long n_chunks = ((long long)D + d_chunk - 1) / d_chunk;
  if (n_thr > 0x7fffffffLL || n_chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_thr + kThreads - 1) / kThreads),
                  (unsigned)n_chunks, B);
  const Convention cv{sx, sy, x_lo, x_hi, y_lo, y_hi};
  auto kernel = wm::is_identity(cv) ? sweep_warp_backward_kernel<false>
                                    : sweep_warp_backward_kernel<true>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)g, (const float*)P, (const float*)Q,
      (const float*)s, (float*)df, D, H, W, h, w, C, log2g, s_per_pixel,
      d_chunk, cv);
  return (int)cudaGetLastError();
}

// tile_counter: null, or 2 device counters (staged, global views of a
// block) that the launch adds to. tile_h: rows of a block's tile (of
// kTileW columns); cells_max: the source cells of the block's stage buffer,
// all views together (0: every sample reads device memory).
int wm_fused_cost_volume(const void* ref, const void* srcs, const void* P,
                         const void* Q, const void* s, const void* temp,
                         void* out, void* tile_counter, int B, int NV, int D,
                         int H, int W, int h, int w, int C, int s_per_pixel,
                         int agg, int tile_h, int cells_max, void* stream) {
  const int log2g = (C % kVec) ? -1 : wm::log2_exact(C / kVec);
  if (log2g < 0 || log2g > 5 || B <= 0 || NV <= 0 || D <= 0 || H <= 0 ||
      W <= 0 || h <= 0 || w <= 0 || h > 32767 || w > 32767 || B > 65535 ||
      (agg != 0 && agg != 1) || tile_h <= 0 || cells_max < 0)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)tile_h * wm::kTileW << log2g;
  const long long n_tiles = (long long)((H + tile_h - 1) / tile_h) *
                            ((W + wm::kTileW - 1) / wm::kTileW);
  const long long n_runs = ((long long)D + wm::kDRun - 1) / wm::kDRun;
  if (threads > wm::kMaxTileThreads || threads % 32 != 0 ||
      n_tiles > 0x7fffffffLL || n_runs > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wm::footprint_smem_bytes(
      NV, cells_max, C, tile_h * wm::kTileW, (int)threads);
  auto kernel = log2g == 0   ? fused_cost_volume_kernel<0>
                : log2g == 1 ? fused_cost_volume_kernel<1>
                : log2g == 2 ? fused_cost_volume_kernel<2>
                : log2g == 3 ? fused_cost_volume_kernel<3>
                : log2g == 4 ? fused_cost_volume_kernel<4>
                             : fused_cost_volume_kernel<5>;
  const int rc = wm::allow_smem((const void*)kernel, smem);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)n_tiles, (unsigned)n_runs, B);
  kernel<<<grid, (unsigned)threads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)ref, (const __nv_bfloat16*)srcs,
      (const float*)P, (const float*)Q, (const float*)s, (const float*)temp,
      (__nv_bfloat16*)out, (unsigned long long*)tile_counter, NV, D, H, W, h,
      w, s_per_pixel, agg, tile_h, cells_max);
  return (int)cudaGetLastError();
}

}  // extern "C"
