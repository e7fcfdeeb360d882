// Plane-sweep kernels for Hopper (sm_90a): the fused multi-view cost
// volume of the MVSNet depthmap forward, and the per-view warp's transpose
// (the MVSNet and Vis-MVSNet training backward). The warp itself and the
// Vis group-wise correlation are in warp.cu.
//
// Each replaces Pallas TPU kernels of wildmvs/ops/mosaic_sweep.py:
//   wm_fused_cost_volume    <- _kernel_fused / fused_cost_volume_px (:811-1117)
//   wm_sweep_warp_backward  <- _kernel_scatter_px / mosaic_scatter_px
//                                                                (:1930-2088)
// They compute what those kernels compute, not how: a Hopper gather has no
// lane window and no VMEM budget, so the TPU's corner table, span plans,
// window tiers and exact-gather fallbacks have no counterpart here, and
// the kernels are exact for any rig geometry.
//
// The projection, the coordinate convention (MVSNet or Vis-MVSNet) and the
// bilinear border-zero sampler are sampler.cuh's; both kernels work on the
// tiles of footprint.cuh, and the fused kernel on its staged footprints.
// Features are channels-last [.., h, w, C] bf16; volumes [B, D, H, W, C]
// bf16, rounded once to bf16 (round to nearest even).
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch.
#include "footprint.cuh"
#include "sampler.cuh"

namespace {

using wm::Convention;
using wm::kVec;
using wm::load8;
using wm::proj1;

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
// Warp backward (the transpose of sweep_warp, warp.cu):
//   g [B, D, H, W, C] bf16 -> df [B, h, w, C] f32 (zeroed by the caller),
//   df[corner] += w_corner * g[d, y, x] for each live sample's four corners
//   that lie inside the image; coordinates, the validity test and the f32
//   weights are the forward's (proj1, wm::taps).
//
// Bound: HBM bytes, g read once and df written once (252 MB at the 512x640
// headline's 128x160 features, C=32, D=192: 0.076 ms at 3.35 TB/s). On the
// card its 16-byte f32 atomics into device memory set the pace: the first
// design (one thread per pixel and 8 channels over a run of 16 hypotheses,
// adding all four corners into df whenever its sample changed cell) took
// 0.325 ms on an H100, and 0.142 ms with the same loads, taps and register
// sums but no atomics (PERF.md). Design (footprint.cuh's tile): grid
// (tiles, runs of kDRun hypotheses, B); a block of tile_h x kTileW pixels
// x C/8 threads loads the tile's planes and the run's hypotheses once. The
// C/8 threads of a pixel take the run C/8 hypotheses at a time: each
// computes the taps of one and they share them by shuffles. A thread sums
// its four corners' weights times its 8 gradient channels in registers
// while the sample stays in one source cell; when the cell changes
// (move_cell) it keeps the two corners that a move of one cell shares and
// adds the others that lie inside the image into df with 16-byte atomics,
// which it does not wait for (RED). An f32 accumulator of the tile's
// footprint in shared memory, added into df once a block, was slower at
// every training shape: on Hopper an f32 add into shared memory is a
// compare-and-swap loop that its thread waits for (PERF.md). The launch
// adds its count of 16-byte atomics to tile_counter[2] unless it is null.
// The order of the f32 adds changes from run to run, so df may differ in
// the last bits between runs.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void red_add8(float* p, const float v[kVec]) {
  atomicAdd(reinterpret_cast<float4*>(p),
            make_float4(v[0], v[1], v[2], v[3]));
  atomicAdd(reinterpret_cast<float4*>(p + 4),
            make_float4(v[4], v[5], v[6], v[7]));
}

// The sample's cell moves from the packed cell `code` ((x0 + 1) | (y0 + 1)
// << 16) to `next` (-1: none): add the corner sums acc that the new cell
// does not share and that lie inside the image into dfb (the thread's
// channels of df[b]); the corners the two cells share (a move of one cell)
// stay in acc as the new cell's, the others become zero. Returns the
// 16-byte atomics it issued.
template <int C>
__device__ __forceinline__ int move_cell(float* dfb, int h, int w, int code,
                                         int next, float acc[4][kVec]) {
  const int x0 = (code & 0xffff) - 1, y0 = (code >> 16) - 1;
  int dx = 2, dy = 2;                          // no shared corner
  if (next >= 0) {
    const int mx = (next & 0xffff) - 1 - x0, my = (next >> 16) - 1 - y0;
    if (abs(mx) + abs(my) == 1) {
      dx = mx;
      dy = my;
    }
  }
  int n = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xi = x0 + (k & 1), yi = y0 + (k >> 1);
    if ((unsigned)((k & 1) - dx) <= 1u && (unsigned)((k >> 1) - dy) <= 1u)
      continue;                                // shared with the new cell
    if (xi >= 0 && xi < w && yi >= 0 && yi < h) {
      red_add8(dfb + ((size_t)yi * w + xi) * C, acc[k]);
      n += 2;
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float a0 = acc[0][i], a1 = acc[1][i], a2 = acc[2][i],
                a3 = acc[3][i];
    acc[0][i] = dx == 1 ? a1 : dy == 1 ? a2 : 0.f;
    acc[1][i] = dx == -1 ? a0 : dy == 1 ? a3 : 0.f;
    acc[2][i] = dx == 1 ? a3 : dy == -1 ? a0 : 0.f;
    acc[3][i] = dx == -1 ? a2 : dy == -1 ? a1 : 0.f;
  }
  return n;
}

template <bool kConv, int kLog2g>
__global__ void __launch_bounds__(wm::kMaxTileThreads, 3)
sweep_warp_backward_kernel(const __nv_bfloat16* __restrict__ g,
                           const float* __restrict__ P,
                           const float* __restrict__ Q,
                           const float* __restrict__ s,
                           float* __restrict__ df,
                           unsigned long long* __restrict__ tile_counter,
                           int D, int H, int W, int h, int w,
                           int s_per_pixel, int tile_h, Convention cv) {
  constexpr int G = 1 << kLog2g;              // threads of a pixel
  constexpr int C = G * kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const wm::Tile t = wm::make_tile(H, W, tile_h, kLog2g);
  const wm::StageSmem m = wm::carve(smem, 1, 0, C, t.npx);
  const int b = blockIdx.z;
  const int hw = H * W;
  const int d0 = blockIdx.y * wm::kDRun;
  const int d_end = min(d0 + wm::kDRun, D);
  const int slice = threadIdx.x & (G - 1);
  const int c0 = slice * kVec;

  wm::load_tile_planes(m.pq, P, Q, b, 1, H, W, t);
  wm::hyp_range(m.sred, m.sv, s, s_per_pixel, b, D, hw, d0, d_end, t,
                slice == 0);
  __syncthreads();
  const float px = m.pq[t.slot], py = m.pq[t.npx + t.slot],
              pz = m.pq[2 * t.npx + t.slot];
  const float qx = m.pq[3 * t.npx + t.slot], qy = m.pq[4 * t.npx + t.slot],
              qz = m.pq[5 * t.npx + t.slot];

  float* dfb = df + (size_t)b * h * w * C + c0;
  const __nv_bfloat16* gp = g + (((size_t)b * D + d0) * hw + t.pix) * C + c0;
  float acc[4][kVec];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[k][i] = 0.f;
  int cur = -1;                               // the packed cell acc holds
  int n_atomics = 0;
  const int lane0 = (threadIdx.x & 31) & ~(G - 1);
  for (int d = d0; d < d_end; d += G) {
    int mine = -1;                            // dead
    float mfx = 0.f, mfy = 0.f;
    if (d + slice < d_end) {
      const float sv = m.sv[(d + slice - d0) * t.npx + t.slot];
      int x0, y0;
      if (wm::taps<kConv>(proj1(px, sv, qx), proj1(py, sv, qy),
                          proj1(pz, sv, qz), cv, h, w, x0, y0, mfx, mfy))
        mine = (x0 + 1) | ((y0 + 1) << 16);
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int code = __shfl_sync(wm::kFullMask, mine, lane0 | j);
      const float fx = __shfl_sync(wm::kFullMask, mfx, lane0 | j);
      const float fy = __shfl_sync(wm::kFullMask, mfy, lane0 | j);
      if (d + j >= d_end) break;                   // uniform in the block
      if (code < 0 || !t.live) continue;
      if (code != cur) {
        if (cur >= 0) n_atomics += move_cell<C>(dfb, h, w, cur, code, acc);
        cur = code;
      }
      const float wts[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx,
                            fy * (1.f - fx), fy * fx};
      float gv[kVec];
      load8(gp + (size_t)(d + j - d0) * hw * C, gv);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[k][i] += wts[k] * gv[i];
    }
  }
  if (cur >= 0) n_atomics += move_cell<C>(dfb, h, w, cur, -1, acc);
  if (tile_counter != nullptr) {
    const unsigned n = __reduce_add_sync(wm::kFullMask, (unsigned)n_atomics);
    if ((threadIdx.x & 31) == 0 && n != 0)
      atomicAdd(tile_counter + 2, (unsigned long long)n);
  }
}

using BackwardKernel = decltype(&sweep_warp_backward_kernel<false, 0>);

template <bool kConv>
BackwardKernel backward_kernel(int log2g) {
  switch (log2g) {
    case 0: return sweep_warp_backward_kernel<kConv, 0>;
    case 1: return sweep_warp_backward_kernel<kConv, 1>;
    case 2: return sweep_warp_backward_kernel<kConv, 2>;
    case 3: return sweep_warp_backward_kernel<kConv, 3>;
    case 4: return sweep_warp_backward_kernel<kConv, 4>;
    default: return sweep_warp_backward_kernel<kConv, 5>;
  }
}

}  // namespace

extern "C" {

// df must be zeroed by the caller; the kernel only adds into it.
// tile_counter: null, or 3 device counters, of which the launch adds its
// 16-byte atomics into df to the third. tile_h: rows of a block's tile (of
// kTileW columns). (sx, sy, x_lo, x_hi, y_lo, y_hi): the coordinate
// convention (sampler.cuh).
int wm_sweep_warp_backward(const void* g, const void* P, const void* Q,
                           const void* s, void* df, void* tile_counter,
                           int B, int D, int H, int W, int h, int w, int C,
                           int s_per_pixel, int tile_h, float sx, float sy,
                           float x_lo, float x_hi, float y_lo, float y_hi,
                           void* stream) {
  const int log2g = (C % kVec) ? -1 : wm::log2_exact(C / kVec);
  if (log2g < 0 || log2g > 5 || B <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      h <= 0 || w <= 0 || h > 32767 || w > 32767 || B > 65535 || tile_h <= 0)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)tile_h * wm::kTileW << log2g;
  const long long n_tiles = (long long)((H + tile_h - 1) / tile_h) *
                            ((W + wm::kTileW - 1) / wm::kTileW);
  const long long n_runs =
      ((long long)D + wm::kDRun - 1) / wm::kDRun;
  if (threads > wm::kMaxTileThreads || threads % 32 != 0 ||
      n_tiles > 0x7fffffffLL || n_runs > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wm::footprint_smem_bytes(1, 0, C, tile_h * wm::kTileW,
                                               (int)threads);
  const Convention cv{sx, sy, x_lo, x_hi, y_lo, y_hi};
  const BackwardKernel kernel = wm::is_identity(cv)
                                    ? backward_kernel<false>(log2g)
                                    : backward_kernel<true>(log2g);
  const dim3 grid((unsigned)n_tiles, (unsigned)n_runs, B);
  kernel<<<grid, (unsigned)threads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)g, (const float*)P, (const float*)Q,
      (const float*)s, (float*)df, (unsigned long long*)tile_counter, D, H,
      W, h, w, s_per_pixel, tile_h, cv);
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
