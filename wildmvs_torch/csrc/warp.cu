// Single-view sweep kernels for Hopper (sm_90a) on footprint.cuh: the
// per-view warp of the MVSNet and Vis-MVSNet training forward, and the
// warp fused with the group-wise correlation, the Vis-MVSNet per-pair cost
// volume of the depthmap forward. One kernel loop serves both; only what a
// sample's eight warped channels become differs.
//
// Each replaces Pallas TPU kernels of wildmvs/ops/mosaic_sweep.py:
//   wm_sweep_warp  <- _kernel / mosaic_sweep_warp         (:143-270)
//                     _kernel_px / mosaic_sweep_warp_px   (:298-624)
//     src [B, h, w, C] -> out[b, d, y, x, c], the bilinear border-zero
//     sample of src at hypothesis d, in either convention (sampler.cuh).
//   wm_sweep_gwc   <- _kernel_px_gwc / mosaic_sweep_warp_px_gwc (:627-791)
//     which computes what homography_sweep_warp followed by
//     groupwise_correlation computes (reference VisMVSNet
//     model_cas.py:176-187, nn_utils.py:473-490):
//     out[b, d, y, x, g] = sum over the C/G channels c of group g of
//                          ref[b, y, x, c] * warped[b, d, y, x, c], G = 8.
//     The warped [D, H, W, C] volume never reaches HBM: each warped value
//     stays f32 (not rounded), is multiplied by the reference feature and
//     summed into its group in f32. (The Pallas kernel rounds the warped
//     value to bf16 first.)
// Each output is rounded once to bf16 (round to nearest even).
//
// Bound: HBM bytes. The warp writes D*H*W*C*2 bytes (251.7 MB at the
// 512x640 headline's 128x160 features, C=32, D=192: 0.075 ms at 3.35 TB/s)
// and reads the source map (1.3 MB, it stays in the 50 MB L2), the planes
// and the hypotheses; the correlation writes C/8 times fewer bytes than the
// warped volume it replaces and reads the reference map once. On the card
// both are bound by the instructions of their samples instead (two IEEE
// divisions, 16 bf16 conversions of four corners and 32 FMAs a sample and
// 8 channels) and by the occupancy that leaves: the first warp, one thread
// a (d, pixel, 8 channels), loaded the planes and the hypothesis and
// computed both divisions for each of the C/8 threads of a pixel and read
// its four 16-byte corners from L1/L2 for each 16-byte store (PERF.md).
//
// Design (footprint.cuh): grid (tiles, runs of kDRun hypotheses, B); a
// block of tile_h x kTileW reference pixels x C/8 threads, one thread per
// (pixel, 8-channel slice), loads the tile's planes and the run's
// hypotheses once, copies the source footprint of its tile over its run
// into shared memory and samples from there; samples outside it read
// device memory through wm::corners8 with the same arithmetic. The C/8
// threads of a pixel take the run C/8 hypotheses at a time: each computes
// the taps of one (wm::make_tap) and they share them by shuffles. The warp
// stores its thread's 8 channels, the correlation its thread's groups (a
// group has C/8 channels, at most 8 for C <= 64, so a slice holds whole
// groups and sums them with no shuffle); both with streaming stores. The
// counts of staged and global blocks go to tile_counter[0..1] unless it is
// null.
//
// The entry points launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() so the caller can raise on a refused launch.
#include "footprint.cuh"
#include "sampler.cuh"

namespace {

using wm::Convention;
using wm::kVec;
using wm::load8;
using wm::proj1;

constexpr int kGroups = 8;

// src [B, h, w, C], P/Q [B, 3, H, W], s [B, D] or [B, D, H, W] -> out
// [B, D, H, W, C] (kGwc false) or, with ref [B, H, W, C], the correlation
// [B, D, H, W, 8] (kGwc true).
// 4 blocks an SM (at most 64 registers): faster than 3 at the Vis eval's
// stage 3 on an H100 (PERF.md).
template <bool kConv, int C, bool kGwc>
__global__ void __launch_bounds__(wm::kMaxTileThreads, 4)
sweep_view_kernel(const __nv_bfloat16* __restrict__ src,
                  const __nv_bfloat16* __restrict__ ref,
                  const float* __restrict__ P, const float* __restrict__ Q,
                  const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
                  unsigned long long* __restrict__ tile_counter, int D, int H,
                  int W, int h, int w, int s_per_pixel, int tile_h,
                  int cells_max, Convention cv) {
  constexpr int kLog2g = C == 8 ? 0 : C == 16 ? 1 : C == 32 ? 2
                       : C == 64 ? 3 : C == 128 ? 4 : 5;
  constexpr int kG = 1 << kLog2g;               // threads of a pixel
  // outputs of a thread's sample: 8 channels, or its groups
  constexpr int kOut = kGwc ? kVec / (C / kGroups) : kVec;
  constexpr int kOutC = kGwc ? kGroups : C;     // outputs of a pixel
  extern __shared__ __align__(16) unsigned char smem[];
  const wm::Tile t = wm::make_tile(H, W, tile_h, kLog2g);
  const wm::StageSmem m = wm::carve(smem, 1, cells_max, C, t.npx);
  const int b = blockIdx.z;
  const int hw = H * W;
  const int d0 = blockIdx.y * wm::kDRun;
  const int d_end = min(d0 + wm::kDRun, D);
  const int slice = threadIdx.x & (kG - 1);
  const __nv_bfloat16* img = src + (size_t)b * h * w * C;

  wm::load_tile_planes(m.pq, P, Q, b, 1, H, W, t);
  wm::hyp_range(m.sred, m.sv, s, s_per_pixel, b, D, hw, d0, d_end, t,
                slice == 0);
  float refv[kVec];
  if constexpr (kGwc)
    load8(ref + ((size_t)b * hw + t.pix) * C + slice * kVec, refv);
  __syncthreads();
  float lo, hi;
  wm::run_range(m.sred, lo, hi);
  wm::block_footprints<kConv>(m, t, lo, hi, cv, 1, h, w, kLog2g, cells_max);
  const float px = m.pq[t.slot], py = m.pq[t.npx + t.slot],
              pz = m.pq[2 * t.npx + t.slot];
  const float qx = m.pq[3 * t.npx + t.slot], qy = m.pq[4 * t.npx + t.slot],
              qz = m.pq[5 * t.npx + t.slot];
  __syncthreads();
  wm::stage_all(m, img, 0, 1, h, w, C, kLog2g, cells_max, tile_counter);
  const wm::Footprint f = m.fps[0];

  // the pixel's kG threads take the run kG hypotheses at a time: each
  // computes the taps of one (wm::make_tap) and they share them by shuffles
  const int lane0 = (threadIdx.x & 31) & ~(kG - 1);
  __nv_bfloat16* o =
      out + (((size_t)b * D + d0) * hw + t.pix) * kOutC + slice * kOut;
  for (int d = d0; d < d_end; d += kG) {
    wm::Tap mine{-1, 0.f, 0.f};
    if (d + slice < d_end) {
      const float sv = m.sv[(d + slice - d0) * t.npx + t.slot];
      mine = wm::make_tap<kConv>(proj1(px, sv, qx), proj1(py, sv, qy),
                                 proj1(pz, sv, qz), cv, h, w, f, C);
    }
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      const wm::Tap tp = wm::shfl_tap(mine, lane0 | j);
      if (d + j >= d_end) break;                   // uniform in the block
      float warped[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) warped[i] = 0.f;
      wm::sample_tap(tp, m.buf + f.off, f.cols * C, img, h, w, C,
                     slice * kVec, warped);      // a dead sample stays 0
      if constexpr (kGwc) {
        float corr[kOut];
#pragma unroll
        for (int k = 0; k < kOut; ++k) corr[k] = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          corr[i / (C / kGroups)] += refv[i] * warped[i];
        if (t.live) wm::store_bf16_cs<kOut>(o, corr);
      } else {
        if (t.live) wm::store_bf16_cs<kVec>(o, warped);
      }
      o += (size_t)hw * kOutC;
    }
  }
}

template <bool kConv, int C, bool kGwc>
int launch(const dim3& grid, int threads, cudaStream_t stream,
           const void* src, const void* ref, const void* P, const void* Q,
           const void* s, void* out, void* tile_counter, int D, int H, int W,
           int h, int w, int s_per_pixel, int tile_h, int cells_max,
           const Convention& cv) {
  auto kernel = sweep_view_kernel<kConv, C, kGwc>;
  const size_t smem = wm::footprint_smem_bytes(1, cells_max, C,
                                               tile_h * wm::kTileW, threads);
  const int rc = wm::allow_smem((const void*)kernel, smem);
  if (rc != 0) return rc;
  kernel<<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)src, (const __nv_bfloat16*)ref, (const float*)P,
      (const float*)Q, (const float*)s, (__nv_bfloat16*)out,
      (unsigned long long*)tile_counter, D, H, W, h, w, s_per_pixel, tile_h,
      cells_max, cv);
  return (int)cudaGetLastError();
}

// launch<kConv, C, kGwc> for a runtime C (the correlation takes C <= 64).
template <bool kConv, bool kGwc, typename... Args>
int launch_c(int C, Args... args) {
  switch (C) {
    case 8: return launch<kConv, 8, kGwc>(args...);
    case 16: return launch<kConv, 16, kGwc>(args...);
    case 32: return launch<kConv, 32, kGwc>(args...);
    case 64: return launch<kConv, 64, kGwc>(args...);
  }
  if constexpr (!kGwc) {
    if (C == 128) return launch<kConv, 128, false>(args...);
    if (C == 256) return launch<kConv, 256, false>(args...);
  }
  return (int)cudaErrorInvalidValue;
}

// The arguments both entry points check, and their grid; log2g < 0 when
// the kernels do not take them.
int view_grid(int B, int D, int H, int W, int h, int w, int C, int tile_h,
              int cells_max, int max_log2g, dim3& grid, int& threads) {
  const int log2g = (C % kVec) ? -1 : wm::log2_exact(C / kVec);
  if (log2g < 0 || log2g > max_log2g || B <= 0 || D <= 0 || H <= 0 ||
      W <= 0 || h <= 0 || w <= 0 || h > 32767 || w > 32767 || B > 65535 ||
      tile_h <= 0 || cells_max < 0)
    return -1;
  const long long thr = (long long)tile_h * wm::kTileW << log2g;
  const long long n_tiles = (long long)((H + tile_h - 1) / tile_h) *
                            ((W + wm::kTileW - 1) / wm::kTileW);
  const long long n_runs = ((long long)D + wm::kDRun - 1) / wm::kDRun;
  if (thr > wm::kMaxTileThreads || thr % 32 != 0 || n_tiles > 0x7fffffffLL ||
      n_runs > 65535)
    return -1;
  grid = dim3((unsigned)n_tiles, (unsigned)n_runs, B);
  threads = (int)thr;
  return log2g;
}

}  // namespace

extern "C" {

// Both entry points return cudaGetLastError() after the launch (0 =
// success); cudaErrorInvalidValue for arguments the kernels do not take.
// tile_counter: null, or 2 device counters (staged, global blocks) that the
// launch adds to. tile_h: rows of a block's tile (of kTileW columns);
// cells_max: the source cells the stage buffer holds (0: every sample
// reads device memory). (sx, sy, x_lo, x_hi, y_lo, y_hi): the coordinate
// convention (sampler.cuh).

// C = 8 * 2^k <= 256.
int wm_sweep_warp(const void* src, const void* P, const void* Q,
                  const void* s, void* out, void* tile_counter, int B, int D,
                  int H, int W, int h, int w, int C, int s_per_pixel,
                  int tile_h, int cells_max, float sx, float sy, float x_lo,
                  float x_hi, float y_lo, float y_hi, void* stream) {
  dim3 grid;
  int thr;
  const int log2g = view_grid(B, D, H, W, h, w, C, tile_h, cells_max, 5,
                              grid, thr);
  if (log2g < 0) return (int)cudaErrorInvalidValue;
  const Convention cv{sx, sy, x_lo, x_hi, y_lo, y_hi};
  const cudaStream_t st = (cudaStream_t)stream;
  if (wm::is_identity(cv))
    return launch_c<false, false>(C, grid, thr, st, src, nullptr, P, Q, s,
                                  out, tile_counter, D, H, W, h, w,
                                  s_per_pixel, tile_h, cells_max, cv);
  return launch_c<true, false>(C, grid, thr, st, src, nullptr, P, Q, s, out,
                               tile_counter, D, H, W, h, w, s_per_pixel,
                               tile_h, cells_max, cv);
}

// C must be 8, 16, 32 or 64.
int wm_sweep_gwc(const void* src, const void* ref, const void* P,
                 const void* Q, const void* s, void* out, void* tile_counter,
                 int B, int D, int H, int W, int h, int w, int C,
                 int s_per_pixel, int tile_h, int cells_max, float sx,
                 float sy, float x_lo, float x_hi, float y_lo, float y_hi,
                 void* stream) {
  dim3 grid;
  int thr;
  if (view_grid(B, D, H, W, h, w, C, tile_h, cells_max, 3, grid, thr) < 0)
    return (int)cudaErrorInvalidValue;
  const Convention cv{sx, sy, x_lo, x_hi, y_lo, y_hi};
  return launch_c<true, true>(C, grid, thr, (cudaStream_t)stream, src, ref,
                              P, Q, s, out, tile_counter, D, H, W, h, w,
                              s_per_pixel, tile_h, cells_max, cv);
}

}  // extern "C"
