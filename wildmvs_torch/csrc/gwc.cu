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
// up to 30 MB at the 1184x1600 eval's stage 3, stays in the 50 MB L2). On
// the card it is bound by the instructions of its samples instead.
//
// Design (footprint.cuh): grid (tiles, runs of kDRun hypotheses, B); a
// block of tile_h x kTileW pixels x C/8 threads, one thread per (pixel,
// 8-channel slice). A group has C/8 channels (at most 8 for C <= 64), so a
// slice holds whole groups: the thread forms its 8 warped channels in f32,
// sums its own groups with no shuffle, and the C/8 threads of a pixel
// together write its 16 output bytes (streaming stores). The block copies
// the source footprint of its tile over its run into shared memory once
// and samples from there; samples outside it read device memory through
// wm::corners8 with the same arithmetic. The C/8 threads of a pixel take
// the run C/8 hypotheses at a time: each computes the taps of one and they
// share them by shuffles. The counts of staged and global blocks go to
// tile_counter[0..1] unless it is null.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch.
#include "footprint.cuh"
#include "sampler.cuh"

namespace {

using wm::Convention;
using wm::kVec;
using wm::load8;
using wm::proj1;

constexpr int kGroups = 8;

// src [B, h, w, C], ref [B, H, W, C], P/Q [B, 3, H, W], s [B, D] or
// [B, D, H, W] -> out [B, D, H, W, 8].
// 4 blocks an SM (at most 64 registers, no spill): faster than 3 at stage
// 3 on an H100 (PERF.md).
template <int C>
__global__ void __launch_bounds__(wm::kMaxTileThreads, 4)
sweep_gwc_kernel(const __nv_bfloat16* __restrict__ src,
                 const __nv_bfloat16* __restrict__ ref,
                 const float* __restrict__ P, const float* __restrict__ Q,
                 const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
                 unsigned long long* __restrict__ tile_counter, int D, int H,
                 int W, int h, int w, int s_per_pixel, int tile_h,
                 int cells_max, Convention cv) {
  constexpr int kLog2g = C == 8 ? 0 : C == 16 ? 1 : C == 32 ? 2 : 3;
  constexpr int kPerGroup = C / kGroups;        // channels per group
  constexpr int kSlice = kVec / kPerGroup;      // groups per 8-channel slice
  extern __shared__ __align__(16) unsigned char smem[];
  const wm::Tile t = wm::make_tile(H, W, tile_h, kLog2g);
  const wm::StageSmem m = wm::carve(smem, 1, cells_max, C, t.npx);
  const int b = blockIdx.z;
  const int hw = H * W;
  const int d0 = blockIdx.y * wm::kDRun;
  const int d_end = min(d0 + wm::kDRun, D);
  const int slice = threadIdx.x & ((1 << kLog2g) - 1);
  const __nv_bfloat16* img = src + (size_t)b * h * w * C;

  wm::load_tile_planes(m.pq, P, Q, b, 1, H, W, t);
  wm::hyp_range(m.sred, m.sv, s, s_per_pixel, b, D, hw, d0, d_end, t,
                slice == 0);
  float refv[kVec];
  load8(ref + ((size_t)b * hw + t.pix) * C + slice * kVec, refv);
  __syncthreads();
  float lo, hi;
  wm::run_range(m.sred, lo, hi);
  wm::block_footprints<true>(m, t, lo, hi, cv, 1, h, w, kLog2g, cells_max);
  const float px = m.pq[t.slot], py = m.pq[t.npx + t.slot],
              pz = m.pq[2 * t.npx + t.slot];
  const float qx = m.pq[3 * t.npx + t.slot], qy = m.pq[4 * t.npx + t.slot],
              qz = m.pq[5 * t.npx + t.slot];
  __syncthreads();
  wm::stage_all(m, img, 0, 1, h, w, C, kLog2g, cells_max, tile_counter);
  const wm::Footprint f = m.fps[0];

  // the pixel's kG threads take the run kG hypotheses at a time: each
  // computes the taps of one (wm::make_tap) and they share them by shuffles
  constexpr int kG = 1 << kLog2g;
  const int lane0 = (threadIdx.x & 31) & ~(kG - 1);
  __nv_bfloat16* o =
      out + (((size_t)b * D + d0) * hw + t.pix) * kGroups + slice * kSlice;
  for (int d = d0; d < d_end; d += kG) {
    wm::Tap mine{-1, 0.f, 0.f};
    if (d + slice < d_end) {
      const float sv = m.sv[(d + slice - d0) * t.npx + t.slot];
      mine = wm::make_tap<true>(proj1(px, sv, qx), proj1(py, sv, qy),
                                proj1(pz, sv, qz), cv, h, w, f, C);
    }
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      const wm::Tap tp = wm::shfl_tap(mine, lane0 | j);
      if (d + j >= d_end) break;                   // uniform in the block
      float corr[kSlice];
#pragma unroll
      for (int k = 0; k < kSlice; ++k) corr[k] = 0.f;
      if (tp.code != -1) {
        float warped[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) warped[i] = 0.f;
        wm::sample_tap(tp, m.buf + f.off, f.cols * C, img, h, w, C,
                       slice * kVec, warped);
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          corr[i / kPerGroup] += refv[i] * warped[i];
      }
      if (t.live) wm::store_bf16_cs<kSlice>(o, corr);
      o += (size_t)hw * kGroups;
    }
  }
}

template <int C>
int launch(const dim3& grid, int threads, cudaStream_t stream,
           const void* src, const void* ref, const void* P, const void* Q,
           const void* s, void* out, void* tile_counter, int D, int H, int W,
           int h, int w, int s_per_pixel, int tile_h, int cells_max,
           const Convention& cv) {
  const size_t smem = wm::footprint_smem_bytes(1, cells_max, C,
                                               tile_h * wm::kTileW, threads);
  const int rc = wm::allow_smem((const void*)sweep_gwc_kernel<C>, smem);
  if (rc != 0) return rc;
  sweep_gwc_kernel<C><<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)src, (const __nv_bfloat16*)ref, (const float*)P,
      (const float*)Q, (const float*)s, (__nv_bfloat16*)out,
      (unsigned long long*)tile_counter, D, H, W, h, w, s_per_pixel, tile_h,
      cells_max, cv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success);
// cudaErrorInvalidValue for arguments the kernel does not take (C must be
// 8, 16, 32 or 64). tile_counter: null, or 2 device counters (staged,
// global blocks) that the launch adds to. tile_h: rows of a block's tile
// (of kTileW columns); cells_max: the source cells the stage buffer holds.
// (sx, sy, x_lo, x_hi, y_lo, y_hi): the coordinate convention
// (sampler.cuh).
int wm_sweep_gwc(const void* src, const void* ref, const void* P,
                 const void* Q, const void* s, void* out, void* tile_counter,
                 int B, int D, int H, int W, int h, int w, int C,
                 int s_per_pixel, int tile_h, int cells_max, float sx,
                 float sy, float x_lo, float x_hi, float y_lo, float y_hi,
                 void* stream) {
  const int log2g = (C % kVec) ? -1 : wm::log2_exact(C / kVec);
  if (log2g < 0 || log2g > 3 || B <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      h <= 0 || w <= 0 || h > 32767 || w > 32767 || B > 65535 ||
      tile_h <= 0 || cells_max < 0)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)tile_h * wm::kTileW << log2g;
  const long long n_tiles = (long long)((H + tile_h - 1) / tile_h) *
                            ((W + wm::kTileW - 1) / wm::kTileW);
  const long long n_runs = ((long long)D + wm::kDRun - 1) / wm::kDRun;
  if (threads > wm::kMaxTileThreads || threads % 32 != 0 ||
      n_tiles > 0x7fffffffLL || n_runs > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_tiles, (unsigned)n_runs, B);
  const Convention cv{sx, sy, x_lo, x_hi, y_lo, y_hi};
  const cudaStream_t st = (cudaStream_t)stream;
  const int thr = (int)threads;
  switch (C) {
    case 8:
      return launch<8>(grid, thr, st, src, ref, P, Q, s, out, tile_counter,
                       D, H, W, h, w, s_per_pixel, tile_h, cells_max, cv);
    case 16:
      return launch<16>(grid, thr, st, src, ref, P, Q, s, out, tile_counter,
                        D, H, W, h, w, s_per_pixel, tile_h, cells_max, cv);
    case 32:
      return launch<32>(grid, thr, st, src, ref, P, Q, s, out, tile_counter,
                        D, H, W, h, w, s_per_pixel, tile_h, cells_max, cv);
    default:
      return launch<64>(grid, thr, st, src, ref, P, Q, s, out, tile_counter,
                        D, H, W, h, w, s_per_pixel, tile_h, cells_max, cv);
  }
}

}  // extern "C"
