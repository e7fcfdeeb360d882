// Source footprints in shared memory: the design of the port's forward
// sweep kernels, since each reads many samples per source pixel. Three
// kernels copy the footprint's bf16 features into shared memory and sample
// from there: fused_cost_volume (csrc/sweep.cu), sweep_warp and sweep_gwc
// (csrc/warp.cu). The warp's transpose, sweep_warp_backward (csrc/sweep.cu),
// shares the tile, the run and their set-up (make_tile, load_tile_planes,
// hyp_range) but stages nothing (see "The backward" below).
//
// A block owns a tile of tile_h x kTileW reference pixels (C/8 threads a
// pixel, one per 8-channel slice) over a run of kDRun hypotheses. It loads
// the tile's planes and the run's hypotheses once, copies into shared
// memory each view's footprint (the box of source cells that the tile's
// samples over the run can read; a stage in the words below), and then
// samples from there with no further barrier.
//
// The footprint rule (sweep_kernels.sweep_footprints is the same rule in
// PyTorch). Project the 8 corners of the box (the tile's four corner pixels)
// x [s_lo, s_hi], where s_lo and s_hi are the least and greatest hypothesis
// of the run over the tile, with the sampler's own arithmetic (proj1, the
// convention's division, scale and clamp). For planes built by
// mvsnet_planes or vis_planes, (rx, ry, rz) is affine in the pixel for a
// fixed s and affine in s for a fixed pixel; so when rz > 0 at the 8
// corners, rz > 0 on the whole box, and x = rx / rz (a linear-fractional
// function of the pixel, monotone in s; the clamp is monotone) takes its
// extremes at the corners. The footprint is [floor(x_min) - 1,
// floor(x_max) + 2] (y alike): one cell for the bilinear +1 corner and one
// for rounding, cut to the image's zero ring [-1, w] x [-1, h]. Cells
// outside the image are zero-filled (cp.async with a source size of 0),
// which is the sampler's border-zero.
//
// Exact whatever the planes: every live sample checks that its four
// corners lie in the staged box (four integer compares) and otherwise reads
// device memory through the sampler's corners8, with the same arithmetic. A
// stage with rz <= 0 (or a non-finite coordinate) at a corner stages
// nothing, and all its samples take that path. The footprint decides speed,
// never a result.
//
// The stage buffer. A block has one buffer of cells_max source cells for
// all its views; the views' footprints are placed in it in view order, and
// a view whose footprint does not fit in what the views before it left is
// not staged. The wrapper sizes the buffer from NV
// (sweep_kernels.footprint_plan), so that one launch takes any number of
// views: more views share the same bytes instead of passing the block's
// shared-memory limit or the SM's occupancy.
//
// Why one stage a run and not double-buffered stages of a few hypotheses:
// on the H100 the kernels are bound by the instructions of each sample
// (two IEEE divisions, 32 conversions and 32 FMAs), not by its gathers;
// stages of 1-4 hypotheses, each with its footprint, copies and two
// barriers, ran slower than the one-thread-a-sample kernels they
// replaced (PERF.md). The
// sampling also shares the taps (the divisions) among a pixel's threads.
//
// The backward. An f32 accumulator of the footprint in shared memory,
// which the block would add into the source gradient once, measured slower
// at every training shape on an H100 than adding each sample's corners
// into device memory (PERF.md): an f32 add into shared memory is a
// compare-and-swap loop (ATOMS.CAST.SPIN) that waits for its answer, where
// a 16-byte add into device memory (RED) does not wait. So
// sweep_warp_backward keeps its corner sums in registers while a sample
// stays in one source cell, and adds into device memory when it moves.
#pragma once

#include "sampler.cuh"

namespace wm {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxTileThreads = 256;   // threads of a footprint block, at most
constexpr int kTileW = 8;              // columns of a tile
// Hypotheses of a block's run (sweep_kernels.FOOTPRINT_D_RUN): one staged
// footprint a view covers them all, and the longer run amortizes the
// block's set-up (16 ran faster than 8 on an H100, PERF.md).
constexpr int kDRun = 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for every committed cp.async group of this thread.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Streaming (evict-first) stores of the output volume, so that it does not
// push the source maps out of L2.
__device__ __forceinline__ void store_cs(__nv_bfloat16* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}
__device__ __forceinline__ void store_cs(__nv_bfloat16* p, uint2 v) {
  asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};\n" ::"l"(p), "r"(v.x),
               "r"(v.y) : "memory");
}
__device__ __forceinline__ void store_cs(__nv_bfloat16* p, unsigned v) {
  asm volatile("st.global.cs.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void store_cs(__nv_bfloat16* p, unsigned short v) {
  asm volatile("st.global.cs.u16 [%0], %1;\n" ::"l"(p), "h"(v) : "memory");
}

// n f32 values rounded to bf16 (nearest even) and stored with one
// streaming store of 2n bytes (n = 1, 2, 4 or 8).
template <int N>
__device__ __forceinline__ void store_bf16_cs(__nv_bfloat16* p,
                                              const float* v) {
  if constexpr (N == 1) {
    const __nv_bfloat16 b = __float2bfloat16_rn(v[0]);
    store_cs(p, *reinterpret_cast<const unsigned short*>(&b));
  } else {
    __nv_bfloat162 h2[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    if constexpr (N == 2) store_cs(p, *reinterpret_cast<const unsigned*>(h2));
    if constexpr (N == 4) store_cs(p, *reinterpret_cast<const uint2*>(h2));
    if constexpr (N == 8) store_cs(p, *reinterpret_cast<const uint4*>(h2));
  }
}

// A block's tile of reference pixels and this thread's place in it.
struct Tile {
  int y0, x0;          // first pixel of the tile
  int th, tw;          // rows and columns inside the image (ragged edges)
  int npx;             // pixels of a full tile
  int slot;            // this thread's pixel in the tile, clamped inside
  int pix;             // that pixel, y * W + x
  bool live;           // this thread's pixel lies inside the image
};

// Slot of corner k of the tile's pixels inside the image: bit 0 picks the
// last column, bit 1 the last row.
__device__ __forceinline__ int corner_slot(const Tile& t, int k) {
  return ((k & 2) ? (t.th - 1) * kTileW : 0) + ((k & 1) ? t.tw - 1 : 0);
}

// Tile blockIdx.x of an H x W grid cut into tile_h x kTileW tiles; thread
// threadIdx.x owns slice (threadIdx.x & (2^log2g - 1)) of pixel
// threadIdx.x >> log2g. Threads past a ragged edge take the nearest pixel
// inside, compute with it and store nothing.
__device__ __forceinline__ Tile make_tile(int H, int W, int tile_h,
                                          int log2g) {
  Tile t;
  const int n_tx = (W + kTileW - 1) / kTileW;
  const int tyi = blockIdx.x / n_tx;
  t.y0 = tyi * tile_h;
  t.x0 = (blockIdx.x - tyi * n_tx) * kTileW;
  t.th = min(tile_h, H - t.y0);
  t.tw = min(kTileW, W - t.x0);
  t.npx = tile_h * kTileW;
  const int lp = threadIdx.x >> log2g;
  const int ly = lp / kTileW, lx = lp % kTileW;
  t.live = ly < t.th && lx < t.tw;
  const int cy = min(ly, t.th - 1), cx = min(lx, t.tw - 1);
  t.slot = cy * kTileW + cx;
  t.pix = (t.y0 + cy) * W + t.x0 + cx;
  return t;
}

// pq[(v * 6 + k) * npx + slot] = (P then Q)[b, v, k % 3] at the slot's
// pixel (clamped inside), for the NV views of P/Q [B, NV, 3, H, W].
__device__ __forceinline__ void load_tile_planes(float* pq, const float* P,
                                                 const float* Q, int b,
                                                 int NV, int H, int W,
                                                 const Tile& t) {
  const int hw = H * W;
  const int n = NV * 6 * t.npx;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int vk = i / t.npx;
    const int slot = i - vk * t.npx;
    const int v = vk / 6, k = vk - v * 6;
    const int ly = slot / kTileW, lx = slot % kTileW;
    const int pix = (t.y0 + min(ly, t.th - 1)) * W + t.x0 + min(lx, t.tw - 1);
    const size_t at = ((size_t)(b * NV + v) * 3 + (k % 3)) * hw + pix;
    pq[i] = (k < 3 ? P : Q)[at];
  }
}

// Hypothesis d of this thread's pixel (s [B, D] or [B, D, H, W]).
__device__ __forceinline__ float hyp(const float* s, int s_per_pixel, int b,
                                     int D, int hw, int d, int pix) {
  return s_per_pixel ? s[((size_t)b * D + d) * hw + pix] : s[(size_t)b * D + d];
}

// The least and greatest hypothesis of the block's run [d0, d_end) over
// the tile, reduced within each warp into sred[warp * 2 + {0, 1}];
// run_range() finishes the reduction across the warps after a barrier.
// The run's hypotheses also land in sv[(d - d0) * npx + slot] (the first
// slice of each pixel writes them), so the sampling loop reads them from
// shared memory: their device loads are all in flight at once here.
__device__ __forceinline__ void hyp_range(float* sred, float* sv,
                                          const float* s, int s_per_pixel,
                                          int b, int D, int hw, int d0,
                                          int d_end, const Tile& t,
                                          bool first_slice) {
  float lo = __int_as_float(0x7f800000), hi = -lo;
  for (int d = d0; d < d_end; ++d) {
    const float v = hyp(s, s_per_pixel, b, D, hw, d, t.pix);
    if (first_slice) sv[(d - d0) * t.npx + t.slot] = v;
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFullMask, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFullMask, hi, o));
  }
  if ((threadIdx.x & 31) == 0) {
    sred[(threadIdx.x >> 5) * 2] = lo;
    sred[(threadIdx.x >> 5) * 2 + 1] = hi;
  }
}

__device__ __forceinline__ void run_range(const float* sred, float& lo,
                                          float& hi) {
  lo = sred[0];
  hi = sred[1];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) {
    lo = fminf(lo, sred[2 * i]);
    hi = fmaxf(hi, sred[2 * i + 1]);
  }
}

// A stage's box of source cells (inclusive; cols = x1 - x0 + 1), how many
// 16-byte pieces it stages (0 when it is empty or not staged) and where in
// the block's stage buffer (elements).
struct Footprint {
  int x0, y0, x1, y1, cols, n16, off;
  bool staged;
};

// The footprint of one stage (see the top of this file). pqv: the view's
// tile planes (load_tile_planes layout, npx apart); [s_lo, s_hi]: the
// stage's hypotheses over the tile. Every lane of the warp must call it.
template <bool kConv>
__device__ __forceinline__ Footprint footprint(const float* pqv,
                                               const Tile& t, float s_lo,
                                               float s_hi,
                                               const Convention& cv, int h,
                                               int w, int log2g,
                                               int cells_max) {
  const int lane = threadIdx.x & 31;
  const int slot = corner_slot(t, lane & 3);
  const float sv = (lane & 4) ? s_hi : s_lo;
  const float rx = proj1(pqv[slot], sv, pqv[3 * t.npx + slot]);
  const float ry = proj1(pqv[t.npx + slot], sv, pqv[4 * t.npx + slot]);
  const float rz = proj1(pqv[2 * t.npx + slot], sv, pqv[5 * t.npx + slot]);
  float x, y;
  if (kConv) {
    x = coord1(rx, rz, cv.sx, cv.x_lo, cv.x_hi);
    y = coord1(ry, rz, cv.sy, cv.y_lo, cv.y_hi);
  } else {
    x = __fdiv_rn(rx, rz);
    y = __fdiv_rn(ry, rz);
  }
  int ok = rz > 0.f && isfinite(x) && isfinite(y);
  float xmin = x, xmax = x, ymin = y, ymax = y;
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    xmin = fminf(xmin, __shfl_xor_sync(kFullMask, xmin, o));
    xmax = fmaxf(xmax, __shfl_xor_sync(kFullMask, xmax, o));
    ymin = fminf(ymin, __shfl_xor_sync(kFullMask, ymin, o));
    ymax = fmaxf(ymax, __shfl_xor_sync(kFullMask, ymax, o));
    ok &= __shfl_xor_sync(kFullMask, ok, o);
  }
  // clamp before the int conversion: a far or non-finite coordinate stays
  // a few cells outside the ring
  const float wx = (float)w + 4.f, hy = (float)h + 4.f;
  Footprint f;
  f.x0 = max((int)floorf(fminf(fmaxf(xmin, -4.f), wx)) - 1, -1);
  f.x1 = min((int)floorf(fminf(fmaxf(xmax, -4.f), wx)) + 2, w);
  f.y0 = max((int)floorf(fminf(fmaxf(ymin, -4.f), hy)) - 1, -1);
  f.y1 = min((int)floorf(fminf(fmaxf(ymax, -4.f), hy)) + 2, h);
  const int cols = f.x1 - f.x0 + 1, rows = f.y1 - f.y0 + 1;
  const bool empty = cols <= 0 || rows <= 0;
  f.cols = empty ? 0 : cols;
  f.staged = ok && (empty || rows * cols <= cells_max);
  f.n16 = (f.staged && !empty) ? (rows * cols) << log2g : 0;
  f.off = 0;
  return f;
}

// Issue the cp.async copies of a staged footprint of img [h, w, C] into
// buf [rows, cols, C]: 16 bytes a thread per step, cells outside the image
// zero-filled. The caller commits the group.
__device__ __forceinline__ void stage(const Footprint& f,
                                      const __nv_bfloat16* __restrict__ img,
                                      int h, int w, int C, int log2g,
                                      __nv_bfloat16* buf) {
  const int per_row = f.cols << log2g;
  for (int i = threadIdx.x; i < f.n16; i += blockDim.x) {
    const int row = i / per_row;
    const int rem = i - row * per_row;
    const int xx = f.x0 + (rem >> log2g);
    const int yy = f.y0 + row;
    const bool in = xx >= 0 && xx < w && yy >= 0 && yy < h;
    const __nv_bfloat16* src =
        in ? img + ((size_t)yy * w + xx) * C + ((rem & ((1 << log2g) - 1))
                                                 * kVec)
           : img;
    cp_async16(buf + (size_t)i * kVec, src, in ? 16 : 0);
  }
}

// True when the four corners of the sample with top-left corner (x0, y0)
// lie in the staged footprint.
__device__ __forceinline__ bool in_footprint(const Footprint& f, int x0,
                                             int y0) {
  return f.staged && x0 >= f.x0 && x0 < f.x1 && y0 >= f.y0 && y0 < f.y1;
}

// The taps of one sample as the C/8 threads of a pixel exchange them (one
// thread computes a sample's taps, wm::taps, and the pixel's threads share
// them by shuffles): code >= 0 is the element offset of the top-left
// corner in the stage buffer; code == -1 a dead sample; code <= -2 a sample
// outside the staged box, read from device memory at x0 + 1 | (y0 + 1) <<
// 16 == -2 - code (the entry points keep h and w below 2^15).
struct Tap {
  int code;
  float fx, fy;
};

template <bool kConv>
__device__ __forceinline__ Tap make_tap(float rx, float ry, float rz,
                                        const Convention& cv, int h, int w,
                                        const Footprint& f, int C) {
  Tap tp;
  int x0, y0;
  if (!taps<kConv>(rx, ry, rz, cv, h, w, x0, y0, tp.fx, tp.fy)) {
    tp.code = -1;
    return tp;
  }
  tp.code = in_footprint(f, x0, y0)
                ? ((y0 - f.y0) * f.cols + (x0 - f.x0)) * C
                : -2 - ((x0 + 1) | ((y0 + 1) << 16));
  return tp;
}

__device__ __forceinline__ Tap shfl_tap(const Tap& t, int src_lane) {
  Tap r;
  r.code = __shfl_sync(kFullMask, t.code, src_lane);
  r.fx = __shfl_sync(kFullMask, t.fx, src_lane);
  r.fy = __shfl_sync(kFullMask, t.fy, src_lane);
  return r;
}

// The bilinear combine of channels [c0, c0+8) at a live sample's taps:
// from the stage buffer buf (row: its elements per footprint row) or, for a
// sample outside it, from img [h, w, C] through wm::corners8. The same
// weights and the same combine either way (corners k = 0..3 in order; a
// cell outside the image reads zero).
__device__ __forceinline__ void sample_tap(const Tap& tp,
                                           const __nv_bfloat16* buf, int row,
                                           const __nv_bfloat16* img, int h,
                                           int w, int C, int c0,
                                           float acc[kVec]) {
  if (tp.code >= 0) {
    const float fx = tp.fx, fy = tp.fy;
    const float wts[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx,
                          fy * (1.f - fx), fy * fx};
    const __nv_bfloat16* p = buf + tp.code + c0;
    float v[4][kVec];
    load8(p, v[0]);
    load8(p + C, v[1]);
    load8(p + row, v[2]);
    load8(p + row + C, v[3]);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] += wts[k] * v[k][i];
  } else if (tp.code <= -2) {
    const int xy = -2 - tp.code;
    corners8(img, h, w, C, c0, (xy & 0xffff) - 1, (xy >> 16) - 1, tp.fx,
             tp.fy, acc);
  }
}

// A footprint kernel's dynamic shared memory: the stage buffer of
// cells_max cells, the tile planes, the views' footprints and the run's
// hypothesis range.
struct StageSmem {
  __nv_bfloat16* buf;   // [cells_max * C], the views' footprints at fps[v].off
  float* pq;            // load_tile_planes
  float* sv;            // [kDRun][npx] hypotheses (hyp_range)
  Footprint* fps;       // [NV]
  float* sred;          // hyp_range
};

__device__ __forceinline__ StageSmem carve(unsigned char* smem, int NV,
                                           int cells_max, int C, int npx) {
  StageSmem m;
  m.buf = reinterpret_cast<__nv_bfloat16*>(smem);
  m.pq = reinterpret_cast<float*>(m.buf + (size_t)cells_max * C);
  m.sv = m.pq + NV * 6 * npx;
  m.fps = reinterpret_cast<Footprint*>(m.sv + kDRun * npx);
  m.sred = reinterpret_cast<float*>(m.fps + NV);
  return m;
}

// (sweep_kernels.footprint_smem_bytes is the same sum; the wrappers choose
// tile_h and cells_max with it.)
inline size_t footprint_smem_bytes(int NV, int cells_max, int C, int npx,
                                   int threads) {
  return (size_t)cells_max * C * 2 + (size_t)NV * 6 * npx * 4 +
         (size_t)kDRun * npx * 4 + NV * sizeof(Footprint) +
         (size_t)(threads / 32) * 2 * 4;
}

// The footprints of the NV views over the block's run [lo, hi] into
// m.fps: each warp takes 4 views at a time, 8 lanes a view.
template <bool kConv>
__device__ __forceinline__ void block_footprints(const StageSmem& m,
                                                 const Tile& t, float lo,
                                                 float hi,
                                                 const Convention& cv,
                                                 int NV, int h, int w,
                                                 int log2g, int cells_max) {
  const int lane = threadIdx.x & 31;
  const int per_pass = (blockDim.x >> 5) * 4;
  for (int v0 = (threadIdx.x >> 5) * 4; v0 < NV; v0 += per_pass) {
    const int v = v0 + (lane >> 3);
    const Footprint f =
        footprint<kConv>(m.pq + min(v, NV - 1) * 6 * t.npx, t, lo, hi, cv,
                         h, w, log2g, cells_max);
    if (v < NV && (lane & 7) == 0) m.fps[v] = f;
  }
}

// Place the views' footprints in the stage buffer of cells_max cells, in
// view order; a footprint that does not fit in what is left is not staged.
// One thread does it.
__device__ __forceinline__ void place_footprints(Footprint* fps, int NV,
                                                 int cells_max, int C,
                                                 int log2g) {
  int used = 0;
  for (int v = 0; v < NV; ++v) {
    Footprint& f = fps[v];
    const int cells = f.n16 >> log2g;
    if (cells == 0) continue;             // global, or empty and staged
    if (used + cells <= cells_max) {
      f.off = used * C;
      used += cells;
    } else {
      f.staged = false;
      f.n16 = 0;
    }
  }
}

// Add a block's counts of staged and global stages to tile_counter[0..1]
// unless it is null (sweep_kernels.counting_tiles; sweep_warp_backward
// counts its atomics into tile_counter[2]).
__device__ __forceinline__ void count_stages(unsigned long long* tile_counter,
                                             int n_staged, int n_global) {
  if (tile_counter != nullptr && threadIdx.x == 0) {
    atomicAdd(tile_counter, (unsigned long long)n_staged);
    atomicAdd(tile_counter + 1, (unsigned long long)n_global);
  }
}

// Place the footprints of m.fps (after a block barrier), copy every staged
// one (view v of img + v * stride) into the stage buffer and wait for the
// copies; counts the staged and the global views into tile_counter[0..1]
// unless it is null. Ends with a block barrier.
__device__ __forceinline__ void stage_all(const StageSmem& m,
                                          const __nv_bfloat16* img,
                                          size_t stride, int NV, int h,
                                          int w, int C, int log2g,
                                          int cells_max,
                                          unsigned long long* tile_counter) {
  if (threadIdx.x == 0) place_footprints(m.fps, NV, cells_max, C, log2g);
  __syncthreads();
  int n_staged = 0;
  for (int v = 0; v < NV; ++v) {
    const Footprint f = m.fps[v];
    n_staged += f.staged;
    stage(f, img + v * stride, h, w, C, log2g, m.buf + f.off);
  }
  cp_async_commit();
  cp_async_wait_all();
  count_stages(tile_counter, n_staged, NV - n_staged);
  __syncthreads();
}

// Let `kernel` take `bytes` of dynamic shared memory (above the default
// 48 KB only by this call). Returns the CUDA error, 0 on success.
inline int allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace wm
