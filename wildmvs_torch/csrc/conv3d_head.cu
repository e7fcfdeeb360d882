// The score head of the port's 3D regularizers on Hopper (sm_90a): the one
// convolution that ends MVSNet's CostRegNet (`prob`, 8 -> 1), Vis-MVSNet's
// RegPair and RegFuse (`final_conv`, 8 -> 1) and CVP-MVSNet's shared
// regularizer (`prob0`, 16 -> 1). 3x3x3 taps, stride 1, zero padding 1, one
// output channel, C = 8 or 16 input channels, with or without bias.
//
// It replaces no Pallas kernel: the JAX package leaves this convolution to
// XLA. It was added because cuDNN takes a generic implicit-GEMM kernel
// without tensor cores for a 3D convolution with one output channel, and
// that kernel led the device time of every served net on an H100 (about
// 1 ns a voxel for each 8 input channels: 22.8 ms of MVSNet's 192x296x400
// head at 1184x1600, 65 ms of Vis-MVSNet's 15 heads a request, 40 ms of
// CVP-MVSNet's five; PERF.md).
//
// Arithmetic: the weight and bias come in the compute dtype (bf16 or f32)
// and are widened to f32; each output voxel sums its 27 * C products in f32
// registers, adds the bias in f32 and is rounded once to the compute dtype
// (nearest even), as cuDNN's bf16 convolution accumulates. No packed bf16
// FMAs (they would accumulate in bf16) and no atomics, so two calls give
// the same bits.
//
// Bound: 27 * C FMAs a voxel against C inputs read and one output written,
// 24 (C = 8) to 25 (C = 16) operations a byte in bf16. Products of bf16
// operands summed in f32 are what the tensor cores' bf16 MMA computes
// (989 TFLOP/s), so in bf16 the bytes bound the op: MVSNet's head reads
// 364 MB and writes 45 MB, 0.122 ms at 3.35 TB/s. In f32 (4C + 4 bytes a
// voxel, about 13 operations a byte) the bytes bound it even at the CUDA
// cores' 67 TFLOP/s. This kernel runs the bf16 products on the CUDA cores
// in f32 (9.8 GFLOP, 0.147 ms for MVSNet's head), so it can reach at most
// about 83 % of the bf16 bound; a tensor-core formulation
// (27 * C taps and channels as K, neighbouring outputs as N) would lift
// that ceiling.
//
// Design. A block owns an output tile of kRows x kTileW (32 x 64, or 16 x 64
// where the planes would not fit) over a chunk of D and walks it plane by
// plane. The haloed input plane, (kRows + 2) x (kTileW + 2) voxels of C
// channels, is copied into shared memory by 16-byte cp.async (zero-filled
// outside the volume: the padding) while the previous plane is computed, two
// buffers deep. A thread owns kStrip = 8 consecutive W outputs of one row
// and keeps three sets of accumulators: each input plane p adds its taps
// kd = 0, 1, 2 into outputs p + 1, p and p - 1, so each input value read
// from shared memory feeds 3 x 3 (kd, kw) taps of the strip, and output
// p - 1 is complete after plane p. Weights sit in shared memory as f32 and
// are read by broadcast, 72 at a time (one kh and 8 channels). A warp is
// 8 rows x 4 strips, its 8-lane phases 8 rows of one column, and a plane's
// row pitch is an odd number of 16-byte chunks, so a phase's 16-byte loads
// fall in 8 distinct bank groups. The D chunk is chosen from the shape
// (`launch`) so that every level fills the card; the first and last plane
// of a chunk, which feed only one output of the chunk, compute that tap
// alone.
//
// Layouts: input [B, D, H, W, C] (the NCDHW tensor in channels_last_3d
// memory), weight [1, C, 3, 3, 3], bias [1] or null, output [B, D, H, W].
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch.
#include "footprint.cuh"

namespace {

constexpr int kStrip = 8;                  // consecutive W outputs a thread
constexpr int kTileW = 64;                 // columns of a tile: 2 warps
constexpr int kHaloW = kTileW + 2;         // staged columns of a plane
constexpr size_t kSmemMax = 232448;        // shared memory a block may take
// blocks a launch aims for: 8 to the H100's 132 SMs, so that the last wave
// of a large level is a small share of it
constexpr int kTargetBlocks = 8 * 132;
constexpr int kMinDChunk = 4;              // each chunk stages 2 halo planes

// Shared-memory geometry of a block for compute type T, C = 8 * kG8 and
// tile rows kRows.
template <typename T, int kG8, int kRows>
struct HeadPlan {
  static constexpr int kChunksPerGroup = 8 * (int)sizeof(T) / 16;  // 1 or 2
  static constexpr int kChunksPerVoxel = kG8 * kChunksPerGroup;
  // odd, so that 8 consecutive rows start in 8 distinct bank groups
  static constexpr int kPitch = (kHaloW * kChunksPerVoxel) | 1;
  static constexpr int kPlaneChunks = (kRows + 2) * kPitch;
  static constexpr int kThreads = kRows / 8 * 2 * 32;
  static constexpr int kWeights = 27 * 8 * kG8;
  static constexpr size_t kSmemBytes =
      2 * (size_t)kPlaneChunks * 16 + (size_t)kWeights * 4;
};

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(float v) { return v; }

// 8 channels of one voxel from shared memory, as f32.
__device__ __forceinline__ void load8(const uint4* p, float (&x)[8],
                                      __nv_bfloat16) {
  const uint4 u = *p;
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const uint4* p, float (&x)[8], float) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// Copy input plane p's haloed tile into buf (cp.async; zeros outside).
template <typename T, int kG8, int kRows>
__device__ __forceinline__ void stage_plane(uint4* buf, const T* in, int b,
                                            int p, int D, int H, int W,
                                            int h0, int w0) {
  using Pl = HeadPlan<T, kG8, kRows>;
  constexpr int kRowChunks = kHaloW * Pl::kChunksPerVoxel;
  constexpr int kElemsPerChunk = 16 / (int)sizeof(T);
  constexpr int kC = 8 * kG8;
  const size_t plane = ((size_t)b * D + p) * H;
  for (int i = threadIdx.x; i < (kRows + 2) * kRowChunks; i += Pl::kThreads) {
    const int r = i / kRowChunks;
    const int rem = i - r * kRowChunks;
    const int v = rem / Pl::kChunksPerVoxel;
    const int q = rem - v * Pl::kChunksPerVoxel;
    const int gh = h0 - 1 + r, gw = w0 - 1 + v;
    const bool in_vol = gh >= 0 && gh < H && gw >= 0 && gw < W;
    const T* src = in_vol ? in + ((plane + gh) * W + gw) * kC +
                                q * kElemsPerChunk
                          : in;
    wm::cp_async16(buf + r * Pl::kPitch + rem, src, in_vol ? 16 : 0);
  }
}

// Add one staged plane's taps into the accumulators: acc[kd][j] gets tap kd
// of output column j, for the kd set in kMask (bit kd).
template <typename T, int kG8, int kRows, int kMask>
__device__ __forceinline__ void plane_taps(const uint4* buf, const float* wsm,
                                           int row, int col0,
                                           float (&acc)[3][kStrip]) {
  using Pl = HeadPlan<T, kG8, kRows>;
#pragma unroll 1
  for (int khg = 0; khg < 3 * kG8; ++khg) {
    const int kh = khg / kG8, g = khg - kh * kG8;
    // weights of this kh and channel group: [kd][kw][c], 72 floats
    float w[3][3][8];
    const float4* wp = reinterpret_cast<const float4*>(wsm + khg * 72);
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
      if (!(kMask >> kd & 1)) continue;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const float4 a = wp[(kd * 3 + kw) * 2], c = wp[(kd * 3 + kw) * 2 + 1];
        w[kd][kw][0] = a.x; w[kd][kw][1] = a.y;
        w[kd][kw][2] = a.z; w[kd][kw][3] = a.w;
        w[kd][kw][4] = c.x; w[kd][kw][5] = c.y;
        w[kd][kw][6] = c.z; w[kd][kw][7] = c.w;
      }
    }
    const uint4* rp = buf + (row + kh) * Pl::kPitch +
                      col0 * Pl::kChunksPerVoxel + g * Pl::kChunksPerGroup;
#pragma unroll
    for (int p = 0; p < kStrip + 2; ++p) {
      float x[8];
      load8(rp + p * Pl::kChunksPerVoxel, x, T());
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int j = p - kw;
        if (j < 0 || j >= kStrip) continue;
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
          if (!(kMask >> kd & 1)) continue;
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[kd][j] = fmaf(w[kd][kw][c], x[c], acc[kd][j]);
        }
      }
    }
  }
}

// Round one finished strip (plus the bias) and store its live columns.
__device__ __forceinline__ void store_strip(__nv_bfloat16* dst,
                                            const float (&a)[kStrip],
                                            float bias, int n, bool vec) {
  if (vec) {
    __nv_bfloat162 h2[kStrip / 2];
#pragma unroll
    for (int i = 0; i < kStrip / 2; ++i)
      h2[i] = __floats2bfloat162_rn(a[2 * i] + bias, a[2 * i + 1] + bias);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h2);
    return;
  }
#pragma unroll
  for (int j = 0; j < kStrip; ++j)
    if (j < n) dst[j] = __float2bfloat16_rn(a[j] + bias);
}
__device__ __forceinline__ void store_strip(float* dst,
                                            const float (&a)[kStrip],
                                            float bias, int n, bool vec) {
  if (vec) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    d4[0] = make_float4(a[0] + bias, a[1] + bias, a[2] + bias, a[3] + bias);
    d4[1] = make_float4(a[4] + bias, a[5] + bias, a[6] + bias, a[7] + bias);
    return;
  }
#pragma unroll
  for (int j = 0; j < kStrip; ++j)
    if (j < n) dst[j] = a[j] + bias;
}

// grid (tiles of kRows x kTileW, chunks of d_chunk planes, B).
template <typename T, int kG8, int kRows>
__global__ void __launch_bounds__(HeadPlan<T, kG8, kRows>::kThreads,
                                  512 / HeadPlan<T, kG8, kRows>::kThreads)
conv3d_head_kernel(const T* __restrict__ in, const T* __restrict__ weight,
                   const T* __restrict__ bias, T* __restrict__ out, int D,
                   int H, int W, int tiles_w, int d_chunk) {
  using Pl = HeadPlan<T, kG8, kRows>;
  extern __shared__ uint4 smem[];
  float* wsm = reinterpret_cast<float*>(smem + 2 * Pl::kPlaneChunks);

  const int h0 = blockIdx.x / tiles_w * kRows;
  const int w0 = blockIdx.x % tiles_w * kTileW;
  const int d0 = blockIdx.y * d_chunk;
  const int d1 = min(D, d0 + d_chunk);
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = (warp >> 1) * 8 + (lane & 7);
  const int col0 = ((warp & 1) * 4 + (lane >> 3)) * kStrip;
  const int h = h0 + row, wc = w0 + col0;
  const bool live = h < H && wc < W;
  const int n_cols = min(kStrip, W - wc);
  // a whole strip at an aligned address: one 16-byte store (two for f32)
  const bool vec = n_cols == kStrip && W % (16 / (int)sizeof(T)) == 0;

  // weights as f32, [kh][g][kd][kw][c]
  for (int i = threadIdx.x; i < Pl::kWeights; i += Pl::kThreads) {
    const int c = i % 8, kw = i / 8 % 3, kd = i / 24 % 3;
    const int g = i / 72 % kG8, kh = i / (72 * kG8);
    wsm[i] = widen(weight[(g * 8 + c) * 27 + kd * 9 + kh * 3 + kw]);
  }
  const float bias_f = bias == nullptr ? 0.f : widen(bias[0]);

  float acc[3][kStrip];
#pragma unroll
  for (int kd = 0; kd < 3; ++kd)
#pragma unroll
    for (int j = 0; j < kStrip; ++j) acc[kd][j] = 0.f;

  // planes d0 - 1 .. d1 feed the chunk's outputs; outside [0, D) they are
  // the zero padding and are skipped
  const int pa = max(d0 - 1, 0), pb = min(d1, D - 1);
  stage_plane<T, kG8, kRows>(smem, in, b, pa, D, H, W, h0, w0);
  wm::cp_async_commit();
  for (int p = pa; p <= pb; ++p) {
    uint4* cur = smem + ((p - pa) & 1) * Pl::kPlaneChunks;
    if (p < pb)
      stage_plane<T, kG8, kRows>(smem + ((p - pa + 1) & 1) * Pl::kPlaneChunks,
                                 in, b, p + 1, D, H, W, h0, w0);
    wm::cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (live) {
      // taps whose output (p + 1 - kd) lies in the chunk
      const int mask = (p + 1 >= d0 && p + 1 < d1) |
                       (p >= d0 && p < d1) << 1 |
                       (p - 1 >= d0 && p - 1 < d1) << 2;
      if (mask == 1)
        plane_taps<T, kG8, kRows, 1>(cur, wsm, row, col0, acc);
      else if (mask == 4)
        plane_taps<T, kG8, kRows, 4>(cur, wsm, row, col0, acc);
      else
        plane_taps<T, kG8, kRows, 7>(cur, wsm, row, col0, acc);
      if (p - 1 >= d0 && p - 1 < d1)
        store_strip(out + (((size_t)b * D + p - 1) * H + h) * W + wc, acc[2],
                    bias_f, n_cols, vec);
    }
#pragma unroll
    for (int j = 0; j < kStrip; ++j) {
      acc[2][j] = acc[1][j];
      acc[1][j] = acc[0][j];
      acc[0][j] = 0.f;
    }
    __syncthreads();     // every thread is done with cur before its refill
  }
  // the last plane of the volume: its plane D is padding, so it is complete
  if (live && d1 == D)
    store_strip(out + (((size_t)b * D + D - 1) * H + h) * W + wc, acc[2],
                bias_f, n_cols, vec);
}

// The launch plan: tiles of kRows x kTileW outputs, and D cut into chunks
// of at least kMinDChunk planes so that the launch makes about
// kTargetBlocks blocks.
template <typename T, int kG8, int kRows>
int launch(const void* in, const void* weight, const void* bias, void* out,
           int B, int D, int H, int W, cudaStream_t stream) {
  using Pl = HeadPlan<T, kG8, kRows>;
  static_assert(Pl::kSmemBytes <= kSmemMax, "two planes must fit");
  auto kernel = conv3d_head_kernel<T, kG8, kRows>;
  const int err = wm::allow_smem((const void*)kernel, Pl::kSmemBytes);
  if (err != 0) return err;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles = tiles_w * ((H + kRows - 1) / kRows);
  const int chunks = (kTargetBlocks + B * tiles - 1) / (B * tiles);
  const int spread = (D + chunks - 1) / chunks;
  const int d_chunk = spread > kMinDChunk ? spread : kMinDChunk;
  const dim3 grid(tiles, (D + d_chunk - 1) / d_chunk, B);
  kernel<<<grid, Pl::kThreads, Pl::kSmemBytes, stream>>>(
      static_cast<const T*>(in), static_cast<const T*>(weight),
      static_cast<const T*>(bias), static_cast<T*>(out), D, H, W, tiles_w,
      d_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for what the kernel does not take. is_f32: the
// compute dtype is f32 (else bf16). Tiles of 32 rows, or 16 for f32 with
// C = 16, whose two planes of 32 rows would not fit in shared memory. bias
// may be null.
int wm_conv3d_head(const void* in, const void* weight, const void* bias,
                   void* out, int B, int C, int D, int H, int W, int is_f32,
                   void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!is_f32 && C == 8)
    return launch<__nv_bfloat16, 1, 32>(in, weight, bias, out, B, D, H, W,
                                        st);
  if (!is_f32 && C == 16)
    return launch<__nv_bfloat16, 2, 32>(in, weight, bias, out, B, D, H, W,
                                        st);
  if (is_f32 && C == 8)
    return launch<float, 1, 32>(in, weight, bias, out, B, D, H, W, st);
  if (is_f32 && C == 16)
    return launch<float, 2, 16>(in, weight, bias, out, B, D, H, W, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
