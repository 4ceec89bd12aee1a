// 2-bit packed ternary matmul for Hopper (sm_90a): three routed designs.
//
// Replaces: repro/kernels/ternary_matmul.py `_kernel` (pallas_call at :61),
// reached through `ternary_matmul` and `ops.ternary_matmul`; in the model it
// is every projection of `quant="ternary_packed"` (models/layers.py).
//
// Computes out[m, n] = scale[n] * sum_k x[m, k] * code(k, n), with
//   x     (M, K) float32 or bfloat16, row-major;
//   w2    (K/4, N) bytes, row-major: byte (r, n) holds the codes of
//         k = 4r..4r+3 in bits 0-1, 2-3, 4-5, 6-7;
//         code 01 -> +1, 10 -> -1, 00 and 11 -> 0;
//   scale (1, N) float32, applied once after the sum (as the Pallas kernel's
//         wrapper does at ternary_matmul.py:73);
//   out   (M, N) float32.
// Sums are float32; the codes are unpacked on chip and never written to
// device memory as a dense matrix.  The wrapper
// (`cuda_ternary_matmul.plan`) picks the design by M and x's dtype.
//
// What bounds each regime on this card (H100 SXM: 132 SMs, 3.35 TB/s,
// 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 on the CUDA
// cores), and what each design does about it:
//
// 1. Decode, M <= 8 (`ternary_splitk_kernel`, both dtypes, CUDA cores).
//    The byte bound is small (llama3.2-1b's w_gate: 4.2 MB, ~1.3 us); what
//    bounds it is getting those bytes in flight at once, then the float32
//    issue rate: at M = 8 a code feeds 8 FMAs, 134 M FMAs for w_gate.  A
//    block of 128 threads owns 64 output columns and one range of packed
//    rows (split K): the plan picks the splits so every llama3.2-1b
//    projection puts 256 blocks, one wave, on the 132 SMs.  The block
//    copies its packed slice (16-byte cp.async) and its slice of x into
//    shared memory in two groups, everything in flight at once, and sums
//    the first half while the second lands.  A thread sums 8 columns: a
//    byte's four codes become float32 +-2 by a byte permute (halved at the
//    end, exactly) and feed BM rows of FMAs.  Partial sums are reduced in
//    a fixed order: across a warp's row groups by a shuffle tree, across
//    the 4 warps through shared memory, and across the K splits in the
//    same launch: every block writes its partial tile to a workspace, and
//    the last block to arrive on a column tile (a per-tile counter, after
//    __threadfence) adds the partials in split order, applies `scale`,
//    writes `out` and resets the counter to 0.  No float atomics: two
//    launches on the same operands give bit-identical results.
// 2. Prefill, M > 8 with bf16 x (`ternary_mma_kernel`, tensor cores).
//    Bound: the 2*M*K*N operations (w_gate at M = 768: 25.8 GFLOP, 26 us
//    at the bf16 rate), and below that the L2 traffic of re-reading x for
//    every column tile.  `wgmma` (not mma.sync: an mma.sync design with
//    ldmatrix reached about a fifth of the rate, see PERF.md) computes the
//    product transposed, the decoded codes as the register A operand and
//    x's tile as the shared-memory B operand; see section 2 below.  Tile
//    rows (BMM 128, 96 or 64) are chosen per shape so the grid fills the
//    card; where even 64 leaves it thin, K is split through the same
//    fixed-order reduction.  `scale` is applied in the epilogue.  Codes
//    are exactly +-2 or 0 in bf16, so each product is exact and only the
//    float32 sums round.
// 3. M > 8 with float32 x (`ternary_matmul_kernel`, CUDA cores; also bf16
//    x whose address is not 8-byte aligned).  It serves the float32 model
//    (card-against-CPU checks) and the tests, not the bf16 serving path.
//    A block owns 128 output columns and 8 rows of x; its 8 warps split
//    each 256-wide K tile, a lane owns 4 columns (one 4-byte word per
//    packed row), and the next tile's words load while the current one is
//    summed; the warps' sums are added in a fixed order.
//
// The workspace and the counters of designs 1 and 2 belong to the wrapper,
// which allocates them once per device; the counters start at 0 and every
// launch leaves them at 0.  They assume one stream: two launches running at
// once on different streams would share them.
#include <atomic>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ternary_mma.cuh"

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The low two bits -> {+1, -1, 0}: 01 -> 1, 10 -> 0 - 1, 00 and 11 -> 0.
// Selects and one add, no integer-to-float conversion.
__device__ __forceinline__ float ternary(uint32_t code) {
  const float pos = (code & 1u) ? 1.f : 0.f;
  return (code & 2u) ? pos - 1.f : pos;
}

// a + the four codes of byte b times xv.x, .y, .z, .w, in k order.
__device__ __forceinline__ float dot4(uint32_t b, float4 xv, float a) {
  a = fmaf(ternary(b), xv.x, a);
  a = fmaf(ternary(b >> 2), xv.y, a);
  a = fmaf(ternary(b >> 4), xv.z, a);
  return fmaf(ternary(b >> 6), xv.w, a);
}

// The sums over the splits' partials (`stride` apart, split 0 first) of E
// floats `estride` apart, read past L1 so other blocks' writes are seen.
// The loads of several splits are issued before their adds, which stay in
// split order.
template <int E>
__device__ __forceinline__ void sum_splits(const float* __restrict__ p,
                                           long long stride, int estride,
                                           int splits, float (&acc)[E]) {
  constexpr int kBatch = E >= 8 ? 1 : 8 / E;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  int s = 0;
  for (; s + kBatch <= splits; s += kBatch) {
    float v[kBatch][E];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[u][e] = __ldcg(p + (s + u) * stride + e * estride);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += v[u][e];
  }
  for (; s < splits; ++s)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += __ldcg(p + s * stride + e * estride);
}

// After every thread of the block has written its partials: whether this
// block is the last of `splits` to arrive on counter `*cnt`.  The last one
// resets the counter for the next launch.
__device__ __forceinline__ bool last_to_arrive(int* cnt, int splits,
                                               int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const int prev = atomicAdd(cnt, 1);
    *flag = prev == splits - 1;
    if (*flag) *cnt = 0;
  }
  __syncthreads();
  if (*flag) __threadfence();
  return *flag;
}

// ---------------------------------------------------------------------------
// 1. Decode: split-K packed GEMV.
constexpr int kGvThreads = 128;
constexpr int kGvBlockN = 64;                   // output columns per block
constexpr int kGvChunk = 16;                    // bytes per copy
constexpr int kGvCols = 8;                      // columns a thread sums
constexpr int kGvColThreads = kGvBlockN / kGvCols;  // threads across a row
constexpr int kGvGroups = kGvThreads / kGvColThreads;  // 16 row groups
constexpr int kGvWarps = kGvThreads / 32;
constexpr int kGvMaxRows = 256;                 // packed rows per split

// 2 * code as float32, for the code in bits 12-13 of `v`: +2, -2 or 0.  A
// byte permute from a 4-entry table of high bytes; +2 and -2 (0x40000000,
// 0xC0000000) differ from 0 in the high byte alone.  Sums of these are
// exactly twice the sums of the codes, and are halved at the end.
__device__ __forceinline__ float twice_code(uint32_t v) {
  return __uint_as_float(__byte_perm(0x00C04000u, 0u, v & 0x3000u));
}

template <typename T, int BM>
struct GvSmem {
  static constexpr int kW = kGvMaxRows * kGvBlockN;        // packed slice
  static constexpr int kX = BM * 4 * kGvMaxRows * sizeof(T);  // x slice
  static constexpr int kBytes = kW + kX;
  static_assert(kGvWarps * BM * kGvBlockN * 4 <= kX, "partials reuse x");
};

// x[4q..4q+3] of a row staged in shared memory, as floats.
__device__ __forceinline__ float4 smem_x4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 smem_x4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

template <typename T, int BM>
__global__ void __launch_bounds__(kGvThreads)
    ternary_splitk_kernel(const T* __restrict__ x,
                          const uint8_t* __restrict__ w2,
                          const float* __restrict__ scale,
                          float* __restrict__ out, float* __restrict__ ws,
                          int* __restrict__ counters, int M, int K, int N,
                          int rows_per_split, int vec_x, int vec) {
  using S = GvSmem<T, BM>;
  constexpr int kXRow = 4 * kGvMaxRows;
  constexpr int kXChunk = 4 * sizeof(T);                 // 4 values of k
  extern __shared__ __align__(16) uint8_t gsm[];
  __shared__ int last;
  uint8_t* wsl = gsm;                                    // [rows][64] bytes
  T* xs = reinterpret_cast<T*>(gsm + S::kW);             // [BM][4 rows]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % kGvColThreads, g = tid / kGvColThreads;
  const int tile = blockIdx.x, split = blockIdx.z, splits = gridDim.z;
  const int K4 = K / 4;
  const int r0 = split * rows_per_split;
  const int rows = max(0, min(rows_per_split, K4 - r0));
  // The block's slice of x and its packed slice go to shared memory in two
  // cp.async groups, all of it in flight at once; the first half of the
  // rows is summed while the second lands.  `half` is a multiple of the
  // row groups' count (or all rows).
  for (int i = tid; i < BM * rows; i += kGvThreads) {
    const int m = i / rows, q = i - m * rows;
    const T* src = x + (long long)m * K + 4 * (r0 + q);
    T* dst = xs + m * kXRow + 4 * q;
    if (vec_x) {                                 // x 16-byte aligned
      if (kXChunk == 16)
        cp_async16(smem_u32(dst), m < M ? src : x, m < M ? 16 : 0);
      else
        cp_async8(smem_u32(dst), m < M ? src : x, m < M ? 8 : 0);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) dst[u] = m < M ? src[u] : T(0.f);
    }
  }
  const int half =
      min(rows, kGvGroups * ((rows + 2 * kGvGroups - 1) / (2 * kGvGroups)));
  for (int part = 0; part < 2; ++part) {
    const int lo = part ? half : 0, hi = part ? rows : half;
    for (int i = 4 * lo + tid; i < 4 * hi; i += kGvThreads) {
      const int row = i >> 2, n = tile * kGvBlockN + (i & 3) * kGvChunk;
      const uint8_t* src = w2 + (long long)(r0 + row) * N + n;
      uint8_t* dst = wsl + row * kGvBlockN + (i & 3) * kGvChunk;
      if (vec) {                                 // N % 16 == 0
        cp_async16(smem_u32(dst), n < N ? src : w2, n < N ? 16 : 0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        for (int b = 0; b < kGvChunk; ++b)
          if (n + b < N)
            w[b >> 2] |= static_cast<uint32_t>(__ldg(src + b)) << (8 * (b & 3));
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    cp_async_commit();
  }

  float acc[BM][kGvCols];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < kGvCols; ++j) acc[m][j] = 0.f;

  auto sum_row = [&](int r) {
    const uint2 cw = *reinterpret_cast<const uint2*>(
        wsl + r * kGvBlockN + c * kGvCols);
    const uint32_t word[2] = {cw.x, cw.y};
    float4 xv[BM];
#pragma unroll
    for (int m = 0; m < BM; ++m) xv[m] = smem_x4(xs + m * kXRow + 4 * r);
    // Each byte's four codes are decoded once and used for every row.
#pragma unroll
    for (int j = 0; j < kGvCols; ++j) {
      const uint32_t b = word[j >> 2] >> (8 * (j & 3));
      const float c0 = twice_code(b << 12), c1 = twice_code(b << 10),
                  c2 = twice_code(b << 8), c3 = twice_code(b << 6);
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        float a = acc[m][j];
        a = fmaf(c0, xv[m].x, a);
        a = fmaf(c1, xv[m].y, a);
        a = fmaf(c2, xv[m].z, a);
        acc[m][j] = fmaf(c3, xv[m].w, a);
      }
    }
  };
  cp_async_wait<1>();
  __syncthreads();
  for (int r = g; r < half; r += kGvGroups) sum_row(r);
  cp_async_wait<0>();
  __syncthreads();
  for (int r = half + g; r < rows; r += kGvGroups) sum_row(r);
  __syncthreads();                               // x is reused below
  float (*red)[BM][kGvBlockN] = reinterpret_cast<float (*)[BM][kGvBlockN]>(xs);

  // The row groups of a warp (lane / 8) by a shuffle tree, then the warps
  // in order through shared memory: the same order in every launch.
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < kGvCols; ++j) {
      float v = acc[m][j];
#pragma unroll
      for (int o = kGvColThreads; o < 32; o *= 2)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[m][j] = v;
    }
  if (lane < kGvColThreads) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int j = 0; j < kGvCols; j += 4)
        *reinterpret_cast<float4*>(&red[warp][m][c * kGvCols + j]) =
            make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2],
                        acc[m][j + 3]);
  }
  __syncthreads();

  constexpr int kOut = BM * kGvBlockN;          // block's partial tile
  constexpr int kPer = (kOut + kGvThreads - 1) / kGvThreads;
  float part[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int o = tid + e * kGvThreads;
    part[e] = 0.f;
    if (o < kOut) {
      const int m = o / kGvBlockN, col = o % kGvBlockN;
#pragma unroll
      for (int w = 0; w < kGvWarps; ++w) part[e] += red[w][m][col];
    }
  }
  if (splits > 1) {
    float* tile_ws = ws + (long long)tile * splits * kOut;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int o = tid + e * kGvThreads;
      if (o < kOut) tile_ws[(long long)split * kOut + o] = part[e];
    }
    if (!last_to_arrive(counters + tile, splits, &last)) return;
    if (tid < kOut)                              // elements tid + 128 e
      sum_splits<kPer>(tile_ws + tid, kOut, kGvThreads, splits, part);
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int o = tid + e * kGvThreads;
    const int m = o / kGvBlockN, n = tile * kGvBlockN + o % kGvBlockN;
    if (o < kOut && m < M && n < N)              // the codes were +-2
      out[(long long)m * N + n] = (part[e] * 0.5f) * scale[n];
  }
}

// ---------------------------------------------------------------------------
// 2. Prefill: tensor cores (wgmma), out^T = W^T x^T.
//
// The product is computed transposed: the decoded codes are wgmma's A
// operand (64 output columns n x 16 k per instruction), taken from
// registers, and x's tile is B (BMM rows of x x 16 k), read from shared
// memory through a descriptor (128-byte swizzle, the layout `swz` writes).
// A block of 2 warpgroups owns 128 output columns and BMM rows of x.
// Warp wl of a warpgroup owns 16 of its 64 columns: A row g is column
// 2g and row g + 8 is column 2g + 1, so a lane's two columns are
// neighbouring bytes of a packed row (one 2-byte load) and its results
// for a row of x are neighbouring floats (float2 stores).  A lane's k
// slots 2q, 2q+1 (2q+8, 2q+9) are one nibble of packed row q / 2 (+ 2).
// The codes become bf16 by a byte permute from a 4-entry table of high
// bytes: +1 and -1 are encoded as +2 and -2 (0x4000 / 0xC000, whose low
// byte is 0), and the epilogue halves the sum, which is exact.
// x's tiles and the packed rows go through a 4-stage cp.async ring, two
// stages ahead; each K step decodes its codes while the previous step's
// wgmma run (wait_group 1), with A registers double-buffered.  The
// constants, helpers, stage copies and the K loop (`mma_k_loop`) are in
// ternary_mma.cuh, which expert_matmul.cu shares.

template <int BMM>
__global__ void __launch_bounds__(kTcThreads, 2)
    ternary_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const uint8_t* __restrict__ w2,
                       const float* __restrict__ scale,
                       float* __restrict__ out, float* __restrict__ ws,
                       int* __restrict__ counters, int M, int K, int N,
                       int rows_per_split, int vec_x, int vec_w,
                       int vec_out) {
  using S = TcSmem<BMM>;
  constexpr int ND = BMM / 2;                  // accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ int last;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  // warpgroup wg owns columns n0 + 64 wg ..; its warp wl rows 16 wl .. of
  // them, row g at column 2g and row g + 8 at column 2g + 1
  const int wg = warp >> 2, wl = warp & 3;
  const int ncol = 64 * wg + 16 * wl + 2 * g;  // within the block's kBN
  const int n0 = blockIdx.x * S::kBN, m0 = blockIdx.y * BMM;
  const int split = blockIdx.z, splits = gridDim.z;
  const int K4 = K / 4;
  const int r_begin = split * rows_per_split;
  const int r_end = min(K4, r_begin + rows_per_split);

  float d[ND];
  mma_k_loop<BMM>(smem, x, w2, M, K, N, m0, n0, r_begin, r_end, vec_x,
                  vec_w, ncol, q, d);

  // d[4j + e] is column (m) 8j + 2q + (e & 1), row (n) ncol + (e >> 1).
  if (splits > 1) {
    constexpr int kTile = BMM * S::kBN;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* tile_ws = ws + (long long)tile * splits * kTile;
    float* mine = tile_ws + (long long)split * kTile;
#pragma unroll
    for (int j = 0; j < BMM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(mine + (8 * j + 2 * q + e) * S::kBN +
                                   ncol) =
            make_float2(d[4 * j + e], d[4 * j + 2 + e]);
    if (!last_to_arrive(counters + tile, splits, &last)) return;
#pragma unroll
    for (int j = 0; j < BMM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v[2];
        sum_splits<2>(tile_ws + (8 * j + 2 * q + e) * S::kBN + ncol, kTile,
                      1, splits, v);
        d[4 * j + e] = v[0];
        d[4 * j + 2 + e] = v[1];
      }
  }
  const int n = n0 + ncol;
  const float s0 = n < N ? scale[n] : 0.f, s1 = n + 1 < N ? scale[n + 1] : 0.f;
#pragma unroll
  for (int j = 0; j < BMM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * q + e;
      if (m >= M) continue;
      float* o = out + (long long)m * N + n;
      const float v0 = (d[4 * j + e] * 0.5f) * s0;     // codes were +-2
      const float v1 = (d[4 * j + 2 + e] * 0.5f) * s1;
      if (vec_out && n + 1 < N) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        if (n < N) o[0] = v0;
        if (n + 1 < N) o[1] = v1;
      }
    }
}

template <int BMM>
int launch_mma(const void* x, const void* w2, const void* scale, void* out,
               void* ws, void* counters, int M, int K, int N, int splits,
               int rows_per_split, int vec_x, int vec_w, int vec_out,
               cudaStream_t s) {
  using S = TcSmem<BMM>;
  static std::atomic<uint64_t> done{0};
  const cudaError_t attr = allow_smem(
      reinterpret_cast<const void*>(ternary_mma_kernel<BMM>), S::kBytes,
      done);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + S::kBN - 1) / S::kBN, (M + BMM - 1) / BMM, splits);
  ternary_mma_kernel<BMM><<<grid, kTcThreads, S::kBytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w2),
      static_cast<const float*>(scale), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), M, K, N,
      rows_per_split, vec_x, vec_w, vec_out);
  return 0;
}

// ---------------------------------------------------------------------------
// 3. M > 8 on the CUDA cores (float32 x, or unaligned bf16 x).
constexpr int kLanes = 32;
constexpr int kCols = 4;                       // output columns per thread
constexpr int kBlockN = kLanes * kCols;        // 128
constexpr int kWarpsK = 8;                     // warps splitting a K tile
constexpr int kThreads = kLanes * kWarpsK;     // 256
constexpr int kTileRows = 64;                  // packed rows per K tile
constexpr int kTileK = 4 * kTileRows;          // 256 values of k
constexpr int kRowsPerWarp = kTileRows / kWarpsK;
constexpr int kBM = 8;                         // rows of x per block

// Loads tile r0's operands into registers: this thread's packed rows
// (rows past K and columns past N read 0) and its column of the x tile
// (kTileK == kThreads, so column `tid` of each of the kBM rows).
template <typename T>
__device__ __forceinline__ void fetch_tile(
    const T* __restrict__ x, const uint8_t* __restrict__ w2, int r0, int K4,
    int M, int K, int N, int m0, int n0, int warp, int tid, int vec,
    uint32_t (&word)[kRowsPerWarp], float (&xr)[kBM]) {
  const int rows = min(kTileRows, K4 - r0);
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int rr = warp + q * kWarpsK;
    word[q] = 0u;
    if (rr < rows && n0 < N) {
      const uint8_t* p = w2 + (long long)(r0 + rr) * N + n0;
      if (vec) {
        word[q] = __ldg(reinterpret_cast<const uint32_t*>(p));
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (n0 + c < N)
            word[q] |= static_cast<uint32_t>(__ldg(p + c)) << (8 * c);
      }
    }
  }
  const int k = 4 * r0 + tid;
#pragma unroll
  for (int m = 0; m < kBM; ++m)
    xr[m] = (m0 + m < M && k < K) ? to_float(x[(long long)(m0 + m) * K + k])
                                  : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ternary_matmul_kernel(const T* __restrict__ x,
                          const uint8_t* __restrict__ w2,
                          const float* __restrict__ scale,
                          float* __restrict__ out, int M, int K, int N,
                          int vec) {
  static_assert(kTileK == kThreads, "one x column of a tile per thread");
  __shared__ __align__(16) float xs[kBM][kTileK];
  __shared__ __align__(16) float part[kWarpsK][kBM][kBlockN];

  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const int n0 = blockIdx.x * kBlockN + lane * kCols;
  const int m0 = blockIdx.y * kBM;
  const int K4 = K / 4;

  float acc[kBM][kCols];
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  // Software pipeline: tile t + 1's loads are issued before tile t's FMAs.
  uint32_t word_next[kRowsPerWarp];
  float x_next[kBM];
  if (K4 > 0)
    fetch_tile<T>(x, w2, 0, K4, M, K, N, m0, n0, warp, tid, vec, word_next,
                  x_next);
  for (int r0 = 0; r0 < K4; r0 += kTileRows) {
    uint32_t word[kRowsPerWarp];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) word[q] = word_next[q];
#pragma unroll
    for (int m = 0; m < kBM; ++m) xs[m][tid] = x_next[m];
    __syncthreads();
    if (r0 + kTileRows < K4)
      fetch_tile<T>(x, w2, r0 + kTileRows, K4, M, K, N, m0, n0, warp, tid,
                    vec, word_next, x_next);
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int rr = warp + q * kWarpsK;
#pragma unroll
      for (int m = 0; m < kBM; ++m) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[m][4 * rr]);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[m][c] = dot4(word[q] >> (8 * c), xv, acc[m][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kBM; ++m)
    *reinterpret_cast<float4*>(&part[warp][m][lane * kCols]) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  for (int i = tid; i < kBM * kBlockN; i += kThreads) {
    const int m = i / kBlockN, col = i - m * kBlockN;
    const int n = blockIdx.x * kBlockN + col;
    if (m0 + m < M && n < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsK; ++w) s += part[w][m][col];
      out[(long long)(m0 + m) * N + n] = s * scale[n];
    }
  }
}

// ---------------------------------------------------------------------------
template <typename T, int BM>
int launch_splitk(const void* x, const void* w2, const void* scale,
                   void* out, void* ws, void* counters, int M, int K, int N,
                   int splits, int rows_per_split, int vec_x, int vec,
                   cudaStream_t s) {
  constexpr int kBytes = GvSmem<T, BM>::kBytes;
  static std::atomic<uint64_t> done{0};
  const cudaError_t attr = allow_smem(
      reinterpret_cast<const void*>(ternary_splitk_kernel<T, BM>), kBytes,
      done);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + kGvBlockN - 1) / kGvBlockN, 1, splits);
  ternary_splitk_kernel<T, BM><<<grid, kGvThreads, kBytes, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w2),
      static_cast<const float*>(scale), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), M, K, N,
      rows_per_split, vec_x, vec);
  return 0;
}

template <typename T>
int launch_splitk_rows(const void* x, const void* w2, const void* scale,
                       void* out, void* ws, void* counters, int M, int K,
                       int N, int splits, int rows_per_split, int vec_x,
                       int vec, cudaStream_t s) {
  auto go = [&](auto bm) {
    return launch_splitk<T, decltype(bm)::value>(
        x, w2, scale, out, ws, counters, M, K, N, splits, rows_per_split,
        vec_x, vec, s);
  };
  if (M > 4) return go(std::integral_constant<int, 8>());
  if (M > 2) return go(std::integral_constant<int, 4>());
  if (M == 2) return go(std::integral_constant<int, 2>());
  return go(std::integral_constant<int, 1>());
}

template <typename T>
void launch_cuda_core(const void* x, const void* w2, const void* scale,
                      void* out, int M, int K, int N, int vec,
                      cudaStream_t s) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kBM - 1) / kBM);
  const dim3 block(kLanes, kWarpsK);
  ternary_matmul_kernel<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w2),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N,
      vec);
}

}  // namespace

// Plain C entry point, bound with ctypes.  All pointers are device pointers
// to contiguous tensors: x (M, K) bfloat16 when x_bf16 != 0 else float32,
// w2 (K/4, N) int8, scale (1, N) float32, out (M, N) float32; ws and
// counters are the wrapper's workspace (float32) and zeroed int32 counters,
// large enough for the plan.  `args` is a host array of ten ints: M, K, N,
// variant (0 = split-K GEMV, M <= 8; 1 = tensor cores, bf16 x 8-byte
// aligned; 2 = CUDA cores), splits and rows_per_split (packed rows; they
// cover K/4 exactly), tile_m (variant 1: BMM, 64, 96 or 128), vec_x (x
// 16-byte aligned; variant 1 also needs K % 8 == 0), vec_w (N % 16 == 0 and
// w2 16-byte aligned; variant 2: N % 4 == 0 and 4 bytes) and vec_out (N
// even).  The caller keeps every grid dimension inside its limit.  Returns
// cudaGetLastError() after the launch (or the error of setting a kernel's
// shared memory size); the launch is asynchronous on `stream`.
extern "C" int ternary_matmul(const void* x, int x_bf16, const void* w2,
                              const void* scale, void* out, void* ws,
                              void* counters, const int* args, void* stream) {
  const int M = args[0], K = args[1], N = args[2], variant = args[3];
  const int splits = args[4], rows_per_split = args[5], tile_m = args[6];
  const int vec_x = args[7], vec_w = args[8], vec_out = args[9];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (variant == 0) {
    err = x_bf16 ? launch_splitk_rows<__nv_bfloat16>(
                       x, w2, scale, out, ws, counters, M, K, N, splits,
                       rows_per_split, vec_x, vec_w, s)
                 : launch_splitk_rows<float>(x, w2, scale, out, ws, counters,
                                             M, K, N, splits, rows_per_split,
                                             vec_x, vec_w, s);
  } else if (variant == 1) {
    if (!x_bf16) return static_cast<int>(cudaErrorInvalidValue);
    auto go = [&](auto bmm) {
      return launch_mma<decltype(bmm)::value>(
          x, w2, scale, out, ws, counters, M, K, N, splits, rows_per_split,
          vec_x, vec_w, vec_out, s);
    };
    err = tile_m == 128  ? go(std::integral_constant<int, 128>())
          : tile_m == 96 ? go(std::integral_constant<int, 96>())
                         : go(std::integral_constant<int, 64>());
  } else {
    if (x_bf16)
      launch_cuda_core<__nv_bfloat16>(x, w2, scale, out, M, K, N, vec_w, s);
    else
      launch_cuda_core<float>(x, w2, scale, out, M, K, N, vec_w, s);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
