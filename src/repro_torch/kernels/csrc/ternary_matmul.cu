// 2-bit packed ternary matmul for Hopper (sm_90a).
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
// The sum is accumulated in float32; the codes are unpacked in registers and
// never written to device memory as a dense matrix.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 on the
// tensor cores, 67 TFLOP/s float32 on the CUDA cores):
//   * decode (M <= 8): the packed weight bytes.  llama3.2-1b's w_gate is
//     2048 x 8192 codes = 4.2 MB -> ~1.3 us at 3.35 TB/s.  The kernel is
//     latency-bound well above that: at N = 512 or 2048 the grid has only
//     4 or 16 column blocks for 132 SMs (no split of K across blocks).
//   * prefill (M = 768): the 2*M*K*N operations, 25.8 GFLOP for w_gate ->
//     ~26 us at the bf16 tensor-core rate.  This kernel runs on the CUDA
//     cores (float32 FMAs), whose peak alone puts the same work at ~0.39 ms;
//     the gap to the tensor-core bound is recorded, not hidden.  Tensor
//     cores (mma.sync / wgmma on codes unpacked to bf16 in shared memory)
//     are the next step.
//
// Design: a block owns 128 output columns and up to BM (1, 2, 4 or 8) rows
// of x.  Its 32 lanes own 4 neighbouring columns each, so one packed row of
// the block is one coalesced 128-byte load, a 4-byte word per lane holding
// 4 columns x 4 values of k.  Its 8 warps split the packed rows of each
// 256-wide K tile; the tile of x is staged in shared memory as float32 and
// read as a broadcast float4.  The next tile's weight words and x values
// are loaded into registers while the current tile is summed, so each tile
// waits for memory once, not once per load.  Each thread keeps BM x 4 float32 sums in
// registers; at the end the 8 warps' partial sums are added in a fixed order
// through shared memory, so the result does not depend on scheduling.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kCols = 4;                       // output columns per thread
constexpr int kBlockN = kLanes * kCols;        // 128
constexpr int kWarpsK = 8;                     // warps splitting a K tile
constexpr int kThreads = kLanes * kWarpsK;     // 256
constexpr int kTileRows = 64;                  // packed rows per K tile
constexpr int kTileK = 4 * kTileRows;          // 256 values of k
constexpr int kRowsPerWarp = kTileRows / kWarpsK;

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

// Loads tile r0's operands into registers: this thread's packed rows
// (rows past K and columns past N read 0) and its column of the x tile
// (kTileK == kThreads, so column `tid` of each of the BM rows).  All loads
// are independent, so they are in flight together.
template <typename T, int BM>
__device__ __forceinline__ void fetch_tile(
    const T* __restrict__ x, const uint8_t* __restrict__ w2, int r0, int K4,
    int M, int K, int N, int m0, int n0, int warp, int tid, int vec,
    uint32_t (&word)[kRowsPerWarp], float (&xr)[BM]) {
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
  for (int m = 0; m < BM; ++m)
    xr[m] = (m0 + m < M && k < K) ? to_float(x[(long long)(m0 + m) * K + k])
                                  : 0.f;
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    ternary_matmul_kernel(const T* __restrict__ x,
                          const uint8_t* __restrict__ w2,
                          const float* __restrict__ scale,
                          float* __restrict__ out, int M, int K, int N,
                          int vec) {
  static_assert(kTileK == kThreads, "one x column of a tile per thread");
  __shared__ __align__(16) float xs[BM][kTileK];
  __shared__ __align__(16) float part[kWarpsK][BM][kBlockN];

  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const int n0 = blockIdx.x * kBlockN + lane * kCols;
  const int m0 = blockIdx.y * BM;
  const int K4 = K / 4;

  float acc[BM][kCols];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  // Software pipeline: tile t + 1's loads are issued before tile t's FMAs.
  uint32_t word_next[kRowsPerWarp];
  float x_next[BM];
  if (K4 > 0)
    fetch_tile<T, BM>(x, w2, 0, K4, M, K, N, m0, n0, warp, tid, vec,
                      word_next, x_next);
  for (int r0 = 0; r0 < K4; r0 += kTileRows) {
    uint32_t word[kRowsPerWarp];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) word[q] = word_next[q];
#pragma unroll
    for (int m = 0; m < BM; ++m) xs[m][tid] = x_next[m];
    __syncthreads();
    if (r0 + kTileRows < K4)
      fetch_tile<T, BM>(x, w2, r0 + kTileRows, K4, M, K, N, m0, n0, warp,
                        tid, vec, word_next, x_next);
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int rr = warp + q * kWarpsK;
      float4 xv[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m)
        xv[m] = *reinterpret_cast<const float4*>(&xs[m][4 * rr]);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const uint32_t b = word[q] >> (8 * c);
        const float w0 = ternary(b), w1 = ternary(b >> 2),
                    w2v = ternary(b >> 4), w3 = ternary(b >> 6);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          float a = acc[m][c];
          a = fmaf(w0, xv[m].x, a);
          a = fmaf(w1, xv[m].y, a);
          a = fmaf(w2v, xv[m].z, a);
          a = fmaf(w3, xv[m].w, a);
          acc[m][c] = a;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < BM; ++m)
    *reinterpret_cast<float4*>(&part[warp][m][lane * kCols]) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  for (int i = tid; i < BM * kBlockN; i += kThreads) {
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

template <typename T, int BM>
void launch(const void* x, const void* w2, const void* scale, void* out,
            int M, int K, int N, int vec, cudaStream_t s) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + BM - 1) / BM);
  const dim3 block(kLanes, kWarpsK);
  ternary_matmul_kernel<T, BM><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w2),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N,
      vec);
}

template <typename T>
void launch_rows(const void* x, const void* w2, const void* scale, void* out,
                 int M, int K, int N, int vec, cudaStream_t s) {
  if (M >= 5)
    launch<T, 8>(x, w2, scale, out, M, K, N, vec, s);
  else if (M >= 3)
    launch<T, 4>(x, w2, scale, out, M, K, N, vec, s);
  else if (M == 2)
    launch<T, 2>(x, w2, scale, out, M, K, N, vec, s);
  else
    launch<T, 1>(x, w2, scale, out, M, K, N, vec, s);
}

}  // namespace

// Plain C entry point, bound with ctypes.  All pointers are device pointers
// to contiguous tensors: x (M, K) bfloat16 when x_bf16 != 0 else float32,
// w2 (K/4, N) int8, scale (1, N) float32, out (M, N) float32.  The caller
// guarantees M >= 1, N >= 1, K % 4 == 0, ceil(M / 8) <= 65535, and vec != 0
// only when N % 4 == 0 and w2 is 4-byte aligned.  Returns cudaGetLastError()
// after the launch; the launch is asynchronous on `stream`.
extern "C" int ternary_matmul(const void* x, int x_bf16, const void* w2,
                              const void* scale, void* out, int M, int K,
                              int N, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    launch_rows<__nv_bfloat16>(x, w2, scale, out, M, K, N, vec, s);
  else
    launch_rows<float>(x, w2, scale, out, M, K, N, vec, s);
  return static_cast<int>(cudaGetLastError());
}
