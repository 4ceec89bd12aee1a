// Grouped 2-bit ternary expert GEMM for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference's MoE (repro/models/moe.py)
// multiplies dense experts over capacity slots with einsums.  This serves
// the port's dropless MoE (models/moe.py `dropless_ffn`, through
// `ops.expert_matmul`), whose experts are 2-bit ternary codes.
//
// Computes, for every expert e and every row m in [off[e], off[e + 1]),
//   out[m, n] = scale[e, n] * sum_k x[m, k] * code_e(k, n),
// with
//   x     (M, K) bfloat16, row-major, its rows grouped by expert;
//   w2    (E, K/4, N) bytes: expert e's codes packed as in
//         ternary_matmul.cu (byte (r, n) holds k = 4r..4r+3 in bits 0-1,
//         2-3, 4-5, 6-7; 01 -> +1, 10 -> -1, 00 and 11 -> 0);
//   scale (E, 1, N) float32, applied once after the sum;
//   off   (E + 1) int32 on the device, off[0] = 0, off[E] = M;
//   out   (M, N) float32.
// The counts are never read on the host: the grid is sized from M and E
// alone and each block finds its work in `off`.
//
// Bound on this card (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s): the 2*M*K*N
// operations.  At the served shapes (K 2,304 / N 896 and K 896 / N 2,304,
// ~4,096 rows an expert) the product is far above the ridge; only an
// expert with a few rows is bound by its codes' bytes.
//
// Design: ternary_matmul.cu's tensor-core design (its section 2) on each
// (expert, 128-row tile): the product transposed, the codes decoded in
// registers to bf16 +-2 / 0 as wgmma's A operand (64 output columns x 16
// k), x's tile from shared memory as B (128 rows x 16 k, 128-byte
// swizzle), a 4-stage cp.async ring two stages ahead, each K step decoding
// while the previous step's wgmma run, the sum halved in the epilogue
// (exact).  A block of 2 warpgroups owns 128 output columns and 128 rows
// of one expert; no K split.  The tile scheduler: grid.y is ceil(M / 128)
// + E, an upper bound of the sum over experts of ceil(rows / 128); block y
// is the y-th (expert, tile) pair in expert order, which its first warp
// finds by a scan of the tile counts over its lanes (each lane two experts
// at E = 64) and a ballot; blocks past the last pair exit at once.  The
// K loop is ternary_mma_kernel's (`mma_k_loop`, ternary_mma.cuh) at 128
// rows, over the expert's rows and codes.
#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ternary_mma.cuh"

namespace {

constexpr int kBM = 128;                       // rows of x a block
using S = TcSmem<kBM>;                         // 128 output columns a block

__global__ void __launch_bounds__(kTcThreads, 2)
    expert_mma_kernel(const __nv_bfloat16* __restrict__ x,
                      const uint8_t* __restrict__ w2,
                      const float* __restrict__ scale,
                      const int* __restrict__ offsets,
                      float* __restrict__ out, int E, int K, int N,
                      int vec_w, int vec_out) {
  constexpr int ND = kBM / 2;                  // accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ int sched[3];                     // expert, first row, end row
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // This block's (expert, tile): lane l counts the 128-row tiles of
  // experts l * per .. l * per + per - 1; an inclusive scan over the lanes
  // gives each lane's range of tile indices, and the lane whose range
  // holds blockIdx.y walks its experts to the tile.
  if (warp == 0) {
    const int per = (E + 31) / 32;
    int mine = 0;
    for (int i = 0; i < per; ++i) {
      const int ex = lane * per + i;
      if (ex < E) mine += (offsets[ex + 1] - offsets[ex] + kBM - 1) / kBM;
    }
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const int t = static_cast<int>(blockIdx.y), first = incl - mine;
    const unsigned hit = __ballot_sync(0xffffffffu, t >= first && t < incl);
    if (hit == 0u) {
      if (lane == 0) sched[0] = -1;
    } else if (lane == __ffs(hit) - 1) {
      int left = t - first;
      for (int i = 0; i < per; ++i) {
        const int ex = lane * per + i;
        if (ex >= E) break;
        const int lo = offsets[ex], hi = offsets[ex + 1];
        const int tiles = (hi - lo + kBM - 1) / kBM;
        if (left < tiles) {
          sched[0] = ex;
          sched[1] = lo + left * kBM;
          sched[2] = hi;
          break;
        }
        left -= tiles;
      }
    }
  }
  __syncthreads();
  const int ex = sched[0];
  if (ex < 0) return;
  const int row0 = sched[1], row_end = sched[2];
  const int K4 = K / 4;
  const uint8_t* w2e = w2 + (long long)ex * K4 * N;

  const int g = lane >> 2, q = lane & 3;
  // warpgroup wg owns columns n0 + 64 wg ..; its warp wl rows 16 wl .. of
  // them, row g at column 2g and row g + 8 at column 2g + 1
  const int wg = warp >> 2, wl = warp & 3;
  const int ncol = 64 * wg + 16 * wl + 2 * g;  // within the block's kBN
  const int n0 = blockIdx.x * S::kBN;

  float d[ND];
  mma_k_loop<kBM>(smem, x, w2e, row_end, K, N, row0, n0, 0, K4, 1, vec_w,
                  ncol, q, d);

  // d[4j + e] is column (m) 8j + 2q + (e & 1), row (n) ncol + (e >> 1).
  const float* sc = scale + (long long)ex * N;
  const int n = n0 + ncol;
  const float s0 = n < N ? sc[n] : 0.f, s1 = n + 1 < N ? sc[n + 1] : 0.f;
#pragma unroll
  for (int j = 0; j < kBM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = row0 + 8 * j + 2 * q + e;
      if (m >= row_end) continue;
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

}  // namespace

// Plain C entry point, bound with ctypes.  All pointers are device pointers
// to contiguous tensors: x (M, K) bfloat16 (16-byte aligned, K % 8 == 0),
// w2 (E, K/4, N) int8, scale (E, 1, N) float32, offsets (E + 1) int32
// (non-decreasing, 0 to M), out (M, N) float32.  `args` is a host array of
// seven ints: M, K, N, E, tiles (the grid's y: ceil(M / 128) + E, inside
// its limit), vec_w (N % 16 == 0 and w2 16-byte aligned) and vec_out (N
// even).  Returns cudaGetLastError() after the launch (or the error of
// setting the kernel's shared memory size); the launch is asynchronous on
// `stream`.
extern "C" int expert_matmul(const void* x, const void* w2, const void* scale,
                             const void* offsets, void* out, const int* args,
                             void* stream) {
  const int M = args[0], K = args[1], N = args[2], E = args[3];
  const int tiles = args[4], vec_w = args[5], vec_out = args[6];
  if (M == 0 || N == 0) return 0;
  static std::atomic<uint64_t> done{0};
  const cudaError_t attr = allow_smem(
      reinterpret_cast<const void*>(expert_mma_kernel), S::kBytes, done);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + S::kBN - 1) / S::kBN, tiles);
  expert_mma_kernel<<<grid, kTcThreads, S::kBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w2),
      static_cast<const float*>(scale), static_cast<const int*>(offsets),
      static_cast<float*>(out), E, K, N, vec_w, vec_out);
  return static_cast<int>(cudaGetLastError());
}
