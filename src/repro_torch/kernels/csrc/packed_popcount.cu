// Per-row popcount of bit-packed 32-bit words for Hopper (sm_90a).
//
// Replaces: repro/kernels/packed_popcount.py `_kernel` (pallas_call at :31),
// reached through `packed_popcount` and `ops.packed_popcount`.
//
// Computes out[b] = sum_w popcount(words[b, w]) for words (B, W) 32-bit
// (int32 bit patterns of the reference's uint32 words), out (B,) int32.
// The Pallas kernel counts each word with SWAR shifts and masks on the VPU
// and needs B % 256 == 0; here one __popc instruction counts a word and any
// B and W (W = 0 included) are taken.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s): the bytes, 4 per word
// read and 4 per row written; the count is one instruction a word.  At
// (65536, 9) that is 2.6 MB -> ~0.8 us, under the launch itself; at
// (4194304, 9), 168 MB -> ~50 us.
//
// Design: no lane idles on a short row.
//   * `rows` (W <= 64): a block of 128 threads owns a contiguous run of
//     128 rows and reads it as one flat stream, 16-byte loads (four in
//     flight a thread) when the plane starts on a 16-byte boundary, else
//     word by word (a contiguous view at a 4-byte offset must not take the
//     vector loads).  The words are written transposed into shared memory,
//     column c of local row r at c * 129 + r, and thread r then counts row
//     r: at each column the 32 lanes of a warp read 32 consecutive words,
//     so the counting reads have no bank conflicts.
//   * `warp` (W > 64): a warp owns a row and reads it with 16-byte loads
//     between scalar head and tail words (rows start wherever W puts
//     them), then adds its lanes' counts with one `__reduce_add_sync`.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;           // rows (and threads) of a `rows` block
constexpr int kStride = kRows + 1;   // shared column stride, 1 mod 32 banks
constexpr int kInFlight = 4;         // 16-byte loads a thread issues at once
constexpr int kWarpThreads = 256;    // a `warp` block: 8 rows

template <bool VEC>
__global__ void __launch_bounds__(kRows)
    popcount_rows_kernel(const uint32_t* __restrict__ words,
                         int* __restrict__ out, long long B, int W) {
  extern __shared__ uint32_t plane[];  // [W][kStride]
  const long long r_lo = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, B - r_lo);
  const int n = rows * W;              // the run's words, row-major
  const uint32_t* run = words + r_lo * W;
  int done = 0;
  if (VEC) {  // r_lo * W is a multiple of 4: the run starts aligned too
    const int nvec = n / 4;
    const uint4* vrun = reinterpret_cast<const uint4*>(run);
    for (int v0 = threadIdx.x; v0 < nvec; v0 += kRows * kInFlight) {
      uint4 q[kInFlight];
#pragma unroll
      for (int s = 0; s < kInFlight; ++s)
        if (v0 + s * kRows < nvec) q[s] = __ldg(vrun + v0 + s * kRows);
#pragma unroll
      for (int s = 0; s < kInFlight; ++s) {
        if (v0 + s * kRows >= nvec) break;
        const int f = 4 * (v0 + s * kRows);
        int r = f / W, c = f - r * W;
        const uint32_t x[4] = {q[s].x, q[s].y, q[s].z, q[s].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          plane[c * kStride + r] = x[e];
          if (++c == W) {
            c = 0;
            ++r;
          }
        }
      }
    }
    done = 4 * nvec;
  }
  for (int f = done + threadIdx.x; f < n; f += kRows) {
    const int r = f / W;
    plane[(f - r * W) * kStride + r] = __ldg(run + f);
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    int count = 0;
    for (int c = 0; c < W; ++c)
      count += __popc(plane[c * kStride + threadIdx.x]);
    out[r_lo + threadIdx.x] = count;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kWarpThreads)
    popcount_warp_kernel(const uint32_t* __restrict__ words,
                         int* __restrict__ out, long long B, int W) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (kWarpThreads / 32) + threadIdx.x / 32;
  if (row >= B) return;  // the whole warp leaves together
  const long long f0 = row * W;
  const uint32_t* p = words + f0;
  // words before the row's first 16-byte boundary (all of them unaligned)
  const int head = VEC ? min(W, (int)((4 - (f0 & 3)) & 3)) : W;
  const int nvec = (W - head) / 4;
  int count = 0;
  for (int f = lane; f < head; f += 32) count += __popc(__ldg(p + f));
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
#pragma unroll 4
  for (int i = lane; i < nvec; i += 32) {
    const uint4 q = __ldg(v + i);
    count += __popc(q.x) + __popc(q.y) + __popc(q.z) + __popc(q.w);
  }
  for (int f = head + 4 * nvec + lane; f < W; f += 32)
    count += __popc(__ldg(p + f));
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) out[row] = count;
}

}  // namespace

// Plain C entry point, bound with ctypes.  `words` and `out` are device
// pointers to contiguous tensors, (B, W) 32-bit words and (B,) int32.
// `design` 0 runs `rows` (W <= 64), 1 runs `warp`; `vec16` says `words`
// starts on a 16-byte boundary (the caller checks both).  The caller
// guarantees B >= 1 and W >= 0.  Returns cudaErrorInvalidValue for `rows`
// at W > 64, else cudaGetLastError() after the launch, which is
// asynchronous on `stream`.
extern "C" int packed_popcount(const void* words, void* out, long long B,
                               int W, int design, int vec16, void* stream) {
  const auto* wp = static_cast<const uint32_t*>(words);
  auto* op = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    if (W > 64) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = (unsigned)((B + kRows - 1) / kRows);
    const size_t smem = (size_t)W * kStride * sizeof(uint32_t);
    if (vec16)
      popcount_rows_kernel<true><<<blocks, kRows, smem, s>>>(wp, op, B, W);
    else
      popcount_rows_kernel<false><<<blocks, kRows, smem, s>>>(wp, op, B, W);
  } else {
    const int per = kWarpThreads / 32;
    const unsigned blocks = (unsigned)((B + per - 1) / per);
    if (vec16)
      popcount_warp_kernel<true><<<blocks, kWarpThreads, 0, s>>>(wp, op, B, W);
    else
      popcount_warp_kernel<false><<<blocks, kWarpThreads, 0, s>>>(wp, op, B,
                                                                   W);
  }
  return static_cast<int>(cudaGetLastError());
}
