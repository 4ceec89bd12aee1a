// Per-row popcount of bit-packed 32-bit words for Hopper (sm_90a).
//
// Replaces: repro/kernels/packed_popcount.py `_kernel` (pallas_call at :31),
// reached through `packed_popcount` and `ops.packed_popcount`.
//
// Computes out[b] = sum_w popcount(words[b, w]) for words (B, W) 32-bit
// (int32 bit patterns of the reference's uint32 words), out (B,) int32.
// The Pallas kernel counts each word with SWAR shifts and masks on the VPU
// and needs B % 256 == 0; here one __popc instruction counts a word and any
// B and W are taken.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s): the bytes, 4 per word
// read and 4 per row written; the count is one instruction a word.  At
// (65536, 32) that is 8.6 MB -> ~2.6 us.
//
// Design: a group of L lanes (L = 1, 2, ..., 32, the least power of two
// >= W, at most a warp) owns one row.  Lane l counts words l, l + L, ...,
// so neighbouring lanes read neighbouring words, and the group adds its
// counts with warp shuffles in a fixed order.  A block of 256 threads
// holds 256 / L rows; lanes of a row past B count nothing.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    packed_popcount_kernel(const uint32_t* __restrict__ words,
                           int* __restrict__ out, int B, int W, int lanes) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int b = tid / lanes, l = tid % lanes;
  int count = 0;
  if (b < B) {
    const uint32_t* row = words + (long long)b * W;
    for (int i = l; i < W; i += lanes) count += __popc(__ldg(row + i));
  }
  // every lane of the warp takes part, so the full mask is right
  for (int off = lanes / 2; off > 0; off /= 2)
    count += __shfl_down_sync(0xffffffffu, count, off, lanes);
  if (b < B && l == 0) out[b] = count;
}

}  // namespace

// Plain C entry point, bound with ctypes.  `words` and `out` are device
// pointers to contiguous tensors, (B, W) 32-bit words and (B,) int32.  The
// caller guarantees B >= 1, W >= 0 and B * lanes < 2^31.  Returns
// cudaGetLastError() after the launch, which is asynchronous on `stream`.
extern "C" int packed_popcount(const void* words, void* out, int B, int W,
                               void* stream) {
  int lanes = 1;
  while (lanes < W && lanes < 32) lanes *= 2;
  const long long threads = (long long)B * lanes;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  packed_popcount_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int*>(out), B, W,
      lanes);
  return static_cast<int>(cudaGetLastError());
}
