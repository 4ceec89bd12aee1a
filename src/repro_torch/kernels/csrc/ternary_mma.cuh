// The tensor-core K loop of the 2-bit ternary products for Hopper (sm_90a),
// shared by ternary_matmul.cu (`ternary_mma_kernel`, its section 2, whose
// comment sets out the design) and expert_matmul.cu (`expert_mma_kernel`,
// the same loop over each expert's rows): the cp.async and wgmma helpers,
// the stage layout, a stage's copies and the loop itself.  Each .cu file
// is its own translation unit and includes this once; everything here is
// inlined into its kernels.
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Lets `kernel` use `bytes` of dynamic shared memory.  The driver call is
// made once per device, not on every launch; `done` remembers the devices.
cudaError_t allow_smem(const void* kernel, int bytes,
                       std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

constexpr int kTcBK = 64;                      // values of k per stage
constexpr int kTcBKR = kTcBK / 4;              // packed rows per stage
constexpr int kStages = 4;
constexpr int kTcWarpgroups = 2;
constexpr int kTcThreads = 128 * kTcWarpgroups;

// Byte offset of byte `b` of row `row` in a tile of 128-byte rows whose
// 16-byte chunks are XOR-swizzled by (row & 7): the 128-byte swizzle of a
// 1024-byte aligned tile, and 8 consecutive rows at one chunk fall in 8
// different bank groups.
__device__ __forceinline__ int swz(int row, int b) {
  return row * 128 + ((((b >> 4) ^ (row & 7))) << 4) + (b & 15);
}

template <int BMM>
struct TcSmem {
  static constexpr int kBN = 64 * kTcWarpgroups;       // output columns
  static constexpr int kWStride = kBN + 64;            // packed row, padded
  static constexpr int kX = BMM * kTcBK * 2;           // bytes of an x tile
  static constexpr int kW = kTcBKR * kWStride;         // packed bytes
  static constexpr int kOffW = kStages * kX;
  static constexpr int kBytes = kOffW + kStages * kW + 1024;  // + alignment
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a K-major bf16 tile of 128-byte rows, 128-byte swizzle,
// 1024-byte aligned: 8-row groups 1024 bytes apart.  (The leading byte
// offset, 1, is not used by a swizzled K-major layout.)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_m64n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47 "
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int BMM>
__device__ __forceinline__ void wgmma_step(float (&d)[BMM / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  if constexpr (BMM == 64) wgmma_m64n64(d, a, desc, scale_d);
  else if constexpr (BMM == 96) wgmma_m64n96(d, a, desc, scale_d);
  else wgmma_m64n128(d, a, desc, scale_d);
}

// bf16x2 of the two codes in bits 0-3 of v, each +2, -2 or 0.
__device__ __forceinline__ uint32_t decode_nibble(uint32_t v) {
  return __byte_perm(0x00C04000u, 0u,
                     ((v << 4) & 0x30u) | ((v << 10) & 0x3000u));
}

// Issues stage `st`'s copies: BMM rows of x from m0 (k from 4 r) and 16
// packed rows from r of the block's columns, zero-filled past M, past
// `r_end` and past N.  With `vec_x` 0 (K % 8 == 4) x goes in 8-byte
// copies; with `vec_w` 0 (N % 16 or an unaligned w2) the packed bytes are
// stored directly, which the consuming step's barrier makes visible.
template <int BMM>
__device__ __forceinline__ void load_stage(
    uint8_t* smem, int st, const __nv_bfloat16* __restrict__ x,
    const uint8_t* __restrict__ w2, int M, int K, int N, int m0, int n0,
    int r, int r_end, int vec_x, int vec_w) {
  using S = TcSmem<BMM>;
  const int tid = threadIdx.x;
  uint8_t* x_tile = smem + st * S::kX;
  const int k0 = 4 * r, k_end = 4 * r_end;
#pragma unroll
  for (int i = tid; i < BMM * 8; i += kTcThreads) {
    const int row = i >> 3, chunk = i & 7, m = m0 + row;
    const int k = k0 + chunk * 8;
    const uint32_t dst = smem_u32(x_tile + swz(row, chunk * 16));
    const __nv_bfloat16* src = x + (long long)m * K + k;
    if (vec_x) {
      const bool in = m < M && k < k_end;
      cp_async16(dst, in ? src : x, in ? 16 : 0);
    } else {
      const bool in0 = m < M && k < k_end, in1 = m < M && k + 4 < k_end;
      cp_async8(dst, in0 ? src : x, in0 ? 8 : 0);
      cp_async8(dst + 8, in1 ? src + 4 : x, in1 ? 8 : 0);
    }
  }
  if (tid < kTcBKR * (S::kBN / 16)) {
    uint8_t* w_tile = smem + S::kOffW + st * S::kW;
    const int row = tid / (S::kBN / 16), col = (tid % (S::kBN / 16)) * 16;
    const int rr = r + row, n = n0 + col;
    const uint8_t* src = w2 + (long long)rr * N + n;
    if (vec_w) {
      const bool in = rr < r_end && n < N;
      cp_async16(smem_u32(w_tile + row * S::kWStride + col), in ? src : w2,
                 in ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (rr < r_end)
        for (int b = 0; b < 16; ++b)
          if (n + b < N)
            w[b >> 2] |= static_cast<uint32_t>(__ldg(src + b)) << (8 * (b & 3));
      *reinterpret_cast<uint4*>(w_tile + row * S::kWStride + col) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// A block's K loop: d (a thread's BMM / 2 accumulators; d[4j + e] is row
// (m) m0 + 8j + 2q + (e & 1) of x, output column (n) n0 + ncol + (e >> 1))
// = x's rows times the codes of packed rows [r_begin, r_end), each code
// +-2 or 0, so d holds twice the product.  Rows of x at and past M, and
// columns at and past N, read 0.
template <int BMM>
__device__ __forceinline__ void mma_k_loop(
    uint8_t* smem, const __nv_bfloat16* __restrict__ x,
    const uint8_t* __restrict__ w2, int M, int K, int N, int m0, int n0,
    int r_begin, int r_end, int vec_x, int vec_w, int ncol, int q,
    float (&d)[BMM / 2]) {
  using S = TcSmem<BMM>;
  const int iters = (max(0, r_end - r_begin) + kTcBKR - 1) / kTcBKR;

#pragma unroll
  for (int e = 0; e < BMM / 2; ++e) d[e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < iters)
      load_stage<BMM>(smem, s, x, w2, M, K, N, m0, n0, r_begin + s * kTcBKR,
                      r_end, vec_x, vec_w);
    cp_async_commit();
  }

  // One K step: wait for its stage, decode its codes into A registers, and
  // issue its four wgmma; the previous step's wgmma stays in flight.  Its
  // A registers and its stage are not touched again until the next
  // step's wait_group 1 has retired it.
  auto step = [&](int it, uint32_t (&a)[4][4]) {
    cp_async_wait<kStages - 3>();
    fence_proxy_async();
    __syncthreads();
    const int nxt = it + kStages - 2;
    if (nxt < iters)
      load_stage<BMM>(smem, nxt % kStages, x, w2, M, K, N, m0, n0,
                      r_begin + nxt * kTcBKR, r_end, vec_x, vec_w);
    cp_async_commit();
    const uint8_t* w_tile = smem + S::kOffW + (it % kStages) * S::kW;
    const int sh = 4 * (q & 1);
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks) {
      // k 2q, 2q+1 -> packed row 4 ks + q/2, nibble q % 2; k + 8 -> row + 2
      const uint32_t lo = *reinterpret_cast<const uint16_t*>(
          w_tile + (4 * ks + (q >> 1)) * S::kWStride + ncol);
      const uint32_t hi = *reinterpret_cast<const uint16_t*>(
          w_tile + (4 * ks + 2 + (q >> 1)) * S::kWStride + ncol);
      a[ks][0] = decode_nibble(lo >> sh);
      a[ks][1] = decode_nibble(lo >> (8 + sh));
      a[ks][2] = decode_nibble(hi >> sh);
      a[ks][3] = decode_nibble(hi >> (8 + sh));
    }
    const uint32_t x_addr = smem_u32(smem + (it % kStages) * S::kX);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks)
      wgmma_step<BMM>(d, a[ks], wgmma_desc(x_addr + 32 * ks),
                      it > 0 || ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
  };
  uint32_t a0[4][4], a1[4][4];
  int it = 0;
  for (; it + 1 < iters; it += 2) {
    step(it, a0);
    step(it + 1, a1);
  }
  if (it < iters) step(it, a0);
  wgmma_wait<0>();
  cp_async_wait<0>();
}

}  // namespace
