// Fused attention forward for prefill on Hopper (sm_90a).
//
// Replaces: no Pallas kernel.  The reference (repro/models/attention.py
// `blockwise_attention`) leaves attention to XLA einsums, and the port's
// plain version (models/attention.py `blockwise_attention_plain`) keeps f32
// scores (B, K, G, Sq, block_k) in device memory for every key block,
// including the blocks the causal mask zeroes and the pad of the last block,
// then passes over them for the mask, the max, exp, the sum and the
// correction.  This kernel computes the same function in one launch, only on
// the key tiles the mask leaves visible, with the scores kept in registers.
//
// Computes, for q (B, Sq, H, dh), k and v (B, Sk, K, dh), all bf16, H = K G,
//   out[b, i, h] = sum_j p_ij v[b, j, h / G] / max(sum_j p_ij, 1e-30),
//   p_ij = exp(s_ij - m_i),  s_ij = <q[b, i, h], k[b, j, h / G]> / sqrt(dh),
// m_i the running max, over the keys j visible to row i: j < Sk, j <=
// q_offset + i if causal, q_offset + i - j < window if a window is given.
// out is bf16 (B, Sq, H, dh), contiguous.  Every row must see a key: the
// wrapper (`cuda_attention.plan`) routes other calls to the plain version,
// which averages every key there.
//
// Arithmetic, the plain version's at f32 precision:
// * Q K^T is bf16 wgmma with f32 accumulation on the unscaled bf16 q and k,
//   so every product is exact and only the f32 sums round.  The scale,
//   times log2 e, multiplies the f32 scores, and the softmax takes exp2.
// * Online softmax in f32 registers: running max, running sum, correction.
//   Masked scores are -inf; a row that has seen no visible key subtracts 0,
//   so it adds nothing.
// * P V keeps P at f32: each p is split in f32 into three bf16 terms, hi =
//   bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid) (each residual
//   exact by Sterbenz), whose sum is p to its 24 bits; three wgmma add hi V,
//   mid V and lo V into one f32 accumulator: exact products, f32 sums.
// * The output is divided by the running sum in f32, clamped below at
//   1e-30, and rounded once to bf16.
//
// What bounds it on this card (H100 SXM: 989 TFLOP/s bf16 on the tensor
// cores, 3.35 TB/s): at prefill shapes the operations, 4 dh flops per
// visible (row, key) pair (2 of Q K^T, 2 of P V): qwen2.5-14b's 40 heads of
// 128 over a 2,048-token causal prompt are 43 GFLOP a layer and batch row,
// 43 us at the bf16 rate, against 50 MB of q, k, v and out, 15 us.  The
// split P makes the tensor cores run the P V product three times, 2x the
// bound's operations in all.  Measured (PERF.md, kernel table row 7), the
// kernel takes about 6x the bound at qwen's groups, and the tensor cores are
// not what paces it: a build without the P V products is 5 % faster, one
// without the softmax 17 %, one without the copies 12 %.  Each tile's chain
// of copy, barrier, scores and softmax, at two warps a scheduler, sets the
// pace.
//
// Design:
// * A CTA of two warpgroups owns 128 query rows of one (batch row, KV head).
//   The G query heads that share the KV head are stacked into the rows (row r
//   is position p0 + r / G, head h0 + r % G; 128 / G positions a CTA), so a
//   K / V tile is read once for all G heads: GQA stays native, as in the
//   plain version.  Each warpgroup owns 64 rows, its scores a 64 x 64 tile in
//   registers (the wgmma accumulator, whose layout is the A-operand layout of
//   the P V product, so P never leaves registers).
// * The CTA walks 64-key tiles from the first key any of its rows sees to the
//   last.  A warpgroup skips a tile that is masked for all its rows, and a
//   tile visible to all its rows skips the mask.  There is no padding to a
//   block: the result does not depend on the plain version's `block_k`,
//   whose pads it masks.
// * Q is copied into shared memory once; K and V tiles go through a 4-stage
//   cp.async ring, two tiles ahead.  All three are stored in rows of 128
//   bytes (64 values of dh) under the 128-byte swizzle: Q and K are K-major
//   wgmma operands, V (keys x dh) the MN-major B operand of P V.
// * A warpgroup issues a tile's P V behind the next tile's Q K^T and waits
//   only for the scores, so the P V runs on the tensor cores while the next
//   softmax runs on the CUDA cores (the stage of V stays until then, hence
//   the fourth stage).  The walk is peeled (before, first, rest, after this
//   warpgroup's tiles) so that no wgmma wait depends on a branch: ptxas
//   serialises the wgmma of a loop whose waits do.
// * The grid takes the query tiles in reverse, so the longest causal rows
//   start first.
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBN = 64;                        // keys a tile
constexpr int kWgRows = 64;                    // query rows a warpgroup
constexpr int kWarpgroups = 2;
constexpr int kRows = kWgRows * kWarpgroups;   // query rows a CTA
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kStages = 4;
constexpr int kAhead = 2;                      // tiles copied ahead

template <int DH>
struct Smem {
  static constexpr int kHalves = DH / 64;      // 128-byte blocks of a row
  static constexpr int kQHalf = kRows * 128;
  static constexpr int kKVHalf = kBN * 128;
  static constexpr int kQ = kHalves * kQHalf;
  static constexpr int kTile = kHalves * kKVHalf;  // K or V of one tile
  static constexpr int kStage = 2 * kTile;         // K, then V
  static constexpr int kBytes = kQ + kStages * kStage + 1024;  // + alignment
};

// One launch's operands and shape.  Strides are in elements: batch row,
// position, head.
struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  long long qs[3], ks[3], vs[3];
  int sq, sk, h, g, positions, causal, window, q_offset;
  float scale_log2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Byte offset of byte `b` of row `row` in a tile of 128-byte rows whose
// 16-byte chunks are XOR-swizzled by (row & 7): the 128-byte swizzle of a
// 1024-byte aligned tile.
__device__ __forceinline__ int swz(int row, int b) {
  return row * 128 + ((((b >> 4) ^ (row & 7))) << 4) + (b & 15);
}

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
// A barrier of the whole CTA that warps may reach from different places in
// the code (the non-aligned form; __syncthreads needs one place).
__device__ __forceinline__ void cta_barrier() {
  asm volatile("barrier.sync 0;\n" ::: "memory");
}
// Makes this thread's cp.async writes to shared memory visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a 128-byte-swizzled bf16 operand, 1024-byte aligned: `lbo`
// and `sbo` in bytes.  K-major (Q, K): 8-row groups 1024 bytes apart (sbo),
// lbo unused.  MN-major (V): 8-key groups 1024 bytes apart along the
// product's K (sbo), 64-value blocks of dh `lbo` apart along its N.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Score step: S (64 x 64) = Q (64 x 16, shared memory) K^T (16 x 64).
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32],
                                                uint64_t a_desc,
                                                uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b_desc, int scale_d) {
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(scale_d));
}

// P V step: this warpgroup's 64 rows x 16 keys of P (registers) times 16
// keys x DH of V (MN-major, shared memory), accumulated.
template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&d)[DH / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (DH == 64) wgmma_rs_m64n64(d, a, desc, 1);
  else wgmma_rs_m64n128(d, a, desc, 1);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values as a bf16x2 word, `lo` in the low half (the lower column
// of a wgmma A fragment), each rounded to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Splits (x0, x1) into three bf16x2 words whose sums equal x0 and x1: each
// residual is formed in f32, exactly.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  x0 -= __uint_as_float(hi << 16);
  x1 -= __uint_as_float(hi & 0xFFFF0000u);
  mid = pack_bf16(x0, x1);
  x0 -= __uint_as_float(mid << 16);
  x1 -= __uint_as_float(mid & 0xFFFF0000u);
  lo = pack_bf16(x0, x1);
}

// Key tiles [lo, hi) holding a key visible to some row whose absolute
// position lies in [q_lo, q_hi] (`cuda_attention.key_tiles`).
struct Range {
  int lo, hi;
};

__device__ __forceinline__ Range key_tiles(int q_lo, int q_hi,
                                           const Args& a) {
  int begin = 0, end = a.sk;
  if (a.causal) end = min(end, q_hi + 1);
  if (a.window > 0) begin = max(0, q_lo - a.window + 1);
  if (end <= begin) return {0, 0};
  return {begin / kBN, (end + kBN - 1) / kBN};
}

// Whether every key of tile t is visible to every row in [q_lo, q_hi].
__device__ __forceinline__ bool tile_full(int t, int q_lo, int q_hi,
                                          const Args& a) {
  const int first = t * kBN, last = first + kBN - 1;
  return last < a.sk && (!a.causal || last <= q_lo) &&
         (a.window <= 0 || q_hi - first < a.window);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    attention_fwd_kernel(const Args a) {
  using S = Smem<DH>;
  constexpr int kChunks = DH / 8;              // 16-byte chunks of a row
  constexpr int kND = DH / 2;                  // O accumulators a thread
  constexpr int kNS = kBN / 2;                 // score accumulators a thread
  constexpr int kKSteps = kBN / 16;            // P V steps of 16 keys
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3, g8 = lane >> 2, q4 = lane & 3;
  const int kvh = blockIdx.y, b = blockIdx.z, G = a.g;
  const int p0 = (gridDim.x - 1 - blockIdx.x) * a.positions;
  const int rows = min(a.positions, a.sq - p0) * G;   // valid rows

  // Each warpgroup's key tiles, from its valid rows; the CTA walks their
  // union (contiguous: neighbouring rows' visible keys overlap or abut).
  Range mine = {0, 0}, walk = {0, 0};
  int my_lo = 0, my_hi = 0;
#pragma unroll
  for (int w = 0; w < kWarpgroups; ++w) {
    const int first = w * kWgRows, last = min(first + kWgRows, rows) - 1;
    if (first > last) continue;
    const int q_lo = a.q_offset + p0 + first / G;
    const int q_hi = a.q_offset + p0 + last / G;
    const Range r = key_tiles(q_lo, q_hi, a);
    if (r.hi <= r.lo) continue;
    walk = walk.hi <= walk.lo ? r : Range{min(walk.lo, r.lo),
                                          max(walk.hi, r.hi)};
    if (w == wg) {
      mine = r;
      my_lo = q_lo;
      my_hi = q_hi;
    }
  }
  const int n = walk.hi - walk.lo;

  const __nv_bfloat16* kb = a.k + b * a.ks[0] + kvh * a.ks[2];
  const __nv_bfloat16* vb = a.v + b * a.vs[0] + kvh * a.vs[2];
  // Q's rows, zero past the valid ones; in the first copy group.
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r < rows;
    const __nv_bfloat16* src = a.q + b * a.qs[0] +
                               (p0 + r / G) * a.qs[1] +
                               (kvh * G + r % G) * a.qs[2] + c * 8;
    cp_async16(smem_u32(smem + (c >> 3) * S::kQHalf + swz(r, (c & 7) * 16)),
               in ? src : a.q, in ? 16 : 0);
  }
  // Tile t's K and V into stage st, zero past Sk (so masked products are
  // 0 * 0, never 0 * garbage).
  auto load_tile = [&](int t, int st) {
    uint8_t* base = smem + S::kQ + st * S::kStage;
    for (int i = tid; i < 2 * kBN * kChunks; i += kThreads) {
      const int which = i / (kBN * kChunks), j = i % (kBN * kChunks);
      const int r = j / kChunks, c = j % kChunks, key = t * kBN + r;
      const bool in = key < a.sk;
      const __nv_bfloat16* src = which ? vb + key * a.vs[1] + c * 8
                                       : kb + key * a.ks[1] + c * 8;
      cp_async16(smem_u32(base + which * S::kTile + (c >> 3) * S::kKVHalf +
                          swz(r, (c & 7) * 16)),
                 in ? src : a.k, in ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < kAhead; ++st) {
    if (st < n) load_tile(walk.lo + st, st);
    cp_async_commit();
  }

  // This thread's rows (accumulator rows g8 and g8 + 8 of its warp's 16)
  // and their absolute positions.
  const int r_a = wg * kWgRows + wl * 16 + g8, r_b = r_a + 8;
  const int qp_a = a.q_offset + p0 + r_a / G;
  const int qp_b = a.q_offset + p0 + r_b / G;
  const uint32_t q_addr = smem_u32(smem) + wg * kWgRows * 128;

  float o[kND], s[kNS];
  uint32_t ph[kKSteps][4], pm[kKSteps][4], pl[kKSteps][4];
#pragma unroll
  for (int e = 0; e < kND; ++e) o[e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  // Every thread, every tile of the walk: tile it has landed for every
  // thread, and every warpgroup is done with tile it - 2, whose stage the
  // copy of tile it + kAhead reuses (tile it - 1's P V may still run).
  auto next_tile = [&](int it) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    cta_barrier();
    if (it + kAhead < n)
      load_tile(walk.lo + it + kAhead, (it + kAhead) % kStages);
    cp_async_commit();
  };
  // S = Q K^T of tile it, 64 rows x 64 keys, f32 (not waited for).
  auto issue_qk = [&](int it) {
    const uint32_t k_addr =
        smem_u32(smem + S::kQ + (it % kStages) * S::kStage);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      const int off = 32 * (ks & 3);
      wgmma_ss_m64n64(
          s, wgmma_desc(q_addr + (ks >> 2) * S::kQHalf + off, 16, 1024),
          wgmma_desc(k_addr + (ks >> 2) * S::kKVHalf + off, 16, 1024),
          ks > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile it, P in ph, pm, pl (not waited for).
  auto issue_pv = [&](int it) {
    const uint32_t v_addr =
        smem_u32(smem + S::kQ + (it % kStages) * S::kStage + S::kTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const uint64_t vd = wgmma_desc(v_addr + kk * 16 * 128, S::kKVHalf, 1024);
      wgmma_pv<DH>(o, ph[kk], vd);
      wgmma_pv<DH>(o, pm[kk], vd);
      wgmma_pv<DH>(o, pl[kk], vd);
    }
    wgmma_commit();
  };
  // The softmax of tile it's scores: s becomes P, the running max and sum
  // move on, and the correction of O is returned in (c_a, c_b).
  auto softmax = [&](int it, float& c_a, float& c_b) {
    const int t = walk.lo + it;
    // Scale into log2 units, mask, and the rows' running max.
    // s[4j + e] is row r_a (e < 2) or r_b, key t kBN + 8 j + 2 q4 + (e & 1).
    const bool full = tile_full(t, my_lo, my_hi, a);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * a.scale_log2;
        if (!full) {
          const int key = t * kBN + 8 * j + 2 * q4 + (e & 1);
          const int qp = e < 2 ? qp_a : qp_b;
          if (key >= a.sk || (a.causal && key > qp) ||
              (a.window > 0 && qp - key >= a.window))
            x = -INFINITY;
        }
        s[4 * j + e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, d));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, d));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with no visible key yet subtracts 0: its exp2(-inf) are 0
    const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
    c_a = exp2_approx(m_a - mu_a);
    c_b = exp2_approx(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(s[4 * j + e] - (e < 2 ? mu_a : mu_b));
        s[4 * j + e] = p;
        if (e < 2) sum_a += p;
        else sum_b += p;
      }
    // this thread's share of the rows' sums; the quad's shares are added
    // at the end (the correction is the same for all four)
    l_a = l_a * c_a + sum_a;
    l_b = l_b * c_b + sum_b;
  };
  // O *= the correction, and P in three bf16 terms, as the A fragments of
  // the P V steps: step kk takes keys 16 kk .. 16 kk + 15, which are
  // s[8 kk .. 8 kk + 7].
  auto rescale_split = [&](float c_a, float c_b) {
#pragma unroll
    for (int j = 0; j < kND / 4; ++j) {
      o[4 * j] *= c_a;
      o[4 * j + 1] *= c_a;
      o[4 * j + 2] *= c_b;
      o[4 * j + 3] *= c_b;
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], ph[kk][r],
               pm[kk][r], pl[kk][r]);
  };

  // The walk: the tiles before this warpgroup's, its first tile, the rest
  // of its tiles (each one's P V issued behind the next one's Q K^T, so it
  // runs while that tile's softmax does), then the tiles after its own.
  // Each phase has a fixed wgmma pattern: no wait depends on a branch.
  int it = 0;
  for (; it < n && walk.lo + it < mine.lo; ++it) next_tile(it);
  if (it < n && walk.lo + it < mine.hi) {
    float c_a, c_b;
    next_tile(it);
    issue_qk(it);
    wgmma_wait<0>();
    softmax(it, c_a, c_b);
    rescale_split(c_a, c_b);
    for (++it; it < n && walk.lo + it < mine.hi; ++it) {
      next_tile(it);
      issue_qk(it);
      issue_pv(it - 1);
      wgmma_wait<1>();                             // S has landed
      softmax(it, c_a, c_b);
      wgmma_wait<0>();                             // O, ph, pm, pl are free
      rescale_split(c_a, c_b);
    }
    issue_pv(it - 1);
    wgmma_wait<0>();
  }
  for (; it < n; ++it) next_tile(it);
  cp_async_wait<0>();

  // Out = O / max(l, 1e-30) in f32, rounded once to bf16.
  // o[4j + e] is row r_a (e < 2) or r_b, column 8 j + 2 q4 + (e & 1).
#pragma unroll
  for (int d = 1; d < 4; d <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, d);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, d);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r_b : r_a;
    if (r >= rows) continue;
    const float l = fmaxf(half ? l_b : l_a, 1e-30f);
    __nv_bfloat16* dst =
        a.out + ((static_cast<long long>(b) * a.sq + p0 + r / G) * a.h +
                 kvh * G + r % G) * DH + 2 * q4;
#pragma unroll
    for (int j = 0; j < kND / 4; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(o[4 * j + 2 * half] / l, o[4 * j + 2 * half + 1] / l);
  }
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

template <int DH>
int launch(const Args& a, int batch, int kv, int n_qtiles, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  const cudaError_t attr = allow_smem(
      reinterpret_cast<const void*>(attention_fwd_kernel<DH>),
      Smem<DH>::kBytes, done);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attention_fwd_kernel<DH>
      <<<dim3(n_qtiles, kv, batch), kThreads, Smem<DH>::kBytes, s>>>(a);
  return 0;
}

}  // namespace

// Plain C entry point, bound with ctypes.  q (B, Sq, H, dh), k and v (B, Sk,
// K, dh) are bf16 device tensors whose rows of dh are contiguous and 16-byte
// aligned; `strides` holds their nine element strides (q's batch, position
// and head, then k's, then v's).  out is a contiguous bf16 (B, Sq, H, dh).
// `args` is a host array of ten ints: B, Sq, Sk, H, K, dh (64 or 128),
// causal, window (0 = none), q_offset and positions (query positions a CTA,
// 128 / G at most).
// `scale_log2` is log2(e) / sqrt(dh).  The caller makes sure every query
// row sees a key and keeps K and B within the grid's y and z limits.
// Returns cudaGetLastError() after the launch (or the error of setting the
// kernel's shared memory size); the launch is asynchronous on `stream`.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* out, const long long* strides,
                             const int* args, float scale_log2,
                             void* stream) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = static_cast<__nv_bfloat16*>(out);
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
  }
  const int batch = args[0], kv = args[4], dh = args[5];
  a.sq = args[1];
  a.sk = args[2];
  a.h = args[3];
  a.g = args[3] / kv;
  a.causal = args[6];
  a.window = args[7];
  a.q_offset = args[8];
  a.positions = args[9];
  a.scale_log2 = scale_log2;
  const int n_qtiles = (a.sq + a.positions - 1) / a.positions;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (dh == 128) err = launch<128>(a, batch, kv, n_qtiles, s);
  else if (dh == 64) err = launch<64>(a, batch, kv, n_qtiles, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

