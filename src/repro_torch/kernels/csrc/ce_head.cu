// The training head and cross-entropy on Hopper (sm_90a): the loss
//   nll = sum_r mask_r (logZ_r - z[r, label_r]),  z = x W,  mask_r = label_r >= 0,
// and its gradients dX = D W^T and dW = x^T D, D[r, c] = g mask_r
// (exp(z[r, c] - logZ_r) - [c == label_r]), for bf16 x (M, K), a bf16 head
// W (K, V) read in place, int32 labels and the upstream scalar g.  The f32
// logits never reach device memory.
//
// Replaces: no Pallas kernel.  The reference (repro/models/transformer.py
// `chunked_ce_loss`) leaves the head and the loss to XLA einsums, and the
// port's plain path (models/transformer.py `_ce_chunk`) casts the head to
// f32 in every chunk, forward and recompute, and multiplies on the CUDA
// cores with the chunk's f32 logits and their gradient in device memory.
//
// Arithmetic, the plain path's at f32 precision:
// * z is bf16 wgmma with f32 accumulation: every product of two bf16 values
//   is exact in f32, so only the f32 sums round, as in the plain path.
// * logZ by an online max and sum of exp over each CTA's range of V, the
//   ranges' partials merged by `ce_merge_kernel`.
// * D is formed in f32 and split into three bf16 terms, hi = bf16(d), mid =
//   bf16(d - hi), lo = bf16(d - hi - mid), each residual exact, whose sum is
//   d to its 24 bits (for |d| >= 2^-110; below, the lowest bits of d fall
//   under bf16's subnormal step).  dX and dW take the three planes of D in
//   their K loops against one f32 accumulator: exact products, f32 sums,
//   rounded once to the output.  dW stays f32 across the chunks of rows.
//
// What bounds it on this card (H100 SXM: 989 TFLOP/s bf16 on the tensor
// cores, 3.35 TB/s): the operations.  One pass of z is 2 M K V flops; the
// loss takes 8: the forward, the backward's recompute, and dX and dW three
// times each, one pass a plane.  At rwkv6-7b's microbatch (M 8,192, K 4,096,
// V 65,536) that is 35 TFLOP, 35.6 ms at the bf16 rate, against 1.1 GB of x,
// W, dX and dW and 2.4 GB of planes written and read twice a chunk.
//
// Design (every kernel: a CTA of two warpgroups, a 128 x 256 output tile,
// each warpgroup 64 rows x 256 columns, one m64n256k16 wgmma a 16-deep slice
// with both operands in shared memory):
// * Operands go through cp.async rings of 64-deep tiles, two steps ahead, in
//   rows of 128 bytes under the 128-byte swizzle.  An operand whose rows run
//   along the contraction (x in z, the planes and W in dX) is a K-major
//   descriptor; one whose rows run along the output (W in z, the planes and
//   x in dW) is MN-major, so W, x and the planes are all read in place.
// * `ce_logits_kernel`: a CTA owns 128 rows and a range of V's 256-column
//   tiles (the grid splits V so that about two CTAs an SM run).  It walks
//   its tiles' K steps as one stream, so the next tile's copies fly during a
//   tile's epilogue.  The LSE epilogue moves each row's running max and sum
//   and writes the label's logit where its column lies; the GRAD epilogue
//   forms D and writes its three planes for one chunk of rows.
// * `ce_mm_kernel` (dX, and dW as its transpose sum_p plane_p^T x): the
//   planes are A, and the K loop takes, for each 64-deep tile of the
//   contraction, the three planes in turn against one tile of B, which is
//   copied once for the three (a ring of two).  dW's first chunk stores its
//   f32 tile; later chunks add to it with `red.add` (one CTA owns each
//   element, so each launch adds once, deterministically).  Adding in the
//   epilogue keeps the accumulators wgmma's alone: ptxas serialises the
//   wgmma of a kernel that loads a C tile into them (on an H100 SXM, dW's
//   chunk of 2,048 rows took 6.89 ms with such a load, 5.14 without).
// * Measured at rwkv6-7b's microbatch on an H100 SXM (PERF.md, kernel table
//   row 9): the products run at 40-70 % of the bf16 rate, the forward's and
//   the recompute's lowest: each step copies a 128-row and a 256-column
//   tile, 48 KB for 4.2 MFLOP, so 132 CTAs ask the L2 for ~8 TB/s at the
//   full rate.
#include "ternary_mma.cuh"

#include <cmath>

namespace {

constexpr int kBM = 128;                       // output rows a CTA
constexpr int kBN = 256;                       // output columns a CTA
constexpr int kBK = 64;                        // contraction a step
constexpr int kThreadsCE = 256;                // two warpgroups
constexpr int kAhead = 2;                      // steps copied ahead
constexpr int kRing = 4;                       // slots of a per-step operand
constexpr int kHeld = 2;                       // slots of the planes' partner
constexpr int kPlanes = 3;
constexpr int kATile = kBM * kBK * 2;          // bytes
constexpr int kBTile = kBN * kBK * 2;
constexpr int kLogitsSmem = kRing * (kATile + kBTile) + 1024;

// Copies R x C bf16, element (r, c) at g[(r0 + r) ld + c0 + c], into shared
// memory as C / 64 blocks of R rows of 128 bytes (block b at b R 128 bytes),
// 128-byte swizzled; elements at or past (r_lim, c_lim) read 0.  c_lim is a
// multiple of 8, so each 16-byte chunk is all in or all out.
template <int R, int C>
__device__ __forceinline__ void load_tile(uint8_t* dst,
                                          const __nv_bfloat16* __restrict__ g,
                                          long long ld, int r0, int c0,
                                          int r_lim, int c_lim) {
  constexpr int kChunks = R * C / 8, kRowChunks = C / 8;
  static_assert(kChunks % kThreadsCE == 0, "whole rounds of copies");
#pragma unroll
  for (int j = 0; j < kChunks / kThreadsCE; ++j) {
    const int i = j * kThreadsCE + threadIdx.x;
    const int r = i / kRowChunks, c = (i % kRowChunks) * 8;
    const int row = r0 + r, col = c0 + c;
    const bool in = row < r_lim && col < c_lim;
    cp_async16(smem_u32(dst + (c >> 6) * (R * 128) + swz(r, (c & 63) * 2)),
               in ? g + static_cast<long long>(row) * ld + col : g,
               in ? 16 : 0);
  }
}

// A 64-deep operand tile of `E` (128 or 256) output rows or columns, K-major
// (E rows of 64) or MN-major (64 rows of E), from element (e0, k0) of a
// matrix whose element (e, k) lies at g[e ld + k] (K-major) or g[k ld + e].
template <int E, bool KMAJ>
__device__ __forceinline__ void load_operand(uint8_t* dst,
                                             const __nv_bfloat16* g,
                                             long long ld, int e0, int k0,
                                             int e_lim, int k_lim) {
  if constexpr (KMAJ) load_tile<E, kBK>(dst, g, ld, e0, k0, e_lim, k_lim);
  else load_tile<kBK, E>(dst, g, ld, k0, e0, k_lim, e_lim);
}

// Descriptor of a 128-byte-swizzled bf16 operand slice; `lbo` and `sbo` in
// bytes (the tiles' bases are 1024-byte aligned).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Slice ks (16 deep) of a tile at `base` (`load_operand`'s layout), from its
// output row or column e0 (a multiple of 64): K-major, 8-row groups 1024
// bytes apart; MN-major, 8-deep groups 1024 bytes apart and 64-wide blocks
// of the output 8,192 bytes apart.
template <bool KMAJ>
__device__ __forceinline__ uint64_t operand_desc(uint32_t base, int e0,
                                                 int ks) {
  if constexpr (KMAJ) return smem_desc(base + e0 * 128 + 32 * ks, 16, 1024);
  else return smem_desc(base + (e0 >> 6) * 8192 + ks * 2048, 8192, 1024);
}

// d (64 x 256, f32) += A (64 x 16) B (16 x 256), both from shared memory;
// TA / TB 1 for an MN-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// Two f32 values as a bf16x2 word, `lo` in the low half, each rounded to
// nearest.
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

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// One launch of `ce_logits_kernel`.  x (M, K) and W (K, V) row-major; the
// LSE pass writes part_m and part_s (splits, M) and label_z (M); the GRAD
// pass reads logz (M) and *g and writes the planes (3, plane / V, V).
struct LogitsArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const int* labels;
  float* part_m;
  float* part_s;
  float* label_z;
  const float* logz;
  const float* g;
  __nv_bfloat16* planes;
  long long plane;
  int M, K, V, splits;
};

// Thread layout of a warpgroup's m64n256 accumulator: d[4j + e] is row
// 16 wl + g8 + 8 (e >> 1) of the warpgroup's 64, column 8j + 2 q4 + (e & 1).
template <bool GRAD>
__global__ void __launch_bounds__(kThreadsCE, 1)
    ce_logits_kernel(const LogitsArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* a_ring = smem;
  uint8_t* b_ring = smem + kRing * kATile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3, g8 = lane >> 2, q4 = lane & 3;
  const int m0 = blockIdx.y * kBM;
  const int n_tiles = (a.V + kBN - 1) / kBN;
  const int t_lo = static_cast<int>(
      static_cast<long long>(blockIdx.x) * n_tiles / a.splits);
  const int t_hi = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * n_tiles / a.splits);
  const int k_steps = a.K / kBK;
  const int total = (t_hi - t_lo) * k_steps;

  auto load = [&](int s) {
    const int t = t_lo + s / k_steps, k0 = (s % k_steps) * kBK;
    load_operand<kBM, true>(a_ring + (s % kRing) * kATile, a.x, a.K, m0, k0,
                            a.M, a.K);
    load_operand<kBN, false>(b_ring + (s % kRing) * kBTile, a.w, a.V,
                             t * kBN, k0, a.V, a.K);
  };
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }

  // this thread's two rows and their labels (-1 past M)
  const int row_a = m0 + wg * 64 + wl * 16 + g8, row_b = row_a + 8;
  const int lab_a = row_a < a.M ? a.labels[row_a] : -1;
  const int lab_b = row_b < a.M ? a.labels[row_b] : -1;
  float m_a = -INFINITY, m_b = -INFINITY, s_a = 0.f, s_b = 0.f;
  float lz_a = 0.f, lz_b = 0.f, gm_a = 0.f, gm_b = 0.f;
  if constexpr (GRAD) {
    const float g = *a.g;
    if (lab_a >= 0) { lz_a = a.logz[row_a]; gm_a = g; }
    if (lab_b >= 0) { lz_b = a.logz[row_b]; gm_b = g; }
  }

  const uint32_t a_base = smem_u32(a_ring), b_base = smem_u32(b_ring);
  float acc[128];
  int s = 0;
  for (int t = t_lo; t < t_hi; ++t) {
    for (int kk = 0; kk < k_steps; ++kk, ++s) {
      cp_async_wait<kAhead - 1>();
      fence_proxy_async();
      __syncthreads();
      if (s + kAhead < total) load(s + kAhead);
      cp_async_commit();
      const uint32_t at = a_base + (s % kRing) * kATile;
      const uint32_t bt = b_base + (s % kRing) * kBTile;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)
        wgmma_n256<0, 1>(acc, operand_desc<true>(at, wg * 64, ks),
                         operand_desc<false>(bt, 0, ks), kk > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();

    const int n0 = t * kBN;
    const bool full = n0 + kBN <= a.V;
    if constexpr (!GRAD) {
      // the tile's row max, then the running max and sum move on
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + 8 * j + 2 * q4 + (e & 1);
          if (full || col < a.V) {
            if (e < 2) mx_a = fmaxf(mx_a, acc[4 * j + e]);
            else mx_b = fmaxf(mx_b, acc[4 * j + e]);
          }
        }
#pragma unroll
      for (int d = 1; d < 4; d <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, d));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, d));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + 8 * j + 2 * q4 + (e & 1);
          if (full || col < a.V) {
            const float z = acc[4 * j + e];
            if (e < 2) {
              sum_a += expf(z - mn_a);
              if (col == lab_a) a.label_z[row_a] = z;
            } else {
              sum_b += expf(z - mn_b);
              if (col == lab_b) a.label_z[row_b] = z;
            }
          }
        }
      s_a = s_a * expf(m_a - mn_a) + sum_a;
      s_b = s_b * expf(m_b - mn_b) + sum_b;
      m_a = mn_a;
      m_b = mn_b;
    } else {
      // D = g mask (exp(z - logZ) - [col == label]) in three bf16 planes
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? row_b : row_a;
        if (row >= a.M) continue;
        const int lab = half ? lab_b : lab_a;
        const float lz = half ? lz_b : lz_a, gm = half ? gm_b : gm_a;
        __nv_bfloat16* dst = a.planes + static_cast<long long>(row) * a.V;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int col = n0 + 8 * j + 2 * q4;      // V is even
          if (!full && col >= a.V) continue;
          const float d0 = gm * expf(acc[4 * j + 2 * half] - lz) -
                           (col == lab ? gm : 0.f);
          const float d1 = gm * expf(acc[4 * j + 2 * half + 1] - lz) -
                           (col + 1 == lab ? gm : 0.f);
          uint32_t hi, mid, lo;
          split3(d0, d1, hi, mid, lo);
          *reinterpret_cast<uint32_t*>(dst + col) = hi;
          *reinterpret_cast<uint32_t*>(dst + a.plane + col) = mid;
          *reinterpret_cast<uint32_t*>(dst + 2 * a.plane + col) = lo;
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (!GRAD) {
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      s_a += __shfl_xor_sync(0xffffffffu, s_a, d);
      s_b += __shfl_xor_sync(0xffffffffu, s_b, d);
    }
    if (q4 == 0) {
      const long long off = static_cast<long long>(blockIdx.x) * a.M;
      if (row_a < a.M) {
        a.part_m[off + row_a] = m_a;
        a.part_s[off + row_a] = s_a;
      }
      if (row_b < a.M) {
        a.part_m[off + row_b] = m_b;
        a.part_s[off + row_b] = s_b;
      }
    }
  }
}

// logZ of each row from the splits' (max, sum) partials, and the row's NLL
// (0 for a masked row).
__global__ void ce_merge_kernel(const float* __restrict__ part_m,
                                const float* __restrict__ part_s,
                                const float* __restrict__ label_z,
                                const int* __restrict__ labels, int M,
                                int splits, float* __restrict__ logz,
                                float* __restrict__ nll) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  float m = -INFINITY;
  for (int i = 0; i < splits; ++i) m = fmaxf(m, part_m[i * M + r]);
  float s = 0.f;
  for (int i = 0; i < splits; ++i)
    s += part_s[i * M + r] * expf(part_m[i * M + r] - m);
  const float lz = m + logf(s);
  logz[r] = lz;
  nll[r] = labels[r] >= 0 ? lz - label_z[r] : 0.f;
}

// One launch of `ce_mm_kernel`: out = sum over the three planes of A_p B,
// A_p (M, K) the planes, B (K, N), contraction K.  Element (m, k) of A_p
// lies at a[m lda + k + p plane] (K-major) or a[k lda + m + p plane];
// element (k, n) of B at b[n ldb + k] (K-major) or b[k ldb + n].  dX
// stores bf16 out[m ldo + n]; dW stores f32 out[n ldo + m] (the transpose)
// when `accumulate` is 0 and adds to it otherwise.
struct MmArgs {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  void* out;
  long long lda, ldb, ldo, plane;
  int M, N, K, accumulate;
};

constexpr int kMmSmem = kRing * kATile + kHeld * kBTile + 1024;

template <bool A_KMAJ, bool B_KMAJ, bool DW>
__global__ void __launch_bounds__(kThreadsCE, 1)
    ce_mm_kernel(const MmArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* a_ring = smem;
  uint8_t* b_ring = smem + kRing * kATile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3, g8 = lane >> 2, q4 = lane & 3;
  // column tiles fastest: the CTAs that share a plane tile run together
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int total = (a.K + kBK - 1) / kBK * kPlanes;

  // step s: contraction tile s / 3, plane s % 3; B's tile is copied with
  // plane 0 into its ring of two
  auto load = [&](int s) {
    const int k0 = s / kPlanes * kBK, p = s % kPlanes;
    load_operand<kBM, A_KMAJ>(a_ring + (s % kRing) * kATile,
                              a.a + p * a.plane, a.lda, m0, k0, a.M, a.K);
    if (p == 0)
      load_operand<kBN, B_KMAJ>(b_ring + (s / kPlanes % kHeld) * kBTile,
                                a.b, a.ldb, n0, k0, a.N, a.K);
  };
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }

  const uint32_t a_base = smem_u32(a_ring), b_base = smem_u32(b_ring);
  float acc[128];
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    if (s + kAhead < total) load(s + kAhead);
    cp_async_commit();
    const uint32_t at = a_base + (s % kRing) * kATile;
    const uint32_t bt = b_base + (s / kPlanes % kHeld) * kBTile;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
      wgmma_n256<A_KMAJ ? 0 : 1, B_KMAJ ? 0 : 1>(
          acc, operand_desc<A_KMAJ>(at, wg * 64, ks),
          operand_desc<B_KMAJ>(bt, 0, ks), s > 0 || ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  const int row_a = m0 + wg * 64 + wl * 16 + g8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + 8 * half;
    if (row >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = n0 + 8 * j + 2 * q4;        // N is even
      if (col >= a.N) continue;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if constexpr (DW) {
        // one CTA owns each element, so the add is the only one this launch
        float* out = static_cast<float*>(a.out) + col * a.ldo + row;
        if (a.accumulate) {
          atomicAdd(out, v0);
          atomicAdd(out + a.ldo, v1);
        } else {
          out[0] = v0;
          out[a.ldo] = v1;
        }
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.out) +
                                     row * a.ldo + col) = pack_bf16(v0, v1);
      }
    }
  }
}

template <bool GRAD>
int launch_logits(const LogitsArgs& a, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  const cudaError_t attr = allow_smem(
      reinterpret_cast<const void*>(ce_logits_kernel<GRAD>), kLogitsSmem,
      done);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ce_logits_kernel<GRAD><<<dim3(a.splits, (a.M + kBM - 1) / kBM),
                           kThreadsCE, kLogitsSmem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool A_KMAJ, bool B_KMAJ, bool DW>
int launch_mm(const MmArgs& a, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  auto* kernel = ce_mm_kernel<A_KMAJ, B_KMAJ, DW>;
  const cudaError_t attr = allow_smem(reinterpret_cast<const void*>(kernel),
                                      kMmSmem, done);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM), kThreadsCE,
           kMmSmem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes.  Every pointer is a device
// pointer, every bf16 matrix row-major, contiguous and 16-byte aligned; K is
// a multiple of 64 and V of 8; the caller keeps ceil(M / 128) and ceil(V /
// 256) within the grid's y limit and 1 <= splits <= ceil(V / 256).  Each
// returns cudaGetLastError() after its launches (or the error of setting a
// kernel's shared memory size); the launches are asynchronous on `stream`.

// The forward: logz (M) and each row's NLL (M), from x (M, K), W (K, V) and
// labels (M).  part_m, part_s (splits, M) are scratch; label_z (M) is
// zeroed by the caller (a masked row's stays 0).
extern "C" int ce_lse(const void* x, const void* w, const int* labels, int M,
                      int K, int V, int splits, float* part_m, float* part_s,
                      float* label_z, float* logz, float* nll, void* stream) {
  LogitsArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.labels = labels;
  a.part_m = part_m;
  a.part_s = part_s;
  a.label_z = label_z;
  a.M = M;
  a.K = K;
  a.V = V;
  a.splits = splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_logits<false>(a, s);
  if (err) return err;
  ce_merge_kernel<<<(M + 255) / 256, 256, 0, s>>>(part_m, part_s, label_z,
                                                  labels, M, splits, logz,
                                                  nll);
  return static_cast<int>(cudaGetLastError());
}

// The backward's D for rows x (M, K) (one chunk), as three bf16 planes of
// (M, V) `plane` elements apart, from their logz, labels and the upstream
// scalar *g (a device f32).
extern "C" int ce_grad(const void* x, const void* w, const int* labels,
                       const float* logz, const float* g, void* planes,
                       long long plane, int M, int K, int V, int splits,
                       void* stream) {
  LogitsArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.labels = labels;
  a.logz = logz;
  a.g = g;
  a.planes = static_cast<__nv_bfloat16*>(planes);
  a.plane = plane;
  a.M = M;
  a.K = K;
  a.V = V;
  a.splits = splits;
  return launch_logits<true>(a, static_cast<cudaStream_t>(stream));
}

// dX (M, K) bf16 = sum_p plane_p (M, V) W^T for one chunk of M rows.
extern "C" int ce_dx(const void* planes, long long plane, const void* w,
                     void* dx, int M, int K, int V, void* stream) {
  MmArgs a{};
  a.a = static_cast<const __nv_bfloat16*>(planes);
  a.b = static_cast<const __nv_bfloat16*>(w);
  a.out = dx;
  a.lda = V;            // plane element (row, v): K-major
  a.ldb = V;            // W element (v, k) at w[k V + v]: K-major
  a.ldo = K;
  a.plane = plane;
  a.M = M;
  a.N = K;
  a.K = V;
  return launch_mm<true, true, false>(a, static_cast<cudaStream_t>(stream));
}

// dW (K, V) f32 (+)= x^T (K, M) sum_p plane_p (M, V) for one chunk of M
// rows, computed as its transpose sum_p plane_p^T x: written when
// `accumulate` is 0, added to otherwise.
extern "C" int ce_dw(const void* x, const void* planes, long long plane,
                     float* dw, int M, int K, int V, int accumulate,
                     void* stream) {
  MmArgs a{};
  a.a = static_cast<const __nv_bfloat16*>(planes);
  a.b = static_cast<const __nv_bfloat16*>(x);
  a.out = dw;
  a.lda = V;            // plane^T element (v, row) at planes[row V + v]
  a.ldb = K;            // x element (row, k): MN-major
  a.ldo = V;
  a.plane = plane;
  a.M = V;
  a.N = K;
  a.K = M;
  a.accumulate = accumulate;
  return launch_mm<false, false, true>(a, static_cast<cudaStream_t>(stream));
}
