// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces: repro/kernels/rwkv6_scan.py `_kernel` (pallas_call at :92),
// reached through `rwkv6_chunked` and `ops.rwkv6_scan`; in the model it is
// the recurrence of every RWKV-6 layer's time-mix (models/ssm.py), at
// prefill and at every decode step.
//
// Computes, for each row (b, h) and token t = 0 .. T-1,
//   y[b, t, h, j] = sum_i r_i S[i][j] + c_t v_j,  c_t = sum_i r_i u_i k_i
//   S[i][j]       = w_i S[i][j] + k_i v_j
// (r, k, v, w of token t; the bonus sum_i r_i u_i k_i v_j of the reference
// factored into one scalar a token) from S = s0[b, h] or zeros, with
//   r, k, v  (B, T, H, DH) views, bfloat16 or float32 (widened here, which
//            is exact): the last dimension contiguous, heads DH apart, any
//            step sB between batch rows and sT between tokens;
//   w        the same layout, float32 (decays reach 1e-12);
//   u        float32, row (b, h) at b * u_sb + h * DH (u_sb = 0: one
//            (H, DH) bonus for every b);
//   s0, s_out (B, H, DH, DH) float32, contiguous, row i = key dim, column
//            j = value dim; s_out may alias s0 (the decode cache updated in
//            place: each thread reads its own elements before it writes
//            them, and no other thread touches them);
//   y        (B, T, H, DH) float32, contiguous.
// The (BH, T, DH) layout of the reference's kernel is the case H = 1,
// u_sb = DH.  This is the sequential oracle `ref.rwkv6_scan_ref` with an
// initial state.  The Pallas kernel runs chunks as matmuls and divides k by
// the cumulative decay inside a chunk, which overflows float32 for small
// decays; this kernel never divides, so it is right at any decay in (0, 1).
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s float32 on
// the CUDA cores, 128 float32 lanes an SM): rwkv6-7b's prefill of 8 x 96
// tokens in float32 moves 4 x 512 x 96 x 64 floats in, y out and 512 final
// 64 x 64 states, 71 MB -> ~21 us, and issues 3 instructions per (row,
// token, i, j), 604 M lane instructions -> ~18 us at the float32 rate: the
// two bounds are close.  A decode step (T = 1) is the state: 8.4 MB in and
// 8.4 MB out -> ~5 us.  The recurrence is sequential in t.
//
// Design: one block per row (b, h).  Each thread keeps an R x C tile of
// the state in registers for the whole sequence (DH = 64: 8 key rows x 8
// value columns, 64 threads a row; DH = 16: 4 x 2, 32 threads), so the
// state is read and written once, and a token costs three instructions per
// (i, j): y's multiply-add and the decay update's multiply and
// multiply-add.  The tile is what feeds the CUDA cores: shared memory
// delivers 128 bytes a clock to an SM's registers against 128 float
// operations, so a thread that owned one column (4 lanes a column, an
// earlier build) spent 12 bytes of r_i, k_i, w_i on every 3 operations and
// ran at the shared-memory rate; an 8 x 8 tile loads each r_i, k_i, w_i
// once for 8 columns and each v_j once for 8 rows.  A thread's columns are
// float4 chunks, and threads of a row group (same rows) are consecutive
// lanes, so every warp load or store of the state covers whole 128-byte
// lines and every shared-memory read of a token's operands is a broadcast
// or contiguous.  The key sum of a column is split over the G = DH / R row
// groups: each token's partial sums go to shared memory, and after each
// chunk a sum pass adds them in a fixed pairwise order (so the bits do not
// depend on scheduling and a split run equals one pass), adds c_t v_j and
// writes y as float4s; the token loop itself carries no reduction.
// Operands are staged TC = 8 tokens a chunk into a ring of three
// shared-memory stages with 16-byte `cp.async`, two chunks ahead of the
// one computed (one chunk ahead left the load latency exposed), so a block
// waits on device memory at most once a chunk.  A chunk takes three block
// syncs: its data landed, a prepare pass (widens bfloat16 r, k, v to
// float32 and sums c_t for each token) done, its partial sums written.  The
// next token's operands are loaded into registers while the current one is
// computed, two operand sets in turn.  Each thread's staging pieces, row
// bases and token steps are fixed when the kernel starts, so staging costs
// a few instructions a piece.  Operands (state included) that do not start
// on 16-byte boundaries are staged and loaded element by element instead
// (`VEC` false).
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TC = 8;      // tokens staged a chunk
constexpr int STAGES = 3;  // chunks in the staging ring

struct Args {
  const void* rkv[3];  // r, k, v: float or bfloat16
  const float* w;
  const float* u;
  const float* s0;     // may be null; may alias s_out
  float* s_out;
  float* y;
  long long sB[4], sT[4];  // r, k, v, w: batch-row and token steps (elements)
  long long u_sb, y_sB, y_sT;
  int H, T;
};

// A thread's tile of the state: R key rows x C value columns.
template <int DH> struct TileOf;
template <> struct TileOf<64> { static constexpr int R = 8, C = 8; };
template <> struct TileOf<16> { static constexpr int R = 4, C = 2; };

template <int DH>
struct Geo {
  static constexpr int R = TileOf<DH>::R, C = TileOf<DH>::C;
  static constexpr int G = DH / R;      // row groups
  static constexpr int NJ = DH / C;     // column groups, the fastest lanes
  static constexpr int NT = G * NJ;     // threads a block
  static constexpr int TPT = NT / TC;   // prepare and sum threads a token,
  static constexpr int EPT = DH / TPT;  // and elements each
  static_assert(R % 4 == 0 && EPT % 4 == 0 && TPT <= 32 && NT % 32 == 0 &&
                    NT % TC == 0 && NT >= DH,
                "geometry");
  // the n-th of W columns a thread owns out of `groups` interleaved
  // groups: float4 chunks 4 x groups apart, or single columns
  template <int W, int groups>
  static __device__ __forceinline__ int col(int group, int n) {
    if constexpr (W % 4)
      return n * groups + group;
    else
      return (n / 4) * 4 * groups + group * 4 + n % 4;
  }
};

template <int DH, typename T>
struct Smem;

template <int DH>
struct Smem<DH, float> {  // r, k, v staged straight into the planes
  float w[STAGES][TC][DH];
  float x[STAGES][3][TC][DH];
  float part[TC][Geo<DH>::G][DH];  // each row group's partial y
  float u[DH];
  float c[TC];
  __device__ const float* plane(int st, int which) const {
    return &x[st][which][0][0];
  }
};

template <int DH>
struct Smem<DH, __nv_bfloat16> {  // staged raw, widened by the prepare pass
  float w[STAGES][TC][DH];
  __nv_bfloat16 raw[STAGES][3][TC][DH];
  float x[3][TC][DH];
  float part[TC][Geo<DH>::G][DH];
  float u[DH];
  float c[TC];
  __device__ const float* plane(int, int which) const {
    return &x[which][0][0];
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` of this thread's committed groups are open
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Where a thread's staging reads come from: each operand's row (b, h)
// start and token step, in bytes, fixed for the kernel.
struct Src {
  const char* base[4];  // r, k, v, w
  long long step[4];
};

// Stage tokens [t0, t0 + n) of one operand (element type E) into dst,
// token t's DH elements at dst + t * DH: 16-byte `cp.async` pieces (a
// thread's pieces fixed by its index) when VEC, else element by element.
template <int DH, typename E, bool VEC>
__device__ __forceinline__ void stage_one(E* dst, const char* base,
                                          long long step, int t0, int n) {
  using Gm = Geo<DH>;
  if constexpr (VEC) {
    constexpr int EPP = 16 / sizeof(E);  // elements a 16-byte piece
    constexpr int PER = DH / EPP;        // pieces a token
    constexpr int ROUNDS = (TC * PER + Gm::NT - 1) / Gm::NT;
#pragma unroll
    for (int k = 0; k < ROUNDS; ++k) {
      const int p = threadIdx.x + k * Gm::NT;
      const int t = p / PER, i = (p % PER) * EPP;
      if ((TC * PER % Gm::NT == 0 || p < TC * PER) && t < n)
        cp_async16(dst + t * DH + i,
                   base + (t0 + t) * step + i * (int)sizeof(E));
    }
  } else {
    for (int e = threadIdx.x; e < n * DH; e += Gm::NT) {
      const int t = e / DH, i = e - t * DH;
      dst[t * DH + i] =
          reinterpret_cast<const E*>(base + (t0 + t) * step)[i];
    }
  }
}

// Stage tokens [t0, t0 + n) of every operand into ring stage `st`.
template <int DH, typename T, bool VEC>
__device__ __forceinline__ void stage(Smem<DH, T>& sm, const Src& src,
                                      int t0, int n, int st) {
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    T* dst;
    if constexpr (std::is_same_v<T, float>)
      dst = &sm.x[st][x][0][0];
    else
      dst = &sm.raw[st][x][0][0];
    stage_one<DH, T, VEC>(dst, src.base[x], src.step[x], t0, n);
  }
  stage_one<DH, float, VEC>(&sm.w[st][0][0], src.base[3], src.step[3], t0,
                            n);
}

// The prepare pass over a staged chunk: thread (t, l) widens r, k, v at
// i = l EPT .. (l + 1) EPT - 1 of token t (bfloat16 only) and adds its
// share of c_t = sum_i r_i u_i k_i; the TPT threads of a token add their
// shares in a fixed xor order.  Tokens past the chunk's end compute on
// stale data that nothing reads.
template <int DH, typename T>
__device__ __forceinline__ void prepare(Smem<DH, T>& sm, int st) {
  using Gm = Geo<DH>;
  const int t = threadIdx.x / Gm::TPT, l = threadIdx.x % Gm::TPT;
  float c = 0.f;
#pragma unroll
  for (int q = 0; q < Gm::EPT / 4; ++q) {
    const int i = l * Gm::EPT + 4 * q;
    float4 r4, k4;
    if constexpr (std::is_same_v<T, float>) {
      r4 = *reinterpret_cast<const float4*>(&sm.x[st][0][t][i]);
      k4 = *reinterpret_cast<const float4*>(&sm.x[st][1][t][i]);
    } else {
      float4 f[3];
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        const auto* p =
            reinterpret_cast<const __nv_bfloat162*>(&sm.raw[st][x][t][i]);
        const float2 lo = __bfloat1622float2(p[0]);
        const float2 hi = __bfloat1622float2(p[1]);
        f[x] = make_float4(lo.x, lo.y, hi.x, hi.y);
        *reinterpret_cast<float4*>(&sm.x[x][t][i]) = f[x];
      }
      r4 = f[0];
      k4 = f[1];
    }
    const float4 u4 = *reinterpret_cast<const float4*>(&sm.u[i]);
    c = fmaf(r4.x, u4.x * k4.x, c);
    c = fmaf(r4.y, u4.y * k4.y, c);
    c = fmaf(r4.z, u4.z * k4.z, c);
    c = fmaf(r4.w, u4.w * k4.w, c);
  }
#pragma unroll
  for (int o = 1; o < Gm::TPT; o *= 2) c += __shfl_xor_sync(0xffffffffu, c, o);
  if (l == 0) sm.c[t] = c;
}

// The sum pass over a computed chunk: thread (t, q) adds the G row groups'
// partial sums of its EPT columns of token t in a fixed pairwise order,
// adds c_t v_j and writes y, 16 bytes at a time.
template <int DH, typename T>
__device__ __forceinline__ void sum_chunk(const Smem<DH, T>& sm, int st,
                                          int cnt, float* y_tok,
                                          long long y_sT) {
  using Gm = Geo<DH>;
  constexpr int G = Gm::G, W = Gm::EPT;
  const int t = threadIdx.x / Gm::TPT, q = threadIdx.x % Gm::TPT;
  if (t >= cnt) return;
  const float c = sm.c[t];
  const float* vp = sm.plane(st, 2) + t * DH;
  float* yt = y_tok + t * y_sT;
#pragma unroll
  for (int n = 0; n < W; n += 4) {
    const int j = Gm::template col<W, Gm::TPT>(q, n);
    float4 p[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      p[g] = *reinterpret_cast<const float4*>(&sm.part[t][g][j]);
#pragma unroll
    for (int span = 1; span < G; span *= 2)
#pragma unroll
      for (int g = 0; g < G; g += 2 * span) {
        p[g].x += p[g + span].x;
        p[g].y += p[g + span].y;
        p[g].z += p[g + span].z;
        p[g].w += p[g + span].w;
      }
    const float4 v4 = *reinterpret_cast<const float4*>(vp + j);
    *reinterpret_cast<float4*>(yt + j) =
        make_float4(fmaf(c, v4.x, p[0].x), fmaf(c, v4.y, p[0].y),
                    fmaf(c, v4.z, p[0].z), fmaf(c, v4.w, p[0].w));
  }
}

// One token's operands of a thread: r, k, w of its R rows, v of its C
// columns.
template <int R, int C>
struct Operands {
  float4 r[R / 4], k[R / 4], w[R / 4];
  float v[C];
};

template <int DH, typename T, bool VEC>
__global__ void __launch_bounds__(Geo<DH>::NT, 256 / Geo<DH>::NT)
    rwkv6_scan_kernel(const Args a) {
  using Gm = Geo<DH>;
  constexpr int R = Gm::R, C = Gm::C;
  constexpr int CV = (C % 4 || !VEC) ? 1 : 4;  // state columns a load
  __shared__ __align__(16) Smem<DH, T> sm;
  const int tid = threadIdx.x;
  const int jc = tid % Gm::NJ, g = tid / Gm::NJ;
  const long long row = blockIdx.x;
  const long long b = row / a.H;
  const int h = static_cast<int>(row - b * a.H);
  const int nchunks = (a.T + TC - 1) / TC;
  auto col = [&](int n) { return Gm::template col<C, Gm::NJ>(jc, n); };
  Src src;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int es = x < 3 ? (int)sizeof(T) : 4;
    src.base[x] = static_cast<const char*>(x < 3 ? a.rkv[x] : a.w) +
                  (b * a.sB[x] + (long long)h * DH) * es;
    src.step[x] = a.sT[x] * es;
  }
  auto stage_chunk = [&](int ch) {
    if (ch < nchunks)
      stage<DH, T, VEC>(sm, src, ch * TC, min(TC, a.T - ch * TC),
                        ch % STAGES);
    cp_async_commit();  // an empty group past the end keeps the count
  };

  // the first chunks and u go first (a decode step's prepare pass needs
  // them before the state), then this thread's tile of the state: rows
  // g R .. g R + R - 1, columns col(n), whose loads stay in flight
  for (int ch = 0; ch < STAGES - 1; ++ch) stage_chunk(ch);
  const float ui =
      tid < DH ? a.u[b * a.u_sb + (long long)h * DH + tid] : 0.f;
  const float* s0 = a.s0 ? a.s0 + row * DH * DH : nullptr;
  float S[R][C];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = g * R + m;
#pragma unroll
    for (int n = 0; n < C; n += CV) {
      if constexpr (CV == 1) {
        S[m][n] = s0 ? s0[i * DH + col(n)] : 0.f;
      } else {
        const float4 q = s0 ? *reinterpret_cast<const float4*>(
                                  s0 + i * DH + col(n))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        S[m][n] = q.x;
        S[m][n + 1] = q.y;
        S[m][n + 2] = q.z;
        S[m][n + 3] = q.w;
      }
    }
  }
  if (tid < DH) sm.u[tid] = ui;
  float* y_row = a.y + b * a.y_sB + (long long)h * DH;

  for (int ch = 0; ch < nchunks; ++ch) {
    const int st = ch % STAGES, cnt = min(TC, a.T - ch * TC);
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk ch landed; chunk ch - 1 summed
    stage_chunk(ch + STAGES - 1);  // into the stage chunk ch - 1 left
    prepare<DH, T>(sm, st);
    __syncthreads();  // planes and c_t of chunk ch written

    const float* rp = sm.plane(st, 0) + g * R;
    const float* kp = sm.plane(st, 1) + g * R;
    const float* vp = sm.plane(st, 2);
    const float* wp = &sm.w[st][0][0] + g * R;
    auto load = [&](int t, Operands<R, C>& o) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        o.r[q] = reinterpret_cast<const float4*>(rp + t * DH)[q];
        o.k[q] = reinterpret_cast<const float4*>(kp + t * DH)[q];
        o.w[q] = reinterpret_cast<const float4*>(wp + t * DH)[q];
      }
#pragma unroll
      for (int n = 0; n < C; n += (C % 4 ? 1 : 4)) {
        if constexpr (C % 4) {
          o.v[n] = vp[t * DH + col(n)];
        } else {
          const float4 q =
              *reinterpret_cast<const float4*>(vp + t * DH + col(n));
          o.v[n] = q.x;
          o.v[n + 1] = q.y;
          o.v[n + 2] = q.z;
          o.v[n + 3] = q.w;
        }
      }
    };
    auto compute = [&](int t, const Operands<R, C>& o) {
      float acc[C];
#pragma unroll
      for (int n = 0; n < C; ++n) acc[n] = 0.f;
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float rr[4] = {o.r[q].x, o.r[q].y, o.r[q].z, o.r[q].w};
        const float kk[4] = {o.k[q].x, o.k[q].y, o.k[q].z, o.k[q].w};
        const float ww[4] = {o.w[q].x, o.w[q].y, o.w[q].z, o.w[q].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int n = 0; n < C; ++n) {
            float& s = S[4 * q + e][n];
            acc[n] = fmaf(rr[e], s, acc[n]);
            s = fmaf(ww[e], s, kk[e] * o.v[n]);
          }
        }
      }
      float* pt = &sm.part[t][g][0];
#pragma unroll
      for (int n = 0; n < C; n += (C % 4 ? 1 : 4)) {
        if constexpr (C % 4)
          pt[col(n)] = acc[n];
        else
          *reinterpret_cast<float4*>(pt + col(n)) =
              make_float4(acc[n], acc[n + 1], acc[n + 2], acc[n + 3]);
      }
    };
    // two operand sets in turn: token t + 1's are loaded while token t is
    // computed
    Operands<R, C> even, odd;
    if (cnt > 0) load(0, even);
    for (int t = 0; t < cnt; t += 2) {
      load(min(t + 1, cnt - 1), odd);
      compute(t, even);
      if (t + 1 == cnt) break;
      load(min(t + 2, cnt - 1), even);
      compute(t + 1, odd);
    }
    __syncthreads();  // every row group's partial sums of chunk ch written
    sum_chunk<DH, T>(sm, st, cnt, y_row + ch * TC * a.y_sT, a.y_sT);
  }
  float* so = a.s_out + row * DH * DH;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = g * R + m;
#pragma unroll
    for (int n = 0; n < C; n += CV) {
      if constexpr (CV == 1)
        so[i * DH + col(n)] = S[m][n];
      else
        *reinterpret_cast<float4*>(so + i * DH + col(n)) =
            make_float4(S[m][n], S[m][n + 1], S[m][n + 2], S[m][n + 3]);
    }
  }
}

template <int DH, typename T>
void launch(const Args& a, int BH, bool vec, cudaStream_t s) {
  if (vec)
    rwkv6_scan_kernel<DH, T, true><<<BH, Geo<DH>::NT, 0, s>>>(a);
  else
    rwkv6_scan_kernel<DH, T, false><<<BH, Geo<DH>::NT, 0, s>>>(a);
}

template <int DH>
void launch(const Args& a, int BH, bool bf16, bool vec, cudaStream_t s) {
  if (bf16)
    launch<DH, __nv_bfloat16>(a, BH, vec, s);
  else
    launch<DH, float>(a, BH, vec, s);
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers in
// the layouts above; s0 may be null (zero initial state) and may equal
// s_out.  `steps` is a host array of 11 element counts: sB and sT of r, k,
// v and w in turn, then u_sb, y's batch step and y's token step.  `bf16`
// says r, k and v are bfloat16 (else float32); `vec16` that every operand
// row and token, and both states, start on a 16-byte boundary (the caller
// checks).  The caller guarantees BH = B x H >= 1, H >= 1 and T >= 0.
// Returns cudaErrorInvalidValue for a DH other than 16 (the reduced
// configs) or 64 (rwkv6-7b), else cudaGetLastError() after the launch,
// which is asynchronous on `stream`.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, const long long* steps,
                          int BH, int H, int T, int DH, int bf16, int vec16,
                          void* stream) {
  Args a;
  a.rkv[0] = r;
  a.rkv[1] = k;
  a.rkv[2] = v;
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.s_out = static_cast<float*>(s_out);
  a.y = static_cast<float*>(y);
  for (int x = 0; x < 4; ++x) {
    a.sB[x] = steps[2 * x];
    a.sT[x] = steps[2 * x + 1];
  }
  a.u_sb = steps[8];
  a.y_sB = steps[9];
  a.y_sT = steps[10];
  a.H = H;
  a.T = T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 16: launch<16>(a, BH, bf16 != 0, vec16 != 0, s); break;
    case 64: launch<64>(a, BH, bf16 != 0, vec16 != 0, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
