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
constexpr int CK = 16;     // tokens between the state checkpoints
static_assert(CK % TC == 0, "a checkpoint falls on a chunk's start");

struct Args {
  const void* rkv[3];  // r, k, v: float or bfloat16
  const float* w;
  const float* u;
  const float* s0;     // may be null; may alias s_out
  float* s_out;
  float* y;
  float* ck;           // (B, H, ceil(T / CK), DH, DH) checkpoints, or null
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

template <int DH, typename T, bool VEC, bool SAVE>
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
    if constexpr (SAVE) {  // the state before token ch TC, every CK tokens
      if ((ch * TC) % CK == 0) {
        const int nck = (a.T + CK - 1) / CK;
        float* ck = a.ck + (row * nck + ch * TC / CK) * DH * DH;
#pragma unroll
        for (int m = 0; m < R; ++m) {
          const int i = g * R + m;
#pragma unroll
          for (int n = 0; n < C; n += CV) {
            if constexpr (CV == 1)
              ck[i * DH + col(n)] = S[m][n];
            else
              *reinterpret_cast<float4*>(ck + i * DH + col(n)) =
                  make_float4(S[m][n], S[m][n + 1], S[m][n + 2],
                              S[m][n + 3]);
          }
        }
      }
    }
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

template <int DH, typename T, bool SAVE>
void launch(const Args& a, int BH, bool vec, cudaStream_t s) {
  if (vec)
    rwkv6_scan_kernel<DH, T, true, SAVE><<<BH, Geo<DH>::NT, 0, s>>>(a);
  else
    rwkv6_scan_kernel<DH, T, false, SAVE><<<BH, Geo<DH>::NT, 0, s>>>(a);
}

template <int DH, typename T>
void launch(const Args& a, int BH, bool vec, cudaStream_t s) {
  if (a.ck)
    launch<DH, T, true>(a, BH, vec, s);
  else
    launch<DH, T, false>(a, BH, vec, s);
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
// s_out.  With `ck` not null (a gradient run) the state before tokens 0,
// CK, 2 CK, ... of row (b, h) is also written to ck[b, h, t / CK], a
// contiguous (B, H, ceil(T / CK), DH, DH) float32 tensor: a kernel
// instance of its own, so the serving launches run the code they ran.
// `steps` is a host array of 11 element counts: sB and sT of r, k, v and
// w in turn, then u_sb, y's batch step and y's token step.  `bf16`
// says r, k and v are bfloat16 (else float32); `vec16` that every operand
// row and token, and both states, start on a 16-byte boundary (the caller
// checks).  The caller guarantees BH = B x H >= 1, H >= 1 and T >= 0.
// Returns cudaErrorInvalidValue for a DH other than 16 (the reduced
// configs) or 64 (rwkv6-7b), else cudaGetLastError() after the launch,
// which is asynchronous on `stream`.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, void* ck,
                          const long long* steps, int BH, int H, int T,
                          int DH, int bf16, int vec16, void* stream) {
  Args a;
  a.rkv[0] = r;
  a.rkv[1] = k;
  a.rkv[2] = v;
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.s_out = static_cast<float*>(s_out);
  a.y = static_cast<float*>(y);
  a.ck = static_cast<float*>(ck);
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

// ---------------------------------------------------------------------------
// The backward pass: gradients of y and of the final state back to r, k, v,
// w, u and s0.  The reference has no backward Pallas kernel (JAX
// differentiates its `lax.scan`); this gives the card's forward the
// gradient the reference's model has.  For each row (b, h), with G_T =
// dL/dS_T (`ds`, zeros when null) and t = T .. 1:
//   dr_t[i] = sum_j dy_t[j] S_{t-1}[i][j] + u_i k_i e_t
//   dk_t[i] = sum_j G_t[i][j] v_j + r_i u_i e_t
//   dv_t[j] = sum_i G_t[i][j] k_i + c_t dy_j
// (e_t = sum_j dy_j v_j, c_t = sum_i r_i u_i k_i)
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]  += r_i k_i e_t
//   G_{t-1}[i][j] = w_i G_t[i][j] + r_i dy_j
// and ds0 = G_0.  S_{t-1} is never recovered by dividing by the decay: the
// forward kept the state every CK tokens (`ck`), and each interval of CK
// tokens, last first, is recomputed forward from its checkpoint, then
// walked in reverse.
//
// Layouts: r, k, v, w as the forward reads them (strided (B, T, H, DH)
// views, steps in `steps`); u as the forward's; dy, dr, dk, dv, dw
// contiguous (B, T, H, DH), dy and dw float32, dr, dk, dv in r's type
// (summed in float32, rounded once); ck (B, H, ceil(T / CK), DH, DH);
// ds, ds0 (B, H, DH, DH); du (B, H, DH), each row's own bonus gradient
// (the caller sums it over b for a shared bonus: no float atomics, so two
// runs give the same bits).  No scratch in device memory.
//
// What bounds it on this card (roofline/kernel_model.py
// `wkv_bwd_bound_ms`): per (row, token, i, j) the recompute of the state
// and the reverse walk's multiply-adds (dr, dw, dk and dv partial sums,
// G's update), ~13 flops at 67 TFLOP/s float32, against the bytes of r,
// k, v, w, dy, the checkpoints and the five gradients, each moved once.
// rwkv6-7b's training microbatch (B 2, T 256, H 64, DH 64, bf16) is 1.7
// GFLOP -> ~26 us against ~84 MB -> ~25 us: the two bounds are close, and
// the recurrence is sequential in t.  Device memory is not what this
// kernel waits on: it issues the walk's 6 float32 operations per (row,
// token, i, j), ~1.9 state updates of 2 (the recompute, and the odd
// states again in the walk), the sums across lanes and the loads and
// stores of shared memory that feed them.
//
// Design.  A row (b, h) is a cluster of P CTAs (`BwdGeo`: P = 2 at DH =
// 64, so 256 CTAs at the training shape, two an SM, one wave; P = 1 at
// DH = 16).  CTA q owns the value columns q JW .. q JW + JW - 1 of S and
// G (JW = DH / P) and key rows q JW .. of dr, dk, dw and du.  G's update,
// S's recompute and dv's key sum only ever touch a CTA's own columns;
// each CTA stages the chunk's whole rows of r, k, w (and its columns of
// v, dy) and sums c_t itself, in the same order as the others.  A thread
// keeps a 2 x C tile of G in registers for the whole sequence (key rows
// 2 g, 2 g + 1; C = 8 float4 columns at DH = 64), four lanes a row pair,
// 128 threads a CTA (8 warps an SM).  The chunk's recomputed states stay
// in shared memory (`hist`, each thread's own tile, read back by the same
// thread): each CK = 16-token interval is walked in two halves of 8
// tokens -- recompute through the first half without keeping it, keep
// and walk the later half, then recompute and walk the first -- and only
// the states before the even tokens are kept; the walk recomputes the
// one before an odd token from the even one below it, whose operands it
// loads anyway.  That halves the state's shared-memory traffic and keeps
// a CTA at 81.5 KB (bf16; 86.7 KB float32).  The walk is pipelined: a
// token's sums across lanes are interleaved with the next token's
// multiply-adds.  The row sums over j go in two steps: a thread's C
// columns, then its row pair's four lanes (jc ^ 1, even lanes keeping row
// 2 g's, odd ones 2 g + 1's; then jc ^ 2), written a float4 a row (dr,
// dk, dw) into the CTA's own shared memory (`xch`, two halves in turn);
// after a cluster barrier, CTA q adds rows q JW .. from CTAs 0 .. P - 1
// in rank order (the other CTAs' through distributed shared memory), and
// the CTAs' shares of e_t the same way, adds the u e_t terms and writes.
// The barrier is arrived at after a walk and waited on only after the
// next half's recompute.  dv's key sums are halved over the warp's row
// groups (lanes ^ 4, ^ 8, ^ 16), then added over the warps in order.
// Every sum has a fixed order and there are no float atomics, so two
// launches give the same bits.  A chunk's operands are staged one chunk
// ahead of the walk with `cp.async`, 16-byte pieces where every operand
// row and token starts on a 16-byte boundary (`VEC`), element copies
// otherwise (4-byte `cp.async`; bfloat16 loaded and stored, cp.async has
// no 2-byte piece), into a staging buffer that a prepare pass widens into
// float32 planes; each thread's pieces follow from its index and
// compile-time shapes.
namespace {

constexpr int HALF = CK / 2;  // tokens whose states a walk keeps at once

struct BwdArgs {
  const void* rkv[3];  // r, k, v: float or bfloat16
  const float* w;
  const float* u;
  const float* ck;
  const float* dy;
  const float* ds;     // may be null
  void* d_rkv[3];      // dr, dk, dv in r's type
  float* dw;
  float* du;
  float* ds0;
  long long sB[4], sT[4];  // r, k, v, w: batch-row and token steps (elements)
  long long u_sb;
  int H, T;
};

// A row's cluster and a CTA's threads: P CTAs a row, JW value columns
// (and key rows of dr, dk, dw, du) a CTA, an R x C tile a thread with the
// NJ column groups as the fastest lanes and the row groups above them;
// TPT threads a token of EPT elements each in the prepare pass; SPT
// threads share a column (or key row) in the passes after a walk, PS
// half-chunk slots each; XT floats a token of the sums the cluster
// exchanges (dr, dk, dw of every key row a float4, then the CTA's share
// of e_t).
template <int DH>
struct BwdGeo {
  static constexpr int P = DH == 64 ? 2 : 1;
  static constexpr int JW = DH / P;
  static constexpr int NJ = 4;
  static constexpr int R = 2, C = JW / NJ;
  static constexpr int CV = C / 4;            // float4s of a tile row
  static constexpr int G = DH / R;            // row groups
  static constexpr int NT = NJ * G;           // threads a CTA
  static constexpr int NW = NT / 32;          // warps a CTA
  static constexpr int TPT = NT / CK;
  static constexpr int EPT = DH / TPT;
  static constexpr int SPT = NT / JW;
  static constexpr int PS = HALF / SPT;
  static constexpr int XT = 4 * DH + 4;
  static constexpr int MIN_CTAS = DH == 64 ? 2 : 4;  // an SM, bf16
  static_assert(C % 4 == 0 && C <= 8 && EPT == 8 && NT % 32 == 0 &&
                    TPT <= 32 && NT % DH == 0 && NT % JW == 0 &&
                    HALF % SPT == 0 && JW % EPT == 0,
                "geometry");
};

template <int DH, typename T>
struct BwdSmem {
  using Gm = BwdGeo<DH>;
  T x[2][CK][DH];                           // r, k as staged
  T xv[CK][Gm::JW];                         // v's columns of the CTA
  float w[CK][DH];                          // w as staged
  float dy[CK][Gm::JW];                     // dy's columns of the CTA
  float r_[CK][DH], k_[CK][DH], w_[CK][DH]; // the chunk in float32
  float v_[CK][Gm::JW], dy_[CK][Gm::JW];
  float4 hist[HALF / 2][Gm::R][Gm::CV][Gm::NT];  // S before the even slots
  float xch[2][HALF][Gm::XT];               // the exchanged sums, by turns
  float dvw[HALF][Gm::NW][Gm::JW];          // each warp's dv
  float u[DH];
  float c[CK];                              // sum_i r_i u_i k_i
  float e[CK];                              // the CTA's share of e_t
};

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// eight consecutive elements of shared memory, widened to float32
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&o)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    o[2 * q] = f.x;
    o[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&o)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(o[4], o[5], o[6], o[7]);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Stage tokens [t0, t0 + n) of one operand (element type E, W elements a
// token) into dst, token t at dst + t W: a thread's 16-byte `cp.async`
// pieces fixed by its index when VEC, else its elements (column tid % W,
// every NT / W-th token) by 4-byte `cp.async`, or for bfloat16 loaded
// together, then stored.
template <int W, int NT, typename E, bool VEC>
__device__ __forceinline__ void stage_rows(E* dst, const char* base,
                                           long long step, int t0, int n) {
  if constexpr (VEC) {
    constexpr int EPP = 16 / sizeof(E);  // elements a piece
    constexpr int PER = W / EPP;         // pieces a token
    constexpr int ALL = CK * PER;
#pragma unroll
    for (int k = 0; k < (ALL + NT - 1) / NT; ++k) {
      const int p = threadIdx.x + k * NT;
      const int t = p / PER, i = (p % PER) * EPP;
      if ((ALL % NT == 0 || p < ALL) && t < n)
        cp_async16(dst + t * W + i,
                   base + (t0 + t) * step + i * (int)sizeof(E));
    }
  } else {
    constexpr int TS = NT / W;  // tokens a round
    static_assert(NT % W == 0 && CK % TS == 0, "whole rounds");
    const int i = threadIdx.x % W, t1 = threadIdx.x / W;
    if constexpr (sizeof(E) == 4) {
#pragma unroll
      for (int k = 0; k < CK / TS; ++k)
        if (t1 + k * TS < n)
          cp_async4(dst + (t1 + k * TS) * W + i,
                    base + (t0 + t1 + k * TS) * step + i * 4);
    } else {  // cp.async takes no 2-byte piece
      E got[CK / TS];
#pragma unroll
      for (int k = 0; k < CK / TS; ++k)
        if (t1 + k * TS < n)
          got[k] = reinterpret_cast<const E*>(
              base + (t0 + t1 + k * TS) * step)[i];
#pragma unroll
      for (int k = 0; k < CK / TS; ++k)
        if (t1 + k * TS < n) dst[(t1 + k * TS) * W + i] = got[k];
    }
  }
}

// The cluster barrier in two halves (arrive releases this thread's writes,
// wait acquires every thread's of the cluster), the CTA's rank in its
// cluster, and where a shared variable lies in another CTA of the cluster.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ const float* map_rank(const float* p, int rank) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
  return reinterpret_cast<const float*>(out);
}

// A walk token's operands of a thread: r, k, w of its R rows, v and dy of
// its C columns, and its tile of S_{t-1}.
template <int CV>
struct WalkOps {
  float2 r, k, w;
  float4 v[CV], d[CV], s[2][CV];
};

template <int DH, typename T, bool VEC>
__global__ void __launch_bounds__(BwdGeo<DH>::NT, BwdGeo<DH>::MIN_CTAS)
    rwkv6_scan_bwd_kernel(const BwdArgs a) {
  using Gm = BwdGeo<DH>;
  constexpr int P = Gm::P, JW = Gm::JW, R = Gm::R, C = Gm::C, CV = Gm::CV,
                NT = Gm::NT, SPT = Gm::SPT, PS = Gm::PS;
  static_assert(R == 2, "a tile's rows are a float2");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<DH, T>& sm = *reinterpret_cast<BwdSmem<DH, T>*>(smem_raw);
  const int q = cluster_rank();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int jc = tid % Gm::NJ, g = tid / Gm::NJ;
  const int i0 = R * g;         // the thread's key rows i0, i0 + 1
  const int jl = C * jc;        // its first column among the CTA's,
  const int j0 = q * JW + jl;   // and in the row
  const int pj = tid % JW, ps0 = tid / JW;  // after a walk: column or
                                            // key row q JW + pj, slot ps0..
  const long long row = blockIdx.x / P;
  const long long b = row / a.H;
  const int h = static_cast<int>(row - b * a.H);
  const int nck = (a.T + CK - 1) / CK;
  // row (b, h)'s first element and token step in the contiguous tensors
  const long long tok0 = (b * a.T * a.H + h) * DH;
  const long long tstep = static_cast<long long>(a.H) * DH;
  const char* base[5];  // r, k, v, w, dy: the staged row's start and step
  long long step[5];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int es = x < 3 ? (int)sizeof(T) : 4;
    base[x] = static_cast<const char*>(x < 3 ? a.rkv[x] : a.w) +
              (b * a.sB[x] + static_cast<long long>(h) * DH +
               (x == 2 ? q * JW : 0)) *
                  es;
    step[x] = a.sT[x] * es;
  }
  base[4] = reinterpret_cast<const char*>(a.dy + tok0 + q * JW);
  step[4] = tstep * 4;
  T* dr = static_cast<T*>(a.d_rkv[0]) + tok0;
  T* dk = static_cast<T*>(a.d_rkv[1]) + tok0;
  T* dv = static_cast<T*>(a.d_rkv[2]) + tok0 + q * JW;
  float* dw = a.dw + tok0;

  auto stage_chunk = [&](int c) {
    const int t0 = c * CK, n = min(CK, a.T - t0);
#pragma unroll
    for (int x = 0; x < 2; ++x)
      stage_rows<DH, NT, T, VEC>(&sm.x[x][0][0], base[x], step[x], t0, n);
    stage_rows<JW, NT, T, VEC>(&sm.xv[0][0], base[2], step[2], t0, n);
    stage_rows<DH, NT, float, VEC>(&sm.w[0][0], base[3], step[3], t0, n);
    stage_rows<JW, NT, float, VEC>(&sm.dy[0][0], base[4], step[4], t0, n);
    cp_async_commit();
  };
  // the thread's tile (rows i0.., columns j0..) of a (DH, DH) state
  auto load_tile = [&](const float* s, float (&X)[R][C]) {
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const float* p = s + (i0 + m) * DH + j0;
#pragma unroll
      for (int n = 0; n < C; n += 4) {
        if constexpr (VEC) {
          const float4 q4 = *reinterpret_cast<const float4*>(p + n);
          X[m][n] = q4.x; X[m][n + 1] = q4.y;
          X[m][n + 2] = q4.z; X[m][n + 3] = q4.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) X[m][n + k] = p[n + k];
        }
      }
    }
  };
  // The prepare pass: thread (tt, l) widens elements l EPT .. of token
  // tt's r, k, w (and of the CTA's columns of v, dy) into the float32
  // planes and adds its shares of c_t and of the CTA's e_t; the TPT
  // threads of a token add their shares in a fixed xor order (c_t the same
  // in every CTA of the cluster).
  auto prepare = [&]() {
    const int tt = tid / Gm::TPT, l = tid % Gm::TPT, i = l * Gm::EPT;
    float rf[8], kf[8], wf[8];
    load8(&sm.x[0][tt][i], rf);
    load8(&sm.x[1][tt][i], kf);
    load8(&sm.w[tt][i], wf);
    float cs = 0.f, es = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) cs = fmaf(rf[n], sm.u[i + n] * kf[n], cs);
    store8(&sm.r_[tt][i], rf);
    store8(&sm.k_[tt][i], kf);
    store8(&sm.w_[tt][i], wf);
    if (i < JW) {
      float vf[8], df[8];
      load8(&sm.xv[tt][i], vf);
      load8(&sm.dy[tt][i], df);
#pragma unroll
      for (int n = 0; n < 8; ++n) es = fmaf(df[n], vf[n], es);
      store8(&sm.v_[tt][i], vf);
      store8(&sm.dy_[tt][i], df);
    }
#pragma unroll
    for (int o = 1; o < Gm::TPT; o *= 2) {
      cs += __shfl_xor_sync(0xffffffffu, cs, o);
      es += __shfl_xor_sync(0xffffffffu, es, o);
    }
    if (l == 0) {
      sm.c[tt] = cs;
      sm.e[tt] = es;
    }
  };
  // S_t from S_{t-1} with token t's k, w (rows i0..) and v (columns jl..):
  // the forward's arithmetic, so the states are its bits.  A token's
  // operands are loaded before the previous state is kept, so the loads
  // never wait behind the stores.
  struct StepOps {
    float2 k, w;
    float4 v[CV];
  };
  auto step_ops = [&](int t) {
    StepOps o;
    o.k = *reinterpret_cast<const float2*>(&sm.k_[t][i0]);
    o.w = *reinterpret_cast<const float2*>(&sm.w_[t][i0]);
#pragma unroll
    for (int n = 0; n < CV; ++n)
      o.v[n] = *reinterpret_cast<const float4*>(&sm.v_[t][jl + 4 * n]);
    return o;
  };
  auto advance = [&](const StepOps& o, float (&S)[R][C]) {
    const float kk[2] = {o.k.x, o.k.y}, ww[2] = {o.w.x, o.w.y};
    float vv[C];
#pragma unroll
    for (int n = 0; n < CV; ++n) {
      vv[4 * n] = o.v[n].x; vv[4 * n + 1] = o.v[n].y;
      vv[4 * n + 2] = o.v[n].z; vv[4 * n + 3] = o.v[n].w;
    }
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int n = 0; n < C; ++n) S[m][n] = fmaf(ww[m], S[m][n], kk[m] * vv[n]);
  };
  auto keep = [&](int s, const float (&S)[R][C]) {
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int n = 0; n < CV; ++n)
        sm.hist[s][m][n][tid] = make_float4(S[m][4 * n], S[m][4 * n + 1],
                                            S[m][4 * n + 2], S[m][4 * n + 3]);
  };
  // From the checkpoint, advance through `skip` tokens (0 or HALF) without
  // keeping them, then keep the states before the even ones of the next n
  // tokens (the walk recomputes those before the odd ones).
  auto recompute = [&](const float (&ck)[R][C], int skip, int n) {
    float S[R][C];
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int k = 0; k < C; ++k) S[m][k] = ck[m][k];
    if (skip) {
#pragma unroll
      for (int t = 0; t < HALF; ++t) advance(step_ops(t), S);
    }
    StepOps o[2];
    o[0] = step_ops(skip);
    auto kept = [&](int s, int nn, int cur) {
      o[cur ^ 1] = step_ops(skip + min(s + 1, nn - 1));
      if (!(s & 1)) keep(s / 2, S);
      if (s + 1 < nn) advance(o[cur], S);
    };
    if (n == HALF) {
#pragma unroll
      for (int s = 0; s < HALF; ++s) kept(s, HALF, s & 1);
    } else {
      for (int s = 0; s < n; s += 2) {
        kept(s, n, 0);
        if (s + 1 < n) kept(s + 1, n, 1);
      }
    }
  };

  float Gt[R][C];
  if (a.ds) {
    load_tile(a.ds + row * DH * DH, Gt);
  } else {
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int n = 0; n < C; ++n) Gt[m][n] = 0.f;
  }
  auto load_ops = [&](int t, WalkOps<CV>& o) {
    o.r = *reinterpret_cast<const float2*>(&sm.r_[t][i0]);
    o.k = *reinterpret_cast<const float2*>(&sm.k_[t][i0]);
    o.w = *reinterpret_cast<const float2*>(&sm.w_[t][i0]);
#pragma unroll
    for (int n = 0; n < CV; ++n) {
      o.v[n] = *reinterpret_cast<const float4*>(&sm.v_[t][jl + 4 * n]);
      o.d[n] = *reinterpret_cast<const float4*>(&sm.dy_[t][jl + 4 * n]);
    }
  };
  // the state before slot s: kept for an even slot; for an odd one, the
  // even slot's state advanced by the even slot's token (`even`, whose
  // operands and state are loaded too)
  auto load_state = [&](int s, WalkOps<CV>& o) {
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int n = 0; n < CV; ++n) o.s[m][n] = sm.hist[s / 2][m][n][tid];
  };
  auto advance_state = [&](const WalkOps<CV>& even, WalkOps<CV>& o) {
    float S[R][C];
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int n = 0; n < CV; ++n) {
        S[m][4 * n] = even.s[m][n].x; S[m][4 * n + 1] = even.s[m][n].y;
        S[m][4 * n + 2] = even.s[m][n].z; S[m][4 * n + 3] = even.s[m][n].w;
      }
    StepOps st;
    st.k = even.k;
    st.w = even.w;
#pragma unroll
    for (int n = 0; n < CV; ++n) st.v[n] = even.v[n];
    advance(st, S);
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int n = 0; n < CV; ++n)
        o.s[m][n] = make_float4(S[m][4 * n], S[m][4 * n + 1],
                                S[m][4 * n + 2], S[m][4 * n + 3]);
  };
  auto unpack = [](const float4 (&q)[CV], float (&f)[C]) {
#pragma unroll
    for (int n = 0; n < CV; ++n) {
      f[4 * n] = q[n].x; f[4 * n + 1] = q[n].y;
      f[4 * n + 2] = q[n].z; f[4 * n + 3] = q[n].w;
    }
  };
  // The reverse walk, one token (slot s of the half, token t of the
  // chunk) at a time: the partial sums over the thread's tile, then
  // G_{t-1}; then the sums across lanes, written for the passes after the
  // walk.  The row sums (dr, dk, dw of rows i0, i0 + 1) are added over
  // lane jc ^ 1 (even lanes keep row i0's, odd i0 + 1's), then jc ^ 2, and
  // written by lanes jc = 0, 1 into xch[buf]; dv's sums over the warp's 8
  // row groups by halving (lanes ^ 4, ^ 8, ^ 16: each keeps half its
  // columns and adds the other lane's) into dvw; lane 0 copies the CTA's
  // share of e_t.  The shuffles of token s are interleaved with the
  // multiply-adds of token s - 1 (two rows, one between each level), so
  // that neither waits on the other.
  struct Part {
    float x[6];  // dr, dk, dw of row i0, then of row i0 + 1
    float pv[C];
  };
  auto compute_row = [&](int m, const WalkOps<CV>& o, Part& p) {
    float vv[C], dd[C], sp[C];
    unpack(o.v, vv);
    unpack(o.d, dd);
    unpack(o.s[m], sp);
    const float rm = m ? o.r.y : o.r.x, km = m ? o.k.y : o.k.x;
    const float wm = m ? o.w.y : o.w.x;
    float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
    for (int n = 0; n < C; ++n) {
      pr = fmaf(dd[n], sp[n], pr);
      pw = fmaf(Gt[m][n], sp[n], pw);
      pk = fmaf(Gt[m][n], vv[n], pk);
      p.pv[n] = m ? fmaf(Gt[m][n], km, p.pv[n]) : Gt[m][n] * km;
    }
#pragma unroll
    for (int n = 0; n < C; ++n) Gt[m][n] = fmaf(wm, Gt[m][n], rm * dd[n]);
    p.x[3 * m] = pr;
    p.x[3 * m + 1] = pk;
    p.x[3 * m + 2] = pw;
  };
  // keep half of pv's first 2 cnt columns, adding lane ^ bit's other half
  auto halve = [&](float (&pv)[C], int cnt, int bit) {
    const bool hi = lane & bit;
#pragma unroll
    for (int n = 0; n < C / 2; ++n)
      if (n < cnt) {
        const float give = hi ? pv[n] : pv[n + cnt];
        pv[n] = (hi ? pv[n + cnt] : pv[n]) +
                __shfl_xor_sync(0xffffffffu, give, bit);
      }
  };
  auto reduce1 = [&](Part& p) {
    const bool odd = jc & 1;
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      const float give = odd ? p.x[n] : p.x[n + 3];
      p.x[n] = (odd ? p.x[n + 3] : p.x[n]) +
               __shfl_xor_sync(0xffffffffu, give, 1);
    }
    halve(p.pv, C / 2, 4);
  };
  auto reduce2 = [&](Part& p) {
#pragma unroll
    for (int n = 0; n < 3; ++n)
      p.x[n] += __shfl_xor_sync(0xffffffffu, p.x[n], 2);
    halve(p.pv, C / 4, 8);
  };
  auto reduce3 = [&](Part& p, int t, int s, int buf) {
    if constexpr (C == 8)
      halve(p.pv, 1, 16);
    else
      p.pv[0] += __shfl_xor_sync(0xffffffffu, p.pv[0], 16);
    float* xs = &sm.xch[buf][s][0];
    if (jc < 2)
      *reinterpret_cast<float4*>(xs + 4 * (i0 + jc)) =
          make_float4(p.x[0], p.x[1], p.x[2], 0.f);
    if (tid == 0) xs[4 * DH] = sm.e[t];
    const int col = (lane & 4 ? C / 2 : 0) + (lane & 8 ? C / 4 : 0) +
                    (C == 8 && (lane & 16) ? 1 : 0);
    if (C == 8 || !(lane & 16)) sm.dvw[s][warp][jl + col] = p.pv[0];
  };
  // Walk tokens base + n - 1 .. base of the chunk (states of the even
  // slots in hist[0, n / 2)).  A full half is pipelined: an odd token's
  // operands are loaded with the even token's below it (and that token's
  // kept state), while the previous token's sums are reduced.
  auto walk = [&](int base_t, int n, int buf) {
    Part p[2];
    if (n == HALF) {
      WalkOps<CV> oo, oe;  // the odd and even tokens of a pair
      auto load_pair = [&](int s) {  // s odd
        load_ops(base_t + s, oo);
        load_ops(base_t + s - 1, oe);
        load_state(s - 1, oe);
      };
      load_pair(HALF - 1);
      advance_state(oe, oo);
      compute_row(0, oo, p[0]);
      compute_row(1, oo, p[0]);
#pragma unroll
      for (int s = HALF - 1; s >= 0; --s) {
        const int cur = (HALF - 1 - s) & 1;
        const bool odd_next = s > 0 && ((s - 1) & 1);
        if (odd_next) load_pair(s - 1);
        reduce1(p[cur]);
        if (odd_next) advance_state(oe, oo);
        const WalkOps<CV>& nx = odd_next ? oo : oe;
        if (s > 0) compute_row(0, nx, p[cur ^ 1]);
        reduce2(p[cur]);
        if (s > 0) compute_row(1, nx, p[cur ^ 1]);
        reduce3(p[cur], base_t + s, s, buf);
      }
    } else {
      for (int s = n - 1; s >= 0; --s) {
        WalkOps<CV> o;
        load_ops(base_t + s, o);
        if (s & 1) {
          WalkOps<CV> even;
          load_ops(base_t + s - 1, even);
          load_state(s - 1, even);
          advance_state(even, o);
        } else {
          load_state(s, o);
        }
        compute_row(0, o, p[0]);
        compute_row(1, o, p[0]);
        reduce1(p[0]);
        reduce2(p[0]);
        reduce3(p[0], base_t + s, s, buf);
      }
    }
  };

  // After a walk: dv of the CTA's column pj at the thread's slots (the
  // warps' sums in order, then c_t dy_j), and the plane terms its key row
  // q JW + pj needs once the cluster's sums are in.  The dv values are
  // stored after the cluster barrier is arrived at (`store_dv`), so that
  // the barrier's release does not wait on them.
  float pre[PS][3];  // u_i k_i, r_i u_i, r_i k_i at the slots
  float dvs[PS];
  auto finish_dv = [&](int base_t, int n) {
#pragma unroll
    for (int ps = 0; ps < PS; ++ps) {
      const int s = ps0 + ps * SPT, t = base_t + s;
      if (s < n) {
        float p = sm.dvw[s][0][pj];
#pragma unroll
        for (int w = 1; w < Gm::NW; ++w) p += sm.dvw[s][w][pj];
        dvs[ps] = fmaf(sm.c[t], sm.dy_[t][pj], p);
        const int i = q * JW + pj;
        const float ui = sm.u[i], ri = sm.r_[t][i], ki = sm.k_[t][i];
        pre[ps][0] = ui * ki;
        pre[ps][1] = ri * ui;
        pre[ps][2] = ri * ki;
      }
    }
  };
  auto store_dv = [&](int t0, int base_t, int n) {
#pragma unroll
    for (int ps = 0; ps < PS; ++ps) {
      const int s = ps0 + ps * SPT;
      if (s < n) dv[(t0 + base_t + s) * tstep + pj] = narrow<T>(dvs[ps]);
    }
  };
  // Once every CTA's sums of a half are in: dr, dk, dw of key row q JW +
  // pj at the thread's slots, the CTAs' sums (and e_t's shares) added in
  // rank order, and this thread's share of du.
  float du = 0.f;
  const float* xch_of[P];  // every CTA's xch, as this thread reaches it
#pragma unroll
  for (int rk = 0; rk < P; ++rk) xch_of[rk] = map_rank(&sm.xch[0][0][0], rk);
  auto finish_rows = [&](int t0, int base_t, int n, int buf) {
    const int i = q * JW + pj;
#pragma unroll
    for (int ps = 0; ps < PS; ++ps) {
      const int s = ps0 + ps * SPT;
      if (s < n) {
        float acc[3] = {0.f, 0.f, 0.f}, e = 0.f;
#pragma unroll
        for (int rk = 0; rk < P; ++rk) {
          const float* xr =
              (rk == q ? &sm.xch[0][0][0] : xch_of[rk]) +
              (buf * HALF + s) * Gm::XT;
          const float4 x4 = *reinterpret_cast<const float4*>(xr + 4 * i);
          acc[0] += x4.x;
          acc[1] += x4.y;
          acc[2] += x4.z;
          e += xr[4 * DH];
        }
        const long long at = (t0 + base_t + s) * tstep + i;
        dr[at] = narrow<T>(fmaf(pre[ps][0], e, acc[0]));
        dk[at] = narrow<T>(fmaf(pre[ps][1], e, acc[1]));
        dw[at] = acc[2];
        du = fmaf(pre[ps][2], e, du);
      }
    }
  };
  // A half's row sums are finished after the next half's recompute: the
  // cluster barrier arrived at after a walk is waited on only then.
  bool pending = false;
  int p_t0 = 0, p_base = 0, p_n = 0, p_buf = 0, buf = 0;
  auto finish_pending = [&]() {
    if (pending) {
      cluster_wait();  // every CTA's sums of the pending half are written
      finish_rows(p_t0, p_base, p_n, p_buf);
      pending = false;
    }
  };
  auto half = [&](int t0, int base_t, int n) {
    finish_pending();
    walk(base_t, n, buf);
    __syncthreads();  // every warp's dv sums of the half are written
    finish_dv(base_t, n);
    cluster_arrive();
    store_dv(t0, base_t, n);
    pending = true;
    p_t0 = t0;
    p_base = base_t;
    p_n = n;
    p_buf = buf;
    buf ^= 1;
  };

  if (nck > 0) stage_chunk(nck - 1);
  if (tid < DH)
    sm.u[tid] = a.u[b * a.u_sb + static_cast<long long>(h) * DH + tid];
  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * CK, cnt = min(CK, a.T - t0);
    cp_async_wait<0>();
    __syncthreads();  // chunk c staged; chunk c + 1's planes all read
    prepare();
    __syncthreads();  // the planes, c_t and e_t written; staging free
    float ck[R][C];
    load_tile(a.ck + (row * nck + c) * DH * DH, ck);
    if (cnt > HALF) {  // the later half first
      recompute(ck, HALF, cnt - HALF);
      half(t0, HALF, cnt - HALF);
    }
    // chunk c - 1 lands while the first half is walked; staged only after
    // the later half's barrier arrive, which would wait on its loads
    if (c > 0) stage_chunk(c - 1);
    recompute(ck, 0, min(cnt, HALF));
    half(t0, 0, min(cnt, HALF));
  }
  finish_pending();
  cluster_arrive();
  cluster_wait();  // no CTA leaves while another reads its sums
  float* so = a.ds0 + row * DH * DH;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    float* p = so + (i0 + m) * DH + j0;
#pragma unroll
    for (int n = 0; n < C; n += 4) {
      if constexpr (VEC) {
        *reinterpret_cast<float4*>(p + n) = make_float4(
            Gt[m][n], Gt[m][n + 1], Gt[m][n + 2], Gt[m][n + 3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) p[n + k] = Gt[m][n + k];
      }
    }
  }
  // du of key row q JW + pj: the SPT threads' shares in order
  float* dus = &sm.dvw[0][0][0];
  dus[ps0 * JW + pj] = du;
  __syncthreads();
  if (tid < JW) {
    float sum = dus[tid];
#pragma unroll
    for (int k = 1; k < SPT; ++k) sum += dus[k * JW + tid];
    a.du[row * DH + q * JW + tid] = sum;
  }
}

template <int DH, typename T, bool VEC>
cudaError_t bwd_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                       int BH, cudaStream_t s) {
  using Gm = BwdGeo<DH>;
  constexpr int bytes = static_cast<int>(sizeof(BwdSmem<DH, T>));
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = Gm::P;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(BH * Gm::P));
  cfg.blockDim = dim3(Gm::NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaFuncSetAttribute(rwkv6_scan_bwd_kernel<DH, T, VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int DH, typename T, bool VEC>
int launch_bwd(const BwdArgs& a, int BH, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = bwd_config<DH, T, VEC>(cfg, attr, BH, s);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, rwkv6_scan_bwd_kernel<DH, T, VEC>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// P, threads a CTA, dynamic shared memory, CTAs an SM holds, clusters the
// card holds at once, registers a thread, local memory a thread (spills).
template <int DH, typename T, bool VEC>
int bwd_geometry(int* out) {
  auto kern = rwkv6_scan_bwd_kernel<DH, T, VEC>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = bwd_config<DH, T, VEC>(cfg, attr, 1, nullptr);
  int per_sm = 0, clusters = 0;
  cudaFuncAttributes fa;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, BwdGeo<DH>::NT, cfg.dynamicSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = BwdGeo<DH>::P;
  out[1] = BwdGeo<DH>::NT;
  out[2] = static_cast<int>(cfg.dynamicSmemBytes);
  out[3] = per_sm;
  out[4] = clusters;
  out[5] = fa.numRegs;
  out[6] = static_cast<int>(fa.localSizeBytes);
  return 0;
}

template <int DH, typename T>
int bwd_dispatch(const BwdArgs* a, int BH, bool vec, cudaStream_t s,
                 int* out) {
  if (out) return vec ? bwd_geometry<DH, T, true>(out)
                      : bwd_geometry<DH, T, false>(out);
  return vec ? launch_bwd<DH, T, true>(*a, BH, s)
             : launch_bwd<DH, T, false>(*a, BH, s);
}

template <int DH>
int bwd_dispatch(const BwdArgs* a, int BH, bool bf16, bool vec,
                 cudaStream_t s, int* out) {
  return bf16 ? bwd_dispatch<DH, __nv_bfloat16>(a, BH, vec, s, out)
              : bwd_dispatch<DH, float>(a, BH, vec, s, out);
}

int bwd_dispatch(const BwdArgs* a, int BH, int DH, int bf16, int vec16,
                 cudaStream_t s, int* out) {
  switch (DH) {
    case 16: return bwd_dispatch<16>(a, BH, bf16 != 0, vec16 != 0, s, out);
    case 64: return bwd_dispatch<64>(a, BH, bf16 != 0, vec16 != 0, s, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point of the backward pass, bound with ctypes.  Pointers are
// device pointers in the layouts above; ds may be null (no gradient on the
// final state).  `steps` is a host array of 9 element counts: sB and sT of
// r, k, v and w in turn, then u_sb.  `vec16` says every operand row and
// token, dy, ck and ds start on 16-byte boundaries (the caller checks).
// The caller guarantees BH = B x H >= 1, H >= 1, T >= 0 and that ck holds
// ceil(T / CK) states a row.  Returns cudaErrorInvalidValue for a DH other
// than 16 or 64, else the error of the shared-memory attribute or of the
// cluster launch (a card that cannot place the cluster refuses it), which
// is asynchronous on `stream`.
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* ck,
                              const void* dy, const void* ds, void* dr,
                              void* dk, void* dv, void* dw, void* du,
                              void* ds0, const long long* steps, int BH,
                              int H, int T, int DH, int bf16, int vec16,
                              void* stream) {
  BwdArgs a;
  a.rkv[0] = r;
  a.rkv[1] = k;
  a.rkv[2] = v;
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.ck = static_cast<const float*>(ck);
  a.dy = static_cast<const float*>(dy);
  a.ds = static_cast<const float*>(ds);
  a.d_rkv[0] = dr;
  a.d_rkv[1] = dk;
  a.d_rkv[2] = dv;
  a.dw = static_cast<float*>(dw);
  a.du = static_cast<float*>(du);
  a.ds0 = static_cast<float*>(ds0);
  for (int x = 0; x < 4; ++x) {
    a.sB[x] = steps[2 * x];
    a.sT[x] = steps[2 * x + 1];
  }
  a.u_sb = steps[8];
  a.H = H;
  a.T = T;
  return bwd_dispatch(&a, BH, DH, bf16, vec16,
                      static_cast<cudaStream_t>(stream), nullptr);
}

// The backward kernel instance's geometry on this card, into out[7]: P
// (CTAs a row), threads a CTA, dynamic shared memory bytes, CTAs an SM
// holds, clusters the card holds at once, registers a thread and local
// memory bytes a thread.  Returns a CUDA error code, 0 on success.
extern "C" int rwkv6_scan_bwd_geometry(int DH, int bf16, int vec16,
                                       int* out) {
  return bwd_dispatch(nullptr, 1, DH, bf16, vec16, nullptr, out);
}
