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
// forward kept the state every CK tokens (`ck`), and each chunk of CK
// tokens, last chunk first, is recomputed forward from its checkpoint into
// a per-row scratch (`hist`, CK states), then walked in reverse.
//
// Layouts: r, k, v, w as the forward reads them (strided (B, T, H, DH)
// views, steps in `steps`); u as the forward's; dy, dr, dk, dv, dw
// contiguous (B, T, H, DH), dy and dw float32, dr, dk, dv in r's type
// (summed in float32, rounded once); ck (B, H, ceil(T / CK), DH, DH);
// ds, ds0 (B, H, DH, DH); du (B, H, DH), each row's own bonus gradient
// (the caller sums it over b for a shared bonus: no float atomics, so two
// runs give the same bits); hist (B H, CK, DH DH) scratch.
//
// What bounds it on this card (roofline/kernel_model.py
// `wkv_bwd_bound_ms`): per (row, token, i, j) the recompute of the state
// and the reverse walk's multiply-adds (dr, dw, dk and dv partial sums,
// G's update), ~13 flops at 67 TFLOP/s float32, against the bytes of r,
// k, v, w, dy, the checkpoints and the five gradients (the scratch is 64
// KB a row of DH = 64 at CK = 16, written and read back by the same
// thread).  rwkv6-7b's training microbatch (B 2, T 256, H 64, DH 64,
// bf16) is 1.7 GFLOP -> ~26 us against ~84 MB -> ~25 us: the two bounds
// are close, and the recurrence is sequential in t.
//
// Design (a simple first version): one block a row with the forward's
// thread geometry (an R x C tile of S and G a thread); G stays in
// registers for the whole sequence.  A chunk's operands are staged into
// shared memory as float32 (element loads: no alignment is asked), then
// c_t and e_t are summed a thread a token, the states recomputed into
// `hist` (each thread writes and reads back only its own tile, laid out
// so a warp's accesses are contiguous), and the tokens walked in reverse:
// the row sums (dr, dk, dw) over a row group's NJ lanes by an xor
// butterfly, whose result is the same on every lane and every run; dv's
// key sums go to shared memory and are added over the row groups in a
// fixed pairwise order after the chunk, as the forward adds y.
namespace {

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
  float* hist;
  long long sB[4], sT[4];  // r, k, v, w: batch-row and token steps (elements)
  long long u_sb;
  int H, T;
};

template <int DH>
struct BwdSmem {
  float x[5][CK][DH];              // r, k, v, w, dy of the chunk's tokens
  float dvp[CK][Geo<DH>::G][DH];   // each row group's partial dv
  float u[DH];
  float c[CK];                     // sum_i r_i u_i k_i
  float e[CK];                     // sum_j dy_j v_j
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DH, typename T>
__global__ void __launch_bounds__(Geo<DH>::NT)
    rwkv6_scan_bwd_kernel(const BwdArgs a) {
  using Gm = Geo<DH>;
  constexpr int R = Gm::R, C = Gm::C, NJ = Gm::NJ, NT = Gm::NT, G = Gm::G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<DH>& sm = *reinterpret_cast<BwdSmem<DH>*>(smem_raw);
  const int tid = threadIdx.x;
  const int jc = tid % NJ, g = tid / NJ;
  const long long row = blockIdx.x;
  const long long b = row / a.H;
  const int h = static_cast<int>(row - b * a.H);
  const int nck = (a.T + CK - 1) / CK;
  auto col = [&](int n) { return Gm::template col<C, NJ>(jc, n); };
  // row (b, h)'s first element and token step in the contiguous tensors
  const long long tok0 = (b * a.T * a.H + h) * DH;
  const long long tstep = static_cast<long long>(a.H) * DH;
  const T* src[3];
#pragma unroll
  for (int x = 0; x < 3; ++x)
    src[x] = static_cast<const T*>(a.rkv[x]) + b * a.sB[x] +
             static_cast<long long>(h) * DH;
  const float* wsrc = a.w + b * a.sB[3] + static_cast<long long>(h) * DH;
  T* dr = static_cast<T*>(a.d_rkv[0]) + tok0;
  T* dk = static_cast<T*>(a.d_rkv[1]) + tok0;
  T* dv = static_cast<T*>(a.d_rkv[2]) + tok0;
  float* dw = a.dw + tok0;
  const float* dy = a.dy + tok0;
  float* hist = a.hist + row * CK * DH * DH;
  if (tid < DH) sm.u[tid] = a.u[b * a.u_sb + static_cast<long long>(h) * DH +
                                tid];

  float Gt[R][C];
  const float* ds = a.ds ? a.ds + row * DH * DH : nullptr;
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int n = 0; n < C; ++n)
      Gt[m][n] = ds ? ds[(g * R + m) * DH + col(n)] : 0.f;
  float du = 0.f;

  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * CK, cnt = min(CK, a.T - t0);
    __syncthreads();  // the previous chunk's shared data is read
    for (int e = tid; e < cnt * DH; e += NT) {
      const int t = e / DH, i = e - t * DH;
      const long long tt = t0 + t;
#pragma unroll
      for (int x = 0; x < 3; ++x)
        sm.x[x][t][i] = widen(src[x][tt * a.sT[x] + i]);
      sm.x[3][t][i] = wsrc[tt * a.sT[3] + i];
      sm.x[4][t][i] = dy[tt * tstep + i];
    }
    __syncthreads();  // the chunk is staged
    if (tid < cnt) {
      float cs = 0.f, es = 0.f;
      for (int i = 0; i < DH; ++i) {
        cs = fmaf(sm.x[0][tid][i], sm.u[i] * sm.x[1][tid][i], cs);
        es = fmaf(sm.x[4][tid][i], sm.x[2][tid][i], es);
      }
      sm.c[tid] = cs;
      sm.e[tid] = es;
    }
    {  // recompute S_{t-1} for the chunk's tokens from its checkpoint
      float S[R][C];
      const float* ckp = a.ck + (row * nck + c) * DH * DH;
#pragma unroll
      for (int m = 0; m < R; ++m)
#pragma unroll
        for (int n = 0; n < C; ++n) S[m][n] = ckp[(g * R + m) * DH + col(n)];
      for (int t = 0; t < cnt; ++t) {
        float* ht = hist + t * DH * DH;
#pragma unroll
        for (int m = 0; m < R; ++m)
#pragma unroll
          for (int n = 0; n < C; ++n) ht[(m * C + n) * NT + tid] = S[m][n];
#pragma unroll
        for (int m = 0; m < R; ++m) {
          const float wi = sm.x[3][t][g * R + m], ki = sm.x[1][t][g * R + m];
#pragma unroll
          for (int n = 0; n < C; ++n)
            S[m][n] = fmaf(wi, S[m][n], ki * sm.x[2][t][col(n)]);
        }
      }
    }
    __syncthreads();  // c_t and e_t are written

    for (int t = cnt - 1; t >= 0; --t) {
      const float* ht = hist + t * DH * DH;
      float rr[R], kk[R], ww[R], vv[C], dd[C];
#pragma unroll
      for (int m = 0; m < R; ++m) {
        rr[m] = sm.x[0][t][g * R + m];
        kk[m] = sm.x[1][t][g * R + m];
        ww[m] = sm.x[3][t][g * R + m];
      }
#pragma unroll
      for (int n = 0; n < C; ++n) {
        vv[n] = sm.x[2][t][col(n)];
        dd[n] = sm.x[4][t][col(n)];
      }
      float pr[R], pk[R], pw[R], pv[C];
#pragma unroll
      for (int m = 0; m < R; ++m) pr[m] = pk[m] = pw[m] = 0.f;
#pragma unroll
      for (int n = 0; n < C; ++n) pv[n] = 0.f;
#pragma unroll
      for (int m = 0; m < R; ++m)
#pragma unroll
        for (int n = 0; n < C; ++n) {
          const float sp = ht[(m * C + n) * NT + tid];
          pr[m] = fmaf(dd[n], sp, pr[m]);
          pw[m] = fmaf(Gt[m][n], sp, pw[m]);
          pk[m] = fmaf(Gt[m][n], vv[n], pk[m]);
          pv[n] = fmaf(Gt[m][n], kk[m], pv[n]);
        }
      // the row sums over the NJ lanes of the row group
#pragma unroll
      for (int o = 1; o < NJ; o *= 2)
#pragma unroll
        for (int m = 0; m < R; ++m) {
          pr[m] += __shfl_xor_sync(0xffffffffu, pr[m], o);
          pk[m] += __shfl_xor_sync(0xffffffffu, pk[m], o);
          pw[m] += __shfl_xor_sync(0xffffffffu, pw[m], o);
        }
      const float et = sm.e[t];
      const long long at = (t0 + t) * tstep;
#pragma unroll
      for (int m = 0; m < R; ++m)
        if (m == jc) {  // lane m of the group writes row g R + m
          const int i = g * R + m;
          dr[at + i] = narrow<T>(fmaf(sm.u[i] * kk[m], et, pr[m]));
          dk[at + i] = narrow<T>(fmaf(rr[m] * sm.u[i], et, pk[m]));
          dw[at + i] = pw[m];
        }
#pragma unroll
      for (int n = 0; n < C; ++n) sm.dvp[t][g][col(n)] = pv[n];
#pragma unroll
      for (int m = 0; m < R; ++m)
#pragma unroll
        for (int n = 0; n < C; ++n)
          Gt[m][n] = fmaf(ww[m], Gt[m][n], rr[m] * dd[n]);
    }
    __syncthreads();  // every row group's dv partial sums are written
    for (int e = tid; e < cnt * DH; e += NT) {
      const int t = e / DH, j = e - t * DH;
      float p[G];
#pragma unroll
      for (int q = 0; q < G; ++q) p[q] = sm.dvp[t][q][j];
#pragma unroll
      for (int span = 1; span < G; span *= 2)
#pragma unroll
        for (int q = 0; q < G; q += 2 * span) p[q] += p[q + span];
      dv[(t0 + t) * tstep + j] = narrow<T>(fmaf(sm.c[t], sm.x[4][t][j], p[0]));
    }
    if (tid < DH)
      for (int t = cnt - 1; t >= 0; --t)
        du = fmaf(sm.x[0][t][tid] * sm.x[1][t][tid], sm.e[t], du);
  }
  float* so = a.ds0 + row * DH * DH;
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int n = 0; n < C; ++n) so[(g * R + m) * DH + col(n)] = Gt[m][n];
  if (tid < DH) a.du[row * DH + tid] = du;
}

template <int DH, typename T>
int launch_bwd(const BwdArgs& a, int BH, cudaStream_t s) {
  constexpr int bytes = static_cast<int>(sizeof(BwdSmem<DH>));
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_bwd_kernel<DH, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_scan_bwd_kernel<DH, T><<<BH, Geo<DH>::NT, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_bwd(const BwdArgs& a, int BH, bool bf16, cudaStream_t s) {
  return bf16 ? launch_bwd<DH, __nv_bfloat16>(a, BH, s)
              : launch_bwd<DH, float>(a, BH, s);
}

}  // namespace

// Plain C entry point of the backward pass, bound with ctypes.  Pointers are
// device pointers in the layouts above; ds may be null (no gradient on the
// final state).  `steps` is a host array of 9 element counts: sB and sT of
// r, k, v and w in turn, then u_sb.  The caller guarantees BH = B x H >= 1,
// H >= 1, T >= 0 and that ck holds ceil(T / CK) states a row.  Returns
// cudaErrorInvalidValue for a DH other than 16 or 64, else the error of the
// shared-memory attribute or of the launch, which is asynchronous on
// `stream`.
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* ck,
                              const void* dy, const void* ds, void* dr,
                              void* dk, void* dv, void* dw, void* du,
                              void* ds0, void* hist, const long long* steps,
                              int BH, int H, int T, int DH, int bf16,
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
  a.hist = static_cast<float*>(hist);
  for (int x = 0; x < 4; ++x) {
    a.sB[x] = steps[2 * x];
    a.sT[x] = steps[2 * x + 1];
  }
  a.u_sb = steps[8];
  a.H = H;
  a.T = T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 16: return launch_bwd<16>(a, BH, bf16 != 0, s);
    case 64: return launch_bwd<64>(a, BH, bf16 != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
