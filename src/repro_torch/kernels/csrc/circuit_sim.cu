// Population gate-level circuit simulation for Hopper (sm_90a): two routed
// designs of one gate walk.
//
// Replaces: repro/kernels/pallas_circuit_sim.py
//   * `_fused_kernel` (:183; fused_eval_uint / population_eval_uint)
//                                                  -> DECODE=true
//   * `_kernel` (:78; simulate_population)         -> DECODE=false
//   * `fleet_eval_words` (:322) runs DECODE=true over the padded tenants,
//     one schedule per tenant row.
//
// Computes, for individual p and packed word column w (vector s of a word is
// bit s % 32 of word s / 32):
//   node[id] = words[(p,) id, w]                  for id < n_in
//   node[n_in + g] = m0 ^ (ma & a) ^ (mb & b) ^ (mab & a & b),
//       a = node[in0[p, g]], b = node[in1[p, g]], masks from the opcode,
// then either the raw output words out[p, o, w] = node[outputs[p, o]]
// (DECODE=false) or the LSB-first integers
//   label[p, 32 w + s] = sum_o bit_s(node[outputs[p, o]]) << o (DECODE=true).
//
// What bounds it on this card: neither bytes nor operations.  The word
// plane in and the labels out are a few bytes per column, and the logic is
// ~6 integer ops per gate per word: microseconds at the serving shapes.
// What bounds it is the dependency chain.  A circuit of logic depth D
// (293 levels at arrhythmia, 36 at cardio) needs D rounds in which every
// gate of a level reads values the previous round wrote; a round costs at
// least one shared-memory round trip and one barrier, ~30 SM cycles at
// the least, so arrhythmia's chain is ~4.4 us at 1,980 MHz whatever the
// width.  With one warp walking a block's levels there is nothing to hide
// latency behind, so a level costs its dependent instruction chain: the
// design keeps that chain to the operand loads, the logic, one store and
// one barrier.
//
// 1. `circuit_level_kernel` ("shared_plane", the route for every plan whose
//    value plane fits in shared memory).  A block owns C word columns of
//    one plan row: grid (ceil(W / C), P).  It keeps the whole node plane of
//    those columns in shared memory, laid out [row][column], so the lanes
//    that read one gate's operand for consecutive columns hit consecutive
//    banks.  The host builds the row's level schedule once per plan
//    (`cuda_circuit_sim.schedule`): gates grouped by logic level, each
//    slot's operands already mapped to plane rows and its opcode to four
//    ANF bits, packed with the level offsets into one buffer a row.  The
//    block stages it with 16-byte copies while its other half loads the
//    input words (coalesced along W), so staging is one round of loads.
//    Then, level by level, the row's walking threads (a (gate, column)
//    pair of its widest level each; thread = gate lane * C + column) each
//    evaluate at most one gate from the level, their entry prefetched
//    during the previous level and the store predicated, and the level
//    ends in one barrier among the walking threads: __syncwarp when they
//    are one warp, else a named barrier.  Wider levels stride.  The chain
//    is D barriers, not G dependent global round trips.  A row whose
//    schedule ends early (fleet rows of smaller depth) stops at its own
//    last level, block-uniformly; inactive columns (w >= W) compute on
//    zero words and reach every barrier.  Gates that the schedule leaves
//    out (the fleet's padding) are never evaluated and nothing reads their
//    rows.  Epilogue: one thread per (column, bit) ORs the taps into the
//    LSB-first integer and writes coalesced labels, or one thread per
//    (tap, column) copies output words.  Shared memory, up to 227 KB:
//    4 (n_in + G) C bytes of plane and ~5 bytes a gate of schedule; the
//    attribute that allows more than 48 KB is set once per device.
// 2. `circuit_walk_kernel` ("global_scratch", the route for plans whose
//    one-column plane and schedule do not fit, about 25 k gates and up).
//    One thread owns one word column and walks the gates in plan order
//    over a global scratch plane vals[p][node][w] that the wrapper
//    allocates; 128 columns a block, the plan staged in shared memory in
//    chunks and read as a broadcast.  Each gate is two dependent loads and
//    a store, so a column's walk is bounded by the L1/L2 latency times G.
// 3. `circuit_levels_kernel` and `circuit_schedule_kernel`: the level
//    schedule of a plan that carries none (a population, a bare wrapper
//    call), built on the card per call so such a call does not wait on
//    host work per gate.
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;      // global-scratch walk: columns a block
constexpr int kPlanChunk = 1024;   // gates staged per shared-memory refill
constexpr int kLevelMaxThreads = 512;
constexpr int kMaxSmem = 232448;   // 227 KB, what a block can opt into
constexpr int kScheduleThreads = 512;   // the schedule kernels' block

// ANF coefficient masks (c0, ca, cb, cab) per Gate opcode, copied from
// `_ANF_COEFF` (repro_torch/core/circuits.py).  INPUT acts as BUF.
#define ONES 0xFFFFFFFFu
__constant__ uint32_t c_anf[13][4] = {
    {0u, ONES, 0u, 0u},        // INPUT
    {0u, 0u, 0u, 0u},          // CONST0
    {ONES, 0u, 0u, 0u},        // CONST1
    {0u, ONES, 0u, 0u},        // BUF
    {ONES, ONES, 0u, 0u},      // NOT
    {0u, 0u, 0u, ONES},        // AND
    {0u, ONES, ONES, ONES},    // OR
    {0u, ONES, ONES, 0u},      // XOR
    {ONES, 0u, 0u, ONES},      // NAND
    {ONES, ONES, ONES, ONES},  // NOR
    {ONES, ONES, ONES, 0u},    // XNOR
    {0u, ONES, 0u, ONES},      // ANDN
    {ONES, 0u, ONES, ONES},    // ORN
};
#undef ONES

// Lets `kernel` use up to kMaxSmem bytes of dynamic shared memory.  The
// driver call is made once per device, not on every launch; `done`
// remembers the devices.
cudaError_t allow_smem(const void* kernel, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// ---------------------------------------------------------------------------
// 1. Level-parallel walk over a shared-memory value plane.
//
// The plane holds row r of the node plane at words [r * C, r * C + C):
// rows 0..n_in-1 are the inputs and row n_in + k the gate in schedule slot
// k.  The host's schedule gives each plan row one buffer of R words:
//   [0, S0)          the level offsets, L + 1 of them (S0 = L + 1 padded
//                    to 4);
//   [S0, S0 + Ge)    per slot, (row of in0) | (row of in1) << 16 (Ge = G
//                    padded to 4);
//   [S0 + Ge, R)     per slot, a byte of ANF coefficient bits (c0, ca, cb,
//                    cab in bits 0-3), Gb = G padded to 16 bytes;
// and `rank` (P, G), the slot of each gate, for the output taps.  Rows
// times C fit 16 bits: a plane of 65,536 words is past the shared-memory
// budget.
//
// Shared memory, in this order: the plane (n_nodes * C words, padded to
// 4), the row's buffer (R words; its entries scaled by C once staged), the
// taps' plane offsets (n_out words), the row's level count and widest
// level (2 words).
__device__ __forceinline__ uint32_t apply_anf(uint32_t f, uint32_t a,
                                              uint32_t b) {
  return (0u - (f & 1u)) ^ ((0u - ((f >> 1) & 1u)) & a) ^
         ((0u - ((f >> 2) & 1u)) & b) ^ ((0u - (f >> 3)) & (a & b));
}

// Keeps `v` in a register across the level loop (no reload from the
// constant bank on the loop's critical path).
__device__ __forceinline__ int pinned(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// The level loop of one thread: lane j of column c (`col` = plane + c).
// `dst` is the plane word of slot j's row.  The thread holds the next
// level's bound and its first entry in registers, loaded while the
// current level runs (the schedule is read-only by now), so a level's
// chain is the operand loads, the logic, the store and the barrier.
// STRIDE: a level may hold more gates than lanes (J), so a lane strides
// over them; else a lane evaluates at most one gate a level, without a
// branch (the store is predicated).  WARP: the walking threads are one
// warp and synchronise with __syncwarp.
template <bool STRIDE, bool WARP>
__device__ __forceinline__ void walk_levels(
    uint32_t* col, uint32_t* dst, const uint32_t* ent, const uint8_t* bits,
    const int* lstart, int j, int J, int C, int n_levels, int n_sched,
    int threads) {
  const int JC = J * C;
  int lo = 0;
  int hi = n_levels > 0 ? lstart[1] : 0;
  uint32_t e = j < n_sched ? ent[j] : 0u;
  uint32_t f = j < n_sched ? bits[j] : 0u;
  for (int l = 0; l < n_levels; ++l) {
    const int hi_next = lstart[l + 2 <= n_levels ? l + 2 : n_levels];
    const int kn = hi + j;
    const uint32_t e_next = kn < n_sched ? ent[kn] : 0u;
    const uint32_t f_next = kn < n_sched ? bits[kn] : 0u;
    const uint32_t r = apply_anf(f, col[e & 0xFFFFu], col[e >> 16]);
    if (lo + j < hi) dst[lo * C] = r;
    if (STRIDE) {
      uint32_t* d = dst + lo * C;
      for (int k = lo + j + J; k < hi; k += J) {
        d += JC;
        const uint32_t ek = ent[k];
        *d = apply_anf(bits[k], col[ek & 0xFFFFu], col[ek >> 16]);
      }
    }
    if (WARP)
      __syncwarp();
    else
      asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
    lo = hi;
    hi = hi_next;
    e = e_next;
    f = f_next;
  }
}

template <bool DECODE>
__global__ void __launch_bounds__(kLevelMaxThreads)
circuit_level_kernel(const uint4* __restrict__ prog,
                     const int32_t* __restrict__ rank_g,
                     const int32_t* __restrict__ outputs,
                     const uint32_t* __restrict__ words, int per_individual,
                     uint32_t* __restrict__ out, int G, int R, int S0,
                     int Ge, int n_in, int n_out, int W, int L, int C,
                     int level_threads) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_nodes = n_in + G;
  uint32_t* plane = reinterpret_cast<uint32_t*>(smem);
  uint32_t* buf = plane + (n_nodes * C + 3) / 4 * 4;
  const int* lstart = reinterpret_cast<const int*>(buf);
  uint32_t* ent = buf + S0;
  const uint8_t* bits = reinterpret_cast<const uint8_t*>(buf + S0 + Ge);
  uint32_t* s_out = buf + R;
  int* s_levels = reinterpret_cast<int*>(s_out + n_out);
  int* s_width = s_levels + 1;

  const int p = blockIdx.y;
  const int w0 = blockIdx.x * C;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const long long Wl = W;

  // staging, in one round of loads: the first half of the block copies
  // the row's buffer with 16-byte loads, the second half loads the input
  // words and maps the output taps to plane rows.  The loops are unrolled
  // so several loads are in flight at once.
  const int half = T / 2;
  if (t < half) {
    const uint4* row = prog + (long long)p * (R / 4);
#pragma unroll 4
    for (int i = t; i < R / 4; i += half)
      reinterpret_cast<uint4*>(buf)[i] = __ldg(row + i);
  } else {
    const int u = t - half;
    const uint32_t* wrow =
        words + (per_individual ? (long long)p * n_in * Wl : 0) + w0;
    if ((C & 3) == 0 && (W & 3) == 0 &&
        (reinterpret_cast<uintptr_t>(words) & 15) == 0) {
      // whole 16-byte quads of columns, each in or past W together (a
      // word plane that starts off a 16-byte boundary loads word by word)
      const int C4 = C / 4;
#pragma unroll 4
      for (int i = u; i < n_in * C4; i += half) {
        const int k = i / C4, c = 4 * (i - k * C4);
        reinterpret_cast<uint4*>(plane)[i] =
            w0 + c < W ? __ldg(reinterpret_cast<const uint4*>(wrow + k * Wl
                                                              + c))
                       : make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
#pragma unroll 4
      for (int i = u; i < n_in * C; i += half) {
        const int k = i / C, c = i - k * C;
        plane[i] = w0 + c < W ? __ldg(wrow + k * Wl + c) : 0u;
      }
    }
    const int32_t* out_row = outputs + (long long)p * n_out;
    const int32_t* rrow = rank_g + (long long)p * G;
    for (int o = u; o < n_out; o += half) {
      const int id = __ldg(out_row + o);
      s_out[o] = (id < n_in ? id : n_in + __ldg(rrow + id - n_in)) * C;
    }
    if (u == 0) {
      *s_levels = 0;
      *s_width = 0;
    }
  }
  __syncthreads();
  // then from shared memory: the entries scaled by C, the row's level
  // count (up to the level its last scheduled gate ends) and widest level
  const int n_sched = lstart[L];
  if (C > 1)
    for (int i = t; i < n_sched; i += T) {
      const uint32_t e = ent[i];
      ent[i] = (e & 0xFFFFu) * C | ((e >> 16) * C) << 16;
    }
  for (int i = t + 1; i <= L; i += T) {
    const int st = lstart[i], prev = lstart[i - 1];
    if (st == n_sched && prev < n_sched) *s_levels = i;
    if (st > prev) atomicMax(s_width, st - prev);
  }
  __syncthreads();

  // The row's walking threads — a (gate, column) pair of its widest level
  // each, in whole warps, at most `level_threads` — walk its levels (those
  // up to its last scheduled gate), synchronising among themselves only;
  // thread = gate lane j * C + column c.  Lanes j >= J only synchronise.
  const int walkers = min(level_threads, (*s_width * C + 31) / 32 * 32);
  if (t < walkers) {
    const int Cp = pinned(C);
    const int nt = pinned(walkers);
    const int c = t % Cp;
    const int j = t / Cp;
    const int J = nt / Cp;
    const int n_levels = *s_levels;
    uint32_t* col = plane + c;
    uint32_t* dst = col + (n_in + j) * Cp;
    const int* ls = lstart;
    const int lane = j < J ? j : n_sched;   // idle lanes match no slot
    const bool stride = *s_width > J;
    if (nt == 32) {
      if (!stride)
        walk_levels<false, true>(col, dst, ent, bits, ls, lane, J, Cp,
                                 n_levels, n_sched, nt);
      else
        walk_levels<true, true>(col, dst, ent, bits, ls, lane, J, Cp,
                                n_levels, n_sched, nt);
    } else {
      if (!stride)
        walk_levels<false, false>(col, dst, ent, bits, ls, lane, J, Cp,
                                  n_levels, n_sched, nt);
      else
        walk_levels<true, false>(col, dst, ent, bits, ls, lane, J, Cp,
                                 n_levels, n_sched, nt);
    }
  }
  __syncthreads();

  if constexpr (DECODE) {
    // one thread per (column, bit): a warp covers one column's 32 labels
    for (int i = t; i < C * 32; i += T) {
      const int cc = i >> 5, s = i & 31;
      if (w0 + cc >= W) continue;
      uint32_t lab = 0u;
      for (int o = 0; o < n_out; ++o)
        lab |= ((plane[s_out[o] + cc] >> s) & 1u) << o;
      out[((long long)p * Wl + w0 + cc) * 32 + s] = lab;
    }
  } else {
    for (int i = t; i < n_out * C; i += T) {
      const int o = i / C, cc = i - o * C;
      if (w0 + cc >= W) continue;
      out[((long long)p * n_out + o) * Wl + w0 + cc] = plane[s_out[o] + cc];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. Serial walk per column over a global scratch plane.
template <bool DECODE>
__global__ void __launch_bounds__(kThreads)
circuit_walk_kernel(const int32_t* __restrict__ op,
                    const int32_t* __restrict__ in0,
                    const int32_t* __restrict__ in1,
                    const int32_t* __restrict__ outputs,
                    const uint32_t* words, int per_individual,
                    uint32_t* vals, uint32_t* out, int G, int n_in,
                    int n_out, int W) {
  __shared__ int32_t s_op[kPlanChunk];
  __shared__ int32_t s_in0[kPlanChunk];
  __shared__ int32_t s_in1[kPlanChunk];

  const int p = blockIdx.y;
  const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool active = w < W;
  const long long Wl = W;
  // node id k of this column lives at col[k * W]
  uint32_t* col = vals + (long long)p * (n_in + G) * Wl + w;
  const int32_t* op_row = op + (long long)p * G;
  const int32_t* in0_row = in0 + (long long)p * G;
  const int32_t* in1_row = in1 + (long long)p * G;

  if (active) {
    const uint32_t* in_col =
        words + (per_individual ? (long long)p * n_in * Wl : 0) + w;
    for (int k = 0; k < n_in; ++k) col[k * Wl] = in_col[k * Wl];
  }
  for (int g0 = 0; g0 < G; g0 += kPlanChunk) {
    const int n = min(kPlanChunk, G - g0);
    __syncthreads();  // the previous chunk is no longer being read
    for (int i = threadIdx.x; i < n; i += kThreads) {
      s_op[i] = op_row[g0 + i];
      s_in0[i] = in0_row[g0 + i];
      s_in1[i] = in1_row[g0 + i];
    }
    __syncthreads();
    if (active) {
      uint32_t* dst = col + (long long)(n_in + g0) * Wl;
      for (int i = 0; i < n; ++i) {
        const uint32_t* m = c_anf[s_op[i]];
        const uint32_t a = col[s_in0[i] * Wl];
        const uint32_t b = col[s_in1[i] * Wl];
        dst[i * Wl] = m[0] ^ (m[1] & a) ^ (m[2] & b) ^ (m[3] & (a & b));
      }
    }
  }
  if (!active) return;

  const int32_t* out_row = outputs + (long long)p * n_out;
  if constexpr (DECODE) {
    uint32_t lab[32];
#pragma unroll
    for (int s = 0; s < 32; ++s) lab[s] = 0u;
    for (int o = 0; o < n_out; ++o) {
      const uint32_t v = col[out_row[o] * Wl];
#pragma unroll
      for (int s = 0; s < 32; ++s) lab[s] |= ((v >> s) & 1u) << o;
    }
    uint4* dst = reinterpret_cast<uint4*>(out + ((long long)p * Wl + w) * 32);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      dst[q] = make_uint4(lab[4 * q], lab[4 * q + 1], lab[4 * q + 2],
                          lab[4 * q + 3]);
  } else {
    for (int o = 0; o < n_out; ++o)
      out[((long long)p * n_out + o) * Wl + w] = col[out_row[o] * Wl];
  }
}

// ---------------------------------------------------------------------------
// 3. The level schedule of raw plan rows (a population or a bare call
//    that carries no schedule), built on the card so such a call does not
//    wait on host work per gate.  Two kernels, one block a row each.
//
// `circuit_levels_kernel`: each thread owns a contiguous run of the row's
// gates and sweeps it in plan order, level = 1 + the larger level of the
// two operands (inputs at 0), so a chain inside a run settles in one
// sweep; sweeps repeat until none changes a level.  Levels only grow
// towards their fixed point, so reading a neighbour's old or new value is
// equally sound, and a sweep count past the longest chain of run
// crossings is never needed.  An operand that is not an earlier gate
// reads 0, so even a plan that breaks the feed-forward contract ends.
// The row's deepest level goes to meta[0] (atomicMax).
__global__ void __launch_bounds__(kScheduleThreads)
circuit_levels_kernel(const int32_t* __restrict__ in0,
                      const int32_t* __restrict__ in1,
                      int32_t* __restrict__ levels, int* meta, int G,
                      int n_in) {
  extern __shared__ __align__(16) unsigned char smem[];
  volatile int* lev = reinterpret_cast<volatile int*>(smem);
  const int t = threadIdx.x;
  const long long row = (long long)blockIdx.x * G;
  const int per = (G + kScheduleThreads - 1) / kScheduleThreads;
  const int lo = min(G, t * per), hi = min(G, lo + per);
  for (int g = lo; g < hi; ++g) lev[g] = 0;
  int changed;
  do {
    __syncthreads();
    int ch = 0;
    for (int g = lo; g < hi; ++g) {
      const unsigned a = __ldg(in0 + row + g) - n_in;
      const unsigned b = __ldg(in1 + row + g) - n_in;
      const int la = a < unsigned(g) ? lev[a] : 0;
      const int lb = b < unsigned(g) ? lev[b] : 0;
      const int v = 1 + max(la, lb);
      if (v != lev[g]) {
        lev[g] = v;
        ch = 1;
      }
    }
    changed = __syncthreads_or(ch);
  } while (changed);
  int top = 0;
  for (int g = t; g < G; g += kScheduleThreads) {
    const int v = lev[g];
    levels[row + g] = v;
    top = max(top, v);
  }
  top = __reduce_max_sync(0xFFFFFFFFu, top);
  if ((t & 31) == 0 && top) atomicMax(meta, top);
}

// `circuit_schedule_kernel`: the row's buffer (layout as for
// `circuit_level_kernel`) and `rank` from its levels (0: not evaluated),
// L the deepest level of any row.  A stable counting sort: gates are
// counted into L + 1 buckets (levels 1..L, then the gates not evaluated),
// warp 0 scans the counts into the level offsets (and the row's widest
// level, into meta[1]) and then hands out slots in plan order 32 gates at
// a time, a gate's slot its bucket's cursor plus the lanes before it in
// the same bucket; last, every gate writes its slot's operand rows and
// ANF bits.  Shared memory: 4 (L + 1) + 4 G bytes.
__global__ void __launch_bounds__(kScheduleThreads)
circuit_schedule_kernel(const int32_t* __restrict__ op,
                        const int32_t* __restrict__ in0,
                        const int32_t* __restrict__ in1,
                        const int32_t* __restrict__ levels,
                        int32_t* __restrict__ rank_g, int32_t* prog,
                        int* meta, int G, int n_in, int L, int R, int S0,
                        int Ge) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* count = reinterpret_cast<int*>(smem);
  uint16_t* key = reinterpret_cast<uint16_t*>(count + L + 1);
  uint16_t* slot = key + G;
  const int t = threadIdx.x;
  const long long row = (long long)blockIdx.x * G;
  int32_t* prow = prog + (long long)blockIdx.x * R;

  for (int i = t; i <= L; i += kScheduleThreads) count[i] = 0;
  __syncthreads();
  for (int g = t; g < G; g += kScheduleThreads) {
    const int lv = levels[row + g];
    const int k = lv >= 1 && lv <= L ? lv - 1 : L;
    key[g] = k;
    atomicAdd(count + k, 1);
  }
  __syncthreads();
  if (t < 32) {
    // the level offsets: bucket k's first slot, written out as starts[k]
    int carry = 0, widest = 0;
    for (int base = 0; base <= L; base += 32) {
      const int k = base + t;
      const int c = k <= L ? count[k] : 0;
      if (k < L) widest = max(widest, c);
      int incl = c;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (t >= d) incl += v;
      }
      if (k <= L) count[k] = prow[k] = carry + incl - c;
      carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
    }
    widest = __reduce_max_sync(0xFFFFFFFFu, widest);
    if (t == 0 && widest) atomicMax(meta + 1, widest);
    // stable slots, 32 gates at a time in plan order
    const unsigned before = (1u << t) - 1u;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + t;
      const int k = g < G ? key[g] : -1 - t;   // idle lanes match no one
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, k);
      const int leader = __ffs(peers) - 1;
      const int first = __shfl_sync(0xFFFFFFFFu, g < G ? count[k] : 0,
                                    leader);
      if (g < G) slot[g] = first + __popc(peers & before);
      __syncwarp();
      if (g < G && t == leader) count[k] = first + __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  uint8_t* bits = reinterpret_cast<uint8_t*>(prow + S0 + Ge);
  for (int g = t; g < G; g += kScheduleThreads) {
    const int k = slot[g];
    rank_g[row + g] = k;
    uint32_t rows[2];
    const int ids[2] = {__ldg(in0 + row + g), __ldg(in1 + row + g)};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gate = min(max(ids[i] - n_in, 0), G - 1);
      rows[i] = uint32_t(ids[i] < n_in ? ids[i] : n_in + slot[gate]) &
                0xFFFFu;
    }
    prow[S0 + k] = int32_t(rows[0] | rows[1] << 16);
    const uint32_t* m = c_anf[min(max(__ldg(op + row + g), 0), 12)];
    bits[k] = uint8_t((m[0] != 0u) | (m[1] != 0u) << 1 | (m[2] != 0u) << 2 |
                      (m[3] != 0u) << 3);
  }
}

}  // namespace

// Plain C entry points, bound with ctypes.  All pointers are device
// pointers to contiguous int32 tensors: op/in0/in1 (P, G), outputs
// (P, n_out), words (n_in, W) or (P, n_in, W) when per_individual; `out`
// is (P, W*32) when decode != 0, else (P, n_out, W).  The caller
// guarantees 0 < P <= 65535, W > 0, n_out <= 32 when decoding, opcodes in
// [0, 13) and node ids in range.  Each returns cudaGetLastError() after
// the launch (or the attribute call's error); the launch is asynchronous
// on `stream`.

// The level walk.  `prog` (P, R) int32 holds each plan row's buffer
// (level offsets, slot entries, opcode bits; R a multiple of 4), `rank`
// (P, G) each gate's slot, as `cuda_circuit_sim.schedule` builds them from
// a validated schedule: slot k's operands are input rows or slots of
// earlier levels, and the outputs read inputs or scheduled gates.  Grid
// (ceil(W / C), P), `threads` a block (a multiple of 32, 128 to 512), of
// which at most `level_threads` (a multiple of 32, at least C) walk the
// levels, as many as the row's widest level needs; `smem` bytes of dynamic
// shared memory as `cuda_circuit_sim.plan` computes them.
extern "C" int circuit_level_walk(const void* prog, const void* rank,
                                  const void* outputs, const void* words,
                                  int per_individual, void* out, int P, int G,
                                  int R, int S0, int Ge, int n_in, int n_out,
                                  int W, int L, int C, int level_threads,
                                  int threads, int smem, int decode,
                                  void* stream) {
  static std::atomic<uint64_t> done_decode{0}, done_words{0};
  const void* kernel =
      decode ? reinterpret_cast<const void*>(circuit_level_kernel<true>)
             : reinterpret_cast<const void*>(circuit_level_kernel<false>);
  const cudaError_t attr =
      allow_smem(kernel, decode ? done_decode : done_words);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((W + C - 1) / C, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* prog_p = static_cast<const uint4*>(prog);
  auto* rank_p = static_cast<const int32_t*>(rank);
  auto* outputs_p = static_cast<const int32_t*>(outputs);
  auto* words_p = static_cast<const uint32_t*>(words);
  auto* out_p = static_cast<uint32_t*>(out);
  if (decode)
    circuit_level_kernel<true><<<grid, threads, smem, s>>>(
        prog_p, rank_p, outputs_p, words_p, per_individual, out_p, G, R, S0,
        Ge, n_in, n_out, W, L, C, level_threads);
  else
    circuit_level_kernel<false><<<grid, threads, smem, s>>>(
        prog_p, rank_p, outputs_p, words_p, per_individual, out_p, G, R, S0,
        Ge, n_in, n_out, W, L, C, level_threads);
  return static_cast<int>(cudaGetLastError());
}

// The global-scratch walk: `vals` is a (P, n_in + G, W) scratch plane and
// the plan must be feed-forward in plan order (in0/in1 of gate g below
// n_in + g, outputs below n_in + G).
extern "C" int circuit_walk(const void* op, const void* in0, const void* in1,
                            const void* outputs, const void* words,
                            int per_individual, void* vals, void* out, int P,
                            int G, int n_in, int n_out, int W, int decode,
                            void* stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* op_p = static_cast<const int32_t*>(op);
  auto* in0_p = static_cast<const int32_t*>(in0);
  auto* in1_p = static_cast<const int32_t*>(in1);
  auto* outputs_p = static_cast<const int32_t*>(outputs);
  auto* words_p = static_cast<const uint32_t*>(words);
  auto* vals_p = static_cast<uint32_t*>(vals);
  auto* out_p = static_cast<uint32_t*>(out);
  if (decode)
    circuit_walk_kernel<true><<<grid, kThreads, 0, s>>>(
        op_p, in0_p, in1_p, outputs_p, words_p, per_individual, vals_p, out_p,
        G, n_in, n_out, W);
  else
    circuit_walk_kernel<false><<<grid, kThreads, 0, s>>>(
        op_p, in0_p, in1_p, outputs_p, words_p, per_individual, vals_p, out_p,
        G, n_in, n_out, W);
  return static_cast<int>(cudaGetLastError());
}

// The level schedule of P raw plan rows: in0/in1/op (P, G) int32.
// `circuit_levels` writes `levels` (P, G) and the deepest level into
// meta[0] (meta, 2 ints, zeroed by the caller); `smem` = 4 G bytes.
// `circuit_schedule` writes `rank` (P, G) and `prog` (P, R), zeroed by the
// caller, from `levels` and L (the deepest level), and the widest level
// into meta[1]; `smem` = 4 (L + 1) + 4 G bytes.  Both need G < 65536 and
// `smem` at most kMaxSmem.
extern "C" int circuit_levels(const void* in0, const void* in1, void* levels,
                              void* meta, int P, int G, int n_in, int smem,
                              void* stream) {
  static std::atomic<uint64_t> done{0};
  const cudaError_t attr =
      allow_smem(reinterpret_cast<const void*>(circuit_levels_kernel), done);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  circuit_levels_kernel<<<P, kScheduleThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(in0), static_cast<const int32_t*>(in1),
      static_cast<int32_t*>(levels), static_cast<int*>(meta), G, n_in);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int circuit_schedule(const void* op, const void* in0,
                                const void* in1, const void* levels,
                                void* rank, void* prog, void* meta, int P,
                                int G, int n_in, int L, int R, int S0,
                                int Ge, int smem, void* stream) {
  static std::atomic<uint64_t> done{0};
  const cudaError_t attr = allow_smem(
      reinterpret_cast<const void*>(circuit_schedule_kernel), done);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  circuit_schedule_kernel<<<P, kScheduleThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(op), static_cast<const int32_t*>(in0),
      static_cast<const int32_t*>(in1), static_cast<const int32_t*>(levels),
      static_cast<int32_t*>(rank), static_cast<int32_t*>(prog),
      static_cast<int*>(meta), G, n_in, L, R, S0, Ge);
  return static_cast<int>(cudaGetLastError());
}
