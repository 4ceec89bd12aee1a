// Population gate-level circuit simulation for Hopper (sm_90a).
//
// Replaces: repro/kernels/pallas_circuit_sim.py
//   * `_fused_kernel` (fused_eval_uint / population_eval_uint) -> DECODE=true
//   * `_kernel` (simulate_population)                           -> DECODE=false
//   * `fleet_eval_words` runs DECODE=true over the padded tenant planes.
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
// What bounds it on this card: neither bytes nor operations.  The bound is
// a few bytes per word column (the word plane in, 128 B of labels out) and
// ~6 integer ops per gate per word, microseconds at the serving shapes.
// The gates of one column form a serial dependency chain (logic depth 293
// at arrhythmia, 3,020 gates), and each gate is two dependent loads and a
// store, so a column's walk is bounded by memory latency times the gate
// count; the card's parallelism comes only from the word columns
// (W = batch / 32) and the population rows.
//
// What this first design does about it: one thread owns one word column of
// one individual and walks the gates in order, so no two threads ever share
// a value and the walk needs no synchronisation.  Grid (ceil(W/128), P),
// 128 threads a block; the per-gate plan (op, in0, in1 of row p) is uniform
// across the block, staged in shared memory in chunks and read as a
// broadcast; the ANF coefficients come from a 13-entry constant table.
//
// Where the value plane lives: a word column holds (n_in + G) * 4 bytes,
// 13 KB at arrhythmia.  At 128 threads a block that is 1.7 MB, which fits
// neither the 64K registers nor the 227 KB of shared memory of an SM, so the
// node values go to a global scratch plane `vals[p][node][w]` that the
// wrapper allocates.  The thread first copies its input words into the
// plane, so every node read is one load from one array (no branch between
// the word plane and the gate values, and no read-only-cache path for a
// line the thread also writes).  A warp's loads and stores of one node are
// contiguous 128-byte lines, and at W = 2048 (65,536 readings) one
// program's plane is (274 + 3,020) * 2,048 * 4 B = 27 MB, inside the 50 MB
// L2.  Alternatives for a later change: shared memory for the nodes whose
// values are still live (liveness from `CircuitIR.levels`), fewer threads
// a block with a column split between registers and shared memory, or one
// warp per column evaluating a level's gates in parallel.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPlanChunk = 1024;  // gates staged per shared-memory refill

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

}  // namespace

// Plain C entry point, bound with ctypes.  All pointers are device pointers
// to contiguous int32 tensors; `vals` is a (P, n_in + G, W) scratch plane; `out` is (P, W*32) when decode != 0, else (P, n_out, W).
// The caller guarantees 0 < P <= 65535, W > 0, n_out <= 32 when decoding,
// opcodes in [0, 13) and a feed-forward plan (in0/in1 of gate g below
// n_in + g, outputs below n_in + G).  Returns cudaGetLastError() after the
// launch; the launch is asynchronous on `stream`.
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
