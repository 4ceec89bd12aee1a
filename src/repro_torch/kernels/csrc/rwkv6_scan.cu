// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces: repro/kernels/rwkv6_scan.py `_kernel` (pallas_call at :92),
// reached through `rwkv6_chunked` and `ops.rwkv6_scan`; in the model it is
// the recurrence of every RWKV-6 layer's time-mix (models/ssm.py), at
// prefill and at every decode step.
//
// Computes, for each batch-head row b and token t = 0 .. T-1,
//   y[b, t, j] = sum_i r[b,t,i] * (S[i][j] + u[b,i] * k[b,t,i] * v[b,t,j])
//   S[i][j]    = w[b,t,i] * S[i][j] + k[b,t,i] * v[b,t,j]
// from S = s0[b] (or zeros), with
//   r, k, v, w (BH, T, DH) float32, u (BH, DH) float32,
//   s0, s_out  (BH, DH, DH) float32, row i = key dim, column j = value dim,
//   y          (BH, T, DH) float32.
// This is the sequential oracle `ref.rwkv6_scan_ref` with an initial state.
// The Pallas kernel instead runs chunks of T_c tokens as matmuls, dividing
// k by the cumulative decay inside a chunk; that overflows float32 for
// small decays (its docstring limits it to w >~ 0.6, and RWKV-6 decays
// exp(-exp(.)) reach far below).  This kernel never divides, so it is
// right at any decay in (0, 1).
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s float32 on
// the CUDA cores): the bytes.  rwkv6-7b's prefill of 8 x 96 tokens moves
// 4 x 512 x 96 x 64 floats in, y out and the 512 final 64 x 64 states,
// 71 MB -> ~21 us; its 7 flops per (row, token, i, j), 1.4 GFLOP, take
// about as long at the float32 rate.  A decode step (T = 1) is the state:
// 8.4 MB in and 8.4 MB out -> ~5 us a layer.  The recurrence is sequential
// in t, so the parallelism is BH x DH threads (32,768 at BH = 512).
//
// Design: one block of DH threads per row b.  Thread j keeps column j of
// S (DH floats) in registers for the whole sequence, so the state is read
// and written once.  Each token's r_i, k_i, u_i k_i and w_i are staged in
// shared memory as one float4 per i (read back as a broadcast), and v_j
// stays in thread j's registers.  Two staging buffers and one barrier a
// token: the next token's operands are loaded into registers while the
// current one is summed.  Each y_j is summed over i in a fixed order, so
// the result does not depend on scheduling.
#include <cuda_runtime.h>

namespace {

template <int DH>
__global__ void __launch_bounds__(DH)
    rwkv6_scan_kernel(const float* __restrict__ r,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ s0,
                      float* __restrict__ y, float* __restrict__ s_out,
                      int T) {
  __shared__ float4 stage[2][DH];        // (r_i, k_i, u_i k_i, w_i)
  const int j = threadIdx.x;
  const long long row = blockIdx.x;
  const long long seq = row * T * DH;    // this row's (T, DH) operands
  const long long mat = row * DH * DH;   // this row's (DH, DH) state

  float S[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) S[i] = s0 ? s0[mat + i * DH + j] : 0.f;
  const float uj = u[row * DH + j];

  float nr = 0.f, nk = 0.f, nv = 0.f, nw = 0.f;
  if (T > 0) {
    nr = r[seq + j];
    nk = k[seq + j];
    nv = v[seq + j];
    nw = w[seq + j];
  }
  for (int t = 0; t < T; ++t) {
    float4* buf = stage[t & 1];
    buf[j] = make_float4(nr, nk, uj * nk, nw);
    const float vj = nv;
    __syncthreads();
    if (t + 1 < T) {
      const long long o = seq + (long long)(t + 1) * DH + j;
      nr = r[o];
      nk = k[o];
      nv = v[o];
      nw = w[o];
    }
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      const float4 q = buf[i];
      acc = fmaf(q.x, fmaf(q.z, vj, S[i]), acc);
      S[i] = fmaf(q.w, S[i], q.y * vj);
    }
    y[seq + (long long)t * DH + j] = acc;
  }
#pragma unroll
  for (int i = 0; i < DH; ++i) s_out[mat + i * DH + j] = S[i];
}

template <int DH>
void launch(const float* r, const float* k, const float* v, const float* w,
            const float* u, const float* s0, float* y, float* s_out, int BH,
            int T, cudaStream_t s) {
  rwkv6_scan_kernel<DH><<<BH, DH, 0, s>>>(r, k, v, w, u, s0, y, s_out, T);
}

}  // namespace

// Plain C entry point, bound with ctypes.  All pointers are device pointers
// to contiguous float32 tensors of the shapes above; s0 may be null (zero
// initial state) and must not alias s_out.  The caller guarantees BH >= 1
// and T >= 0.  Returns cudaErrorInvalidValue for a DH other than 16 (the
// reduced configs) or 64 (rwkv6-7b), else cudaGetLastError() after the
// launch, which is asynchronous on `stream`.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, int BH, int T, int DH,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  const auto* sf = static_cast<const float*>(s0);
  auto* yf = static_cast<float*>(y);
  auto* of = static_cast<float*>(s_out);
  switch (DH) {
    case 16: launch<16>(rf, kf, vf, wf, uf, sf, yf, of, BH, T, s); break;
    case 64: launch<64>(rf, kf, vf, wf, uf, sf, yf, of, BH, T, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
