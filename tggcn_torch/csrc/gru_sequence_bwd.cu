// K2: the backward sweep of the frame-level GRU (K1) for S stacked streams.
//
// Replaces the TPU kernel tggcn/ops/gru_pallas.py::_bwd_kernel (launched by
// _gru_seq_bwd_impl, gru_pallas.py:167). The TPU kernel walks time in
// reverse as its grid, keeps dL/dh in VMEM and recomputes the gates from gi
// and h_prev. Here no block may wait for another, so time is the host loop
// again: two launches per step, ordered by the stream, and the carry dL/dh
// lives in device memory (`carry`, which ends as dh0).
//
// One step, for stream s and row r (t visits time opposite to the forward:
// T-1 .. 0 for the forward streams, 0 .. T-1 for the trailing num_reverse):
//   A  gate:  gh = h_prev @ W_hh[s] + b_hh[s] (the recompute), r, z, n;
//             dh = carry + g[t]; dn = dh (1 - z); dz = dh (h_prev - n);
//             dtanh = dn (1 - n^2); d_ir = dtanh gh_n r (1 - r);
//             d_iz = dz z (1 - z); dgi = [d_ir, d_iz, dtanh];
//             dgh = [d_ir, d_iz, dtanh r]; dhz = dh z.
//   B  carry: carry = dhz + dgh @ W_hh[s]^T, contracting the 3h axis.
// A is K1's product (blocks own 32 rows x 16 hidden units in all three
// gates). B multiplies by W_hh^T, which the caller passes transposed
// (S, 3h, h) so that tile_gemm.cuh reads it as it reads any (K, N) weight.
// dW_hh and db_hh are reduced outside, as one product over h_prev x dgh.
//
// Bound on an H100: two products of 2*R*h*3h per stream and step:
// 2*2*T*S*R*h*3h = 101 GFLOP at T=167, S=6, R=32, h=512, 1.5 ms of float32
// FMAs at 67 TFLOP/s, as this kernel runs them, or 0.61 ms as 3xTF32 on the
// tensor cores, the bound chip_smoke.py holds it to. W_hh and its transpose (38 MB) stay in L2 and are read every
// step; HBM carries gi, h_prev and g in and dgi, dgh out (about 0.8 GB).

#include "tile_gemm.cuh"

namespace {

using namespace tggcn;

__device__ __forceinline__ int time_of(int s, int S, int num_reverse, int step, int T) {
  return s >= S - num_reverse ? step : T - 1 - step;
}

__global__ void __launch_bounds__(kThreads)
gru_bwd_gate_kernel(const float* __restrict__ gi,     // (T, S, R, 3h)
                    const float* __restrict__ hprev,  // (T, S, R, h)
                    const float* __restrict__ g,      // (T, S, R, h)
                    const float* __restrict__ w_hh,   // (S, h, 3h)
                    const float* __restrict__ b_hh,   // (S, 3h)
                    const float* __restrict__ carry,  // (S, R, h)
                    float* __restrict__ dgi,          // (T, S, R, 3h)
                    float* __restrict__ dgh,          // (T, S, R, 3h)
                    float* __restrict__ dhz,          // (S, R, h)
                    int T, int S, int R, int H, int num_reverse, int step) {
  const int s = blockIdx.z;
  const int row0 = blockIdx.y * kTileRows;
  const int unit0 = blockIdx.x * kTileUnits;
  const int t = time_of(s, S, num_reverse, step, T);
  const size_t ts = (size_t)t * S + s;
  const float* hp = hprev + ts * R * H;

  extern __shared__ __align__(16) unsigned char smem[];
  float acc[4][4][3] = {};
  const Operand op = {hp, H, w_hh + (size_t)s * H * 3 * H, 3 * H, H, H};
  accumulate<3, 1, 3>(op, op, R, H, row0, unit0, smem, acc);
  store_partials<3>(smem, acc);
  __syncthreads();

  for (int i = 0; i < kEpiloguePairs; ++i) {
    const int p = threadIdx.x + i * kThreads, r = p / kTileUnits, c = p % kTileUnits;
    const int row = row0 + r, unit = unit0 + c;
    if (row >= R || unit >= H) continue;
    const size_t g3 = (ts * R + row) * 3 * H;
    const float* gr = gi + g3;
    const float* b = b_hh + (size_t)s * 3 * H;
    const float rg = sigmoid_f(gr[unit] + (reduce_partials<3>(smem, 0, r, c) + b[unit]));
    const float zg = sigmoid_f(gr[H + unit] + (reduce_partials<3>(smem, 1, r, c) + b[H + unit]));
    const float hn = reduce_partials<3>(smem, 2, r, c) + b[2 * H + unit];
    const float ng = tanhf(gr[2 * H + unit] + rg * hn);
    const size_t hs = (size_t)s * R * H + (size_t)row * H + unit;
    const float dh = carry[hs] + g[(ts * R + row) * H + unit];
    const float dz = dh * (hp[(size_t)row * H + unit] - ng);
    const float dtanh = dh * (1.f - zg) * (1.f - ng * ng);
    const float d_ir = dtanh * hn * rg * (1.f - rg);
    const float d_iz = dz * zg * (1.f - zg);
    dgi[g3 + unit] = d_ir;
    dgi[g3 + H + unit] = d_iz;
    dgi[g3 + 2 * H + unit] = dtanh;
    dgh[g3 + unit] = d_ir;
    dgh[g3 + H + unit] = d_iz;
    dgh[g3 + 2 * H + unit] = dtanh * rg;
    dhz[hs] = dh * zg;
  }
}

__global__ void __launch_bounds__(kThreads)
gru_bwd_carry_kernel(const float* __restrict__ dgh,   // (T, S, R, 3h)
                     const float* __restrict__ w_t,   // (S, 3h, h): W_hh transposed
                     const float* __restrict__ dhz,   // (S, R, h)
                     float* __restrict__ carry,       // (S, R, h)
                     int T, int S, int R, int H, int num_reverse, int step) {
  const int s = blockIdx.z;
  const int row0 = blockIdx.y * kTileRows;
  const int unit0 = blockIdx.x * kTileUnits;
  const int t = time_of(s, S, num_reverse, step, T);

  extern __shared__ __align__(16) unsigned char smem[];
  float acc[4][4][1] = {};
  const Operand op = {dgh + ((size_t)t * S + s) * R * 3 * H, 3 * H,
                      w_t + (size_t)s * 3 * H * H, H, 0, 3 * H};
  accumulate<1, 1, 1>(op, op, R, H, row0, unit0, smem, acc);
  store_partials<1>(smem, acc);
  __syncthreads();
  for (int i = 0; i < kEpiloguePairs; ++i) {
    const int p = threadIdx.x + i * kThreads, r = p / kTileUnits, c = p % kTileUnits;
    const int row = row0 + r, unit = unit0 + c;
    if (row >= R || unit >= H) continue;
    const size_t hs = (size_t)s * R * H + (size_t)row * H + unit;
    carry[hs] = dhz[hs] + reduce_partials<1>(smem, 0, r, c);
  }
}

}  // namespace

// Runs the whole backward sweep: per step the launches A and B on `stream`,
// in order. `carry` must hold zeros on entry and holds dh0 on return.
// Returns the first CUDA error of a launch (0 when all were accepted).
// H % 4 == 0.
extern "C" int tggcn_gru_sequence_bwd_f32(const float* gi, const float* hprev,
                                          const float* g, const float* w_hh,
                                          const float* w_t, const float* b_hh,
                                          float* dgi, float* dgh, float* dhz,
                                          float* carry, int T, int S, int R, int H,
                                          int num_reverse, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem_a = smem_bytes<3, 3>(), smem_b = smem_bytes<1, 1>();
  cudaError_t err = cudaFuncSetAttribute(gru_bwd_gate_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_a);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gru_bwd_carry_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + kTileUnits - 1) / kTileUnits, (R + kTileRows - 1) / kTileRows, S);
  for (int step = 0; step < T; ++step) {
    gru_bwd_gate_kernel<<<grid, kThreads, smem_a, stream>>>(
        gi, hprev, g, w_hh, b_hh, carry, dgi, dgh, dhz, T, S, R, H, num_reverse, step);
    gru_bwd_carry_kernel<<<grid, kThreads, smem_b, stream>>>(
        dgh, w_t, dhz, carry, T, S, R, H, num_reverse, step);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
