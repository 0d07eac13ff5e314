// K1: the frame-level GRU over a whole sequence for S stacked streams.
//
// Replaces the TPU kernel tggcn/ops/gru_pallas.py::_fwd_kernel (launched by
// _gru_seq_fwd_impl, gru_pallas.py:147). The TPU kernel walks time as its
// grid and keeps W_hh and the state resident in VMEM. Here the blocks of a
// launch run in parallel with no order and no block may wait for another,
// so time is the host loop: one launch per step, and the stream order of
// the launches carries the state from step to step through `out`.
//
// One step, for stream s and row r:
//   gh = h_prev @ W_hh[s] + b_hh[s]                 (gates r, z, n)
//   r = sigmoid(gi_r + gh_r); z = sigmoid(gi_z + gh_z)
//   n = tanh(gi_n + r * gh_n);  h = (1 - z) * n + z * h_prev
// A block owns 32 rows and 16 hidden units of one stream and computes their
// three gate columns with the pipelined, register-tiled product of
// tile_gemm.cuh (W_hh is read once per step); the gate math then runs once
// per (row, unit). Streams s >= S -
// num_reverse run backward in time (the backward directions of a BiGRU).
//
// Bound on an H100: 2*T*S*R*h*3h operations, 50 GFLOP at T=167, S=6, R=32,
// h=512: 0.75 ms of float32 FMAs at 67 TFLOP/s, as this kernel runs them,
// or 0.31 ms as 3xTF32 on the tensor cores (float32 accuracy at a third of
// 495 TFLOP/s), the bound chip_smoke.py holds it to. W_hh (19 MB at that shape) is read once per step from
// L2, where it stays resident (50 MB); the bytes that must cross HBM
// (gi in, h out, W_hh once) are about 280 MB.

#include "tile_gemm.cuh"

namespace {

using namespace tggcn;

__global__ void __launch_bounds__(kThreads)
gru_step_kernel(const float* __restrict__ gi,     // (T, S, R, 3h)
                const float* __restrict__ w_hh,   // (S, h, 3h)
                const float* __restrict__ b_hh,   // (S, 3h)
                const float* __restrict__ h0,     // (S, R, h)
                float* __restrict__ out,          // (T, S, R, h)
                int T, int S, int R, int H, int num_reverse, int step) {
  const int s = blockIdx.z;
  const int row0 = blockIdx.y * kTileRows;
  const int unit0 = blockIdx.x * kTileUnits;
  const bool reverse = s >= S - num_reverse;
  const int t = reverse ? T - 1 - step : step;
  const float* h_prev = step == 0
      ? h0 + (size_t)s * R * H
      : out + ((size_t)(reverse ? t + 1 : t - 1) * S + s) * R * H;

  extern __shared__ __align__(16) unsigned char smem[];
  float acc[4][4][3] = {};
  const Operand op = {h_prev, H, w_hh + (size_t)s * H * 3 * H, 3 * H, H, H};
  accumulate<3, 1, 3>(op, op, R, H, row0, unit0, smem, acc);
  store_partials<3>(smem, acc);
  __syncthreads();

  for (int i = 0; i < kEpiloguePairs; ++i) {
    const int p = threadIdx.x + i * kThreads, r = p / kTileUnits, c = p % kTileUnits;
    const int row = row0 + r, unit = unit0 + c;
    if (row >= R || unit >= H) continue;
    const float* g = gi + (((size_t)t * S + s) * R + row) * 3 * H;
    const float* b = b_hh + (size_t)s * 3 * H;
    const float rg = sigmoid_f(g[unit] + (reduce_partials<3>(smem, 0, r, c) + b[unit]));
    const float zg = sigmoid_f(g[H + unit] + (reduce_partials<3>(smem, 1, r, c) + b[H + unit]));
    const float ng = tanhf(g[2 * H + unit]
                           + rg * (reduce_partials<3>(smem, 2, r, c) + b[2 * H + unit]));
    const float hp = h_prev[(size_t)row * H + unit];
    out[(((size_t)t * S + s) * R + row) * H + unit] = (1.f - zg) * ng + zg * hp;
  }
}

}  // namespace

// Runs the whole sequence: T launches on `stream`, in order. Returns the
// first CUDA error of a launch (0 when all were accepted). H % 4 == 0.
extern "C" int tggcn_gru_sequence_f32(const float* gi, const float* w_hh,
                                      const float* b_hh, const float* h0,
                                      float* out, int T, int S, int R, int H,
                                      int num_reverse, void* stream) {
  const size_t smem = smem_bytes<3, 3>();
  cudaError_t err = cudaFuncSetAttribute(gru_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + kTileUnits - 1) / kTileUnits, (R + kTileRows - 1) / kTileRows, S);
  for (int step = 0; step < T; ++step) {
    gru_step_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        gi, w_hh, b_hh, h0, out, T, S, R, H, num_reverse, step);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
