// K2: the backward sweep of the frame-level GRU (K1) for S stacked streams.
//
// Replaces the TPU kernel tggcn/ops/gru_pallas.py::_bwd_kernel (launched by
// _gru_seq_bwd_impl, gru_pallas.py:167). The TPU kernel walks time in
// reverse as its grid, keeps dL/dh in VMEM and recomputes the gates from gi
// and h_prev. Here K1 kept the gates [r | z | hn] of every step, so K2 takes
// no gate product; no block may wait for another, so time is the host loop,
// one launch per step ordered by the stream.
//
// The gate backward C at (t, s, row, unit), elementwise from the kept gates
// and the carried gradient dL/dh = carry + g[t] (n = tanh(gi_n + r hn) is
// recomputed, as K1 computed it):
//   dn = dh (1 - z); dz = dh (h_prev - n); dtanh = dn (1 - n^2);
//   d_ir = dtanh hn r (1 - r); d_iz = dz z (1 - z);
//   dgi = [d_ir, d_iz, dtanh]; dgh = [d_ir, d_iz, dtanh r]; dhz = dh z.
// A step's launch P takes carry = dhz + dgh[t] @ W_hh[s]^T, contracting the
// 3h axis, and in its epilogue each block runs C of the next step for its
// own units from the carry it computed (the carry never leaves the block),
// or writes dh0 = carry after the last step. A first, elementwise launch
// runs C of the first step with a zero carry: T + 1 launches a call. t
// visits time opposite to the forward: T-1 .. 0 for the forward streams,
// 0 .. T-1 for the trailing num_reverse.
//
// P runs on the tensor cores through tc_gemm.cuh (mma.sync TF32, 3xTF32
// split: float32 accuracy), reading W_hh as stored: its rows are the units,
// so the product contracts along the weight's columns (kColRows), and no
// transposed copy is made. A block owns 32 units (two m16 tiles) of one
// stream and up to 32 rows over the whole 3h depth (12 chunks of 128 at
// h = 512): 96 blocks at the MPHOI shape, one wave on 132 SMs; 16 units a
// block (192 blocks) took 27% longer (PERF.md). The warps' partial sums are
// added in a fixed order, so a call gives the same bits on every run. dW_hh
// and db_hh are reduced outside, as one product over h_prev x dgh.
//
// Bound on an H100: one product of 2*R*h*3h per stream and step, 2*T*S*R*h*3h
// = 50 GFLOP at T=167, S=6, R=32, h=512: 0.31 ms as 3xTF32 at a third of 495
// TFLOP/s (the design that recomputed gh took two products, 0.61 ms). W_hh
// (19 MB) stays in L2 and is read every step; HBM carries gi's n block, the
// gates, h_prev and g in and dgi, dgh out (about 0.9 GB).

#include "tc_gemm.cuh"

namespace {

using namespace tggcn::tc;

__device__ __forceinline__ int time_of(int s, int S, int num_reverse, int step, int T) {
  return s >= S - num_reverse ? step : T - 1 - step;
}

struct CellArgs {
  const float *gi, *hprev, *g, *gates;   // gi, gates (T, S, R, 3h); hprev, g (T, S, R, h)
  float *dgi, *dgh, *dhz;                 // dgi, dgh (T, S, R, 3h); dhz (S, R, h)
};

// Phase C at (t, s, row, unit) from the carry dL/dh of the step before.
__device__ __forceinline__ void cell_bwd(const CellArgs& c, int t, int s, int S, int R, int H,
                                         int row, int unit, float carry) {
  const size_t at = ((size_t)t * S + s) * R + row;
  const size_t g3 = at * 3 * H, h1 = at * H + unit;
  const float rg = c.gates[g3 + unit], zg = c.gates[g3 + H + unit];
  const float hn = c.gates[g3 + 2 * H + unit];
  const float ng = tanhf(c.gi[g3 + 2 * H + unit] + rg * hn);
  const float dh = carry + c.g[h1];
  const float dz = dh * (c.hprev[h1] - ng);
  const float dtanh = dh * (1.f - zg) * (1.f - ng * ng);
  const float d_ir = dtanh * hn * rg * (1.f - rg);
  const float d_iz = dz * zg * (1.f - zg);
  c.dgi[g3 + unit] = d_ir;
  c.dgi[g3 + H + unit] = d_iz;
  c.dgi[g3 + 2 * H + unit] = dtanh;
  c.dgh[g3 + unit] = d_ir;
  c.dgh[g3 + H + unit] = d_iz;
  c.dgh[g3 + 2 * H + unit] = dtanh * rg;
  c.dhz[((size_t)s * R + row) * H + unit] = dh * zg;
}

// C of the first step (zero carry); grid (ceil(R * H / kThreads), S).
__global__ void __launch_bounds__(kThreads)
gru_bwd_first(CellArgs c, int T, int S, int R, int H, int num_reverse) {
  const int s = blockIdx.y;
  const int t = time_of(s, S, num_reverse, 0, T);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < R * H) cell_bwd(c, t, s, S, R, H, i / H, i % H, 0.f);
}

constexpr int kTiles = 2;
constexpr int kUnits = kTiles * kMTile;   // hidden units a block owns
constexpr size_t kSmem = smem_bytes<true, kTiles, kTiles>();

// carry = dhz + dgh[t] @ W_hh[s]^T for the block's kUnits units, then C of
// the next step from it (or dh0 = carry after the last).
__global__ void __launch_bounds__(kThreads)
gru_bwd_carry(CellArgs c, const float* __restrict__ w_hh, float* __restrict__ dh0, int T,
              int S, int R, int H, int num_reverse, int step) {
  const int s = blockIdx.z;
  const int row0 = blockIdx.y * kMaxRows;
  const int unit0 = blockIdx.x * kUnits;
  const int rows = min(kMaxRows, R - row0);
  const int t = time_of(s, S, num_reverse, step, T);

  extern __shared__ __align__(16) unsigned char smem[];
  float acc[kTiles][kNTiles][4] = {};
  const Operand op = {c.dgh + (((size_t)t * S + s) * R + row0) * 3 * H, 3 * H,
                      w_hh + (size_t)s * H * 3 * H, 3 * H, 3 * H};
  Tiles tiles = {};
#pragma unroll
  for (int u = 0; u < kTiles; ++u) {
    tiles.col[u] = unit0 + u * kMTile;
    tiles.valid[u] = max(0, min(kMTile, H - unit0 - u * kMTile));
  }
  accumulate<true, kTiles, kTiles, 1, TileSlots>(op, op, op, tiles, rows, smem, acc);
  store_partials<kTiles>(smem, acc);
  __syncthreads();
  const bool last = step + 1 == T;
  const int next = last ? t : time_of(s, S, num_reverse, step + 1, T);
  for (int p = threadIdx.x; p < kUnits * kMaxRows; p += kThreads) {
    const int cu = p % kUnits, r = p / kUnits;
    const int row = row0 + r, unit = unit0 + cu;
    if (r >= rows || unit >= H) continue;
    const size_t hs = ((size_t)s * R + row) * H + unit;
    const float carry = c.dhz[hs] + reduce<kTiles>(smem, cu / kMTile, cu % kMTile, r);
    if (last)
      dh0[hs] = carry;
    else
      cell_bwd(c, next, s, S, R, H, row, unit, carry);
  }
}

}  // namespace

// Runs the whole backward sweep: the first step's C, then one launch P per
// step on `stream`, in order. gates (T, S, R, 3h) are K1's kept [r | z |
// hn]; dhz (S, R, h) is scratch; dh0 (S, R, h) receives dL/dh0. Returns the
// first CUDA error of a launch (0 when all were accepted). H % 4 == 0,
// T >= 1.
extern "C" int tggcn_gru_sequence_bwd_f32(const float* gi, const float* hprev,
                                          const float* g, const float* gates,
                                          const float* w_hh, float* dgi, float* dgh,
                                          float* dhz, float* dh0, int T, int S, int R, int H,
                                          int num_reverse, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (H % 4 != 0 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const CellArgs c = {gi, hprev, g, gates, dgi, dgh, dhz};
  cudaError_t err = cudaFuncSetAttribute(gru_bwd_carry,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_c((R * H + kThreads - 1) / kThreads, S);
  const dim3 grid_p((H + kUnits - 1) / kUnits, (R + kMaxRows - 1) / kMaxRows, S);
  gru_bwd_first<<<grid_c, kThreads, 0, stream>>>(c, T, S, R, H, num_reverse);
  for (int step = 0; step < T; ++step) {
    gru_bwd_carry<<<grid_p, kThreads, kSmem, stream>>>(c, w_hh, dh0, T, S, R, H, num_reverse,
                                                       step);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
