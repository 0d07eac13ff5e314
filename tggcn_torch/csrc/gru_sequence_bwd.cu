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
//
// bfloat16 (T = bf16: gi, hprev, g, W_hh in; dgi, dgh, dh0 out), as the TPU
// kernel runs it (gru_pallas.py:97-126): the carry stays float32, and the
// carry product takes the float32 dgh, as the TPU kernel's dgh_s @ W^T
// does, not the bfloat16 dgh it writes out: C also writes the step's dgh in
// float32 to dgh32 (two slots by step parity: a launch reads its step's
// while its epilogue writes the next step's). The product is float32 dgh
// against W_hh's bfloat16 values, exact in TF32: two TF32 products, float32
// accuracy. The kept gates are float32. Bound: 2*T*S*R*h*3h at half the
// TF32 rate, 0.20 ms at the MPHOI shape.

#include "tc_gemm.cuh"

namespace {

using namespace tggcn::tc;

__device__ __forceinline__ int time_of(int s, int S, int num_reverse, int step, int T) {
  return s >= S - num_reverse ? step : T - 1 - step;
}

template <class T>
struct CellArgs {
  const T *gi, *hprev, *g;                // gi (T, S, R, 3h); hprev, g (T, S, R, h)
  const float* gates;                     // (T, S, R, 3h)
  T *dgi, *dgh;                           // (T, S, R, 3h)
  float *dhz, *dgh32;                     // dhz (S, R, h); bf16: dgh32 (2, S, R, 3h)
};

// Phase C at (t, s, row, unit) from the carry dL/dh of the step before; the
// step's index is `step` (its dgh32 slot).
template <class T>
__device__ __forceinline__ void cell_bwd(const CellArgs<T>& c, int t, int s, int S, int R,
                                         int H, int row, int unit, float carry, int step) {
  const size_t at = ((size_t)t * S + s) * R + row;
  const size_t g3 = at * 3 * H, h1 = at * H + unit;
  const float rg = c.gates[g3 + unit], zg = c.gates[g3 + H + unit];
  const float hn = c.gates[g3 + 2 * H + unit];
  const float ng = tanhf(to_f32(c.gi[g3 + 2 * H + unit]) + rg * hn);
  const float dh = carry + to_f32(c.g[h1]);
  const float dz = dh * (to_f32(c.hprev[h1]) - ng);
  const float dtanh = dh * (1.f - zg) * (1.f - ng * ng);
  const float d_ir = dtanh * hn * rg * (1.f - rg);
  const float d_iz = dz * zg * (1.f - zg);
  c.dgi[g3 + unit] = from_f32<T>(d_ir);
  c.dgi[g3 + H + unit] = from_f32<T>(d_iz);
  c.dgi[g3 + 2 * H + unit] = from_f32<T>(dtanh);
  c.dgh[g3 + unit] = from_f32<T>(d_ir);
  c.dgh[g3 + H + unit] = from_f32<T>(d_iz);
  c.dgh[g3 + 2 * H + unit] = from_f32<T>(dtanh * rg);
  if constexpr (IsBf16<T>::value) {
    float* d32 = c.dgh32 + (((size_t)(step & 1) * S + s) * R + row) * 3 * H + unit;
    d32[0] = d_ir;
    d32[H] = d_iz;
    d32[2 * H] = dtanh * rg;
  }
  c.dhz[((size_t)s * R + row) * H + unit] = dh * zg;
}

// C of the first step (zero carry); grid (ceil(R * H / kThreads), S).
template <class T>
__global__ void __launch_bounds__(kThreads)
gru_bwd_first(CellArgs<T> c, int T_, int S, int R, int H, int num_reverse) {
  const int s = blockIdx.y;
  const int t = time_of(s, S, num_reverse, 0, T_);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < R * H) cell_bwd(c, t, s, S, R, H, i / H, i % H, 0.f, 0);
}

constexpr int kTiles = 2;
constexpr int kUnits = kTiles * kMTile;   // hidden units a block owns
template <class T>
constexpr size_t kSmem = smem_bytes<true, kTiles, kTiles, kStages, T, float>();

// carry = dhz + dgh[t] @ W_hh[s]^T for the block's kUnits units (dgh in
// float32: the output itself, or dgh32 with bfloat16 IO), then C of the
// next step from it (or dh0 = carry after the last).
template <class T>
__global__ void __launch_bounds__(kThreads)
gru_bwd_carry(CellArgs<T> c, const T* __restrict__ w_hh, T* __restrict__ dh0, int T_, int S,
              int R, int H, int num_reverse, int step) {
  const int s = blockIdx.z;
  const int row0 = blockIdx.y * kMaxRows;
  const int unit0 = blockIdx.x * kUnits;
  const int rows = min(kMaxRows, R - row0);
  const int t = time_of(s, S, num_reverse, step, T_);

  extern __shared__ __align__(16) unsigned char smem[];
  float acc[kTiles][kNTiles][4] = {};
  const float* dgh;
  if constexpr (IsBf16<T>::value)
    dgh = c.dgh32 + (((size_t)(step & 1) * S + s) * R + row0) * 3 * H;
  else
    dgh = c.dgh + (((size_t)t * S + s) * R + row0) * 3 * H;
  const OperandT<T, float> op = {dgh, 3 * H, w_hh + (size_t)s * H * 3 * H, 3 * H, 3 * H};
  Tiles tiles = {};
#pragma unroll
  for (int u = 0; u < kTiles; ++u) {
    tiles.col[u] = unit0 + u * kMTile;
    tiles.valid[u] = max(0, min(kMTile, H - unit0 - u * kMTile));
  }
  accumulate<true, kTiles, kTiles, 1, TileSlots>(op, op, op, tiles, rows, smem, acc);
  store_partials<kTiles>(smem, acc);
  __syncthreads();
  const bool last = step + 1 == T_;
  const int next = last ? t : time_of(s, S, num_reverse, step + 1, T_);
  for (int p = threadIdx.x; p < kUnits * kMaxRows; p += kThreads) {
    const int cu = p % kUnits, r = p / kUnits;
    const int row = row0 + r, unit = unit0 + cu;
    if (r >= rows || unit >= H) continue;
    const size_t hs = ((size_t)s * R + row) * H + unit;
    const float carry = c.dhz[hs] + reduce<kTiles>(smem, cu / kMTile, cu % kMTile, r);
    if (last)
      dh0[hs] = from_f32<T>(carry);
    else
      cell_bwd(c, next, s, S, R, H, row, unit, carry, step + 1);
  }
}

template <class T>
int run(const CellArgs<T>& c, const T* w_hh, T* dh0, int T_, int S, int R, int H,
        int num_reverse, cudaStream_t stream) {
  if (H % (16 / (int)sizeof(T)) != 0 || T_ < 1 || (IsBf16<T>::value && c.dgh32 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(gru_bwd_carry<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmem<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_c((R * H + kThreads - 1) / kThreads, S);
  const dim3 grid_p((H + kUnits - 1) / kUnits, (R + kMaxRows - 1) / kMaxRows, S);
  gru_bwd_first<T><<<grid_c, kThreads, 0, stream>>>(c, T_, S, R, H, num_reverse);
  for (int step = 0; step < T_; ++step) {
    gru_bwd_carry<T><<<grid_p, kThreads, kSmem<T>, stream>>>(c, w_hh, dh0, T_, S, R, H,
                                                             num_reverse, step);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
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
  const CellArgs<float> c = {gi, hprev, g, gates, dgi, dgh, dhz, nullptr};
  return run<float>(c, w_hh, dh0, T, S, R, H, num_reverse,
                    static_cast<cudaStream_t>(stream_ptr));
}

// The same in bfloat16 IO (the gates float32), with dgh32 (2, S, R, 3h)
// float32 scratch. H % 8 == 0.
extern "C" int tggcn_gru_sequence_bwd_bf16(const bf16* gi, const bf16* hprev, const bf16* g,
                                           const float* gates, const bf16* w_hh, bf16* dgi,
                                           bf16* dgh, float* dhz, bf16* dh0, float* dgh32,
                                           int T, int S, int R, int H, int num_reverse,
                                           void* stream_ptr) {
  const CellArgs<bf16> c = {gi, hprev, g, gates, dgi, dgh, dhz, dgh32};
  return run<bf16>(c, w_hh, dh0, T, S, R, H, num_reverse,
                   static_cast<cudaStream_t>(stream_ptr));
}
