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
// A block owns 32 hidden units of one stream and up to 32 rows. It takes
// their r, z and n columns of W_hh (six m16 tiles: two a gate, the gates H
// apart) on the tensor cores through tc_gemm.cuh: mma.sync TF32 in the
// 3xTF32 split (float32 accuracy; single-pass TF32 flips hard decisions
// downstream), weight columns on the mma's M side and the step's rows on
// its N side, depth h in 128-deep chunks, each k8 step's sum rounded into
// the running sum (Round: the states feed every hard decision downstream).
// The 16 warps form two groups of three tiles (a thread holds three tiles'
// sums), and the ring holds three 70 KB stages. At the MPHOI shape that is
// 96 blocks, one wave on 132 SMs (one 512-thread block to an SM); 16 units
// a block (three tiles, 192 blocks, 1.45 waves) took 27% longer (PERF.md).
// The gate math then runs once per (row, unit). Streams s >= S -
// num_reverse run backward in time (the backward directions of a BiGRU).
//
// With keep (a gradient will be taken), every step also writes what the
// backward (K2) reads: gates = [r | z | hn], hn = h_prev @ W_hh_n + b_hh_n,
// so K2 takes no gate product; it recomputes n = tanh(gi_n + r hn)
// elementwise (reading gi's n block costs K2 the bytes that a kept n would,
// and K1 writes a third less).
//
// Bound on an H100: 2*T*S*R*h*3h operations, 50 GFLOP at T=167, S=6, R=32,
// h=512: 0.31 ms as 3xTF32 on the tensor cores (a third of 495 TFLOP/s), the
// bound chip_smoke.py holds it to. W_hh (19 MB at that shape) is read once
// per step from L2, where it stays resident (50 MB); the bytes that must
// cross HBM (gi in, h out, W_hh once; with keep the gates out) are about
// 280 MB (480 MB with keep).

#include "tc_gemm.cuh"

namespace {

using namespace tggcn::tc;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

constexpr int kUnits = 2 * kMTile;      // hidden units a block owns
constexpr int kTiles = 3 * kUnits / kMTile;
constexpr int kGroups = 2;              // warp groups of three tiles
constexpr int kRing = 3;
constexpr size_t kSmem = smem_bytes<false, kTiles, kTiles / kGroups, kRing>();

__global__ void __launch_bounds__(kThreads)
gru_step_kernel(const float* __restrict__ gi,     // (T, S, R, 3h)
                const float* __restrict__ w_hh,   // (S, h, 3h)
                const float* __restrict__ b_hh,   // (S, 3h)
                const float* __restrict__ h0,     // (S, R, h)
                float* __restrict__ out,          // (T, S, R, h)
                float* __restrict__ gates,        // (T, S, R, 3h) with keep
                int keep, int T, int S, int R, int H, int num_reverse, int step) {
  constexpr int U = kUnits / kMTile;
  const int s = blockIdx.z;
  const int row0 = blockIdx.y * kMaxRows;
  const int unit0 = blockIdx.x * kUnits;
  const int rows = min(kMaxRows, R - row0);
  const bool reverse = s >= S - num_reverse;
  const int t = reverse ? T - 1 - step : step;
  const float* h_prev = step == 0
      ? h0 + (size_t)s * R * H
      : out + ((size_t)(reverse ? t + 1 : t - 1) * S + s) * R * H;

  extern __shared__ __align__(16) unsigned char smem[];
  float acc[kTiles / kGroups][kNTiles][4] = {};
  const Operand op = {h_prev + (size_t)row0 * H, H, w_hh + (size_t)s * H * 3 * H, 3 * H, H};
  Tiles tiles = {};
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {      // tile i: gate i / U, units (i % U) * 16 ..
    const int first = unit0 + (i % U) * kMTile;
    tiles.col[i] = (i / U) * H + first;
    tiles.valid[i] = max(0, min(kMTile, H - first));
  }
  accumulate<false, kTiles, kTiles / kGroups, 1, TileSlots, kRing, kGroups, true>(
      op, op, op, tiles, rows, smem, acc);
  store_partials<kTiles / kGroups>(smem, acc);
  __syncthreads();

  const float* b = b_hh + (size_t)s * 3 * H;
  const size_t ts = (size_t)t * S + s;
  for (int p = threadIdx.x; p < kUnits * kMaxRows; p += kThreads) {
    const int c = p % kUnits, r = p / kUnits;
    const int row = row0 + r, unit = unit0 + c;
    if (r >= rows || unit >= H) continue;
    const int u = c / kMTile, m = c % kMTile;
    const auto gate = [&](int i) {              // the product of gate i's tile
      return reduce<kTiles / kGroups, kGroups>(smem, i * U + u, m, r);
    };
    const float* g = gi + (ts * R + row) * 3 * H;
    const float rg = sigmoid_f(g[unit] + (gate(0) + b[unit]));
    const float zg = sigmoid_f(g[H + unit] + (gate(1) + b[H + unit]));
    const float hn = gate(2) + b[2 * H + unit];
    const float ng = tanhf(g[2 * H + unit] + rg * hn);
    const float hp = h_prev[(size_t)row * H + unit];
    out[(ts * R + row) * H + unit] = (1.f - zg) * ng + zg * hp;
    if (keep) {
      float* kept = gates + (ts * R + row) * 3 * H + unit;
      kept[0] = rg;
      kept[H] = zg;
      kept[2 * H] = hn;
    }
  }
}

}  // namespace

// Runs the whole sequence: T launches on `stream`, in order. With keep,
// gates (T, S, R, 3h) receives [r | z | hn] of every step; without, it may
// be null. Returns the first CUDA error of a launch (0 when all were
// accepted). H % 4 == 0.
extern "C" int tggcn_gru_sequence_f32(const float* gi, const float* w_hh,
                                      const float* b_hh, const float* h0,
                                      float* out, float* gates, int keep, int T, int S,
                                      int R, int H, int num_reverse, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (H % 4 != 0 || (keep && gates == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(gru_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + kUnits - 1) / kUnits, (R + kMaxRows - 1) / kMaxRows, S);
  for (int step = 0; step < T; ++step) {
    gru_step_kernel<<<grid, kThreads, kSmem, stream>>>(gi, w_hh, b_hh, h0, out, gates, keep, T,
                                                       S, R, H, num_reverse, step);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
