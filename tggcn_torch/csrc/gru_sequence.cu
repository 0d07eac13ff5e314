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
//
// bfloat16 (T = bf16: gi, W_hh, b_hh, h0 and the states out in bfloat16),
// as the TPU kernel runs it (gru_pallas.py:61-77): the state stays float32,
// in a buffer of its own (state: two slots by step parity, since a step's
// product reads every unit of the state the step before wrote), not in the
// bfloat16 output, which would round the carried state at every step. The
// product takes that float32 state against W_hh's bfloat16 values, which
// TF32 holds exactly: two TF32 products (the state's high and low parts),
// float32 accuracy, W_hh at half the shared-memory bytes; each k8 step
// still rounds into the running sum (Round). The gates, gi and b_hh are
// read as float32; the kept gates are float32. Bound: 2*T*S*R*h*3h at half
// the TF32 rate (two products), 0.20 ms at the MPHOI shape.

#include "tc_gemm.cuh"

namespace {

using namespace tggcn::tc;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

constexpr int kUnits = 2 * kMTile;      // hidden units a block owns
constexpr int kTiles = 3 * kUnits / kMTile;
constexpr int kGroups = 2;              // warp groups of three tiles
constexpr int kRing = 3;
template <class T>
constexpr size_t kSmem = smem_bytes<false, kTiles, kTiles / kGroups, kRing, T, float>();

template <class T>
__global__ void __launch_bounds__(kThreads)
gru_step_kernel(const T* __restrict__ gi,         // (T, S, R, 3h)
                const T* __restrict__ w_hh,       // (S, h, 3h)
                const T* __restrict__ b_hh,       // (S, 3h)
                const T* __restrict__ h0,         // (S, R, h)
                T* __restrict__ out,              // (T, S, R, h)
                float* __restrict__ state,        // bf16: (2, S, R, h), slot 1 = h0 at first
                float* __restrict__ gates,        // (T, S, R, 3h) with keep
                int keep, int T_, int S, int R, int H, int num_reverse, int step) {
  constexpr int U = kUnits / kMTile;
  constexpr bool kF32 = !IsBf16<T>::value;
  const int s = blockIdx.z;
  const int row0 = blockIdx.y * kMaxRows;
  const int unit0 = blockIdx.x * kUnits;
  const int rows = min(kMaxRows, R - row0);
  const bool reverse = s >= S - num_reverse;
  const int t = reverse ? T_ - 1 - step : step;
  // The float32 state this step reads, and with bfloat16 IO where it writes.
  const float* h_prev;
  float* h_next = nullptr;
  if constexpr (kF32) {
    h_prev = step == 0 ? h0 + (size_t)s * R * H
                       : out + ((size_t)(reverse ? t + 1 : t - 1) * S + s) * R * H;
  } else {
    h_prev = state + ((size_t)((step + 1) & 1) * S + s) * R * H;
    h_next = state + ((size_t)(step & 1) * S + s) * R * H;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  float acc[kTiles / kGroups][kNTiles][4] = {};
  const OperandT<T, float> op = {h_prev + (size_t)row0 * H, H, w_hh + (size_t)s * H * 3 * H,
                                 3 * H, H};
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

  const T* b = b_hh + (size_t)s * 3 * H;
  const size_t ts = (size_t)t * S + s;
  for (int p = threadIdx.x; p < kUnits * kMaxRows; p += kThreads) {
    const int c = p % kUnits, r = p / kUnits;
    const int row = row0 + r, unit = unit0 + c;
    if (r >= rows || unit >= H) continue;
    const int u = c / kMTile, m = c % kMTile;
    const auto gate = [&](int i) {              // the product of gate i's tile
      return reduce<kTiles / kGroups, kGroups>(smem, i * U + u, m, r);
    };
    const T* g = gi + (ts * R + row) * 3 * H;
    const float rg = sigmoid_f(to_f32(g[unit]) + (gate(0) + to_f32(b[unit])));
    const float zg = sigmoid_f(to_f32(g[H + unit]) + (gate(1) + to_f32(b[H + unit])));
    const float hn = gate(2) + to_f32(b[2 * H + unit]);
    const float ng = tanhf(to_f32(g[2 * H + unit]) + rg * hn);
    const float hp = h_prev[(size_t)row * H + unit];
    const float h = (1.f - zg) * ng + zg * hp;
    out[(ts * R + row) * H + unit] = from_f32<T>(h);
    if constexpr (!kF32) h_next[(size_t)row * H + unit] = h;
    if (keep) {
      float* kept = gates + (ts * R + row) * 3 * H + unit;
      kept[0] = rg;
      kept[H] = zg;
      kept[2 * H] = hn;
    }
  }
}

template <class T>
int run(const T* gi, const T* w_hh, const T* b_hh, const T* h0, T* out, float* state,
        float* gates, int keep, int T_, int S, int R, int H, int num_reverse,
        cudaStream_t stream) {
  if (H % (16 / (int)sizeof(T)) != 0 || (keep && gates == nullptr) ||
      (IsBf16<T>::value && state == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(gru_step_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmem<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + kUnits - 1) / kUnits, (R + kMaxRows - 1) / kMaxRows, S);
  for (int step = 0; step < T_; ++step) {
    gru_step_kernel<T><<<grid, kThreads, kSmem<T>, stream>>>(gi, w_hh, b_hh, h0, out, state,
                                                             gates, keep, T_, S, R, H,
                                                             num_reverse, step);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
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
  return run<float>(gi, w_hh, b_hh, h0, out, nullptr, gates, keep, T, S, R, H, num_reverse,
                    static_cast<cudaStream_t>(stream_ptr));
}

// The same in bfloat16 IO: state (2, S, R, h) float32 holds h0 in slot 1
// at the call; the gates are float32. H % 8 == 0.
extern "C" int tggcn_gru_sequence_bf16(const bf16* gi, const bf16* w_hh, const bf16* b_hh,
                                       const bf16* h0, bf16* out, float* state, float* gates,
                                       int keep, int T, int S, int R, int H, int num_reverse,
                                       void* stream_ptr) {
  return run<bf16>(gi, w_hh, b_hh, h0, out, state, gates, keep, T, S, R, H, num_reverse,
                   static_cast<cudaStream_t>(stream_ptr));
}
