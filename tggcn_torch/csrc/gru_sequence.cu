// K1: the frame-level GRU over a whole sequence for S stacked streams.
//
// Replaces the TPU kernel tggcn/ops/gru_pallas.py::_fwd_kernel (launched by
// _gru_seq_fwd_impl, gru_pallas.py:147). The TPU kernel walks time as its
// grid and keeps W_hh and the state resident in VMEM. Two routes here:
//   - bfloat16 at h <= 512: gru_cluster_kernel, one launch a call. The
//     blocks of one (stream, row tile) form a thread-block cluster that
//     holds the stream's W_hh in its blocks' registers for all T steps,
//     exchanges the state through distributed shared memory and waits at
//     one cluster barrier a step (gru_cluster.cuh: the plan and the rule).
//   - float32, and bfloat16 at h > 512: gru_step_kernel, one launch a step,
//     whose blocks wait on no other block; the launches' order on the
//     stream carries the state from step to step. float32 W_hh is 3 MB a
//     stream, 192 KB a block at 16 blocks: it does not fit a cluster's
//     shared memory next to the state (ROADMAP.md queues it).
// The route is chosen from the dtype and h before any launch.
//
// One step, for stream s and row r:
//   gh = h_prev @ W_hh[s] + b_hh[s]                 (gates r, z, n)
//   r = sigmoid(gi_r + gh_r); z = sigmoid(gi_z + gh_z)
//   n = tanh(gi_n + r * gh_n);  h = (1 - z) * n + z * h_prev
// Streams s >= S - num_reverse run backward in time (the backward
// directions of a BiGRU). With keep (a gradient will be taken), every step
// also writes what the backward (K2) reads: gates = [r | z | hn], hn =
// h_prev @ W_hh_n + b_hh_n, so K2 takes no gate product; it recomputes n =
// tanh(gi_n + r hn) elementwise (reading gi's n block costs K2 the bytes
// that a kept n would, and K1 writes a third less).
//
// The per-step kernel. A block owns 32 hidden units of one stream and up
// to 32 rows. It takes their r, z and n columns of W_hh (six m16 tiles: two
// a gate, the gates H apart) on the tensor cores through tc_gemm.cuh:
// mma.sync TF32 in the 3xTF32 split (float32 accuracy; single-pass TF32
// flips hard decisions downstream), weight columns on the mma's M side and
// the step's rows on its N side, depth h in 128-deep chunks, each k8 step's
// sum rounded into the running sum (Round: the states feed every hard
// decision downstream). The 16 warps form two groups of three tiles (a
// thread holds three tiles' sums), and the ring holds three 70 KB stages.
// At the MPHOI shape that is 96 blocks, one wave on 132 SMs (one 512-thread
// block to an SM); 16 units a block (three tiles, 192 blocks, 1.45 waves)
// took 27% longer (PERF.md). Each launch reloads W_hh from L2: on the H100
// most of a launch's time went to that copy, not to its product (PERF.md).
//
// Bound on an H100: 2*T*S*R*h*3h operations, 50 GFLOP at T=167, S=6, R=32,
// h=512: 0.31 ms as 3xTF32 on the tensor cores (a third of 495 TFLOP/s), the
// bound chip_smoke.py holds it to; the bytes that must cross HBM (gi in, h
// out, W_hh once; with keep the gates out) are about 280 MB (480 MB with
// keep).
//
// bfloat16 (T = bf16: gi, W_hh, b_hh, h0 and the states out in bfloat16),
// as the TPU kernel runs it (gru_pallas.py:61-77): the state stays float32
// (state: two slots by step parity; slot 1 holds h0 at the call), not in
// the bfloat16 output, which would round the carried state at every step.
// The product takes that float32 state against W_hh's bfloat16 values at
// float32 accuracy; the gates, gi and b_hh are read as float32; the kept
// gates are float32. The per-step kernel takes two TF32 products (the
// state's high and low parts; bfloat16 is exact in TF32). The cluster
// kernel takes three bfloat16 parts of the state on wgmma (gru_cluster.cuh),
// a block's two warpgroups each an M tile of its W_hh slice in registers
// (slice columns 0-63: r and z; 64-127: n and 32 zero columns), and rounds
// every kRound k16 steps' sum into the running sum (Round; each k16 step, a
// fence and a wait a group, was 6% slower at the MPHOI shape, PERF.md).
// Bound: 2*T*S*R*h*3h at a third of the BF16 rate (three products), 0.15
// ms at the MPHOI shape.

#include "gru_cluster.cuh"
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

// The cluster-resident bfloat16 kernel: the whole sequence in one launch
// (gru_cluster.cuh has the plan and the product). Its two warpgroups each
// take one M tile of the block's W_hh slice as wgmma's A (slice columns
// 0-63: r, z; 64-127: n and 32 zero columns) over the whole depth, held in
// registers for all T steps (128 a thread). Shared memory (1024-aligned):
// the B tiles, the state's three bfloat16 parts over the depth of h = 512
// (3 x 8 tiles, 96 KB; depth past h stays zero), first the staging of the
// slice; the warpgroups' sums (2 x 64 x kSumStride float32); the block's
// own slice of the float32 state, two slots by step parity (own[slot]
// [row][unit]), which its peers read.
namespace cl = tggcn::gru;

constexpr int kClusterThreads = 256;
constexpr int kWGroups = kClusterThreads / 128;
constexpr int kK16 = cl::kMaxCluster * kUnits / 16;   // k16 steps over the largest depth, 512
constexpr int kRound = 2;                  // k16 steps a Round group sums in the tensor core
constexpr int kSumStride = 33;
constexpr size_t kBBytes = (size_t)cl::kParts * (kK16 / 4) * cl::kBTileBytes;
constexpr size_t kSumBytes = (size_t)kWGroups * 64 * kSumStride * sizeof(float);
static_assert(kBBytes >= cl::kStageBytes, "the B tiles hold the staging");

size_t cluster_smem(int) {
  return 1024 + kBBytes + kSumBytes + 2 * kMaxRows * kUnits * sizeof(float);
}

// Each step, for the block's units unit0 .. unit0 + 31 and the rows of its
// tile: the peers' slices of the state the step before wrote (slot (step
// + 1) & 1; slot 1 holds h0, from `state`, at the start), split into the B
// tiles' three parts; gh = state @ slice on wgmma, the products of each
// group of kRound k16 steps started from zero and added to the running sum
// in float32 (Round) while the next group's run; the gate math; the new
// state into the block's own slot step & 1; one cluster barrier, while
// which gi of the next step loads.
__global__ void __launch_bounds__(kClusterThreads, 1)
gru_cluster_kernel(const bf16* __restrict__ gi, const bf16* __restrict__ w_hh,
                   const bf16* __restrict__ b_hh, const float* __restrict__ state,
                   bf16* __restrict__ out, float* __restrict__ gates, int keep, int T_, int S,
                   int R, int H, int num_reverse) {
  constexpr int kPairs = kUnits * kMaxRows / kClusterThreads;
  const int C = gridDim.x, rank = blockIdx.x;
  const int s = blockIdx.z;
  const int row0 = blockIdx.y * kMaxRows;
  const int unit0 = rank * kUnits;
  const int rows = min(kMaxRows, R - row0);
  const bool reverse = s >= S - num_reverse;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = cl::align1024(smem_raw);
  const uint32_t btiles = cl::smem_u32(smem);
  constexpr uint32_t kPartStride = (kK16 / 4) * cl::kBTileBytes;
  float* sums = reinterpret_cast<float*>(smem + kBBytes);
  float* own = reinterpret_cast<float*>(smem + kBBytes + kSumBytes);   // [2][rows][units]

  // This thread's A fragments: warpgroup wgi takes slice columns 64 wgi ..
  // 64 wgi + 63, rows m0 and m0 + 8 of them in this thread.
  const int wgi = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int m0 = 64 * wgi + 16 * warp + g;
  uint32_t a[kK16][4];
  const bf16* stage = reinterpret_cast<const bf16*>(smem);
  cl::stage_slice(reinterpret_cast<bf16*>(smem), w_hh + (size_t)s * H * 3 * H, H, unit0,
                  [&](int r0, int n) {
#pragma unroll
                    for (int i = 0; i < kK16; ++i) {
                      if (16 * i < r0 || 16 * i >= r0 + n) continue;
                      cl::a_fragment(a[i], m0, 16 * i, q, [&](int m, int k) -> uint16_t {
                        return m < cl::kSliceCols && k < H
                                   ? __bfloat16_as_ushort(stage[(k - r0) * cl::kSliceCols + m])
                                   : 0;
                      });
                    }
                  });
  // Depth past h reads no rows: zero fragments, and zero parts below.
#pragma unroll
  for (int i = 0; i < kK16; ++i)
    if (16 * i >= H) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0;
  for (int i = threadIdx.x; i < (int)(kBBytes / 16); i += kClusterThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);

  // The (row, unit) pairs of this thread, their b_hh, and gi of a step.
  float b[kPairs][3];
  bf16 g_in[kPairs][3];
  const auto pair_row = [](int k) { return (int)(threadIdx.x + k * kClusterThreads) / kUnits; };
  const auto pair_unit = [](int k) { return (int)(threadIdx.x + k * kClusterThreads) % kUnits; };
  const auto live = [&](int k) { return pair_row(k) < rows && unit0 + pair_unit(k) < H; };
  const bf16* bs = b_hh + (size_t)s * 3 * H;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j) b[k][j] = live(k) ? to_f32(bs[j * H + unit0 + pair_unit(k)]) : 0.f;
    if (live(k))
      own[(1 * kMaxRows + pair_row(k)) * kUnits + pair_unit(k)] =
          state[((size_t)(1 * S + s) * R + row0 + pair_row(k)) * H + unit0 + pair_unit(k)];
  }
  auto time_at = [&](int step) { return reverse ? T_ - 1 - step : step; };
  auto load_gi = [&](int step) {
    const size_t ts = (size_t)time_at(step) * S + s;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      if (!live(k)) continue;
      const bf16* gp = gi + (ts * R + row0 + pair_row(k)) * 3 * H + unit0 + pair_unit(k);
#pragma unroll
      for (int j = 0; j < 3; ++j) g_in[k][j] = gp[j * H];
    }
  };
  load_gi(0);
  cl::cluster_arrive();
  cl::cluster_wait();

  const uint32_t own_addr = cl::smem_u32(own);
  constexpr int kVecs = kUnits / 4;                                 // float4s of a peer's row
  constexpr int kBatch = 4, kGather = kMaxRows * cl::kMaxCluster * kVecs / kClusterThreads;
  for (int step = 0; step < T_; ++step) {
    const int prev = (step + 1) & 1, cur = step & 1;
    // The state the step before wrote, from every peer, into the B tiles'
    // parts; the loads of a batch are all issued before any is used.
#pragma unroll
    for (int it0 = 0; it0 < kGather; it0 += kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int it = 0; it < kBatch; ++it) {
        const int i = threadIdx.x + (it0 + it) * kClusterThreads;
        const int r = i / (C * kVecs), p = (i / kVecs) % C, vi = i % kVecs;
        if (r < rows && p * kUnits + 4 * vi < H)
          v[it] = cl::ld_cluster4(cl::map_rank(
              own_addr + (uint32_t)(((prev * kMaxRows + r) * kUnits + 4 * vi) * sizeof(float)),
              p));
      }
#pragma unroll
      for (int it = 0; it < kBatch; ++it) {
        const int i = threadIdx.x + (it0 + it) * kClusterThreads;
        const int r = i / (C * kVecs), p = (i / kVecs) % C, vi = i % kVecs;
        if (r < rows && p * kUnits + 4 * vi < H) {
          const int k = p * kUnits + 4 * vi;
          unsigned char* tile = smem + (k / cl::kDepth) * cl::kBTileBytes;
          uint32_t lo[cl::kParts], hi[cl::kParts];
          cl::split3(v[it].x, v[it].y, lo);
          cl::split3(v[it].z, v[it].w, hi);
#pragma unroll
          for (int pt = 0; pt < cl::kParts; ++pt)
            *reinterpret_cast<uint2*>(tile + pt * kPartStride + cl::b_offset(r, k % cl::kDepth)) =
                make_uint2(lo[pt], hi[pt]);
        }
      }
    }
    cl::fence_async_smem();
    __syncthreads();

    // gh, Round every kRound k16 steps: a group's products start from zero
    // and its sum joins the running sum while the next group's run (two
    // accumulators).
    float sum[16] = {}, d[2][16] = {};
#pragma unroll
    for (int grp = 0; grp < kK16 / kRound; ++grp) {
      cl::fence_operands(d[grp & 1]);
      cl::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kRound; ++j) {
        const int i = grp * kRound + j;
        cl::parts_k16(d[grp & 1], a[i], btiles + (i / 4) * cl::kBTileBytes, kPartStride, i % 4,
                      j > 0);
      }
      cl::wgmma_commit();
      if (grp > 0) {
        cl::wgmma_wait<1>();
        cl::fence_operands(d[(grp - 1) & 1]);
#pragma unroll
        for (int j = 0; j < 16; ++j) sum[j] += d[(grp - 1) & 1][j];
      }
    }
    cl::wgmma_wait<0>();
    cl::fence_operands(d[(kK16 / kRound - 1) & 1]);
#pragma unroll
    for (int j = 0; j < 16; ++j) sum[j] += d[(kK16 / kRound - 1) & 1][j];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          sums[(wgi * 64 + 16 * warp + g + 8 * i) * kSumStride + 8 * j + 2 * q + c] =
              sum[4 * j + 2 * i + c];
    __syncthreads();

    // The gate math of every pair first, then the stores (a store to `own`
    // would otherwise hold the next pair's loads behind it).
    float rg[kPairs], zg[kPairs], hn[kPairs], h[kPairs];
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int r = pair_row(k), c = pair_unit(k);
      const auto gate = [&](int i) {          // slice column 32 i + c
        return sums[(i * kUnits + c) * kSumStride + r];
      };
      rg[k] = sigmoid_f(to_f32(g_in[k][0]) + (gate(0) + b[k][0]));
      zg[k] = sigmoid_f(to_f32(g_in[k][1]) + (gate(1) + b[k][1]));
      hn[k] = gate(2) + b[k][2];
      const float ng = tanhf(to_f32(g_in[k][2]) + rg[k] * hn[k]);
      const float hp = own[(prev * kMaxRows + r) * kUnits + c];
      h[k] = (1.f - zg[k]) * ng + zg[k] * hp;
    }
    const size_t ts = (size_t)time_at(step) * S + s;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      if (!live(k)) continue;
      const int r = pair_row(k), c = pair_unit(k), row = row0 + r, unit = unit0 + c;
      out[(ts * R + row) * H + unit] = from_f32<bf16>(h[k]);
      own[(cur * kMaxRows + r) * kUnits + c] = h[k];
      if (keep) {
        float* kept = gates + (ts * R + row) * 3 * H + unit;
        kept[0] = rg[k];
        kept[H] = zg[k];
        kept[2 * H] = hn[k];
      }
    }
    cl::cluster_arrive();
    if (step + 1 < T_) load_gi(step + 1);
    cl::cluster_wait();
  }
}

// The cluster route's plan for (S, R, H): {blocks a cluster (0: the
// per-step route), units a block, rows a cluster, dynamic shared memory,
// clusters a call}.
void cluster_plan(int S, int R, int H, int* out) {
  const int C = H % 8 == 0 ? cl::cluster_blocks(H) : 0;
  out[0] = C;
  out[1] = kUnits;
  out[2] = R < kMaxRows ? R : kMaxRows;
  out[3] = C ? (int)cluster_smem(H) : 0;
  out[4] = C ? S * ((R + kMaxRows - 1) / kMaxRows) : 0;
}

template <class T>
int run(const T* gi, const T* w_hh, const T* b_hh, const T* h0, T* out, float* state,
        float* gates, int keep, int T_, int S, int R, int H, int num_reverse,
        cudaStream_t stream) {
  if (H % (16 / (int)sizeof(T)) != 0 || (keep && gates == nullptr) ||
      (IsBf16<T>::value && state == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (IsBf16<T>::value) {
    int plan[5];
    cluster_plan(S, R, H, plan);
    if (plan[0]) {
      const size_t smem = cluster_smem(H);
      cudaError_t err = cl::prepare_cluster(gru_cluster_kernel, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cl::launch_cluster(gru_cluster_kernel, kClusterThreads, plan[0],
                               (R + kMaxRows - 1) / kMaxRows, S, smem, stream, gi, w_hh, b_hh,
                               (const float*)state, out, gates, keep, T_, S, R, H, num_reverse);
      if (err != cudaSuccess) return static_cast<int>(err);
      return static_cast<int>(cudaGetLastError());
    }
  }
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

// The bfloat16 route's plan at (S, R, H), into out[6]: blocks a cluster (0:
// the per-step route), units a block, rows a cluster, dynamic shared
// memory bytes, clusters a call, and on the cluster route the most
// clusters the card holds at once (cudaOccupancyMaxActiveClusters; else
// -1). Returns a CUDA error code (0 on success).
extern "C" int tggcn_gru_sequence_plan(int S, int R, int H, int* out) {
  cluster_plan(S, R, H, out);
  out[5] = -1;
  if (!out[0]) return 0;
  return static_cast<int>(tggcn::gru::max_active_clusters(gru_cluster_kernel, kClusterThreads,
                                                          out[0], (size_t)out[3], &out[5]));
}

// The most clusters of C blocks of this kernel, each with smem bytes of
// shared memory, that the card holds at once (for plans not taken).
extern "C" int tggcn_gru_sequence_clusters(int C, int smem, int* out) {
  return static_cast<int>(
      tggcn::gru::max_active_clusters(gru_cluster_kernel, kClusterThreads, C, (size_t)smem, out));
}
