// K2: the backward sweep of the frame-level GRU (K1) for S stacked streams.
//
// Replaces the TPU kernel tggcn/ops/gru_pallas.py::_bwd_kernel (launched by
// _gru_seq_bwd_impl, gru_pallas.py:167). The TPU kernel walks time in
// reverse as its grid, keeps dL/dh in VMEM and recomputes the gates from gi
// and h_prev. Here K1 kept the gates [r | z | hn] of every step, so K2 takes
// no gate product. Two routes, as K1's: bfloat16 at h <= 512 takes
// gru_bwd_cluster, one launch a call, a cluster a (stream, row tile) that
// holds W_hh in its blocks' registers and sums the carry's partial products
// through distributed shared memory (gru_cluster.cuh); float32, and
// bfloat16 at h > 512, take one launch a step (T + 1 a call) whose blocks
// wait on no other block.
//
// The gate backward C at (t, s, row, unit), elementwise from the kept gates
// and the carried gradient dL/dh = carry + g[t] (n = tanh(gi_n + r hn) is
// recomputed, as K1 computed it):
//   dn = dh (1 - z); dz = dh (h_prev - n); dtanh = dn (1 - n^2);
//   d_ir = dtanh hn r (1 - r); d_iz = dz z (1 - z);
//   dgi = [d_ir, d_iz, dtanh]; dgh = [d_ir, d_iz, dtanh r]; dhz = dh z.
// Then carry = dhz + dgh[t] @ W_hh[s]^T, contracting the 3h axis, feeds C
// of the next step, or dh0 = carry after the last. t visits time opposite
// to the forward: T-1 .. 0 for the forward streams, 0 .. T-1 for the
// trailing num_reverse. dW_hh and db_hh are reduced outside, as one product
// over h_prev x dgh.
//
// The per-step route: a launch P takes the carry product and, in its
// epilogue, C of the next step for its own units from the carry it
// computed (the carry never leaves the block); a first, elementwise launch
// runs C of the first step with a zero carry. P runs on the tensor cores
// through tc_gemm.cuh (mma.sync TF32, 3xTF32 split: float32 accuracy),
// reading W_hh as stored: its rows are the units, so the product contracts
// along the weight's columns (kColRows), and no transposed copy is made. A
// block owns 32 units (two m16 tiles) of one stream and up to 32 rows over
// the whole 3h depth (12 chunks of 128 at h = 512): 96 blocks at the MPHOI
// shape, one wave on 132 SMs; 16 units a block (192 blocks) took 27% longer
// (PERF.md). The warps' partial sums are added in a fixed order, so a call
// gives the same bits on every run.
//
// Bound on an H100: one product of 2*R*h*3h per stream and step, 2*T*S*R*h*3h
// = 50 GFLOP at T=167, S=6, R=32, h=512: 0.31 ms as 3xTF32 at a third of 495
// TFLOP/s (the design that recomputed gh took two products, 0.61 ms); HBM
// carries gi's n block, the gates, h_prev and g in and dgi, dgh out (about
// 0.9 GB).
//
// bfloat16 (T = bf16: gi, hprev, g, W_hh in; dgi, dgh, dh0 out), as the TPU
// kernel runs it (gru_pallas.py:97-126): the carry stays float32, and the
// carry product takes the float32 dgh, as the TPU kernel's dgh_s @ W^T
// does, not the bfloat16 dgh it writes out; the kept gates are float32. The
// per-step route keeps that dgh in dgh32 (two slots by step parity: a
// launch reads its step's while its epilogue writes the next step's) and
// takes two TF32 products (float32 dgh against W_hh's bfloat16 values,
// exact in TF32). The cluster route splits dgh into three bfloat16 parts on
// chip and takes them on wgmma; its sum of the block partials, in rank
// order, replaces the per-step route's 12 chunks of 128. Bound:
// 2*T*S*R*h*3h at a third of the BF16 rate (three products), 0.15 ms at
// the MPHOI shape; 0.17 ms by its bytes.

#include "gru_cluster.cuh"
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

// The cluster-resident bfloat16 sweep: the whole backward in one launch
// (gru_cluster.cuh has the plan and the product). Each block holds the
// slice of W_hh that K1's block of the same rank holds (rows all h units,
// its 96 r, z and n columns), here as wgmma's A with the units on M: the
// four warpgroups take two 64-unit tiles each, all 96 columns deep, in
// registers for all T steps (48 a thread). Shared memory (1024-aligned):
// the B tiles, dgh_own's three bfloat16 parts (3 x 2 tiles of 64 columns,
// 24 KB), first the staging of the slice; the block's partial products for
// every unit of the stream (part[p][row][unit]: peer p's units, C x
// kMaxRows x kPStride float32), which its peers read.
namespace cl = tggcn::gru;

constexpr int kPStride = cl::kUnits + 4;        // a partial row's stride: no conflicts
constexpr int kCTiles = (cl::kSliceCols + cl::kDepth - 1) / cl::kDepth;   // B tiles a part
constexpr int kCK16 = cl::kSliceCols / 16;      // k16 steps over the block's columns
constexpr int kUnitTiles = 2;                   // 64-unit M tiles a warpgroup
constexpr int kReduceBatch = 4;                 // peers' partial loads in flight at once

__host__ __device__ constexpr size_t larger(size_t a, size_t b) { return a > b ? a : b; }

__host__ __device__ constexpr size_t bwd_b_region() {
  return larger((size_t)cl::kParts * kCTiles * cl::kBTileBytes, cl::kStageBytes);
}

size_t bwd_cluster_smem(int H) {
  return 1024 + bwd_b_region() +
         (size_t)cl::cluster_blocks(H) * kMaxRows * kPStride * sizeof(float);
}

// What C reads at one step for a thread's two units: the kept gates, gi's
// n block, the upstream gradient and the state the step read.
struct CellIn {
  float2 r, z, hn;
  __nv_bfloat162 gin, g, hp;
};

// Each step, for the block's units and the rows of its tile: C from the
// carry the block holds (zero at the first step) into dgi, dgh and the B
// tiles' parts of dgh_own (float32, split, as the TPU kernel's carry
// product takes dgh); the partial dgh_own @ slice^T of every unit of the
// stream on wgmma (the warpgroups own disjoint units: no sum inside the
// block), written to `part` once every peer has read the last step's
// (barrier A); once all are written (barrier B) the block adds, for its own
// units, the peers' partials in rank order 0 .. C-1 through distributed
// shared memory (kReduceBatch loads issued before any is used): carry =
// dhz + that sum. After the last step dh0 = carry. Two cluster barriers a
// step, A overlapped with C and the product; the next step's C inputs load
// while B waits.
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_cluster(CellArgs<bf16> c, const bf16* __restrict__ w_hh, bf16* __restrict__ dh0,
                int T_, int S, int R, int H, int num_reverse) {
  const int C = gridDim.x, rank = blockIdx.x;
  const int s = blockIdx.z;
  const int row0 = blockIdx.y * kMaxRows;
  const int unit0 = rank * cl::kUnits;
  const int rows = min(kMaxRows, R - row0);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = cl::align1024(smem_raw);
  const uint32_t btiles = cl::smem_u32(smem);
  constexpr uint32_t kPartStride = kCTiles * cl::kBTileBytes;
  float* part = reinterpret_cast<float*>(smem + bwd_b_region());   // [C][kMaxRows][kPStride]

  // This thread's A fragments: warpgroup wgi takes units 128 wgi + 64 mi +
  // 16 warp + g (+ 8), all kCK16 k16 steps of the block's columns.
  const int wgi = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  uint32_t a[kUnitTiles][kCK16][4];
  const bf16* stage = reinterpret_cast<const bf16*>(smem);
  cl::stage_slice(reinterpret_cast<bf16*>(smem), w_hh + (size_t)s * H * 3 * H, H, unit0,
                  [&](int r0, int n) {
#pragma unroll
                    for (int mi = 0; mi < kUnitTiles; ++mi) {
                      const int u0 = 64 * (kUnitTiles * wgi + mi);
                      if (u0 < r0 || u0 >= r0 + n) continue;
#pragma unroll
                      for (int i = 0; i < kCK16; ++i)
                        cl::a_fragment(a[mi][i], u0 + 16 * warp + g, 16 * i, q,
                                       [&](int u, int k) -> uint16_t {
                                         return u < H ? __bfloat16_as_ushort(
                                                            stage[(u - r0) * cl::kSliceCols + k])
                                                      : 0;
                                       });
                    }
                  });
#pragma unroll
  for (int mi = 0; mi < kUnitTiles; ++mi)
    if (64 * (kUnitTiles * wgi + mi) >= H)
#pragma unroll
      for (int i = 0; i < kCK16; ++i) a[mi][i][0] = a[mi][i][1] = a[mi][i][2] = a[mi][i][3] = 0;
  // dgh_own's parts of rows past the tile and of units past h stay zero.
  for (int i = threadIdx.x; i < (int)(bwd_b_region() / 16); i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);

  // This thread's units cc, cc + 1 of row r.
  const int r = threadIdx.x / (cl::kUnits / 2), cc = 2 * (threadIdx.x % (cl::kUnits / 2));
  const int row = row0 + r, unit = unit0 + cc;
  const bool live = r < rows && unit < H;
  float carry[2] = {0.f, 0.f}, dhz[2];
  CellIn in;
  auto load_in = [&](int step) {
    if (!live) return;
    const size_t at = ((size_t)time_of(s, S, num_reverse, step, T_) * S + s) * R + row;
    const size_t g3 = at * 3 * H + unit, h1 = at * H + unit;
    in.r = *reinterpret_cast<const float2*>(c.gates + g3);
    in.z = *reinterpret_cast<const float2*>(c.gates + g3 + H);
    in.hn = *reinterpret_cast<const float2*>(c.gates + g3 + 2 * H);
    in.gin = *reinterpret_cast<const __nv_bfloat162*>(c.gi + g3 + 2 * H);
    in.g = *reinterpret_cast<const __nv_bfloat162*>(c.g + h1);
    in.hp = *reinterpret_cast<const __nv_bfloat162*>(c.hprev + h1);
  };
  load_in(0);
  cl::cluster_arrive();                              // A: no partial is read yet

  const uint32_t part_addr = cl::smem_u32(part);
  for (int step = 0; step < T_; ++step) {
    // C, as cell_bwd computes it, for units cc and cc + 1.
    if (live) {
      const size_t at = ((size_t)time_of(s, S, num_reverse, step, T_) * S + s) * R + row;
      const size_t g3 = at * 3 * H + unit;
      const float rv[2] = {in.r.x, in.r.y}, zv[2] = {in.z.x, in.z.y};
      const float hv[2] = {in.hn.x, in.hn.y};
      const float gn[2] = {__low2float(in.gin), __high2float(in.gin)};
      const float gv[2] = {__low2float(in.g), __high2float(in.g)};
      const float pv[2] = {__low2float(in.hp), __high2float(in.hp)};
      float dgh[3][2], dth[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float rg = rv[j], zg = zv[j], hn = hv[j];
        const float ng = tanhf(gn[j] + rg * hn);
        const float dh = carry[j] + gv[j];
        const float dz = dh * (pv[j] - ng);
        const float dtanh = dh * (1.f - zg) * (1.f - ng * ng);
        dgh[0][j] = dtanh * hn * rg * (1.f - rg);
        dgh[1][j] = dz * zg * (1.f - zg);
        dgh[2][j] = dtanh * rg;
        dth[j] = dtanh;
        dhz[j] = dh * zg;
      }
      auto put = [&](bf16* base, size_t i, float x, float y) {
        *reinterpret_cast<__nv_bfloat162*>(base + i) = __floats2bfloat162_rn(x, y);
      };
      put(c.dgi, g3, dgh[0][0], dgh[0][1]);
      put(c.dgi, g3 + H, dgh[1][0], dgh[1][1]);
      put(c.dgi, g3 + 2 * H, dth[0], dth[1]);
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        put(c.dgh, g3 + gate * H, dgh[gate][0], dgh[gate][1]);
        const int col = gate * cl::kUnits + cc;
        uint32_t parts[cl::kParts];
        cl::split3(dgh[gate][0], dgh[gate][1], parts);
        unsigned char* tile = smem + (col / cl::kDepth) * cl::kBTileBytes;
#pragma unroll
        for (int pt = 0; pt < cl::kParts; ++pt)
          *reinterpret_cast<uint32_t*>(tile + pt * kPartStride +
                                       cl::b_offset(r, col % cl::kDepth)) = parts[pt];
      }
    }
    cl::fence_async_smem();
    __syncthreads();

    // The partial of this warpgroup's unit tiles.
    float acc[kUnitTiles][16] = {};
#pragma unroll
    for (int mi = 0; mi < kUnitTiles; ++mi) cl::fence_operands(acc[mi]);
    cl::wgmma_fence();
#pragma unroll
    for (int mi = 0; mi < kUnitTiles; ++mi) {
#pragma unroll
      for (int i = 0; i < kCK16; ++i)
        cl::parts_k16(acc[mi], a[mi][i], btiles + (16 * i / cl::kDepth) * cl::kBTileBytes,
                      kPartStride, (16 * i % cl::kDepth) / 16, i > 0);
    }
    cl::wgmma_commit();
    cl::wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < kUnitTiles; ++mi) cl::fence_operands(acc[mi]);

    cl::cluster_wait();                              // A: every peer has read the last part
#pragma unroll
    for (int mi = 0; mi < kUnitTiles; ++mi) {
      const int u = 64 * (kUnitTiles * wgi + mi) + 16 * warp + g;
      if (u - g >= H) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* at = part + (size_t)((u + 8 * i) / cl::kUnits) * kMaxRows * kPStride +
                    (u + 8 * i) % cl::kUnits;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            at[(8 * j + 2 * q + e) * kPStride] = acc[mi][4 * j + 2 * i + e];
      }
    }
    cl::cluster_arrive();                            // B
    if (step + 1 < T_) load_in(step + 1);
    cl::cluster_wait();
    if (live) {
      const uint32_t at = part_addr +
                          (uint32_t)(((rank * kMaxRows + r) * kPStride + cc) * sizeof(float));
      float v[2] = {0.f, 0.f};
#pragma unroll
      for (int p0 = 0; p0 < cl::kMaxCluster; p0 += kReduceBatch) {
        float2 x[kReduceBatch];
#pragma unroll
        for (int p = 0; p < kReduceBatch; ++p)
          if (p0 + p < C) x[p] = cl::ld_cluster2(cl::map_rank(at, p0 + p));
#pragma unroll
        for (int p = 0; p < kReduceBatch; ++p) {
          if (p0 + p < C) {
            v[0] += x[p].x;
            v[1] += x[p].y;
          }
        }
      }
      carry[0] = dhz[0] + v[0];
      carry[1] = dhz[1] + v[1];
    }
    cl::cluster_arrive();                            // A: this block has read the peers' parts
  }
  if (live)
    *reinterpret_cast<__nv_bfloat162*>(dh0 + ((size_t)s * R + row) * H + unit) =
        __floats2bfloat162_rn(carry[0], carry[1]);
  cl::cluster_wait();                                // no peer reads this block's part any more
}

// The bfloat16 route's plan for (S, R, H): {blocks a cluster (0: the
// per-step route), units a block, rows a cluster, dynamic shared memory,
// clusters a call}.
void bwd_cluster_plan(int S, int R, int H, int* out) {
  const int C = H % 8 == 0 ? cl::cluster_blocks(H) : 0;
  out[0] = C;
  out[1] = cl::kUnits;
  out[2] = R < kMaxRows ? R : kMaxRows;
  out[3] = C ? (int)bwd_cluster_smem(H) : 0;
  out[4] = C ? S * ((R + kMaxRows - 1) / kMaxRows) : 0;
}

template <class T>
int run(const CellArgs<T>& c, const T* w_hh, T* dh0, int T_, int S, int R, int H,
        int num_reverse, cudaStream_t stream) {
  if (H % (16 / (int)sizeof(T)) != 0 || T_ < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (IsBf16<T>::value) {
    int plan[5];
    bwd_cluster_plan(S, R, H, plan);
    if (plan[0]) {
      const size_t smem = bwd_cluster_smem(H);
      cudaError_t err = cl::prepare_cluster(gru_bwd_cluster, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cl::launch_cluster(gru_bwd_cluster, kThreads, plan[0],
                               (R + kMaxRows - 1) / kMaxRows, S, smem, stream, c, w_hh, dh0, T_,
                               S, R, H, num_reverse);
      if (err != cudaSuccess) return static_cast<int>(err);
      return static_cast<int>(cudaGetLastError());
    }
    if (c.dgh32 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
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
// float32 scratch, which, as dhz, only the per-step route (h > 512) uses.
// H % 8 == 0.
extern "C" int tggcn_gru_sequence_bwd_bf16(const bf16* gi, const bf16* hprev, const bf16* g,
                                           const float* gates, const bf16* w_hh, bf16* dgi,
                                           bf16* dgh, float* dhz, bf16* dh0, float* dgh32,
                                           int T, int S, int R, int H, int num_reverse,
                                           void* stream_ptr) {
  const CellArgs<bf16> c = {gi, hprev, g, gates, dgi, dgh, dhz, dgh32};
  return run<bf16>(c, w_hh, dh0, T, S, R, H, num_reverse,
                   static_cast<cudaStream_t>(stream_ptr));
}

// The bfloat16 route's plan at (S, R, H), into out[6], as
// tggcn_gru_sequence_plan gives K1's: blocks a cluster (0: the per-step
// route), units a block, rows a cluster, dynamic shared memory bytes,
// clusters a call, and on the cluster route the most clusters the card
// holds at once (else -1). Returns a CUDA error code (0 on success).
extern "C" int tggcn_gru_sequence_bwd_plan(int S, int R, int H, int* out) {
  bwd_cluster_plan(S, R, H, out);
  out[5] = -1;
  if (!out[0]) return 0;
  return static_cast<int>(
      tggcn::gru::max_active_clusters(gru_bwd_cluster, kThreads, out[0], (size_t)out[3], &out[5]));
}
