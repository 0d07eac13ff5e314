// What the cluster-resident bfloat16 kernels of the frame-level GRU (K1 in
// gru_sequence.cu, K2 in gru_sequence_bwd.cu) share: the cluster plan, the
// cluster barrier and distributed shared memory, the launch with an
// explicit cluster dimension, the copy of a block's W_hh slice, and the
// product on wgmma with that slice in registers for the whole sequence.
//
// The plan. One launch a call. The blocks of one (stream, row tile) form a
// thread-block cluster of C = ceil(h / 32) blocks, each owning 32 hidden
// units: the r, z and n columns of W_hh[s] for its units (h x 96 bfloat16,
// 96 KB at h = 512), loaded once (cp.async through a staging area) and held
// as wgmma's A fragments in its warpgroups' registers for all T steps, so
// no step reads W_hh again. Each step the blocks exchange what the others
// need through distributed shared memory (K1: the float32 state slices;
// K2: the carry's partial products) and wait at the cluster barrier. A
// cluster's blocks are scheduled together on one GPC, or not at all, so a
// block may wait for the blocks of its own cluster; it never waits for a
// block outside it, and there are no atomics: every sum runs in a fixed
// order, and a call gives the same bits on every run. C <= 16 (the H100's
// largest cluster, non-portable above 8): h <= 512; larger h keeps the
// per-step kernels, a route chosen from the shape before any launch; a
// refused launch raises. Rows a cluster: up to 32 (kMaxRows), the N side
// of the products (wgmma n32); a row count above 32 takes several clusters
// a stream, which run in waves when more are launched than the card holds
// at once (seven 16-block clusters on the H100, PERF.md).
#pragma once

#include "tc_gemm.cuh"
#include "wg_gemm.cuh"

namespace tggcn {
namespace gru {

using namespace tggcn::tc;
using wg::align1024;
using wg::fence_operands;

constexpr int kUnits = 2 * kMTile;        // hidden units a block owns
constexpr int kSliceCols = 3 * kUnits;    // its r, z and n columns of W_hh
constexpr int kMaxCluster = 16;
constexpr int kLoadRows = 128;            // W_hh rows a staging pass copies
constexpr size_t kStageBytes = (size_t)kLoadRows * kSliceCols * sizeof(bf16);

// Blocks in the cluster of one stream at h hidden units; 0 when its slice
// needs more than kMaxCluster blocks (the per-step route).
inline int cluster_blocks(int H) {
  const int c = (H + kUnits - 1) / kUnits;
  return c <= kMaxCluster ? c : 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory offset in the block of cluster
// rank `rank` (distributed shared memory).
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float2 ld_cluster2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// The cluster barrier, split: arrive releases this block's shared-memory
// writes to the cluster, wait returns once every thread of the cluster has
// arrived and acquires theirs. Every thread of a block takes part, so a
// wait also orders the block's own threads, as __syncthreads does.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Launches kernel on a grid (C, row tiles, S) of `threads`-thread blocks
// whose clusters are the C blocks of one (row tile, stream).
template <class Kernel, class... Args>
cudaError_t launch_cluster(Kernel kernel, int threads, int C, int tiles, int S, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, tiles, S);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Sets the kernel's shared-memory and cluster-size attributes.
template <class Kernel>
cudaError_t prepare_cluster(Kernel kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// The most clusters of C blocks of `threads` threads with smem bytes each
// that the card holds at once (cudaOccupancyMaxActiveClusters), into *out.
template <class Kernel>
cudaError_t max_active_clusters(Kernel kernel, int threads, int C, size_t smem, int* out) {
  cudaError_t err = prepare_cluster(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &cfg);
}

// Stages the block's slice of w = W_hh[s] (H x 3H, bfloat16): rows 0 ..
// H-1, the r, z and n columns of units unit0 .. unit0 + kUnits - 1 (slice
// column gate * kUnits + c), columns of units >= H as zero, kLoadRows rows
// at a time with cp.async into `stage` (kStageBytes, row r at r *
// kSliceCols), calling take(r0, n) once rows r0 .. r0 + n - 1 are in. Ends
// with the block synchronized.
template <class Take>
__device__ __forceinline__ void stage_slice(bf16* stage, const bf16* w, int H, int unit0,
                                            Take take) {
  constexpr int kCopies = kSliceCols / 8;   // 16-byte copies a row
  const int valid = min(kUnits, H - unit0);
  for (int r0 = 0; r0 < H; r0 += kLoadRows) {
    const int n = min(kLoadRows, H - r0);
    for (int i = threadIdx.x; i < n * kCopies; i += blockDim.x) {
      const int r = i / kCopies, j = i % kCopies;
      const int gate = j / (kUnits / 8), c = (j % (kUnits / 8)) * 8;
      const bool ok = c < valid;
      cp_async16(stage + r * kSliceCols + gate * kUnits + c,
                 ok ? w + (size_t)(r0 + r) * 3 * H + gate * H + unit0 + c : w, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    take(r0, n);
    __syncthreads();
  }
}

// ---- the products: wgmma with A in registers ----------------------------------
//
// A product of a float32 operand x (the state in K1, dgh in K2) and W_hh's
// bfloat16 values at float32 accuracy: x = x1 + x2 + x3, three bfloat16
// parts (x1 = x rounded, x2 the remainder rounded, x3 the rest; together
// x's 24 bits), each multiplied by the exact W on wgmma's bfloat16 rate
// with float32 sums, the small parts first. W is wgmma's A, held in the
// registers of its warpgroup for the whole sequence (the same fragment
// layout as mma.sync m16n8k16's A, for the warp's 16 rows of the 64); the
// parts are B, rows x 64 deep K-major in the 128-byte swizzle (the layout
// TMA gives wg_gemm.cuh's rows), written by the block's own threads.
constexpr int kParts = 3;
constexpr int kDepth = 64;                        // depth of a B tile: one 128-byte row
constexpr int kBTileBytes = kMaxRows * kDepth * 2;  // 4 KB

// The three bfloat16 parts of a and b (two neighbouring values), each
// part's pair packed as one 32-bit word (a in the low half).
__device__ __forceinline__ void split3(float a, float b, uint32_t (&p)[kParts]) {
#pragma unroll
  for (int i = 0; i < kParts; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    p[i] = *reinterpret_cast<const uint32_t*>(&v);
    a -= __low2float(v);
    b -= __high2float(v);
  }
}

// The byte offset, in a B tile, of row n and depth k (even; the 4 bytes of
// k and k + 1): 128-byte rows whose 16-byte chunks sit at chunk ^ (n % 8).
__device__ __forceinline__ uint32_t b_offset(int n, int k) {
  return n * 128 + (((k / 8) ^ (n % 8)) * 16) + (k % 8) * 2;
}

// Makes this thread's shared-memory writes visible to wgmma, which reads
// its operands through the async proxy (the block then synchronizes).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 32, float32) = A (64 x 16, registers) B (32 x 16, descriptor b,
// K-major)^T, plus d unless `add` is 0.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

// One k16 step of the three parts into d: B tile `tile` of part p at
// tile + p * part_stride bytes, its k16 step k16 (0..3).
__device__ __forceinline__ void parts_k16(float (&d)[16], const uint32_t (&a)[4], uint32_t tile,
                                          uint32_t part_stride, int k16, bool add) {
#pragma unroll
  for (int p = kParts - 1; p >= 0; --p)
    wgmma_rs(d, a, wg::k_major(tile + p * part_stride, k16), add || p != kParts - 1);
}

// The A fragment of k16 step (k0 .. k0 + 15) for rows m0 (= 16 warp + g
// of the warpgroup's 64) and m0 + 8: value(m, k) gives A's bfloat16 bits.
template <class Value>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], int m0, int k0, int q, Value value) {
  const auto pack = [&](int m, int k) {
    return (uint32_t)value(m, k) | ((uint32_t)value(m, k + 1) << 16);
  };
  a[0] = pack(m0, k0 + 2 * q);
  a[1] = pack(m0 + 8, k0 + 2 * q);
  a[2] = pack(m0, k0 + 2 * q + 8);
  a[3] = pack(m0 + 8, k0 + 2 * q + 8);
}

}  // namespace gru
}  // namespace tggcn
