// A block-level bfloat16 product for Hopper: wgmma (the warpgroup's
// asynchronous tensor-core product, m64n32k16, bfloat16 operands, float32
// sums) on operands that the tensor memory accelerator (TMA) copies into
// shared memory. It runs the bfloat16 product phases of K3 (segment_scan.cu:
// the message projections A and the cells B); tc_gemm.cuh keeps the
// float32 products, the per-step K1's and K2's bfloat16 x float32 ones
// (h > 512; gru_cluster.cuh takes them below) and K4's bfloat16 ones, whose
// bits its two-launch route keeps (segment_scan_bwd.cu; on wgmma K4's carry
// was slower and its dmsgs moved a checked output past its limit on the
// H100, PERF.md).
//
// What bounds them. At MPHOI's batch of 8 each of those phases is one
// wave of 128 blocks a step (2048 at a predict batch of 128), each block streaming its weight columns and the step's rows from L2 over
// a depth of h to 3h. Split on the H100 (PERF.md), a
// launch of tc_gemm.cuh's design spent its time in its copies (cp.async,
// 16 bytes a thread, each with its own address arithmetic) and then in
// its epilogue, whose loads from device memory waited until the product was
// done; the products (mma.sync, every fragment loaded from shared memory by
// scalar loads) hid under the copies. Here one thread of a producer warp
// issues every copy of the block as TMA tile copies, from the start of the
// launch, into a ring of kStages stages, each completed on an mbarrier
// with its transaction bytes; the consumer warpgroups wait on a stage's
// barrier and run wgmma straight from shared memory (no fragment loads),
// then hand the stage back on its second barrier; the kernels issue their
// epilogue's loads before the product (load_now), so that those land while
// the copies run. Nothing waits on another block. The ring has a stage for
// each stage of the product, up to kStages = 8 (ring_stages): 99 KB, so
// two blocks share an SM. On the H100 (PERF.md) a ring of 16 (197 KB, one
// block an SM) was no faster in one wave and a third slower in many.
//
// Shape ("swap AB", as tc_gemm.cuh). The weight columns are wgmma's M side,
// 64 a tile (a block uses 32 or 48 of them; the others read whatever
// the stage holds and their sums are never read), the step's rows its N
// side, 32 (TMA boxes of 16 rows, or one of 32 where the block's group has
// more than 16; rows the block lacks read as zeros past the tensor's end or
// as other rows, whose sums are never read).
// A stage is 64 deep, one 128-byte row of bfloat16: room for 8 KB of
// weights and 4 KB of rows (a block copies 4 or 6 KB and 2 or 4). Depth past
// an operand's end reads as zeros on both sides (each tensor map ends where
// its operand ends), so a ragged depth adds nothing.
//
// Operand layouts. The rows are K-major (each row's depth contiguous) in
// the 128-byte swizzle, a TMA box 64 deep. The weights are read MN-major,
// as K3 stores them (w[k][col]): wgmma's transposed A, built from
// 16-column pieces, each a TMA box of 16 columns x 64 deep in the 32-byte
// swizzle at 2 KB steps, so a block can take a GRU cell's r, z and n
// columns, which lie h apart, into one M tile; no transposed copy of the
// weights is made.
//
// Split-K and sums. kConsumers warpgroups take the stages in turn (stage i
// to warpgroup i % kConsumers), each into its own accumulators; after the
// loop their sums go to shared memory and reduce() adds them in warpgroup
// order, so a result has the same bits on every run.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_gemm.cuh"

namespace tggcn {
namespace wg {

using tc::bf16;

constexpr int kConsumers = 2;                          // consumer warpgroups
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 32;        // and one producer warp
constexpr int kDepth = 64;                             // depth of a stage
constexpr int kM = 64, kN = 32;                        // the wgmma tile
constexpr int kRowBox = 16;                            // rows of a TMA box of rows
constexpr int kPiece = 16;                             // columns of an MN-major weight piece
constexpr int kPieceBytes = kPiece * kDepth * 2;       // 2 KB
constexpr int kRowBytes = kDepth * 2;                  // a row (or column) of a stage: 128 bytes
constexpr int kABytes = kM * kRowBytes;                // 8 KB
constexpr int kBBytes = kN * kRowBytes;                // 4 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kStages = 8;                             // the most stages a ring has
constexpr int kPartStride = kN + 1;
// The consumers' sums (store_partials), written over the ring once the
// product is done: up to two accumulators each.
constexpr int kPartBytes = kConsumers * 2 * kM * kPartStride * 4;

// The stages of the ring of a product of `chunks` stages of 64: one for
// each, up to kStages (then the producer waits for a stage to be read).
__host__ __device__ constexpr int ring_stages(int chunks) {
  return chunks < kStages ? chunks : kStages;
}

// The bytes of a ring of `stages` stages: at least the consumers' sums.
__host__ __device__ constexpr int ring_bytes(int stages) {
  return stages * kStageBytes > kPartBytes ? stages * kStageBytes : kPartBytes;
}

// Dynamic shared memory of a block whose ring has `stages` stages: the
// ring, its 2 stages barriers (past the ring, so that the sums never
// overwrite them), and room to align the ring to 1024 bytes (the 128-byte
// swizzle's period).
__host__ __device__ constexpr size_t smem_bytes(int stages) {
  return (size_t)ring_bytes(stages) + 16 * stages + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uintptr_t at = (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023);
  return reinterpret_cast<unsigned char*>(at);
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// The consumer warpgroups alone (the producer warp has left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// ---- TMA ---------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------------

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle (1: 128 bytes, 3: 32 bytes).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

// K-major, 128-byte swizzle (the rows): rows of 128 bytes, 8-row groups
// 1024 bytes apart; a k16 step moves the start 32 bytes.
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int k16) {
  return descriptor(tile + 32 * k16, 16, 1024, 1);
}

// MN-major, 32-byte swizzle (the weights): 16-column pieces kPieceBytes
// apart (the leading offset), each 64 k-rows of 32 bytes in 8-row groups
// 256 bytes apart (the stride offset); a k16 step moves the start 16
// k-rows.
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int k16) {
  return descriptor(tile + 512 * k16, kPieceBytes, 256, 3);
}

__device__ __forceinline__ void fence_operands(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 32, float32) += A (64 x 16) B (32 x 16)^T, A read MN-major
// (transposed), B K-major.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// One stage's product, 4 k16 steps, into d; returns once the stage has
// been read.
__device__ __forceinline__ void multiply_stage(float (&d)[16], uint32_t a, uint32_t b) {
  fence_operands(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < kDepth / 16; ++k)
    wgmma_m64n32k16(d, mn_major(a, k), k_major(b, k));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(d);
}

// ---- the block's product --------------------------------------------------------

// Stage s of a ring of `stages`: its weights (A) and rows (B), and its two
// barriers, full (the stage's bytes have landed) and empty (its consumer
// has read it); shared-memory addresses.
struct Ring {
  uint32_t base;                                        // stage 0, 1024-aligned
  uint32_t bars;                                        // stage 0's full barrier
  int stages;
  __device__ uint32_t a(int s) const { return base + s * kStageBytes; }
  __device__ uint32_t b(int s) const { return a(s) + kABytes; }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (stages + s); }
};

// Sets up the ring of a block's product of `chunks` stages (its
// ring_stages(chunks) stages' barriers, in smem_bytes of that), then
// __syncthreads. Call it before any early loads of an epilogue (load_now):
// a barrier waits for the thread's loads in flight.
__device__ __forceinline__ Ring begin(unsigned char* smem, int chunks) {
  const int stages = ring_stages(chunks);
  const Ring ring{smem_u32(smem), smem_u32(smem) + ring_bytes(stages), stages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring.stages; ++s) {
      bar_init(ring.full(s), 1);
      bar_init(ring.empty(s), 1);
    }
    bar_init_fence();
  }
  __syncthreads();
  return ring;
}

// The block's product over plan.chunks() stages of 64 on the ring of
// begin(): the producer warp's first thread issues plan.issue(i, weights,
// rows, barrier) for every stage i (which posts the stage's bytes on the
// barrier and starts its TMA copies), as soon as the ring has room;
// consumer warpgroup g multiplies stages g, g + kConsumers, ... into
// acc[plan.acc(i)] (NACC accumulators of 64 x 32). Returns true in the
// consumer threads, their sums in acc, and false in the producer warp,
// which then has nothing left to do (it must not wait on the block: use
// consumers_sync). Both sides step through the ring's slots and rounds
// without a division (the ring's size is known only at run time).
template <int NACC, class Plan>
__device__ __forceinline__ bool product(const Plan& plan, const Ring& ring,
                                        float (&acc)[NACC][16]) {
  const int tid = threadIdx.x, total = plan.chunks(), stages = ring.stages;
  if (tid >= kConsumerThreads) {
    if (tid == kConsumerThreads) {
      plan.prefetch();
      for (int i = 0, s = 0, round = 0; i < total; ++i) {
        if (round > 0) bar_wait(ring.empty(s), (round - 1) & 1);
        plan.issue(i, ring.a(s), ring.b(s), ring.full(s));
        if (++s == stages) {
          s = 0;
          ++round;
        }
      }
    }
    return false;
  }
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[a][i] = 0.f;
  const int g = tid / 128;
  for (int i = g, s = g % stages, round = g / stages; i < total; i += kConsumers) {
    bar_wait(ring.full(s), round & 1);
    if (NACC == 1 || plan.acc(i) == 0)
      multiply_stage(acc[0], ring.a(s), ring.b(s));
    else
      multiply_stage(acc[NACC - 1], ring.a(s), ring.b(s));
    if (tid % 128 == 0) bar_arrive(ring.empty(s));
    for (s += kConsumers; s >= stages; s -= stages) ++round;
  }
  return true;
}

// The consumers' sums into shared memory (over the ring, which product()
// has finished with once every consumer is past it; kPartBytes).
template <int NACC>
__device__ __forceinline__ void store_partials(unsigned char* smem, const float (&acc)[NACC][16]) {
  consumers_sync();
  float* part = reinterpret_cast<float*>(smem);
  const int g = threadIdx.x / 128, t = threadIdx.x % 128, w = t / 32, l = t % 32;
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int m = 16 * w + l / 4 + 8 * i, n = 8 * j + 2 * (l % 4) + c;
          part[((g * NACC + a) * kM + m) * kPartStride + n] = acc[a][4 * j + 2 * i + c];
        }
  consumers_sync();
}

// Accumulator a at weight column m (0..63) and row n: the consumers' sums
// added in warpgroup order.
template <int NACC>
__device__ __forceinline__ float reduce(const unsigned char* smem, int a, int m, int n) {
  const float* part = reinterpret_cast<const float*>(smem);
  float v = 0.f;
#pragma unroll
  for (int g = 0; g < kConsumers; ++g) v += part[((g * NACC + a) * kM + m) * kPartStride + n];
  return v;
}

// The rows of a TMA box of a group of `rows` rows (every block of the
// group copies boxes of this height): 16, or 32 (the whole N side) once
// the group has more than 16.
__host__ __device__ constexpr int row_box(int rows) { return rows > kRowBox ? kN : kRowBox; }

// A block's rows: rows row0 .. row0 + rows - 1 of a rows map, copied in
// boxes of `box` rows (row_box of the group; rows <= kN).
struct Rows {
  int row0, rows, box;
  __device__ uint32_t bytes() const { return (rows + box - 1) / box * box * kRowBytes; }
  // One stage of them, depth k0 .. k0 + 63 of `plane`, into dst.
  __device__ void load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int k0,
                       int plane) const {
    for (int r = 0; r < rows; r += box)
      tma_load(dst + r * kRowBytes, map, bar, k0, row0 + r, plane);
  }
};

// Loads issued where they stand (volatile asm: the compiler neither sinks
// them toward their use nor merges them), so that an epilogue's inputs are
// in flight while the block's copies run; a bfloat16 value stays raw bits
// until widen() at its use.
__device__ __forceinline__ float load_now(const float* p) {
  float v;
  asm volatile("ld.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint16_t load_now(const bf16* p) {
  uint16_t v;
  asm volatile("ld.b16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float widen(uint16_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

// ---- tensor maps (host) ---------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), found through the runtime (no -lcuda).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bfloat16 tensor map of `rank` dimensions, innermost first:
// dims, the byte strides of dimensions 1.. (multiples of 16), the box and
// the swizzle; elements outside the dimensions read as zeros. Returns
// cudaErrorInvalidValue if the encoding fails.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                            const uint64_t* strides, const uint32_t* box,
                            CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorInvalidValue;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Rows: a tensor (planes, rows, width) read from column `offset` of each
// row (width >= offset + depth), depth `depth`; a box of row_box(rows) rows
// x 64 deep in the 128-byte swizzle. Rows past `rows` and depth past
// `depth` read as zeros.
inline cudaError_t rows_map(CUtensorMap* map, const bf16* base, int planes, int rows, int width,
                            int depth, int offset = 0) {
  const uint64_t dims[3] = {(uint64_t)depth, (uint64_t)rows, (uint64_t)planes};
  const uint64_t strides[2] = {(uint64_t)width * 2, (uint64_t)rows * width * 2};
  const uint32_t box[3] = {kDepth, (uint32_t)row_box(rows), 1};
  return make_map(map, base + offset, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// MN-major weights: (planes, depth, cols) as stored, a box of 16 columns x
// 64 deep in the 32-byte swizzle (one piece).
inline cudaError_t mn_major_map(CUtensorMap* map, const bf16* base, int planes, int depth,
                                int cols) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)depth, (uint64_t)planes};
  const uint64_t strides[2] = {(uint64_t)cols * 2, (uint64_t)depth * cols * 2};
  const uint32_t box[3] = {kPiece, kDepth, 1};
  return make_map(map, base, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B);
}

}  // namespace wg
}  // namespace tggcn
