// A block-level product on the tensor cores, for the recurrent kernels
// (gru_sequence.cu, gru_sequence_bwd.cu, segment_scan.cu,
// segment_scan_bwd.cu), float32 accumulation, in three element-type pairs
// (weight, activation), each operand's type a template parameter:
//   float, float   mma.sync m16n8k8 in TF32 with the 3xTF32 split (float32
//                  accuracy); the float32 kernels.
//   bf16, float    a float32 activation against a weight that holds
//                  bfloat16 values (K1 and K2 in bfloat16 at h > 512,
//                  their per-step route: the float32
//                  state or dgh against W_hh, as the TPU kernels take
//                  h(f32) @ W.astype(f32)). A bfloat16 value is exact in
//                  TF32, so W is not split: two TF32 products, lo_x W +
//                  hi_x W, keep float32 accuracy, and W sits in shared
//                  memory as bfloat16 (half its bytes).
//   bf16, bf16     mma.sync m16n8k16 in bfloat16 (K4 and K5's v1 and v4
//                  projection phases in bfloat16: bfloat16 x bfloat16 with
//                  float32 sums, as the TPU kernels'
//                  preferred_element_type=float32 products). K3's bfloat16
//                  products run on wgmma fed by TMA (wg_gemm.cuh).
//
// Numbers. Each float32 operand x is split into a TF32 high part hi (x
// with the low 13 bits of its mantissa cleared) and the remainder lo = x -
// hi, which the tensor core reads as TF32 (its low 13 bits dropped); a
// product is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b (the small terms
// first), summed in float32. The dropped lo_a lo_b term and lo's own
// truncation are about 2^-20 of each product, so the result keeps
// float32-level error (tests/test_torch_segment_scan.py emulates this
// scheme on the CPU at the kernels' depths). Plain single-pass TF32 (about
// 2^-10 of each product) is not used anywhere. The tensor core does not
// round its float32 sums to nearest: carried through it at every step of
// a product, a running sum drifts. With Round, the three products of each
// k8 step start from a zero accumulator and their sum joins the running
// sum by a float32 add; K1 takes it (its states feed every hard decision
// of the model: without it a full-width train step's segment-level
// gradients moved by 1.5e-3 of their largest against the plain route,
// with it by 1.6e-4, as with cuBLAS; PERF.md). It costs K1 about 13%
// of its time; K2-K5 do without.
//
// Shape ("swap AB"). The weight columns take the M side of the mma (16 per
// tile) and the activation rows the N side (8 per tile), so a step's 16
// human rows fill two n8 tiles and its 32 object rows four, and no tile
// pads 16 rows to 32. A block of kThreads threads owns MT m16 tiles of
// weight columns (each tile's 16 columns start anywhere: the r, z and n
// gates of a GRU are three tiles H apart) and up to kMaxRows rows, over the
// whole depth. The depth runs in chunks (128 deep, 256 for bf16 x bf16),
// copied global -> shared with cp.async (16 bytes: 4 float32 or 8
// bfloat16 values) through a ring of NS buffers (kStages unless the kernel
// asks for fewer); each of the 16 warps takes one mma step (k8, or k16 for
// bf16 x bf16) of every chunk for all MT tiles (split-K inside the block),
// or, with MG warp groups, MG steps for its group's MT / MG tiles, and the
// warps' partial sums are added in a fixed order at the end (reduce), so a
// result has the same bits on every run. A bf16 x bf16 stage holds as many
// bytes as a float32 one, twice the depth.
//
// What bounds it on an H100 is not bytes and not the tensor cores' rate:
// at the scan's shapes a block's time grows with its number of chunks and
// hardly with its rows, whether its weights sit in L2 or not; a deeper ring
// changed nothing, and with the copies or the products switched off in turn
// each took about half the time, so the two do not overlap. What they share
// (issue slots, the load/store pipe) is not measured yet (PERF.md). 16 warps
// (four to a scheduler) and 128-deep chunks were faster than 8 warps and
// 64-deep chunks; TMA copies of whole rows were slower than these cp.async
// copies and were not kept.
//
// Layout. mma.sync takes its fragments from registers, loaded from shared
// memory one scalar at a time, so either weight layout works and needs no
// transposed copy: kColRows = false reads w[k][col] (a weight the product
// contracts along its rows, K3's x @ W), kColRows = true reads w[col][k]
// (contracting along its columns, K4's and K2's dy @ W^T). The shared-memory strides
// (Stage) make every fragment load conflict-free and keep each row 16-byte
// aligned for cp.async; a bfloat16 fragment of k16 takes two neighbouring
// values of k as one 32-bit load, or, for a weight stored [k][col], two
// 16-bit loads packed. (wgmma takes TF32 only K-major from shared memory,
// so K3's float32 weights would need a transposed copy; its 16-bit operands
// may be MN-major, which wg_gemm.cuh uses for K3's bfloat16 weights.)
//
// Operands. Up to three operands (x_p, w_p) add into one set of
// accumulators; Map::slot(p, t) names the accumulator slot of operand p's
// tile t (or -1: the tile is skipped for that operand), so a GRU cell keeps
// its input and recurrent n-gate sums apart and adds the r and z sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tggcn {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr int kMTile = 16;
constexpr int kMaxRows = 32;            // rows per block: four n8 tiles
constexpr int kNTiles = kMaxRows / 8;

template <class T>
struct IsBf16 {
  static constexpr bool value = false;
};
template <>
struct IsBf16<bf16> {
  static constexpr bool value = true;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// A value of the IO type T from a float32 (round to nearest even).
template <class T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (IsBf16<T>::value)
    return __float2bfloat16_rn(x);
  else
    return x;
}

// x rounded to T and back: the identity for float32.
template <class T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <bool kColRows, int MT, class TW = float, class TX = float>
struct Stage {
  static constexpr bool kBf16 = IsBf16<TW>::value && IsBf16<TX>::value;
  static constexpr int kK = kBf16 ? 16 : 8;                  // depth of one mma step
  static constexpr int kChunk = kK * kWarps;                 // depth per stage: a step per warp
  // kColRows: [weight column][k], stride kChunk + 16 bytes (A fragments at
  // bank 4 m + k for float32, distinct 32-bit words m (kChunk + 8) / 2 + k
  // / 2 for bfloat16); else [k][weight column], stride MT * 16 + 8 (at bank
  // 8 k + m or 24 k + m). x: [row][k], stride kChunk + 16 bytes (B
  // fragments at bank 4 row + k, or 4 row + k / 2 for bfloat16).
  static constexpr int kWRows = kColRows ? MT * kMTile : kChunk;
  static constexpr int kWStride = kColRows ? kChunk + 16 / (int)sizeof(TW) : MT * kMTile + 8;
  static constexpr int kXStride = kChunk + 16 / (int)sizeof(TX);
  TW w[kWRows][kWStride];
  TX x[kMaxRows][kXStride];
};

constexpr int kPartStride = kMaxRows + 1;

// The warps' partial sums: S slots per warp.
template <int S>
struct Partials {
  float v[kWarps][S][kMTile][kPartStride];
};

template <bool kColRows, int MT, int S, int NS = kStages, class TW = float, class TX = float>
constexpr size_t smem_bytes() {
  return NS * sizeof(Stage<kColRows, MT, TW, TX>) > sizeof(Partials<S>)
             ? NS * sizeof(Stage<kColRows, MT, TW, TX>)
             : sizeof(Partials<S>);
}

// The block's weight columns: tile t starts at column col[t] of w (with
// kColRows, at row col[t]), and its first valid[t] columns are real; the
// others read as zero.
constexpr int kMaxTiles = 6;
struct Tiles {
  int col[kMaxTiles];
  int valid[kMaxTiles];
};

// One operand: x (rows, K) with row stride ldx, and the weight w with row
// stride ldw. Rows >= rows and depths >= K read as zero. ldx, ldw, K and
// the tiles' columns are multiples of a 16-byte copy's values (4 float32,
// 8 bfloat16) and the pointers 16-byte aligned.
template <class TW = float, class TX = float>
struct OperandT {
  const TX* x;
  int ldx;
  const TW* w;
  int ldw;
  int K;
  int rows = -1;                        // its own rows, or -1: accumulate's
};
using Operand = OperandT<>;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;             // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}
// A 4-byte copy (an unaligned float), through L1.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo exactly: hi is x with the 13 low bits of its mantissa cleared
// (a TF32 value), lo the float32 remainder, which the tensor core reads to
// TF32 by dropping its own 13 low bits. One logic op and one add a value:
// cvt.rna.tf32.f32, twice a value, cost more than the products it fed.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A (16 x 16, row-major) and B (16 x 8, column-major) in bfloat16 pairs of
// neighbouring k, the lower k in the low half; C as mma_tf32's.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two neighbouring bfloat16 values (4-byte aligned) as one 32-bit word.
__device__ __forceinline__ uint32_t pair(const bf16& lo) {
  return *reinterpret_cast<const uint32_t*>(&lo);
}

// Two bfloat16 values as one 32-bit word, lo in the low half.
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Field t < MT of a tile array, by selects (a dynamic index would put the
// array in local memory).
template <int MT>
__device__ __forceinline__ int pick(const int (&v)[kMaxTiles], int t) {
  int x = v[0];
#pragma unroll
  for (int i = 1; i < MT; ++i) x = t == i ? v[i] : x;
  return x;
}

// Copies chunk k0 of an operand into a stage. Every thread issues the same
// number of 16-byte copies at places fixed by its index, so the addressing
// is a few integer operations a copy (it competes for issue slots with the
// products).
template <bool kColRows, int MT, class TW, class TX>
__device__ __forceinline__ void load_chunk(Stage<kColRows, MT, TW, TX>& st,
                                           const OperandT<TW, TX>& op, const Tiles& tiles,
                                           int rows, int k0) {
  constexpr int kChunk = Stage<kColRows, MT, TW, TX>::kChunk;
  constexpr int kXV = 16 / sizeof(TX), kWV = 16 / sizeof(TW);   // values a copy
  constexpr int kXCopies = kMaxRows * kChunk / kXV / kThreads;
  constexpr int kWCopies = MT * kMTile * kChunk / kWV / kThreads;
  static_assert(kXCopies * kThreads == kMaxRows * kChunk / kXV, "x copies");
  static_assert(kWCopies * kThreads == MT * kMTile * kChunk / kWV, "w copies");
#pragma unroll
  for (int j = 0; j < kXCopies; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (kChunk / kXV), kk = (i % (kChunk / kXV)) * kXV;
    const bool valid = r < rows && k0 + kk < op.K;
    cp_async16(&st.x[r][kk], valid ? op.x + (size_t)r * op.ldx + k0 + kk : op.x, valid);
  }
#pragma unroll
  for (int j = 0; j < kWCopies; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if constexpr (kColRows) {
      const int m = i / (kChunk / kWV), kk = (i % (kChunk / kWV)) * kWV;
      const int t = m / kMTile, mm = m % kMTile;
      const bool valid = mm < pick<MT>(tiles.valid, t) && k0 + kk < op.K;
      cp_async16(&st.w[m][kk],
                 valid ? op.w + (size_t)(pick<MT>(tiles.col, t) + mm) * op.ldw + k0 + kk : op.w,
                 valid);
    } else {
      const int kk = i / (MT * kMTile / kWV), m = (i % (MT * kMTile / kWV)) * kWV;
      const int t = m / kMTile, mm = m % kMTile;
      const bool valid = mm < pick<MT>(tiles.valid, t) && k0 + kk < op.K;
      cp_async16(&st.w[kk][m],
                 valid ? op.w + (size_t)(k0 + kk) * op.ldw + pick<MT>(tiles.col, t) + mm : op.w,
                 valid);
    }
  }
}

// This warp's share of one staged chunk of operand P, into acc. With MG =
// 1 each warp takes one k8 step of the chunk for all MT tiles, into slot
// Map::slot(P, t). With MG > 1 the warps form MG groups of kWarps / MG:
// group g takes tiles g * MT / MG .. (g + 1) * MT / MG - 1, into its S =
// MT / MG slots in tile order (Map is not read), and MG steps of the
// chunk, so a block can own more tiles than one thread's registers hold.
// Round: see the note on numbers at the top (TF32 products only).
template <bool kColRows, int MT, int S, int P, class Map, int MG, bool Round, class TW, class TX>
__device__ __forceinline__ void multiply_chunk(const Stage<kColRows, MT, TW, TX>& st,
                                               int ntiles, float (&acc)[S][kNTiles][4]) {
  static_assert(MG == 1 || (MT % MG == 0 && S == MT / MG && kWarps % MG == 0), "groups");
  constexpr int kGroupWarps = kWarps / MG, kGroupTiles = MT / MG;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4, group = warp / kGroupWarps;
  if constexpr (Stage<kColRows, MT, TW, TX>::kBf16) {
    static_assert(!Round, "Round is for the TF32 products");
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      const int kk = 16 * (warp % kGroupWarps + j * kGroupWarps);
      uint32_t b[kNTiles][2];
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        if (n < ntiles) {
          b[n][0] = pair(st.x[8 * n + g][kk + 2 * q]);
          b[n][1] = pair(st.x[8 * n + g][kk + 2 * q + 8]);
        }
      }
#pragma unroll
      for (int lt = 0; lt < kGroupTiles; ++lt) {
        const int s = MG > 1 ? lt : Map::slot(P, lt);
        if (s < 0) continue;
        const int m = (group * kGroupTiles + lt) * kMTile + g;
        const int k = kk + 2 * q;
        uint32_t a[4];
        if constexpr (kColRows) {
          a[0] = pair(st.w[m][k]);
          a[1] = pair(st.w[m + 8][k]);
          a[2] = pair(st.w[m][k + 8]);
          a[3] = pair(st.w[m + 8][k + 8]);
        } else {
          a[0] = pack(st.w[k][m], st.w[k + 1][m]);
          a[1] = pack(st.w[k][m + 8], st.w[k + 1][m + 8]);
          a[2] = pack(st.w[k + 8][m], st.w[k + 9][m]);
          a[3] = pack(st.w[k + 8][m + 8], st.w[k + 9][m + 8]);
        }
#pragma unroll
        for (int n = 0; n < kNTiles; ++n)
          if (n < ntiles) mma_bf16(acc[s][n], a, b[n]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      const int kk = 8 * (warp % kGroupWarps + j * kGroupWarps);
      uint32_t bh[kNTiles][2], bl[kNTiles][2];
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        if (n < ntiles) {
          split(st.x[8 * n + g][kk + q], bh[n][0], bl[n][0]);
          split(st.x[8 * n + g][kk + q + 4], bh[n][1], bl[n][1]);
        }
      }
#pragma unroll
      for (int lt = 0; lt < kGroupTiles; ++lt) {
        const int s = MG > 1 ? lt : Map::slot(P, lt);
        if (s < 0) continue;
        const int m = (group * kGroupTiles + lt) * kMTile + g;
        float av[4];
        if constexpr (kColRows) {
          av[0] = to_f32(st.w[m][kk + q]);
          av[1] = to_f32(st.w[m + 8][kk + q]);
          av[2] = to_f32(st.w[m][kk + q + 4]);
          av[3] = to_f32(st.w[m + 8][kk + q + 4]);
        } else {
          av[0] = to_f32(st.w[kk + q][m]);
          av[1] = to_f32(st.w[kk + q][m + 8]);
          av[2] = to_f32(st.w[kk + q + 4][m]);
          av[3] = to_f32(st.w[kk + q + 4][m + 8]);
        }
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(av[i], ah[i], al[i]);
#pragma unroll
        for (int n = 0; n < kNTiles; ++n) {
          if (n < ntiles) {
            if constexpr (IsBf16<TW>::value) {
              // A bfloat16 weight is exact in TF32 (al = 0): two products.
              if constexpr (Round) {
                float c[4] = {0.f, 0.f, 0.f, 0.f};
                mma_tf32(c, ah, bl[n]);
                mma_tf32(c, ah, bh[n]);
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[s][n][i] += c[i];
              } else {
                mma_tf32(acc[s][n], ah, bl[n]);
                mma_tf32(acc[s][n], ah, bh[n]);
              }
            } else if constexpr (Round) {
              float c[4] = {0.f, 0.f, 0.f, 0.f};
              mma_tf32(c, al, bh[n]);
              mma_tf32(c, ah, bl[n]);
              mma_tf32(c, ah, bh[n]);
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[s][n][i] += c[i];
            } else {
              mma_tf32(acc[s][n], al, bh[n]);
              mma_tf32(acc[s][n], ah, bl[n]);
              mma_tf32(acc[s][n], ah, bh[n]);
            }
          }
        }
      }
    }
  }
}

// Nothing to do once a ring's first copies are issued (accumulate's early).
struct NoEarly {
  __device__ void operator()() const {}
};

// Accumulates the products of operands 0 .. NP-1 over their whole depths:
// acc[slot][n][i] holds tile column g or g + 8 and row 8 n + 2 q (+1) in
// the mma's C layout; store_partials and reduce read it back. NS is the
// depth of the ring, MG the number of warp groups, Round the rounding of
// each k8 step's sum (multiply_chunk). rows <= kMaxRows. The element
// types TW, TX are the operands'. early() runs once the first NS - 1
// chunks' copies are issued: work of the caller's (an epilogue's loads)
// whose latency the copies then hide. after_a() runs once operand a's
// last chunk is multiplied (the caller may take a's sums out of acc and
// clear it, so that b's sums start from zero while the ring runs on).
template <bool kColRows, int MT, int S, int NP, class Map, int NS = kStages, int MG = 1,
          bool Round = false, class TW, class TX, class Early = NoEarly,
          class AfterA = NoEarly>
__device__ __forceinline__ void accumulate(const OperandT<TW, TX>& a, const OperandT<TW, TX>& b,
                                           const OperandT<TW, TX>& c, const Tiles& tiles,
                                           int rows, unsigned char* smem,
                                           float (&acc)[S][kNTiles][4], Early early = Early(),
                                           AfterA after_a = AfterA()) {
  static_assert(NS >= 2, "ring");
  using St = Stage<kColRows, MT, TW, TX>;
  constexpr int kChunk = St::kChunk;
  St* buf = reinterpret_cast<St*>(smem);
  const int na = (a.K + kChunk - 1) / kChunk;
  const int nb = NP > 1 ? (b.K + kChunk - 1) / kChunk : 0;
  const int nc = NP > 2 ? (c.K + kChunk - 1) / kChunk : 0;
  const int total = na + nb + nc;
  const int rows_a = a.rows >= 0 ? a.rows : rows, rows_b = b.rows >= 0 ? b.rows : rows;
  const int rows_c = c.rows >= 0 ? c.rows : rows;
  auto prefetch = [&](int i) {
    if (i < total) {
      if (i < na)
        load_chunk(buf[i % NS], a, tiles, rows_a, i * kChunk);
      else if (i < na + nb)
        load_chunk(buf[i % NS], b, tiles, rows_b, (i - na) * kChunk);
      else
        load_chunk(buf[i % NS], c, tiles, rows_c, (i - na - nb) * kChunk);
    }
    cp_async_commit();
  };
  for (int i = 0; i < NS - 1; ++i) prefetch(i);
  early();
  for (int i = 0; i < total; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();                    // chunk i is in; chunk i - 1's buffer is free
    prefetch(i + NS - 1);
    const St& st = buf[i % NS];
    if (i < na) {
      multiply_chunk<kColRows, MT, S, 0, Map, MG, Round>(st, (rows_a + 7) / 8, acc);
      if (i == na - 1) after_a();
    } else if (NP > 1 && i < na + nb) {
      multiply_chunk<kColRows, MT, S, 1, Map, MG, Round>(st, (rows_b + 7) / 8, acc);
    } else if (NP > 2) {
      multiply_chunk<kColRows, MT, S, 2, Map, MG, Round>(st, (rows_c + 7) / 8, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                      // the ring is free for the partial sums
}

template <int S>
__device__ __forceinline__ void store_partials(unsigned char* smem,
                                               const float (&acc)[S][kNTiles][4]) {
  Partials<S>& pt = *reinterpret_cast<Partials<S>*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      pt.v[warp][s][g][8 * n + 2 * q] = acc[s][n][0];
      pt.v[warp][s][g][8 * n + 2 * q + 1] = acc[s][n][1];
      pt.v[warp][s][g + 8][8 * n + 2 * q] = acc[s][n][2];
      pt.v[warp][s][g + 8][8 * n + 2 * q + 1] = acc[s][n][3];
    }
}

// Slot s (of S * MG, the warps' S slots per group) at tile column m (0..15)
// and row r: the sum of the parts of the warps that own it, in warp order.
template <int S, int MG = 1>
__device__ __forceinline__ float reduce(const unsigned char* smem, int s, int m, int r) {
  const Partials<S>& pt = *reinterpret_cast<const Partials<S>*>(smem);
  constexpr int kGroupWarps = kWarps / MG;
  const int w0 = MG > 1 ? s / S * kGroupWarps : 0, ls = MG > 1 ? s % S : s;
  float v = 0.f;
#pragma unroll
  for (int w = 0; w < kGroupWarps; ++w) v += pt.v[w0 + w][ls][m][r];
  return v;
}

// One slot for every tile of every operand.
struct OneSlot {
  __host__ __device__ static constexpr int slot(int, int) { return 0; }
};

// Slot t for tile t of every operand.
struct TileSlots {
  __host__ __device__ static constexpr int slot(int, int t) { return t; }
};

}  // namespace tc
}  // namespace tggcn
