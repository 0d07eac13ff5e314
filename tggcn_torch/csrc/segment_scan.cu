// K3: the bidirectional gated segment scan of the 2G-GCN, 'dot' attention.
//
// Replaces the TPU kernel tggcn/ops/segment_scan_pallas.py::_make_kernel in
// mode 'dot' (launched by _seg_dir_pallas, segment_scan_pallas.py:268). The
// TPU kernel runs one direction's whole step per grid step with every
// weight resident in VMEM. Here no block may wait for another, so each time
// step is three launches whose order on the stream orders the phases, and
// both directions (d = 0 forward, d = 1 backward in time) share each launch:
//
//   A  proj:  m_e = relu(h_src @ w_from[e] + b_from[e]) for the four edges
//             e = hh, ho (from the human states), oh, oo (from the objects);
//             blocks own 32 columns of one (direction, edge) and up to 32
//             rows.
//   M  mix:   per (batch, direction, column slice): scaled dot scores
//             between the carried states, the masked softmax over senders
//             (1 - eye on h2h, the object mask on o2h, both on o2o, finite
//             fill so a fully masked row gives zeros), att_oh out, and the
//             attention-weighted messages mix_h = [a_hh m_hh, a_oh m_oh],
//             mix_o = [a_ho m_ho, a_oo m_oo].
//   B  cell:  gi = gi_base + mix @ w_msg, gh = h_prev @ w_hh + b_hh, GRU
//             gates r, z, n, h_new = (1 - z) n + z h_prev, and the commit
//             h = u h_new + (1 - u) h_prev; blocks own 16 hidden units (their
//             r, z and n columns) of one (direction, cell) and up to 32 rows.
// A and B run their products on the tensor cores through tc_gemm.cuh
// (mma.sync TF32 with the 3xTF32 split, float32 accumulation; weight
// columns on the mma's M side, the step's 16 or 32 rows on its N side), so
// each weight is read once per step; in bfloat16 through wg_gemm.cuh
// (wgmma fed by TMA, the weights read MN-major as stored: proj_wg, cell_wg).
//
// What the backward (K4) reads is kept when the caller asks (keep = 1, the
// training forward): every step's edge messages m_h = [hh | ho] per human
// and m_o = [oh | oo] per object (K4 takes the ReLU's derivative where the
// forward was, instead of on the far side of a kink after a recompute), the
// mixed messages mix_h, mix_o, the full softmaxed attention `atts` (E x E
// per batch) and the gates [r | z | n | hn] of every cell row, hn = h_prev
// @ w_hh_n + b_hh_n. K4 then needs no gate product and no attention. With
// keep = 0 (serving), m and mix hold one step per direction and nothing
// else is written.
//
// K5, the same scan in the other attention modes of _make_kernel, is the
// same three phases with the mode a template parameter of A and M (the
// 'dot' instantiation is K3 as above). Each step's scores are computed
// once per (batch, direction), in A, and M only reads them, takes the
// masked softmax and mixes, as in 'ext':
//   v1   four more blocks in A (one per direction and source group, after
//        the 128 message blocks at the MPHOI shape: 132, one wave on the
//        H100's 132 SMs) take the four projections of each entity's state
//        against w_att, proj (2, B, E, 4): n as the receiver of each
//        sender group (the first half of w_att[e]) and as the sender to
//        each receiver group (the second half); a warp a projection, the
//        dot product strided over the lanes. M scores relu(proj[n][g_m] +
//        proj[m][2 + g_n] + b_att[e]).
//   v4   A runs its own kernel, proj_v4_kernel: each block owns 32 columns
//        of BOTH edges of one source group (four tiles of 16 columns, one
//        load of the rows for two weights), either the messages (hh, ho or
//        oh, oo) or tmp_e = recv @ W_e for the group's two score edges as
//        receiver (hh, oh or ho, oo). A tmp block never writes tmp: its
//        epilogue multiplies its 32 columns by the senders' states into
//        partial scores, part (2, B, E, E, h / 32), and M adds the h / 32
//        partials of a score in column order and scores relu(sum +
//        b_att[e]). 2 kinds x 2 groups x 16 column pairs x 2 directions =
//        128 blocks at the MPHOI shape, one wave (one edge a block would
//        be 256 blocks of a 150 KB ring each: two waves at one block an SM).
//   ext  M reads step t of the weights computed outside (mean pooling or
//        inverse distances), already softmaxed, and scores nothing.
// M stages the scores A made in shared memory (v1 E * 4, v4 E * E * h / 32
// floats) and takes the masked softmax one warp a receiver row, its lanes
// the senders, in masked_softmax_row's order (one thread a row waits on a
// chain of global loads and exponentials: on the H100, 1.5-1.75 ms of the
// call that way, 0.66-0.80 ms this way, against ext's 0.50 with no
// softmax; PERF.md).
// What bounds A is the bytes a block copies into shared memory (PERF.md,
// the K1-K4 redesign): a v4 block copies two weights' tiles and one set of
// rows, 1.44 times a K3 block's bytes a chunk, in one wave instead of two;
// its ring (4 stages of 53,760 bytes, 215,040 with the epilogue's buffers)
// allows one block an SM, as K3's does
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor: 1; -Xptxas -v: 128
// registers, no spills). On the H100 v4's A phase takes 1.65 ms a bf16 call
// (two waves of one edge a block took 1.84), 1.6 times K3's.
// w_att and b_att are in score order, by receiver then sender: hh, oh, ho,
// oo (segment_scan_pallas.py:729), unlike w_from's hh, ho, oh, oo. K5 is
// forward only: it runs with keep = 0.
//
// Bound on an H100. Per step and direction at the MPHOI shape (B=8, H=2,
// O=4, h=512) the matmuls do 2*(96*h*h + 48*3h*3h) = 277 MFLOP (four
// projections over 16+16+32+32 rows; 48 cell rows of depth 3h), so 92 GFLOP
// for both directions over T=167: 1.38 ms of float32 FMAs at 67 TFLOP/s,
// 0.56 ms as 3xTF32 (three TF32 products each, 495 TFLOP/s). The weights
// (46 MB a step for both directions) are read from L2 every step; HBM has to
// carry gi in, the states out and, with keep, 263 MB of kept tensors (0.08
// ms at 3.35 TB/s). v1 and ext do about the same work; v4 adds
// 2 * 96 * h * h * 2 * T = 17 GFLOP.
//
// bfloat16 (T = bf16: gi, u, the weights, the mask, h0 and the outputs
// h_h, h_o, att_oh in bfloat16), as the TPU kernel runs it
// (segment_scan_pallas.py:92-220; 'dot' with fuse_dirs): the states stay float32, in
// buffers of their own (state_h, state_o: (2, rows, h), updated in place by
// B, each element by the thread that reads it), not in the bfloat16
// outputs, which would round the carried state at every step. A's and B's
// products are bfloat16 x bfloat16 with float32 sums (wg_gemm.cuh: wgmma
// m64n32k16; K5's v1 and v4 A phases tc_gemm.cuh's m16n8k16)
// on the activations rounded as the TPU kernel's astype(wdt) rounds them:
// the states (the bfloat16 outputs of the step before, or h0) and the mixed
// messages, which M writes in bfloat16. M's scores, softmax and mixing take
// the float32 states and edge messages; the kept m, gates and attention are
// float32, the kept mix the bfloat16 the product read. Bound: the same
// 92 GFLOP at the dense bfloat16 rate (989 TFLOP/s), 0.09 ms, and the
// scores and mixing on the FMA units; the weights are half the bytes.
// K5 in bfloat16 rounds each mode's scores where the TPU kernel does
// (scores_v1 :123, scores_v4 :134, :147-149): v1 takes the float32 states
// rounded to bfloat16 (the bfloat16 outputs of the step before, or h0)
// against the bfloat16 w_att; v4's A phase takes the bfloat16 states
// against W_att, rounds each element of that product's float32 sum to
// bfloat16 and multiplies it by the float32 sender state (state_h,
// state_o) in float32 (JAX promotes the bfloat16 x float32 product); ext
// widens the bfloat16 weights computed outside.

#include "tc_gemm.cuh"
#include "wg_gemm.cuh"

namespace {

using namespace tggcn::tc;
namespace wg = tggcn::wg;

constexpr int kMaxEntities = 16;
constexpr int kMixColumns = 128;   // mix columns (of 2h) per mix block

// Attention modes: the codes of tggcn_segment_scan_att_f32's `mode`.
constexpr int kDot = 0, kV1 = 1, kV4 = 2, kExt = 3;

struct Step {
  int d, t;   // direction and the time it processes at this step
};

__device__ __forceinline__ Step step_of(int step, int T) {
  const int d = blockIdx.z;
  return {d, d == 0 ? step : T - 1 - step};
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// The states this step reads: h0 at the first step, else the previous
// step's output of the same direction. rows = B * entities.
template <class T>
__device__ __forceinline__ const T* prev_state(const T* h0, const T* out, Step s, int step,
                                               int T_, int rows, int H) {
  if (step == 0) return h0 + (size_t)s.d * rows * H;
  const int tp = s.d == 0 ? s.t - 1 : s.t + 1;
  return out + ((size_t)s.d * T_ + tp) * rows * H;
}

// The slot of a kept per-step tensor (m, mix, gates) at the step's (d, t):
// every step's with keep, else one per direction.
__device__ __forceinline__ size_t slot_of(Step s, int T, int keep) {
  return keep ? (size_t)s.d * T + s.t : (size_t)s.d;
}

// Edge e's message row `row`: m_h holds the edges hh | ho of each human,
// m_o the edges oh | oo of each object.
__device__ __forceinline__ size_t msg_at(Step s, int T, int keep, int rows, int row, int e,
                                         int H) {
  return (slot_of(s, T, keep) * rows + row) * 2 * H + (size_t)(e & 1) * H;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The float32 states this step reads: with bfloat16 IO the carried states
// (state, (2, rows, H)), else the IO-type states themselves.
template <class T>
__device__ __forceinline__ const float* f32_state(const T* h0, const T* out, const float* state,
                                                  Step s, int step, int T_, int rows, int H) {
  if constexpr (IsBf16<T>::value)
    return state + (size_t)s.d * rows * H;
  else
    return prev_state(h0, out, s, step, T_, rows, H);
}

// Four values of x as float32 (16 or 8 aligned bytes).
__device__ __forceinline__ float4 load4(const float* x) {
  return *reinterpret_cast<const float4*>(x);
}
__device__ __forceinline__ float4 load4(const bf16* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(x);
  const bf16* v = reinterpret_cast<const bf16*>(&u);
  return make_float4(to_f32(v[0]), to_f32(v[1]), to_f32(v[2]), to_f32(v[3]));
}

// v1's projections of source group g (0 humans, 1 objects) for every row
// of the group, into proj (2, B, E, 4): proj[n][j] for j < 2 is n as the
// receiver of senders of group j (the first half of w_att[2 g + j]), for j
// >= 2 n as the sender to receivers of group j - 2 (the second half of
// w_att[2 (j - 2) + g]). x holds the states in the IO type: the bfloat16
// outputs are the float32 states rounded as the TPU kernel rounds them. A
// warp a row: each lane takes four neighbouring values of every 128, all
// its loads issued before the sums, then four warp sums.
template <class T>
__device__ void v1_projections(const T* x, const T* w_att, float* proj, Step s, int g, int B,
                               int NH, int NO, int H) {
  const int ng = g == 0 ? NH : NO, E = NH + NO;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const T* w[4] = {w_att + (size_t)(2 * g) * 2 * H, w_att + (size_t)(2 * g + 1) * 2 * H,
                   w_att + (size_t)g * 2 * H + H, w_att + (size_t)(2 + g) * 2 * H + H};
  for (int r = warp; r < B * ng; r += kWarps) {
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 4 * lane; k < H; k += 128) {
      const float4 xv = load4(x + (size_t)r * H + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 wv = load4(w[j] + k);
        dot[j] = fmaf(xv.x, wv.x, dot[j]);
        dot[j] = fmaf(xv.y, wv.y, dot[j]);
        dot[j] = fmaf(xv.z, wv.z, dot[j]);
        dot[j] = fmaf(xv.w, wv.w, dot[j]);
      }
    }
    const int b = r / ng, n = (g == 0 ? 0 : NH) + r % ng;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = warp_sum(dot[j]);
      if (lane == 0) proj[(((size_t)s.d * B + b) * E + n) * 4 + j] = v;
    }
  }
}

// Blocks own 32 columns of one (direction, edge) and up to 32 rows: edges
// 0-3 are the messages hh, ho (from the humans) and oh, oo (from the
// objects). In v1 the grid is flat in x: blocks below col_pairs * 4 *
// row_tiles are those (x = column pair + col_pairs * y), and the two after
// them (per direction) take v1_projections of the humans and the objects.
template <int Mode, class T>
__global__ void __launch_bounds__(kThreads)
proj_kernel(const T* __restrict__ h0_h, const T* __restrict__ h0_o,
            const T* __restrict__ out_h, const T* __restrict__ out_o,
            const T* __restrict__ w_from, const T* __restrict__ b_from,
            float* __restrict__ m_h, float* __restrict__ m_o,
            const T* __restrict__ w_att, float* __restrict__ proj, int keep, int T_, int B,
            int NH, int NO, int H, int row_tiles, int step) {
  const Step s = step_of(step, T_);
  int bx = blockIdx.x, by = blockIdx.y;
  if constexpr (Mode == kV1) {
    const int col_pairs = (H + 2 * kMTile - 1) / (2 * kMTile);
    const int regular = col_pairs * 4 * row_tiles;
    if (bx >= regular) {
      const int g = bx - regular;
      const T* x = g == 0 ? prev_state(h0_h, out_h, s, step, T_, B * NH, H)
                          : prev_state(h0_o, out_o, s, step, T_, B * NO, H);
      v1_projections<T>(x, w_att, proj, s, g, B, NH, NO, H);
      return;
    }
    by = bx / col_pairs;
    bx %= col_pairs;
  }
  const int e = by / row_tiles;
  const int row0 = (by % row_tiles) * kMaxRows;
  const int col0 = bx * 2 * kMTile;
  const int group = e < 2 ? 0 : 1;          // the source: humans, objects
  const int all_rows = B * (group == 0 ? NH : NO);
  if (row0 >= all_rows) return;
  const int rows = min(kMaxRows, all_rows - row0);
  const T* x = (group == 0 ? prev_state(h0_h, out_h, s, step, T_, all_rows, H)
                           : prev_state(h0_o, out_o, s, step, T_, all_rows, H))
               + (size_t)row0 * H;
  const T* w = w_from + (size_t)e * H * H;
  extern __shared__ __align__(16) unsigned char smem[];
  float acc[2][kNTiles][4] = {};
  const OperandT<T, T> op = {x, H, w, H, H};
  const Tiles tiles = {{col0, col0 + kMTile, 0},
                       {max(0, min(kMTile, H - col0)), max(0, min(kMTile, H - col0 - kMTile)), 0}};
  accumulate<false, 2, 2, 1, TileSlots>(op, op, op, tiles, rows, smem, acc);
  store_partials<2>(smem, acc);
  __syncthreads();
  for (int p = threadIdx.x; p < 2 * kMTile * kMaxRows; p += kThreads) {
    const int t = p / (kMTile * kMaxRows), c = p % kMTile, r = (p / kMTile) % kMaxRows;
    const int row = row0 + r, col = col0 + t * kMTile + c;
    if (r >= rows || col >= H) continue;
    const float v = reduce<2>(smem, t, c, r);
    (e < 2 ? m_h : m_o)[msg_at(s, T_, keep, all_rows, row, e, H) + col] =
        fmaxf(v + to_f32(b_from[(size_t)e * H + col]), 0.f);
  }
}

// A in bfloat16 (modes dot and ext) on wgmma fed by TMA (wg_gemm.cuh):
// the same blocks as proj_kernel (32 columns of one (direction, edge), up
// to 32 rows), the block's two 16-column pieces of w_from[e] read MN-major
// as stored. Maps: w_from (4 planes of h x h), and per source group (0
// humans, 1 objects) the outputs (2T planes of rows x h) and h0 (2 planes).
struct ProjMaps {
  CUtensorMap w;
  CUtensorMap out[2], h0[2];
};

// The stages of 64 of proj_wg's and cell_wg's products at width H (the
// depth of each operand in turn), which also size their rings.
__host__ __device__ constexpr int proj_chunks(int H) { return (H + wg::kDepth - 1) / wg::kDepth; }
__host__ __device__ constexpr int cell_in_chunks(int H) {
  return (2 * H + wg::kDepth - 1) / wg::kDepth;
}
__host__ __device__ constexpr int cell_chunks(int H) { return cell_in_chunks(H) + proj_chunks(H); }

struct ProjPlan {
  const CUtensorMap *w, *x;
  wg::Rows rows;
  int e, col0, plane, H;
  __device__ int chunks() const { return proj_chunks(H); }
  __device__ int acc(int) const { return 0; }
  __device__ int a_bytes() const { return 2 * wg::kPieceBytes; }
  __device__ int b_bytes() const { return rows.bytes(); }
  __device__ void prefetch() const {
    wg::tma_prefetch(w);
    wg::tma_prefetch(x);
  }
  __device__ void issue(int i, uint32_t a, uint32_t b, uint32_t bar) const {
    const int k0 = i * wg::kDepth;
    wg::bar_expect(bar, a_bytes() + b_bytes());
    for (int p = 0; p < 2; ++p)
      wg::tma_load(a + p * wg::kPieceBytes, w, bar, col0 + p * wg::kPiece, k0, e);
    rows.load(b, x, bar, k0, plane);
  }
};

// The plane of the state maps (ProjMaps, CellMaps) this step reads: h0's
// plane d at the first step, else the output plane of the step before.
__device__ __forceinline__ int prev_plane(Step s, int step, int T_) {
  return step == 0 ? s.d : s.d * T_ + (s.d == 0 ? s.t - 1 : s.t + 1);
}

__global__ void __launch_bounds__(wg::kThreads)
proj_wg(const __grid_constant__ ProjMaps maps, const bf16* __restrict__ b_from,
        float* __restrict__ m_h, float* __restrict__ m_o, int keep, int T_, int B, int NH,
        int NO, int H, int row_tiles, int step) {
  const Step s = step_of(step, T_);
  const int e = blockIdx.y / row_tiles;
  const int row0 = (blockIdx.y % row_tiles) * kMaxRows;
  const int col0 = blockIdx.x * 2 * kMTile;
  const int group = e < 2 ? 0 : 1;          // the source: humans, objects
  const int all_rows = B * (group == 0 ? NH : NO);
  if (row0 >= all_rows) return;
  const int rows = min(kMaxRows, all_rows - row0);
  const ProjPlan plan{&maps.w, step == 0 ? &maps.h0[group] : &maps.out[group],
                      {row0, rows, wg::row_box(all_rows)}, e, col0, prev_plane(s, step, T_), H};
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = wg::align1024(smem_raw);
  const wg::Ring ring = wg::begin(smem, plan.chunks());
  // Each consumer thread's column (the same in its kPer outputs), and its
  // bias, loaded before the product.
  constexpr int kPer = 2 * kMTile * kMaxRows / wg::kConsumerThreads;
  const int m = threadIdx.x % (2 * kMTile), col = col0 + m;
  const uint16_t bias = threadIdx.x < wg::kConsumerThreads && col < H
                            ? wg::load_now(b_from + (size_t)e * H + col)
                            : 0;
  float acc[1][16];
  if (!wg::product<1>(plan, ring, acc)) return;
  wg::store_partials<1>(smem, acc);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = (threadIdx.x + j * wg::kConsumerThreads) / (2 * kMTile), row = row0 + r;
    if (r >= rows || col >= H) continue;
    (e < 2 ? m_h : m_o)[msg_at(s, T_, keep, all_rows, row, e, H) + col] =
        fmaxf(wg::reduce<1>(smem, 0, m, r) + wg::widen(bias), 0.f);
  }
}

// v4's tmp values of a block, rounded to T as the TPU kernel's astype(wdt)
// rounds them ([sender group][row][32 columns]), and the float32 states of
// the senders of its rows' batches over its 32 columns ([batch][sender][32
// columns]), after the partial sums in shared memory; rows padded to 33
// floats, so the threads of a warp, each on its own row, read other banks.
constexpr int kPad = 2 * kMTile + 1;
constexpr size_t kTmpBytes = 2 * kMaxRows * kPad * sizeof(float);
constexpr size_t kSendBytes = (kMaxRows + 1) * kMaxEntities * kPad * sizeof(float);

// v4's projection phase. Block (column pair, y, direction), y = (kind * 2 +
// g) * row_tiles + row tile: 32 columns of both edges 2 g and 2 g + 1 of
// source group g (four tiles of 16 columns of w_from, kind 0, or of w_att,
// kind 1) and up to 32 rows of the group. Kind 0 writes the messages (hh,
// ho or oh, oo) as proj_kernel; kind 1 holds tmp_e = recv @ W_att[e] of the
// score edges e = 2 g + g_m (hh, oh for the humans as receivers, ho, oo for
// the objects) and writes, for each of its rows n and every sender m of the
// row's batch, the partial score sum over its columns c of q(tmp_e[n][c])
// * state[m][c] (state float32, q the rounding to T) into part[d][b][n][m]
// [column pair], part (2, B, E, E, col_pairs).
template <class T>
__global__ void __launch_bounds__(kThreads)
proj_v4_kernel(const T* __restrict__ h0_h, const T* __restrict__ h0_o,
               const T* __restrict__ out_h, const T* __restrict__ out_o,
               const float* __restrict__ state_h, const float* __restrict__ state_o,
               const T* __restrict__ w_from, const T* __restrict__ b_from,
               float* __restrict__ m_h, float* __restrict__ m_o, const T* __restrict__ w_att,
               float* __restrict__ part, int T_, int B, int NH, int NO, int H, int row_tiles,
               int step) {
  const Step s = step_of(step, T_);
  const int kind = blockIdx.y / (2 * row_tiles);
  const int g = (blockIdx.y / row_tiles) % 2;
  const int row0 = (blockIdx.y % row_tiles) * kMaxRows;
  const int col0 = blockIdx.x * 2 * kMTile;
  const int ng = g == 0 ? NH : NO;
  const int all_rows = B * ng;
  if (row0 >= all_rows) return;
  const int rows = min(kMaxRows, all_rows - row0);
  const T* x = (g == 0 ? prev_state(h0_h, out_h, s, step, T_, all_rows, H)
                       : prev_state(h0_o, out_o, s, step, T_, all_rows, H))
               + (size_t)row0 * H;
  const int e0 = 2 * g * H * H, e1 = e0 + H * H;            // edges 2 g, 2 g + 1
  const int v0 = max(0, min(kMTile, H - col0)), v1 = max(0, min(kMTile, H - col0 - kMTile));
  const Tiles tiles = {{e0 + col0, e0 + col0 + kMTile, e1 + col0, e1 + col0 + kMTile},
                       {v0, v1, v0, v1}};
  extern __shared__ __align__(16) unsigned char smem[];
  float acc[4][kNTiles][4] = {};
  const OperandT<T, T> op = {x, H, kind == 0 ? w_from : w_att, H, H};
  accumulate<false, 4, 4, 1, TileSlots>(op, op, op, tiles, rows, smem, acc);
  store_partials<4>(smem, acc);
  __syncthreads();
  if (kind == 0) {
    for (int p = threadIdx.x; p < 4 * kMTile * kMaxRows; p += kThreads) {
      const int t = p / (kMTile * kMaxRows), c = p % kMTile, r = (p / kMTile) % kMaxRows;
      const int e = 2 * g + t / 2, row = row0 + r, col = col0 + (t % 2) * kMTile + c;
      if (r >= rows || col >= H) continue;
      const float v = reduce<4>(smem, t, c, r);
      (g == 0 ? m_h : m_o)[msg_at(s, T_, 0, all_rows, row, e, H) + col] =
          fmaxf(v + to_f32(b_from[(size_t)e * H + col]), 0.f);
    }
    return;
  }
  float* tv = reinterpret_cast<float*>(smem + sizeof(Partials<4>));
  float* ss = tv + 2 * kMaxRows * kPad;
  for (int p = threadIdx.x; p < 4 * kMTile * kMaxRows; p += kThreads) {
    const int t = p / (kMTile * kMaxRows), c = p % kMTile, r = (p / kMTile) % kMaxRows;
    tv[((t / 2) * kMaxRows + r) * kPad + (t % 2) * kMTile + c] =
        round_to<T>(reduce<4>(smem, t, c, r));
  }
  const int E = NH + NO, width = min(2 * kMTile, H - col0);
  const int b0 = row0 / ng, nb = (row0 + rows - 1) / ng - b0 + 1;
  const float* send_h = f32_state(h0_h, out_h, state_h, s, step, T_, B * NH, H) + col0;
  const float* send_o = f32_state(h0_o, out_o, state_o, s, step, T_, B * NO, H) + col0;
  for (int i = threadIdx.x; i < nb * E * 8; i += kThreads) {
    const int sr = i / 8, c = (i % 8) * 4, b = b0 + sr / E, m = sr % E;
    const float* src = m < NH ? send_h + ((size_t)b * NH + m) * H
                              : send_o + ((size_t)b * NO + m - NH) * H;
    const float4 v = c < width ? load4(src + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    float* dst = ss + sr * kPad + c;
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < rows * E; p += kThreads) {
    const int r = p / E, m = p % E, gm = m < NH ? 0 : 1;
    const int row = row0 + r, b = row / ng, n = (g == 0 ? 0 : NH) + row % ng;
    const float* send = ss + ((b - b0) * E + m) * kPad;
    const float* tr = tv + (gm * kMaxRows + r) * kPad;
    float v = 0.f;
    for (int c = 0; c < width; ++c) v = fmaf(tr[c], send[c], v);
    part[((((size_t)s.d * B + b) * E + n) * E + m) * gridDim.x + blockIdx.x] = v;
  }
}

// Masked softmax over senders [first, first + n) of row `a`, in place on
// the scores; mask(m) gives the sender's weight (0 or 1).
template <typename Mask>
__device__ void masked_softmax_row(float* a, int first, int n, Mask mask) {
  float mx = -1e30f;
  for (int m = 0; m < n; ++m) mx = fmaxf(mx, mask(m) > 0.f ? a[first + m] : -1e30f);
  float den = 0.f;
  for (int m = 0; m < n; ++m) {
    const float v = mask(m) > 0.f ? a[first + m] : -1e30f;
    const float ev = expf(v - mx) * mask(m);
    a[first + m] = ev;
    den += ev;
  }
  den = fmaxf(den, 1e-30f);
  for (int m = 0; m < n; ++m) a[first + m] /= den;
}

// Per (batch, column slice, direction): the scores of the mode (dot: from
// the carried states; v1, v4: from what A wrote, proj or part; ext: the
// weights as given), the masked softmax, att_oh (and, with keep, the whole
// E x E attention) and the mixed messages (in T).
// Dynamic shared memory: dot, the (NH + NO) carried states of the block's
// batch, float32 (with bfloat16 IO, from state_h and state_o); v1 and v4,
// the batch's scores from A (E * 4 or E * E * h / 32 floats).
template <int Mode, class T>
__global__ void __launch_bounds__(kThreads)
mix_kernel(const T* __restrict__ h0_h, const T* __restrict__ h0_o,
           const T* __restrict__ out_h, const T* __restrict__ out_o,
           const float* __restrict__ state_h, const float* __restrict__ state_o,
           const T* __restrict__ obj_mask, const float* __restrict__ m_h,
           const float* __restrict__ m_o, const T* __restrict__ b_att,
           const float* __restrict__ scores_in, const T* __restrict__ att_ext,
           T* __restrict__ mix_h, T* __restrict__ mix_o,
           T* __restrict__ att, float* __restrict__ atts, int keep, int T_, int B,
           int NH, int NO, int H, float scale, int step) {
  const Step s = step_of(step, T_);
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kMixColumns;
  const int E = NH + NO;
  const float* hh;
  const float* ho;
  if constexpr (IsBf16<T>::value) {
    hh = state_h + ((size_t)s.d * B * NH + (size_t)b * NH) * H;
    ho = state_o + ((size_t)s.d * B * NO + (size_t)b * NO) * H;
  } else {
    hh = prev_state(h0_h, out_h, s, step, T_, B * NH, H) + (size_t)b * NH * H;
    ho = prev_state(h0_o, out_o, s, step, T_, B * NO, H) + (size_t)b * NO * H;
  }

  extern __shared__ float4 states4[];
  float* states = reinterpret_cast<float*>(states4);       // (E, H)
  __shared__ float a[kMaxEntities][kMaxEntities];
  __shared__ float om_s[kMaxEntities];      // v1, v4: the batch's object mask
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if constexpr (Mode == kDot) {
    for (int i = tid; i < E * H / 4; i += kThreads) {
      const int n = (4 * i) / H, k = (4 * i) % H;
      const float* src = n < NH ? hh + (size_t)n * H : ho + (size_t)(n - NH) * H;
      states4[i] = *reinterpret_cast<const float4*>(src + k);
    }
    __syncthreads();
  }
  if constexpr (Mode == kDot) {
    for (int p = warp; p < E * E; p += kWarps) {
      const int n = p / E, m = p % E;
      float dot = 0.f;
      for (int k = lane; k < H; k += 32) dot = fmaf(states[n * H + k], states[m * H + k], dot);
      for (int off = 16; off > 0; off /= 2) dot += __shfl_down_sync(0xffffffffu, dot, off);
      if (lane == 0) a[n][m] = dot * scale;
    }
  } else if constexpr (Mode == kExt) {
    for (int i = tid; i < E * E; i += kThreads)
      a[i / E][i % E] = to_f32(att_ext[(((size_t)s.t * B + b) * E + i / E) * E + i % E]);
  } else {
    // v1, v4: the scores A made (proj, or part), staged in shared memory,
    // then one warp a receiver row n, lane m its sender: the score edge
    // is 2 g_n + g_m. The masked softmax over each sender group is
    // masked_softmax_row's arithmetic in its order (the row's maximum,
    // then the sum of its exponentials in sender order), across the lanes.
    float* sc = reinterpret_cast<float*>(states4);
    const int parts = (H + 2 * kMTile - 1) / (2 * kMTile);
    const int count = Mode == kV1 ? E * 4 : E * E * parts;
    const float* src = scores_in + ((size_t)s.d * B + b) * count;
    for (int i = tid; i < count; i += kThreads) sc[i] = src[i];
    if (tid < NO) om_s[tid] = to_f32(obj_mask[(size_t)b * NO + tid]);
    __syncthreads();
    if (warp < E) {
      const int n = warp, m = lane < E ? lane : 0;
      const int gn = n < NH ? 0 : 1, gm = m < NH ? 0 : 1;
      float v;
      if constexpr (Mode == kV1) {
        v = fmaxf(sc[n * 4 + gm] + sc[m * 4 + 2 + gn] + to_f32(b_att[2 * gn + gm]), 0.f);
      } else {
        v = 0.f;
        for (int p = 0; p < parts; ++p) v += sc[(n * E + m) * parts + p];
        v = fmaxf(v + to_f32(b_att[2 * gn + gm]), 0.f);
      }
      const float mask = gm == 0 ? (gn == 0 && m == n ? 0.f : 1.f)
                                 : (gn == 1 && m == n ? 0.f : om_s[m - NH]);
      const int first = gm == 0 ? 0 : NH, last = gm == 0 ? NH : E;
      const float x = mask > 0.f ? v : -1e30f;
      float mx = -1e30f;
      for (int j = 0; j < E; ++j) {
        const float xj = __shfl_sync(0xffffffffu, x, j);
        if (j >= first && j < last) mx = fmaxf(mx, xj);
      }
      const float ev = expf(x - mx) * mask;
      float den = 0.f;
      for (int j = 0; j < E; ++j) {
        const float ej = __shfl_sync(0xffffffffu, ev, j);
        if (j >= first && j < last) den += ej;
      }
      den = fmaxf(den, 1e-30f);
      if (lane < E) a[n][m] = ev / den;
    }
  }
  __syncthreads();
  const T* om = obj_mask + (size_t)b * NO;
  if (Mode == kDot && tid < E) {
    const int n = tid;
    if (n < NH) {
      masked_softmax_row(a[n], 0, NH, [&](int m) { return m == n ? 0.f : 1.f; });
      masked_softmax_row(a[n], NH, NO, [&](int o) { return to_f32(om[o]); });
    } else {
      const int o = n - NH;
      masked_softmax_row(a[n], 0, NH, [&](int) { return 1.f; });
      masked_softmax_row(a[n], NH, NO, [&](int p) { return p == o ? 0.f : to_f32(om[p]); });
    }
  }
  __syncthreads();
  if (blockIdx.y == 0) {
    for (int i = tid; i < NH * NO; i += kThreads) {
      const int n = i / NO, o = i % NO;
      att[((((size_t)s.d * T_ + s.t) * B + b) * NH + n) * NO + o] = from_f32<T>(a[n][NH + o]);
    }
    if (keep) {
      for (int i = tid; i < E * E; i += kThreads)
        atts[((((size_t)s.d * T_ + s.t) * B + b) * E + i / E) * E + i % E] = a[i / E][i % E];
    }
  }
  auto m_row = [&](int e, int row) {
    return e < 2 ? m_h + msg_at(s, T_, keep, B * NH, row, e, H)
                 : m_o + msg_at(s, T_, keep, B * NO, row, e, H);
  };
  const size_t slot = slot_of(s, T_, keep);
  const int width = min(kMixColumns, 2 * H - c0);
  for (int i = tid; i < E * width; i += kThreads) {
    const int n = i / width, k = c0 + i % width;
    const bool human = n < NH;
    float v = 0.f;
    if (k < H) {            // from the humans: edge hh (to humans) or ho (to objects)
      for (int m = 0; m < NH; ++m) v = fmaf(a[n][m], m_row(human ? 0 : 1, b * NH + m)[k], v);
    } else {                // from the objects: edge oh (to humans) or oo (to objects)
      for (int o = 0; o < NO; ++o)
        v = fmaf(a[n][NH + o], m_row(human ? 2 : 3, b * NO + o)[k - H], v);
    }
    if (human)
      mix_h[(slot * B * NH + b * NH + n) * 2 * H + k] = from_f32<T>(v);
    else
      mix_o[(slot * B * NO + b * NO + n - NH) * 2 * H + k] = from_f32<T>(v);
  }
}

// Accumulator slots of the cell's product: tiles r, z, n of the input
// operand (mix @ w_msg) add into slots 0, 1, 2, those of the recurrent
// operand (h_prev @ w_hh) into 0, 1 and 3: the n gate keeps its two sides
// apart.
struct CellSlots {
  __host__ __device__ static constexpr int slot(int p, int t) { return p == 1 && t == 2 ? 3 : t; }
};

// B in float32 (bfloat16 IO runs cell_wg).
__global__ void __launch_bounds__(kThreads)
cell_kernel(const float* __restrict__ gi_h, const float* __restrict__ gi_o,
            const float* __restrict__ u_h, const float* __restrict__ u_o,
            const float* __restrict__ mix_h, const float* __restrict__ mix_o,
            const float* __restrict__ w_msg_h, const float* __restrict__ w_msg_o,
            const float* __restrict__ w_hh_h, const float* __restrict__ w_hh_o,
            const float* __restrict__ b_hh_h, const float* __restrict__ b_hh_o,
            const float* __restrict__ h0_h, const float* __restrict__ h0_o,
            float* __restrict__ out_h, float* __restrict__ out_o, float* __restrict__ gates_h,
            float* __restrict__ gates_o, int keep, int T_, int B, int NH, int NO, int H,
            int row_tiles, int step) {
  const Step s = step_of(step, T_);
  const int cell = blockIdx.y / row_tiles;             // 0 humans, 1 objects
  const int row0 = (blockIdx.y % row_tiles) * kMaxRows;
  const int unit0 = blockIdx.x * kMTile;
  const int all_rows = B * (cell == 0 ? NH : NO);
  if (row0 >= all_rows) return;
  const int rows = min(kMaxRows, all_rows - row0);
  const size_t slot = slot_of(s, T_, keep);
  const float* mix = (cell == 0 ? mix_h : mix_o) + (slot * all_rows + row0) * 2 * H;
  const float* w_msg = (cell == 0 ? w_msg_h : w_msg_o) + (size_t)s.d * 2 * H * 3 * H;
  const float* w_hh = (cell == 0 ? w_hh_h : w_hh_o) + (size_t)s.d * H * 3 * H;
  const float* b_hh = (cell == 0 ? b_hh_h : b_hh_o) + (size_t)s.d * 3 * H;
  const float* h_prev = cell == 0 ? prev_state(h0_h, out_h, s, step, T_, all_rows, H)
                                  : prev_state(h0_o, out_o, s, step, T_, all_rows, H);

  extern __shared__ __align__(16) unsigned char smem[];
  float acc[4][kNTiles][4] = {};
  const Operand in = {mix, 2 * H, w_msg, 3 * H, 2 * H};
  const Operand rec = {h_prev + (size_t)row0 * H, H, w_hh, 3 * H, H};
  const int valid = min(kMTile, H - unit0);
  const Tiles tiles = {{unit0, H + unit0, 2 * H + unit0}, {valid, valid, valid}};
  accumulate<false, 3, 4, 2, CellSlots>(in, rec, rec, tiles, rows, smem, acc);
  store_partials<4>(smem, acc);
  __syncthreads();
  float* gates = cell == 0 ? gates_h : gates_o;
  for (int p = threadIdx.x; p < kMTile * kMaxRows; p += kThreads) {
    const int c = p % kMTile, r = p / kMTile;
    const int row = row0 + r, unit = unit0 + c;
    if (r >= rows || unit >= H) continue;
    const float* g =
        (cell == 0 ? gi_h : gi_o) + (((size_t)s.d * T_ + s.t) * all_rows + row) * 3 * H;
    const float rg = sigmoid_f(g[unit] + reduce<4>(smem, 0, c, r) + b_hh[unit]);
    const float zg = sigmoid_f(g[H + unit] + reduce<4>(smem, 1, c, r) + b_hh[H + unit]);
    const float hn = reduce<4>(smem, 3, c, r) + b_hh[2 * H + unit];
    const float ng = tanhf(g[2 * H + unit] + reduce<4>(smem, 2, c, r) + rg * hn);
    const float hp = h_prev[(size_t)row * H + unit];
    const float h_new = (1.f - zg) * ng + zg * hp;
    const float u = (cell == 0 ? u_h : u_o)[(size_t)s.t * all_rows + row];
    const float h = u * h_new + (1.f - u) * hp;
    (cell == 0 ? out_h : out_o)[(((size_t)s.d * T_ + s.t) * all_rows + row) * H + unit] = h;
    if (keep) {
      float* gr = gates + (slot * all_rows + row) * 4 * H + unit;
      gr[0] = rg;
      gr[H] = zg;
      gr[2 * H] = ng;
      gr[3 * H] = hn;
    }
  }
}

// B in bfloat16 on wgmma fed by TMA (wg_gemm.cuh): the same blocks as
// cell_kernel (16 units of one (direction, cell), up to 32 rows). The
// block's M tile takes the r, z and n columns of its units as three
// 16-column pieces of the weights, read MN-major as stored (rows 0-15, 16-31
// and 32-47 of the tile); the input operand (mix @ w_msg) sums into one
// accumulator, the recurrent one (h_prev @ w_hh) into another, so the n
// gate keeps its two sides apart and the epilogue adds the r and z sums.
// Maps per cell: w_msg (2 planes of 2h x 3h), w_hh (2 planes of h x 3h),
// mix (2T planes with keep, else 2), the outputs and h0 as rows.
struct CellMaps {
  CUtensorMap w_msg[2], w_hh[2];
  CUtensorMap mix[2], out[2], h0[2];
};

struct CellPlan {
  const CUtensorMap *w_msg, *w_hh, *mix, *prev;
  wg::Rows rows;
  int d, unit0, mix_plane, prev_plane, H;
  __device__ int chunks_in() const { return cell_in_chunks(H); }
  __device__ int chunks() const { return cell_chunks(H); }
  __device__ int acc(int i) const { return i < chunks_in() ? 0 : 1; }
  __device__ int a_bytes() const { return 3 * wg::kPieceBytes; }
  __device__ int b_bytes() const { return rows.bytes(); }
  __device__ void prefetch() const {
    wg::tma_prefetch(w_msg);
    wg::tma_prefetch(w_hh);
    wg::tma_prefetch(mix);
    wg::tma_prefetch(prev);
  }
  __device__ void issue(int i, uint32_t a, uint32_t b, uint32_t bar) const {
    const int nin = chunks_in();
    const bool in = i < nin;
    const int k0 = (in ? i : i - nin) * wg::kDepth;
    wg::bar_expect(bar, a_bytes() + b_bytes());
    for (int g = 0; g < 3; ++g)
      wg::tma_load(a + g * wg::kPieceBytes, in ? w_msg : w_hh, bar, unit0 + g * H, k0, d);
    rows.load(b, in ? mix : prev, bar, k0, in ? mix_plane : prev_plane);
  }
};

// h_prev for the update is the float32 state in `state`, which the block
// then overwrites with the new state (the bfloat16 outputs would round the
// carried state at every step).
__global__ void __launch_bounds__(wg::kThreads)
cell_wg(const __grid_constant__ CellMaps maps, const bf16* __restrict__ gi_h,
        const bf16* __restrict__ gi_o, const bf16* __restrict__ u_h,
        const bf16* __restrict__ u_o, const bf16* __restrict__ b_hh_h,
        const bf16* __restrict__ b_hh_o, bf16* __restrict__ out_h, bf16* __restrict__ out_o,
        float* __restrict__ state_h, float* __restrict__ state_o, float* __restrict__ gates_h,
        float* __restrict__ gates_o, int keep, int T_, int B, int NH, int NO, int H,
        int row_tiles, int step) {
  const Step s = step_of(step, T_);
  const int cell = blockIdx.y / row_tiles;             // 0 humans, 1 objects
  const int row0 = (blockIdx.y % row_tiles) * kMaxRows;
  const int unit0 = blockIdx.x * kMTile;
  const int all_rows = B * (cell == 0 ? NH : NO);
  if (row0 >= all_rows) return;
  const int rows = min(kMaxRows, all_rows - row0);
  const size_t slot = slot_of(s, T_, keep);
  const CellPlan plan{&maps.w_msg[cell], &maps.w_hh[cell], &maps.mix[cell],
                      step == 0 ? &maps.h0[cell] : &maps.out[cell],
                      {row0, rows, wg::row_box(all_rows)}, s.d, unit0, (int)slot,
                      prev_plane(s, step, T_), H};
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = wg::align1024(smem_raw);
  const bf16* b_hh = (cell == 0 ? b_hh_h : b_hh_o) + (size_t)s.d * 3 * H;
  float* state = (cell == 0 ? state_h : state_o) + (size_t)s.d * all_rows * H;
  float* gates = cell == 0 ? gates_h : gates_o;
  const wg::Ring ring = wg::begin(smem, plan.chunks());
  // The epilogue's inputs (gi, b_hh, the float32 state, u), loaded before
  // the product (after begin's barrier, which would wait for them) so that
  // their latency hides behind the copies: each consumer thread takes kPer
  // of the block's (row, unit) outputs, p = thread + j * kConsumerThreads.
  constexpr int kPer = kMTile * kMaxRows / wg::kConsumerThreads;
  uint16_t in[kPer][7] = {};                 // gi r, z, n; b_hh r, z, n; u (raw bits)
  float hp[kPer] = {};
  if (threadIdx.x < wg::kConsumerThreads) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = threadIdx.x + j * wg::kConsumerThreads, r = p / kMTile;
      const int row = row0 + r, unit = unit0 + p % kMTile;
      if (r < rows && unit < H) {
        const bf16* g =
            (cell == 0 ? gi_h : gi_o) + (((size_t)s.d * T_ + s.t) * all_rows + row) * 3 * H;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          in[j][q] = wg::load_now(g + q * H + unit);
          in[j][3 + q] = wg::load_now(b_hh + q * H + unit);
        }
        in[j][6] = wg::load_now((cell == 0 ? u_h : u_o) + (size_t)s.t * all_rows + row);
        hp[j] = wg::load_now(state + (size_t)row * H + unit);
      }
    }
  }
  float acc[2][16];
  if (!wg::product<2>(plan, ring, acc)) return;
  wg::store_partials<2>(smem, acc);
  const auto sum = [&](int a, int m, int r) { return wg::reduce<2>(smem, a, m, r); };
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = threadIdx.x + j * wg::kConsumerThreads;
    const int c = p % kMTile, r = p / kMTile;
    const int row = row0 + r, unit = unit0 + c;
    if (r >= rows || unit >= H) continue;
    const auto x = [&](int q) { return wg::widen(in[j][q]); };
    const float rg = sigmoid_f(x(0) + (sum(0, c, r) + sum(1, c, r)) + x(3));
    const float zg = sigmoid_f(x(1) + (sum(0, kMTile + c, r) + sum(1, kMTile + c, r)) + x(4));
    const float hn = sum(1, 2 * kMTile + c, r) + x(5);
    const float ng = tanhf(x(2) + sum(0, 2 * kMTile + c, r) + rg * hn);
    const float h_new = (1.f - zg) * ng + zg * hp[j];
    const float u = x(6);
    const float h = u * h_new + (1.f - u) * hp[j];
    (cell == 0 ? out_h : out_o)[(((size_t)s.d * T_ + s.t) * all_rows + row) * H + unit] =
        from_f32<bf16>(h);
    state[(size_t)row * H + unit] = h;
    if (keep) {
      float* gr = gates + (slot * all_rows + row) * 4 * H + unit;
      gr[0] = rg;
      gr[H] = zg;
      gr[2 * H] = ng;
      gr[3 * H] = hn;
    }
  }
}

// The launch shapes of a scan, with the kernels' shared-memory limits set.
struct Launch {
  dim3 grid_a, grid_m, grid_b;
  size_t smem_a, smem_m, smem_b;
  int threads_a, threads_b;
  int row_tiles;
};

// In bfloat16, A runs proj_wg in the modes whose A is the message
// projections alone (dot, ext; v1 adds its projection blocks and v4 has
// proj_v4_kernel, both on tc_gemm.cuh), and B runs cell_wg in every mode.
template <int Mode, class T>
constexpr bool kWgProj = IsBf16<T>::value && (Mode == kDot || Mode == kExt);

// The A kernel of a mode and the B kernel of an IO type.
template <int Mode, class T>
const void* proj_of() {
  if constexpr (kWgProj<Mode, T>)
    return reinterpret_cast<const void*>(proj_wg);
  else if constexpr (Mode == kV4)
    return reinterpret_cast<const void*>(proj_v4_kernel<T>);
  else
    return reinterpret_cast<const void*>(proj_kernel<Mode, T>);
}

template <class T>
const void* cell_of() {
  if constexpr (IsBf16<T>::value)
    return reinterpret_cast<const void*>(cell_wg);
  else
    return reinterpret_cast<const void*>(cell_kernel);
}

template <int Mode, class T>
cudaError_t configure(int B, int NH, int NO, int H, Launch& L) {
  const size_t states_bytes = (size_t)(NH + NO) * H * sizeof(float);
  constexpr size_t v4_epilogue = sizeof(Partials<4>) + kTmpBytes + kSendBytes;
  constexpr size_t v4_smem = smem_bytes<false, 4, 4, kStages, T, T>() > v4_epilogue
                                 ? smem_bytes<false, 4, 4, kStages, T, T>()
                                 : v4_epilogue;
  L.smem_a = kWgProj<Mode, T> ? wg::smem_bytes(wg::ring_stages(proj_chunks(H)))
             : Mode == kV4    ? v4_smem
                              : smem_bytes<false, 2, 2, kStages, T, T>();
  L.threads_a = kWgProj<Mode, T> ? wg::kThreads : kThreads;
  const int E = NH + NO, col_pairs = (H + 2 * kMTile - 1) / (2 * kMTile);
  L.smem_m = Mode == kDot ? states_bytes
             : Mode == kV1 ? (size_t)E * 4 * sizeof(float)
             : Mode == kV4 ? (size_t)E * E * col_pairs * sizeof(float) : 0;
  L.smem_b = IsBf16<T>::value ? wg::smem_bytes(wg::ring_stages(cell_chunks(H)))
                              : smem_bytes<false, 3, 4, kStages, T, T>();
  L.threads_b = IsBf16<T>::value ? wg::kThreads : kThreads;
  const int max_rows = B * (NH > NO ? NH : NO);
  L.row_tiles = (max_rows + kMaxRows - 1) / kMaxRows;
  const int col_tiles = (H + kMTile - 1) / kMTile;
  // v1: the message blocks flat in x, then one projection block per group.
  L.grid_a = Mode == kV1 ? dim3(col_pairs * 4 * L.row_tiles + 2, 1, 2)
                         : dim3(col_pairs, 4 * L.row_tiles, 2);
  L.grid_m = dim3(B, (2 * H + kMixColumns - 1) / kMixColumns, 2);
  L.grid_b = dim3(col_tiles, 2 * L.row_tiles, 2);
  cudaError_t err = cudaFuncSetAttribute(proj_of<Mode, T>(),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.smem_a);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cell_of<T>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L.smem_b);
  return err;
}

// The tensor maps of proj_wg and cell_wg for one call (the pointers are the
// call's; a CUDA graph that captures the launches keeps them by value).
cudaError_t scan_maps(const bf16* w_from, const bf16* w_msg_h, const bf16* w_msg_o,
                      const bf16* w_hh_h, const bf16* w_hh_o, const bf16* h0_h,
                      const bf16* h0_o, const bf16* out_h, const bf16* out_o, const bf16* mix_h,
                      const bf16* mix_o, int keep, int T_, int B, int NH, int NO, int H,
                      ProjMaps& pm, CellMaps& cm) {
  const int rows[2] = {B * NH, B * NO};
  const bf16* h0[2] = {h0_h, h0_o};
  const bf16* out[2] = {out_h, out_o};
  const bf16* mix[2] = {mix_h, mix_o};
  const bf16* w_msg[2] = {w_msg_h, w_msg_o};
  const bf16* w_hh[2] = {w_hh_h, w_hh_o};
  cudaError_t err = wg::mn_major_map(&pm.w, w_from, 4, H, H);
  for (int g = 0; g < 2 && err == cudaSuccess; ++g) {
    err = wg::rows_map(&pm.out[g], out[g], 2 * T_, rows[g], H, H);
    if (err == cudaSuccess) err = wg::rows_map(&pm.h0[g], h0[g], 2, rows[g], H, H);
    if (err == cudaSuccess) err = wg::mn_major_map(&cm.w_msg[g], w_msg[g], 2, 2 * H, 3 * H);
    if (err == cudaSuccess) err = wg::mn_major_map(&cm.w_hh[g], w_hh[g], 2, H, 3 * H);
    if (err == cudaSuccess)
      err = wg::rows_map(&cm.mix[g], mix[g], keep ? 2 * T_ : 2, rows[g], 2 * H, 2 * H);
    cm.out[g] = pm.out[g];
    cm.h0[g] = pm.h0[g];
  }
  return err;
}

// Runs the whole scan, both directions: per step the launches A, M, B on
// `stream`, in order. Returns the first CUDA error of a launch, else 0.
// With bfloat16 IO, state_h and state_o hold the float32 states (h0 at the
// call). scores: v1's proj (2, B, E, 4) or v4's part (2, B, E, E, h / 32).
template <int Mode, class T>
int run_scan(const T* gi_h, const T* gi_o, const T* u_h, const T* u_o, const T* w_from,
             const T* b_from, const T* w_msg_h, const T* w_msg_o, const T* w_hh_h,
             const T* w_hh_o, const T* b_hh_h, const T* b_hh_o, const T* obj_mask,
             const T* h0_h, const T* h0_o, const T* w_att, const T* b_att,
             const T* att_ext, T* out_h, T* out_o, T* att, float* m_h, float* m_o,
             float* scores, T* mix_h, T* mix_o, float* gates_h, float* gates_o,
             float* atts, float* state_h, float* state_o, int keep, int T_, int B, int NH,
             int NO, int H, float scale, cudaStream_t stream) {
  const size_t states_bytes = (size_t)(NH + NO) * H * sizeof(float);
  if (NH + NO > kMaxEntities || H % (16 / (int)sizeof(T)) != 0 || states_bytes > 48 * 1024 ||
      (IsBf16<T>::value && (state_h == nullptr || state_o == nullptr)) ||
      ((Mode == kV1 || Mode == kV4) && scores == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch L;
  cudaError_t err = configure<Mode, T>(B, NH, NO, H, L);
  if (err != cudaSuccess) return static_cast<int>(err);
  ProjMaps pmaps;
  CellMaps cmaps;
  if constexpr (IsBf16<T>::value) {
    err = scan_maps(w_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o, h0_h, h0_o, out_h, out_o, mix_h,
                    mix_o, keep, T_, B, NH, NO, H, pmaps, cmaps);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int step = 0; step < T_; ++step) {
    if constexpr (kWgProj<Mode, T>)
      proj_wg<<<L.grid_a, L.threads_a, L.smem_a, stream>>>(pmaps, b_from, m_h, m_o, keep, T_,
                                                           B, NH, NO, H, L.row_tiles, step);
    else if constexpr (Mode == kV4)
      proj_v4_kernel<T><<<L.grid_a, L.threads_a, L.smem_a, stream>>>(
          h0_h, h0_o, out_h, out_o, state_h, state_o, w_from, b_from, m_h, m_o, w_att, scores,
          T_, B, NH, NO, H, L.row_tiles, step);
    else
      proj_kernel<Mode, T><<<L.grid_a, L.threads_a, L.smem_a, stream>>>(
          h0_h, h0_o, out_h, out_o, w_from, b_from, m_h, m_o, w_att, scores, keep, T_, B, NH,
          NO, H, L.row_tiles, step);
    mix_kernel<Mode, T><<<L.grid_m, kThreads, L.smem_m, stream>>>(
        h0_h, h0_o, out_h, out_o, state_h, state_o, obj_mask, m_h, m_o, b_att, scores, att_ext,
        mix_h, mix_o, att, atts, keep, T_, B, NH, NO, H, scale, step);
    if constexpr (IsBf16<T>::value)
      cell_wg<<<L.grid_b, L.threads_b, L.smem_b, stream>>>(
          cmaps, gi_h, gi_o, u_h, u_o, b_hh_h, b_hh_o, out_h, out_o, state_h, state_o, gates_h,
          gates_o, keep, T_, B, NH, NO, H, L.row_tiles, step);
    else
      cell_kernel<<<L.grid_b, L.threads_b, L.smem_b, stream>>>(
          gi_h, gi_o, u_h, u_o, mix_h, mix_o, w_msg_h, w_msg_o, w_hh_h, w_hh_o, b_hh_h, b_hh_o,
          h0_h, h0_o, out_h, out_o, gates_h, gates_o, keep, T_, B, NH, NO, H, L.row_tiles,
          step);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The phases' launch shapes and resident blocks an SM: out[0..2] the
// blocks of A, M and B, out[3..5] their blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[6..8] their dynamic
// shared memory in bytes.
template <int Mode, class T>
int occupancy(int B, int NH, int NO, int H, int* out) {
  Launch L;
  cudaError_t err = configure<Mode, T>(B, NH, NO, H, L);
  const dim3 grids[3] = {L.grid_a, L.grid_m, L.grid_b};
  const size_t smem[3] = {L.smem_a, L.smem_m, L.smem_b};
  const int threads[3] = {L.threads_a, kThreads, L.threads_b};
  const void* kernels[3] = {proj_of<Mode, T>(), reinterpret_cast<const void*>(mix_kernel<Mode, T>),
                            cell_of<T>()};
  for (int i = 0; i < 3 && err == cudaSuccess; ++i) {
    out[i] = (int)(grids[i].x * grids[i].y * grids[i].z);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3 + i], kernels[i], threads[i],
                                                        smem[i]);
    out[6 + i] = (int)smem[i];
  }
  return static_cast<int>(err);
}

}  // namespace

// K3: the scan in 'dot' mode. With keep = 1, m_h, m_o (2, T, B * NH or NO,
// 2H), mix_h, mix_o (the same shapes), gates_h, gates_o (2, T, B * NH or NO,
// 4H: r, z, n, hn) and atts (2, T, B, E, E) keep every step's; with keep =
// 0, m and mix hold one step per direction (2, B * NH or NO, 2H) and gates
// and atts may be null. H % 4 == 0, NH + NO <= 16 and (NH + NO) * H * 4
// bytes <= 48 KB.
extern "C" int tggcn_segment_scan_dot_f32(
    const float* gi_h, const float* gi_o, const float* u_h, const float* u_o,
    const float* w_from, const float* b_from, const float* w_msg_h,
    const float* w_msg_o, const float* w_hh_h, const float* w_hh_o,
    const float* b_hh_h, const float* b_hh_o, const float* obj_mask,
    const float* h0_h, const float* h0_o, float* out_h, float* out_o,
    float* att, float* m_h, float* m_o, float* mix_h, float* mix_o, float* gates_h,
    float* gates_o, float* atts, int keep, int T, int B, int NH, int NO, int H, float scale,
    void* stream_ptr) {
  return run_scan<kDot, float>(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h,
                               w_hh_o, b_hh_h, b_hh_o, obj_mask, h0_h, h0_o, nullptr, nullptr,
                               nullptr, out_h, out_o, att, m_h, m_o, nullptr, mix_h, mix_o,
                               gates_h, gates_o, atts, nullptr, nullptr, keep, T, B, NH,
                               NO, H, scale, static_cast<cudaStream_t>(stream_ptr));
}

// K3 in bfloat16 IO: every pointer of tggcn_segment_scan_dot_f32 but m_h,
// m_o, gates and atts (float32) in bfloat16, and state_h, state_o (2, B *
// NH or NO, H) float32 holding h0 at the call. H % 8 == 0.
extern "C" int tggcn_segment_scan_dot_bf16(
    const bf16* gi_h, const bf16* gi_o, const bf16* u_h, const bf16* u_o,
    const bf16* w_from, const bf16* b_from, const bf16* w_msg_h, const bf16* w_msg_o,
    const bf16* w_hh_h, const bf16* w_hh_o, const bf16* b_hh_h, const bf16* b_hh_o,
    const bf16* obj_mask, const bf16* h0_h, const bf16* h0_o, bf16* out_h, bf16* out_o,
    bf16* att, float* m_h, float* m_o, bf16* mix_h, bf16* mix_o, float* gates_h,
    float* gates_o, float* atts, float* state_h, float* state_o, int keep, int T, int B,
    int NH, int NO, int H, float scale, void* stream_ptr) {
  return run_scan<kDot, bf16>(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h,
                              w_hh_o, b_hh_h, b_hh_o, obj_mask, h0_h, h0_o, nullptr, nullptr,
                              nullptr, out_h, out_o, att, m_h, m_o, nullptr, mix_h, mix_o,
                              gates_h, gates_o, atts, state_h, state_o, keep, T, B, NH,
                              NO, H, scale, static_cast<cudaStream_t>(stream_ptr));
}

// K5: the scan in mode 1 'v1' (w_att (4, 2H), b_att (4); scores, the
// projections, (2, B, E, 4) scratch), 2 'v4' (w_att (4, H, H), b_att (4);
// scores, the partial scores, (2, B, E, E, ceil(H / 32)) scratch) or 3
// 'ext' (att_ext (T, B, E, E), E = NH + NO: row n < NH holds
// [a_hh | a_oh] of human n, row NH + o [a_ho | a_oo] of object o). m_h, m_o,
// mix_h and mix_o hold one step's, (2, B * NH or NO, 2H). Unused pointers
// may be null. The limits are K3's.
extern "C" int tggcn_segment_scan_att_f32(
    int mode, const float* gi_h, const float* gi_o, const float* u_h, const float* u_o,
    const float* w_from, const float* b_from, const float* w_msg_h,
    const float* w_msg_o, const float* w_hh_h, const float* w_hh_o,
    const float* b_hh_h, const float* b_hh_o, const float* obj_mask,
    const float* h0_h, const float* h0_o, const float* w_att, const float* b_att,
    const float* att_ext, float* out_h, float* out_o, float* att, float* m_h, float* m_o,
    float* scores, float* mix_h, float* mix_o, int T, int B, int NH, int NO, int H,
    void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define TGGCN_RUN_SCAN(M)                                                                 \
  run_scan<M, float>(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o, \
                     b_hh_h, b_hh_o, obj_mask, h0_h, h0_o, w_att, b_att, att_ext, out_h,     \
                     out_o, att, m_h, m_o, scores, mix_h, mix_o, nullptr, nullptr, nullptr,  \
                     nullptr, nullptr, 0, T, B, NH, NO, H, 1.f, stream)
  switch (mode) {
    case kV1: return TGGCN_RUN_SCAN(kV1);
    case kV4: return TGGCN_RUN_SCAN(kV4);
    case kExt: return TGGCN_RUN_SCAN(kExt);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TGGCN_RUN_SCAN
}

// K5 in bfloat16 IO: every pointer of tggcn_segment_scan_att_f32 but m_h,
// m_o and scores (float32) in bfloat16, and state_h, state_o (2, B *
// NH or NO, H) float32 holding h0 at the call, as K3 in bfloat16. H % 8 == 0.
extern "C" int tggcn_segment_scan_att_bf16(
    int mode, const bf16* gi_h, const bf16* gi_o, const bf16* u_h, const bf16* u_o,
    const bf16* w_from, const bf16* b_from, const bf16* w_msg_h, const bf16* w_msg_o,
    const bf16* w_hh_h, const bf16* w_hh_o, const bf16* b_hh_h, const bf16* b_hh_o,
    const bf16* obj_mask, const bf16* h0_h, const bf16* h0_o, const bf16* w_att,
    const bf16* b_att, const bf16* att_ext, bf16* out_h, bf16* out_o, bf16* att, float* m_h,
    float* m_o, float* scores, bf16* mix_h, bf16* mix_o, float* state_h,
    float* state_o, int T, int B, int NH, int NO, int H, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define TGGCN_RUN_SCAN(M)                                                                 \
  run_scan<M, bf16>(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o, \
                    b_hh_h, b_hh_o, obj_mask, h0_h, h0_o, w_att, b_att, att_ext, out_h,     \
                    out_o, att, m_h, m_o, scores, mix_h, mix_o, nullptr, nullptr, nullptr,  \
                    state_h, state_o, 0, T, B, NH, NO, H, 1.f, stream)
  switch (mode) {
    case kV1: return TGGCN_RUN_SCAN(kV1);
    case kV4: return TGGCN_RUN_SCAN(kV4);
    case kExt: return TGGCN_RUN_SCAN(kExt);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TGGCN_RUN_SCAN
}

// The launch shapes of the scan in `mode` (0 'dot', 1 'v1', 2 'v4', 3
// 'ext'; bf16 != 0 for the bfloat16 variant) at (B, NH, NO, H): out[0..2]
// the blocks of phases A, M and B, out[3..5] the blocks of each that an SM
// holds at once, out[6..8] their dynamic shared memory in bytes. Returns
// the CUDA error of the query, else 0.
extern "C" int tggcn_segment_scan_occupancy(int mode, int bf16_io, int B, int NH, int NO,
                                            int H, int* out) {
#define TGGCN_OCCUPANCY(M) \
  (bf16_io ? occupancy<M, bf16>(B, NH, NO, H, out) : occupancy<M, float>(B, NH, NO, H, out))
  switch (mode) {
    case kDot: return TGGCN_OCCUPANCY(kDot);
    case kV1: return TGGCN_OCCUPANCY(kV1);
    case kV4: return TGGCN_OCCUPANCY(kV4);
    case kExt: return TGGCN_OCCUPANCY(kExt);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TGGCN_OCCUPANCY
}
