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
// each weight is read once per step.
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
// 'dot' instantiation is K3 as above):
//   v1   M scores relu(recv . wa[e][:h] + send . wa[e][h:] + b_att[e]): four
//        dot products per entity over the carried states in shared memory.
//   v4   A also computes tmp_e = recv @ W_e for the two score edges of each
//        receiver (96 more rows of depth h at the MPHOI shape); M scores
//        relu(tmp_e . send + b_att[e]).
//   ext  M reads step t of the weights computed outside (mean pooling or
//        inverse distances), already softmaxed, and scores nothing.
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
// products are bfloat16 x bfloat16 with float32 sums (tc_gemm.cuh, m16n8k16)
// on the activations rounded as the TPU kernel's astype(wdt) rounds them:
// the states (the bfloat16 outputs of the step before, or h0) and the mixed
// messages, which M writes in bfloat16. M's scores, softmax and mixing take
// the float32 states and edge messages; the kept m, gates and attention are
// float32, the kept mix the bfloat16 the product read. Bound: the same
// 92 GFLOP at the dense bfloat16 rate (989 TFLOP/s), 0.09 ms, and the
// scores and mixing on the FMA units; the weights are half the bytes.
// K5 in bfloat16 rounds each mode's scores where the TPU kernel does
// (scores_v1 :123, scores_v4 :134, :147-149): v1 takes the float32 states
// rounded to bfloat16 against the bfloat16 w_att; v4's A phase takes the
// bfloat16 states (the outputs of the step before) against W_att, and M
// rounds that product's float32 sum to bfloat16 and multiplies it by the
// float32 sender state in float32 (JAX promotes the bfloat16 x float32
// product); ext widens the bfloat16 weights computed outside.

#include "tc_gemm.cuh"

namespace {

using namespace tggcn::tc;

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

// Blocks own 32 columns of one (direction, edge) and up to 32 rows: edges
// 0-3 are the messages (hh, ho, oh, oo); in v4, edges 4-7 are tmp = recv @
// W_att of the score edges hh, oh (receivers humans, into tmp_h) and ho, oo
// (receivers objects, into tmp_o), laid out (2, rows, sender group, h).
template <int Mode, class T>
__global__ void __launch_bounds__(kThreads)
proj_kernel(const T* __restrict__ h0_h, const T* __restrict__ h0_o,
            const T* __restrict__ out_h, const T* __restrict__ out_o,
            const T* __restrict__ w_from, const T* __restrict__ b_from,
            float* __restrict__ m_h, float* __restrict__ m_o,
            const T* __restrict__ w_att, float* __restrict__ tmp_h,
            float* __restrict__ tmp_o, int keep, int T_, int B, int NH, int NO,
            int H, int row_tiles, int step) {
  const Step s = step_of(step, T_);
  const int e = blockIdx.y / row_tiles;
  const int row0 = (blockIdx.y % row_tiles) * kMaxRows;
  const int col0 = blockIdx.x * 2 * kMTile;
  const int group = (e < 4 ? e : e - 4) < 2 ? 0 : 1;          // the source: humans, objects
  const int all_rows = B * (group == 0 ? NH : NO);
  if (row0 >= all_rows) return;
  const int rows = min(kMaxRows, all_rows - row0);
  const T* x = (group == 0 ? prev_state(h0_h, out_h, s, step, T_, all_rows, H)
                           : prev_state(h0_o, out_o, s, step, T_, all_rows, H))
               + (size_t)row0 * H;
  const T* w = e < 4 ? w_from + (size_t)e * H * H : w_att + (size_t)(e - 4) * H * H;
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
    if (e < 4) {
      (e < 2 ? m_h : m_o)[msg_at(s, T_, keep, all_rows, row, e, H) + col] =
          fmaxf(v + to_f32(b_from[(size_t)e * H + col]), 0.f);
    } else {
      (group == 0 ? tmp_h : tmp_o)[(((size_t)s.d * all_rows + row) * 2 + (e & 1)) * H + col] = v;
    }
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Per (batch, column slice, direction): the scores of the mode, the masked
// softmax (ext: the weights as given), att_oh (and, with keep, the whole
// E x E attention) and the mixed messages (in T).
// Dynamic shared memory: the (NH + NO) carried states of the block's batch,
// float32 (with bfloat16 IO, from state_h and state_o).
template <int Mode, class T>
__global__ void __launch_bounds__(kThreads)
mix_kernel(const T* __restrict__ h0_h, const T* __restrict__ h0_o,
           const T* __restrict__ out_h, const T* __restrict__ out_o,
           const float* __restrict__ state_h, const float* __restrict__ state_o,
           const T* __restrict__ obj_mask, const float* __restrict__ m_h,
           const float* __restrict__ m_o, const T* __restrict__ w_att,
           const T* __restrict__ b_att, const float* __restrict__ tmp_h,
           const float* __restrict__ tmp_o, const T* __restrict__ att_ext,
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
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if constexpr (Mode != kExt) {
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
  } else if constexpr (Mode == kV1) {
    // proj[n][g]: n as the receiver of senders of group g (0 humans, 1
    // objects), the first half of wa; proj[n][2 + g]: n as the sender to
    // receivers of group g, the second half. Score edge = 2 g_recv + g_send.
    __shared__ float proj[kMaxEntities][4];
    for (int p = warp; p < 4 * E; p += kWarps) {
      const int n = p / 4, j = p % 4, gn = n < NH ? 0 : 1;
      const T* w = j < 2 ? w_att + (size_t)(2 * gn + j) * 2 * H
                         : w_att + (size_t)(2 * (j - 2) + gn) * 2 * H + H;
      float dot = 0.f;
      for (int k = lane; k < H; k += 32)
        dot = fmaf(round_to<T>(states[n * H + k]), to_f32(w[k]), dot);
      dot = warp_sum(dot);
      if (lane == 0) proj[n][j] = dot;
    }
    __syncthreads();
    for (int i = tid; i < E * E; i += kThreads) {
      const int n = i / E, m = i % E, gn = n < NH ? 0 : 1, gm = m < NH ? 0 : 1;
      a[n][m] = fmaxf(proj[n][gm] + proj[m][2 + gn] + to_f32(b_att[2 * gn + gm]), 0.f);
    }
  } else if constexpr (Mode == kV4) {
    for (int p = warp; p < E * E; p += kWarps) {
      const int n = p / E, m = p % E, gn = n < NH ? 0 : 1, gm = m < NH ? 0 : 1;
      const float* tr = gn == 0
          ? tmp_h + (((size_t)s.d * B * NH + b * NH + n) * 2 + gm) * H
          : tmp_o + (((size_t)s.d * B * NO + b * NO + n - NH) * 2 + gm) * H;
      float dot = 0.f;
      for (int k = lane; k < H; k += 32) dot = fmaf(round_to<T>(tr[k]), states[m * H + k], dot);
      dot = warp_sum(dot);
      if (lane == 0) a[n][m] = fmaxf(dot + to_f32(b_att[2 * gn + gm]), 0.f);
    }
  } else {
    for (int i = tid; i < E * E; i += kThreads)
      a[i / E][i % E] = to_f32(att_ext[(((size_t)s.t * B + b) * E + i / E) * E + i % E]);
  }
  __syncthreads();
  const T* om = obj_mask + (size_t)b * NO;
  if (Mode != kExt && tid < E) {
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

// With bfloat16 IO, h_prev for the product is the bfloat16 state (the
// output of the step before, or h0), and for the update the float32 state
// in `state`, which the block then overwrites with the new state.
template <class T>
__global__ void __launch_bounds__(kThreads)
cell_kernel(const T* __restrict__ gi_h, const T* __restrict__ gi_o,
            const T* __restrict__ u_h, const T* __restrict__ u_o,
            const T* __restrict__ mix_h, const T* __restrict__ mix_o,
            const T* __restrict__ w_msg_h, const T* __restrict__ w_msg_o,
            const T* __restrict__ w_hh_h, const T* __restrict__ w_hh_o,
            const T* __restrict__ b_hh_h, const T* __restrict__ b_hh_o,
            const T* __restrict__ h0_h, const T* __restrict__ h0_o,
            T* __restrict__ out_h, T* __restrict__ out_o, float* __restrict__ state_h,
            float* __restrict__ state_o, float* __restrict__ gates_h,
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
  const T* mix = (cell == 0 ? mix_h : mix_o) + (slot * all_rows + row0) * 2 * H;
  const T* w_msg = (cell == 0 ? w_msg_h : w_msg_o) + (size_t)s.d * 2 * H * 3 * H;
  const T* w_hh = (cell == 0 ? w_hh_h : w_hh_o) + (size_t)s.d * H * 3 * H;
  const T* b_hh = (cell == 0 ? b_hh_h : b_hh_o) + (size_t)s.d * 3 * H;
  const T* h_prev = cell == 0 ? prev_state(h0_h, out_h, s, step, T_, all_rows, H)
                              : prev_state(h0_o, out_o, s, step, T_, all_rows, H);
  float* state = nullptr;
  if constexpr (IsBf16<T>::value)
    state = (cell == 0 ? state_h : state_o) + (size_t)s.d * all_rows * H;

  extern __shared__ __align__(16) unsigned char smem[];
  float acc[4][kNTiles][4] = {};
  const OperandT<T, T> in = {mix, 2 * H, w_msg, 3 * H, 2 * H};
  const OperandT<T, T> rec = {h_prev + (size_t)row0 * H, H, w_hh, 3 * H, H};
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
    const T* g = (cell == 0 ? gi_h : gi_o) + (((size_t)s.d * T_ + s.t) * all_rows + row) * 3 * H;
    const float rg = sigmoid_f(to_f32(g[unit]) + reduce<4>(smem, 0, c, r) + to_f32(b_hh[unit]));
    const float zg =
        sigmoid_f(to_f32(g[H + unit]) + reduce<4>(smem, 1, c, r) + to_f32(b_hh[H + unit]));
    const float hn = reduce<4>(smem, 3, c, r) + to_f32(b_hh[2 * H + unit]);
    const float ng = tanhf(to_f32(g[2 * H + unit]) + reduce<4>(smem, 2, c, r) + rg * hn);
    float hp;
    if constexpr (IsBf16<T>::value)
      hp = state[(size_t)row * H + unit];
    else
      hp = h_prev[(size_t)row * H + unit];
    const float h_new = (1.f - zg) * ng + zg * hp;
    const float u = to_f32((cell == 0 ? u_h : u_o)[(size_t)s.t * all_rows + row]);
    const float h = u * h_new + (1.f - u) * hp;
    T* out = cell == 0 ? out_h : out_o;
    out[(((size_t)s.d * T_ + s.t) * all_rows + row) * H + unit] = from_f32<T>(h);
    if constexpr (IsBf16<T>::value) state[(size_t)row * H + unit] = h;
    if (keep) {
      float* gr = gates + (slot * all_rows + row) * 4 * H + unit;
      gr[0] = rg;
      gr[H] = zg;
      gr[2 * H] = ng;
      gr[3 * H] = hn;
    }
  }
}

// Runs the whole scan, both directions: per step the launches A, M, B on
// `stream`, in order. Returns the first CUDA error of a launch, else 0.
// With bfloat16 IO, state_h and state_o hold the float32 states (h0 at the
// call).
template <int Mode, class T>
int run_scan(const T* gi_h, const T* gi_o, const T* u_h, const T* u_o, const T* w_from,
             const T* b_from, const T* w_msg_h, const T* w_msg_o, const T* w_hh_h,
             const T* w_hh_o, const T* b_hh_h, const T* b_hh_o, const T* obj_mask,
             const T* h0_h, const T* h0_o, const T* w_att, const T* b_att,
             const T* att_ext, T* out_h, T* out_o, T* att, float* m_h, float* m_o,
             float* tmp_h, float* tmp_o, T* mix_h, T* mix_o, float* gates_h, float* gates_o,
             float* atts, float* state_h, float* state_o, int keep, int T_, int B, int NH,
             int NO, int H, float scale, cudaStream_t stream) {
  const size_t states_bytes = (size_t)(NH + NO) * H * sizeof(float);
  if (NH + NO > kMaxEntities || H % (16 / (int)sizeof(T)) != 0 || states_bytes > 48 * 1024 ||
      (IsBf16<T>::value && (state_h == nullptr || state_o == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_a = smem_bytes<false, 2, 2, kStages, T, T>();
  const size_t smem_b = smem_bytes<false, 3, 4, kStages, T, T>();
  cudaError_t err = cudaFuncSetAttribute(proj_kernel<Mode, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cell_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int max_rows = B * (NH > NO ? NH : NO);
  const int row_tiles = (max_rows + kMaxRows - 1) / kMaxRows;
  const int col_tiles = (H + kMTile - 1) / kMTile;
  const dim3 grid_a((H + 2 * kMTile - 1) / (2 * kMTile), (Mode == kV4 ? 8 : 4) * row_tiles, 2);
  const dim3 grid_m(B, (2 * H + kMixColumns - 1) / kMixColumns, 2);
  const dim3 grid_b(col_tiles, 2 * row_tiles, 2);
  for (int step = 0; step < T_; ++step) {
    proj_kernel<Mode, T><<<grid_a, kThreads, smem_a, stream>>>(
        h0_h, h0_o, out_h, out_o, w_from, b_from, m_h, m_o, w_att, tmp_h, tmp_o, keep, T_, B,
        NH, NO, H, row_tiles, step);
    mix_kernel<Mode, T><<<grid_m, kThreads, states_bytes, stream>>>(
        h0_h, h0_o, out_h, out_o, state_h, state_o, obj_mask, m_h, m_o, w_att, b_att, tmp_h,
        tmp_o, att_ext, mix_h, mix_o, att, atts, keep, T_, B, NH, NO, H, scale, step);
    cell_kernel<T><<<grid_b, kThreads, smem_b, stream>>>(
        gi_h, gi_o, u_h, u_o, mix_h, mix_o, w_msg_h, w_msg_o, w_hh_h, w_hh_o, b_hh_h, b_hh_o,
        h0_h, h0_o, out_h, out_o, state_h, state_o, gates_h, gates_o, keep, T_, B, NH, NO, H,
        row_tiles, step);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
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
                               nullptr, out_h, out_o, att, m_h, m_o, nullptr, nullptr, mix_h,
                               mix_o, gates_h, gates_o, atts, nullptr, nullptr, keep, T, B, NH,
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
                              nullptr, out_h, out_o, att, m_h, m_o, nullptr, nullptr, mix_h,
                              mix_o, gates_h, gates_o, atts, state_h, state_o, keep, T, B, NH,
                              NO, H, scale, static_cast<cudaStream_t>(stream_ptr));
}

// K5: the scan in mode 1 'v1' (w_att (4, 2H), b_att (4)), 2 'v4' (w_att
// (4, H, H), b_att (4); tmp_h (2, B * NH, 2, H) and tmp_o (2, B * NO, 2, H)
// scratch) or 3 'ext' (att_ext (T, B, E, E), E = NH + NO: row n < NH holds
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
    float* tmp_h, float* tmp_o, float* mix_h, float* mix_o, int T, int B, int NH, int NO,
    int H, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define TGGCN_RUN_SCAN(M)                                                                 \
  run_scan<M, float>(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o, \
                     b_hh_h, b_hh_o, obj_mask, h0_h, h0_o, w_att, b_att, att_ext, out_h,     \
                     out_o, att, m_h, m_o, tmp_h, tmp_o, mix_h, mix_o, nullptr, nullptr,     \
                     nullptr, nullptr, nullptr, 0, T, B, NH, NO, H, 1.f, stream)
  switch (mode) {
    case kV1: return TGGCN_RUN_SCAN(kV1);
    case kV4: return TGGCN_RUN_SCAN(kV4);
    case kExt: return TGGCN_RUN_SCAN(kExt);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TGGCN_RUN_SCAN
}

// K5 in bfloat16 IO: every pointer of tggcn_segment_scan_att_f32 but m_h,
// m_o, tmp_h and tmp_o (float32) in bfloat16, and state_h, state_o (2, B *
// NH or NO, H) float32 holding h0 at the call, as K3 in bfloat16. H % 8 == 0.
extern "C" int tggcn_segment_scan_att_bf16(
    int mode, const bf16* gi_h, const bf16* gi_o, const bf16* u_h, const bf16* u_o,
    const bf16* w_from, const bf16* b_from, const bf16* w_msg_h, const bf16* w_msg_o,
    const bf16* w_hh_h, const bf16* w_hh_o, const bf16* b_hh_h, const bf16* b_hh_o,
    const bf16* obj_mask, const bf16* h0_h, const bf16* h0_o, const bf16* w_att,
    const bf16* b_att, const bf16* att_ext, bf16* out_h, bf16* out_o, bf16* att, float* m_h,
    float* m_o, float* tmp_h, float* tmp_o, bf16* mix_h, bf16* mix_o, float* state_h,
    float* state_o, int T, int B, int NH, int NO, int H, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define TGGCN_RUN_SCAN(M)                                                                 \
  run_scan<M, bf16>(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o, \
                    b_hh_h, b_hh_o, obj_mask, h0_h, h0_o, w_att, b_att, att_ext, out_h,     \
                    out_o, att, m_h, m_o, tmp_h, tmp_o, mix_h, mix_o, nullptr, nullptr,     \
                    nullptr, state_h, state_o, 0, T, B, NH, NO, H, 1.f, stream)
  switch (mode) {
    case kV1: return TGGCN_RUN_SCAN(kV1);
    case kV4: return TGGCN_RUN_SCAN(kV4);
    case kExt: return TGGCN_RUN_SCAN(kExt);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TGGCN_RUN_SCAN
}
