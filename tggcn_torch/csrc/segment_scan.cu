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
//             blocks own 32 rows x 16 columns of one (direction, edge). The
//             messages of every step are kept (m_h = [hh | ho] per human,
//             m_o = [oh | oo] per object): the backward (K4) takes them as
//             they were, instead of recomputing them on the far side of a
//             ReLU kink.
//   M  mix:   per (batch, direction, column slice): scaled dot scores
//             between the carried states, the masked softmax over senders
//             (1 - eye on h2h, the object mask on o2h, both on o2o, finite
//             fill so a fully masked row gives zeros), att_oh out, and the
//             attention-weighted messages mix_h = [a_hh m_hh, a_oh m_oh],
//             mix_o = [a_ho m_ho, a_oo m_oo].
//   B  cell:  gi = gi_base + mix @ w_msg, gh = h_prev @ w_hh + b_hh, GRU
//             gates r, z, n, h_new = (1 - z) n + z h_prev, and the commit
//             h = u h_new + (1 - u) h_prev; blocks own 32 rows x 16 hidden
//             units of one (direction, cell).
// A and B use the pipelined, register-tiled product of tile_gemm.cuh, so
// each weight is read once per step while there are at most 32 rows.
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
// forward only, so it keeps no per-step messages: each step's sit in one
// buffer per direction.
//
// Bound on an H100: float32 FMAs. Per step and direction at the MPHOI shape
// (B=8, H=2, O=4, h=512) the matmuls do 2*(96*h*h + 48*3h*3h) = 277 MFLOP
// (four projections over 16+16+32+32 rows; 48 cell rows of depth 3h), so
// 92 GFLOP for both directions over T=167, against 67 TFLOP/s.
// The weights (40 MB for both directions) stay in the 50 MB L2 and are read
// from it every step; HBM has to carry only gi in and the states out. v1 and
// ext do about the same work; v4 adds 2 * 96 * h * h * 2 * T = 17 GFLOP.

#include "tile_gemm.cuh"

namespace {

using namespace tggcn;

constexpr int kMaxEntities = 16;
constexpr int kMixColumns = 128;   // mix columns (of 2h) per mix block
constexpr int kWarps = kThreads / 32;

// Attention modes: the codes of tggcn_segment_scan_att_f32's `mode`.
constexpr int kDot = 0, kV1 = 1, kV4 = 2, kExt = 3;

struct Step {
  int d, t;   // direction and the time it processes at this step
};

__device__ __forceinline__ Step step_of(int step, int T) {
  const int d = blockIdx.z;
  return {d, d == 0 ? step : T - 1 - step};
}

// The states this step reads: h0 at the first step, else the previous
// step's output of the same direction. rows = B * entities.
__device__ __forceinline__ const float* prev_state(const float* h0, const float* out,
                                                   Step s, int step, int T,
                                                   int rows, int H) {
  if (step == 0) return h0 + (size_t)s.d * rows * H;
  const int tp = s.d == 0 ? s.t - 1 : s.t + 1;
  return out + ((size_t)s.d * T + tp) * rows * H;
}

// Edge e's message row `row` at the step's (d, t): m_h holds the edges
// hh | ho of each human, m_o the edges oh | oo of each object. K3 keeps
// every step's (for K4); K5 one step's per direction.
template <int Mode>
__device__ __forceinline__ size_t msg_at(Step s, int T, int rows, int row, int e, int H) {
  const size_t slot = Mode == kDot ? (size_t)s.d * T + s.t : (size_t)s.d;
  return (slot * rows + row) * 2 * H + (size_t)(e & 1) * H;
}

// Blocks own 32 rows x 16 columns of one (direction, edge): edges 0-3 are
// the messages (hh, ho, oh, oo); in v4, edges 4-7 are tmp = recv @ W_att of
// the score edges hh, oh (receivers humans, into tmp_h) and ho, oo
// (receivers objects, into tmp_o), laid out (2, rows, sender group, h).
template <int Mode>
__global__ void __launch_bounds__(kThreads)
proj_kernel(const float* __restrict__ h0_h, const float* __restrict__ h0_o,
            const float* __restrict__ out_h, const float* __restrict__ out_o,
            const float* __restrict__ w_from, const float* __restrict__ b_from,
            float* __restrict__ m_h, float* __restrict__ m_o,
            const float* __restrict__ w_att, float* __restrict__ tmp_h,
            float* __restrict__ tmp_o, int T, int B, int NH, int NO,
            int H, int row_tiles, int step) {
  const Step s = step_of(step, T);
  const int e = blockIdx.y / row_tiles;
  const int row0 = (blockIdx.y % row_tiles) * kTileRows;
  const int col0 = blockIdx.x * kTileUnits;
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (Mode == kV4) {
    if (e >= 4) {
      const int se = e - 4;
      const int rows = se < 2 ? B * NH : B * NO;
      if (row0 >= rows) return;
      const float* x = se < 2 ? prev_state(h0_h, out_h, s, step, T, B * NH, H)
                              : prev_state(h0_o, out_o, s, step, T, B * NO, H);
      float acc[4][4][1] = {};
      const Operand op = {x, H, w_att + (size_t)se * H * H, H, 0, H};
      accumulate<1, 1, 1>(op, op, rows, H, row0, col0, smem, acc);
      store_partials<1>(smem, acc);
      __syncthreads();
      float* tmp = se < 2 ? tmp_h : tmp_o;
      for (int i = 0; i < kEpiloguePairs; ++i) {
        const int p = threadIdx.x + i * kThreads, r = p / kTileUnits, c = p % kTileUnits;
        const int row = row0 + r, col = col0 + c;
        if (row >= rows || col >= H) continue;
        tmp[(((size_t)s.d * rows + row) * 2 + (se & 1)) * H + col] =
            reduce_partials<1>(smem, 0, r, c);
      }
      return;
    }
  }
  const int rows = e < 2 ? B * NH : B * NO;
  if (row0 >= rows) return;
  const float* x = e < 2 ? prev_state(h0_h, out_h, s, step, T, B * NH, H)
                         : prev_state(h0_o, out_o, s, step, T, B * NO, H);
  float* m = e < 2 ? m_h : m_o;

  float acc[4][4][1] = {};
  const Operand op = {x, H, w_from + (size_t)e * H * H, H, 0, H};
  accumulate<1, 1, 1>(op, op, rows, H, row0, col0, smem, acc);
  store_partials<1>(smem, acc);
  __syncthreads();
  for (int i = 0; i < kEpiloguePairs; ++i) {
    const int p = threadIdx.x + i * kThreads, r = p / kTileUnits, c = p % kTileUnits;
    const int row = row0 + r, col = col0 + c;
    if (row >= rows || col >= H) continue;
    const float v = reduce_partials<1>(smem, 0, r, c) + b_from[(size_t)e * H + col];
    m[msg_at<Mode>(s, T, rows, row, e, H) + col] = fmaxf(v, 0.f);
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
// softmax (ext: the weights as given), att_oh and the mixed messages.
// Dynamic shared memory: the (NH + NO) carried states of the block's batch.
template <int Mode>
__global__ void __launch_bounds__(kThreads)
mix_kernel(const float* __restrict__ h0_h, const float* __restrict__ h0_o,
           const float* __restrict__ out_h, const float* __restrict__ out_o,
           const float* __restrict__ obj_mask, const float* __restrict__ m_h,
           const float* __restrict__ m_o, const float* __restrict__ w_att,
           const float* __restrict__ b_att, const float* __restrict__ tmp_h,
           const float* __restrict__ tmp_o, const float* __restrict__ att_ext,
           float* __restrict__ mix_h, float* __restrict__ mix_o,
           float* __restrict__ att, int T, int B, int NH, int NO, int H,
           float scale, int step) {
  const Step s = step_of(step, T);
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kMixColumns;
  const int E = NH + NO;
  const float* hh = prev_state(h0_h, out_h, s, step, T, B * NH, H) + (size_t)b * NH * H;
  const float* ho = prev_state(h0_o, out_o, s, step, T, B * NO, H) + (size_t)b * NO * H;

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
      const float* w = j < 2 ? w_att + (size_t)(2 * gn + j) * 2 * H
                             : w_att + (size_t)(2 * (j - 2) + gn) * 2 * H + H;
      float dot = 0.f;
      for (int k = lane; k < H; k += 32) dot = fmaf(states[n * H + k], w[k], dot);
      dot = warp_sum(dot);
      if (lane == 0) proj[n][j] = dot;
    }
    __syncthreads();
    for (int i = tid; i < E * E; i += kThreads) {
      const int n = i / E, m = i % E, gn = n < NH ? 0 : 1, gm = m < NH ? 0 : 1;
      a[n][m] = fmaxf(proj[n][gm] + proj[m][2 + gn] + b_att[2 * gn + gm], 0.f);
    }
  } else if constexpr (Mode == kV4) {
    for (int p = warp; p < E * E; p += kWarps) {
      const int n = p / E, m = p % E, gn = n < NH ? 0 : 1, gm = m < NH ? 0 : 1;
      const float* tr = gn == 0
          ? tmp_h + (((size_t)s.d * B * NH + b * NH + n) * 2 + gm) * H
          : tmp_o + (((size_t)s.d * B * NO + b * NO + n - NH) * 2 + gm) * H;
      float dot = 0.f;
      for (int k = lane; k < H; k += 32) dot = fmaf(tr[k], states[m * H + k], dot);
      dot = warp_sum(dot);
      if (lane == 0) a[n][m] = fmaxf(dot + b_att[2 * gn + gm], 0.f);
    }
  } else {
    for (int i = tid; i < E * E; i += kThreads)
      a[i / E][i % E] = att_ext[(((size_t)s.t * B + b) * E + i / E) * E + i % E];
  }
  __syncthreads();
  const float* om = obj_mask + (size_t)b * NO;
  if (Mode != kExt && tid < E) {
    const int n = tid;
    if (n < NH) {
      masked_softmax_row(a[n], 0, NH, [&](int m) { return m == n ? 0.f : 1.f; });
      masked_softmax_row(a[n], NH, NO, [&](int o) { return om[o]; });
    } else {
      const int o = n - NH;
      masked_softmax_row(a[n], 0, NH, [&](int) { return 1.f; });
      masked_softmax_row(a[n], NH, NO, [&](int p) { return p == o ? 0.f : om[p]; });
    }
  }
  __syncthreads();
  if (blockIdx.y == 0) {
    for (int i = tid; i < NH * NO; i += kThreads) {
      const int n = i / NO, o = i % NO;
      att[((((size_t)s.d * T + s.t) * B + b) * NH + n) * NO + o] = a[n][NH + o];
    }
  }
  auto m_row = [&](int e, int row) {
    return e < 2 ? m_h + msg_at<Mode>(s, T, B * NH, row, e, H)
                 : m_o + msg_at<Mode>(s, T, B * NO, row, e, H);
  };
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
      mix_h[((size_t)s.d * B * NH + b * NH + n) * 2 * H + k] = v;
    else
      mix_o[((size_t)s.d * B * NO + b * NO + n - NH) * 2 * H + k] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
cell_kernel(const float* __restrict__ gi_h, const float* __restrict__ gi_o,
            const float* __restrict__ u_h, const float* __restrict__ u_o,
            const float* __restrict__ mix_h, const float* __restrict__ mix_o,
            const float* __restrict__ w_msg_h, const float* __restrict__ w_msg_o,
            const float* __restrict__ w_hh_h, const float* __restrict__ w_hh_o,
            const float* __restrict__ b_hh_h, const float* __restrict__ b_hh_o,
            const float* __restrict__ h0_h, const float* __restrict__ h0_o,
            float* __restrict__ out_h, float* __restrict__ out_o,
            int T, int B, int NH, int NO, int H, int row_tiles, int step) {
  const Step s = step_of(step, T);
  const int cell = blockIdx.y / row_tiles;             // 0 humans, 1 objects
  const int row0 = (blockIdx.y % row_tiles) * kTileRows;
  const int unit0 = blockIdx.x * kTileUnits;
  const int rows = B * (cell == 0 ? NH : NO);
  if (row0 >= rows) return;
  const float* mix = (cell == 0 ? mix_h : mix_o) + (size_t)s.d * rows * 2 * H;
  const float* w_msg = (cell == 0 ? w_msg_h : w_msg_o) + (size_t)s.d * 2 * H * 3 * H;
  const float* w_hh = (cell == 0 ? w_hh_h : w_hh_o) + (size_t)s.d * H * 3 * H;
  const float* b_hh = (cell == 0 ? b_hh_h : b_hh_o) + (size_t)s.d * 3 * H;
  const float* h_prev = cell == 0 ? prev_state(h0_h, out_h, s, step, T, rows, H)
                                  : prev_state(h0_o, out_o, s, step, T, rows, H);

  // Slots: 0 r, 1 z (input and recurrent sides summed), 2 input n, 3 recurrent n.
  extern __shared__ __align__(16) unsigned char smem[];
  float acc[4][4][4] = {};
  const Operand in = {mix, 2 * H, w_msg, 3 * H, H, 2 * H}, rec = {h_prev, H, w_hh, 3 * H, H, H};
  accumulate<3, 2, 4>(in, rec, rows, H, row0, unit0, smem, acc);
  store_partials<4>(smem, acc);
  __syncthreads();
  for (int i = 0; i < kEpiloguePairs; ++i) {
    const int p = threadIdx.x + i * kThreads, r = p / kTileUnits, c = p % kTileUnits;
    const int row = row0 + r, unit = unit0 + c;
    if (row >= rows || unit >= H) continue;
    const float* g = (cell == 0 ? gi_h : gi_o) + (((size_t)s.d * T + s.t) * rows + row) * 3 * H;
    const float rg = sigmoid_f(g[unit] + reduce_partials<4>(smem, 0, r, c) + b_hh[unit]);
    const float zg = sigmoid_f(g[H + unit] + reduce_partials<4>(smem, 1, r, c) + b_hh[H + unit]);
    const float ng = tanhf(g[2 * H + unit] + reduce_partials<4>(smem, 2, r, c)
                           + rg * (reduce_partials<4>(smem, 3, r, c) + b_hh[2 * H + unit]));
    const float hp = h_prev[(size_t)row * H + unit];
    const float h_new = (1.f - zg) * ng + zg * hp;
    const float u = (cell == 0 ? u_h : u_o)[(size_t)s.t * rows + row];
    float* out = cell == 0 ? out_h : out_o;
    out[(((size_t)s.d * T + s.t) * rows + row) * H + unit] = u * h_new + (1.f - u) * hp;
  }
}

// Runs the whole scan, both directions: per step the launches A, M, B on
// `stream`, in order. Returns the first CUDA error of a launch, else 0.
template <int Mode>
int run_scan(const float* gi_h, const float* gi_o, const float* u_h, const float* u_o,
             const float* w_from, const float* b_from, const float* w_msg_h,
             const float* w_msg_o, const float* w_hh_h, const float* w_hh_o,
             const float* b_hh_h, const float* b_hh_o, const float* obj_mask,
             const float* h0_h, const float* h0_o, const float* w_att, const float* b_att,
             const float* att_ext, float* out_h, float* out_o, float* att, float* m_h,
             float* m_o, float* tmp_h, float* tmp_o, float* mix_h, float* mix_o, int T, int B,
             int NH, int NO, int H, float scale, cudaStream_t stream) {
  const size_t states_bytes = (size_t)(NH + NO) * H * sizeof(float);
  if (NH + NO > kMaxEntities || H % 4 != 0 || states_bytes > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_a = smem_bytes<1, 1>(), smem_b = smem_bytes<3, 4>();
  cudaError_t err = cudaFuncSetAttribute(proj_kernel<Mode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int max_rows = B * (NH > NO ? NH : NO);
  const int row_tiles = (max_rows + kTileRows - 1) / kTileRows;
  const int col_tiles = (H + kTileUnits - 1) / kTileUnits;
  const dim3 grid_a(col_tiles, (Mode == kV4 ? 8 : 4) * row_tiles, 2);
  const dim3 grid_m(B, (2 * H + kMixColumns - 1) / kMixColumns, 2);
  const dim3 grid_b(col_tiles, 2 * row_tiles, 2);
  for (int step = 0; step < T; ++step) {
    proj_kernel<Mode><<<grid_a, kThreads, smem_a, stream>>>(
        h0_h, h0_o, out_h, out_o, w_from, b_from, m_h, m_o, w_att, tmp_h, tmp_o, T, B, NH,
        NO, H, row_tiles, step);
    mix_kernel<Mode><<<grid_m, kThreads, states_bytes, stream>>>(
        h0_h, h0_o, out_h, out_o, obj_mask, m_h, m_o, w_att, b_att, tmp_h, tmp_o, att_ext,
        mix_h, mix_o, att, T, B, NH, NO, H, scale, step);
    cell_kernel<<<grid_b, kThreads, smem_b, stream>>>(
        gi_h, gi_o, u_h, u_o, mix_h, mix_o, w_msg_h, w_msg_o, w_hh_h, w_hh_o,
        b_hh_h, b_hh_o, h0_h, h0_o, out_h, out_o, T, B, NH, NO, H, row_tiles, step);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3: the scan in 'dot' mode; m_h and m_o keep every step's edge messages
// (2, T, B * NH or NO, 2H). H % 4 == 0, NH + NO <= 16 and (NH + NO) * H * 4
// bytes <= 48 KB.
extern "C" int tggcn_segment_scan_dot_f32(
    const float* gi_h, const float* gi_o, const float* u_h, const float* u_o,
    const float* w_from, const float* b_from, const float* w_msg_h,
    const float* w_msg_o, const float* w_hh_h, const float* w_hh_o,
    const float* b_hh_h, const float* b_hh_o, const float* obj_mask,
    const float* h0_h, const float* h0_o, float* out_h, float* out_o,
    float* att, float* m_h, float* m_o, float* mix_h, float* mix_o, int T, int B, int NH,
    int NO, int H, float scale, void* stream_ptr) {
  return run_scan<kDot>(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h,
                        w_hh_o, b_hh_h, b_hh_o, obj_mask, h0_h, h0_o, nullptr, nullptr,
                        nullptr, out_h, out_o, att, m_h, m_o, nullptr, nullptr, mix_h, mix_o,
                        T, B, NH, NO, H, scale, static_cast<cudaStream_t>(stream_ptr));
}

// K5: the scan in mode 1 'v1' (w_att (4, 2H), b_att (4)), 2 'v4' (w_att
// (4, H, H), b_att (4); tmp_h (2, B * NH, 2, H) and tmp_o (2, B * NO, 2, H)
// scratch) or 3 'ext' (att_ext (T, B, E, E), E = NH + NO: row n < NH holds
// [a_hh | a_oh] of human n, row NH + o [a_ho | a_oo] of object o). m_h and
// m_o hold one step's messages, (2, B * NH or NO, 2H). Unused pointers may be
// null. The limits are K3's.
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
  run_scan<M>(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o,      \
              b_hh_h, b_hh_o, obj_mask, h0_h, h0_o, w_att, b_att, att_ext, out_h, out_o,   \
              att, m_h, m_o, tmp_h, tmp_o, mix_h, mix_o, T, B, NH, NO, H, 1.f, stream)
  switch (mode) {
    case kV1: return TGGCN_RUN_SCAN(kV1);
    case kV4: return TGGCN_RUN_SCAN(kV4);
    case kExt: return TGGCN_RUN_SCAN(kExt);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TGGCN_RUN_SCAN
}
