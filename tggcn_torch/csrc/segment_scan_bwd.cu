// K4: the backward sweep of the bidirectional 'dot' segment scan (K3).
//
// Replaces the TPU kernel tggcn/ops/segment_scan_pallas.py::_make_bwd_kernel
// (launched by _seg_dir_bwd_pallas, segment_scan_pallas.py:546). The TPU
// kernel walks time in reverse as its grid with every weight and the carry
// dL/dh resident in VMEM, and recomputes the step from the streamed h_prev.
// Here no block may wait for another, so each step is five launches whose
// order on the stream orders the phases; both directions (d = 0 forward,
// d = 1 backward in time) share each launch, and the carry lives in device
// memory (carry_h, carry_o, which end as dh0). The step visits time
// opposite to the forward: t = T-1 .. 0 for d = 0, 0 .. T-1 for d = 1.
//
//   M  mix:    recompute the scaled dot scores, the masked softmaxes (kept
//              in `atts` for phase A) and the mixed messages msgs_h, msgs_o
//              (an output: dW_msg is reduced from it outside). The edge
//              messages m_e = relu(h_prev_src @ w_from[e] + b_from[e]) are
//              not recomputed: K3 keeps them (m_h, m_o), so the ReLU's
//              derivative is taken where the forward was. A recompute that
//              sums in another order can land on the other side of the kink
//              (at the MPHOI width on an H100 one such flip moved an output
//              by 7% of its largest value against the plain version).
//   C  cell:   recompute gi = gi_base + msgs @ w_msg, gh = h_prev @ w_hh +
//              b_hh and the gates; dH = carry + g; du = sum(dH (h_new -
//              h_prev)), one partial per block (du_part); dh_new = dH u; dgi,
//              dgh; dhz = dH (1 - u) + dh_new z.
//   D  dmsgs:  dmsgs = dgi @ w_msg^T (contract 3h).
//   A  att:    per (batch, direction, column slice): da = dmsgs . m (plus
//              g_att on the o2h block), ds = a (da - sum(da a)) per softmax
//              group (a fully masked row has a = 0 and so ds = 0), the
//              score gradients of receivers and senders (attc) and dm = a^T
//              dmsgs, masked by the ReLU into dpre (an output).
//   R  carry:  carry = dhz + attc + dgh @ w_hh^T + dpre @ [w_from^T of the
//              two edges the cell's states send].
// After the sweep one launch adds each row's du partials in block order:
// no atomics, so a call gives the same bits on every run.
// C, D and R use the pipelined, register-tiled product of tile_gemm.cuh;
// the transposed weights (w_msg^T, w_hh^T, w_from^T) come from the caller,
// transposed once per call, so that every product reads a (K, N) weight.
// The weight and bias gradients are reduced outside, as large products
// over the per-step outputs.
//
// Bound on an H100: float32 FMAs. Per step and direction at the MPHOI shape
// (B=8, H=2, O=4, h=512) the products do 2*48*3h*3h for the recomputed
// gates plus 2*48*(3h*2h + 5h*h) for D and R, 566 MFLOP, so 189 GFLOP for
// both directions over T=167, against 67 TFLOP/s. The cell weights and
// their transposes (68 MB) do not all fit the 50 MB L2.

#include "tile_gemm.cuh"

namespace {

using namespace tggcn;

constexpr int kMaxEntities = 16;
constexpr int kSliceColumns = 128;   // columns per mix / att block
constexpr int kWarps = kThreads / 32;

struct Step {
  int d, t;
};

__device__ __forceinline__ Step step_of(int step, int T) {
  const int d = blockIdx.z;
  return {d, d == 0 ? T - 1 - step : step};
}

// Row `row` of a per-step tensor (2, T, rows, width) at (d, t).
__device__ __forceinline__ size_t at(Step s, int T, int rows, int row, int width) {
  return (((size_t)s.d * T + s.t) * rows + row) * width;
}

// Edge e's message row `row` at the step's (d, t): m_h holds the edges
// hh | ho of each human, m_o the edges oh | oo of each object.
__device__ __forceinline__ size_t msg_at(Step s, int T, int rows, int row, int e, int H) {
  return (((size_t)s.d * T + s.t) * rows + row) * 2 * H + (size_t)(e & 1) * H;
}

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

// Edge of the message that receiver n takes from sender m: 0 hh, 1 ho, 2 oh, 3 oo.
__device__ __forceinline__ int edge_of(int n, int m, int NH) {
  return n < NH ? (m < NH ? 0 : 2) : (m < NH ? 1 : 3);
}

// Dynamic shared memory: the (NH + NO) states of the block's batch.
__global__ void __launch_bounds__(kThreads)
segb_mix(const float* __restrict__ hprev_h, const float* __restrict__ hprev_o,
         const float* __restrict__ obj_mask, const float* __restrict__ m_h,
         const float* __restrict__ m_o,
         float* __restrict__ msgs_h, float* __restrict__ msgs_o, float* __restrict__ atts,
         int T, int B, int NH, int NO, int H, float scale, int step) {
  const Step s = step_of(step, T);
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kSliceColumns;
  const int E = NH + NO;
  const float* hh = hprev_h + at(s, T, B * NH, b * NH, H);
  const float* ho = hprev_o + at(s, T, B * NO, b * NO, H);

  extern __shared__ float4 states4[];
  float* states = reinterpret_cast<float*>(states4);       // (E, H)
  __shared__ float a[kMaxEntities][kMaxEntities];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int i = tid; i < E * H / 4; i += kThreads) {
    const int n = (4 * i) / H, k = (4 * i) % H;
    const float* src = n < NH ? hh + (size_t)n * H : ho + (size_t)(n - NH) * H;
    states4[i] = *reinterpret_cast<const float4*>(src + k);
  }
  __syncthreads();
  for (int p = warp; p < E * E; p += kWarps) {
    const int n = p / E, m = p % E;
    float dot = 0.f;
    for (int k = lane; k < H; k += 32) dot = fmaf(states[n * H + k], states[m * H + k], dot);
    for (int off = 16; off > 0; off /= 2) dot += __shfl_down_sync(0xffffffffu, dot, off);
    if (lane == 0) a[n][m] = dot * scale;
  }
  __syncthreads();
  const float* om = obj_mask + (size_t)b * NO;
  if (tid < E) {
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
    for (int i = tid; i < E * E; i += kThreads)
      atts[(((size_t)s.d * B + b) * E + i / E) * E + i % E] = a[i / E][i % E];
  }
  auto m_row = [&](int e, int row) {
    return e < 2 ? m_h + msg_at(s, T, B * NH, row, e, H) : m_o + msg_at(s, T, B * NO, row, e, H);
  };
  const int width = min(kSliceColumns, 2 * H - c0);
  for (int i = tid; i < E * width; i += kThreads) {
    const int n = i / width, k = c0 + i % width;
    const bool human = n < NH;
    float v = 0.f;
    if (k < H) {
      for (int m = 0; m < NH; ++m) v = fmaf(a[n][m], m_row(human ? 0 : 1, b * NH + m)[k], v);
    } else {
      for (int o = 0; o < NO; ++o)
        v = fmaf(a[n][NH + o], m_row(human ? 2 : 3, b * NO + o)[k - H], v);
    }
    if (human)
      msgs_h[at(s, T, B * NH, b * NH + n, 2 * H) + k] = v;
    else
      msgs_o[at(s, T, B * NO, b * NO + n - NH, 2 * H) + k] = v;
  }
}

struct CellArgs {
  const float *gi, *u, *hprev, *g, *msgs, *w_msg, *w_hh, *b_hh, *carry;
  float *dgi, *dgh, *du_part, *dhz;
};

__global__ void __launch_bounds__(kThreads)
segb_cell(CellArgs hum, CellArgs obj, int T, int B, int NH, int NO, int H, int row_tiles,
          int step) {
  const Step s = step_of(step, T);
  const int cell = blockIdx.y / row_tiles;             // 0 humans, 1 objects
  const int row0 = (blockIdx.y % row_tiles) * kTileRows;
  const int unit0 = blockIdx.x * kTileUnits;
  const int rows = B * (cell == 0 ? NH : NO);
  if (row0 >= rows) return;
  const CellArgs& c = cell == 0 ? hum : obj;
  const float* msgs = c.msgs + at(s, T, rows, 0, 2 * H);
  const float* hp = c.hprev + at(s, T, rows, 0, H);
  const float* w_msg = c.w_msg + (size_t)s.d * 2 * H * 3 * H;
  const float* w_hh = c.w_hh + (size_t)s.d * H * 3 * H;
  const float* b_hh = c.b_hh + (size_t)s.d * 3 * H;

  // Slots: 0 r, 1 z (input and recurrent sides summed), 2 input n, 3 recurrent n.
  extern __shared__ __align__(16) unsigned char smem[];
  float acc[4][4][4] = {};
  const Operand in = {msgs, 2 * H, w_msg, 3 * H, H, 2 * H}, rec = {hp, H, w_hh, 3 * H, H, H};
  accumulate<3, 2, 4>(in, rec, rows, H, row0, unit0, smem, acc);
  store_partials<4>(smem, acc);
  __syncthreads();
  for (int i = 0; i < kEpiloguePairs; ++i) {
    const int p = threadIdx.x + i * kThreads, r = p / kTileUnits, cc = p % kTileUnits;
    const int row = row0 + r, unit = unit0 + cc;
    const bool valid = row < rows && unit < H;
    float du = 0.f;
    if (valid) {
      const size_t g3 = at(s, T, rows, row, 3 * H);
      const float* gr = c.gi + g3;
      const float rg = sigmoid_f(gr[unit] + reduce_partials<4>(smem, 0, r, cc) + b_hh[unit]);
      const float zg = sigmoid_f(gr[H + unit] + reduce_partials<4>(smem, 1, r, cc)
                                 + b_hh[H + unit]);
      const float hn = reduce_partials<4>(smem, 3, r, cc) + b_hh[2 * H + unit];
      const float ng = tanhf(gr[2 * H + unit] + reduce_partials<4>(smem, 2, r, cc) + rg * hn);
      const float hpv = hp[(size_t)row * H + unit];
      const float h_new = (1.f - zg) * ng + zg * hpv;
      const size_t hs = ((size_t)s.d * rows + row) * H + unit;
      const float dH = c.carry[hs] + c.g[at(s, T, rows, row, H) + unit];
      const float u = c.u[(size_t)s.t * rows + row];
      du = dH * (h_new - hpv);
      const float dh_new = dH * u;
      const float dtanh = dh_new * (1.f - zg) * (1.f - ng * ng);
      const float d_ir = dtanh * hn * rg * (1.f - rg);
      const float d_iz = dh_new * (hpv - ng) * zg * (1.f - zg);
      c.dgi[g3 + unit] = d_ir;
      c.dgi[g3 + H + unit] = d_iz;
      c.dgi[g3 + 2 * H + unit] = dtanh;
      c.dgh[g3 + unit] = d_ir;
      c.dgh[g3 + H + unit] = d_iz;
      c.dgh[g3 + 2 * H + unit] = dtanh * rg;
      c.dhz[hs] = dH * (1.f - u) + dh_new * zg;
    }
    // The 16 units of a tile row sit in 16 neighbouring lanes: add them up
    // in a fixed order, then one partial per row and block; du_sum adds the
    // blocks' partials after the sweep, so du is the same on every run.
    for (int off = kTileUnits / 2; off > 0; off /= 2)
      du += __shfl_xor_sync(0xffffffffu, du, off, kTileUnits);
    if (cc == 0 && row < rows)
      c.du_part[(((size_t)s.d * T + s.t) * rows + row) * gridDim.x + blockIdx.x] = du;
  }
}

// du[i] = the sum, in block order, of the `parts` partials of row i.
__global__ void __launch_bounds__(kThreads)
du_sum(const float* __restrict__ part_h, const float* __restrict__ part_o,
       float* __restrict__ du_h, float* __restrict__ du_o, int n_h, int n_o, int parts) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool human = i < n_h;
  if (i >= n_h + n_o) return;
  const float* p = human ? part_h + (size_t)i * parts : part_o + (size_t)(i - n_h) * parts;
  float v = 0.f;
  for (int q = 0; q < parts; ++q) v += p[q];
  (human ? du_h : du_o)[human ? i : i - n_h] = v;
}

// dmsgs = dgi @ w_msg^T for both cells; blocks own 32 rows x 16 of 2h columns.
__global__ void __launch_bounds__(kThreads)
segb_dmsgs(const float* __restrict__ dgi_h, const float* __restrict__ dgi_o,
           const float* __restrict__ w_msg_t_h, const float* __restrict__ w_msg_t_o,
           float* __restrict__ dmsgs_h, float* __restrict__ dmsgs_o, int T, int B, int NH,
           int NO, int H, int row_tiles, int step) {
  const Step s = step_of(step, T);
  const int cell = blockIdx.y / row_tiles;
  const int row0 = (blockIdx.y % row_tiles) * kTileRows;
  const int col0 = blockIdx.x * kTileUnits;
  const int rows = B * (cell == 0 ? NH : NO);
  if (row0 >= rows) return;
  const float* dgi = (cell == 0 ? dgi_h : dgi_o) + at(s, T, rows, 0, 3 * H);
  const float* w_t = (cell == 0 ? w_msg_t_h : w_msg_t_o) + (size_t)s.d * 3 * H * 2 * H;
  float* out = (cell == 0 ? dmsgs_h : dmsgs_o) + (size_t)s.d * rows * 2 * H;

  extern __shared__ __align__(16) unsigned char smem[];
  float acc[4][4][1] = {};
  const Operand op = {dgi, 3 * H, w_t, 2 * H, 0, 3 * H};
  accumulate<1, 1, 1>(op, op, rows, 2 * H, row0, col0, smem, acc);
  store_partials<1>(smem, acc);
  __syncthreads();
  for (int i = 0; i < kEpiloguePairs; ++i) {
    const int p = threadIdx.x + i * kThreads, r = p / kTileUnits, c = p % kTileUnits;
    const int row = row0 + r, col = col0 + c;
    if (row >= rows || col >= 2 * H) continue;
    out[(size_t)row * 2 * H + col] = reduce_partials<1>(smem, 0, r, c);
  }
}

struct AttArgs {
  const float *hprev_h, *hprev_o, *g_att, *m_h, *m_o, *atts, *dmsgs_h, *dmsgs_o;
  float *dpre_h, *dpre_o, *attc_h, *attc_o;
};

// Per (batch, column slice, direction): the backward through the attention,
// the mixing and the ReLU of the message projections.
__global__ void __launch_bounds__(kThreads)
segb_att(AttArgs x, int T, int B, int NH, int NO, int H, float scale, int step) {
  const Step s = step_of(step, T);
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kSliceColumns;
  const int E = NH + NO;
  __shared__ float a[kMaxEntities][kMaxEntities];
  __shared__ float ds[kMaxEntities][kMaxEntities];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // dmsgs row of receiver n (2h wide), message row of edge e from sender m,
  // state row of entity n.
  auto dmg = [&](int n) {
    return n < NH ? x.dmsgs_h + ((size_t)s.d * B * NH + b * NH + n) * 2 * H
                  : x.dmsgs_o + ((size_t)s.d * B * NO + b * NO + n - NH) * 2 * H;
  };
  auto m_row = [&](int e, int m) {
    return m < NH ? x.m_h + msg_at(s, T, B * NH, b * NH + m, e, H)
                  : x.m_o + msg_at(s, T, B * NO, b * NO + m - NH, e, H);
  };
  auto state = [&](int n) {
    return n < NH ? x.hprev_h + at(s, T, B * NH, b * NH + n, H)
                  : x.hprev_o + at(s, T, B * NO, b * NO + n - NH, H);
  };
  for (int i = tid; i < E * E; i += kThreads)
    a[i / E][i % E] = x.atts[(((size_t)s.d * B + b) * E + i / E) * E + i % E];
  for (int p = warp; p < E * E; p += kWarps) {         // da, over the full width
    const int n = p / E, m = p % E;
    const float* dr = dmg(n) + (m < NH ? 0 : H);
    const float* mr = m_row(edge_of(n, m, NH), m);
    float dot = 0.f;
    for (int k = lane; k < H; k += 32) dot = fmaf(dr[k], mr[k], dot);
    for (int off = 16; off > 0; off /= 2) dot += __shfl_down_sync(0xffffffffu, dot, off);
    if (lane == 0) {
      if (n < NH && m >= NH) dot += x.g_att[(at(s, T, B, b, NH) + n) * NO + m - NH];
      ds[n][m] = dot;
    }
  }
  __syncthreads();
  if (tid < E) {                                       // softmax backward per group
    const int n = tid;
    for (int grp = 0; grp < 2; ++grp) {
      const int lo = grp == 0 ? 0 : NH, hi = grp == 0 ? NH : E;
      float dot = 0.f;
      for (int m = lo; m < hi; ++m) dot += ds[n][m] * a[n][m];
      for (int m = lo; m < hi; ++m) ds[n][m] = a[n][m] * (ds[n][m] - dot);
    }
  }
  __syncthreads();
  const int width = min(kSliceColumns, H - c0);
  for (int i = tid; i < E * width; i += kThreads) {
    const int j = i / width, k = c0 + i % width;
    // Score gradients: j as receiver and as sender.
    float g = 0.f;
    for (int m = 0; m < E; ++m) g = fmaf(ds[j][m] + ds[m][j], state(m)[k], g);
    // dm of the two edges j sends: to the humans (offset 0 of their dmsgs
    // for a human sender, H for an object sender) and to the objects.
    const int half = j < NH ? 0 : H;
    float dm_h = 0.f, dm_o = 0.f;
    for (int n = 0; n < NH; ++n) dm_h = fmaf(a[n][j], dmg(n)[half + k], dm_h);
    for (int n = NH; n < E; ++n) dm_o = fmaf(a[n][j], dmg(n)[half + k], dm_o);
    const int e_h = edge_of(0, j, NH), e_o = edge_of(NH, j, NH);
    dm_h = m_row(e_h, j)[k] > 0.f ? dm_h : 0.f;
    dm_o = m_row(e_o, j)[k] > 0.f ? dm_o : 0.f;
    if (j < NH) {
      const size_t o = at(s, T, B * NH, b * NH + j, 2 * H);
      x.dpre_h[o + k] = dm_h;                          // edge hh
      x.dpre_h[o + H + k] = dm_o;                      // edge ho
      x.attc_h[((size_t)s.d * B * NH + b * NH + j) * H + k] = scale * g;
    } else {
      const size_t o = at(s, T, B * NO, b * NO + j - NH, 2 * H);
      x.dpre_o[o + k] = dm_h;                          // edge oh
      x.dpre_o[o + H + k] = dm_o;                      // edge oo
      x.attc_o[((size_t)s.d * B * NO + b * NO + j - NH) * H + k] = scale * g;
    }
  }
}

struct CarryArgs {
  const float *dgh, *w_hh_t, *dpre, *w_from_t, *dhz, *attc;
  float* carry;
};

// carry = dhz + attc + dgh @ w_hh^T + dpre @ w_from^T (of the sent edges).
__global__ void __launch_bounds__(kThreads)
segb_carry(CarryArgs hum, CarryArgs obj, int T, int B, int NH, int NO, int H, int row_tiles,
           int step) {
  const Step s = step_of(step, T);
  const int cell = blockIdx.y / row_tiles;
  const int row0 = (blockIdx.y % row_tiles) * kTileRows;
  const int unit0 = blockIdx.x * kTileUnits;
  const int rows = B * (cell == 0 ? NH : NO);
  if (row0 >= rows) return;
  const CarryArgs& c = cell == 0 ? hum : obj;

  extern __shared__ __align__(16) unsigned char smem[];
  float acc[4][4][2] = {};
  const Operand rec = {c.dgh + at(s, T, rows, 0, 3 * H), 3 * H,
                       c.w_hh_t + (size_t)s.d * 3 * H * H, H, 0, 3 * H};
  const Operand snd = {c.dpre + at(s, T, rows, 0, 2 * H), 2 * H, c.w_from_t, H, 0, 2 * H};
  accumulate<1, 2, 2>(rec, snd, rows, H, row0, unit0, smem, acc);
  store_partials<2>(smem, acc);
  __syncthreads();
  for (int i = 0; i < kEpiloguePairs; ++i) {
    const int p = threadIdx.x + i * kThreads, r = p / kTileUnits, cc = p % kTileUnits;
    const int row = row0 + r, unit = unit0 + cc;
    if (row >= rows || unit >= H) continue;
    const size_t hs = ((size_t)s.d * rows + row) * H + unit;
    c.carry[hs] = c.dhz[hs] + c.attc[hs] + reduce_partials<2>(smem, 0, r, cc)
                  + reduce_partials<2>(smem, 1, r, cc);
  }
}

}  // namespace

// Runs the whole backward sweep, both directions: per step the launches M,
// C, D, A, R on `stream`, in order, then du_sum. carry_h and carry_o must
// hold zeros on entry; the carries hold dh0 on return. du_part_h and
// du_part_o take (2, T, B * NH or NO, ceil(H / 16)) partials. Returns the
// first CUDA error of a launch, else 0. H % 4 == 0, NH + NO <= 16 and
// (NH + NO) * H * 4 bytes <= 48 KB.
extern "C" int tggcn_segment_scan_dot_bwd_f32(
    const float* gi_h, const float* gi_o, const float* u_h, const float* u_o,
    const float* hprev_h, const float* hprev_o, const float* m_h, const float* m_o,
    const float* g_h, const float* g_o, const float* g_att, const float* w_msg_h,
    const float* w_msg_o, const float* w_hh_h, const float* w_hh_o, const float* b_hh_h,
    const float* b_hh_o, const float* obj_mask, const float* w_from_t_h,
    const float* w_from_t_o, const float* w_msg_t_h, const float* w_msg_t_o,
    const float* w_hh_t_h, const float* w_hh_t_o, float* dgi_h, float* dgi_o,
    float* dgh_h, float* dgh_o, float* msgs_h, float* msgs_o, float* dpre_h,
    float* dpre_o, float* du_h, float* du_o, float* du_part_h, float* du_part_o,
    float* carry_h, float* carry_o, float* atts,
    float* dhz_h, float* dhz_o, float* dmsgs_h, float* dmsgs_o, float* attc_h, float* attc_o, int T, int B, int NH, int NO, int H, float scale,
    void* stream_ptr) {
  const size_t states_bytes = (size_t)(NH + NO) * H * sizeof(float);
  if (NH + NO > kMaxEntities || H % 4 != 0 || states_bytes > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem_1 = smem_bytes<1, 1>(), smem_c = smem_bytes<3, 4>(),
               smem_r = smem_bytes<1, 2>();
  cudaError_t err = cudaFuncSetAttribute(segb_cell,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(segb_dmsgs, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(segb_carry, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_r);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int max_rows = B * (NH > NO ? NH : NO);
  const int row_tiles = (max_rows + kTileRows - 1) / kTileRows;
  const int col_tiles = (H + kTileUnits - 1) / kTileUnits;
  const dim3 grid_m(B, (2 * H + kSliceColumns - 1) / kSliceColumns, 2);
  const dim3 grid_c(col_tiles, 2 * row_tiles, 2);
  const dim3 grid_d(2 * col_tiles, 2 * row_tiles, 2);
  const dim3 grid_a(B, (H + kSliceColumns - 1) / kSliceColumns, 2);
  const CellArgs cell_h = {gi_h, u_h, hprev_h, g_h, msgs_h, w_msg_h, w_hh_h, b_hh_h,
                           carry_h, dgi_h, dgh_h, du_part_h, dhz_h};
  const CellArgs cell_o = {gi_o, u_o, hprev_o, g_o, msgs_o, w_msg_o, w_hh_o, b_hh_o,
                           carry_o, dgi_o, dgh_o, du_part_o, dhz_o};
  const AttArgs att = {hprev_h, hprev_o, g_att, m_h, m_o, atts, dmsgs_h, dmsgs_o,
                       dpre_h, dpre_o, attc_h, attc_o};
  const CarryArgs carry_args_h = {dgh_h, w_hh_t_h, dpre_h, w_from_t_h, dhz_h, attc_h, carry_h};
  const CarryArgs carry_args_o = {dgh_o, w_hh_t_o, dpre_o, w_from_t_o, dhz_o, attc_o, carry_o};
  for (int step = 0; step < T; ++step) {
    segb_mix<<<grid_m, kThreads, states_bytes, stream>>>(hprev_h, hprev_o, obj_mask, m_h, m_o,
                                                         msgs_h, msgs_o, atts, T, B, NH, NO,
                                                         H, scale, step);
    segb_cell<<<grid_c, kThreads, smem_c, stream>>>(cell_h, cell_o, T, B, NH, NO, H,
                                                   row_tiles, step);
    segb_dmsgs<<<grid_d, kThreads, smem_1, stream>>>(dgi_h, dgi_o, w_msg_t_h, w_msg_t_o,
                                                    dmsgs_h, dmsgs_o, T, B, NH, NO, H,
                                                    row_tiles, step);
    segb_att<<<grid_a, kThreads, 0, stream>>>(att, T, B, NH, NO, H, scale, step);
    segb_carry<<<grid_c, kThreads, smem_r, stream>>>(carry_args_h, carry_args_o, T, B, NH,
                                                    NO, H, row_tiles, step);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_h = 2 * T * B * NH, n_o = 2 * T * B * NO;
  du_sum<<<(n_h + n_o + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      du_part_h, du_part_o, du_h, du_o, n_h, n_o, col_tiles);
  return static_cast<int>(cudaGetLastError());
}
