// K4: the backward sweep of the bidirectional 'dot' segment scan (K3).
//
// Replaces the TPU kernel tggcn/ops/segment_scan_pallas.py::_make_bwd_kernel
// (launched by _seg_dir_bwd_pallas, segment_scan_pallas.py:546). The TPU
// kernel walks time in reverse as its grid with every weight and the carry
// dL/dh resident in VMEM, and recomputes the step from the streamed h_prev.
// Here no block may wait for a block outside its own cluster, so each step
// is three launches (bfloat16 at h <= 512: two, below) whose order on the
// stream orders the phases; both directions (d = 0 forward, d = 1 backward
// in time) share each launch. The step visits time opposite to the
// forward: t = T-1 .. 0 for d = 0, 0 .. T-1 for d = 1.
//
// K3, run with keep, kept what the forward computed: the edge messages m
// (so the ReLU's derivative is taken where the forward was), the softmaxed
// attention `atts` and the gates [r | z | n | hn] of every cell row. So K4
// recomputes nothing: no gate product, no scores, no softmax, no mixing.
// Every value it differentiates through is the one the forward used (a
// recompute summed in another order can land on the other side of the
// ReLU's kink: at the MPHOI width on an H100 one such flip moved an output
// by 7% of its largest value).
//
//   C  cell:   elementwise from the kept gates: dH = carry + g; du = sum(dH
//              (h_new - h_prev)), one partial per block (du_part); dh_new =
//              dH u; dgi, dgh; dhz = dH (1 - u) + dh_new z. It runs in R's
//              epilogue of the step before (the carry never leaves the
//              block that computed it); the first step has a launch of its
//              own with a zero carry.
//   D  dmsgs:  dmsgs = dgi @ w_msg^T (contract 3h).
//   A  att:    per (batch, direction, column slice): da = dmsgs . m (plus
//              g_att on the o2h block), ds = a (da - sum(da a)) per softmax
//              group (a fully masked row has a = 0 and so ds = 0), the
//              score gradients of receivers and senders (attc) and dm = a^T
//              dmsgs, masked by the ReLU into dpre (an output).
//   R  carry:  carry = dhz + attc + dgh @ w_hh^T + dpre @ [w_from^T of the
//              two edges the cell's states send]; then C of the next step,
//              or dh0 after the last.
// After the sweep one launch adds each row's du partials in block order:
// no atomics, so a call gives the same bits on every run.
// D and R run on the tensor cores through tc_gemm.cuh (mma.sync TF32 with
// the 3xTF32 split, float32 accumulation), reading w_msg, w_hh and w_from as
// they are stored (the products contract along the weights' columns). The
// weight and bias gradients are reduced outside, as large products over
// the per-step outputs and K3's kept mixed messages.
//
// Bound on an H100. Per step and direction at the MPHOI shape (B=8, H=2,
// O=4, h=512) the products do 2*48*(3h*2h + 5h*h) = 277 MFLOP for D and R,
// so 93 GFLOP for both directions over T=167 (1.39 ms of float32 FMAs at 67
// TFLOP/s, 0.56 ms as 3xTF32 at 495 TFLOP/s). The weights D and R read (46
// MB a step for both directions: w_msg 25 MB, w_hh 13 MB, w_from twice
// 8 MB) about fill the 50 MB L2.
//
// bfloat16 (T = bf16: u, hprev, the upstream gradients, the weights and
// every output in bfloat16; K3's kept m, gates and attention float32), as
// the TPU kernel runs it (segment_scan_pallas.py:324-527): D's and R's
// products are bfloat16 x bfloat16 with float32 sums (tc_gemm.cuh,
// m16n8k16) on the bfloat16 outputs dgi, dgh and dpre, which is what the
// TPU kernel multiplies; the carry dL/dh, dhz, du's partials and attc stay
// float32. Where the TPU kernel computes in bfloat16 the values are
// rounded (round_to): the gates, attention and messages it would
// recompute, each step of C's elementwise backward, dmsgs and the score
// gradient ds. The weights are half the bytes; bound: the products at the
// dense bfloat16 rate (989 TFLOP/s), the attention backward on the FMA
// units.
//
// bfloat16 at h <= 512 takes two launches a step (run_cluster), chosen from
// the shape before any launch (cluster_plan; larger h, and float32, keep
// the three above):
//   DA  a cluster launch: a cluster of ceil(h / 32) blocks is one
//       (direction, sender group, batch tile of 32 / max(H, O) clips). The
//       softmax groups follow the sender type, and each reads only its half
//       of a receiver's dmsgs row and the dpre of its own senders, so block
//       `rank` takes 32 of the group's h dmsgs columns for both cells' rows
//       of the tile (segb_dmsgs's two products, through one ring), then
//       from its columns the group senders' dpre towards both receiver
//       cells (A's column work); then each block gathers the full group
//       half of a share of the tile's receivers' dmsgs rows from the
//       cluster's tiles (distributed shared memory) and takes da and the
//       softmax backward of the group in segb_att's order, writing ds
//       (2, B, E, E). One block an SM: at MPHOI's shape four clusters of
//       16, which the card holds at once (it holds seven).
//   R   segb_carry's product and epilogue, which take attc from ds and the
//       states themselves (segb_att's order) and copy those inputs, dhz
//       and the next step's C inputs while the product's copies run.
// So segb_att's launch, its eightfold staging and its repeated da go, and
// a call makes 2T + 2 launches (3T + 2 before). Every product, sum and
// rounding is the per-step route's, so every output has its bits (the
// card tests hold them equal). On the H100 (PERF.md) the route is about 6%
// faster than the per-step one: a DA launch with no copies still takes
// 14 us (its two products on one SM, the cluster barriers, the tile's
// reduction, the gather); 128 blocks of one product each (two blocks an
// SM, so that the card holds eight clusters of 16) were no faster. Copying
// the rows once a cluster by TMA multicast was tried and was slower: each
// stage's ring slot must be freed by every block of the cluster before it
// is refilled, and that coupling, the cluster barriers and the rows' TMA
// boxes cost more than the L2 bytes they saved.

#include "gru_cluster.cuh"
#include "tc_gemm.cuh"

namespace {

using namespace tggcn::tc;

constexpr int kMaxEntities = 16;
constexpr int kSliceColumns = 64;    // columns per att block
// segb_att's dynamic shared memory may take what is left of the 227 KB a
// block can have beside its 2 KB of static arrays.
constexpr size_t kMaxAttSmem = 224 * 1024;

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

// Edge of the message that receiver n takes from sender m: 0 hh, 1 ho, 2 oh, 3 oo.
__device__ __forceinline__ int edge_of(int n, int m, int NH) {
  return n < NH ? (m < NH ? 0 : 2) : (m < NH ? 1 : 3);
}

template <class T>
struct CellArgs {
  const T *u, *hprev, *g;
  const float* gates;
  T *dgi, *dgh;
  float *du_part, *dhz;
};

// What phase C at (s, row, unit) reads besides the carry: the kept gates
// r, z, n and hn, h_prev, the upstream g and the decision u.
struct CellIn {
  float r, z, n, hn, hprev, g, u;
};

template <class T>
__device__ __forceinline__ CellIn cell_load(const CellArgs<T>& c, Step s, int T_, int rows,
                                            int row, int unit, int H) {
  const float* gr = c.gates + at(s, T_, rows, row, 4 * H);
  const size_t hi = at(s, T_, rows, row, H) + unit;
  return {gr[unit], gr[H + unit], gr[2 * H + unit], gr[3 * H + unit], to_f32(c.hprev[hi]),
          to_f32(c.g[hi]), to_f32(c.u[(size_t)s.t * rows + row])};
}

// Phase C at (s, row, unit) from the carry dL/dh and its inputs: writes
// dgi, dgh, dhz and returns this unit's share of du. With bfloat16 IO each
// step is rounded as the TPU kernel's bfloat16 arithmetic rounds it (q:
// the identity in float32).
template <class T>
__device__ __forceinline__ float cell_bwd(const CellArgs<T>& c, Step s, int T_, int rows,
                                          int row, int unit, int H, float carry,
                                          const CellIn& in) {
  const auto q = [](float x) { return round_to<T>(x); };
  const float rg = q(in.r), zg = q(in.z), ng = q(in.n);
  const float hn = q(in.hn);
  const float hpv = in.hprev;
  const float dH = carry + in.g;
  const float u = in.u;
  const float omz = q(1.f - zg);
  const float h_new = q(omz * ng) + zg * hpv;
  const float dh_new = q(dH * u);
  const float dtanh = q(q(dh_new * omz) * q(1.f - q(ng * ng)));
  const float d_ir = q(q(q(dtanh * hn) * rg) * q(1.f - rg));
  const float d_iz = q(q(q(dh_new * q(hpv - ng)) * zg) * omz);
  const size_t g3 = at(s, T_, rows, row, 3 * H);
  c.dgi[g3 + unit] = from_f32<T>(d_ir);
  c.dgi[g3 + H + unit] = from_f32<T>(d_iz);
  c.dgi[g3 + 2 * H + unit] = from_f32<T>(dtanh);
  c.dgh[g3 + unit] = from_f32<T>(d_ir);
  c.dgh[g3 + H + unit] = from_f32<T>(d_iz);
  c.dgh[g3 + 2 * H + unit] = from_f32<T>(dtanh * rg);
  c.dhz[((size_t)s.d * rows + row) * H + unit] = dH * (1.f - u) + q(dh_new * zg);
  return dH * (h_new - hpv);
}

template <class T>
__device__ __forceinline__ float cell_bwd(const CellArgs<T>& c, Step s, int T_, int rows,
                                          int row, int unit, int H, float carry) {
  return cell_bwd(c, s, T_, rows, row, unit, H, carry, cell_load(c, s, T_, rows, row, unit, H));
}

// du_s holds each (row, unit) share of the block's 32 x 16 tile: one
// partial per row and block, added over the 16 units in order.
template <class T>
__device__ __forceinline__ void store_du(const CellArgs<T>& c, Step s, int T_, int rows,
                                         int row0, int nrows,
                                         const float (&du_s)[kMaxRows][kMTile + 1]) {
  __syncthreads();
  const int r = threadIdx.x;
  if (r < nrows) {
    float v = 0.f;
    for (int k = 0; k < kMTile; ++k) v += du_s[r][k];
    c.du_part[at(s, T_, rows, row0 + r, gridDim.x) + blockIdx.x] = v;
  }
}

// Phase C of the first step (zero carry); blocks own 16 units of up to 32
// rows of one (direction, cell), as R's.
template <class T>
__global__ void __launch_bounds__(kThreads)
segb_cell(CellArgs<T> hum, CellArgs<T> obj, int T_, int B, int NH, int NO, int H,
          int row_tiles) {
  const Step s = step_of(0, T_);
  const int cell = blockIdx.y / row_tiles;
  const int row0 = (blockIdx.y % row_tiles) * kMaxRows;
  const int unit0 = blockIdx.x * kMTile;
  const int all_rows = B * (cell == 0 ? NH : NO);
  if (row0 >= all_rows) return;
  const int nrows = min(kMaxRows, all_rows - row0);
  const CellArgs<T>& c = cell == 0 ? hum : obj;
  __shared__ float du_s[kMaxRows][kMTile + 1];
  for (int p = threadIdx.x; p < kMTile * kMaxRows; p += kThreads) {
    const int cc = p % kMTile, r = p / kMTile;
    const int unit = unit0 + cc;
    du_s[r][cc] = r < nrows && unit < H ? cell_bwd(c, s, T_, all_rows, row0 + r, unit, H, 0.f)
                                        : 0.f;
  }
  store_du(c, s, T_, all_rows, row0, nrows, du_s);
}

// du[i] = the sum, in block order, of the `parts` partials of row i.
template <class T>
__global__ void __launch_bounds__(kThreads)
du_sum(const float* __restrict__ part_h, const float* __restrict__ part_o,
       T* __restrict__ du_h, T* __restrict__ du_o, int n_h, int n_o, int parts) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool human = i < n_h;
  if (i >= n_h + n_o) return;
  const float* p = human ? part_h + (size_t)i * parts : part_o + (size_t)(i - n_h) * parts;
  float v = 0.f;
  for (int q = 0; q < parts; ++q) v += p[q];
  (human ? du_h : du_o)[human ? i : i - n_h] = from_f32<T>(v);
}

// dmsgs = dgi @ w_msg^T for both cells (float32, rounded to T as the TPU
// kernel rounds it); blocks own 32 of 2h columns and up to 32 rows.
template <class T>
__global__ void __launch_bounds__(kThreads)
segb_dmsgs(const T* __restrict__ dgi_h, const T* __restrict__ dgi_o,
           const T* __restrict__ w_msg_h, const T* __restrict__ w_msg_o,
           float* __restrict__ dmsgs_h, float* __restrict__ dmsgs_o, int T_, int B, int NH,
           int NO, int H, int row_tiles, int step) {
  const Step s = step_of(step, T_);
  const int cell = blockIdx.y / row_tiles;
  const int row0 = (blockIdx.y % row_tiles) * kMaxRows;
  const int col0 = blockIdx.x * 2 * kMTile;
  const int all_rows = B * (cell == 0 ? NH : NO);
  if (row0 >= all_rows) return;
  const int rows = min(kMaxRows, all_rows - row0);
  const T* dgi = (cell == 0 ? dgi_h : dgi_o) + at(s, T_, all_rows, row0, 3 * H);
  const T* w = (cell == 0 ? w_msg_h : w_msg_o) + (size_t)s.d * 2 * H * 3 * H;
  float* out = (cell == 0 ? dmsgs_h : dmsgs_o) + ((size_t)s.d * all_rows + row0) * 2 * H;

  extern __shared__ __align__(16) unsigned char smem[];
  float acc[2][kNTiles][4] = {};
  const OperandT<T, T> op = {dgi, 3 * H, w, 3 * H, 3 * H};
  const Tiles tiles = {{col0, col0 + kMTile, 0},
                       {max(0, min(kMTile, 2 * H - col0)),
                        max(0, min(kMTile, 2 * H - col0 - kMTile)), 0}};
  accumulate<true, 2, 2, 1, TileSlots>(op, op, op, tiles, rows, smem, acc);
  store_partials<2>(smem, acc);
  __syncthreads();
  for (int p = threadIdx.x; p < 2 * kMTile * kMaxRows; p += kThreads) {
    const int t = p / (kMTile * kMaxRows), c = p % kMTile, r = (p / kMTile) % kMaxRows;
    const int col = col0 + t * kMTile + c;
    if (r >= rows || col >= 2 * H) continue;
    out[(size_t)r * 2 * H + col] = round_to<T>(reduce<2>(smem, t, c, r));
  }
}

template <class T>
struct AttArgs {
  const T *hprev_h, *hprev_o, *g_att;
  const float *m_h, *m_o, *atts, *dmsgs_h, *dmsgs_o;
  T *dpre_h, *dpre_o;
  float *attc_h, *attc_o;
};

// Per (batch, column slice, direction): the backward through the attention,
// the mixing and the ReLU of the message projections. The batch's dmsgs and
// message rows (full width, for da) and its states' column slice are staged
// in shared memory with 16-byte loads first, so that the dot products and
// the per-column sums read shared memory and not a chain of L2 loads.
// Dynamic shared memory: att_smem_bytes(E, H). With bfloat16 IO the
// attention and the messages read as the TPU kernel's bfloat16 recompute
// (rounded), the ReLU's derivative from the float32 messages K3 kept.
template <class T>
__global__ void __launch_bounds__(kThreads)
segb_att(AttArgs<T> x, int T_, int B, int NH, int NO, int H, float scale, int step) {
  const auto q = [](float v) { return round_to<T>(v); };
  const Step s = step_of(step, T_);
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kSliceColumns;
  const int E = NH + NO;
  __shared__ float a[kMaxEntities][kMaxEntities];
  __shared__ float ds[kMaxEntities][kMaxEntities];
  extern __shared__ float4 staged4[];
  float* dm_s = reinterpret_cast<float*>(staged4);        // (E, 2H): dmsgs of receiver n
  float* m_s = dm_s + (size_t)E * 2 * H;                  // (E, 2H): messages sender n sends
  float* st_s = m_s + (size_t)E * 2 * H;                  // (E, kSliceColumns): states
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int width = min(kSliceColumns, H - c0);
  for (int i = tid; i < E * 2 * H / 4; i += kThreads) {
    const int n = (4 * i) / (2 * H), k = (4 * i) % (2 * H);
    const float* dr = n < NH ? x.dmsgs_h + ((size_t)s.d * B * NH + b * NH + n) * 2 * H
                             : x.dmsgs_o + ((size_t)s.d * B * NO + b * NO + n - NH) * 2 * H;
    const float* mr = n < NH ? x.m_h + at(s, T_, B * NH, b * NH + n, 2 * H)
                             : x.m_o + at(s, T_, B * NO, b * NO + n - NH, 2 * H);
    staged4[i] = *reinterpret_cast<const float4*>(dr + k);
    staged4[E * 2 * H / 4 + i] = *reinterpret_cast<const float4*>(mr + k);
  }
  for (int i = tid; i < E * width; i += kThreads) {
    const int n = i / width, k = i % width;
    st_s[n * kSliceColumns + k] =
        to_f32(n < NH ? x.hprev_h[at(s, T_, B * NH, b * NH + n, H) + c0 + k]
                      : x.hprev_o[at(s, T_, B * NO, b * NO + n - NH, H) + c0 + k]);
  }
  for (int i = tid; i < E * E; i += kThreads)
    a[i / E][i % E] = q(x.atts[at(s, T_, B, b, E * E) + i]);
  __syncthreads();
  // Receiver n takes from sender m the edge whose half of m's message row
  // is 0 for a human receiver (hh, oh) and H for an object (ho, oo); n's
  // dmsgs row holds the human senders' half first.
  for (int p = warp; p < E * E; p += kWarps) {         // da, over the full width
    const int n = p / E, m = p % E;
    const float* dr = dm_s + (size_t)n * 2 * H + (m < NH ? 0 : H);
    const float* mr = m_s + (size_t)m * 2 * H + (n < NH ? 0 : H);
    float dot = 0.f;
    for (int k = lane; k < H; k += 32) dot = fmaf(dr[k], q(mr[k]), dot);
    for (int off = 16; off > 0; off /= 2) dot += __shfl_down_sync(0xffffffffu, dot, off);
    if (lane == 0) {
      if (n < NH && m >= NH) dot += to_f32(x.g_att[(at(s, T_, B, b, NH) + n) * NO + m - NH]);
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
      for (int m = lo; m < hi; ++m) ds[n][m] = q(a[n][m] * (ds[n][m] - dot));
    }
  }
  __syncthreads();
  for (int i = tid; i < E * width; i += kThreads) {
    const int j = i / width, kk = i % width, k = c0 + kk;
    // Score gradients: j as receiver and as sender.
    float g = 0.f;
    for (int m = 0; m < E; ++m) g = fmaf(ds[j][m] + ds[m][j], st_s[m * kSliceColumns + kk], g);
    // dm of the two edges j sends: to the humans (offset 0 of their dmsgs
    // for a human sender, H for an object sender) and to the objects.
    const int half = j < NH ? 0 : H;
    float dm_h = 0.f, dm_o = 0.f;
    for (int n = 0; n < NH; ++n) dm_h = fmaf(a[n][j], dm_s[(size_t)n * 2 * H + half + k], dm_h);
    for (int n = NH; n < E; ++n) dm_o = fmaf(a[n][j], dm_s[(size_t)n * 2 * H + half + k], dm_o);
    dm_h = m_s[(size_t)j * 2 * H + k] > 0.f ? dm_h : 0.f;
    dm_o = m_s[(size_t)j * 2 * H + H + k] > 0.f ? dm_o : 0.f;
    if (j < NH) {
      const size_t o = at(s, T_, B * NH, b * NH + j, 2 * H);
      x.dpre_h[o + k] = from_f32<T>(dm_h);             // edge hh
      x.dpre_h[o + H + k] = from_f32<T>(dm_o);         // edge ho
      x.attc_h[((size_t)s.d * B * NH + b * NH + j) * H + k] = scale * g;
    } else {
      const size_t o = at(s, T_, B * NO, b * NO + j - NH, 2 * H);
      x.dpre_o[o + k] = from_f32<T>(dm_h);             // edge oh
      x.dpre_o[o + H + k] = from_f32<T>(dm_o);         // edge oo
      x.attc_o[((size_t)s.d * B * NO + b * NO + j - NH) * H + k] = scale * g;
    }
  }
}

size_t att_smem_bytes(int E, int H) {
  return ((size_t)E * 4 * H + (size_t)E * kSliceColumns) * sizeof(float);
}

template <class T>
struct CarryArgs {
  const T *dgh, *w_hh, *dpre, *w_from;   // w_from: the cell's first sent edge
  const float* attc;
  T* dh0;
};

// carry = dhz + attc + dgh @ w_hh^T + dpre @ w_from^T (of the sent edges),
// then phase C of the next step from it (or dh0 = carry after the last).
template <class T>
__global__ void __launch_bounds__(kThreads)
segb_carry(CarryArgs<T> hum, CarryArgs<T> obj, CellArgs<T> cell_h, CellArgs<T> cell_o, int T_,
           int B, int NH, int NO, int H, int row_tiles, int step) {
  const Step s = step_of(step, T_);
  const int cell = blockIdx.y / row_tiles;
  const int row0 = (blockIdx.y % row_tiles) * kMaxRows;
  const int unit0 = blockIdx.x * kMTile;
  const int all_rows = B * (cell == 0 ? NH : NO);
  if (row0 >= all_rows) return;
  const int rows = min(kMaxRows, all_rows - row0);
  const CarryArgs<T>& c = cell == 0 ? hum : obj;
  const CellArgs<T>& cb = cell == 0 ? cell_h : cell_o;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float du_s[kMaxRows][kMTile + 1];
  float acc[1][kNTiles][4] = {};
  const T* dpre = c.dpre + at(s, T_, all_rows, row0, 2 * H);
  const OperandT<T, T> rec = {c.dgh + at(s, T_, all_rows, row0, 3 * H), 3 * H,
                              c.w_hh + (size_t)s.d * H * 3 * H, 3 * H, 3 * H};
  const OperandT<T, T> snd0 = {dpre, 2 * H, c.w_from, H, H};
  const OperandT<T, T> snd1 = {dpre + H, 2 * H, c.w_from + (size_t)H * H, H, H};
  const Tiles tiles = {{unit0, 0, 0}, {min(kMTile, H - unit0), 0, 0}};
  accumulate<true, 1, 1, 3, OneSlot>(rec, snd0, snd1, tiles, rows, smem, acc);
  store_partials<1>(smem, acc);
  __syncthreads();
  const bool last = step + 1 == T_;
  const Step next = step_of(step + 1, T_);
  for (int p = threadIdx.x; p < kMTile * kMaxRows; p += kThreads) {
    const int cc = p % kMTile, r = p / kMTile;
    const int row = row0 + r, unit = unit0 + cc;
    float du = 0.f;
    if (r < rows && unit < H) {
      const size_t hs = ((size_t)s.d * all_rows + row) * H + unit;
      const float carry = cb.dhz[hs] + c.attc[hs] + reduce<1>(smem, 0, cc, r);
      if (last)
        c.dh0[hs] = from_f32<T>(carry);
      else
        du = cell_bwd(cb, next, T_, all_rows, row, unit, H, carry);
    }
    du_s[r][cc] = du;
  }
  if (!last) store_du(cb, next, T_, all_rows, row0, rows, du_s);
}

// ---- bfloat16 at h <= 512: two launches a step ----------------------------------
//
// See the note at the top. Both kernels are bfloat16 only; their products
// are segb_dmsgs's and segb_carry's (tc_gemm.cuh, the same tiles, depth
// order and sums), so every output has the per-step route's bits.

namespace cl = tggcn::gru;
namespace wg = tggcn::wg;

constexpr int kMaxClusterBlocks = 16;
constexpr int kDmStride = 2 * kMTile;                   // a row of a DA block's dmsgs tile

// DA's dynamic shared memory: the ring of its products (then the object
// rows' partial sums), the human rows' partial sums (then the gathered
// dmsgs rows and their da), and the dmsgs tile the cluster reads.
constexpr size_t kDAPart = smem_bytes<true, 2, 2, kStages, bf16, bf16>();
constexpr size_t kDADm = kDAPart + sizeof(Partials<2>);
constexpr size_t kDAAtt = kDADm + (size_t)2 * kMaxRows * kDmStride * sizeof(float);
// dpre's inputs, copied while the products run: the tile's attention (at
// most 64 / E clips of E x E) and its senders' messages at the block's
// columns (at most 32 senders, both halves).
constexpr size_t kDAMask = kDAAtt + (size_t)4 * kMaxRows * kMaxEntities * sizeof(float);
constexpr size_t kDASmem = kDAMask + (size_t)kMaxRows * 2 * kDmStride * sizeof(float);
// R's: the ring of its product (then its partial sums), then attc's inputs
// for the clips of its rows (ds_s, hp_s).
constexpr size_t kRDs = smem_bytes<true, 1, 1, kStages, bf16, bf16>();
constexpr size_t kRHp = kRDs + (size_t)kMaxRows * kMaxEntities * kMaxEntities * sizeof(float);
constexpr size_t kRSmem = kRHp + (size_t)kMaxRows * kMaxEntities * kMTile * sizeof(bf16);

template <class T>                      // bf16 (the element type names the kernels' variant)
struct DAArgs {
  const T *dgi_h, *dgi_o, *w_msg_h, *w_msg_o, *g_att;
  const float *m_h, *m_o, *atts;
  T *dpre_h, *dpre_o;
  float* ds;                            // (2, B, E, E): the score gradients
};

// DA of one step. A cluster is one (direction, sender group, batch tile):
// block `rank` takes dmsgs columns grp * h + 32 rank .. + 31 of every row
// of both cells in the tile (two products, 3h deep, against each cell's
// w_msg, as segb_dmsgs takes them), then from its columns dpre of the
// group's senders for both receiver cells; then each block gathers the
// full group half of its share of the receivers' dmsgs rows from the
// cluster's tiles (distributed shared memory) and takes da over it, in
// segb_att's order, and the softmax backward of the group, into ds.
__global__ void __launch_bounds__(kThreads, 1)
segb_dmsgs_att(DAArgs<bf16> x, int T_, int B, int NH, int NO, int H, int nb, int step) {
  const auto q = [](float v) { return round_to<bf16>(v); };
  const Step s = step_of(step, T_);
  const int C = gridDim.x, rank = blockIdx.x, tid = threadIdx.x;
  const int grp = blockIdx.y % 2, b0 = blockIdx.y / 2 * nb, nbt = min(nb, B - b0);
  const int E = NH + NO, Ng = grp == 0 ? NH : NO, col0 = 2 * kMTile * rank;
  const int rows_h = nbt * NH, rows_o = nbt * NO;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* part_h = smem + kDAPart;
  const size_t wd = (size_t)s.d * 2 * H * 3 * H;
  const Tiles tiles = {{grp * H + col0, grp * H + col0 + kMTile, 0},
                       {max(0, min(kMTile, H - col0)), max(0, min(kMTile, H - col0 - kMTile)), 0}};
  float* att_s = reinterpret_cast<float*>(smem + kDAAtt);     // (nbt, E, E)
  float* mask_s = reinterpret_cast<float*>(smem + kDAMask);   // (nbt * Ng, 2, 32)
  const float* msg = grp == 0 ? x.m_h : x.m_o;
  // The human rows' product, then the object rows', through one ring: the
  // human sums go to part_h once their last stage is multiplied.
  float acc[2][kNTiles][4] = {};
  OperandT<bf16, bf16> hum = {x.dgi_h + at(s, T_, B * NH, b0 * NH, 3 * H), 3 * H,
                              x.w_msg_h + wd, 3 * H, 3 * H};
  OperandT<bf16, bf16> obj = {x.dgi_o + at(s, T_, B * NO, b0 * NO, 3 * H), 3 * H,
                              x.w_msg_o + wd, 3 * H, 3 * H};
  hum.rows = rows_h;
  obj.rows = rows_o;
  accumulate<true, 2, 2, 2, TileSlots>(
      hum, obj, obj, tiles, rows_o, smem, acc,
      [&] {
        // Copied with the product's next stage (the copies join its group).
        for (int p = tid; p < nbt * E * E; p += kThreads)
          cp_async4(att_s + p, x.atts + at(s, T_, B, b0, E * E) + p);
        for (int p = tid; p < nbt * Ng * 2 * (kDmStride / 4); p += kThreads) {
          const int sr = p / (2 * (kDmStride / 4)), half = p / (kDmStride / 4) % 2;
          const int k = col0 + p % (kDmStride / 4) * 4;
          const bool valid = k < H;
          const float* src = msg + at(s, T_, B * Ng, b0 * Ng + sr, 2 * H) + half * H + k;
          cp_async16(mask_s + (sr * 2 + half) * kDmStride + k - col0, valid ? src : msg, valid);
        }
      },
      [&] {
        store_partials<2>(part_h, acc);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < kNTiles; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
      });
  store_partials<2>(smem, acc);
  __syncthreads();

  // The block's dmsgs tile: rows 0..31 the human rows, 32..63 the object
  // rows, 32 columns; rounded to bfloat16 as segb_dmsgs rounds it.
  float* dm = reinterpret_cast<float*>(smem + kDADm);
  for (int p = tid; p < 2 * 2 * kMTile * kMaxRows; p += kThreads) {
    const int cell = p / (2 * kMTile * kMaxRows), i = p % (2 * kMTile * kMaxRows);
    const int t = i / (kMTile * kMaxRows), cc = i % kMTile, r = (i / kMTile) % kMaxRows;
    const int col = col0 + t * kMTile + cc;
    float v = 0.f;
    if (r < (cell == 0 ? rows_h : rows_o) && col < H)
      v = q(reduce<2>(cell == 0 ? part_h : smem, t, cc, r));
    dm[(cell * kMaxRows + r) * kDmStride + t * kMTile + cc] = v;
  }
  __syncthreads();
  cl::cluster_arrive();                 // the tile is ready for the cluster

  // This block's receivers (rank, rank + C, ... of the tile's human rows,
  // then its object rows) and, copied now into the free ring for their da,
  // the messages of the group's senders to them.
  const int nrecv = rows_h + rows_o;
  const int mine = rank < nrecv ? (nrecv - rank + C - 1) / C : 0;
  float* msg_s = reinterpret_cast<float*>(smem);  // (mine, Ng, H)
  for (int p = tid; p < mine * Ng * (H / 4); p += kThreads) {
    const int li = p / (Ng * (H / 4)), m = p / (H / 4) % Ng, k = p % (H / 4) * 4;
    const int ri = rank + C * li;
    const int cell = ri < rows_h ? 0 : 1, r = cell == 0 ? ri : ri - rows_h;
    const int b = b0 + r / (cell == 0 ? NH : NO);
    cp_async16(msg_s + ((size_t)li * Ng + m) * H + k,
               msg + at(s, T_, B * Ng, b * Ng + m, 2 * H) + cell * H + k, true);
  }
  cp_async_commit();

  // dpre of the group's senders at this block's columns, as segb_att takes
  // it: dm of the edges to the humans and to the objects, masked by the
  // ReLU of the messages K3 kept.
  bf16* dpre = grp == 0 ? x.dpre_h : x.dpre_o;
  for (int p = tid; p < nbt * Ng * 2 * kMTile; p += kThreads) {
    const int kk = p % (2 * kMTile), j = p / (2 * kMTile) % Ng, bl = p / (2 * kMTile * Ng);
    const int k = col0 + kk, b = b0 + bl, je = grp == 0 ? j : NH + j;
    if (k >= H) continue;
    const float* a = att_s + bl * E * E + je;
    float dm_h = 0.f, dm_o = 0.f;
    for (int n = 0; n < NH; ++n)
      dm_h = fmaf(q(a[n * E]), dm[(bl * NH + n) * kDmStride + kk], dm_h);
    for (int n = 0; n < NO; ++n)
      dm_o = fmaf(q(a[(NH + n) * E]), dm[(kMaxRows + bl * NO + n) * kDmStride + kk], dm_o);
    const size_t o = at(s, T_, B * Ng, b * Ng + j, 2 * H);
    const float* mask = mask_s + (bl * Ng + j) * 2 * kDmStride + kk;
    dm_h = mask[0] > 0.f ? dm_h : 0.f;
    dm_o = mask[kDmStride] > 0.f ? dm_o : 0.f;
    dpre[o + k] = from_f32<bf16>(dm_h);         // edge hh or oh
    dpre[o + H + k] = from_f32<bf16>(dm_o);     // edge ho or oo
  }
  cl::cluster_wait();

  // The receivers' dmsgs rows' group half, gathered from the cluster's
  // tiles over the human partial sums, which are read.
  float* rowbuf = reinterpret_cast<float*>(part_h);
  float* da = rowbuf + (size_t)mine * H;          // (mine, kMaxEntities)
  const uint32_t dm_addr = cl::smem_u32(dm);
  constexpr int kVec = kDmStride / 4;             // 16-byte loads a tile row
  for (int p = tid; p < mine * C * kVec; p += kThreads) {
    const int li = p / (C * kVec), peer = p / kVec % C, v = p % kVec;
    const int ri = rank + C * li;
    const int r = ri < rows_h ? ri : kMaxRows + ri - rows_h;
    const int col = 2 * kMTile * peer + 4 * v;
    if (col < H)
      *reinterpret_cast<float4*>(rowbuf + (size_t)li * H + col) = cl::ld_cluster4(
          cl::map_rank(dm_addr + (uint32_t)((r * kDmStride + 4 * v) * sizeof(float)), peer));
  }
  cp_async_wait<0>();
  __syncthreads();
  cl::cluster_arrive();                 // this block has read the cluster's tiles
  const int warp = tid / 32, lane = tid % 32;
  for (int p = warp; p < mine * Ng; p += kWarps) {
    const int li = p / Ng, m = p % Ng, ri = rank + C * li;
    const int cell = ri < rows_h ? 0 : 1, r = cell == 0 ? ri : ri - rows_h;
    const int Nc = cell == 0 ? NH : NO, b = b0 + r / Nc, n = r % Nc;
    const float* dr = rowbuf + (size_t)li * H;
    const float* mr = msg_s + ((size_t)li * Ng + m) * H;
    float dot = 0.f;
    for (int k = lane; k < H; k += 32) dot = fmaf(dr[k], q(mr[k]), dot);
    for (int off = 16; off > 0; off /= 2) dot += __shfl_down_sync(0xffffffffu, dot, off);
    if (lane == 0) {
      if (cell == 0 && grp == 1) dot += to_f32(x.g_att[(at(s, T_, B, b, NH) + n) * NO + m]);
      da[li * kMaxEntities + m] = dot;
    }
  }
  __syncthreads();
  if (tid < mine) {                     // the softmax backward of the group
    const int ri = rank + C * tid;
    const int cell = ri < rows_h ? 0 : 1, r = cell == 0 ? ri : ri - rows_h;
    const int Nc = cell == 0 ? NH : NO, b = b0 + r / Nc, ne = (cell == 0 ? 0 : NH) + r % Nc;
    const int m0 = grp == 0 ? 0 : NH;
    const float* a = x.atts + at(s, T_, B, b, E * E) + ne * E + m0;
    float* ds = x.ds + (((size_t)s.d * B + b) * E + ne) * E + m0;
    const float* d = da + tid * kMaxEntities;
    float dot = 0.f;
    for (int m = 0; m < Ng; ++m) dot += d[m] * q(a[m]);
    for (int m = 0; m < Ng; ++m) ds[m] = q(q(a[m]) * (d[m] - dot));
  }
  cl::cluster_wait();                   // no block reads this block's tile any more
}

template <class T>                      // bf16, as DAArgs
struct RArgs {
  const T *dgh_h, *dgh_o, *dpre_h, *dpre_o, *w_hh_h, *w_hh_o, *w_from, *hprev_h, *hprev_o;
  const float* ds;
  T *dh0_h, *dh0_o;
};

// Phase C's inputs issued where they stand (wg::load_now), the bfloat16
// ones as raw bits.
struct CellRaw {
  float r, z, n, hn;
  uint16_t hprev, g, u;
};

__device__ __forceinline__ CellRaw cell_load_now(const CellArgs<bf16>& c, Step s, int T_,
                                                 int rows, int row, int unit, int H) {
  const float* gr = c.gates + at(s, T_, rows, row, 4 * H);
  const size_t hi = at(s, T_, rows, row, H) + unit;
  return {wg::load_now(gr + unit), wg::load_now(gr + H + unit), wg::load_now(gr + 2 * H + unit),
          wg::load_now(gr + 3 * H + unit), wg::load_now(c.hprev + hi), wg::load_now(c.g + hi),
          wg::load_now(c.u + (size_t)s.t * rows + row)};
}

// R of one step: segb_carry's product and epilogue, with attc taken here
// from ds and the step's states in segb_att's order. As soon as the
// product's first copies are issued, the block copies attc's inputs into
// shared memory and each thread (one row and unit) issues its loads of
// dhz and of the next step's phase C, so that they land while the copies
// run.
__global__ void __launch_bounds__(kThreads)
segb_carry_ds(RArgs<bf16> x, CellArgs<bf16> cell_h, CellArgs<bf16> cell_o, int T_, int B,
              int NH, int NO, int H, int row_tiles, float scale, int step) {
  const Step s = step_of(step, T_);
  const int cell = blockIdx.y / row_tiles;
  const int row0 = (blockIdx.y % row_tiles) * kMaxRows;
  const int unit0 = blockIdx.x * kMTile;
  const int all_rows = B * (cell == 0 ? NH : NO);
  if (row0 >= all_rows) return;
  const int rows = min(kMaxRows, all_rows - row0);
  const CellArgs<bf16>& cb = cell == 0 ? cell_h : cell_o;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float du_s[kMaxRows][kMTile + 1];
  // attc's inputs for the tile's clips: their ds (E x E each) and their
  // entities' states at the block's units.
  float(*ds_s)[kMaxEntities * kMaxEntities] =
      reinterpret_cast<float(*)[kMaxEntities * kMaxEntities]>(smem + kRDs);
  bf16(*hp_s)[kMaxEntities][kMTile] = reinterpret_cast<bf16(*)[kMaxEntities][kMTile]>(smem + kRHp);
  const bf16* dpre = (cell == 0 ? x.dpre_h : x.dpre_o) + at(s, T_, all_rows, row0, 2 * H);
  const bf16* w_from = x.w_from + (size_t)2 * cell * H * H;
  const OperandT<bf16, bf16> rec = {
      (cell == 0 ? x.dgh_h : x.dgh_o) + at(s, T_, all_rows, row0, 3 * H), 3 * H,
      (cell == 0 ? x.w_hh_h : x.w_hh_o) + (size_t)s.d * H * 3 * H, 3 * H, 3 * H};
  const OperandT<bf16, bf16> snd0 = {dpre, 2 * H, w_from, H, H};
  const OperandT<bf16, bf16> snd1 = {dpre + H, 2 * H, w_from + (size_t)H * H, H, H};
  const Tiles tiles = {{unit0, 0, 0}, {min(kMTile, H - unit0), 0, 0}};
  const int cc = threadIdx.x % kMTile, r = threadIdx.x / kMTile;
  const int row = row0 + r, unit = unit0 + cc;
  const bool live = r < rows && unit < H, last = step + 1 == T_;
  const Step next = step_of(step + 1, T_);
  const size_t hs = ((size_t)s.d * all_rows + row) * H + unit;
  float pre = 0.f;
  CellRaw in = {};
  float acc[1][kNTiles][4] = {};
  const int Nc = cell == 0 ? NH : NO, E = NH + NO, b0 = row0 / Nc;
  const int nbat = (row0 + rows - 1) / Nc - b0 + 1;
  accumulate<true, 1, 1, 3, OneSlot>(rec, snd0, snd1, tiles, rows, smem, acc, [&] {
    // Copied with the product's next stage (the copies join its group).
    for (int p = threadIdx.x; p < nbat * E * E; p += kThreads)
      cp_async4(&ds_s[p / (E * E)][p % (E * E)],
                x.ds + ((size_t)s.d * B + b0 + p / (E * E)) * E * E + p % (E * E));
    for (int p = threadIdx.x; p < nbat * E * 2; p += kThreads) {
      const int bl = p / (2 * E), m = p / 2 % E, half = p % 2;
      const int b = b0 + bl;
      const bf16* hp = m < NH ? x.hprev_h + at(s, T_, B * NH, b * NH + m, H)
                              : x.hprev_o + at(s, T_, B * NO, b * NO + m - NH, H);
      const bool valid = unit0 + 8 * half < H;
      cp_async16(&hp_s[bl][m][8 * half], valid ? hp + unit0 + 8 * half : hp, valid);
    }
    if (!live) return;
    pre = wg::load_now(cb.dhz + hs);
    if (!last) in = cell_load_now(cb, next, T_, all_rows, row, unit, H);
  });
  store_partials<1>(smem, acc);
  __syncthreads();
  float du = 0.f;
  if (live) {
    // attc = scale g, rounded on its own as segb_att stores it, in
    // segb_att's order; then dhz + attc.
    const int bl = row / Nc - b0, je = (cell == 0 ? 0 : NH) + row % Nc;
    const float* ds = ds_s[bl];
    float g = 0.f;
    for (int m = 0; m < E; ++m)
      g = fmaf(ds[je * E + m] + ds[m * E + je], to_f32(hp_s[bl][m][cc]), g);
    pre = __fadd_rn(pre, __fmul_rn(scale, g));
    const float carry = pre + reduce<1>(smem, 0, cc, r);
    if (last)
      (cell == 0 ? x.dh0_h : x.dh0_o)[hs] = from_f32<bf16>(carry);
    else
      du = cell_bwd(cb, next, T_, all_rows, row, unit, H, carry,
                    CellIn{in.r, in.z, in.n, in.hn, wg::widen(in.hprev), wg::widen(in.g),
                           wg::widen(in.u)});
  }
  du_s[r][cc] = du;
  if (!last) store_du(cb, next, T_, all_rows, row0, rows, du_s);
}

// The bfloat16 two-launch route's plan at (B, NH, NO, H), into
// out[kPlanInts]: 1 if the shape takes it (else 0: the per-step route),
// DA's blocks a cluster, clusters a step and dynamic shared memory, R's
// blocks a step and dynamic shared memory, the batch tile of a DA cluster,
// and a slot for the most DA clusters the card holds at once.
constexpr int kPlanInts = 8;

void cluster_plan(int B, int NH, int NO, int H, int* out) {
  const int most = NH > NO ? NH : NO;
  const bool ok = NH >= 1 && NO >= 1 && NH + NO <= kMaxEntities && H % 8 == 0 && H > 0 &&
                  H <= kMaxClusterBlocks * 2 * kMTile && B >= 1;
  const int nb = ok ? kMaxRows / most : 0;
  out[0] = ok;
  out[1] = ok ? (H + 2 * kMTile - 1) / (2 * kMTile) : 0;
  out[2] = ok ? 2 * 2 * ((B + nb - 1) / nb) : 0;
  out[3] = ok ? (int)kDASmem : 0;
  out[4] = ok ? 2 * ((H + kMTile - 1) / kMTile) *
                    ((B * NH + kMaxRows - 1) / kMaxRows + (B * NO + kMaxRows - 1) / kMaxRows)
              : 0;
  out[5] = ok ? (int)kRSmem : 0;
  out[6] = nb;
  out[7] = -1;
}

int run_cluster(const bf16* u_h, const bf16* u_o, const bf16* hprev_h, const bf16* hprev_o,
                const float* m_h, const float* m_o, const float* gates_h, const float* gates_o,
                const float* atts, const bf16* g_h, const bf16* g_o, const bf16* g_att,
                const bf16* w_from, const bf16* w_msg_h, const bf16* w_msg_o, const bf16* w_hh_h,
                const bf16* w_hh_o, bf16* dgi_h, bf16* dgi_o, bf16* dgh_h, bf16* dgh_o,
                bf16* dpre_h, bf16* dpre_o, bf16* du_h, bf16* du_o, bf16* dh0_h, bf16* dh0_o,
                float* du_part_h, float* du_part_o, float* dhz_h, float* dhz_o, float* ds,
                int T_, int B, int NH, int NO, int H, float scale, cudaStream_t stream) {
  int plan[kPlanInts];
  cluster_plan(B, NH, NO, H, plan);
  if (!plan[0] || T_ < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int C = plan[1], nb = plan[6];
  const int units = (H + kMTile - 1) / kMTile;
  const int row_tiles = (B * (NH > NO ? NH : NO) + kMaxRows - 1) / kMaxRows;
  cudaError_t err = cl::prepare_cluster(segb_dmsgs_att, kDASmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(segb_carry_ds, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kRSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CellArgs<bf16> cell_h = {u_h, hprev_h, g_h, gates_h, dgi_h, dgh_h, du_part_h, dhz_h};
  const CellArgs<bf16> cell_o = {u_o, hprev_o, g_o, gates_o, dgi_o, dgh_o, du_part_o, dhz_o};
  const DAArgs<bf16> da = {dgi_h, dgi_o, w_msg_h, w_msg_o, g_att, m_h, m_o, atts,
                           dpre_h, dpre_o, ds};
  const RArgs<bf16> ra = {dgh_h, dgh_o, dpre_h, dpre_o, w_hh_h, w_hh_o, w_from, hprev_h, hprev_o,
                          ds, dh0_h, dh0_o};
  const dim3 grid_c(units, 2 * row_tiles, 2);
  segb_cell<bf16><<<grid_c, kThreads, 0, stream>>>(cell_h, cell_o, T_, B, NH, NO, H, row_tiles);
  for (int step = 0; step < T_; ++step) {
    // DA's grid: (rank, (tile, group), direction), a cluster along x.
    err = cl::launch_cluster(segb_dmsgs_att, kThreads, C, plan[2] / 2, 2, kDASmem, stream, da,
                             T_, B, NH, NO, H, nb, step);
    if (err == cudaSuccess)
      segb_carry_ds<<<grid_c, kThreads, kRSmem, stream>>>(ra, cell_h, cell_o, T_, B, NH, NO, H,
                                                          row_tiles, scale, step);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_h = 2 * T_ * B * NH, n_o = 2 * T_ * B * NO;
  du_sum<bf16><<<(n_h + n_o + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      du_part_h, du_part_o, du_h, du_o, n_h, n_o, units);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int run_bwd(const T* u_h, const T* u_o, const T* hprev_h, const T* hprev_o, const float* m_h,
            const float* m_o, const float* gates_h, const float* gates_o, const float* atts,
            const T* g_h, const T* g_o, const T* g_att, const T* w_from, const T* w_msg_h,
            const T* w_msg_o, const T* w_hh_h, const T* w_hh_o, T* dgi_h, T* dgi_o, T* dgh_h,
            T* dgh_o, T* dpre_h, T* dpre_o, T* du_h, T* du_o, T* dh0_h, T* dh0_o,
            float* du_part_h, float* du_part_o, float* dhz_h, float* dhz_o, float* dmsgs_h,
            float* dmsgs_o, float* attc_h, float* attc_o, int T_, int B, int NH, int NO, int H,
            float scale, cudaStream_t stream) {
  const size_t smem_a = att_smem_bytes(NH + NO, H);
  if (NH + NO > kMaxEntities || H % (16 / (int)sizeof(T)) != 0 || T_ < 1 ||
      smem_a > kMaxAttSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_d = smem_bytes<true, 2, 2, kStages, T, T>();
  const size_t smem_r = smem_bytes<true, 1, 1, kStages, T, T>();
  cudaError_t err = cudaFuncSetAttribute(segb_dmsgs<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_d);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(segb_carry<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_r);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(segb_att<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int max_rows = B * (NH > NO ? NH : NO);
  const int row_tiles = (max_rows + kMaxRows - 1) / kMaxRows;
  const int col_tiles = (H + kMTile - 1) / kMTile;
  const dim3 grid_c(col_tiles, 2 * row_tiles, 2);
  const dim3 grid_d((2 * H + 2 * kMTile - 1) / (2 * kMTile), 2 * row_tiles, 2);
  const dim3 grid_a(B, (H + kSliceColumns - 1) / kSliceColumns, 2);
  const CellArgs<T> cell_h = {u_h, hprev_h, g_h, gates_h, dgi_h, dgh_h, du_part_h, dhz_h};
  const CellArgs<T> cell_o = {u_o, hprev_o, g_o, gates_o, dgi_o, dgh_o, du_part_o, dhz_o};
  const AttArgs<T> att = {hprev_h, hprev_o, g_att, m_h, m_o, atts, dmsgs_h, dmsgs_o,
                          dpre_h, dpre_o, attc_h, attc_o};
  const CarryArgs<T> carry_h = {dgh_h, w_hh_h, dpre_h, w_from, attc_h, dh0_h};
  const CarryArgs<T> carry_o = {dgh_o, w_hh_o, dpre_o, w_from + (size_t)2 * H * H, attc_o, dh0_o};
  segb_cell<T><<<grid_c, kThreads, 0, stream>>>(cell_h, cell_o, T_, B, NH, NO, H, row_tiles);
  for (int step = 0; step < T_; ++step) {
    segb_dmsgs<T><<<grid_d, kThreads, smem_d, stream>>>(dgi_h, dgi_o, w_msg_h, w_msg_o, dmsgs_h,
                                                       dmsgs_o, T_, B, NH, NO, H, row_tiles, step);
    segb_att<T><<<grid_a, kThreads, smem_a, stream>>>(att, T_, B, NH, NO, H, scale, step);
    segb_carry<T><<<grid_c, kThreads, smem_r, stream>>>(carry_h, carry_o, cell_h, cell_o, T_, B,
                                                       NH, NO, H, row_tiles, step);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_h = 2 * T_ * B * NH, n_o = 2 * T_ * B * NO;
  du_sum<T><<<(n_h + n_o + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      du_part_h, du_part_o, du_h, du_o, n_h, n_o, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs the whole backward sweep, both directions: C of the first step, then
// per step the launches D, A, R on `stream`, in order, then du_sum. gates
// (2, T, B * NH or NO, 4H) and atts (2, T, B, E, E) are K3's kept tensors.
// du_part_h and du_part_o take (2, T, B * NH or NO, ceil(H / 16)) partials;
// dhz, dmsgs and attc are one step's scratch per direction. Returns the
// first CUDA error of a launch, else 0. H % 4 == 0, NH + NO <= 16 and
// (NH + NO) * (4H + 64) * 4 bytes <= 224 KB.
extern "C" int tggcn_segment_scan_dot_bwd_f32(
    const float* u_h, const float* u_o, const float* hprev_h, const float* hprev_o,
    const float* m_h, const float* m_o, const float* gates_h, const float* gates_o,
    const float* atts, const float* g_h, const float* g_o, const float* g_att,
    const float* w_from, const float* w_msg_h, const float* w_msg_o, const float* w_hh_h,
    const float* w_hh_o, float* dgi_h, float* dgi_o, float* dgh_h, float* dgh_o,
    float* dpre_h, float* dpre_o, float* du_h, float* du_o, float* dh0_h, float* dh0_o,
    float* du_part_h, float* du_part_o, float* dhz_h, float* dhz_o, float* dmsgs_h,
    float* dmsgs_o, float* attc_h, float* attc_o, int T, int B, int NH, int NO, int H,
    float scale, void* stream_ptr) {
  return run_bwd<float>(u_h, u_o, hprev_h, hprev_o, m_h, m_o, gates_h, gates_o, atts, g_h, g_o,
                        g_att, w_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o, dgi_h, dgi_o, dgh_h,
                        dgh_o, dpre_h, dpre_o, du_h, du_o, dh0_h, dh0_o, du_part_h, du_part_o,
                        dhz_h, dhz_o, dmsgs_h, dmsgs_o, attc_h, attc_o, T, B, NH, NO, H, scale,
                        static_cast<cudaStream_t>(stream_ptr));
}

// The same in bfloat16 IO: m_h, m_o, gates and atts (K3's kept) and the
// scratch float32, every other tensor bfloat16. H % 8 == 0. With cluster
// = 1 the cluster route (two cluster launches a step; the shape must take
// it: tggcn_segment_scan_dot_bwd_plan), which reads ds (2, B, E, E) and
// neither dmsgs nor attc; with cluster = 0 the per-step route, which reads
// dmsgs and attc and not ds.
extern "C" int tggcn_segment_scan_dot_bwd_bf16(
    const bf16* u_h, const bf16* u_o, const bf16* hprev_h, const bf16* hprev_o,
    const float* m_h, const float* m_o, const float* gates_h, const float* gates_o,
    const float* atts, const bf16* g_h, const bf16* g_o, const bf16* g_att,
    const bf16* w_from, const bf16* w_msg_h, const bf16* w_msg_o, const bf16* w_hh_h,
    const bf16* w_hh_o, bf16* dgi_h, bf16* dgi_o, bf16* dgh_h, bf16* dgh_o, bf16* dpre_h,
    bf16* dpre_o, bf16* du_h, bf16* du_o, bf16* dh0_h, bf16* dh0_o, float* du_part_h,
    float* du_part_o, float* dhz_h, float* dhz_o, float* dmsgs_h, float* dmsgs_o,
    float* attc_h, float* attc_o, float* ds, int cluster, int T, int B, int NH, int NO, int H,
    float scale, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (cluster)
    return run_cluster(u_h, u_o, hprev_h, hprev_o, m_h, m_o, gates_h, gates_o, atts, g_h, g_o,
                       g_att, w_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o, dgi_h, dgi_o, dgh_h,
                       dgh_o, dpre_h, dpre_o, du_h, du_o, dh0_h, dh0_o, du_part_h, du_part_o,
                       dhz_h, dhz_o, ds, T, B, NH, NO, H, scale, stream);
  return run_bwd<bf16>(u_h, u_o, hprev_h, hprev_o, m_h, m_o, gates_h, gates_o, atts, g_h, g_o,
                       g_att, w_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o, dgi_h, dgi_o, dgh_h,
                       dgh_o, dpre_h, dpre_o, du_h, du_o, dh0_h, dh0_o, du_part_h, du_part_o,
                       dhz_h, dhz_o, dmsgs_h, dmsgs_o, attc_h, attc_o, T, B, NH, NO, H, scale,
                       stream);
}

// The bfloat16 two-launch route's plan at (B, NH, NO, H) into out[8] (see
// cluster_plan), with, if occupancy and on that route, the most DA
// clusters the card holds at once (cudaOccupancyMaxActiveClusters; else
// -1).
// Returns a CUDA error code (0 on success).
extern "C" int tggcn_segment_scan_dot_bwd_plan(int B, int NH, int NO, int H, int occupancy,
                                               int* out) {
  cluster_plan(B, NH, NO, H, out);
  if (!out[0] || !occupancy) return 0;
  return static_cast<int>(
      cl::max_active_clusters(segb_dmsgs_att, kThreads, out[1], kDASmem, &out[7]));
}
