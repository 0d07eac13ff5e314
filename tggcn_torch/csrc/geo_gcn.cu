// K6: the fused GeoGCN block of the 2G-GCN, after its BatchNorm.
//
// Replaces the TPU kernel tggcn/ops/geo_gcn_pallas.py::_kernel (launched by
// _geo_gcn_fused_impl, geo_gcn_pallas.py:100), which keeps every weight
// resident in VMEM and walks tiles of 16 frames as its grid:
//
//   x (V, 4) -> h1 = relu(x w1 + b1) (V, 64) -> h = relu(h1 w2 + b2) (V, 64)
//   -> s1 = h ws1 + bs1, s2 = h ws2 + bs2 (V, 128) -> scores = s1 s2^T (V, V)
//   -> row softmax (plain, no mask, as geo_gcn_pallas.py:51) -> A
//   -> mixed = A h (V, 64) -> out = mixed w_out (V, 128), to device memory.
//
// Here one launch covers the N = batch * time frames, one warp a frame.
// A block of kWarps = 12 warps copies the weights into shared memory once
// (cp.async, every copy in flight at once); warp w of block b then takes
// the frames f = w * gridDim.x + b + i * 12 * gridDim.x, so a block runs up
// to 12 frames at a time (V <= 32 rows each, padded to 32: two m16 tiles,
// the rows of x past V read as zero).
// The grid is min(N, SMs) blocks: at N = 1336 frames on the 132 SMs of an
// H100 every warp takes at most one frame, 10 or 11 a block, in one wave.
//
// Every product runs on the tensor cores, mma.sync m16n8k8 in TF32 with the
// 3xTF32 split of tc_gemm.cuh (float32 accuracy), its sums in registers:
//   h      h1's 8-column tiles are made one at a time (depth 4, padded to 8)
//          and fed straight into h's sums (depth 64);
//   scores for each 8-column slab j of the 128 similarity columns, s1_j =
//          h ws1[:, j] + bs1[j] and s2_j (32 x 8, depth 64), then scores +=
//          s1_j s2_j^T (depth 8): s1 and s2 never exist whole;
//   A      the row softmax over the V real columns, in the score registers
//          (columns past V weigh exactly 0, so the padded rows of h, which
//          hold relu of the biases, carry no weight);
//   mixed  A h (depth 32), h read back from the warp's buffer;
//   out    mixed w_out (depth 64), 32 columns at a time, rows < V stored.
// An accumulator fragment is the next product's A fragment without a move:
// a thread holds the sums (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1)
// of an 8-column tile (g = lane / 4, q = lane % 4), an A fragment wants
// (g, k), (g + 8, k), (g, k + 4), (g + 8, k + 4) at k = q, and a product's
// depth may run in any order: k = q stands for column 2q of the tile and
// k = q + 4 for column 2q + 1, and the B fragment reads rows 2q and 2q + 1
// (of a weight, or of h) to match. s2_j's accumulator is likewise the B
// fragment of s1_j s2_j^T. Only h goes through shared memory: its rows are
// the depth of A h.
//
// Shared memory: the weights with row strides of 68 and 132 floats (4 mod 32,
// so a B fragment's rows 2q, 2q + 1 and columns g fall on 32 distinct banks),
// 122,496 bytes, and each warp's h (32 x 68 floats, 8,704 bytes): 226,944
// bytes, one block of 384 threads an SM (registers: at most 168 a thread).
// No warp waits for another after the weights are in, and nothing is
// reduced across warps or blocks: each output element is one warp's sum.
//
// Bound on an H100. At the MPHOI shape (N = 8 * 167 = 1336 frames, V = 26)
// the chain does 1.76 MFLOP a frame, 2.4 GFLOP in all: 14 us as 3xTF32 on
// the tensor cores (a third of 495 TFLOP/s), the bound chip_smoke.py holds
// it to; the 17.8 MB of output take 5 us at 3.35 TB/s. Padding V to 32 adds
// 23% to the products; the weights' copy into each block's shared memory is
// a fixed cost a block.

#include "tc_gemm.cuh"

namespace {

namespace tc = tggcn::tc;

constexpr int kWarps = 12;                 // frames a block at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;                  // V padded: two m16 tiles
constexpr int kIn = 4, kEmbed = 64, kSim = 128, kOut = 128;
constexpr int kS64 = kEmbed + 4, kS128 = kSim + 4;   // row strides in floats

// Offsets in shared memory, in floats (each a multiple of 4).
constexpr int kW1 = 0;                               // (8, 64): rows 4-7 zero
constexpr int kW2 = kW1 + 8 * kS64, kWs1 = kW2 + kEmbed * kS64,
              kWs2 = kWs1 + kEmbed * kS128, kWout = kWs2 + kEmbed * kS128,
              kB1 = kWout + kEmbed * kS128, kB2 = kB1 + kEmbed, kBs1 = kB2 + kEmbed,
              kBs2 = kBs1 + kSim, kWeights = kBs2 + kSim;
constexpr int kH = kWeights;                         // each warp's h: kRows x kS64
constexpr int kTotal = kH + kWarps * kRows * kS64;
constexpr size_t kSmemBytes = kTotal * sizeof(float);

// One operand fragment of a 3xTF32 product: its TF32 high parts and
// remainders (tc::split).
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  tc::split(a0, f.hi[0], f.lo[0]);
  tc::split(a1, f.hi[1], f.lo[1]);
  tc::split(a2, f.hi[2], f.lo[2]);
  tc::split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  tc::split(b0, f.hi[0], f.lo[0]);
  tc::split(b1, f.hi[1], f.lo[1]);
  return f;
}

// The A fragment of a depth tile from the accumulator tile c of the product
// before: k = q is the tile's column 2q, k = q + 4 its column 2q + 1.
__device__ __forceinline__ FragA from_acc(const float (&c)[4]) {
  return frag_a(c[0], c[2], c[1], c[3]);
}

// The B fragment of depth tile j (rows 8 j + 2q, 8 j + 2q + 1, to match
// from_acc) and column n0 + g of w, row stride ld.
__device__ __forceinline__ FragB rows_b(const float* w, int ld, int j, int n0) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const float* p = w + (8 * j + 2 * q) * ld + n0 + g;
  return frag_b(p[0], p[ld]);
}

// c += a b at float32 accuracy: the small terms first, as tc_gemm.cuh.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  tc::mma_tf32(c, a.lo, b.hi);
  tc::mma_tf32(c, a.hi, b.lo);
  tc::mma_tf32(c, a.hi, b.hi);
}

// Starts the copy of rows x cols floats of src (row-major, cols % 4 == 0)
// into dst, row stride ld, as 16-byte cp.async copies, all in flight
// together; rows past `rows` up to `padded` are zero-filled.
__device__ __forceinline__ void copy_rows(float* dst, int ld, const float* src, int rows,
                                          int padded, int cols) {
  const int per_row = cols / 4;
  for (int i = threadIdx.x; i < padded * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * 4;
    tc::cp_async16(dst + r * ld + c, r < rows ? src + r * cols + c : src, r < rows);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
geo_gcn_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ ws1,
               const float* __restrict__ bs1, const float* __restrict__ ws2,
               const float* __restrict__ bs2, const float* __restrict__ w_out,
               float* __restrict__ out, int N, int V) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  copy_rows(sm + kW1, kS64, w1, kIn, 8, kEmbed);
  copy_rows(sm + kW2, kS64, w2, kEmbed, kEmbed, kEmbed);
  copy_rows(sm + kWs1, kS128, ws1, kEmbed, kEmbed, kSim);
  copy_rows(sm + kWs2, kS128, ws2, kEmbed, kEmbed, kSim);
  copy_rows(sm + kWout, kS128, w_out, kEmbed, kEmbed, kOut);
  copy_rows(sm + kB1, 0, b1, 1, 1, kEmbed);
  copy_rows(sm + kB2, 0, b2, 1, 1, kEmbed);
  copy_rows(sm + kBs1, 0, bs1, 1, 1, kSim);
  copy_rows(sm + kBs2, 0, bs2, 1, 1, kSim);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, q = lane % 4;
  float* hs = sm + kH + warp * kRows * kS64;
  for (int f = warp * gridDim.x + blockIdx.x; f < N; f += gridDim.x * kWarps) {
    // x's A fragments: depth 4 padded to 8, k = q < 2 standing for columns
    // 2q and 2q + 1 (w1's rows 4-7 are zero for q >= 2).
    const float* xf = x + (size_t)f * V * kIn;
    FragA xa[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r0 = 16 * mt + g, r1 = r0 + 8;
      const bool in0 = q < 2 && r0 < V, in1 = q < 2 && r1 < V;
      xa[mt] = frag_a(in0 ? xf[r0 * kIn + 2 * q] : 0.f, in1 ? xf[r1 * kIn + 2 * q] : 0.f,
                      in0 ? xf[r0 * kIn + 2 * q + 1] : 0.f, in1 ? xf[r1 * kIn + 2 * q + 1] : 0.f);
    }

    // h = relu(h1 w2 + b2), h1 = relu(x w1 + b1) one 8-column tile j at a time.
    float h[2][8][4] = {};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const FragB wb = rows_b(sm + kW1, kS64, 0, 8 * j);
      const float c0 = sm[kB1 + 8 * j + 2 * q], c1 = sm[kB1 + 8 * j + 2 * q + 1];
      FragA ha[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(c, xa[mt], wb);
        const float r[4] = {fmaxf(c[0] + c0, 0.f), fmaxf(c[1] + c1, 0.f), fmaxf(c[2] + c0, 0.f),
                            fmaxf(c[3] + c1, 0.f)};
        ha[mt] = from_acc(r);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const FragB b = rows_b(sm + kW2, kS64, j, 8 * nt);
        mma3(h[0][nt], ha[0], b);
        mma3(h[1][nt], ha[1], b);
      }
    }
    __syncwarp();                       // the frame before has read hs
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float c0 = sm[kB2 + 8 * nt + 2 * q], c1 = sm[kB2 + 8 * nt + 2 * q + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float* c = h[mt][nt];
        c[0] = fmaxf(c[0] + c0, 0.f);
        c[1] = fmaxf(c[1] + c1, 0.f);
        c[2] = fmaxf(c[2] + c0, 0.f);
        c[3] = fmaxf(c[3] + c1, 0.f);
        float* row = hs + (16 * mt + g) * kS64 + 8 * nt + 2 * q;
        *reinterpret_cast<float2*>(row) = make_float2(c[0], c[1]);
        *reinterpret_cast<float2*>(row + 8 * kS64) = make_float2(c[2], c[3]);
      }
    }

    // scores = s1 s2^T over 8-column slabs of the similarity projections.
    float sc[2][4][4] = {};
#pragma unroll 1
    for (int j = 0; j < kSim / 8; ++j) {
      float s1[2][4] = {}, s2[2][4] = {};
#pragma unroll
      for (int k = 0; k < kEmbed / 8; ++k) {
        const FragB p1 = rows_b(sm + kWs1, kS128, k, 8 * j);
        const FragB p2 = rows_b(sm + kWs2, kS128, k, 8 * j);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const FragA a = from_acc(h[mt][k]);
          mma3(s1[mt], a, p1);
          mma3(s2[mt], a, p2);
        }
      }
      const float u0 = sm[kBs1 + 8 * j + 2 * q], u1 = sm[kBs1 + 8 * j + 2 * q + 1];
      const float v0 = sm[kBs2 + 8 * j + 2 * q], v1 = sm[kBs2 + 8 * j + 2 * q + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        s1[mt][0] += u0, s1[mt][1] += u1, s1[mt][2] += u0, s1[mt][3] += u1;
        s2[mt][0] += v0, s2[mt][1] += v1, s2[mt][2] += v0, s2[mt][3] += v1;
      }
      const FragA a0 = from_acc(s1[0]), a1 = from_acc(s1[1]);
#pragma unroll
      for (int wt = 0; wt < 4; ++wt) {   // score columns 8 wt .. 8 wt + 7: s2's rows
        const float* c = s2[wt / 2];
        const FragB b = wt % 2 == 0 ? frag_b(c[0], c[1]) : frag_b(c[2], c[3]);
        mma3(sc[0][wt], a0, b);
        mma3(sc[1][wt], a1, b);
      }
    }

    // The row softmax over the V real columns. Rows 16 mt + g (elements 0,
    // 1) and 16 mt + g + 8 (elements 2, 3); a row's 32 columns lie in the
    // four lanes of a quad.
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = -INFINITY;
#pragma unroll
        for (int wt = 0; wt < 4; ++wt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = sc[mt][wt][2 * half + e];
            if (8 * wt + 2 * q + e >= V) v = -INFINITY;
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float den = 0.f;
#pragma unroll
        for (int wt = 0; wt < 4; ++wt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = sc[mt][wt][2 * half + e];
            v = expf(v - mx);
            den += v;
          }
        den += __shfl_xor_sync(0xffffffffu, den, 1);
        den += __shfl_xor_sync(0xffffffffu, den, 2);
#pragma unroll
        for (int wt = 0; wt < 4; ++wt)
#pragma unroll
          for (int e = 0; e < 2; ++e) sc[mt][wt][2 * half + e] /= den;
      }
    }
    __syncwarp();                       // h is in hs

    // mixed = A h, the nodes as depth.
    float mixed[2][8][4] = {};
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      const FragA a0 = from_acc(sc[0][j]), a1 = from_acc(sc[1][j]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const FragB b = rows_b(hs, kS64, j, 8 * nt);
        mma3(mixed[0][nt], a0, b);
        mma3(mixed[1][nt], a1, b);
      }
    }

    // out = mixed w_out, 32 columns at a time; rows < V to device memory.
    float* of = out + (size_t)f * V * kOut;
#pragma unroll 1
    for (int c = 0; c < kOut / 32; ++c) {
      float o[2][4][4] = {};
#pragma unroll
      for (int k = 0; k < kEmbed / 8; ++k) {
        const FragA a0 = from_acc(mixed[0][k]), a1 = from_acc(mixed[1][k]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const FragB b = rows_b(sm + kWout, kS128, k, 32 * c + 8 * nt);
          mma3(o[0][nt], a0, b);
          mma3(o[1][nt], a1, b);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int r0 = 16 * mt + g, col = 32 * c + 8 * nt + 2 * q;
          if (r0 < V)
            *reinterpret_cast<float2*>(of + (size_t)r0 * kOut + col) =
                make_float2(o[mt][nt][0], o[mt][nt][1]);
          if (r0 + 8 < V)
            *reinterpret_cast<float2*>(of + (size_t)(r0 + 8) * kOut + col) =
                make_float2(o[mt][nt][2], o[mt][nt][3]);
        }
    }
  }
}

// The grid of a launch over N frames: min(N, SMs) blocks.
cudaError_t grid_of(int N, int& blocks) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(geo_gcn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
  blocks = N < sms ? N : sms;
  return err;
}

}  // namespace

// The GeoGCN outputs out (N, V, 128) of the normalised frames x (N, V, 4):
// one launch on `stream`. Returns the CUDA error of the launch, else 0.
// 1 <= V <= 32; every pointer 16-byte aligned.
extern "C" int tggcn_geo_gcn_f32(const float* x, const float* w1, const float* b1,
                                 const float* w2, const float* b2, const float* ws1,
                                 const float* bs1, const float* ws2, const float* bs2,
                                 const float* w_out, float* out, int N, int V,
                                 void* stream_ptr) {
  if (V < 1 || V > kRows || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = grid_of(N, blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  geo_gcn_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream_ptr)>>>(
      x, w1, b1, w2, b2, ws1, bs1, ws2, bs2, w_out, out, N, V);
  return static_cast<int>(cudaGetLastError());
}

// The launch over N frames: out[0] the frames a block runs at a time (its
// warps), out[1] the blocks, out[2] the blocks an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[3] the threads of a
// block, out[4] its dynamic shared memory in bytes. Returns the CUDA error
// of the query, else 0.
extern "C" int tggcn_geo_gcn_config(int N, int* out) {
  int blocks = 0;
  cudaError_t err = grid_of(N, blocks);
  out[0] = kWarps;
  out[1] = blocks;
  out[3] = kThreads;
  out[4] = (int)kSmemBytes;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], geo_gcn_kernel, kThreads,
                                                        kSmemBytes);
  return static_cast<int>(err);
}
