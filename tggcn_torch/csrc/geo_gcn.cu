// K6: the fused GeoGCN block of the 2G-GCN, after its BatchNorm.
//
// Replaces the TPU kernel tggcn/ops/geo_gcn_pallas.py::_kernel (launched by
// _geo_gcn_fused_impl, geo_gcn_pallas.py:100), which keeps every weight
// resident in VMEM and walks tiles of 16 frames as its grid. Here one launch
// of persistent blocks, one per SM, covers the N = batch * time frames:
// each block copies the weights (115 KB of float32) into shared memory once
// and then takes frames f = blockIdx.x, blockIdx.x + gridDim.x, ... For a
// frame the whole chain stays in shared memory (about 54 KB at V = 32):
//
//   x (V, 4) -> h1 = relu(x w1 + b1) (V, 64) -> h = relu(h1 w2 + b2) (V, 64)
//   -> s1 = h ws1 + bs1, s2 = h ws2 + bs2 (V, 128) -> scores = s1 s2^T (V, V)
//   -> row softmax (plain, no mask, as geo_gcn_pallas.py:51) -> A
//   -> mixed = A h (V, 64) -> out = mixed w_out (V, 128), to device memory.
//
// The dense layers give each thread one row and four neighbouring columns,
// so one float4 of the weight feeds four FMAs. The block has 16 warps: one
// block fits an SM (for its shared memory), and the warps hide each other's
// shared-memory latency.
//
// Bound on an H100. At the MPHOI shape (N = 8 * 167 = 1336 frames, V = 26)
// the chain does 1.76 MFLOP a frame, 2.4 GFLOP in all: 35 us of float32
// FMAs at 67 TFLOP/s, as this kernel runs them, or 14 us as 3xTF32 on the
// tensor cores, the bound chip_smoke.py holds it to; the 17.8 MB of output take 5 us at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxNodes = 32;
constexpr int kIn = 4, kEmbed = 64, kSim = 128, kOut = 128;
constexpr int kSimStride = kSim + 1;   // rows of s1, s2: neighbouring rows on other banks

// Weight offsets in shared memory, in floats; every offset is a multiple of 4.
constexpr int kW1 = 0, kB1 = kW1 + kIn * kEmbed, kW2 = kB1 + kEmbed,
              kB2 = kW2 + kEmbed * kEmbed, kWs1 = kB2 + kEmbed, kBs1 = kWs1 + kEmbed * kSim,
              kWs2 = kBs1 + kSim, kBs2 = kWs2 + kEmbed * kSim, kWout = kBs2 + kSim,
              kWeights = kWout + kEmbed * kOut;
// Per-frame buffers after the weights.
constexpr int kX = kWeights, kH1 = kX + kMaxNodes * kIn, kH = kH1 + kMaxNodes * kEmbed,
              kS1 = kH + kMaxNodes * kEmbed, kS2 = kS1 + kMaxNodes * kSimStride,
              kA = kS2 + kMaxNodes * kSimStride, kTotal = kA + kMaxNodes * kMaxNodes;
constexpr size_t kSmemBytes = kTotal * sizeof(float);

// out[v][c] = act(b[c] + sum_k in[v][k] w[k][c]) for v < V, c < C (C % 4 == 0);
// in has row stride ldi, w (K, C) row stride C, out row stride ldo.
template <bool kRelu>
__device__ __forceinline__ void dense(const float* in, int ldi, int K, const float* w,
                                      const float* b, int C, float* out, int ldo, int V) {
  const int groups = C / 4;
  for (int i = threadIdx.x; i < V * groups; i += kThreads) {
    const int v = i / groups, c = (i % groups) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < K; ++k) {
      const float x = in[v * ldi + k];
      const float4 wv = *reinterpret_cast<const float4*>(w + k * C + c);
      acc.x = fmaf(x, wv.x, acc.x);
      acc.y = fmaf(x, wv.y, acc.y);
      acc.z = fmaf(x, wv.z, acc.z);
      acc.w = fmaf(x, wv.w, acc.w);
    }
    float r[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (b != nullptr) r[j] += b[c + j];
      out[v * ldo + c + j] = kRelu ? fmaxf(r[j], 0.f) : r[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
geo_gcn_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ ws1,
               const float* __restrict__ bs1, const float* __restrict__ ws2,
               const float* __restrict__ bs2, const float* __restrict__ w_out,
               float* __restrict__ out, int N, int V) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const struct { const float* src; int at, n; } parts[] = {
      {w1, kW1, kIn * kEmbed}, {b1, kB1, kEmbed}, {w2, kW2, kEmbed * kEmbed},
      {b2, kB2, kEmbed}, {ws1, kWs1, kEmbed * kSim}, {bs1, kBs1, kSim},
      {ws2, kWs2, kEmbed * kSim}, {bs2, kBs2, kSim}, {w_out, kWout, kEmbed * kOut}};
  for (const auto& p : parts)
    for (int i = threadIdx.x; i < p.n / 4; i += kThreads)
      smem4[p.at / 4 + i] = reinterpret_cast<const float4*>(p.src)[i];

  float *xs = sm + kX, *h1 = sm + kH1, *h = sm + kH, *s1 = sm + kS1, *s2 = sm + kS2,
        *a = sm + kA;
  for (int f = blockIdx.x; f < N; f += gridDim.x) {
    __syncthreads();                  // the weights are in; the last frame's buffers are free
    for (int i = threadIdx.x; i < V * kIn; i += kThreads) xs[i] = x[(size_t)f * V * kIn + i];
    __syncthreads();
    dense<true>(xs, kIn, kIn, sm + kW1, sm + kB1, kEmbed, h1, kEmbed, V);
    __syncthreads();
    dense<true>(h1, kEmbed, kEmbed, sm + kW2, sm + kB2, kEmbed, h, kEmbed, V);
    __syncthreads();
    dense<false>(h, kEmbed, kEmbed, sm + kWs1, sm + kBs1, kSim, s1, kSimStride, V);
    dense<false>(h, kEmbed, kEmbed, sm + kWs2, sm + kBs2, kSim, s2, kSimStride, V);
    __syncthreads();
    for (int i = threadIdx.x; i < V * V; i += kThreads) {
      const int v = i / V, w = i % V;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};   // four chains, summed in a fixed order
      for (int c = 0; c < kSim; c += 4)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dot[j] = fmaf(s1[v * kSimStride + c + j], s2[w * kSimStride + c + j], dot[j]);
      a[v * kMaxNodes + w] = (dot[0] + dot[1]) + (dot[2] + dot[3]);
    }
    __syncthreads();
    if (threadIdx.x < V) {
      float* row = a + threadIdx.x * kMaxNodes;
      float mx = row[0];
      for (int w = 1; w < V; ++w) mx = fmaxf(mx, row[w]);
      float den = 0.f;
      for (int w = 0; w < V; ++w) {
        row[w] = expf(row[w] - mx);
        den += row[w];
      }
      for (int w = 0; w < V; ++w) row[w] /= den;
    }
    __syncthreads();
    dense<false>(a, kMaxNodes, V, h, nullptr, kEmbed, h1, kEmbed, V);   // mixed, into h1
    __syncthreads();
    dense<false>(h1, kEmbed, kEmbed, sm + kWout, nullptr, kOut, out + (size_t)f * V * kOut,
                 kOut, V);
  }
}

}  // namespace

// The GeoGCN outputs out (N, V, 128) of the normalised frames x (N, V, 4):
// one launch on `stream`. Returns the CUDA error of the launch, else 0.
// 1 <= V <= 32.
extern "C" int tggcn_geo_gcn_f32(const float* x, const float* w1, const float* b1,
                                 const float* w2, const float* b2, const float* ws1,
                                 const float* bs1, const float* ws2, const float* bs2,
                                 const float* w_out, float* out, int N, int V,
                                 void* stream_ptr) {
  if (V < 1 || V > kMaxNodes) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(geo_gcn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = N < sms ? N : sms;
  geo_gcn_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream_ptr)>>>(
      x, w1, b1, w2, b2, ws1, bs1, ws2, bs2, w_out, out, N, V);
  return static_cast<int>(cudaGetLastError());
}
