// (M, K) @ (K, N) with an fp32 accumulator and an optional silu / tanh
// epilogue; any M, K, N.
//
// Replaces: src/repro/kernels/gemm.py, gemm (_gemm_kernel). The Pallas
// kernel pads M/K/N up to (8|128)-multiples in HBM, pins the weight block
// in VMEM and walks K as the sequential grid axis into a VMEM accumulator.
//
// Here nothing is padded: the edges are bounds checks. On this path M is 1
// almost always (CRONet's FCs and RNN steps are GEMVs: trunk fc1 is
// 1x4800x40), so one thread per output would leave 40 threads each doing
// 4800 serial FMAs. Instead K is split twice:
//  * across blocks: grid (ceil(N/32), M, ceil(K/kKChunk)); with more than
//    one K chunk, each block writes an fp32 partial sum and a second kernel
//    adds the chunks in order, applies the epilogue and rounds;
//  * inside a block: 8 warps each take every 8th k of the chunk, lane l
//    column n0 + l, so a warp reads 32 consecutive weights (one 128-byte
//    line) and one broadcast x value per k; the 8 partial sums are added in
//    warp order through shared memory.
// Every sum has a fixed order, so results do not vary from run to run.
// x and w may each be fp32 or bf16 (both are read as fp32, as the Pallas
// kernel casts them); the output has x's dtype.
//
// What bounds it on the H100: bytes. A GEMV reads every weight once for two
// flops: trunk fc1 moves 768 KB (0.23 us at 3.35 TB/s) for 0.38 MFLOP.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// 0 = none, 1 = silu, 2 = tanh
__device__ __forceinline__ float epilogue(float v, int act) {
  if (act == 1) return v / (1.0f + expf(-v));
  if (act == 2) return tanhf(v);
  return v;
}

constexpr int kCols = 32;     // output columns per block (one per lane)
constexpr int kSlices = 8;    // warps per block, each a K slice
constexpr int kKChunk = 256;  // K values per block

// grid (ceil(N/kCols), min(M, 65535), nchunks); blockDim kCols * kSlices.
// nchunks == 1: write act(sum) to out in TX; else fp32 partial[kz, m, n].
template <typename TX, typename TW>
__global__ void gemm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                            TX* __restrict__ out, float* __restrict__ partial,
                            int M, int K, int N, int act) {
  __shared__ float part[kSlices][kCols];
  const int lane = threadIdx.x % kCols, slice = threadIdx.x / kCols;
  const int n = blockIdx.x * kCols + lane;
  const int k0 = blockIdx.z * kKChunk;
  const int k1 = min(K, k0 + kKChunk);
  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    float s = 0.0f;
    if (n < N) {
      const size_t xr = (size_t)m * K;
      for (int k = k0 + slice; k < k1; k += kSlices)
        s = fmaf(ld(x, xr + k), ld(w, (size_t)k * N + n), s);
    }
    part[slice][lane] = s;
    __syncthreads();
    if (slice == 0 && n < N) {
      float t = 0.0f;
      for (int q = 0; q < kSlices; ++q) t += part[q][lane];
      if (gridDim.z == 1)
        st(out, (size_t)m * N + n, epilogue(t, act));
      else
        partial[((size_t)blockIdx.z * M + m) * N + n] = t;
    }
    __syncthreads();
  }
}

// one thread per output: add the K chunks in order, epilogue, round
template <typename TX>
__global__ void gemm_reduce_kernel(const float* __restrict__ partial,
                                   TX* __restrict__ out, int M, int N,
                                   int nchunks, int act) {
  const size_t MN = (size_t)M * N;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < MN;
       o += (size_t)gridDim.x * blockDim.x) {
    float t = 0.0f;
    for (int c = 0; c < nchunks; ++c) t += partial[c * MN + o];
    st(out, o, epilogue(t, act));
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, float* partial, int M,
           int K, int N, int act, cudaStream_t stream) {
  const int nchunks = K > kKChunk ? (K + kKChunk - 1) / kKChunk : 1;
  const dim3 grid((N + kCols - 1) / kCols, M < 65535 ? M : 65535, nchunks);
  gemm_kernel<TX, TW><<<grid, kCols * kSlices, 0, stream>>>(
      (const TX*)x, (const TW*)w, (TX*)out, partial, M, K, N, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nchunks == 1) return (int)err;
  const size_t MN = (size_t)M * N;
  size_t blocks = (MN + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  gemm_reduce_kernel<TX><<<(unsigned)blocks, 256, 0, stream>>>(
      partial, (TX*)out, M, N, nchunks, act);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of fp32 partial sums (nchunks * M * N, or 0) the caller must
// allocate for these sizes.
extern "C" long long gemm_partial_size(int M, int K, int N) {
  const int nchunks = K > kKChunk ? (K + kKChunk - 1) / kKChunk : 1;
  return nchunks == 1 ? 0 : (long long)nchunks * M * N;
}

// dtype codes: 0 = float32, 1 = bfloat16; out (M, N) has x's dtype.
// act: 0 none, 1 silu, 2 tanh. M, N >= 1. Returns cudaGetLastError().
extern "C" int gemm_forward(int x_dtype, int w_dtype, const void* x,
                            const void* w, void* out, float* partial, int M,
                            int K, int N, int act, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, w, out, partial, M, K, N, act, s);
  if (x_dtype == 0)
    return launch<float, __nv_bfloat16>(x, w, out, partial, M, K, N, act, s);
  if (w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, out, partial, M, K, N, act, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, partial, M, K, N, act, s);
}

extern "C" const char* gemm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
