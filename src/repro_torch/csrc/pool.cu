// k x k max pool with floor windows, and adaptive average pool in 3D (the
// 2D pool is its D = od = 1 case).
//
// Replaces: src/repro/kernels/pool.py, maxpool2d (_maxpool2d_kernel),
// adaptive_avg_pool2d (_aap2d_kernel) and adaptive_avg_pool3d
// (_aap3d_kernel). The Pallas kernels take one image per grid step; the
// adaptive windows are unrolled at trace time.
//
//  * max pool: (B, H, W, C) -> (B, H/k, W/k, C), floor division, so an odd
//    last row or column is dropped (CRONet's small mesh: 10x30 -> 5x15). A
//    NaN in the window gives NaN, as jnp.max does, and ties keep the first
//    value in row-major window order (v > m || v != v): the result is an
//    input's bits, the same as F.max_pool2d's. One thread computes one
//    output pixel for 16 bytes of channels (4 fp32 or 8 bf16; one channel
//    when C is ragged or a pointer is not 16-byte aligned), so neighbouring
//    threads read neighbouring 16 bytes of each input pixel and a warp
//    moves 512 contiguous bytes a load. At k = 2 (CRONet's) the four loads
//    are all issued before the first compare, so a thread waits for one
//    round trip, not four; other k walk the window. Indices are 32-bit (the wrapper raises at
//    2^31 elements) and the grid is one thread per output vector, 128 a
//    block: CRONet medium's branch pool (10, 20, 30, 32) fp32 is 12,000
//    threads in 94 blocks, one wave on 132 SMs.
//  * adaptive average pool: (B, D, H, W, C) -> (B, od, oh, ow, C). The
//    window of output i along an axis of n inputs and o outputs is
//    [floor(i*n/o), ceil((i+1)*n/o)) (repro/core/cronet.py _adaptive_bounds,
//    PyTorch's rule); windows may overlap (depth 4 -> 3: [0,2), [1,3),
//    [2,4)). One block reduces one window for 32 channels: lanes over
//    channels (coalesced, ragged channels masked), one warp per row of the
//    largest window (depth x height, up to 32), each row's positions
//    walked by a pointer step with the loads issued ahead of the adds, and
//    the partials added in a fixed warp order. The window is summed in
//    fp32, divided by its size and rounded once to x's dtype. A thread per
//    output would leave CRONet's 2D pool (10 150-pixel windows of 32
//    channels) a serial chain of 150 loads on 2 of 132 SMs; here 10 blocks
//    of 10 warps each make 15. (Splitting positions rather than rows costs
//    an integer division per position, which at 32 warps on one SM took
//    longer to issue than the loads saved.) The box mean equals the Pallas
//    kernel's mean over depth of the h x w means, because every depth
//    slice's h x w window has the same size.
//
// What bounds them on the H100: bytes (one compare or add per input read).
// The outputs are small, so each call is a few microseconds of launch and
// latency at CRONet's sizes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

constexpr int kPoolThreads = 128;

// an element's bits, and its value as fp32 (exact for both types)
template <typename T> struct Raw;
template <> struct Raw<float> { using type = float; };
template <> struct Raw<__nv_bfloat16> { using type = unsigned short; };
__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(unsigned short v) {
  return __uint_as_float((unsigned)v << 16);
}

// V elements loaded and stored as one access (16 bytes when V > 1)
template <typename R, int V>
struct alignas(sizeof(R) * V) Pack {
  R e[V];
};

// m takes w's element where w's is larger or NaN (the first of equal
// values stays; a NaN sticks)
template <typename R, int V>
__device__ __forceinline__ void take(Pack<R, V>& m, const Pack<R, V>& w) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float v = as_float(w.e[e]);
    if (v > as_float(m.e[e]) || v != v) m.e[e] = w.e[e];
  }
}

// One thread per (output pixel, V channels); K > 0 fixes k at compile
// time, K = 0 reads it from `k`.
template <typename R, int V, int K>
__global__ void __launch_bounds__(kPoolThreads)
maxpool2d_kernel(const R* __restrict__ x, R* __restrict__ out, int n, int H,
                 int W, int C, int OH, int OW, int k) {
  using P = Pack<R, V>;
  const int i = blockIdx.x * kPoolThreads + threadIdx.x;
  if (i >= n) return;
  const int cvecs = C / V;
  int rest = i / cvecs;
  const int cv = i - rest * cvecs;
  const int ox = rest % OW;
  rest /= OW;
  const int oy = rest % OH;
  const int b = rest / OH;
  const int kk = K > 0 ? K : k;
  const R* base = x + ((b * H + oy * kk) * W + ox * kk) * C + cv * V;
  P m;
  if constexpr (K > 0) {
    P w[K * K];
#pragma unroll
    for (int a = 0; a < K; ++a)
#pragma unroll
      for (int c = 0; c < K; ++c)
        w[a * K + c] = *reinterpret_cast<const P*>(base + (a * W + c) * C);
    m = w[0];
#pragma unroll
    for (int t = 1; t < K * K; ++t) take(m, w[t]);
  } else {
    m = *reinterpret_cast<const P*>(base);
    for (int a = 0; a < kk; ++a)
      for (int c = a == 0 ? 1 : 0; c < kk; ++c)
        take(m, *reinterpret_cast<const P*>(base + (a * W + c) * C));
  }
  *reinterpret_cast<P*>(out + (size_t)i * V) = m;
}

template <typename T, int V>
cudaError_t maxpool_launch(const void* x, void* out, int B, int H, int W,
                           int C, int k, cudaStream_t s) {
  using R = typename Raw<T>::type;
  const int OH = H / k, OW = W / k;
  const int n = B * OH * OW * (C / V);
  const unsigned grid = (unsigned)((n + kPoolThreads - 1) / kPoolThreads);
  const R* xr = (const R*)x;
  R* o = (R*)out;
  if (k == 2)   // CRONet's pool
    maxpool2d_kernel<R, V, 2><<<grid, kPoolThreads, 0, s>>>(xr, o, n, H, W,
                                                            C, OH, OW, k);
  else
    maxpool2d_kernel<R, V, 0><<<grid, kPoolThreads, 0, s>>>(xr, o, n, H, W,
                                                            C, OH, OW, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t maxpool_dispatch(const void* x, void* out, int B, int H, int W,
                             int C, int k, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = C % V == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  return vec ? maxpool_launch<T, V>(x, out, B, H, W, C, k, s)
             : maxpool_launch<T, 1>(x, out, B, H, W, C, k, s);
}

__device__ __forceinline__ int win_start(int i, int n, int o) { return (i * n) / o; }
__device__ __forceinline__ int win_end(int i, int n, int o) {
  return ((i + 1) * n + o - 1) / o;
}

constexpr int kAapMaxWarps = 32;

// One block per (b, output cell, tile of 32 channels): lanes run over
// channels, the block's warps take the window's rows (depth x height), and
// each walks its rows' positions with a pointer step, loads issued ahead of
// the adds. The warp partials are added in warp order (no atomics: the same
// bits on every call for a given shape).
template <typename T>
__global__ void __launch_bounds__(kAapMaxWarps * 32)
aap_kernel(const T* __restrict__ x, T* __restrict__ out, int D, int H, int W,
           int C, int OD, int OH, int OW) {
  __shared__ float part[kAapMaxWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int c = blockIdx.y * 32 + lane;
  int cell = blockIdx.x;  // ((b * OD + od) * OH + oh) * OW + ow
  const int ow = cell % OW;
  cell /= OW;
  const int oh = cell % OH;
  cell /= OH;
  const int od = cell % OD;
  const int b = cell / OD;
  const int d0 = win_start(od, D, OD), d1 = win_end(od, D, OD);
  const int h0 = win_start(oh, H, OH), h1 = win_end(oh, H, OH);
  const int w0 = win_start(ow, W, OW), w1 = win_end(ow, W, OW);
  const int nh = h1 - h0, nw = w1 - w0, rows = (d1 - d0) * nh;
  float s = 0.0f;
  if (c < C)
    for (int r = warp; r < rows; r += warps) {
      const T* px =
          x + ((((size_t)b * D + d0 + r / nh) * H + h0 + r % nh) * W + w0) *
                  C + c;
#pragma unroll 8
      for (int i = 0; i < nw; ++i) s += ld(px, (size_t)i * C);
    }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < C) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kAapMaxWarps; ++w)
      if (w < warps) t += part[w][lane];
    st(out, (size_t)blockIdx.x * C + c, t / (float)(rows * nw));
  }
}

// the largest adaptive window along an axis of n inputs and o outputs
int max_window(int n, int o) {
  int m = 0;
  for (int i = 0; i < o; ++i) {
    const int len = ((i + 1) * n + o - 1) / o - (i * n) / o;
    m = len > m ? len : m;
  }
  return m;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (input and output). B*(H/k)*(W/k)*C >= 1
// and B*H*W*C < 2^31.
extern "C" int maxpool2d_forward(int dtype, const void* x, void* out, int B,
                                 int H, int W, int C, int k, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || (long long)B * H * W * C >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)maxpool_dispatch<float>(x, out, B, H, W, C, k, s);
  return (int)maxpool_dispatch<__nv_bfloat16>(x, out, B, H, W, C, k, s);
}

// dims: B, D, H, W, C, OD, OH, OW, with 1 <= OD <= D, 1 <= OH <= H,
// 1 <= OW <= W and B * OD * OH * OW < 2^31.
extern "C" int aap3d_forward(int dtype, const void* x, void* out,
                             const int* dims, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int B = dims[0], D = dims[1], H = dims[2], W = dims[3], C = dims[4];
  const int OD = dims[5], OH = dims[6], OW = dims[7];
  const dim3 grid(B * OD * OH * OW, (C + 31) / 32);
  // a warp for each row of the largest window, up to 32
  const int rows = max_window(D, OD) * max_window(H, OH);
  const int warps = rows < kAapMaxWarps ? rows : kAapMaxWarps;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    aap_kernel<float><<<grid, warps * 32, 0, s>>>(
        (const float*)x, (float*)out, D, H, W, C, OD, OH, OW);
  else
    aap_kernel<__nv_bfloat16><<<grid, warps * 32, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, D, H, W, C, OD, OH, OW);
  return (int)cudaGetLastError();
}

extern "C" const char* pool_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
