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
//    NaN in the window gives NaN, as jnp.max does. One thread computes one
//    output, channels fastest, so a warp reads 32 consecutive channels of
//    each input pixel (coalesced) and writes 32 consecutive outputs.
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

namespace {

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

constexpr int kThreads = 256;

template <typename T>
__global__ void maxpool2d_kernel(const T* __restrict__ x, T* __restrict__ out,
                                 int B, int H, int W, int C, int k) {
  const int OH = H / k, OW = W / k;
  const size_t total = (size_t)B * OH * OW * C;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(o % C);
    size_t r = o / C;
    const int ox = (int)(r % OW);
    r /= OW;
    const int oy = (int)(r % OH);
    const int b = (int)(r / OH);
    const size_t base = (((size_t)b * H + oy * k) * W + ox * k) * C + c;
    float m = ld(x, base);
    for (int i = 0; i < k; ++i)
      for (int j = 0; j < k; ++j) {
        const float v = ld(x, base + ((size_t)i * W + j) * C);
        if (v > m || v != v) m = v;  // NaN sticks
      }
    st(out, o, m);  // exact: m is one of the inputs
  }
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

unsigned grid_for(size_t total) {
  size_t blocks = (total + kThreads - 1) / kThreads;
  return (unsigned)(blocks > 65535 ? 65535 : blocks);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (input and output). B*(H/k)*(W/k)*C >= 1.
extern "C" int maxpool2d_forward(int dtype, const void* x, void* out, int B,
                                 int H, int W, int C, int k, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned g = grid_for((size_t)B * (H / k) * (W / k) * C);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    maxpool2d_kernel<float><<<g, kThreads, 0, s>>>((const float*)x, (float*)out,
                                                    B, H, W, C, k);
  else
    maxpool2d_kernel<__nv_bfloat16><<<g, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, B, H, W, C, k);
  return (int)cudaGetLastError();
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
