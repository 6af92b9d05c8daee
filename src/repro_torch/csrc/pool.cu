// k x k max pool with floor windows, and adaptive average pool in 3D (the
// 2D pool is its D = od = 1 case).
//
// Replaces: src/repro/kernels/pool.py, maxpool2d (_maxpool2d_kernel),
// adaptive_avg_pool2d (_aap2d_kernel) and adaptive_avg_pool3d
// (_aap3d_kernel). The Pallas kernels take one image per grid step; the
// adaptive windows are unrolled at trace time.
//
// Here one thread computes one output element, channels fastest, so a warp
// reads 32 consecutive channels of each input pixel (coalesced) and writes
// 32 consecutive outputs.
//  * max pool: (B, H, W, C) -> (B, H/k, W/k, C), floor division, so an odd
//    last row or column is dropped (CRONet's small mesh: 10x30 -> 5x15). A
//    NaN in the window gives NaN, as jnp.max does.
//  * adaptive average pool: (B, D, H, W, C) -> (B, od, oh, ow, C). The
//    window of output i along an axis of n inputs and o outputs is
//    [floor(i*n/o), ceil((i+1)*n/o)) (repro/core/cronet.py _adaptive_bounds,
//    PyTorch's rule); windows may overlap (depth 4 -> 3: [0,2), [1,3),
//    [2,4)). The window is summed in fp32, divided by its size and rounded
//    once to x's dtype. The box mean equals the Pallas kernel's mean over
//    depth of the h x w means, because every depth slice's h x w window has
//    the same size.
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

template <typename T>
__global__ void aap3d_kernel(const T* __restrict__ x, T* __restrict__ out,
                             int B, int D, int H, int W, int C, int OD, int OH,
                             int OW) {
  const size_t total = (size_t)B * OD * OH * OW * C;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(o % C);
    size_t r = o / C;
    const int ow = (int)(r % OW);
    r /= OW;
    const int oh = (int)(r % OH);
    r /= OH;
    const int od = (int)(r % OD);
    const int b = (int)(r / OD);
    const int d0 = win_start(od, D, OD), d1 = win_end(od, D, OD);
    const int h0 = win_start(oh, H, OH), h1 = win_end(oh, H, OH);
    const int w0 = win_start(ow, W, OW), w1 = win_end(ow, W, OW);
    float s = 0.0f;
    for (int z = d0; z < d1; ++z)
      for (int y = h0; y < h1; ++y) {
        const size_t row = (((size_t)b * D + z) * H + y) * W;
        for (int xx = w0; xx < w1; ++xx) s += ld(x, (row + xx) * C + c);
      }
    st(out, o, s / (float)((d1 - d0) * (h1 - h0) * (w1 - w0)));
  }
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
// 1 <= OW <= W.
extern "C" int aap3d_forward(int dtype, const void* x, void* out,
                             const int* dims, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int B = dims[0], D = dims[1], H = dims[2], W = dims[3], C = dims[4];
  const int OD = dims[5], OH = dims[6], OW = dims[7];
  const unsigned g = grid_for((size_t)B * OD * OH * OW * C);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    aap3d_kernel<float><<<g, kThreads, 0, s>>>((const float*)x, (float*)out, B,
                                               D, H, W, C, OD, OH, OW);
  else
    aap3d_kernel<__nv_bfloat16><<<g, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, B, D, H, W, C, OD, OH, OW);
  return (int)cudaGetLastError();
}

extern "C" const char* pool_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
