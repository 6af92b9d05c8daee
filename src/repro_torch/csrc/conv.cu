// SAME 3D convolution, no bias, optional fused SiLU; conv2d is the D = 1,
// kd = 1 case of the same kernel.
//
// Replaces: src/repro/kernels/conv.py, conv2d (_conv2d_kernel) and conv3d
// (_conv3d_kernel). The Pallas kernels pad the input in HBM and run each
// filter tap as a (H*W, Cin) x (Cin, Cout) MXU matmul over a shifted view,
// one grid step per image.
//
// Here: x (B, D, H, W, Cin) NDHWC and w (KD, KH, KW, Cin, Cout) DHWIO are
// read as they are, unpadded; an edge tap is a bounds check, so nothing is
// copied. Depth is "causal_same" (taps d .. d+KD-1, the tail past D reads
// zero) or "same" with KD = 1. The whole filter sits in shared memory
// (9216 fp32 values, 36.9 KB, for CRONet's trunk conv2). One thread owns
// one output element (pixel, cout): consecutive threads take consecutive
// output channels, so a warp reads each input value as one broadcast and
// the filter row conflict-free, and the output store is coalesced. Every
// multiply-add is an fp32 FMA; accumulation order is taps (d, i, j), then
// Cin, as the Pallas kernel sums its taps. SiLU is applied in fp32 and the
// result rounded once to the output dtype (x's).
//
// What bounds it on the H100: operations. Trunk conv2 at the medium mesh is
// 24 M multiply-adds (48 MFLOP, 0.72 us at fp32's 67 TFLOP/s) against
// 0.87 MB moved at fp32 (0.26 us). This first version issues scalar FMAs with one
// shared-memory and one L1 load each; tensor cores are a later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as astype does
}

constexpr int kThreads = 256;

// grid-stride over B*D*H*W*Cout outputs; dynamic smem = the filter in fp32
template <typename TX, typename TW>
__global__ void conv3d_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                              TX* __restrict__ out, int B, int D, int H, int W,
                              int Cin, int KD, int KH, int KW, int Cout,
                              int fuse_silu) {
  extern __shared__ float ws[];
  const int nw = KD * KH * KW * Cin * Cout;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) ws[i] = ld(w, i);
  __syncthreads();

  const int ph = KH / 2, pw = KW / 2;
  const size_t total = (size_t)B * D * H * W * Cout;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    const int co = (int)(o % Cout);
    size_t r = o / Cout;
    const int xo = (int)(r % W);
    r /= W;
    const int yo = (int)(r % H);
    r /= H;
    const int d = (int)(r % D);
    const int b = (int)(r / D);
    float acc = 0.0f;
    for (int dd = 0; dd < KD; ++dd) {
      const int z = d + dd;
      if (z >= D) break;  // causal_same: the padded tail contributes zero
      for (int i = 0; i < KH; ++i) {
        const int y = yo + i - ph;
        if (y < 0 || y >= H) continue;
        for (int j = 0; j < KW; ++j) {
          const int xx = xo + j - pw;
          if (xx < 0 || xx >= W) continue;
          const size_t xb = ((((size_t)b * D + z) * H + y) * W + xx) * Cin;
          const float* wp = ws + ((dd * KH + i) * KW + j) * Cin * Cout + co;
          for (int ci = 0; ci < Cin; ++ci)
            acc = fmaf(ld(x, xb + ci), wp[ci * Cout], acc);
        }
      }
    }
    if (fuse_silu) acc = acc / (1.0f + expf(-acc));
    st(out, o, acc);
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, const int* dims,
           int fuse_silu, cudaStream_t stream) {
  const int B = dims[0], D = dims[1], H = dims[2], W = dims[3], Cin = dims[4];
  const int KD = dims[5], KH = dims[6], KW = dims[7], Cout = dims[8];
  const size_t smem = sizeof(float) * (size_t)KD * KH * KW * Cin * Cout;
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_kernel<TX, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t total = (size_t)B * D * H * W * Cout;
  size_t blocks = (total + kThreads - 1) / kThreads;
  // each block loads the whole filter once: cap the grid at a few blocks
  // per SM and let the blocks stride over the outputs
  const size_t cap = (size_t)sms * 4;
  if (blocks > cap) blocks = cap;
  if (blocks == 0) return 0;
  conv3d_kernel<TX, TW><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const TX*)x, (const TW*)w, (TX*)out, B, D, H, W, Cin, KD, KH, KW, Cout,
      fuse_silu);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; the output has x's dtype.
// dims: B, D, H, W, Cin, KD, KH, KW, Cout (KH, KW odd; depth causal_same,
// which for KD = 1 is "same"). Returns cudaGetLastError() after the launch.
extern "C" int conv3d_forward(int x_dtype, int w_dtype, const void* x,
                              const void* w, void* out, const int* dims,
                              int fuse_silu, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && w_dtype == 0) return launch<float, float>(x, w, out, dims, fuse_silu, s);
  if (x_dtype == 0) return launch<float, __nv_bfloat16>(x, w, out, dims, fuse_silu, s);
  if (w_dtype == 0) return launch<__nv_bfloat16, float>(x, w, out, dims, fuse_silu, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, dims, fuse_silu, s);
}

extern "C" const char* conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
