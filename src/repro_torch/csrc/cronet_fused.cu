// The whole CRONet forward, on Hopper, in three launches from one wrapper.
//
// Replaces: src/repro/kernels/cronet_pipeline.py, cronet_fused (Pallas
// kernel body _make_kernel). It computes core/cronet.forward: trunk
// conv3d x2 + SiLU, AAP3D, FC 4800->40 (+SiLU) ->2560; branch per-timestep
// conv2d x2 + SiLU, maxpool2, AAP(1,1), 10-step tanh RNN 32->64,
// FC 64->40 (+SiLU) ->2560; product.
//
// What bounds it on the H100: operations. At the medium size (30x20 mesh)
// one slot is ~53 M multiply-adds (Table I), almost all in the two second
// convolutions, against ~1.7 MB of fp32 weights that every slot shares;
// at fp32's 67 TFLOP/s the arithmetic takes ~6 us for 4 slots, the bytes
// ~0.5 us.
//
// Why three kernels: the TPU kernel keeps one slot's whole network in VMEM
// (cronet_pipeline.py:172-176). On Hopper the per-slot intermediates do
// not fit one SM's 227 KB (the trunk conv2 output is 667 KB, the branch
// conv2 stack 768 KB). The design never stores either:
//  (a) trunk_kernel, one block per (window row, depth, slot): conv3d-1 for
//      the rows the window needs plus a halo (both depth taps, causal
//      "same" padding) into shared memory, then conv3d-2 + SiLU reduced
//      straight into the spatial AAP window means. Thread (channel, window
//      column) owns one window, so overlapping windows simply recompute
//      the shared rows/columns (~34% extra conv2 work at medium);
//  (b) branch_kernel, one block per (timestep, slot): conv2d-1 + SiLU
//      into shared memory, then conv2d-2 + SiLU reduced on the fly through
//      the 2x2 max pool into the per-channel mean (AAP(1,1));
//  (c) head_kernel, one block per slot: the depth-window mean of (a)
//      (equal to the AAP3D box mean), both FC stacks, the RNN and the
//      product. Its weights come from device memory and stay in L2.
// Every sum runs in a fixed order inside one block, so slot b's output
// does not depend on the batch width. Inputs and weights are fp32 or
// bf16; accumulation and the output are fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

__host__ __device__ __forceinline__ int win_start(int i, int n_in, int n_out) {
  return (i * n_in) / n_out;
}
__host__ __device__ __forceinline__ int win_end(int i, int n_in, int n_out) {
  return ((i + 1) * n_in + n_out - 1) / n_out;
}

// (a) lv (B, D, H, W); w1 (KD, 3, 3, 1, C1); w2 (1, 3, 3, C1, C2);
// S (B, D, PH, PW, C2) = spatial window means of silu(conv2) at depth d.
// blockDim = C2 * PW; grid (PH, D, B).
template <typename T>
__global__ void trunk_kernel(const T* __restrict__ lv, const T* __restrict__ w1,
                             const T* __restrict__ w2, float* __restrict__ S,
                             int D, int H, int W, int KD, int C1, int C2, int PH,
                             int PW) {
  extern __shared__ float sm[];
  float* w2s = sm;
  float* tile = sm + 9 * C1 * C2;
  const int wi = blockIdx.x, d = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int hs = win_start(wi, H, PH), he = win_end(wi, H, PH);
  const int rows = he - hs + 2, Wp = W + 2;

  for (int i = tid; i < 9 * C1 * C2; i += blockDim.x) w2s[i] = ld(w2, i);
  // conv3d-1 + SiLU on rows [hs-1, he] (zero outside the grid: SAME pad)
  for (int i = tid; i < rows * Wp * C1; i += blockDim.x) {
    const int c = i % C1;
    const int rest = i / C1;
    const int xc = rest % Wp;
    const int y = hs - 1 + rest / Wp;
    const int x = xc - 1;
    float v = 0.0f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      float acc = 0.0f;
      for (int dd = 0; dd < KD && d + dd < D; ++dd) {  // causal_same tail = 0
        const size_t img = ((size_t)b * D + d + dd) * H * W;
        for (int ki = 0; ki < 3; ++ki) {
          const int yy = y + ki - 1;
          if (yy < 0 || yy >= H) continue;
          for (int kj = 0; kj < 3; ++kj) {
            const int xx = x + kj - 1;
            if (xx < 0 || xx >= W) continue;
            acc += ld(lv, img + yy * W + xx) * ld(w1, ((dd * 3 + ki) * 3 + kj) * C1 + c);
          }
        }
      }
      v = silu(acc);
    }
    tile[i] = v;
  }
  __syncthreads();

  const int c = tid % C2, wj = tid / C2;
  if (wj >= PW) return;
  const int ws = win_start(wj, W, PW), we = win_end(wj, W, PW);
  float acc = 0.0f;
  for (int y = hs; y < he; ++y) {
    for (int x = ws; x < we; ++x) {
      float v = 0.0f;
      for (int ki = 0; ki < 3; ++ki) {
        for (int kj = 0; kj < 3; ++kj) {
          const float* tp = tile + ((y - hs + ki) * Wp + x + kj) * C1;
          const float* wp = w2s + (ki * 3 + kj) * C1 * C2 + c;
          for (int ci = 0; ci < C1; ++ci) v += tp[ci] * wp[ci * C2];
        }
      }
      acc += silu(v);
    }
  }
  S[(((size_t)b * D + d) * PH + wi) * PW * C2 + wj * C2 + c] =
      acc / (float)((he - hs) * (we - ws));
}

// (b) hist (B, T, ny, nx); w1 (3, 3, 1, C1); w2 (3, 3, C1, C2);
// feats (B, T, C2) = mean over the floor 2x2 max pool of silu(conv2).
// blockDim = C2 * G; grid (T, B).
template <typename T>
__global__ void branch_kernel(const T* __restrict__ hist, const T* __restrict__ w1,
                              const T* __restrict__ w2, float* __restrict__ feats,
                              int Tn, int ny, int nx, int C1, int C2, int G) {
  extern __shared__ float sm[];
  float* w2s = sm;
  float* tile = w2s + 9 * C1 * C2;
  const int Wp = nx + 2;
  float* part = tile + (ny + 2) * Wp * C1;
  const int t = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t img = ((size_t)b * Tn + t) * ny * nx;

  for (int i = tid; i < 9 * C1 * C2; i += blockDim.x) w2s[i] = ld(w2, i);
  for (int i = tid; i < (ny + 2) * Wp * C1; i += blockDim.x) {
    const int c = i % C1;
    const int rest = i / C1;
    const int y = rest / Wp - 1;
    const int x = rest % Wp - 1;
    float v = 0.0f;
    if (y >= 0 && y < ny && x >= 0 && x < nx) {
      float acc = 0.0f;
      for (int ki = 0; ki < 3; ++ki) {
        const int yy = y + ki - 1;
        if (yy < 0 || yy >= ny) continue;
        for (int kj = 0; kj < 3; ++kj) {
          const int xx = x + kj - 1;
          if (xx < 0 || xx >= nx) continue;
          acc += ld(hist, img + yy * nx + xx) * ld(w1, (ki * 3 + kj) * C1 + c);
        }
      }
      v = silu(acc);
    }
    tile[i] = v;
  }
  __syncthreads();

  const int c = tid % C2, g = tid / C2;
  const int ph = ny / 2, pw = nx / 2;
  float s = 0.0f;
  if (g < G) {
    for (int q = g; q < ph * pw; q += G) {
      const int pr = q / pw, pc = q % pw;
      float m = __int_as_float(0xff800000);  // -inf
      for (int a = 0; a < 2; ++a) {
        for (int bb = 0; bb < 2; ++bb) {
          const int y = 2 * pr + a, x = 2 * pc + bb;
          float v = 0.0f;
          for (int ki = 0; ki < 3; ++ki) {
            for (int kj = 0; kj < 3; ++kj) {
              const float* tp = tile + ((y + ki) * Wp + x + kj) * C1;
              const float* wp = w2s + (ki * 3 + kj) * C1 * C2 + c;
              for (int ci = 0; ci < C1; ++ci) v += tp[ci] * wp[ci * C2];
            }
          }
          m = fmaxf(m, silu(v));
        }
      }
      s += m;
    }
    part[g * C2 + c] = s;
  }
  __syncthreads();
  if (tid < C2) {
    float tot = 0.0f;
    for (int k = 0; k < G; ++k) tot += part[k * C2 + tid];
    feats[((size_t)b * Tn + t) * C2 + tid] = tot / (float)(ph * pw);
  }
}

// (c) S (B, D, PH, PW, C2t); feats (B, T, Cb); tf1 (PD*PH*PW*C2t, MID);
// tf2 (MID, P); rwx (Cb, HID); rwh (HID, HID); bf1 (HID, MID);
// bf2 (MID, P); out (B, P). grid (B); blockDim >= max(HID, MID).
template <typename T>
__global__ void head_kernel(const float* __restrict__ S, const float* __restrict__ feats,
                            const T* __restrict__ tf1, const T* __restrict__ tf2,
                            const T* __restrict__ rwx, const T* __restrict__ rwh,
                            const T* __restrict__ bf1, const T* __restrict__ bf2,
                            float* __restrict__ out, int D, int PD, int PH, int PW,
                            int C2t, int Tn, int Cb, int HID, int MID, int P) {
  extern __shared__ float sm[];
  const int F = PD * PH * PW * C2t;
  const int G1 = blockDim.x / MID;
  float* tfeat = sm;
  float* part = tfeat + F;
  float* tmid = part + G1 * MID;
  float* tout = tmid + MID;
  float* fts = tout + P;
  float* h = fts + Tn * Cb;
  float* bmid = h + HID;
  const int b = blockIdx.x, tid = threadIdx.x;

  // AAP3D: depth-window mean of the spatial window means, (d, h, w, c)
  for (int idx = tid; idx < F; idx += blockDim.x) {
    const int c = idx % C2t;
    int r = idx / C2t;
    const int wj = r % PW;
    r /= PW;
    const int wi = r % PH;
    const int k = r / PH;
    const int ds = win_start(k, D, PD), de = win_end(k, D, PD);
    float s = 0.0f;
    for (int dz = ds; dz < de; ++dz)
      s += S[(((size_t)b * D + dz) * PH + wi) * PW * C2t + wj * C2t + c];
    tfeat[idx] = s / (float)(de - ds);
  }
  for (int i = tid; i < Tn * Cb; i += blockDim.x) fts[i] = feats[(size_t)b * Tn * Cb + i];
  for (int i = tid; i < HID; i += blockDim.x) h[i] = 0.0f;
  __syncthreads();

  // trunk FC1 (+SiLU): G1 contiguous K chunks per output, summed in order
  if (tid < G1 * MID) {
    const int o = tid % MID, g = tid / MID;
    const int chunk = (F + G1 - 1) / G1;
    const int k0 = g * chunk, k1 = min(F, k0 + chunk);
    float s = 0.0f;
    for (int k = k0; k < k1; ++k) s += tfeat[k] * ld(tf1, (size_t)k * MID + o);
    part[g * MID + o] = s;
  }
  __syncthreads();
  if (tid < MID) {
    float s = 0.0f;
    for (int g = 0; g < G1; ++g) s += part[g * MID + tid];
    tmid[tid] = silu(s);
  }
  __syncthreads();
  for (int n = tid; n < P; n += blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < MID; ++k) s += tmid[k] * ld(tf2, (size_t)k * P + n);
    tout[n] = s;
  }

  // RNN: h = tanh(x_t @ Wx + h @ Wh), h0 = 0
  for (int t = 0; t < Tn; ++t) {
    float hn = 0.0f;
    if (tid < HID) {
      float a = 0.0f, c = 0.0f;
      for (int k = 0; k < Cb; ++k) a += fts[t * Cb + k] * ld(rwx, k * HID + tid);
      for (int k = 0; k < HID; ++k) c += h[k] * ld(rwh, k * HID + tid);
      hn = tanhf(a + c);
    }
    __syncthreads();
    if (tid < HID) h[tid] = hn;
    __syncthreads();
  }
  if (tid < MID) {
    float s = 0.0f;
    for (int k = 0; k < HID; ++k) s += h[k] * ld(bf1, k * MID + tid);
    bmid[tid] = silu(s);
  }
  __syncthreads();
  for (int n = tid; n < P; n += blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < MID; ++k) s += bmid[k] * ld(bf2, (size_t)k * P + n);
    out[(size_t)b * P + n] = s * tout[n];
  }
}

constexpr int kBranchGroups = 8;
constexpr int kHeadThreads = 256;

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// dims (host ints): B, D, H, W, KD, T, ny, nx, tC1, tC2, bC1, bC2,
//                   PD, PH, PW, HID, MID, P
template <typename T>
int launch(const void* lv_, const void* hist_, const void* const* w_, float* S,
           float* feats, float* out, const int* dims, cudaStream_t stream) {
  const T* lv = (const T*)lv_;
  const T* hist = (const T*)hist_;
  const T* tc1 = (const T*)w_[0];
  const T* tc2 = (const T*)w_[1];
  const T* tf1 = (const T*)w_[2];
  const T* tf2 = (const T*)w_[3];
  const T* bc1 = (const T*)w_[4];
  const T* bc2 = (const T*)w_[5];
  const T* rwx = (const T*)w_[6];
  const T* rwh = (const T*)w_[7];
  const T* bf1 = (const T*)w_[8];
  const T* bf2 = (const T*)w_[9];
  const int B = dims[0], D = dims[1], H = dims[2], W = dims[3], KD = dims[4];
  const int Tn = dims[5], ny = dims[6], nx = dims[7];
  const int tC1 = dims[8], tC2 = dims[9], bC1 = dims[10], bC2 = dims[11];
  const int PD = dims[12], PH = dims[13], PW = dims[14];
  const int HID = dims[15], MID = dims[16], P = dims[17];
  cudaError_t err;

  int max_rows = 0;
  for (int i = 0; i < PH; ++i) {
    const int r = win_end(i, H, PH) - win_start(i, H, PH);
    max_rows = r > max_rows ? r : max_rows;
  }
  const size_t smem_a = sizeof(float) * (size_t)(9 * tC1 * tC2 + (max_rows + 2) * (W + 2) * tC1);
  if ((err = set_smem(trunk_kernel<T>, smem_a)) != cudaSuccess) return (int)err;
  trunk_kernel<T><<<dim3(PH, D, B), tC2 * PW, smem_a, stream>>>(
      lv, tc1, tc2, S, D, H, W, KD, tC1, tC2, PH, PW);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_b = sizeof(float) *
      (size_t)(9 * bC1 * bC2 + (ny + 2) * (nx + 2) * bC1 + kBranchGroups * bC2);
  if ((err = set_smem(branch_kernel<T>, smem_b)) != cudaSuccess) return (int)err;
  branch_kernel<T><<<dim3(Tn, B), bC2 * kBranchGroups, smem_b, stream>>>(
      hist, bc1, bc2, feats, Tn, ny, nx, bC1, bC2, kBranchGroups);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int F = PD * PH * PW * tC2;
  const int G1 = kHeadThreads / MID;
  const size_t smem_c = sizeof(float) *
      (size_t)(F + G1 * MID + MID + P + Tn * bC2 + HID + MID);
  if ((err = set_smem(head_kernel<T>, smem_c)) != cudaSuccess) return (int)err;
  head_kernel<T><<<B, kHeadThreads, smem_c, stream>>>(
      S, feats, tf1, tf2, rwx, rwh, bf1, bf2, out, D, PD, PH, PW, tC2, Tn, bC2,
      HID, MID, P);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (inputs and weights alike).
// weights: tc1, tc2, tf1, tf2, bc1, bc2, rwx, rwh, bf1, bf2 device pointers.
// S (B, D, PH, PW, tC2) and feats (B, T, bC2) are float32 scratch.
// Returns cudaGetLastError() after the last launch (0 on success).
extern "C" int cronet_fused_forward(int dtype, const void* load_vol, const void* hist,
                                    const void* const* weights, float* S, float* feats,
                                    float* out, const int* dims, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    return launch<float>(load_vol, hist, weights, S, feats, out, dims,
                         (cudaStream_t)stream);
  return launch<__nv_bfloat16>(load_vol, hist, weights, S, feats, out, dims,
                               (cudaStream_t)stream);
}

extern "C" const char* cronet_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
