// Flash attention: online-softmax attention whose (Sq, Sk) score matrix
// never leaves the SM.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention
// (_flash_kernel) and flash_attention_causal_gqa. The Pallas kernel runs
// one grid step per (batch x kv head, folded q block, kv block), with GQA
// folding the q-head group into q rows and fp32 running max, denominator
// and accumulator in VMEM scratch across the kv axis; causal GQA loops the
// group in Python.
//
// Here one thread block of 256 threads owns one (batch, q head, 64-row q
// tile) and walks the kv tiles itself (a loop in the block takes the place
// of the sequential grid axis). q head h reads kv head h / g (JAX's
// reshape(b, sq, hkv, g, d) order), so grouped and causal-grouped calls are
// one launch. Per kv tile of 64 keys:
//   1. K and V tiles are staged in shared memory as fp32 (Q stays there for
//      the whole walk; rows padded by one float so that the column reads of
//      the score loop hit 16 distinct banks);
//   2. each thread computes a 4 x 4 block of scores (rows ty*4+i, keys
//      tx+16j), as the fp32 dot times 1/sqrt(D); causally masked scores are
//      -1e30 (not -inf), keys past Sk get p = 0;
//   3. the row max and sum are reduced over the 16 lanes that share a row
//      (warp shuffles); running max m, denominator l and the accumulator
//      rescale by alpha = exp(m_old - m_new);
//   4. p, rounded to v's dtype (bf16 for bf16 inputs, as the reference
//      rounds p before its PV product), goes through shared memory, and each
//      thread adds its 4 rows x Dv/16 columns of P V.
// The output is acc / max(l, 1e-30), rounded to q's dtype. Causal tiles
// wholly above the diagonal are skipped: for them p = exp(-1e30 - m) = 0
// and alpha = 1 exactly, so skipping changes nothing. Causal q tiles are
// scheduled longest first.
//
// What bounds it on the H100: operations. 4*B*Hq*Sq*Sk*D flops (half of
// them causal) would take ~0.35 ms at qwen2.5-32b's prefill widths (S 4096,
// bf16) on the tensor cores; this SIMT kernel runs every multiply-add on the
// fp32 pipes from shared memory (one shared load for every two FMAs in the
// score loop), so it is far from that bound. wgmma tiles fed by TMA are the
// next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}
// p rounded to the value type, as the reference's p.astype(v.dtype)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int D, int Dv) {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * Dv + (size_t)kBQ * (kBK + 1));
}

// NJ = Dv / 16 accumulator columns per thread.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int Hq, int Hkv, int D, int causal, float scale) {
  constexpr int Dv = NJ * 16;
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);         // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);         // [kBK][Dv]
  float* Ps = Vs + kBK * Dv;              // [kBQ][kBK + 1]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int qr = q0 + r;
    Qs[r * (D + 1) + d] =
        qr < Sq ? ld(q, (((size_t)b * Sq + qr) * Hq + h) * D + d) : 0.0f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  int k_end = Sk;
  if (causal) k_end = min(Sk, q0 + kBQ);  // later tiles are wholly masked
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks / Vs / Ps are consumed
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      const int kc = k0 + c;
      Ks[c * (D + 1) + d] =
          kc < Sk ? ld(k, (((size_t)b * Sk + kc) * Hkv + hk) * D + d) : 0.0f;
    }
    for (int idx = tid; idx < kBK * Dv; idx += kThreads) {
      const int c = idx / Dv, d = idx - c * Dv;
      const int kc = k0 + c;
      Vs[idx] =
          kc < Sk ? ld(v, (((size_t)b * Sk + kc) * Hkv + hk) * Dv + d) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float sv = s[i][j] * scale;
        if (causal && kpos > qpos) sv = kNegInf;
        s[i][j] = sv;
        if (kpos < Sk) mx = fmaxf(mx, sv);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p = kpos < Sk ? expf(s[i][j] - m_new) : 0.0f;
        sum += p;
        Ps[(ty * 4 + i) * (kBK + 1) + tx + 16 * j] = round_to(p, v);
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int n_keys = min(kBK, Sk - k0);
    for (int c = 0; c < n_keys; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[c * Dv + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= Sq) continue;
    const float inv = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      st(out, (((size_t)b * Sq + qr) * Hq + h) * Dv + tx + 16 * j,
         acc[i][j] / inv);
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int* dims, int causal, float scale,
                   cudaStream_t stream) {
  const int B = dims[0], Sq = dims[1], Sk = dims[2], Hq = dims[3],
            Hkv = dims[4], D = dims[5];
  const size_t smem = smem_bytes(D, NJ * 16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, Hq, Hkv, D,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int Dv, const void* q, const void* k, const void* v,
                     void* out, const int* dims, int causal, float scale,
                     cudaStream_t s) {
  switch (Dv) {
    case 16: return launch<T, 1>(q, k, v, out, dims, causal, scale, s);
    case 32: return launch<T, 2>(q, k, v, out, dims, causal, scale, s);
    case 64: return launch<T, 4>(q, k, v, out, dims, causal, scale, s);
    case 128: return launch<T, 8>(q, k, v, out, dims, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). dims: B, Sq, Sk, Hq,
// Hkv, D, Dv with Hq % Hkv == 0, 1 <= D <= 128, Dv in {16, 32, 64, 128}.
// q (B, Sq, Hq, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv), out
// (B, Sq, Hq, Dv), all contiguous. causal: kpos <= qpos, both from 0.
extern "C" int flash_attention_forward(int dtype, const void* q,
                                       const void* k, const void* v,
                                       void* out, const int* dims, int causal,
                                       float scale, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    err = dispatch<float>(dims[6], q, k, v, out, dims, causal, scale, s);
  else
    err = dispatch<__nv_bfloat16>(dims[6], q, k, v, out, dims, causal, scale,
                                  s);
  return (int)err;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
