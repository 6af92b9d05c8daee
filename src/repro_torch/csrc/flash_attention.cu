// Flash attention: online-softmax attention whose (Sq, Sk) score matrix
// never leaves the SM. Two kernels; flash_attention.py picks one by dtype
// and head width (bf16 with D == Dv in {64, 128}: tensor cores; anything
// else: SIMT).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention
// (_flash_kernel) and flash_attention_causal_gqa. The Pallas kernel runs
// one grid step per (batch x kv head, folded q block, kv block), with GQA
// folding the q-head group into q rows and fp32 running max, denominator
// and accumulator in VMEM scratch across the kv axis; causal GQA loops the
// group in Python.
//
// Both kernels run one thread block per (batch, q head, q tile) and walk
// the kv tiles themselves (a loop in the block takes the place of the
// sequential grid axis). q head h reads kv head h / g (JAX's
// reshape(b, sq, hkv, g, d) order), so grouped and causal-grouped calls are
// one launch. Masked causal scores are -1e30 (not -inf), keys past Sk get
// p = 0, p is rounded to v's dtype before the PV product (the reference's
// p.astype(v.dtype)) while l sums the unrounded p, and the output is
// acc / max(l, 1e-30) rounded to q's dtype. Causal kv tiles wholly above
// the diagonal are skipped: for them p = 0 and alpha = 1 exactly, so
// skipping changes nothing. Causal q tiles are scheduled longest first.
//
// What bounds both on the H100: operations, 4*B*Hq*Sq*Sk*D flops (half of
// them causal): ~0.35 ms at qwen2.5-32b's prefill widths (S 4096, bf16) on
// the tensor cores, 0.32 ms at S 1024 in fp32 on the CUDA cores.
//
// SIMT kernel (fp32, and bf16 at the other widths: D a multiple of 16 up
// to 256, Dv in {16, 32, 64, 80, 128, 256}). fp32 arithmetic on the CUDA
// cores throughout (fp32's 2e-5 bar rules out TF32). 128 threads: 16 row
// groups x 8 lanes; thread (ty, tx) owns q rows ty + 16 r (r < TR; TR = 4
// for Dv <= 128, else 2, so a block owns 64 or 32 rows), the keys
// tx + 8 i (i < 4) of each 32-key tile, and the output columns
// VW (tx + 8 j) .. + VW - 1 (VW = 4 when 32 divides Dv, else 2). A row's
// 8 lanes are 8 neighbouring lanes of one warp. Per kv tile:
//   1. K and V tiles arrive by cp.async (16-byte copies, keys past Sk
//      zero-filled) in their own dtype: V of tile t is requested as the
//      tile starts and lands while the scores are computed, K of tile t+1
//      as soon as every thread is done with K of tile t, so it lands while
//      the softmax and P.V run. Q is staged once, as fp32.
//   2. Scores: per 4 values of d, one 16-byte load for each of the TR q
//      rows and one for each of the 4 keys, then 16 TR multiply-adds
//      (8 or 5.3 per shared load). Q and K rows are padded by 16 bytes, so
//      the 4 row groups and the 8 keys a warp reads are conflict-free.
//   3. Softmax, branch-free: row max over the 8 lanes (3 shuffles), p =
//      2^(s c - m c) and alpha = 2^((m_old - m_new) c) with c = scale *
//      log2(e) folded in (scores stay unscaled; masked ones are -1e30 in
//      those units, which gives the reference's p); each lane keeps its own
//      share of l, and the lanes add them at the end. p goes to shared
//      memory transposed (P^T[key][row]), one vector store a key.
//   4. P.V: per key one load of the thread's TR p values and Dv / (8 VW)
//      loads of V, then TR Dv / 8 multiply-adds (12.8 per load at Dv 128).
// Three barriers a tile; the shared memory plan (flash_attention.py
// simt_plan) fits 3 blocks an SM at D 128 fp32 (74 KB each) and 2 at D 256.
//
// Tensor-core kernel (bf16, D == Dv in {64, 128}): 384 threads own 128 q
// rows. Warpgroup 0 is the producer: one thread loads Q once and keeps a
// ring of kStages (K, V) tiles of 128 keys full with TMA
// (cp.async.bulk.tensor, one mbarrier per stage for "full" and one for
// "empty"), from tensor maps over the (B, S, H, D) tensors in place (a
// head's rows are H*D elements apart; no transposed copy), 128-byte
// swizzle, 64-column boxes. It gives its registers to the two consumer
// warpgroups (setmaxnreg 24 / 240), which own 64 q rows each and per tile:
//   1. S = Q K^T with wgmma m64n128k16, both operands K-major from shared
//      memory, fp32 accumulators in registers;
//   2. mask, row max over the 4 threads of a quad, p = 2^(s c - m c) with
//      c = scale * log2(e) folded in, alpha = 2^((m_old - m_new) c); each
//      thread keeps its share of l and the quad adds them at the end;
//   3. p is rounded to bf16 in registers: the accumulator fragment of keys
//      16kk .. 16kk+15 is the A-operand fragment of the PV step kk;
//   4. O += P V with wgmma m64nDk16, A from registers, B = V from shared
//      memory, MN-major (keys x Dv): the transpose bit;
//   5. arrive on the stage's "empty" barrier.
// The output is acc * (1 / max(l, 1e-30)). While one warpgroup runs its
// softmax, the other's wgmma and the producer's loads proceed.
// cuTensorMapEncodeTiled (a driver function) is fetched with
// cudaGetDriverEntryPoint[ByVersion]: the library needs no -lcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
namespace simt {

constexpr int kThreads = 128;   // 16 row groups x 8 lanes
constexpr int kLanes = 8;       // lanes that share a row group
constexpr int kKT = 4;          // keys a thread scores per tile
constexpr int kBK = kLanes * kKT;   // keys per kv tile
constexpr int kPad = 16;        // bytes past each Q, K and P^T row
constexpr int kMinBlocks = 3;   // blocks an SM that the registers allow

// The plan flash_attention.py's simt_plan computes: rows per thread, rows
// per block, keys per tile, threads, dynamic shared bytes.
struct Plan {
  int tr, rows, keys, threads, smem;
};

// Shared memory of a block: Q fp32 [rows][D + 4], K [kBK][D + 16 / es] and
// V [kBK][Dv] in the inputs' dtype (es bytes), P^T fp32 [kBK][rows + 4].
struct Layout {
  int q_stride, k_stride, p_stride;        // in elements
  int q_off, k_off, v_off, p_off, bytes;   // in bytes
};

Layout layout(int D, int Dv, int rows, int es) {
  Layout L;
  L.q_stride = D + kPad / 4;
  L.k_stride = D + kPad / es;
  L.p_stride = rows + kPad / 4;
  L.q_off = 0;
  L.k_off = L.q_off + rows * L.q_stride * 4;
  L.v_off = L.k_off + kBK * L.k_stride * es;
  L.p_off = L.v_off + kBK * Dv * es;
  L.bytes = L.p_off + kBK * L.p_stride * 4;
  return L;
}

bool plan_ok(const Plan& p, int D, int Dv, int es) {
  const int tr = Dv <= 128 ? 4 : 2;
  return D % 16 == 0 && D >= 16 && D <= 256 && p.tr == tr &&
         p.rows == 16 * tr && p.keys == kBK && p.threads == kThreads &&
         p.smem == layout(D, Dv, p.rows, es).bytes && p.smem <= kMaxSmem;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; a row that is not valid is
// zero-filled (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive values from shared memory as fp32 (N = 2 or 4)
template <int N>
__device__ __forceinline__ void load(const float* p, float* o) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
}
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
template <int N>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* o) {
  if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    o[0] = lo_bf16(v.x); o[1] = hi_bf16(v.x);
    o[2] = lo_bf16(v.y); o[3] = hi_bf16(v.y);
  } else {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    o[0] = lo_bf16(v); o[1] = hi_bf16(v);
  }
}

// N values to global memory in the output's dtype
template <int N>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}
template <int N>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  if constexpr (N == 4)
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  else
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(v[0], v[1]);
}

// 16 bytes of q (4 fp32 or 8 bf16 values) to fp32 in shared memory
__device__ __forceinline__ void q_chunk(float* dst, const float* src,
                                        bool valid) {
  const float4 v = valid ? __ldg(reinterpret_cast<const float4*>(src))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void q_chunk(float* dst, const __nv_bfloat16* src,
                                        bool valid) {
  const uint4 v = valid ? __ldg(reinterpret_cast<const uint4*>(src))
                        : make_uint4(0u, 0u, 0u, 0u);
  *reinterpret_cast<float4*>(dst) =
      make_float4(lo_bf16(v.x), hi_bf16(v.x), lo_bf16(v.y), hi_bf16(v.y));
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(lo_bf16(v.z), hi_bf16(v.z), lo_bf16(v.w), hi_bf16(v.w));
}

// p rounded to the value type, as the reference's p.astype(v.dtype)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// A thread's walk over the 16-byte chunks of a tile of `rows` rows of
// `cpr` chunks each, 128 threads apart: its first chunk, and the step, as
// (row, chunk) pairs (no division per chunk).
struct Walk {
  int r0, c0, dr, dc, cpr;
  __device__ Walk(int tid, int cpr_) : cpr(cpr_) {
    r0 = tid / cpr;
    c0 = tid - r0 * cpr;
    dr = kThreads / cpr;
    dc = kThreads - dr * cpr;
  }
  __device__ __forceinline__ void next(int& r, int& c) const {
    c += dc;
    r += dr;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
};

// cp.async of kBK rows (keys k0 ..) of a (B, Sk, Hkv, width) tensor's kv
// head into shared rows `stride` elements apart; keys past Sk read 0
template <typename T>
__device__ __forceinline__ void stage(T* dst, int stride, const T* src,
                                      size_t row_step, int k0, int Sk,
                                      const Walk& w) {
  constexpr int E = 16 / sizeof(T);
  for (int r = w.r0, c = w.c0; r < kBK; w.next(r, c)) {
    const bool valid = k0 + r < Sk;
    const T* g = src + (valid ? (size_t)(k0 + r) * row_step : 0) + c * E;
    cp_async16(dst + r * stride + c * E, g, valid);
  }
}

template <typename T, int TR, int DV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int Hq, int Hkv, int D, int causal, float scale, Layout L) {
  constexpr int kRows = 16 * TR;
  constexpr int VW = DV % 32 == 0 ? 4 : 2;   // output columns a vector
  constexpr int NV = DV / (kLanes * VW);     // vectors a thread
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) uint8_t smem[];
  float* Qs = reinterpret_cast<float*>(smem + L.q_off);
  T* Ks = reinterpret_cast<T*>(smem + L.k_off);
  T* Vs = reinterpret_cast<T*>(smem + L.v_off);
  float* Ps = reinterpret_cast<float*>(smem + L.p_off);

  const int tid = threadIdx.x, ty = tid / kLanes, tx = tid % kLanes;
  const int n_qt = gridDim.y;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kRows;  // longest first
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const int k_end = causal ? min(Sk, q0 + kRows) : Sk;  // later tiles masked
  const int n_tiles = (k_end + kBK - 1) / kBK;
  const float c = scale * kLog2e;

  const size_t k_step = (size_t)Hkv * D, v_step = (size_t)Hkv * DV;
  const T* kb = k + ((size_t)b * Sk * Hkv + hk) * D;
  const T* vb = v + ((size_t)b * Sk * Hkv + hk) * DV;
  const Walk wk(tid, D / E), wv(tid, DV / E);

  // Q once, as fp32; then K of the first tile
  {
    const Walk wq(tid, D / E);
    const T* qb = q + ((size_t)b * Sq * Hq + h) * D;
    for (int r = wq.r0, cc = wq.c0; r < kRows; wq.next(r, cc)) {
      const bool valid = q0 + r < Sq;
      q_chunk(Qs + r * L.q_stride + cc * E,
              qb + (valid ? (size_t)(q0 + r) * Hq * D : 0) + cc * E, valid);
    }
  }
  stage(Ks, L.k_stride, kb, k_step, 0, Sk, wk);
  cp_async_commit();

  float m[TR], l[TR], acc[TR][NV * VW];
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < NV * VW; ++j) acc[r][j] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    cp_async_wait<0>();   // this thread's copies of K (tile t) are in
    __syncthreads();      // everyone's are; P.V of tile t-1 is done
    stage(Vs, DV, vb, v_step, k0, Sk, wv);
    cp_async_commit();

    // scores: s[r][i] = q row (ty + 16 r) . key (k0 + tx + 8 i), unscaled
    float s[TR][kKT];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int i = 0; i < kKT; ++i) s[r][i] = 0.0f;
    const float* qrow = Qs + ty * L.q_stride;
    const T* krow = Ks + tx * L.k_stride;
    for (int d0 = 0; d0 < D; d0 += 16) {
#pragma unroll
      for (int dd = 0; dd < 16; dd += 4) {
        float qv[TR][4], kv[kKT][4];
#pragma unroll
        for (int r = 0; r < TR; ++r)
          load<4>(qrow + 16 * r * L.q_stride + d0 + dd, qv[r]);
#pragma unroll
        for (int i = 0; i < kKT; ++i)
          load<4>(krow + kLanes * i * L.k_stride + d0 + dd, kv[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int r = 0; r < TR; ++r)
#pragma unroll
            for (int i = 0; i < kKT; ++i)
              s[r][i] = fmaf(qv[r][e], kv[i][e], s[r][i]);
      }
    }
    __syncthreads();      // K of tile t is consumed: fetch tile t+1's
    if (t + 1 < n_tiles)
      stage(Ks, L.k_stride, kb, k_step, k0 + kBK, Sk, wk);
    cp_async_commit();    // (an empty group on the last tile)

    // masks, on the tiles that need them (a uniform branch)
    if (k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0)) {
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int i = 0; i < kKT; ++i) {
          const int key = k0 + tx + kLanes * i;
          if (causal && key > q0 + ty + 16 * r) s[r][i] = kNegInf;
          if (key >= Sk) s[r][i] = -INFINITY;   // p = 0, not in the max
        }
    }
    // online softmax; p^T to shared memory
    float p[kKT][TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f((m[r] - m_new) * c);
      const float mc = m_new * c;
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kKT; ++i) {
        const float pv = exp2f(fmaf(s[r][i], c, -mc));
        sum += pv;
        p[i][r] = round_to(pv, v);
      }
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NV * VW; ++j) acc[r][j] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < kKT; ++i) {
      float* dst = Ps + (tx + kLanes * i) * L.p_stride + ty * TR;
      if constexpr (TR == 4)
        *reinterpret_cast<float4*>(dst) =
            make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(p[i][0], p[i][1]);
    }
    cp_async_wait<1>();   // V of tile t is in (K of t+1 may still fly)
    __syncthreads();      // and everyone's, and every p

    // O += P V over the tile's keys (keys past Sk have p = 0, V = 0)
    const float* prow = Ps + ty * TR;
    const T* vcol = Vs + VW * tx;
#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      float pv[TR], vv[NV][VW];
      load<TR>(prow + key * L.p_stride, pv);
#pragma unroll
      for (int j = 0; j < NV; ++j)
        load<VW>(vcol + key * DV + VW * kLanes * j, vv[j]);
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            acc[r][j * VW + e] = fmaf(pv[r], vv[j][e], acc[r][j * VW + e]);
    }
  }
  cp_async_wait<0>();     // nothing in flight when the block ends

  // each row's l is spread over its 8 lanes
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr += __shfl_xor_sync(0xffffffffu, lr, 4);
    const int qr = q0 + ty + 16 * r;
    if (qr >= Sq) continue;
    const float inv = 1.0f / fmaxf(lr, 1e-30f);
    T* orow = out + (((size_t)b * Sq + qr) * Hq + h) * DV + VW * tx;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float o[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) o[e] = acc[r][j * VW + e] * inv;
      store<VW>(orow + VW * kLanes * j, o);
    }
  }
}

template <typename T, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int* dims, const Plan& p, int causal, float scale,
                   int device, cudaStream_t stream) {
  constexpr int TR = DV <= 128 ? 4 : 2;
  const int B = dims[0], Sq = dims[1], Sk = dims[2], Hq = dims[3],
            Hkv = dims[4], D = dims[5];
  if (!plan_ok(p, D, DV, sizeof(T))) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return cudaErrorMisalignedAddress;
  cudaError_t err =
      allow_smem((const void*)flash_kernel<T, TR, DV>, p.smem, device);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Sq + p.rows - 1) / p.rows);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  flash_kernel<T, TR, DV><<<grid, kThreads, p.smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, Hq, Hkv, D,
      causal, scale, layout(D, DV, p.rows, sizeof(T)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int Dv, const void* q, const void* k, const void* v,
                     void* out, const int* dims, const Plan& p, int causal,
                     float scale, int device, cudaStream_t s) {
#define SIMT_CASE(DV)                                                   \
  case DV:                                                              \
    return launch<T, DV>(q, k, v, out, dims, p, causal, scale, device, s);
  switch (Dv) {
    SIMT_CASE(16) SIMT_CASE(32) SIMT_CASE(64) SIMT_CASE(80) SIMT_CASE(128)
    SIMT_CASE(256)
#undef SIMT_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace simt

}  // namespace

// ------------------------------------------------------------------------
// The tensor-core kernel: bf16 q, k, v with D == Dv in {64, 128}.
namespace tc {

constexpr int kRows = 64;               // q rows per consumer warpgroup
constexpr int kCons = 2;                // consumer warpgroups per block
constexpr int kBQ = kRows * kCons;      // q rows per block
constexpr int kBK = 128;                // keys per kv tile
constexpr int kStages = 2;              // K/V ring depth
constexpr int kThreads = 128 * (kCons + 1);  // + the producer warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// until the phase of the given parity has completed; a wait of ~2^34
// cycles (seconds) means a lost arrival or transfer, and traps (the launch
// fails) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// ---- TMA: one box of a 4D (D, H, S, B) tensor map into shared memory
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint64_t* bar,
                                         void* dst, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma
// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instructions that own them.
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64, fp32) = A (64 x 16, smem) . B (64 x 16, smem)^T, plus d
// when acc is nonzero
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 128, fp32) = A (64 x 16, smem) . B (128 x 16, smem)^T, plus d
// when acc is nonzero
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) . B (16 x 64,
// smem, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 registers) . B (16 x 128,
// smem, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int acc) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, acc);
  else wgmma_ss_n128(d, a, b, acc);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared memory for head width D (== Dv): Q [D/64][kBQ][64], then K and V
// [kStages][D/64][kBK][64], each 64-column slab a TMA box in the 128-byte
// swizzle, 1024-aligned.
template <int D>
struct Smem {
  static constexpr int Q_BYTES = kBQ * D * 2;
  static constexpr int KV_BYTES = kBK * D * 2;  // one K or V tile
  static constexpr size_t BYTES = 1024 + Q_BYTES + 2 * kStages * KV_BYTES;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, int Sq, int Sk, int Hq,
                int Hkv, int causal, float scale) {
  using C = Smem<D>;
  constexpr int kSlabs = D / 64;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages], qbar;
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = Qs + C::Q_BYTES;
  uint8_t* Vs = Ks + kStages * C::KV_BYTES;

  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;  // later tiles masked
  const int n_tiles = (k_end + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kCons * 128);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(&qbar, C::Q_BYTES);
      for (int c = 0; c < kSlabs; ++c)
        tma_load(&tq, &qbar, Qs + c * kBQ * 128, c * 64, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        uint8_t* ks = Ks + s * C::KV_BYTES;
        uint8_t* vs = Vs + s * C::KV_BYTES;
        for (int c = 0; c < kSlabs; ++c) {
          tma_load(&tk, &full[s], ks + c * kBK * 128, c * 64, hk, t * kBK, b);
          tma_load(&tv, &full[s], vs + c * kBK * 128, c * 64, hk, t * kBK, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns q rows q0 + 64 cw .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1, warp = tid / 32, lane = tid % 32;
  const int r0 = cw * kRows + warp * 16 + lane / 4;  // row in block; r0 + 8
  const int qr0 = q0 + r0, qr1 = qr0 + 8;
  const int cq = (lane % 4) * 2;  // column pair in each 8-column block
  const float c = scale * kLog2e;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  const uint32_t q_addr = smem_u32(Qs) + cw * kRows * 128;
  mbar_wait(&qbar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages, k0 = t * kBK;
    mbar_wait(&full[s], (t / kStages) & 1);
    const uint32_t k_addr = smem_u32(Ks + s * C::KV_BYTES);
    const uint32_t v_addr = smem_u32(Vs + s * C::KV_BYTES);

    // S = Q K^T: both K-major; a k16 step is 32 bytes into a 128-byte row
    float sc[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.0f;
    pin<kBK / 2>(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kBK>(sc,
                   desc(q_addr + (kk / 4) * kBQ * 128 + (kk % 4) * 32, 16,
                        1024),
                   desc(k_addr + (kk / 4) * kBK * 128 + (kk % 4) * 32, 16,
                        1024),
                   kk > 0);
    wg_commit();
    wg_wait0();
    pin<kBK / 2>(sc);

    // sc[4j + e]: row r0 (e < 2) or r0 + 8, key k0 + 8j + cq + (e & 1)
    if (k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0 + cw * kRows)) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + cq + (e & 1);
          if (causal && key > (e < 2 ? qr0 : qr1)) sc[4 * j + e] = kNegInf;
          if (key >= Sk) sc[4 * j + e] = -INFINITY;  // p = 0, not in the max
        }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f((m0 - mx0) * c), a1 = exp2f((m1 - mx1) * c);
    m0 = mx0;
    m1 = mx1;
    const float mc0 = m0 * c, mc1 = m1 * c;

    // p = 2^(s c - m c); the fp32 p feed l, bf16 p the PV product. The
    // accumulator layout of keys 16kk .. 16kk + 15 is the A-operand
    // register layout of the k16 step kk.
    uint32_t pa[kBK / 16][4];
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float p0 = exp2f(fmaf(sc[4 * j], c, -mc0));
      const float p1 = exp2f(fmaf(sc[4 * j + 1], c, -mc0));
      const float p2 = exp2f(fmaf(sc[4 * j + 2], c, -mc1));
      const float p3 = exp2f(fmaf(sc[4 * j + 3], c, -mc1));
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }

    // O += P V: V is keys x Dv, MN-major (the transpose bit); a k16 step is
    // 16 key rows, 2048 bytes; LBO steps between 64-column slabs
    pin<D / 2>(o);
    pin<kBK / 4>(&pa[0][0]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], desc(v_addr + kk * 2048, kBK * 128, 1024));
    wg_commit();
    wg_wait0();
    pin<D / 2>(o);
    pin<kBK / 4>(&pa[0][0]);
    mbar_arrive(&empty[s]);
  }

  // each row's l is spread over the 4 threads of a quad
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* row0 = out + (((size_t)b * Sq + qr0) * Hq + h) * D + cq;
  __nv_bfloat16* row1 = out + (((size_t)b * Sq + qr1) * Hq + h) * D + cq;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (qr0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(row0 + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (qr1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(row1 + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// cuTensorMapEncodeTiled is a driver function: fetched through the runtime
// (cudaGetDriverEntryPoint), so the library links against no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The (B, S, H, D) tensor in place as a 4D map (D, H, S, B): boxes of 64
// columns x one head x `rows` rows, 128-byte swizzle; rows past S read 0.
cudaError_t make_map(EncodeTiled fn, CUtensorMap* map, const void* ptr,
                     int B, int S, int H, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int* dims, int causal, float scale, int device,
                   cudaStream_t stream) {
  const int B = dims[0], Sq = dims[1], Sk = dims[2], Hq = dims[3],
            Hkv = dims[4];
  EncodeTiled fn;
  cudaError_t err = encode_fn(&fn);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if ((err = make_map(fn, &tq, q, B, Sq, Hq, D, kBQ)) != cudaSuccess ||
      (err = make_map(fn, &tk, k, B, Sk, Hkv, D, kBK)) != cudaSuccess ||
      (err = make_map(fn, &tv, v, B, Sk, Hkv, D, kBK)) != cudaSuccess)
    return err;
  if ((err = allow_smem((const void*)flash_tc_kernel<D>,
                        (int)Smem<D>::BYTES, device)) != cudaSuccess)
    return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_tc_kernel<D><<<grid, kThreads, Smem<D>::BYTES, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, Sq, Sk, Hq, Hkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace tc

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). dims: B, Sq, Sk, Hq,
// Hkv, D, Dv with Hq % Hkv == 0, D a multiple of 16 in [16, 256], Dv in
// {16, 32, 64, 80, 128, 256}. q (B, Sq, Hq, D), k (B, Sk, Hkv, D), v
// (B, Sk, Hkv, Dv), out (B, Sq, Hq, Dv), all contiguous and 16-byte
// aligned. plan: simt_plan's 5 ints. causal: kpos <= qpos, both from 0.
extern "C" int flash_attention_forward(int dtype, const void* q,
                                       const void* k, const void* v,
                                       void* out, const int* dims,
                                       const int* plan, int causal,
                                       float scale, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const simt::Plan p{plan[0], plan[1], plan[2], plan[3], plan[4]};
  if (dtype == 0)
    err = simt::dispatch<float>(dims[6], q, k, v, out, dims, p, causal,
                                scale, device, s);
  else
    err = simt::dispatch<__nv_bfloat16>(dims[6], q, k, v, out, dims, p,
                                        causal, scale, device, s);
  return (int)err;
}

// bf16 q, k, v and out; dims as flash_attention_forward, with D == Dv in
// {64, 128} and q, k, v 16-byte aligned.
extern "C" int flash_attention_tc_forward(const void* q, const void* k,
                                          const void* v, void* out,
                                          const int* dims, int causal,
                                          float scale, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dims[5] != dims[6]) return (int)cudaErrorInvalidValue;
  switch (dims[5]) {
    case 64:
      return (int)tc::launch<64>(q, k, v, out, dims, causal, scale, device, s);
    case 128:
      return (int)tc::launch<128>(q, k, v, out, dims, causal, scale, device,
                                  s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
