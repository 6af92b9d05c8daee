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
// them causal), ~0.35 ms at qwen2.5-32b's prefill widths (S 4096, bf16) on
// the tensor cores.
//
// SIMT kernel (fp32, and bf16 at other widths): 256 threads own 64 q rows;
// per 64-key tile:
//   1. K and V tiles are staged in shared memory as fp32 (Q stays there for
//      the whole walk; rows padded by one float so that the column reads of
//      the score loop hit 16 distinct banks);
//   2. each thread computes a 4 x 4 block of scores (rows ty*4+i, keys
//      tx+16j), as the fp32 dot times 1/sqrt(D);
//   3. the row max and sum are reduced over the 16 lanes that share a row
//      (warp shuffles); running max m, denominator l and the accumulator
//      rescale by alpha = exp(m_old - m_new);
//   4. p goes through shared memory, and each thread adds its 4 rows x
//      Dv/16 columns of P V.
// Every multiply-add runs on the fp32 pipes from shared memory (one shared
// load for every two FMAs in the score loop), far from the tensor-core
// bound; fp32's 2e-5 tolerance rules out TF32.
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

// ------------------------------------------------------------------------
// The tensor-core kernel: bf16 q, k, v with D == Dv in {64, 128}.
namespace tc {

constexpr int kRows = 64;               // q rows per consumer warpgroup
constexpr int kCons = 2;                // consumer warpgroups per block
constexpr int kBQ = kRows * kCons;      // q rows per block
constexpr int kBK = 128;                // keys per kv tile
constexpr int kStages = 2;              // K/V ring depth
constexpr int kThreads = 128 * (kCons + 1);  // + the producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

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
                   const int* dims, int causal, float scale,
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
  err = cudaFuncSetAttribute(flash_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Smem<D>::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_tc_kernel<D><<<grid, kThreads, Smem<D>::BYTES, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, Sq, Sk, Hq, Hkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace tc

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
    case 64: return (int)tc::launch<64>(q, k, v, out, dims, causal, scale, s);
    case 128:
      return (int)tc::launch<128>(q, k, v, out, dims, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
