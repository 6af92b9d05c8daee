// (M, K) @ (K, N) with an fp32 accumulator and an optional silu / tanh
// epilogue; any M, K, N, in one launch.
//
// Replaces: src/repro/kernels/gemm.py, gemm (_gemm_kernel). The Pallas
// kernel pads M/K/N up to (8|128)-multiples in HBM, pins the weight block
// in VMEM and walks K as the sequential grid axis into a VMEM accumulator.
//
// What bounds it on the H100: on this path M is 1 (CRONet's FCs and RNN
// steps are GEMVs), so the work is a read of every weight once for two
// flops: bytes. trunk fc1 (1x4800x40) moves 768 KB, 0.23 us at 3.35 TB/s;
// the other calls move 8-400 KB. What a call really costs is latency: the
// launch, one round trip to memory, and the steps that combine the partial
// sums. The design keeps each of those to one:
//  * one launch, whatever K. The grid is (column tiles x cluster, rows).
//    The blocks of one thread-block cluster (up to 8, the portable size)
//    split K; each reduces its K slice in registers and warp shuffles;
//  * the warps of a block meet in shared memory (one barrier; none when
//    the block is one warp), and the blocks of a cluster meet in shared
//    memory too: each rank writes its column sums into rank 0's shared
//    memory (distributed shared memory), one cluster.sync(), and rank 0
//    adds them in rank order, applies the epilogue and stores. No partial
//    buffer in device memory, no second kernel, no atomics;
//  * every weight load is 16 bytes (4 fp32 or 8 bf16 along N) when N is a
//    multiple of that width, else one element (the odd shapes); a thread
//    issues all its loads (up to kLoads weight vectors and their x values)
//    before its first FMA, so a block waits for one memory round trip;
//  * a block owns `groups` column vectors (a power of two up to 8 that
//    divides N's vectors), so N = 40 and N = 64 leave no block half empty;
//    a warp's lanes are (k lane, column group) with the group fastest.
// The wrapper computes the plan (kernels/gemm.py, gemm_plan) and passes it
// in. Every sum has a fixed order for a given plan: each thread's FMA chain
// over its k in increasing order, the shuffle tree, warps in order, then
// ranks in order. So a result is the same bits from call to call.
// x and w may each be fp32 or bf16 (both are read as fp32, as the Pallas
// kernel casts them); the output has x's dtype.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxGroups = 8;
constexpr int kMaxCols = 64;     // groups * vec: 8 x 8 bf16 or 8 x 4 fp32
constexpr int kMaxCluster = 8;
constexpr int kLoads = 8;        // weight vectors a thread holds at once

// The launch plan (kernels/gemm.py, gemm_plan): a block owns `groups`
// column vectors of `vec` columns each and `kblock` k values; its threads
// are (klanes x groups); `cluster` blocks share a column tile and split K.
struct Plan {
  int vec, groups, klanes, cluster, kblock, tiles;
};

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// V consecutive weights as fp32: one 16-byte load for V = 4 (fp32) or
// V = 8 (bf16), one element for V = 1
__device__ __forceinline__ void load_w(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_w(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
template <typename TW>
__device__ __forceinline__ void load_w(const TW* p, float (&v)[1]) {
  v[0] = ld(p, 0);
}

// 0 = none, 1 = silu, 2 = tanh
__device__ __forceinline__ float epilogue(float v, int act) {
  if (act == 1) return v / (1.0f + expf(-v));
  if (act == 2) return tanhf(v);
  return v;
}

// grid (p.tiles * p.cluster, min(M, 65535)), cluster (p.cluster, 1, 1),
// blockDim p.groups * p.klanes. V is p.vec.
template <typename TX, typename TW, int V>
__global__ void __launch_bounds__(kMaxThreads)
gemm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
            TX* __restrict__ out, int M, int K, int N, Plan p, int act) {
  __shared__ float part[kMaxWarps][kMaxCols];  // each warp's column sums
  // rank 0's: every rank's column sums, written there by each rank
  __shared__ float gather[kMaxCluster][kMaxCols];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = tid % p.groups, q = tid / p.groups;
  const int rank = blockIdx.x % p.cluster, tile = blockIdx.x / p.cluster;
  const int cols = p.groups * V;
  const int n0 = tile * cols + g * V;
  // N % V == 0 when V > 1, so a vector is all in range or all out
  const bool col_ok = n0 < N;
  const int k0 = rank * p.kblock, k1 = min(K, k0 + p.kblock);
  // a column sum of this rank into rank 0's gather (distributed shared
  // memory; the write needs no reply, and the other ranks may exit after
  // the cluster barrier that follows)
  cg::cluster_group cluster = cg::this_cluster();
  float* gather0 = p.cluster > 1 ? cluster.map_shared_rank(&gather[0][0], 0)
                                 : &gather[0][0];
  auto to_rank0 = [&](int col, float v) {
    gather0[rank * kMaxCols + col] = v;
  };
  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    const TX* xr = x + (size_t)m * K;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    for (int kc = k0 + q; kc < k1; kc += p.klanes * kLoads) {
      float wv[kLoads][V], xv[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {   // every load first
        const int k = kc + i * p.klanes;
        if (col_ok && k < k1) {
          load_w(w + (size_t)k * N + n0, wv[i]);
          xv[i] = ld(xr, k);
        } else {
          xv[i] = 0.0f;
#pragma unroll
          for (int v = 0; v < V; ++v) wv[i][v] = 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i)     // then the FMAs, k increasing
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fmaf(xv[i], wv[i][v], acc[v]);
    }
    // k lanes of one group inside a warp: lanes g, g + groups, ...
    for (int off = 16; off >= p.groups; off >>= 1)
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[v] += __shfl_down_sync(0xffffffffu, acc[v], off);
    if (nwarps == 1) {      // lanes < groups hold the block's sums
      if (p.cluster == 1) {
        if (lane < p.groups)
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (n0 + v < N)
              st(out, (size_t)m * N + n0 + v, epilogue(acc[v], act));
        continue;
      }
      if (lane < p.groups)
#pragma unroll
        for (int v = 0; v < V; ++v) to_rank0(lane * V + v, acc[v]);
    } else {                // warps in order, through shared memory
      if (lane < p.groups)
#pragma unroll
        for (int v = 0; v < V; ++v) part[warp][lane * V + v] = acc[v];
      __syncthreads();
      float s = 0.0f;
      if (tid < cols) {
        s = part[0][tid];
        for (int i = 1; i < nwarps; ++i) s += part[i][tid];
      }
      if (p.cluster == 1) {
        const int n = tile * cols + tid;
        if (tid < cols && n < N) st(out, (size_t)m * N + n, epilogue(s, act));
        if (m + (int)gridDim.y < M) __syncthreads();   // part is reused
        continue;
      }
      if (tid < cols) to_rank0(tid, s);
    }
    cluster.sync();                        // every rank's sums are in rank 0
    if (rank == 0 && tid < cols) {
      const int n = tile * cols + tid;
      float t = gather[0][tid];
      for (int r = 1; r < p.cluster; ++r) t += gather[r][tid];
      if (n < N) st(out, (size_t)m * N + n, epilogue(t, act));
    }
    if (m + (int)gridDim.y < M) cluster.sync();   // gather is reused
  }
}

bool plan_ok(const Plan& p, int K, int N, int wsize, const void* w) {
  const int threads = p.groups * p.klanes;
  const bool vec_ok =
      p.vec == 1 || (p.vec == 16 / wsize && N % p.vec == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const bool groups_ok = p.groups >= 1 && p.groups <= kMaxGroups &&
                         (p.groups & (p.groups - 1)) == 0;
  return vec_ok && groups_ok && p.groups * p.vec <= kMaxCols &&
         p.klanes >= 1 && threads % 32 == 0 && threads <= kMaxThreads &&
         p.cluster >= 1 && p.cluster <= kMaxCluster && p.kblock >= 0 &&
         (long long)p.cluster * p.kblock >= K &&
         (long long)p.tiles * p.groups * p.vec >= N;
}

template <typename TX, typename TW, int V>
cudaError_t launch_v(const void* x, const void* w, void* out, int M, int K,
                     int N, const Plan& p, int act, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles * p.cluster, M < 65535 ? M : 65535, 1);
  cfg.blockDim = dim3(p.groups * p.klanes, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;   // one block a tile: no cluster
  cudaError_t err = cudaLaunchKernelEx(&cfg, gemm_kernel<TX, TW, V>,
                                       (const TX*)x, (const TW*)w, (TX*)out,
                                       M, K, N, p, act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, int M, int K,
                   int N, const Plan& p, int act, cudaStream_t stream) {
  if (!plan_ok(p, K, N, (int)sizeof(TW), w)) return cudaErrorInvalidValue;
  if (p.vec == 1) return launch_v<TX, TW, 1>(x, w, out, M, K, N, p, act, stream);
  return launch_v<TX, TW, (int)(16 / sizeof(TW))>(x, w, out, M, K, N, p, act, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; out (M, N) has x's dtype.
// act: 0 none, 1 silu, 2 tanh. M, N >= 1. The plan is gemm_plan's, as
// (vec, groups, klanes, cluster, kblock, tiles). Returns the launch's
// cudaError_t: cudaErrorInvalidValue for a plan the kernel cannot run.
extern "C" int gemm_forward(int x_dtype, int w_dtype, const void* x,
                            const void* w, void* out, int M, int K, int N,
                            int act, int vec, int groups, int klanes,
                            int cluster, int kblock, int tiles, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Plan p{vec, groups, klanes, cluster, kblock, tiles};
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && w_dtype == 0)
    err = launch<float, float>(x, w, out, M, K, N, p, act, s);
  else if (x_dtype == 0)
    err = launch<float, __nv_bfloat16>(x, w, out, M, K, N, p, act, s);
  else if (w_dtype == 0)
    err = launch<__nv_bfloat16, float>(x, w, out, M, K, N, p, act, s);
  else
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, M, K, N, p, act, s);
  return (int)err;
}

extern "C" const char* gemm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
