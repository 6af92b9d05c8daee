// Fused sLSTM: the whole recurrence in one persistent cooperative launch.
//
// Replaces: src/repro/kernels/slstm.py, slstm_fused (_slstm_kernel). The
// Pallas kernel keeps R (block-diagonal, (nh, dh, 4dh)) and the (h, c, n,
// m) state in VMEM for the whole sequence; one grid step per (batch tile,
// time block) runs the time steps of the block in order.
//
// On the H100 no SM holds R at xlstm-1.3b's widths (4 heads of 512 units:
// 4 x 512 x 2048 x 4 B = 16 MB against 227 KB of shared memory), and every
// gate of a step needs the whole of its head's h from the step before. So
// the units are spread over the card and the steps are separated by grid
// barriers:
//   * block = U hidden units of one head (U = 16 at dh = 512: 128 blocks),
//     holding its units' four gate columns {z, i, f, o} of R for the whole
//     sequence in shared memory (dh x 4U fp32: 128 KB), and the c, n, m of
//     its units for every batch row;
//   * each step the block reads its head's h of the step before (all batch
//     rows) from a double-buffered fp32 array in L2 (__ldcg: other SMs wrote
//     it), computes the 4U x B gate pre-activations as dh-long dot products
//     split over KS slices of threads (each slice in order, the slices then
//     added in order, so the sum does not depend on B or on the tiling
//     keywords), adds wx (fetched at the start of the step, its latency
//     hidden behind the dot products), updates c, n, m, h, writes h to the
//     output and to the other h buffer, and crosses one grid barrier
//     (cooperative_groups::this_grid().sync()).
// The launch is cooperative (cudaLaunchCooperativeKernel); the entry point
// checks with the occupancy calculator that every block can be resident at
// once and returns kNotCoResident otherwise. There is no fallback.
//
// Numerics as in the reference: fp32 state from zero (m0 = 0 too),
// log_sigmoid computed stably, h = o * c / max(|n|, 1), h rounded to wx's
// dtype on output only.
//
// What bounds it on the H100: operations. 2*B*S*nh*dh*4dh flops take
// ~4.1 ms at 67 TFLOP/s (B 8, S 4096; fp32 outside the tensor cores), and
// 1.34 GB of wx and h traffic ~0.40 ms. This kernel pays a grid barrier
// (a few microseconds) and a dependent chain of shared-memory loads each
// step, so a step costs far more than its share of either bound.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBatchRegs = 8;           // batch rows per register pass
constexpr int kNotCoResident = 100001;  // returned, never a CUDA error

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return x >= 0.0f ? -log1pf(expf(-x)) : x - log1pf(expf(x));
}

struct Plan {
  int U, KS, threads, blocks;
  size_t smem;
};

Plan plan_for(int B, int nh, int dh) {
  Plan p;
  p.U = 1;
  for (int u = 16; u >= 1; --u)
    if (dh % u == 0) { p.U = u; break; }
  // slices of the dot product: as many as fit, each a multiple of 4 long
  // where dh allows (float4 reads of h)
  p.KS = 0;
  for (int ks = 8; ks >= 1; ks >>= 1)
    if (dh % (4 * ks) == 0 && 4 * p.U * ks <= 1024) { p.KS = ks; break; }
  if (p.KS == 0)
    for (int ks = 8; ks >= 1; ks >>= 1)
      if (dh % ks == 0 && 4 * p.U * ks <= 1024) { p.KS = ks; break; }
  p.threads = 4 * p.U * p.KS;
  p.blocks = nh * (dh / p.U);
  const size_t four_u = 4 * (size_t)p.U;
  p.smem = sizeof(float) * ((size_t)B * dh + (size_t)dh * four_u +
                            (size_t)p.KS * B * four_u + (size_t)B * four_u +
                            3 * (size_t)B * p.U);
  return p;
}

template <typename T>
__global__ void slstm_kernel(const T* __restrict__ wx,
                             const float* __restrict__ r, T* __restrict__ out,
                             float* hbuf, int B, int S, int nh, int dh, int U,
                             int KS) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int four_u = 4 * U, d = nh * dh;
  float* hs = smem;                         // [B][dh]   h of the step before
  float* Rs = hs + (size_t)B * dh;          // [dh][4U]  q = g * U + u
  float* part = Rs + (size_t)dh * four_u;   // [KS][B][4U]
  float* wxs = part + (size_t)KS * B * four_u;  // [B][4U]
  float* cs = wxs + (size_t)B * four_u;     // [B][U]
  float* ns = cs + (size_t)B * U;
  float* ms = ns + (size_t)B * U;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int per_head = dh / U;
  const int hh = blockIdx.x / per_head;
  const int u0 = (blockIdx.x % per_head) * U;
  const int col0 = hh * dh + u0;  // first global unit of the block

  for (int idx = tid; idx < dh * four_u; idx += nthreads) {
    const int k = idx / four_u, q = idx - k * four_u;
    const int g = q / U, u = q - g * U;
    Rs[idx] = r[((size_t)hh * dh + k) * 4 * dh + g * dh + u0 + u];
  }
  for (int idx = tid; idx < B * dh; idx += nthreads) hs[idx] = 0.0f;
  for (int idx = tid; idx < B * U; idx += nthreads)
    cs[idx] = ns[idx] = ms[idx] = 0.0f;

  const int slice = tid / four_u, q = tid - slice * four_u;
  const int len = dh / KS, k_lo = slice * len, k_hi = k_lo + len;
  const bool vec = (len % 4) == 0;
  // the wx element this thread fetches each step (one per thread when
  // B * 4U <= threads; the rest are read after the dot products)
  const bool own_wx = tid < B * four_u;
  const int wb = tid / four_u, wq = tid - wb * four_u;
  const size_t wcol = (size_t)(wq / U) * d + col0 + (wq % U);

  for (int t = 0; t < S; ++t) {
    const float* hprev = hbuf + (size_t)(t & 1) * B * d;
    float* hnext = hbuf + (size_t)((t + 1) & 1) * B * d;
    if (t > 0)
      for (int idx = tid; idx < B * dh; idx += nthreads) {
        const int b = idx / dh, k = idx - b * dh;
        hs[idx] = __ldcg(hprev + (size_t)b * d + hh * dh + k);
      }
    float wx_own = 0.0f;
    if (own_wx) wx_own = ld(wx, ((size_t)wb * S + t) * 4 * d + wcol);
    __syncthreads();

    for (int b0 = 0; b0 < B; b0 += kBatchRegs) {
      const int nb = min(kBatchRegs, B - b0);
      float acc[kBatchRegs];
#pragma unroll
      for (int bb = 0; bb < kBatchRegs; ++bb) acc[bb] = 0.0f;
      if (vec) {
        for (int k = k_lo; k < k_hi; k += 4) {
          const float r0 = Rs[(k + 0) * four_u + q];
          const float r1 = Rs[(k + 1) * four_u + q];
          const float r2 = Rs[(k + 2) * four_u + q];
          const float r3 = Rs[(k + 3) * four_u + q];
#pragma unroll
          for (int bb = 0; bb < kBatchRegs; ++bb) {
            if (bb < nb) {
              const float4 h4 =
                  *reinterpret_cast<const float4*>(hs + (b0 + bb) * dh + k);
              float a = acc[bb];
              a += h4.x * r0;
              a += h4.y * r1;
              a += h4.z * r2;
              a += h4.w * r3;
              acc[bb] = a;
            }
          }
        }
      } else {
        for (int k = k_lo; k < k_hi; ++k) {
          const float rk = Rs[k * four_u + q];
#pragma unroll
          for (int bb = 0; bb < kBatchRegs; ++bb)
            if (bb < nb) acc[bb] += hs[(b0 + bb) * dh + k] * rk;
        }
      }
#pragma unroll
      for (int bb = 0; bb < kBatchRegs; ++bb)
        if (bb < nb) part[((size_t)slice * B + b0 + bb) * four_u + q] = acc[bb];
    }
    if (own_wx) wxs[tid] = wx_own;
    for (int idx = nthreads + tid; idx < B * four_u; idx += nthreads) {
      const int b = idx / four_u, qq = idx - b * four_u;
      wxs[idx] = ld(wx, ((size_t)b * S + t) * 4 * d +
                            (size_t)(qq / U) * d + col0 + (qq % U));
    }
    __syncthreads();

    for (int idx = tid; idx < B * U; idx += nthreads) {
      const int b = idx / U, u = idx - b * U;
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float rh = 0.0f;
        for (int s = 0; s < KS; ++s)
          rh += part[((size_t)s * B + b) * four_u + g * U + u];
        pre[g] = wxs[b * four_u + g * U + u] + rh;
      }
      const float z = tanhf(pre[0]);
      const float i_pre = pre[1];
      const float log_f = log_sigmoid(pre[2]);
      const float o = 1.0f / (1.0f + expf(-pre[3]));
      const float m = ms[idx];
      const float m_new = fmaxf(log_f + m, i_pre);
      const float i_g = expf(i_pre - m_new);
      const float f_g = expf(log_f + m - m_new);
      const float c = f_g * cs[idx] + i_g * z;
      const float n = f_g * ns[idx] + i_g;
      const float h = o * c / fmaxf(fabsf(n), 1.0f);
      cs[idx] = c;
      ns[idx] = n;
      ms[idx] = m_new;
      st(out, ((size_t)b * S + t) * d + col0 + u, h);
      __stcg(hnext + (size_t)b * d + col0 + u, h);
    }
    if (t + 1 < S) grid.sync();  // h of step t visible to every block
  }
}

template <typename T>
int launch(const void* wx, const float* r, void* out, float* hbuf, int B,
           int S, int nh, int dh, int device, cudaStream_t stream) {
  const Plan p = plan_for(B, nh, dh);
  cudaError_t err = cudaFuncSetAttribute(
      slstm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0, coop = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, slstm_kernel<T>,
                                                      p.threads, p.smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!coop || (long long)per_sm * sms < p.blocks) return kNotCoResident;
  const T* wx_t = (const T*)wx;
  T* out_t = (T*)out;
  int U = p.U, KS = p.KS;
  void* args[] = {(void*)&wx_t, (void*)&r, (void*)&out_t, (void*)&hbuf,
                  (void*)&B, (void*)&S, (void*)&nh, (void*)&dh, (void*)&U,
                  (void*)&KS};
  err = cudaLaunchCooperativeKernel((const void*)slstm_kernel<T>,
                                    dim3(p.blocks), dim3(p.threads), args,
                                    p.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The launch plan for (B, nh, dh): blocks, threads per block, dynamic
// shared bytes, units per block, dot-product slices.
extern "C" void slstm_plan(int B, int nh, int dh, long long* out5) {
  const Plan p = plan_for(B, nh, dh);
  out5[0] = p.blocks;
  out5[1] = p.threads;
  out5[2] = (long long)p.smem;
  out5[3] = p.U;
  out5[4] = p.KS;
}

// dtype: 0 = float32, 1 = bfloat16 (wx and out). wx (B, S, 4 nh dh) in
// [z|i|f|o] layout, r (nh, dh, 4 dh) fp32, out (B, S, nh dh), hbuf
// (2, B, nh dh) fp32 scratch; all contiguous, B, S >= 1.
extern "C" int slstm_forward(int dtype, const void* wx, const float* r,
                             void* out, float* hbuf, int B, int S, int nh,
                             int dh, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(wx, r, out, hbuf, B, S, nh, dh, device, s);
  return launch<__nv_bfloat16>(wx, r, out, hbuf, B, S, nh, dh, device, s);
}

extern "C" const char* slstm_error_string(int err) {
  if (err == kNotCoResident)
    return "the launch needs more blocks than can be resident at once "
           "(cooperative launch refused)";
  return cudaGetErrorString((cudaError_t)err);
}
