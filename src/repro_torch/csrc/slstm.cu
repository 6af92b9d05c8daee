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
// the units are spread over the card, and the blocks of a head meet once a
// step:
//   * block = U hidden units of one head (U = 16 at dh = 512: 32 blocks a
//     head, 128 in all), holding its units' four gate columns {z, i, f, o}
//     of R for the whole sequence in shared memory (dh x 4U fp32: 128 KB),
//     the head's h of the step before as hT [dh][B rounded up to 8] and the
//     c, n, m of its units;
//   * the gate pre-activations are dh-long dot products. A thread owns a
//     register tile of 4 columns x 8 batch rows over one of KS slices of k
//     (KS = 16 at dh >= 16; slice s takes k = s, s + KS, ..., so the two
//     slices of a warp read hT rows in different banks): a k step is one
//     16-byte load of R, two of hT and 32 FMAs, so shared-memory traffic
//     stays under the FMA issue rate. The slices' sums are then added in
//     slice order, after wx, by the thread that updates the unit's state;
//   * heads never exchange data, so a step waits only for its own head:
//     each block publishes the step it has finished in a flag of its own
//     (a barrier, then st.release by one thread), and a block starts a step
//     when one warp has seen every flag of its head reach the step before
//     (ld.acquire, then a barrier); h goes through a double-buffered fp32
//     array in L2 (__stcg / __ldcg, 16 bytes a load). wx for the next step
//     is fetched into registers before the wait (volatile loads, so the
//     compiler cannot sink them to their use), so its latency hides there.
// Every sum has an order that depends on dh only (never on B, time_block
// or batch_tile): per output (b, column), each slice's FMA chain in k
// order, the slices in order, wx first.
// The launch is cooperative (cudaLaunchCooperativeKernel): one grid
// barrier at the start (the flags are reset), and every block of a head
// must be resident for the waits to end. The entry point checks with the
// occupancy calculator that every block can be resident at once and
// returns kNotCoResident otherwise. There is no fallback.
//
// Numerics as in the reference: fp32 state from zero (m0 = 0 too),
// log_sigmoid computed stably, h = o * c / max(|n|, 1), h rounded to wx's
// dtype on output only.
//
// What bounds it on the H100: operations. 2*B*S*nh*dh*4dh flops take
// ~4.1 ms at 67 TFLOP/s (B 8, S 4096; fp32 outside the tensor cores), and
// 1.34 GB of wx and h traffic ~0.40 ms. A step also pays the head's
// flag round trip through L2 and the h re-read, which do not shrink with
// the work.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTileB = 8;               // batch rows a register tile
constexpr int kTileQ = 4;               // gate columns a register tile
constexpr int kHLoads = 4;              // h loads a thread has in flight
constexpr int kMaxSlices = 16;
constexpr int kMaxThreads = 256;
constexpr int kNotCoResident = 100001;  // returned, never a CUDA error

// The wrapper's plan (kernels/slstm.py, slstm_plan), field for field.
struct Plan {
  int U, KS, L, threads, blocks, per_head, bpad, smem;
};

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

// A load issued where it stands (the compiler may not sink it to its use)
__device__ __forceinline__ float ld_now(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_now(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return __uint_as_float((unsigned)v << 16);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Shared floats: Rs [dh][4U] | hT [dh][bpad + 4] | part [KS][bpad][4U] |
// c, n, m [bpad][U] each. The same sum on the host. (hT's rows are 4
// floats longer than the batch: its transposing stores then meet at most
// two to a bank.)
__host__ __device__ inline long long smem_floats(int dh, int U, int KS,
                                                 int bpad) {
  const long long four_u = 4LL * U;
  return (long long)dh * four_u + (long long)dh * (bpad + 4) +
         (long long)KS * bpad * four_u + 3LL * bpad * U;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
slstm_kernel(const T* __restrict__ wx, const float* __restrict__ r,
             T* __restrict__ out, float* hbuf, int* flags, int B, int S,
             int nh, int dh, Plan p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int U = p.U, four_u = 4 * U, bpad = p.bpad, d = nh * dh;
  const int hs = bpad + 4;                      // hT's row stride
  float* Rs = smem;                             // column q = g * U + u
  float* hT = Rs + (size_t)dh * four_u;
  float* part = hT + (size_t)dh * hs;
  float* cs = part + (size_t)p.KS * bpad * four_u;
  float* ns = cs + (size_t)bpad * U;
  float* ms = ns + (size_t)bpad * U;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int hh = blockIdx.x / p.per_head;
  const int u0 = (blockIdx.x % p.per_head) * U;
  const int col0 = hh * dh + u0;  // first global unit of the block

  for (int idx = tid; idx < dh * four_u; idx += nthreads) {
    const int k = idx / four_u, q = idx - k * four_u;
    const int g = q / U, u = q - g * U;
    Rs[idx] = r[((size_t)hh * dh + k) * 4 * dh + g * dh + u0 + u];
  }
  for (int idx = tid; idx < dh * hs; idx += nthreads) hT[idx] = 0.0f;
  for (int idx = tid; idx < bpad * U; idx += nthreads)
    cs[idx] = ns[idx] = ms[idx] = 0.0f;
  if (tid == 0) flags[blockIdx.x] = 0;

  // this thread's register tile (columns 4 * cq .. + 3, k = slice,
  // slice + KS, ...) and the (b, unit) it updates first, idx = tid, whose
  // four wx values it fetches a step ahead
  const int cq = tid % U, slice = tid / U;
  auto wx_ptr = [&](int b, int u, int g, int t) -> const T* {
    return wx + ((size_t)b * S + t) * 4 * d + (size_t)g * d + col0 + u;
  };
  const bool own = tid < B * U;
  const int ob = own ? tid / U : 0, ou = own ? tid % U : 0;
  float wxr[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) wxr[g] = own ? ld_now(wx_ptr(ob, ou, g, 0)) : 0.0f;
  const bool vec_h = (dh % 4) == 0 && (d % 4) == 0;
  grid.sync();  // every flag is reset before any block publishes a step

  for (int t = 0; t < S; ++t) {
    if (t > 0) {
      // wait for the head's blocks to finish step t - 1, then read its h
      if (tid < 32) {
        for (int j = tid; j < p.per_head; j += 32) {
          const int* f = flags + hh * p.per_head + j;
          const long long t_start = clock64();
          while (ld_acquire(f) < t) {   // a flag that never comes traps
            if (clock64() - t_start > (1LL << 34)) __trap();   // (~8 s)
          }
        }
      }
      __syncthreads();   // the acquires order every thread's reads of h
      const float* hprev = hbuf + (size_t)((t - 1) & 1) * B * d + hh * dh;
      if (vec_h) {
        const int n4 = B * (dh / 4);
        for (int i0 = tid; i0 < n4; i0 += kHLoads * nthreads) {
          float4 v[kHLoads];          // every load first, then the stores
#pragma unroll
          for (int j = 0; j < kHLoads; ++j) {
            const int idx = i0 + j * nthreads;
            const int b = idx % B, k = (idx / B) * 4;   // batch rows fastest
            if (idx < n4)
              v[j] = __ldcg(
                  reinterpret_cast<const float4*>(hprev + (size_t)b * d + k));
          }
#pragma unroll
          for (int j = 0; j < kHLoads; ++j) {
            const int idx = i0 + j * nthreads;
            const int b = idx % B, k = (idx / B) * 4;
            if (idx < n4) {
              hT[(k + 0) * hs + b] = v[j].x;
              hT[(k + 1) * hs + b] = v[j].y;
              hT[(k + 2) * hs + b] = v[j].z;
              hT[(k + 3) * hs + b] = v[j].w;
            }
          }
        }
      } else {
        for (int idx = tid; idx < B * dh; idx += nthreads) {
          const int b = idx % B, k = idx / B;
          hT[k * hs + b] = __ldcg(hprev + (size_t)b * d + k);
        }
      }
      __syncthreads();
    }

    // the slice's dot products: 4 columns x 8 batch rows a pass
    for (int b0 = 0; b0 < bpad; b0 += kTileB) {
      float acc[kTileQ][kTileB];
#pragma unroll
      for (int c = 0; c < kTileQ; ++c)
#pragma unroll
        for (int b = 0; b < kTileB; ++b) acc[c][b] = 0.0f;
#pragma unroll 4
      for (int k = slice; k < dh; k += p.KS) {
        const float4 rv =
            *reinterpret_cast<const float4*>(Rs + (size_t)k * four_u + cq * kTileQ);
        const float4 ha =
            *reinterpret_cast<const float4*>(hT + (size_t)k * hs + b0);
        const float4 hb =
            *reinterpret_cast<const float4*>(hT + (size_t)k * hs + b0 + 4);
        const float rr[kTileQ] = {rv.x, rv.y, rv.z, rv.w};
        const float hv[kTileB] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
        for (int c = 0; c < kTileQ; ++c)
#pragma unroll
          for (int b = 0; b < kTileB; ++b)
            acc[c][b] = fmaf(hv[b], rr[c], acc[c][b]);
      }
#pragma unroll
      for (int b = 0; b < kTileB; ++b)
        *reinterpret_cast<float4*>(
            part + ((size_t)slice * bpad + b0 + b) * four_u + cq * kTileQ) =
            make_float4(acc[0][b], acc[1][b], acc[2][b], acc[3][b]);
    }
    __syncthreads();

    // each (b, unit): its four pre-activations (wx, then the slices' sums
    // in slice order), then the state update
    float* hnext = hbuf + (size_t)(t & 1) * B * d;
    for (int idx = tid; idx < B * U; idx += nthreads) {
      const int b = idx / U, u = idx - b * U;
      float v[4][kMaxSlices];         // every load first, then the sums
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int sl = 0; sl < kMaxSlices; ++sl)
          v[g][sl] = sl < p.KS
                         ? part[((size_t)sl * bpad + b) * four_u + g * U + u]
                         : 0.0f;
      float pb[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float rh = v[g][0];
#pragma unroll
        for (int sl = 1; sl < kMaxSlices; ++sl)
          if (sl < p.KS) rh += v[g][sl];
        pb[g] = (idx == tid ? wxr[g] : ld(wx_ptr(b, u, g, t), 0)) + rh;
      }
      const float z = tanhf(pb[0]);
      const float i_pre = pb[1];
      const float log_f = log_sigmoid(pb[2]);
      const float o = 1.0f / (1.0f + expf(-pb[3]));
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
    if (t + 1 < S) {
      __syncthreads();  // every h of step t of this block is stored
      if (tid == 0) st_release(flags + blockIdx.x, t + 1);
#pragma unroll
      for (int g = 0; g < 4; ++g)   // wx of the next step, in flight
        wxr[g] = own ? ld_now(wx_ptr(ob, ou, g, t + 1)) : 0.0f;
    }
  }
}

bool plan_ok(const Plan& p, int B, int nh, int dh) {
  if (p.U < 1 || dh % p.U || p.per_head != dh / p.U ||
      p.blocks != nh * p.per_head || p.KS < 1 || p.KS > dh ||
      p.L != (dh + p.KS - 1) / p.KS)
    return false;
  if (p.threads != p.U * p.KS || p.threads > kMaxThreads ||
      p.KS > kMaxSlices ||
      p.bpad < B || p.bpad % kTileB)
    return false;
  return p.smem == 4 * smem_floats(dh, p.U, p.KS, p.bpad);
}

template <typename T>
int launch(const void* wx, const float* r, void* out, float* hbuf, int* flags,
           int B, int S, int nh, int dh, const Plan& p, int device,
           cudaStream_t stream) {
  if (!plan_ok(p, B, nh, dh)) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem((const void*)slstm_kernel<T>, p.smem, device);
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
  Plan pl = p;
  void* args[] = {(void*)&wx_t, (void*)&r,  (void*)&out_t, (void*)&hbuf,
                  (void*)&flags, (void*)&B, (void*)&S,     (void*)&nh,
                  (void*)&dh,    (void*)&pl};
  err = cudaLaunchCooperativeKernel((const void*)slstm_kernel<T>,
                                    dim3(p.blocks), dim3(p.threads), args,
                                    p.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (wx and out). wx (B, S, 4 nh dh) in
// [z|i|f|o] layout, r (nh, dh, 4 dh) fp32, out (B, S, nh dh), hbuf
// (2, B, nh dh) fp32 and flags (blocks,) int32 scratch; all contiguous,
// B, S >= 1. plan: slstm_plan's 8 ints (U, KS, L, threads, blocks,
// per_head, bpad, smem). Returns 0, a CUDA error, cudaErrorInvalidValue
// for a plan the kernel cannot run, or kNotCoResident.
extern "C" int slstm_forward(int dtype, const void* wx, const float* r,
                             void* out, float* hbuf, int* flags, int B, int S,
                             int nh, int dh, const int* plan, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Plan p{plan[0], plan[1], plan[2], plan[3],
               plan[4], plan[5], plan[6], plan[7]};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(wx, r, out, hbuf, flags, B, S, nh, dh, p, device, s);
  return launch<__nv_bfloat16>(wx, r, out, hbuf, flags, B, S, nh, dh, p,
                               device, s);
}

extern "C" const char* slstm_error_string(int err) {
  if (err == kNotCoResident)
    return "the launch needs more blocks than can be resident at once "
           "(cooperative launch refused)";
  return cudaGetErrorString((cudaError_t)err);
}
