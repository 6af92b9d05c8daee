// The whole CRONet forward, on Hopper, in two launches from one wrapper.
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
// ~0.5 us. The arithmetic is fp32 on the inputs' values for both dtypes,
// as the JAX megakernel's (cronet_pipeline.py:36-48): the convolutions stay
// on the CUDA cores, since a tensor-core product would round conv1's SiLU
// output to bf16 before conv2.
//
// The per-slot intermediates do not fit one SM (the trunk conv2 output is
// 667 KB, the branch conv2 stack 768 KB), and one slot's work spread over
// one SM per stage leaves the card nearly empty. So:
//  (a) conv_kernel, one launch for both stages, grid (conv tiles, B). A
//      tile is a band of whole rows: trunk (depth d, rows), branch (time
//      step t, an even number of rows), sized by the wrapper's plan
//      (kernels/cronet_pipeline.py, cronet_plan) so that one medium slot is
//      94 blocks of about equal work (0.55-0.57 M multiply-adds each). A
//      block stages its input halo and conv2's filter (fp32) in shared
//      memory, computes conv1 + SiLU for its rows and a one-pixel halo,
//      then conv2 with register tiles: a thread owns 8 output channels x 4
//      adjacent pixels
//      (32 accumulators) of one of two input-channel groups (in-block
//      split-K), so one (row tap, input channel) step loads 6 inputs and
//      3 x 8 weights from shared memory for 96 FMAs. Each conv2 pixel is
//      computed once; group 0 adds group 1's sums. The SiLU'd tile goes back
//      to shared memory and is reduced in a fixed order: trunk rows into
//      their sums over each AAP column window (rowsum, (B, D, H, PW, 64)),
//      branch rows through the floor 2x2 max pool into per-band channel
//      sums (bpart, (B, T, bands, 32)). No slot depends on another.
//  (b) head_kernel, a thread-block cluster of `cluster` (8) blocks per slot,
//      grid (cluster, B). A block first starts the copies of its rank's
//      weights into shared memory (cp.async, all in flight at once: fc1's
//      600 rows, both fc2s' 320 columns, rwx) and the loads of rwh and
//      branch fc1 into registers. (It is not launched as a programmatic
//      dependent of (a), which would let it do that while (a) runs:
//      torch.profiler then loses kernel records, and the kernel counts of
//      the card tests and chip_smoke.py come from it.) Rank r builds the
//      AAP3D features of its K
//      chunk of fc1 from rowsum (depth, then row order; every load of a
//      thread issued before its sums), multiplies them by its staged fc1
//      rows, and writes its 40 sums into every rank's shared memory
//      (distributed shared memory) before one cluster barrier. Meanwhile it
//      runs the branch: features from bpart (band order), the RNN with each
//      thread holding 16 recurrent weights in registers (4 threads an
//      output, a fixed shuffle tree), and branch fc1. Every rank runs the
//      RNN, so no second barrier is needed. After the barrier each rank adds
//      the eight fc1 sums in rank order, and computes its 320 columns of both
//      fc2s and the product.
// Every sum runs in a fixed order that depends on the plan, never on B,
// and no floating-point atomics are used, so slot b's output does not
// depend on the batch width and two calls give the same bits. Inputs and
// weights are fp32 or bf16; accumulation and the output are fp32.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// The network's fixed widths (paper Table I; every size shares them):
// the plan (cronet_plan) raises for a configuration with others.
constexpr int kThreads = 256;    // both kernels
constexpr int kC1 = 16;          // conv1 channels, trunk and branch
constexpr int kTrunkC2 = 64;
constexpr int kBranchC2 = 32;
constexpr int kKD = 2;           // trunk conv1 depth taps (causal)
constexpr int kChan = 8;         // conv2 output channels a thread
constexpr int kRun = 4;          // conv2 adjacent pixels a thread
constexpr int kSplit = 2;        // conv2 input-channel groups (in-block
                                 // split-K), each kThreads / kSplit threads
constexpr int kGroupThreads = kThreads / kSplit;
constexpr int kHid = 64;         // RNN width: 4 threads an output
constexpr int kPoolGroups = 8;   // branch pool-sum groups
constexpr int kMaxCluster = 8;
constexpr int kMaxWinD = 2;      // AAP3D depth window, rows of a window
constexpr int kMaxWinH = 5;
constexpr int kMaxBands = 10;    // branch bands a time step
constexpr int kMaxFeat = 3;      // AAP3D features a head thread
constexpr int kMaxBfe = 2;       // branch features a head thread
constexpr int kMaxTab = 16;      // AAP windows a head rank touches

// The wrapper's plan (kernels/cronet_pipeline.py, cronet_plan). Nothing in
// it depends on B except `batch`, the grid's second dimension.
struct Plan {
  int batch;
  int t_rows, t_bands, t_runs;    // trunk tiles: rows, bands, pixel runs
  int b_rows, b_bands, b_runs;    // branch tiles
  int conv_blocks, conv_smem;     // per slot; bytes
  int cluster, k_chunk, col_chunk, head_smem;
};

// The configuration: B, D, H, W, T, ny, nx, PD, PH, PW, MID, P.
struct Dims {
  int B, D, H, W, T, ny, nx, PD, PH, PW, MID, P;
};

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
// SiLU as csrc/conv.cu computes it: fp32 by the fast intrinsics (~1e-6
// relative, well inside the 1e-4 bar) and without branches. The slow-path
// branches of an IEEE division or a correctly rounded reciprocal keep
// ptxas from interleaving a thread's 16 (conv1) or 32 (conv2) SiLUs.
__device__ __forceinline__ float silu(float x) {
  return __fdividef(x, 1.0f + __expf(-x));
}

__host__ __device__ __forceinline__ int win_start(int i, int n_in, int n_out) {
  return (i * n_in) / n_out;
}
__host__ __device__ __forceinline__ int win_end(int i, int n_in, int n_out) {
  return ((i + 1) * n_in + n_out - 1) / n_out;
}
__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// V consecutive weights as fp32 from one 16-byte load (4 fp32 or 8 bf16),
// issued where it stands: volatile, so the compiler does not sink it to
// the value's first use
__device__ __forceinline__ void load_w_now(const float* p, float (&v)[4]) {
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "l"(p));
}
__device__ __forceinline__ void load_w_now(const __nv_bfloat16* p,
                                           float (&v)[8]) {
  uint32_t u[4];
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u[0]), "=r"(u[1]), "=r"(u[2]), "=r"(u[3])
               : "l"(p));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// ------------------------------------------------------------ conv tiles

// Shared-memory layout of a conv tile (floats), the same on the host:
// w2s [9][C1][C2] | w1s [KD*9][C1] | halo [KD][rows+4][hw] |
// x1 [C1][rows+2][xw] | part [kPoolGroups][C2] |
// xch [kChan*kRun][kGroupThreads] (the second input-channel group's
// sums, one column a thread); conv2's SiLU'd output [rows][runs*kRun] with
// C2 + 1 floats a pixel (the row sums then read distinct banks) reuses w2s
// once the products are done.
struct TileLayout {
  int hw, xw, w2, w1, halo, x1, part, xch, total;
};
__host__ __device__ inline TileLayout tile_layout(int C2, int KD, int rows,
                                                  int runs) {
  TileLayout L;
  L.hw = round4(runs * kRun + 4);   // input cols -2 .. runs*kRun+1
  L.xw = round4(runs * kRun + 2);   // conv1 cols -1 .. runs*kRun
  L.w2 = 0;
  L.w1 = 9 * kC1 * C2;
  L.halo = L.w1 + round4(KD * 9 * kC1);
  L.x1 = L.halo + KD * (rows + 4) * L.hw;
  L.part = L.x1 + kC1 * (rows + 2) * L.xw;
  L.xch = L.part + kPoolGroups * C2;
  L.total = L.xch + kChan * kRun * kGroupThreads;
  return L;
}

// One band of `rows` output rows starting at y0 of a (KD, Himg, Wimg)
// single-channel input stack `img` (plane dd at img + dd * plane, planes
// at or past `planes` read zero): conv1 + SiLU, conv2 + SiLU; the SiLU'd
// conv2 tile is left in sm + L.w2 as [rows][runs*kRun][C2 + 1] (rows past
// the image are not written). Every thread of the block calls it.
template <int C2, int KD, typename T>
__device__ void conv_tile(const T* __restrict__ img, size_t plane, int planes,
                          const T* __restrict__ w1, const T* __restrict__ w2,
                          int Himg, int Wimg, int y0, int rows, int runs,
                          float* sm) {
  constexpr int CG = C2 / kChan;             // channel groups
  constexpr int E = 16 / sizeof(T);          // weights a 16-byte load
  constexpr int NV2 = 9 * kC1 * C2 / E;      // conv2's filter, in loads
  constexpr int PER = (NV2 + kThreads - 1) / kThreads;
  const TileLayout L = tile_layout(C2, KD, rows, runs);
  float* w2s = sm + L.w2;
  float* w1s = sm + L.w1;
  float* halo = sm + L.halo;
  float* x1 = sm + L.x1;
  const int tid = threadIdx.x;

  // conv2's filter: every load issued now (volatile, so it is not sunk to
  // its use), stored after conv1, so its latency hides behind the halo and
  // conv1
  float w2r[PER][E];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int vi = tid + u * kThreads;
    if (vi < NV2) load_w_now(w2 + (size_t)vi * E, w2r[u]);
  }
  for (int i = tid; i < KD * 9 * kC1; i += kThreads) w1s[i] = ld(w1, i);
  const int hrows = rows + 4;
  for (int i = tid; i < KD * hrows * L.hw; i += kThreads) {
    const int dd = i / (hrows * L.hw);
    const int rest = i - dd * hrows * L.hw;
    const int y = y0 - 2 + rest / L.hw, x = rest % L.hw - 2;
    float v = 0.0f;
    if (dd < planes && y >= 0 && y < Himg && x >= 0 && x < Wimg)
      v = ld(img, dd * plane + (size_t)y * Wimg + x);
    halo[i] = v;
  }
  __syncthreads();

  // conv1 + SiLU on rows y0-1 .. y0+rows, cols -1 .. runs*kRun (zero
  // outside the image: conv2's SAME padding); taps in (depth, row, col)
  // order
  const int xrows = rows + 2;
  for (int i = tid; i < xrows * L.xw; i += kThreads) {
    const int rr = i / L.xw, cc = i - rr * L.xw;
    const int y = y0 - 1 + rr, x = cc - 1;
    float acc[kC1];
#pragma unroll
    for (int c = 0; c < kC1; ++c) acc[c] = 0.0f;
    const bool in = y >= 0 && y < Himg && x >= 0 && x < Wimg;
    if (in) {
#pragma unroll
      for (int dd = 0; dd < KD; ++dd)
#pragma unroll
        for (int ki = 0; ki < 3; ++ki)
#pragma unroll
          for (int kj = 0; kj < 3; ++kj) {
            const float v = halo[(dd * hrows + rr + ki) * L.hw + cc + kj];
            const float* wp = w1s + ((dd * 3 + ki) * 3 + kj) * kC1;
#pragma unroll
            for (int c = 0; c < kC1; c += 4) {
              const float4 w = *reinterpret_cast<const float4*>(wp + c);
              acc[c] = fmaf(v, w.x, acc[c]);
              acc[c + 1] = fmaf(v, w.y, acc[c + 1]);
              acc[c + 2] = fmaf(v, w.z, acc[c + 2]);
              acc[c + 3] = fmaf(v, w.w, acc[c + 3]);
            }
          }
    }
#pragma unroll
    for (int c = 0; c < kC1; ++c) acc[c] = in ? silu(acc[c]) : 0.0f;
#pragma unroll
    for (int c = 0; c < kC1; ++c) x1[(c * xrows + rr) * L.xw + cc] = acc[c];
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int vi = tid + u * kThreads;
    if (vi < NV2)
#pragma unroll
      for (int e = 0; e < E; e += 4)
        *reinterpret_cast<float4*>(w2s + (size_t)vi * E + e) =
            make_float4(w2r[u][e], w2r[u][e + 1], w2r[u][e + 2], w2r[u][e + 3]);
  }
  __syncthreads();

  // conv2: thread (input-channel group g, channel group cg, pixel run pg);
  // a run is kRun adjacent pixels of one row. Each group's sum runs over
  // row tap, its input channels, column tap; then group 0 + group 1.
  constexpr int PG = kGroupThreads / CG;
  constexpr int CI = kC1 / kSplit;
  const int g = tid / kGroupThreads, rt = tid % kGroupThreads;
  const int cgp = rt / PG, pg = rt % PG;
  const int r = pg / runs, x0 = (pg - r * runs) * kRun;
  const bool active = r < rows && y0 + r < Himg;
  float acc[kChan][kRun];
#pragma unroll
  for (int c = 0; c < kChan; ++c)
#pragma unroll
    for (int p = 0; p < kRun; ++p) acc[c][p] = 0.0f;
  if (active) {
    for (int ki = 0; ki < 3; ++ki) {
#pragma unroll 2
      for (int cc = 0; cc < CI; ++cc) {
        const int ci = g * CI + cc;
        const float* xp = x1 + (ci * xrows + r + ki) * L.xw + x0;
        const float4 xa = *reinterpret_cast<const float4*>(xp);
        const float2 xb = *reinterpret_cast<const float2*>(xp + 4);
        const float xin[kRun + 2] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y};
#pragma unroll
        for (int kj = 0; kj < 3; ++kj) {
          const float* wp = w2s + ((ki * 3 + kj) * kC1 + ci) * C2 + cgp * kChan;
          const float4 wa = *reinterpret_cast<const float4*>(wp);
          const float4 wb = *reinterpret_cast<const float4*>(wp + 4);
          const float w[kChan] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int c = 0; c < kChan; ++c)
#pragma unroll
            for (int p = 0; p < kRun; ++p)
              acc[c][p] = fmaf(xin[p + kj], w[c], acc[c][p]);
        }
      }
    }
  }
  __syncthreads();   // w2s is done: the SiLU'd tile goes there
  float* xch = sm + L.xch;
  if (g == 1)
#pragma unroll
    for (int c = 0; c < kChan; ++c)
#pragma unroll
      for (int p = 0; p < kRun; ++p)
        xch[(c * kRun + p) * kGroupThreads + rt] = acc[c][p];
  __syncthreads();
  if (g == 0 && active) {
    // the other group's sums first, then every SiLU, then the stores: a
    // store between two SiLUs (it may alias the next load, as far as the
    // compiler knows) would put them one after the other
#pragma unroll
    for (int c = 0; c < kChan; ++c)
#pragma unroll
      for (int p = 0; p < kRun; ++p)
        acc[c][p] += xch[(c * kRun + p) * kGroupThreads + rt];
#pragma unroll
    for (int c = 0; c < kChan; ++c)
#pragma unroll
      for (int p = 0; p < kRun; ++p) acc[c][p] = silu(acc[c][p]);
    const int npx = runs * kRun;
#pragma unroll
    for (int p = 0; p < kRun; ++p) {
      float* op = w2s + ((size_t)r * npx + x0 + p) * (C2 + 1) + cgp * kChan;
#pragma unroll
      for (int c = 0; c < kChan; ++c) op[c] = acc[c][p];
    }
  }
  __syncthreads();
}

// grid (p.conv_blocks, B): blocks [0, D * t_bands) are trunk tiles
// (depth, band), the rest branch tiles (time step, band).
// lv (B, D, H, W); hist (B, T, ny, nx); tc1 (KD, 3, 3, 1, 16);
// tc2 (1, 3, 3, 16, 64); bc1 (3, 3, 1, 16); bc2 (3, 3, 16, 32).
// rowsum (B, D, H, PW, 64): a row's sum over each AAP column window;
// bpart (B, T, b_bands, 32): a band's sum of the 2x2 max-pooled values.
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const T* __restrict__ lv, const T* __restrict__ hist,
            const T* __restrict__ tc1, const T* __restrict__ tc2,
            const T* __restrict__ bc1, const T* __restrict__ bc2,
            float* __restrict__ rowsum, float* __restrict__ bpart, Dims dm,
            Plan p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y, tid = threadIdx.x;
  const int n_trunk = dm.D * p.t_bands;
  if ((int)blockIdx.x < n_trunk) {
    const int d = blockIdx.x / p.t_bands, band = blockIdx.x % p.t_bands;
    const int y0 = band * p.t_rows;
    const size_t plane = (size_t)dm.H * dm.W;
    conv_tile<kTrunkC2, kKD>(lv + ((size_t)b * dm.D + d) * plane, plane,
                             dm.D - d, tc1, tc2, dm.H, dm.W, y0, p.t_rows,
                             p.t_runs, sm);
    const int npx = p.t_runs * kRun;
    const float* ot = sm;
    for (int i = tid; i < p.t_rows * dm.PW * kTrunkC2; i += kThreads) {
      const int c = i % kTrunkC2;
      const int j = (i / kTrunkC2) % dm.PW;
      const int r = i / (kTrunkC2 * dm.PW);
      const int y = y0 + r;
      if (y >= dm.H) continue;
      const int ws = win_start(j, dm.W, dm.PW), we = win_end(j, dm.W, dm.PW);
      float s = 0.0f;
      for (int x = ws; x < we; ++x) s += ot[((size_t)r * npx + x) * (kTrunkC2 + 1) + c];
      rowsum[((((size_t)b * dm.D + d) * dm.H + y) * dm.PW + j) * kTrunkC2 + c] = s;
    }
    return;
  }
  const int bx = blockIdx.x - n_trunk;
  const int t = bx / p.b_bands, band = bx % p.b_bands;
  const int y0 = band * p.b_rows;
  const size_t plane = (size_t)dm.ny * dm.nx;
  conv_tile<kBranchC2, 1>(hist + ((size_t)b * dm.T + t) * plane, plane, 1, bc1,
                          bc2, dm.ny, dm.nx, y0, p.b_rows, p.b_runs, sm);
  // floor 2x2 max pool, then this band's sum of the pooled values per
  // channel: group g takes pooled pixels g, g + 8, ... in order, then the
  // groups are added in order
  const TileLayout L = tile_layout(kBranchC2, 1, p.b_rows, p.b_runs);
  float* part = sm + L.part;
  const int npx = p.b_runs * kRun;
  const int pw = dm.nx / 2, prow = p.b_rows / 2;
  const float* ot = sm;
  {
    const int c = tid % kBranchC2, g = tid / kBranchC2;
    float s = 0.0f;
    for (int q = g; q < prow * pw; q += kPoolGroups) {
      const int lr = q / pw, pc = q - lr * pw;
      if (y0 + 2 * lr + 1 >= dm.ny) break;
      constexpr int os = kBranchC2 + 1;
      const float* o0 = ot + ((size_t)(2 * lr) * npx + 2 * pc) * os + c;
      const float* o1 = o0 + (size_t)npx * os;
      const float m = fmaxf(fmaxf(o0[0], o0[os]), fmaxf(o1[0], o1[os]));
      s += m;
    }
    part[g * kBranchC2 + c] = s;
  }
  __syncthreads();
  if (tid < kBranchC2) {
    float s = part[tid];
    for (int g = 1; g < kPoolGroups; ++g) s += part[g * kBranchC2 + tid];
    bpart[(((size_t)b * dm.T + t) * p.b_bands + band) * kBranchC2 + tid] = s;
  }
}

// ------------------------------------------------------------------ head

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {   // release
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {     // acquire
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
// `bytes` (a multiple of 16) from global to shared memory, 16 at a time
__device__ __forceinline__ void stage(void* dst, const void* src, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads)
    cp_async16(static_cast<char*>(dst) + 16 * i,
               static_cast<const char*>(src) + 16 * i);
}

// V consecutive weights of a staged row, as fp32
__device__ __forceinline__ void load_s(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_s(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// acc[v] += sum over k = q, q + kl, ... < nk of x[k] * w[k * ldw + v], k in
// order; x and w in shared memory
template <int V, typename T>
__device__ __forceinline__ void gemv_lane(const float* x, const T* w, int ldw,
                                          int nk, int q, int kl,
                                          float (&acc)[V]) {
#pragma unroll 4
  for (int k = q; k < nk; k += kl) {
    float wv[V];
    load_s(w + k * ldw, wv);
    const float xk = x[k];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = fmaf(xk, wv[v], acc[v]);
  }
}

// Shared-memory layout of a head block (floats), the same on the host: the
// staged weights in their own type (fc1's rows of this rank [k_chunk][MID],
// both fc2s' columns of this rank [MID][col_chunk], rwx [32][64]), then
// fs [k_chunk] | bfe [T][32] | xw [T][64] | hh [2][64] | bmid [MID] |
// tmid [MID] | gather [kMaxCluster][MID] | part [max(fc1, fc2 partials)] |
// tab [kMaxTab][4] (ints: the rank's AAP windows).
struct HeadLayout {
  int w1, t2, b2, rwx, fs, bfe, xw, hh, bmid, tmid, gather, part, tab, total;
};
__host__ __device__ inline HeadLayout head_layout(const Plan& p, int T, int MID,
                                                  int V, int ES) {
  HeadLayout L;
  const int kl1 = kThreads / (MID / V);
  const int kl2 = kThreads / (p.col_chunk / V);
  L.w1 = 0;
  L.t2 = L.w1 + round4(p.k_chunk * MID * ES / 4);
  L.b2 = L.t2 + round4(MID * p.col_chunk * ES / 4);
  L.rwx = L.b2 + round4(MID * p.col_chunk * ES / 4);
  L.fs = L.rwx + round4(kBranchC2 * kHid * ES / 4);
  L.bfe = L.fs + round4(p.k_chunk);
  L.xw = L.bfe + round4(T * kBranchC2);
  L.hh = L.xw + round4(T * kHid);
  L.bmid = L.hh + 2 * kHid;
  L.tmid = L.bmid + round4(MID);
  L.gather = L.tmid + round4(MID);
  L.part = L.gather + kMaxCluster * round4(MID);
  const int part1 = kl1 * MID, part2 = 2 * kl2 * p.col_chunk;
  L.tab = L.part + round4(part1 > part2 ? part1 : part2);
  L.total = L.tab + 4 * kMaxTab;
  return L;
}

// grid (cluster, B), cluster (cluster, 1, 1); V = 16 / sizeof(T). A block
// first starts every copy of its rank's weights into shared memory
// (cp.async, all in flight at once) and the loads of rwh and bf1, and
// builds its window table; the AAP3D and branch features are loaded while
// those copies land.
// tf1 (F, MID); tf2 (MID, P); rwx (32, 64); rwh (64, 64); bf1 (64, MID);
// bf2 (MID, P); out (B, P) float32.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
head_kernel(const float* __restrict__ rowsum, const float* __restrict__ bpart,
            const T* __restrict__ tf1, const T* __restrict__ tf2,
            const T* __restrict__ rwx, const T* __restrict__ rwh,
            const T* __restrict__ bf1, const T* __restrict__ bf2,
            float* __restrict__ out, Dims dm, Plan p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cluster_arrive_relaxed();            // this block has started
  const int rank = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int MID = dm.MID, P = dm.P, Tn = dm.T;
  const HeadLayout L = head_layout(p, Tn, MID, V, (int)sizeof(T));
  T* sw1 = reinterpret_cast<T*>(sm + L.w1);
  T* st2 = reinterpret_cast<T*>(sm + L.t2);
  T* sb2 = reinterpret_cast<T*>(sm + L.b2);
  T* srwx = reinterpret_cast<T*>(sm + L.rwx);
  float* fs = sm + L.fs;
  float* bfe = sm + L.bfe;
  float* xw = sm + L.xw;
  float* hh = sm + L.hh;
  float* bmid = sm + L.bmid;
  float* tmid = sm + L.tmid;
  float* gather = sm + L.gather;
  float* part = sm + L.part;
  int* tab = reinterpret_cast<int*>(sm + L.tab);

  // -- the weights: every copy and load in flight before the features --
  const int F = dm.PD * dm.PH * dm.PW * kTrunkC2;
  const int k0 = rank * p.k_chunk;
  const int nk = max(0, min(F - k0, p.k_chunk));
  const int c0 = rank * p.col_chunk;
  const int nc = max(0, min(P - c0, p.col_chunk));
  stage(sw1, tf1 + (size_t)k0 * MID, nk * MID * (int)sizeof(T));
  {
    const int per_row = nc * (int)sizeof(T) / 16;
    for (int i = tid; i < MID * per_row; i += kThreads) {
      const int k = i / per_row, ch = i - k * per_row;
      const size_t off = (size_t)k * P + c0;
      cp_async16(reinterpret_cast<char*>(st2 + k * p.col_chunk) + 16 * ch,
                 reinterpret_cast<const char*>(tf2 + off) + 16 * ch);
      cp_async16(reinterpret_cast<char*>(sb2 + k * p.col_chunk) + 16 * ch,
                 reinterpret_cast<const char*>(bf2 + off) + 16 * ch);
    }
  }
  stage(srwx, rwx, kBranchC2 * kHid * (int)sizeof(T));
  // the AAP windows of this rank's features: rowsum offset of the first
  // (depth, row) of the window, its depths, rows and pixel count
  const int w0 = k0 / kTrunkC2;
  if (tid < kMaxTab && nk > 0 && w0 + tid <= (k0 + nk - 1) / kTrunkC2) {
    const int w = w0 + tid;
    const int j = w % dm.PW, i = (w / dm.PW) % dm.PH, k = w / (dm.PW * dm.PH);
    const int ds = win_start(k, dm.D, dm.PD), de = win_end(k, dm.D, dm.PD);
    const int hs = win_start(i, dm.H, dm.PH), he = win_end(i, dm.H, dm.PH);
    const int ws = win_start(j, dm.W, dm.PW), we = win_end(j, dm.W, dm.PW);
    tab[4 * tid] = ((ds * dm.H + hs) * dm.PW + j) * kTrunkC2;
    tab[4 * tid + 1] = de - ds;
    tab[4 * tid + 2] = he - hs;
    tab[4 * tid + 3] = (de - ds) * (he - hs) * (we - ws);
  }
  // recurrent weights: thread (o, quarter) keeps rwh[quarter*16 .. +16][o]
  const int ro = tid >> 2, rq = tid & 3;
  float wh[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) wh[i] = ld(rwh, (rq * 16 + i) * kHid + ro);
  // branch fc1's column of this thread (tid < MID), for after the RNN
  float w_bf1[kHid];
#pragma unroll
  for (int k = 0; k < kHid; ++k)
    w_bf1[k] = tid < MID ? ld(bf1, k * MID + tid) : 0.0f;
  if (tid < kHid) hh[tid] = 0.0f;
  __syncthreads();                     // the window table

  // AAP3D features of this rank's fc1 rows, (d, h, w, c) order: the rows'
  // window sums over the depth window, then the row window, over the count
  {
    const size_t slot = (size_t)b * dm.D * dm.H * dm.PW * kTrunkC2;
    const int dstep = dm.H * dm.PW * kTrunkC2, rstep = dm.PW * kTrunkC2;
    float v[kMaxFeat][kMaxWinD][kMaxWinH];   // every load first
#pragma unroll
    for (int u = 0; u < kMaxFeat; ++u) {
      const int f = tid + u * kThreads;
      const int* e = tab + 4 * (f < nk ? (k0 + f) / kTrunkC2 - w0 : 0);
      const size_t base = slot + e[0] + (k0 + f) % kTrunkC2;
#pragma unroll
      for (int a = 0; a < kMaxWinD; ++a)
#pragma unroll
        for (int y = 0; y < kMaxWinH; ++y)
          v[u][a][y] = f < nk && a < e[1] && y < e[2]
                           ? rowsum[base + a * dstep + y * rstep] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kMaxFeat; ++u) {
      const int f = tid + u * kThreads;
      if (f >= nk) continue;
      const int* e = tab + 4 * ((k0 + f) / kTrunkC2 - w0);
      float s = 0.0f;
#pragma unroll
      for (int a = 0; a < kMaxWinD; ++a)
#pragma unroll
        for (int y = 0; y < kMaxWinH; ++y)
          if (a < e[1] && y < e[2]) s += v[u][a][y];
      fs[f] = s / (float)e[3];
    }
  }
  // branch features: the bands' pooled sums in order, over the pool's size
  {
    const float inv_pool = 1.0f / (float)((dm.ny / 2) * (dm.nx / 2));
    float v[kMaxBfe][kMaxBands];
#pragma unroll
    for (int u = 0; u < kMaxBfe; ++u) {
      const int i = tid + u * kThreads;
      const int t = i / kBranchC2, c = i % kBranchC2;
      const float* bp = bpart + ((size_t)b * Tn + t) * p.b_bands * kBranchC2 + c;
#pragma unroll
      for (int band = 0; band < kMaxBands; ++band)
        v[u][band] = i < Tn * kBranchC2 && band < p.b_bands
                         ? bp[band * kBranchC2] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kMaxBfe; ++u) {
      const int i = tid + u * kThreads;
      if (i >= Tn * kBranchC2) continue;
      float s = 0.0f;
#pragma unroll
      for (int band = 0; band < kMaxBands; ++band)
        if (band < p.b_bands) s += v[u][band];
      bfe[i] = s * inv_pool;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // fc1: this rank's K chunk; thread (column vector g, k lane q)
  {
    const int G = MID / V, kl = kThreads / G;
    const int g = tid % G, q = tid / G;
    if (q < kl) {
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.0f;
      gemv_lane<V>(fs, sw1 + g * V, MID, nk, q, kl, acc);
#pragma unroll
      for (int v = 0; v < V; ++v) part[q * MID + g * V + v] = acc[v];
    }
    __syncthreads();
    cluster_wait();                    // every block of the cluster started
    if (tid < MID) {
      float s = part[tid];
      for (int qq = 1; qq < kl; ++qq) s += part[qq * MID + tid];
      cg::cluster_group cluster = cg::this_cluster();
      for (int dst = 0; dst < p.cluster; ++dst)
        cluster.map_shared_rank(gather, dst)[rank * MID + tid] = s;
    }
    cluster_arrive();                  // this rank's sums are written
  }

  // the branch, on every rank: x-projections of all steps, then the
  // recurrence (h0 = 0), then branch fc1
  for (int i = tid; i < Tn * kHid; i += kThreads) {
    const int t = i / kHid, o = i - t * kHid;
    float a = 0.0f;
#pragma unroll 8
    for (int k = 0; k < kBranchC2; ++k)
      a = fmaf(bfe[t * kBranchC2 + k], ld(srwx, k * kHid + o), a);
    xw[i] = a;
  }
  __syncthreads();
  for (int t = 0; t < Tn; ++t) {
    const float* hc = hh + (t & 1) * kHid + rq * 16;
    float c = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) c = fmaf(hc[i], wh[i], c);
    c += __shfl_down_sync(0xffffffffu, c, 1);   // q0 + q1, q2 + q3
    c += __shfl_down_sync(0xffffffffu, c, 2);   // (q0 + q1) + (q2 + q3)
    if (rq == 0) hh[((t + 1) & 1) * kHid + ro] = tanhf(xw[t * kHid + ro] + c);
    __syncthreads();
  }
  if (tid < MID) {
    const float* hf = hh + (Tn & 1) * kHid;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kHid; ++k) s = fmaf(hf[k], w_bf1[k], s);
    bmid[tid] = silu(s);
  }

  cluster_wait();                      // every rank's fc1 sums are here
  if (tid < MID) {
    float s = gather[tid];
    for (int r = 1; r < p.cluster; ++r) s += gather[r * MID + tid];
    tmid[tid] = silu(s);
  }
  __syncthreads();

  // both fc2s on this rank's columns; thread (column vector v, k lane q)
  {
    const int nv = p.col_chunk / V, kl = kThreads / nv;
    const int vi = tid % nv, q = tid / nv;
    if (q < kl && vi * V < nc) {
      float at[V], ab[V];
#pragma unroll
      for (int v = 0; v < V; ++v) at[v] = ab[v] = 0.0f;
      gemv_lane<V>(tmid, st2 + vi * V, p.col_chunk, MID, q, kl, at);
      gemv_lane<V>(bmid, sb2 + vi * V, p.col_chunk, MID, q, kl, ab);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        part[q * p.col_chunk + vi * V + v] = at[v];
        part[(kl + q) * p.col_chunk + vi * V + v] = ab[v];
      }
    }
    __syncthreads();
    for (int i = tid; i < nc; i += kThreads) {
      float st = part[i], sb = part[kl * p.col_chunk + i];
      for (int qq = 1; qq < kl; ++qq) {
        st += part[qq * p.col_chunk + i];
        sb += part[(kl + qq) * p.col_chunk + i];
      }
      out[(size_t)b * P + c0 + i] = sb * st;
    }
  }
}

// ---------------------------------------------------------------- launch

bool plan_ok(const Plan& p, const Dims& dm, int V) {
  if (p.batch != dm.B || p.batch < 1 || p.batch > 65535) return false;
  if (p.t_rows < 1 || p.t_runs * kRun < dm.W || p.t_rows * p.t_bands < dm.H ||
      p.t_rows * p.t_runs > kGroupThreads / (kTrunkC2 / kChan))
    return false;
  if (p.b_rows < 2 || p.b_rows % 2 || p.b_runs * kRun < dm.nx ||
      p.b_rows * p.b_bands < dm.ny ||
      p.b_rows * p.b_runs > kGroupThreads / (kBranchC2 / kChan))
    return false;
  if (p.conv_blocks != dm.D * p.t_bands + dm.T * p.b_bands ||
      p.b_bands > kMaxBands)
    return false;
  for (int k = 0; k < dm.PD; ++k)
    if (win_end(k, dm.D, dm.PD) - win_start(k, dm.D, dm.PD) > kMaxWinD) return false;
  for (int i = 0; i < dm.PH; ++i)
    if (win_end(i, dm.H, dm.PH) - win_start(i, dm.H, dm.PH) > kMaxWinH) return false;
  const int smem_t = tile_layout(kTrunkC2, kKD, p.t_rows, p.t_runs).total;
  const int smem_b = tile_layout(kBranchC2, 1, p.b_rows, p.b_runs).total;
  const int smem = 4 * (smem_t > smem_b ? smem_t : smem_b);
  if (p.conv_smem != smem) return false;
  const int F = dm.PD * dm.PH * dm.PW * kTrunkC2;
  if (p.cluster < 1 || p.cluster > kMaxCluster ||
      (long long)p.cluster * p.k_chunk < F || p.k_chunk < 1)
    return false;
  if (dm.MID % V || dm.P % V || p.col_chunk % V ||
      (long long)p.cluster * p.col_chunk < dm.P ||
      p.col_chunk / V > kThreads || dm.MID / V > kThreads)
    return false;
  if (p.k_chunk > kMaxFeat * kThreads || dm.T * kBranchC2 > kMaxBfe * kThreads ||
      p.k_chunk / kTrunkC2 + 2 > kMaxTab)
    return false;
  if (p.head_smem != 4 * head_layout(p, dm.T, dm.MID, V, 16 / V).total) return false;
  return true;
}

template <typename T>
int launch(const void* lv_, const void* hist_, const void* const* w_,
           float* rowsum, float* bpart, float* out, const Dims& dm,
           const Plan& p, int device, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (!plan_ok(p, dm, V) || p.conv_smem > kMaxSmem || p.head_smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 10; ++i)
    if (reinterpret_cast<uintptr_t>(w_[i]) % 16) return (int)cudaErrorMisalignedAddress;
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
  cudaError_t err;

  if ((err = allow_smem((const void*)conv_kernel<T>, p.conv_smem, device)) !=
      cudaSuccess)
    return (int)err;
  conv_kernel<T><<<dim3(p.conv_blocks, dm.B), kThreads, p.conv_smem, stream>>>(
      lv, hist, tc1, tc2, bc1, bc2, rowsum, bpart, dm, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = allow_smem((const void*)head_kernel<T, V>, p.head_smem,
                        device)) != cudaSuccess)
    return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, dm.B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.head_smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, head_kernel<T, V>, (const float*)rowsum,
                           (const float*)bpart, tf1, tf2, rwx, rwh, bf1, bf2,
                           out, dm, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (inputs and weights alike).
// weights: tc1, tc2, tf1, tf2, bc1, bc2, rwx, rwh, bf1, bf2 device pointers
// (16-byte aligned). rowsum (B, D, H, PW, 64) and bpart (B, T, b_bands, 32)
// are float32 scratch. dims: B, D, H, W, T, ny, nx, PD, PH, PW, MID, P.
// plan: cronet_plan's 13 ints. Returns cudaGetLastError() after the last
// launch (0 on success); cudaErrorInvalidValue for a plan the kernels
// cannot run.
extern "C" int cronet_fused_forward(int dtype, const void* load_vol, const void* hist,
                                    const void* const* weights, float* rowsum,
                                    float* bpart, float* out, const int* dims,
                                    const int* plan, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{dims[0], dims[1], dims[2], dims[3], dims[4],  dims[5],
                dims[6], dims[7], dims[8], dims[9], dims[10], dims[11]};
  const Plan p{plan[0], plan[1], plan[2],  plan[3],  plan[4],  plan[5], plan[6],
               plan[7], plan[8], plan[9], plan[10], plan[11], plan[12]};
  if (dtype == 0)
    return launch<float>(load_vol, hist, weights, rowsum, bpart, out, dm, p,
                         device, (cudaStream_t)stream);
  return launch<__nv_bfloat16>(load_vol, hist, weights, rowsum, bpart, out, dm,
                               p, device, (cudaStream_t)stream);
}

extern "C" const char* cronet_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
