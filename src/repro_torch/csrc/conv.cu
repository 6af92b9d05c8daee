// SAME 3D convolution, no bias, optional fused SiLU; conv2d is the D = 1,
// KD = 1 case. Two kernels behind one wrapper (kernels/conv.py), chosen by
// a fixed rule, conv.kernel_for(dtype, Cin, Cout):
//   conv_tc_kernel   bf16 x and w, Cin % 16 == 0, Cout % 8 == 0: mma.sync
//                    tensor cores (CRONet's two Cin = 16 layers in bf16);
//   conv_simt_kernel every other call, every fp32 call included.
//
// Replaces: src/repro/kernels/conv.py, conv2d (_conv2d_kernel) and conv3d
// (_conv3d_kernel). The Pallas kernels pad the input in HBM and run each
// filter tap as a (H*W, Cin) x (Cin, Cout) MXU matmul over a shifted view,
// one grid step per image.
//
// Layouts: x (B, D, H, W, Cin) NDHWC and w (KD, KH, KW, Cin, Cout) DHWIO,
// read unpadded; out (B, D, H, W, Cout) in x's dtype. Depth is
// "causal_same" (taps d .. d+KD-1, the tail past D reads zero), which for
// KD = 1 is "same".
//
// What bounds it on the H100, at CRONet medium (GEMM view M x N x K):
//   trunk conv1  2604 x 16 x 18    0.56 M MACs   bytes, 0.05 us (fp32)
//   trunk conv2  2604 x 64 x 144   24.0 M MACs   ops,   0.72 us (fp32 FMA)
//   branch conv1 6000 x 16 x 9     0.86 M MACs   bytes, 0.12 us (fp32)
//   branch conv2 6000 x 32 x 144   27.6 M MACs   ops,   0.82 us (fp32 FMA)
// (bf16 on the tensor cores: bytes, about 0.1 us each). All four sit far
// below what one launch costs by graph replay on this card: ~1.2 us for an
// empty kernel, ~2.5 us for a trivial one. A call is that floor plus one
// block's chain of latency: copy in, multiply-add, store. The design cuts
// the chain:
//
// * Tiles. The wrapper (conv.tile_plan) computes the plan and passes it in:
//   a block owns one (b, d) slice, a band of `rows` output rows by `cols`
//   columns (full width at CRONet's shapes) and `ct` output channels, with
//   the band and ct chosen so that each medium layer launches >= 132 blocks
//   where it has the rows for it (fp32: 168, 168, 200, 200).
// * Halo in shared memory by cp.async. A block copies KD depth planes of
//   (rows + KH - 1) x (cols + KW - 1) input pixels, all Cin channels; a
//   warp takes a halo row, its lanes the row's vectors. Cells outside the
//   image or past D are zero-filled by the copy itself (src-size 0), so the
//   inner loops carry no bounds checks. (bf16 x on the SIMT kernel, Cin 1
//   or odd shapes, is converted to fp32 by plain loads, zeros likewise
//   written by the loader.)
// * Only the block's own filter slice: taps x Cin x ct values, 18.4 KB in
//   fp32 for trunk conv2 where the first version loaded all 36.9 KB in each
//   of ~528 blocks (19 MB of L2 traffic for a layer that moves 0.87 MB).
// * Register tiles (SIMT): a thread keeps 2 pixels x 4 channels, 8
//   independent fp32 accumulators; one (tap, cin) step is two 4-byte and one
//   16-byte shared load for 8 FMAs, where the first version chained 144
//   dependent FMAs with two loads each. Halo pixels are Cin + 4 floats apart
//   (Cin % 4 == 0), so the pixels a warp reads fall in distinct banks.
//   KH thread groups split the taps (in-block split-K): each thread's chain
//   is a third as long, the block has three times the threads to copy with,
//   and group 0 adds the other groups' sums in a fixed order. (A 4-pixel
//   tile gained ~5% on the Cin-16 layers and lost on the Cin-1 layers.)
// * Tensor cores (bf16): one filter tap of 16 input channels is one k16
//   step of mma.sync.m16n8k16 (bf16 in, fp32 accumulators). A warp owns 16
//   output pixels by ct channels. Its A fragments come from the halo by
//   ldmatrix, each lane giving the address of its own pixel shifted by the
//   tap: that is the im2col gather, and nothing is copied. B fragments come
//   from the filter slice by ldmatrix.trans (the filter rows are Cout-major,
//   as DHWIO stores them). Rows of both are an odd number of 16-byte units
//   apart, so the eight rows of an 8x8 matrix hit distinct banks. A block
//   has 4 to 8 warps, so the copy-in, which dominates, is spread wide.
//   Why not wgmma: a layer is ~50 MFLOP with N <= 64 and K = 144 (9 k16
//   steps). wgmma's 64-row tiles would give trunk conv2 41 x 2 warpgroup
//   tiles, fewer than the 132 SMs, and would need the shifted pixels copied
//   into its core-matrix layout per tap (no per-lane row addresses), with a
//   TMA ring and fences to amortise over 9 steps. Tensor work is ~0.05 us of
//   a ~5 us call; mma.sync fed by ldmatrix keeps the set-up to nothing.
// * Epilogue: SiLU in fp32 by the fast intrinsics (below), one rounding to
//   x's dtype. SIMT stores 16 bytes (fp32) or 8 (bf16) per pixel where Cout
//   allows; the tensor-core kernel stages each warp's 16 x ct tile in shared
//   memory and stores 16-byte rows.
// * Order: each output sums its taps (by split group, then group order),
//   then Cin (per k16 step on the tensor cores), in a fixed order: no
//   atomics, no split-K across blocks, so two calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

struct Dims {
  int B, D, H, W, Cin, KD, KH, KW, Cout;
};
// conv.tile_plan's fields, in its order
struct Plan {
  int rows, cols, ct, split, threads, smem, grid_x, grid_y;
};
// one block's output tile: slice (b, d), rows y0 .. y0+nr, columns
// x0 .. x0+nc, channels co0 .. co0+ct (clipped at Cout by the stores)
struct Tile {
  int b, d, y0, x0, nr, nc, co0;
};

// blockIdx.x = ((b * D + d) * row bands + row band) * column bands + column
// band; blockIdx.y = channel tile (conv.tile_of mirrors this)
__device__ __forceinline__ Tile tile_of(const Dims& g, const Plan& p) {
  const int nrb = (g.H + p.rows - 1) / p.rows;
  const int ncb = (g.W + p.cols - 1) / p.cols;
  int t = blockIdx.x;
  const int cb = t % ncb;
  t /= ncb;
  const int rb = t % nrb;
  t /= nrb;
  Tile s;
  s.d = t % g.D;
  s.b = t / g.D;
  s.y0 = rb * p.rows;
  s.x0 = cb * p.cols;
  s.nr = min(p.rows, g.H - s.y0);
  s.nc = min(p.cols, g.W - s.x0);
  s.co0 = blockIdx.y * p.ct;
  return s;
}

// row of pixel `pix` in the tile (no division for one-row bands)
__device__ __forceinline__ int pix_row(const Tile& t, int pix) {
  return t.nr == 1 ? 0 : pix / t.nc;
}

__device__ __forceinline__ size_t out_index(const Dims& g, const Tile& t,
                                            int pix, int co) {
  const int r = pix_row(t, pix);
  const int y = t.y0 + r, xx = t.x0 + pix - r * t.nc;
  return ((((size_t)t.b * g.D + t.d) * g.H + y) * g.W + xx) * g.Cout + co;
}

// log2 of a power of two
__device__ __forceinline__ int log2i(int n) { return __ffs(n) - 1; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of 16 or 4 bytes; with ok false the source size is 0: nothing
// is read and the destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// one vector of `vec` values into the SIMT kernel's fp32 shared memory
__device__ __forceinline__ void copy_in(float* dst, const float* src, bool ok,
                                        int vec) {
  if (vec == 4)
    cp_async16(dst, src, ok);
  else
    cp_async4(dst, src, ok);
}
__device__ __forceinline__ void copy_in(float* dst, const bf16* src, bool ok,
                                        int) {
  *dst = ok ? __bfloat162float(*src) : 0.0f;  // vec is 1 for bf16
}

// Every halo cell of the tile in vectors of `vec` channels:
// fn(cell, vector, x offset, inside). Cell (dd, r, c) holds the input
// pixel (d + dd, y0 + r - KH/2, x0 + c - KW/2); inside is false past D or
// outside the image, and the offset is then 0. A warp takes a halo row and
// its lanes the row's vectors: per row, one division for the warp; per
// vector, a shift (a division only for odd Cin).
template <typename F>
__device__ __forceinline__ void for_halo(const Dims& g, const Tile& t, int hr,
                                         int hc, int vec, F fn) {
  const int nv = g.Cin / vec, ph = g.KH / 2, pw = g.KW / 2;
  const int lnv = (nv & (nv - 1)) == 0 ? log2i(nv) : -1;
  const int lane = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < g.KD * hr; row += blockDim.x >> 5) {
    const int dd = row / hr, r = row - dd * hr;
    const int z = t.d + dd, y = t.y0 + r - ph;
    const bool row_ok = z < g.D && y >= 0 && y < g.H;
    const size_t row0 = (((size_t)t.b * g.D + z) * g.H + y) * g.W;
#pragma unroll 4
    for (int e = lane; e < hc * nv; e += 32) {
      const int c = lnv >= 0 ? e >> lnv : e / nv, v = e - c * nv;
      const int xx = t.x0 + c - pw;
      const bool ok = row_ok && xx >= 0 && xx < g.W;
      fn(row * hc + c, v, ok ? (row0 + xx) * g.Cin + v * vec : 0, ok);
    }
  }
}

// The block's filter slice in vectors of `vec` output channels: row
// (tap, cin) holds channels co0 .. co0 + ct; fn(row, vector, w offset,
// inside), inside false past Cout (offset 0). ct / vec is a power of two.
template <typename F>
__device__ __forceinline__ void for_filter(const Dims& g, int co0, int ct,
                                           int vec, F fn) {
  const int lnv = log2i(ct / vec), nv = ct / vec;
  const int n = g.KD * g.KH * g.KW * g.Cin * nv;
#pragma unroll 4
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int row = q >> lnv, v = q & (nv - 1), co = co0 + v * vec;
    const bool ok = co < g.Cout;  // vec divides Cout: all of it or none
    fn(row, v, ok ? (size_t)row * g.Cout + co : 0, ok);
  }
}

// SiLU by the fast intrinsics: the IEEE division's slow-path call cost
// 0.3-1 us a launch and forced stack spills around it. __expf is within
// ~2 + 1.2|v| ulp and __fdividef within 2 ulp, so the result stays within
// ~1e-5 relative of the plain version's (the fp32 test allows 2e-5); for
// v < -88, __expf(-v) = inf and the quotient is 0, as SiLU tends to.
__device__ __forceinline__ float epilogue(float v, int fuse_silu) {
  return fuse_silu ? __fdividef(v, 1.0f + __expf(-v)) : v;
}

// up to four consecutive channels of one pixel; n of them exist
__device__ __forceinline__ void store4(float* o, const float* v, int n) {
  if (n >= 4 && ((uintptr_t)o & 15) == 0) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int k = 0; k < n && k < 4; ++k) o[k] = v[k];
  }
}
__device__ __forceinline__ void store4(bf16* o, const float* v, int n) {
  if (n >= 4 && ((uintptr_t)o & 7) == 0) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(o) = u;
  } else {
    for (int k = 0; k < n && k < 4; ++k) o[k] = __float2bfloat16(v[k]);
  }
}

// ------------------------------------------------------------ SIMT kernel

constexpr int kPx = 2;  // pixels per thread slot
constexpr int kCo = 4;  // channels per thread slot

// Shared memory: halo fp32 [KD][hr][hc][cks] (sized for the plan's largest
// tile, rounded to 16 bytes), the filter slice fp32 [tap][Cin][ct], the
// split-K partial sums [split - 1][8][slot threads], then each tap's halo
// and filter offsets (int [taps][2]).
// Threads form `split` groups; group k sums taps k, k + split, ... (in
// (d, i, j) order) for every slot, and group 0 adds the other groups' sums
// in group order: a fixed order, and a shorter chain for each thread.
template <typename TX, typename TW>
__global__ void __launch_bounds__(768)
    conv_simt_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                     TX* __restrict__ out, Dims g, Plan p, int fuse_silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = tile_of(g, p);
  const int hr = t.nr + g.KH - 1, hc = t.nc + g.KW - 1;
  const int cks = g.Cin % 4 == 0 ? g.Cin + 4 : g.Cin;
  const int halo_max = g.KD * (p.rows + g.KH - 1) * (p.cols + g.KW - 1) * cks;
  float* hs = reinterpret_cast<float*>(smem);
  float* ws = hs + ((halo_max + 3) & ~3);
  const int nslot_threads = blockDim.x / p.split;
  const int ntap = g.KD * g.KH * g.KW;
  float* part = ws + ntap * g.Cin * p.ct;
  int* taps = reinterpret_cast<int*>(part + (p.split - 1) * kPx * kCo *
                                               nslot_threads);
  for (int q = threadIdx.x; q < ntap; q += blockDim.x) {
    const int dd = q / (g.KH * g.KW), i = (q / g.KW) % g.KH, j = q % g.KW;
    taps[2 * q] = ((dd * hr + i) * hc + j) * cks;
    taps[2 * q + 1] = q * g.Cin * p.ct;
  }

  const int xvec = (sizeof(TX) == 4 && g.Cin % 4 == 0) ? 4 : 1;
  for_halo(g, t, hr, hc, xvec, [=](int cell, int v, size_t src, bool ok) {
    copy_in(hs + (size_t)cell * cks + v * xvec, x + src, ok, xvec);
  });
  const int wvec = (sizeof(TW) == 4 && g.Cout % 4 == 0) ? 4 : 1;
  for_filter(g, t.co0, p.ct, wvec, [=](int row, int v, size_t src, bool ok) {
    copy_in(ws + (size_t)row * p.ct + v * wvec, w + src, ok, wvec);
  });
  cp_async_wait_all();
  __syncthreads();

  const int P = t.nr * t.nc, lngc = log2i(p.ct / kCo);
  const int nslots = ((P + kPx - 1) / kPx) << lngc;
  const int grp = threadIdx.x / nslot_threads;
  const int lane = threadIdx.x - grp * nslot_threads;
  // every thread runs the same number of rounds: the barriers below
  for (int s0 = 0; s0 < nslots; s0 += nslot_threads) {
    const int s = s0 + lane;
    const bool live = s < nslots;
    const int cg = s & ((1 << lngc) - 1), pg = s >> lngc;
    float acc[kPx][kCo];
#pragma unroll
    for (int u = 0; u < kPx; ++u)
#pragma unroll
      for (int k = 0; k < kCo; ++k) acc[u][k] = 0.0f;
    if (live) {
      int base[kPx];
#pragma unroll
      for (int u = 0; u < kPx; ++u) {
        // a ragged last group repeats the last pixel and does not store it
        const int pix = min(pg * kPx + u, P - 1), r = pix_row(t, pix);
        base[u] = (r * hc + pix - r * t.nc) * cks;
      }
      for (int q = grp; q < ntap; q += p.split) {
        const float* xs = hs + taps[2 * q];
        const float* wt = ws + taps[2 * q + 1] + cg * kCo;
#pragma unroll 4
        for (int ci = 0; ci < g.Cin; ++ci) {
          const float4 wv = *reinterpret_cast<const float4*>(wt + ci * p.ct);
#pragma unroll
          for (int u = 0; u < kPx; ++u) {
            const float xv = xs[base[u] + ci];
            acc[u][0] = fmaf(xv, wv.x, acc[u][0]);
            acc[u][1] = fmaf(xv, wv.y, acc[u][1]);
            acc[u][2] = fmaf(xv, wv.z, acc[u][2]);
            acc[u][3] = fmaf(xv, wv.w, acc[u][3]);
          }
        }
      }
    }
    if (p.split > 1) {
      if (grp > 0) {
#pragma unroll
        for (int k = 0; k < kPx * kCo; ++k)
          part[((grp - 1) * kPx * kCo + k) * nslot_threads + lane] =
              acc[k / kCo][k % kCo];
      }
      __syncthreads();
      if (grp == 0) {
        for (int o = 1; o < p.split; ++o) {
#pragma unroll
          for (int k = 0; k < kPx * kCo; ++k)
            acc[k / kCo][k % kCo] +=
                part[((o - 1) * kPx * kCo + k) * nslot_threads + lane];
        }
      }
    }
    const int co = t.co0 + cg * kCo;
    if (live && grp == 0 && co < g.Cout) {
#pragma unroll
      for (int u = 0; u < kPx; ++u) {
        const int pix = pg * kPx + u;
        if (pix >= P) break;
        float v[kCo];
#pragma unroll
        for (int k = 0; k < kCo; ++k) v[k] = epilogue(acc[u][k], fuse_silu);
        store4(out + out_index(g, t, pix, co), v, g.Cout - co);
      }
    }
    if (p.split > 1) __syncthreads();  // part is rewritten next round
  }
}

// ----------------------------------------------------- tensor-core kernel

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}
// c (16 x 8, fp32) += a (16 x 16, bf16) * b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NT = ct / 8 n8 tiles. Shared memory (bf16): halo [KD][hr][hc][Cin + 8],
// filter slice [tap][Cin][CTS], then one 16 x CTS staging tile per warp.
// Cin + 8 and CTS are odd multiples of 8 values (16 bytes), so the 8 row
// addresses of each ldmatrix phase fall in distinct banks.
template <int NT>
__global__ void __launch_bounds__(256)
    conv_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   bf16* __restrict__ out, Dims g, Plan p, int fuse_silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int CT = 8 * NT;
  constexpr int CTS = (NT % 2) ? CT : CT + 8;
  const Tile t = tile_of(g, p);
  const int hr = t.nr + g.KH - 1, hc = t.nc + g.KW - 1;
  const int cks = g.Cin + 8, ntap = g.KD * g.KH * g.KW;
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* ws = hs + (size_t)g.KD * (p.rows + g.KH - 1) * (p.cols + g.KW - 1) *
                      cks;
  bf16* stage = ws + (size_t)ntap * g.Cin * CTS;

  for_halo(g, t, hr, hc, 8, [=](int cell, int v, size_t src, bool ok) {
    cp_async16(hs + (size_t)cell * cks + v * 8, x + src, ok);
  });
  for_filter(g, t.co0, CT, 8, [=](int row, int v, size_t src, bool ok) {
    cp_async16(ws + (size_t)row * CTS + v * 8, w + src, ok);
  });
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int P = t.nr * t.nc, nmt = (P + 15) / 16;
  bf16* st = stage + warp * 16 * CTS;
  const uint32_t hs_u = smem_u32(hs);
  // B: lane l gives row k = l % 16 of the k16 x n16 pair, columns
  // 8 * (l / 16) onwards; A: lane l gives pixel row l % 16, channels
  // 8 * (l / 16) onwards
  const uint32_t b_lane =
      smem_u32(ws) + (uint32_t)(((lane & 15) * CTS + (lane >> 4) * 8) * 2);
  for (int mt = warp; mt < nmt; mt += nwarps) {
    const int pix = min(mt * 16 + (lane & 15), P - 1), r = pix_row(t, pix);
    const uint32_t a_lane =
        hs_u + (uint32_t)(((r * hc + pix - r * t.nc) * cks + (lane >> 4) * 8) *
                          2);
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[n][k] = 0.0f;
    for (int dd = 0; dd < g.KD; ++dd)
      for (int i = 0; i < g.KH; ++i)
        for (int j = 0; j < g.KW; ++j) {
          const int tap = (dd * g.KH + i) * g.KW + j;
          const uint32_t a_tap =
              a_lane + (uint32_t)(((dd * hr + i) * hc + j) * cks * 2);
          const uint32_t b_tap = b_lane + (uint32_t)(tap * g.Cin * CTS * 2);
          for (int k = 0; k < g.Cin; k += 16) {
            uint32_t a[4];
            ldmatrix_x4(a, a_tap + k * 2);
            const uint32_t bk = b_tap + (uint32_t)(k * CTS * 2);
#pragma unroll
            for (int n = 0; n + 1 < NT; n += 2) {
              uint32_t b[4];
              ldmatrix_x4_trans(b, bk + n * 16);
              mma_bf16(acc[n], a, b[0], b[1]);
              mma_bf16(acc[n + 1], a, b[2], b[3]);
            }
            if (NT % 2) {
              uint32_t b[2];
              ldmatrix_x2_trans(b, bk + (NT - 1) * 16);
              mma_bf16(acc[NT - 1], a, b[0], b[1]);
            }
          }
        }
    // accumulator (n, h): rows lane/4 + 8h, channels 8n + 2 (lane % 4) + {0,1}
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (lane >> 2) + 8 * h, col = n * 8 + (lane & 3) * 2;
        *reinterpret_cast<__nv_bfloat162*>(st + row * CTS + col) =
            __floats2bfloat162_rn(epilogue(acc[n][2 * h], fuse_silu),
                                  epilogue(acc[n][2 * h + 1], fuse_silu));
      }
    __syncwarp();
    for (int q = lane; q < 16 * NT; q += 32) {
      const int row = q / NT, v = q % NT;
      const int px = mt * 16 + row, co = t.co0 + v * 8;
      if (px < P && co < g.Cout)
        *reinterpret_cast<uint4*>(out + out_index(g, t, px, co)) =
            *reinterpret_cast<const uint4*>(st + row * CTS + v * 8);
    }
    __syncwarp();
  }
}

template <typename TX, typename TW>
int launch(void (*kernel)(const TX*, const TW*, TX*, Dims, Plan, int),
           const void* x, const void* w, void* out, const int* dims,
           const int* plan, int fuse_silu, int device, cudaStream_t stream) {
  const Dims g{dims[0], dims[1], dims[2], dims[3], dims[4],
               dims[5], dims[6], dims[7], dims[8]};
  const Plan p{plan[0], plan[1], plan[2], plan[3],
               plan[4], plan[5], plan[6], plan[7]};
  const cudaError_t err = allow_smem((const void*)kernel, p.smem, device);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)p.grid_x, (unsigned)p.grid_y), p.threads, p.smem,
           stream>>>((const TX*)x, (const TW*)w, (TX*)out, g, p, fuse_silu);
  return (int)cudaGetLastError();
}

}  // namespace

// dims: B, D, H, W, Cin, KD, KH, KW, Cout (KH, KW odd; depth causal_same,
// which for KD = 1 is "same"); plan: conv.tile_plan's rows, cols, ct,
// split, threads, shared bytes, grid x, grid y. Each returns cudaGetLastError()
// after its launch.

// The SIMT kernel. dtype codes: 0 = float32, 1 = bfloat16; the output has
// x's dtype.
extern "C" int conv3d_forward(int x_dtype, int w_dtype, const void* x,
                              const void* w, void* out, const int* dims,
                              const int* plan, int fuse_silu, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && w_dtype == 0)
    return launch(conv_simt_kernel<float, float>, x, w, out, dims, plan,
                  fuse_silu, device, s);
  if (x_dtype == 0)
    return launch(conv_simt_kernel<float, bf16>, x, w, out, dims, plan,
                  fuse_silu, device, s);
  if (w_dtype == 0)
    return launch(conv_simt_kernel<bf16, float>, x, w, out, dims, plan,
                  fuse_silu, device, s);
  return launch(conv_simt_kernel<bf16, bf16>, x, w, out, dims, plan,
                fuse_silu, device, s);
}

// The tensor-core kernel: bf16 x and w, Cin % 16 == 0, Cout % 8 == 0,
// ct in (8, 16, 32).
extern "C" int conv3d_tc_forward(const void* x, const void* w, void* out,
                                 const int* dims, const int* plan,
                                 int fuse_silu, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (plan[2]) {
    case 8:
      return launch(conv_tc_kernel<1>, x, w, out, dims, plan, fuse_silu,
                    device, s);
    case 16:
      return launch(conv_tc_kernel<2>, x, w, out, dims, plan, fuse_silu,
                    device, s);
    case 32:
      return launch(conv_tc_kernel<4>, x, w, out, dims, plan, fuse_silu,
                    device, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
