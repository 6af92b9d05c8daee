// Fused batched Jacobi-PCG solve for the hybrid tick's FEA fallback.
//
// Replaces: src/repro/kernels/cg_fused.py, solve_b_fused (Pallas kernel
// body _make_solve_kernel, pallas_call in _make_solve). It computes exactly
// what repro.fea.fea2d.solve_b computes (fea2d.py:466-541): per slot, the
// matrix-free Q4 stencil K(x) p with the SIMP stiffness recomputed from the
// densities, the two axpys, the Jacobi precondition, the fixed-tree dots
// and norm, and the convergence loop with its per-slot freeze.
//
// What bounds it on the H100: neither bytes nor operations. One slot's
// solve is a chain of a few hundred dependent iterations, each a stencil
// over ~1.3k dofs plus three reductions, so the time is the latency of
// that chain: the barriers, the shared-memory round trips and the
// stencil's arithmetic on one SM. The bytes the solve must move
// (densities, diag, free mask, warm start in; displacement out: ~30 KB a
// slot at 30x20) take ~0.01 us at 3.35 TB/s.
//
// What the design does about it:
//  * one thread block per slot, of pn / 4 threads (pn: the node count
//    rounded up to a power of two): thread t owns nodes n = r * T + t
//    (r < 4; 256 threads at 30x20, 512 at 60x20) and keeps their U, R, P,
//    K p / Z, Jacobi diagonal, free mask and element stiffness in
//    registers for the whole solve. Shared memory holds only what other
//    threads read: P on a zero-bordered grid (so a neighbour's load needs
//    no bounds test), the element stiffness grid and the folds' scratch.
//    Device memory is touched once on entry and once on exit. Few threads
//    with four nodes each, rather than one node a thread: a warp's fixed
//    work (the folds, the two scalar divisions, the loop) is paid by 8
//    warps, not 32, and a warp whose slot holds no node skips it;
//  * the setup (F, the warm start's residual, the Jacobi diagonal, Z, RZ,
//    fnorm, rnorm), which the JAX package and the plain version run as
//    ~100 small tensor ops, runs in the kernel with the same operations and
//    the same folds: a solve is one launch;
//  * KE arrives by value as a launch parameter, so the stencil's multiplies
//    by KE read the constant bank;
//  * each reduction is one fold in two barriers (fold, below), and r.z and
//    r.r fold in the same pass: an iteration is five barriers (two folds
//    and P's publication), where a fold of halves through shared memory
//    took log2(pow2) + 2 barriers each, ~42 an iteration at 30x20. The
//    block size is a template parameter, so every level of the fold has a
//    compile-time trip count;
//  * each slot leaves the loop on its own criterion
//    (need & fnorm > 0 & rnorm > tol*fnorm & its < max_iter). The
//    reference freezes finished lanes inside one shared loop; a frozen
//    lane never changes, so the per-slot result is the same;
//  * the stencil is a gather per node: each node sums the contributions
//    of its up to four elements in the reference's fixed order
//    (c1 + c2) + (c3 + c4) (fea2d._assemble). No atomics, so the result
//    is deterministic and independent of the batch width;
//  * built with --fmad=false: every multiply and add rounds on its own,
//    as the plain PyTorch version's separate tensor ops do.
//
// Why the fold is fea2d.tree_sum's tree. tree_sum zero-pads the ndof
// values to a power of two and folds halves, x[:h] + x[h:], so it adds the
// pair that differs in the highest index bit first and bit 0 last. Dof
// 2n + c (c = 0 for x, 1 for y) has bit 0 = c and the node's bits above
// it, so the tree is: for each c, the same halving tree over the nodes,
// then (sum over c = 0) + (sum over c = 1). With n = r * T + w * 32 + l
// (register r, warp w, lane l), the node tree's top levels are r, folded
// inside the thread; the middle levels are w: each warp writes its 32
// values, one barrier, then one warp per (sum, c) lets lane l fold the W
// values [.][l] in halves in registers; the last five are lanes:
// __shfl_down_sync(v, h) is x[l] + x[l + h]. Lane 0 writes its sum, a
// second barrier, and every thread adds c = 0 and c = 1. Nodes past the
// last are zeros, as tree_sum's padding. So the sums are bitwise those of
// the plain loop, in 2 barriers instead of 13.
//
// Meshes of up to 2,048 nodes (60x30 has 1,891); the wrapper raises above.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxNodes = 2048;   // nodes a slot: NPT * threads
constexpr int kFoldSlots = 6;     // (sum, c) pairs a fold takes: 3 sums

struct KE64 {
  float v[64];                    // the 8x8 element stiffness, row-major
};

// torch.clamp_min(x, lo): NaN propagates
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return (x != x || x > lo) ? x : lo;
}

// NS sums in fea2d.tree_sum's order (see the file comment). v[s][r][c] is
// this thread's value at dof 2n + c of node n = r * 32W + tid; nl is the
// lanes that hold nodes (32, or the node count rounded up to a power of
// two on a mesh of fewer than 32 nodes). red: kFoldSlots * W * 32 floats,
// res: 6. Every trip count is a compile-time constant but nl's levels.
template <int NS, int NPT, int W>
__device__ __forceinline__ void fold(float (&v)[NS][NPT][2], float* red,
                                     float* res, int nl, float (&out)[NS]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int h = NPT / 2; h >= 1; h >>= 1)       // registers: the top levels
#pragma unroll
    for (int r = 0; r < h; ++r)
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int c = 0; c < 2; ++c) v[s][r][c] = v[s][r][c] + v[s][r + h][c];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      red[((2 * s + c) * W + warp) * 32 + lane] = v[s][0][c];
  __syncthreads();
  for (int q = warp; q < 2 * NS; q += W) {     // a warp per (sum, c)
    const float* src = red + q * W * 32 + lane;
    float a[W];
#pragma unroll
    for (int i = 0; i < W; ++i) a[i] = src[i * 32];
#pragma unroll
    for (int h = W / 2; h >= 1; h >>= 1)       // the warp levels
#pragma unroll
      for (int i = 0; i < h; ++i) a[i] = a[i] + a[i + h];
    float x = a[0];
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) {        // the lane levels
      const float y = __shfl_down_sync(0xffffffffu, x, h);
      if (2 * h <= nl) x = x + y;
    }
    if (lane == 0) res[q] = x;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < NS; ++s) out[s] = res[2 * s] + res[2 * s + 1];
}

// Where a node sits, computed once: the index of its (x - 1, y - 1)
// neighbour in the zero-bordered P grid ((nelx + 3) x (nely + 3): every
// neighbour's load is in bounds, and those off the mesh read 0) and which
// of its four elements exist (bit 0: (x, y), 1: (x - 1, y),
// 2: (x - 1, y - 1), 3: (x, y - 1)).
struct Node {
  int corner;
  unsigned el;
};

__device__ __forceinline__ Node node_at(int nelx, int nely, int x, int y) {
  Node g;
  g.corner = x * (nely + 3) + y;          // halo (x + 1, y + 1) - (1, 1)
  g.el = (x < nelx && y < nely ? 1u : 0u) | (x >= 1 && y < nely ? 2u : 0u) |
         (x >= 1 && y >= 1 ? 4u : 0u) | (x < nelx && y >= 1 ? 8u : 0u);
  return g;
}

// Two rows (r0, r0 + 1) of e * (KE @ ue) for one element, with the
// contraction in fea2d._ke_apply's order: acc = ue0*KE[:,0], then
// acc = acc + ue_j*KE[:,j] for j = 1..7. ue: the element's four nodes'
// (x, y) in the order n1, n2, n2 + 1, n1 + 1.
template <int R0>
__device__ __forceinline__ void elem_rows(const KE64& KE, float2 a, float2 b,
                                          float2 c, float2 d, float ee,
                                          float& o0, float& o1) {
  const float ue[8] = {a.x, a.y, b.x, b.y, c.x, c.y, d.x, d.y};
  float a0 = ue[0] * KE.v[R0 * 8];
  float a1 = ue[0] * KE.v[R0 * 8 + 8];
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    a0 = a0 + ue[j] * KE.v[R0 * 8 + j];
    a1 = a1 + ue[j] * KE.v[R0 * 8 + 8 + j];
  }
  o0 = ee * a0;
  o1 = ee * a1;
}

// (K p) at a node before the free mask: the four elements around it,
// (c1 + c2) + (c3 + c4), each absent element contributing 0; ee: the
// elements' stiffness in the order of Node::el
__device__ __forceinline__ float2 stencil(const float2* P2, int sh,
                                          const Node& g, const float (&ee)[4],
                                          const KE64& KE) {
  float2 q[3][3];                 // P at node (x - 1 + i, y - 1 + j)
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) q[i][j] = P2[g.corner + i * sh + j];
  // all four in straight-line code (their chains overlap), then an absent
  // element's pair is replaced by 0, as the reference's zero padding
  float c[4][2];
  elem_rows<0>(KE, q[1][1], q[2][1], q[2][2], q[1][2], ee[0],  // (x, y):
               c[0][0], c[0][1]);                              // node 1
  elem_rows<2>(KE, q[0][1], q[1][1], q[1][2], q[0][2], ee[1],  // (x-1, y):
               c[1][0], c[1][1]);                              // node 2
  elem_rows<4>(KE, q[0][0], q[1][0], q[1][1], q[0][1], ee[2],  // (x-1, y-1)
               c[2][0], c[2][1]);                              // node 3
  elem_rows<6>(KE, q[1][0], q[2][0], q[2][1], q[1][1], ee[3],  // (x, y-1):
               c[3][0], c[3][1]);                              // node 4
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool present = (g.el >> k) & 1u;
    c[k][0] = present ? c[k][0] : 0.0f;
    c[k][1] = present ? c[k][1] : 0.0f;
  }
  return make_float2((c[0][0] + c[1][0]) + (c[2][0] + c[3][0]),
                     (c[0][1] + c[1][1]) + (c[2][1] + c[3][1]));
}

// The Jacobi diagonal at a node before the "1 where not positive" rule:
// e * diag(KE) assembled as the stencil is, (c1 + c2) + (c3 + c4)
// (fea2d.jacobi_diag)
__device__ __forceinline__ float2 diag_at(const Node& g, const float (&ee)[4],
                                          const KE64& KE) {
  float c[4][2] = {};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if ((g.el >> k) & 1u) {
      c[k][0] = ee[k] * KE.v[(2 * k) * 9];
      c[k][1] = ee[k] * KE.v[(2 * k + 1) * 9];
    }
  return make_float2((c[0][0] + c[1][0]) + (c[2][0] + c[3][0]),
                     (c[0][1] + c[1][1]) + (c[2][1] + c[3][1]));
}

// NPT nodes a thread, W warps a block
template <int NPT, int W>
__global__ void __launch_bounds__(32 * W)
cg_solve_kernel(const float* __restrict__ X, const float* __restrict__ mask,
                const float* __restrict__ f_g, const float* __restrict__ free_g,
                const KE64 KE, const float* __restrict__ need,
                const float* __restrict__ U0, float* __restrict__ Uout,
                int* __restrict__ its_out, int nelx, int nely, int pn,
                float e_min, float one_minus_e_min, float tol, int max_iter) {
  extern __shared__ float2 sm2[];
  const int b = blockIdx.x;
  constexpr int T = 32 * W;
  const int tid = threadIdx.x;
  const int nnode = (nelx + 1) * (nely + 1);
  const int nl = pn < 32 ? pn : 32;       // lanes that hold nodes
  const int ndof = 2 * nnode;
  const int ne = nelx * nely;
  const int sh = nely + 3;                // the zero-bordered P grid
  float2* P2 = sm2;                       // P, read by the neighbours
  float* e = reinterpret_cast<float*>(P2 + (nelx + 3) * sh);
  float* red = e + ne;
  float* res = red + kFoldSlots * 32 * 32;
  const size_t off = (size_t)b * ndof;
  for (int i = tid; i < (nelx + 3) * sh; i += T)
    P2[i] = make_float2(0.0f, 0.0f);

  // SIMP stiffness, as fea2d._e_grid: e_min + x^3 * (1 - e_min), times
  // the active-element mask; x^3 as (x*x)*x like torch's pow(x, 3)
  for (int k = tid; k < ne; k += T) {
    const float x = X[(size_t)b * ne + k];
    float v = e_min + (x * x * x) * one_minus_e_min;
    if (mask != nullptr) v = v * mask[(size_t)b * ne + k];
    e[k] = v;
  }
  // this thread's nodes n = r * T + tid: where they sit, their elements'
  // stiffness and the state only this thread touches. The setup of the
  // plain version (cg_fused._setup): F = f * free, U = U0 * free (or 0),
  // R = F - K(x) U * free, diag, Z = R / diag * free, P = Z.
  Node geo[NPT];
  bool own[NPT];
  int eb[NPT];                            // element (x, y)'s index
  float ee[NPT][4];
  float U[NPT][2], R[NPT][2], P[NPT][2], Z[NPT][2], dg[NPT][2], fr[NPT][2];
#pragma unroll
  for (int r = 0; r < NPT; ++r) {
    const int n = r * T + tid;
    own[r] = n < nnode;
    const int x = n / (nely + 1), y = n - x * (nely + 1);
    geo[r] = node_at(nelx, nely, x, y);
    eb[r] = x * nely + y;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const size_t d = off + 2 * (size_t)n + c;
      fr[r][c] = own[r] ? free_g[d] : 0.0f;
      R[r][c] = own[r] ? f_g[d] * fr[r][c] : 0.0f;     // F, for now
      U[r][c] = (own[r] && U0 != nullptr) ? U0[d] * fr[r][c] : 0.0f;
    }
  }
  __syncthreads();                        // the zero border is written
#pragma unroll
  for (int r = 0; r < NPT; ++r)           // K U first
    if (own[r]) P2[geo[r].corner + sh + 1] = make_float2(U[r][0], U[r][1]);
  __syncthreads();                        // e and U are visible
  float v3[3][NPT][2];                    // R.Z, F.F, R.R
#pragma unroll
  for (int r = 0; r < NPT; ++r) {
    const Node& g = geo[r];
    const int ei[4] = {eb[r], eb[r] - nely, eb[r] - nely - 1, eb[r] - 1};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      ee[r][k] = own[r] && ((g.el >> k) & 1u) ? e[ei[k]] : 0.0f;
    float2 k = make_float2(0.0f, 0.0f), gd = make_float2(1.0f, 1.0f);
    if (own[r]) {
      k = stencil(P2, sh, g, ee[r], KE);
      gd = diag_at(g, ee[r], KE);
    }
    const float ku[2] = {k.x * fr[r][0], k.y * fr[r][1]};
    const float gg[2] = {gd.x, gd.y};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float F = R[r][c];
      dg[r][c] = gg[c] > 0.0f ? gg[c] : 1.0f;
      const float rr = F - ku[c];
      const float z = rr / dg[r][c] * fr[r][c];
      R[r][c] = own[r] ? rr : 0.0f;
      Z[r][c] = own[r] ? z : 0.0f;
      P[r][c] = Z[r][c];
      v3[0][r][c] = R[r][c] * Z[r][c];
      v3[1][r][c] = F * F;
      v3[2][r][c] = R[r][c] * R[r][c];
    }
  }
  __syncthreads();                        // K U has read P2
#pragma unroll
  for (int r = 0; r < NPT; ++r)
    if (own[r]) P2[geo[r].corner + sh + 1] = make_float2(P[r][0], P[r][1]);
  float s3[3];
  fold<3, NPT, W>(v3, red, res, nl, s3);     // its barriers publish P too
  const bool need_b = need[b] > 0.0f;
  const float fnorm = sqrtf(s3[1]);
  float rz = s3[0];
  float rnorm = sqrtf(s3[2]);
  int its = 0;
  while (need_b && fnorm > 0.0f && rnorm > tol * fnorm && its < max_iter) {
    // K(x) P * free, and P . KP; a slot no lane of the warp owns is
    // skipped whole (its values stay 0)
    float v1[1][NPT][2] = {}, kp[NPT][2] = {};
#pragma unroll
    for (int r = 0; r < NPT; ++r) {
      if (!own[r]) continue;
      const float2 k = stencil(P2, sh, geo[r], ee[r], KE);
      kp[r][0] = k.x * fr[r][0];
      kp[r][1] = k.y * fr[r][1];
#pragma unroll
      for (int c = 0; c < 2; ++c) v1[0][r][c] = P[r][c] * kp[r][c];
    }
    float pkp[1];
    fold<1, NPT, W>(v1, red, res, nl, pkp);
    const float alpha = rz / clamp_min_nan(pkp[0], 1e-30f);
    float v2[2][NPT][2] = {};
#pragma unroll
    for (int r = 0; r < NPT; ++r) {
      if (!own[r]) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        U[r][c] = U[r][c] + alpha * P[r][c];
        const float rr = R[r][c] - alpha * kp[r][c];
        const float z = rr / dg[r][c] * fr[r][c];
        R[r][c] = rr;
        Z[r][c] = z;
        v2[0][r][c] = rr * z;
        v2[1][r][c] = rr * rr;
      }
    }
    float sums[2];
    fold<2, NPT, W>(v2, red, res, nl, sums);
    const float beta = sums[0] / clamp_min_nan(rz, 1e-30f);
#pragma unroll
    for (int r = 0; r < NPT; ++r) {
      if (!own[r]) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) P[r][c] = Z[r][c] + beta * P[r][c];
      P2[geo[r].corner + sh + 1] = make_float2(P[r][0], P[r][1]);
    }
    rnorm = sqrtf(sums[1]);
    rz = sums[0];
    ++its;
    __syncthreads();                      // P is published
  }
#pragma unroll
  for (int r = 0; r < NPT; ++r)
    if (own[r])
      reinterpret_cast<float2*>(Uout + off)[r * T + tid] =
          make_float2(U[r][0], U[r][1]);
  if (tid == 0) its_out[b] = its;
}

template <int NPT, int W>
cudaError_t launch(size_t smem, int B, int device, cudaStream_t stream,
                   const float* X,
                   const float* mask, const float* f, const float* free_mask,
                   const KE64& KE, const float* need, const float* U0,
                   float* Uout, int* its_out, int nelx, int nely, int pn,
                   float e_min, float one_minus_e_min, float tol,
                   int max_iter) {
  const cudaError_t err =
      allow_smem((const void*)cg_solve_kernel<NPT, W>, (int)smem, device);
  if (err != cudaSuccess) return err;
  cg_solve_kernel<NPT, W><<<B, 32 * W, smem, stream>>>(
      X, mask, f, free_mask, KE, need, U0, Uout, its_out, nelx, nely, pn,
      e_min, one_minus_e_min, tol, max_iter);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t cg_fused_smem_bytes(int nelx, int nely) {
  const size_t halo = (size_t)(nelx + 3) * (nely + 3);
  return sizeof(float) *
         (2 * halo + (size_t)nelx * nely + kFoldSlots * 32 * 32 + 8);
}

// X (B, nely, nelx) densities, mask the same or null, f (the loads), free
// and U0 (B, ndof; U0 null for a cold start), KE 64 floats in host memory,
// need (B,) as 0/1 floats; pn: the node count rounded up to a power of two,
// at most 2048; threads: one of the block sizes built for NPT = pn /
// threads (1 when pn < threads), listed below. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a mesh or block the kernel does not take.
extern "C" int cg_fused_solve(const float* X, const float* mask, const float* f,
                              const float* free_mask, const float* KE_host,
                              const float* need, const float* U0, float* Uout,
                              int* its_out, int B, int nelx, int nely, int pn,
                              int threads, float e_min, float one_minus_e_min,
                              float tol, int max_iter, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int nnode = (nelx + 1) * (nely + 1);
  const int npt = pn > threads ? pn / threads : 1;
  if (B < 1 || pn < nnode || (pn & (pn - 1)) != 0 || pn > kMaxNodes ||
      (threads > pn && threads != 32))
    return (int)cudaErrorInvalidValue;
  KE64 KE;
  for (int i = 0; i < 64; ++i) KE.v[i] = KE_host[i];
  const size_t smem = cg_fused_smem_bytes(nelx, nely);
  cudaStream_t s = (cudaStream_t)stream;
  // the (nodes a thread, threads) pairs built: block_threads' rule (four
  // nodes a thread; meshes under 128 nodes one warp), and the other block
  // sizes at 1,024 nodes that kernel_probe times
#define CG_CASE(N, T)                                                     \
  if (npt == N && threads == T)                                           \
    return (int)launch<N, T / 32>(smem, B, device, s, X, mask, f,       \
                                  free_mask, KE,                          \
                                  need, U0, Uout, its_out, nelx, nely, pn, \
                                  e_min, one_minus_e_min, tol, max_iter);
  CG_CASE(1, 32) CG_CASE(2, 32) CG_CASE(4, 32) CG_CASE(4, 64)
  CG_CASE(4, 128) CG_CASE(4, 256) CG_CASE(4, 512)
  CG_CASE(8, 128) CG_CASE(2, 512) CG_CASE(1, 1024)
#undef CG_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cg_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
