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
// that chain (barriers and shared-memory round trips), not a rate. The
// bytes the solve must move (densities, diag, free mask, warm start in;
// displacement out: ~30 KB a slot at 30x20) take ~0.01 us at 3.35 TB/s.
//
// What the design does about it:
//  * one thread block per slot, the whole Krylov state (U, R, P, KP/Z,
//    Jacobi diagonal, free mask, the element stiffness grid and a
//    power-of-two reduction buffer) resident in shared memory from the
//    first iteration to the last; device memory is touched once on entry
//    and once on exit (42 KB at 30x20, 83 KB at 60x20: dynamic shared
//    memory, above 48 KB after cudaFuncSetAttribute);
//  * each slot leaves the loop on its own criterion
//    (need & fnorm > 0 & rnorm > tol*fnorm & its < max_iter). The
//    reference freezes finished lanes inside one shared loop; a frozen
//    lane never changes, so the per-slot result is the same;
//  * the stencil is a gather per node: each node sums the contributions
//    of its up to four elements in the reference's fixed order
//    (c1 + c2) + (c3 + c4) (fea2d._assemble). No atomics, so the result
//    is deterministic and independent of the batch width;
//  * reductions zero-pad to a power of two and fold in halves,
//    x[:h] + x[h:] — the summation tree of fea2d.tree_sum;
//  * built with --fmad=false: every multiply and add rounds on its own,
//    as the plain PyTorch version's separate tensor ops do.
//
// The setup (Jacobi diagonal, initial residual, RZ, fnorm, rnorm) runs as
// plain tensor ops in the wrapper, as it does in the JAX package.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// torch.clamp_min(x, lo): NaN propagates
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return (x != x || x > lo) ? x : lo;
}

// Sum of buf[0:pow2) by folding halves, buf[i] = buf[i] + buf[i + h]
// (fea2d.tree_sum's order). Entries [n, pow2) must be zero.
__device__ float fold(float* buf, int pow2) {
  __syncthreads();
  for (int h = pow2 >> 1; h >= 1; h >>= 1) {
    for (int i = threadIdx.x; i < h; i += blockDim.x) buf[i] = buf[i] + buf[i + h];
    __syncthreads();
  }
  const float r = buf[0];
  __syncthreads();
  return r;
}

// Two rows (r0, r0 + 1) of e * (KE @ ue) for element (ex, ey), with the
// contraction in fea2d._ke_apply's order: acc = ue0*KE[:,0], then
// acc = acc + ue_j*KE[:,j] for j = 1..7.
__device__ __forceinline__ void elem_rows(const float* P, const float* e,
                                          const float* KE, int nely, int ex,
                                          int ey, int r0, float& o0,
                                          float& o1) {
  const int s = nely + 1;
  const int n1 = 2 * (ex * s + ey);
  const int n2 = 2 * ((ex + 1) * s + ey);
  const float ue[8] = {P[n1],     P[n1 + 1], P[n2],     P[n2 + 1],
                       P[n2 + 2], P[n2 + 3], P[n1 + 2], P[n1 + 3]};
  const float* k0 = KE + r0 * 8;
  const float* k1 = k0 + 8;
  float a0 = ue[0] * k0[0];
  float a1 = ue[0] * k1[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    a0 = a0 + ue[j] * k0[j];
    a1 = a1 + ue[j] * k1[j];
  }
  const float ee = e[ex * nely + ey];
  o0 = ee * a0;
  o1 = ee * a1;
}

__global__ void __launch_bounds__(kThreads)
cg_solve_kernel(const float* __restrict__ X, const float* __restrict__ mask,
                const float* __restrict__ diag_g, const float* __restrict__ free_g,
                const float* __restrict__ KE_g, const float* __restrict__ need,
                const float* __restrict__ fnorm_g, const float* __restrict__ U0,
                const float* __restrict__ R0, const float* __restrict__ P0,
                const float* __restrict__ RZ0, const float* __restrict__ rnorm0,
                float* __restrict__ Uout, int* __restrict__ its_out, int nelx,
                int nely, int pow2, float e_min, float one_minus_e_min, float tol,
                int max_iter) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int ndof = 2 * (nelx + 1) * (nely + 1);
  const int nnode = (nelx + 1) * (nely + 1);
  const int ne = nelx * nely;
  float* U = sm;
  float* R = U + ndof;
  float* P = R + ndof;
  float* KP = P + ndof;  // K p, then reused for Z
  float* diag = KP + ndof;
  float* fr = diag + ndof;
  float* e = fr + ndof;
  float* KE = e + ne;
  float* buf = KE + 64;

  const size_t off = (size_t)b * ndof;
  for (int d = tid; d < ndof; d += blockDim.x) {
    U[d] = U0[off + d];
    R[d] = R0[off + d];
    P[d] = P0[off + d];
    diag[d] = diag_g[off + d];
    fr[d] = free_g[off + d];
  }
  for (int d = ndof + tid; d < pow2; d += blockDim.x) buf[d] = 0.0f;
  for (int i = tid; i < 64; i += blockDim.x) KE[i] = KE_g[i];
  // SIMP stiffness, as fea2d._e_grid: e_min + x^3 * (1 - e_min), times
  // the active-element mask; x^3 as (x*x)*x like torch's pow(x, 3)
  for (int k = tid; k < ne; k += blockDim.x) {
    const float x = X[(size_t)b * ne + k];
    float v = e_min + (x * x * x) * one_minus_e_min;
    if (mask != nullptr) v = v * mask[(size_t)b * ne + k];
    e[k] = v;
  }
  __syncthreads();

  const bool need_b = need[b] > 0.0f;
  const float fnorm = fnorm_g[b];
  float rz = RZ0[b];
  float rnorm = rnorm0[b];
  int its = 0;
  while (need_b && fnorm > 0.0f && rnorm > tol * fnorm && its < max_iter) {
    // KP = K(x) P * free, buf = P * KP
    for (int n = tid; n < nnode; n += blockDim.x) {
      const int x = n / (nely + 1);
      const int y = n - x * (nely + 1);
      float c1x = 0.f, c1y = 0.f, c2x = 0.f, c2y = 0.f;
      float c3x = 0.f, c3y = 0.f, c4x = 0.f, c4y = 0.f;
      if (x < nelx && y < nely) elem_rows(P, e, KE, nely, x, y, 0, c1x, c1y);
      if (x >= 1 && y < nely) elem_rows(P, e, KE, nely, x - 1, y, 2, c2x, c2y);
      if (x >= 1 && y >= 1) elem_rows(P, e, KE, nely, x - 1, y - 1, 4, c3x, c3y);
      if (x < nelx && y >= 1) elem_rows(P, e, KE, nely, x, y - 1, 6, c4x, c4y);
      const int d = 2 * n;
      const float kx = ((c1x + c2x) + (c3x + c4x)) * fr[d];
      const float ky = ((c1y + c2y) + (c3y + c4y)) * fr[d + 1];
      KP[d] = kx;
      KP[d + 1] = ky;
      buf[d] = P[d] * kx;
      buf[d + 1] = P[d + 1] * ky;
    }
    const float pkp = fold(buf, pow2);
    const float alpha = rz / clamp_min_nan(pkp, 1e-30f);
    for (int d = tid; d < ndof; d += blockDim.x) {
      U[d] = U[d] + alpha * P[d];
      const float r = R[d] - alpha * KP[d];
      R[d] = r;
      const float z = r / diag[d] * fr[d];
      KP[d] = z;
      buf[d] = r * z;
    }
    const float rz_new = fold(buf, pow2);
    const float beta = rz_new / clamp_min_nan(rz, 1e-30f);
    for (int d = tid; d < ndof; d += blockDim.x) {
      P[d] = KP[d] + beta * P[d];
      buf[d] = R[d] * R[d];
    }
    rnorm = sqrtf(fold(buf, pow2));
    rz = rz_new;
    ++its;
  }
  for (int d = tid; d < ndof; d += blockDim.x) Uout[off + d] = U[d];
  if (tid == 0) its_out[b] = its;
}

}  // namespace

extern "C" size_t cg_fused_smem_bytes(int nelx, int nely, int pow2) {
  const int ndof = 2 * (nelx + 1) * (nely + 1);
  return sizeof(float) * (size_t)(6 * ndof + nelx * nely + 64 + pow2);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int cg_fused_solve(const float* X, const float* mask, const float* diag,
                              const float* free_mask, const float* KE,
                              const float* need, const float* fnorm,
                              const float* U0, const float* R0, const float* P0,
                              const float* RZ0, const float* rnorm0, float* Uout,
                              int* its_out, int B, int nelx, int nely, int pow2,
                              float e_min, float one_minus_e_min, float tol,
                              int max_iter, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = cg_fused_smem_bytes(nelx, nely, pow2);
  err = cudaFuncSetAttribute(cg_solve_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cg_solve_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      X, mask, diag, free_mask, KE, need, fnorm, U0, R0, P0, RZ0, rnorm0, Uout,
      its_out, nelx, nely, pow2, e_min, one_minus_e_min, tol, max_iter);
  return (int)cudaGetLastError();
}

extern "C" const char* cg_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
