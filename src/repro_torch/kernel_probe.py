"""Where the device time of the GEMV, the CG solve, the CRONet megakernel
and the fused sLSTM goes, on one NVIDIA GPU.

    PYTHONPATH=src python -m repro_torch.kernel_probe [--out FILE]
        [--cronet] [--slstm] [--flash-simt] [--maxpool] [--silu]
        [--cronet-kernels]
        [--cg-wrapper-only]

GEMV (csrc/gemm.cu): every GEMM of one CRONet medium ``l1`` forward, fp32
and bf16, timed by CUDA-graph replay under gemm_plan's plan and under the
plans it was chosen over (trunk fc1 with a cluster of 1, 2 and 4 blocks;
half and double the k lanes, and column tiles a quarter as wide,
elsewhere), beside an ``empty`` build of the
same source (the kernel returns at once: the launch floor of that grid and
cluster) and ``torch.matmul``.

CG (csrc/cg_fused.cu): the need_idle_warm batch of chip_smoke.py (CRONet
medium, 4 slots, a warm start, one idle and one need=False slot) run for a
fixed number of iterations (the loop's convergence test is cut, so every
build runs the same count) with one phase of the iteration taken out: the
stencil (K p becomes p), the two folds (each thread keeps its own value:
no barriers) or the IEEE division of the Jacobi step; ``skeleton`` takes
out all three. The full build runs at 128, 256, 512 and 1,024 threads a
block, the cut builds at block_threads' count. Per-iteration us = (time
at N iterations - time at 0) / N; the time at 0 is the launch, the
in-kernel setup and the write-out. A ``timed`` build counts the SM cycles
of each phase of an iteration (clock64 in thread 0, barrier waits
included) at 256, 512 and 1,024 threads. Beside them: a ``solve_b_fused`` call, eager and by graph replay, and the
device kernels torch.profiler sees in it.

cronet_fused (``--cronet``): the conv kernel alone, its trunk or branch
tiles alone, its conv1 or conv2 products cut, the head alone and with each
of its phases cut, at medium, B = 1 and 4, fp32 and bf16, by graph replay;
a timed build counts the head's and two conv blocks' SM cycles by phase.
``--cronet-kernels`` prints the device kernels torch.profiler sees per
call (run in a process of its own). slstm_fused (``--slstm``) at
xlstm-1.3b's widths with the flag wait, the h re-read, the dot products or
the gate update cut, and the SM cycles of each phase of a step. The SIMT
flash kernel (``--flash-simt``) at qwen2.5-32b's widths in fp32, S 1024,
non-causal and causal, with its K/V staging, score products, softmax or
P.V products cut, and the SM cycles of each phase a kv tile; then the
wrapper beside SDPA at the other configurations' widths in fp32 and bf16.
``--maxpool`` times maxpool2d through its wrapper by graph replay;
``--silu`` times silu_lut and silu_exact through their wrappers beside an
``empty`` build of csrc/silu.cu at the same grid (the launch floor), the
table read through the read-only cache, evict-first loads and stores,
nvcc's own division, the plans silu_plan's was chosen over, and F.silu.

Outputs of the cut builds are not results; only their times are read. The
phases are cut by editing a copy of each source at fixed anchors: an anchor
that is no longer found raises, so the probe follows the kernels or fails
loudly.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

GEMM_HOOKS = [  # (anchor, replacement)
    ("  __shared__ float part[kMaxWarps][kMaxCols];",
     "#ifdef EMPTY\n  if (M > 0) return;\n#endif\n"
     "  __shared__ float part[kMaxWarps][kMaxCols];"),
]
CG_HOOKS = [
    ("while (need_b && fnorm > 0.0f && rnorm > tol * fnorm && its < max_iter)",
     "while (need_b && its < max_iter)"),
    ("      const float2 k = stencil(P2, sh, geo[r], ee[r], KE);",
     "#ifdef NO_STENCIL\n      const float2 k = P2[geo[r].corner + sh + 1];\n"
     "#else\n      const float2 k = stencil(P2, sh, geo[r], ee[r], KE);\n"
     "#endif"),
    ("  for (int h = NPT / 2; h >= 1; h >>= 1)       // registers: the top",
     "#ifdef NO_FOLD\n#pragma unroll\n  for (int s = 0; s < NS; ++s) "
     "out[s] = v[s][0][0] + v[s][0][1];\n  if (nl > 0) return;\n#endif\n"
     "#pragma unroll\n"
     "  for (int h = NPT / 2; h >= 1; h >>= 1)       // registers: the top"),
    ("        const float z = rr / dg[r][c] * fr[r][c];",
     "#ifdef NO_DIV\n        const float z = rr * dg[r][c] * fr[r][c];\n"
     "#else\n        const float z = rr / dg[r][c] * fr[r][c];\n#endif"),
]
# the timed build: SM cycles (clock64) of each phase of an iteration, as
# thread 0 sees them (the barriers' waits included), summed over the solve
# and written over the first values of the slot's output
CG_PHASES = ("stencil", "fold1", "update", "fold2", "p_store", "barrier")
CG_HOOKS += [
    ("  int its = 0;\n  while (need_b",
     "#ifdef TIMED\n  long long t_acc[6] = {0, 0, 0, 0, 0, 0};\n"
     "  long long t0 = clock64();\n#define MARK(k) { const long long t1 = "
     "clock64(); t_acc[k] += t1 - t0; t0 = t1; }\n#else\n#define MARK(k)\n"
     "#endif\n  int its = 0;\n  while (need_b"),
    ("    float pkp[1];", "    MARK(0)\n    float pkp[1];"),
    ("    const float alpha = rz / clamp_min_nan(pkp[0], 1e-30f);",
     "    MARK(1)\n    const float alpha = rz / clamp_min_nan(pkp[0], 1e-30f);"),
    ("    float sums[2];", "    MARK(2)\n    float sums[2];"),
    ("    const float beta = sums[0] / clamp_min_nan(rz, 1e-30f);",
     "    MARK(3)\n    const float beta = sums[0] / clamp_min_nan(rz, 1e-30f);"),
    ("    rnorm = sqrtf(sums[1]);", "    MARK(4)\n    rnorm = sqrtf(sums[1]);"),
    ("    __syncthreads();                      // P is published\n",
     "    __syncthreads();                      // P is published\n"
     "    MARK(5)\n"),
    ("  if (tid == 0) its_out[b] = its;",
     "#ifdef TIMED\n  __syncthreads();\n  if (tid == 0)\n"
     "    for (int k = 0; k < 6; ++k) Uout[off + k] = (float)t_acc[k];\n"
     "#endif\n  if (tid == 0) its_out[b] = its;"),
]
GEMM_BUILDS = {"full": [], "empty": ["EMPTY"]}
# silu_lut / silu_exact (csrc/silu.cu): an ``empty`` build whose kernel
# returns at once, launched with the wrappers' arguments (the launch floor
# of that grid); ``ldg_table``: the LUT read from the table in device
# memory through the read-only cache, not staged in shared memory;
# ``streaming``: the vectors loaded and stored with the evict-first hints
# (__ldcs / __stcs); ``nvcc_div``: silu_exact with nvcc's own division for
# every element (a range check and a branch each)
SILU_HOOKS = [
    ("  constexpr int kVec = 16 / sizeof(T);\n",
     "#ifdef EMPTY\n  if (nvec >= 0) return;\n#endif\n"
     "  constexpr int kVec = 16 / sizeof(T);\n"),
    ("  if (LUT) {\n    for (int k = tid; k < kEntries; k += blockDim.x) "
     "tab[k] = __ldg(table + k);\n    __syncthreads();\n  }\n",
     "#ifdef LDG_TABLE\n#define tab table\n#else\n"
     "  if (LUT) {\n    for (int k = tid; k < kEntries; k += blockDim.x) "
     "tab[k] = __ldg(table + k);\n    __syncthreads();\n  }\n#endif\n"),
    ("r[j] = __ldg(xv + i + j * step);",
     "r[j] = LOAD(xv + i + j * step);"),
    ("ov[i + j * step] = pack(v, tag);",
     "STORE(ov + i + j * step, pack(v, tag));"),
    ("  return m >= 0x1p-64f && m <= 0x1p64f && d <= 0x1p32f;\n",
     "#ifdef NVCC_DIV\n  if (m >= 0.0f) return false;\n#endif\n"
     "  return m >= 0x1p-64f && m <= 0x1p64f && d <= 0x1p32f;\n"),
    ("namespace {\n",
     "#ifdef STREAMING\n#define LOAD __ldcs\n#define STORE __stcs\n#else\n"
     "#define LOAD __ldg\n#define STORE(p, v) (*(p) = (v))\n#endif\n"
     "namespace {\n"),
]
SILU_BUILDS = {"empty": ["EMPTY"], "ldg_table": ["LDG_TABLE"],
               "streaming": ["STREAMING"], "nvcc_div": ["NVCC_DIV"]}
CG_BUILDS = {"full": [], "no_stencil": ["NO_STENCIL"], "no_fold": ["NO_FOLD"],
             "no_div": ["NO_DIV"],
             "skeleton": ["NO_STENCIL", "NO_FOLD", "NO_DIV"],
             "timed": ["TIMED"]}
CG_ITERS = 300       # below need_idle_warm's 305: the full build converges
GEMM_CASES = {       # (M, K, N, activation), per forward
    "trunk_fc1": (1, 4800, 40, "silu", 1), "fc2": (1, 40, 2560, None, 2),
    "rnn_wx": (1, 32, 64, None, 10), "rnn_wh": (1, 64, 64, None, 10),
    "branch_fc1": (1, 64, 40, "silu", 1)}


def _cuts(names) -> str:
    """A preamble that defines CUT_<NAME> 1 when -DNO_<NAME> is given,
    else 0, for each of ``names``."""
    return "".join(f"#ifdef NO_{n}\n#define CUT_{n} 1\n#else\n#define "
                   f"CUT_{n} 0\n#endif\n" for n in names)


_TIMER = ("#ifdef TIMED\n  long long t_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
          "  long long t0 = clock64();\n#define MARK(k) { const long long "
          "t1 = clock64(); t_acc[k] += t1 - t0; t0 = t1; }\n#else\n"
          "#define MARK(k)\n#endif\n")

# cronet_fused (csrc/cronet_fused.cu): the conv kernel alone (the head's
# launch cut), its trunk or branch tiles alone, its conv1 or conv2 products
# cut, the head alone, and the head with each of its phases cut (the AAP3D
# feature loads, fc1, trunk fc2, the RNN, branch fc1 and fc2); the timed
# build counts rank 0's SM cycles by phase in thread 0 of each slot's
# cluster (features: the feature loads and the wait for the staged
# weights), and in thread 0 of the first trunk and the last branch block
# of slot 0 (g_conv_cycles, read by probe_conv_cycles)
CRONET_PHASES = ("stage", "features", "fc1", "rnn_bfc1", "cluster_wait",
                 "fc2")
CRONET_HOOKS = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n#ifdef TIMED\n"
     "__device__ long long g_conv_cycles[2][8];\n#endif\n" + _cuts(
         ("CONV", "TRUNK", "BRANCH", "CONV1", "CONV2", "HEAD", "AAP", "FC1",
          "FC2", "RNN", "BFC"))),
    ("  const int tid = threadIdx.x;\n\n  // conv2's filter",
     "  const int tid = threadIdx.x;\n#ifdef TIMED\n  long long ct[6];\n"
     "  ct[0] = clock64();\n#define CMARK(k) ct[k] = clock64();\n#else\n"
     "#define CMARK(k)\n#endif\n\n  // conv2's filter"),
    ("    halo[i] = v;\n  }\n  __syncthreads();\n",
     "    halo[i] = v;\n  }\n  __syncthreads();\n  CMARK(1)\n"),
    ("    if (in) {\n", "    if (!CUT_CONV1 && in) {\n"),
    ("w2r[u][e + 2], w2r[u][e + 3]);\n  }\n  __syncthreads();\n",
     "w2r[u][e + 2], w2r[u][e + 3]);\n  }\n  __syncthreads();\n  CMARK(2)\n"),
    ("  if (active) {\n    for (int ki = 0; ki < 3; ++ki) {",
     "  if (!CUT_CONV2 && active) {\n    for (int ki = 0; ki < 3; ++ki) {"),
    ("  __syncthreads();   // w2s is done: the SiLU'd tile goes there\n",
     "  __syncthreads();   // w2s is done: the SiLU'd tile goes there\n"
     "  CMARK(3)\n"),
    ("        xch[(c * kRun + p) * kGroupThreads + rt] = acc[c][p];\n"
     "  __syncthreads();\n",
     "        xch[(c * kRun + p) * kGroupThreads + rt] = acc[c][p];\n"
     "  __syncthreads();\n  CMARK(4)\n"),
    ("      for (int c = 0; c < kChan; ++c) op[c] = acc[c][p];\n    }\n  }\n"
     "  __syncthreads();\n}",
     "      for (int c = 0; c < kChan; ++c) op[c] = acc[c][p];\n    }\n  }\n"
     "  __syncthreads();\n  CMARK(5)\n"
     "#ifdef TIMED\n  if (tid == 0 && blockIdx.y == 0 &&\n"
     "      (int)blockIdx.x == (C2 == kTrunkC2 ? 0 : (int)gridDim.x - 1))\n"
     "    for (int k = 0; k < 6; ++k)\n"
     "      g_conv_cycles[C2 == kTrunkC2 ? 0 : 1][k] = ct[k] - ct[0];\n"
     "#endif\n}"),
    ("extern \"C\" const char* cronet_fused_error_string(int err) {",
     "#ifdef TIMED\nextern \"C\" int probe_conv_cycles(long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_conv_cycles,\n"
     "                                   sizeof(g_conv_cycles));\n}\n#endif\n"
     "extern \"C\" const char* cronet_fused_error_string(int err) {"),
    ("  conv_kernel<T><<<", "  if (!CUT_CONV) conv_kernel<T><<<"),
    ("  err = cudaLaunchKernelEx(&cfg, head_kernel<T, V>,",
     "  if (!CUT_HEAD) err = cudaLaunchKernelEx(&cfg, head_kernel<T, V>,"),
    ("  if ((int)blockIdx.x < n_trunk) {",
     "  if (CUT_TRUNK && (int)blockIdx.x < n_trunk) return;\n"
     "  if (CUT_BRANCH && (int)blockIdx.x >= n_trunk) return;\n"
     "  if ((int)blockIdx.x < n_trunk) {"),
    ("  const int rank = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;\n",
     "  const int rank = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;\n"
     + _TIMER),
    ("  __syncthreads();                     // the window table\n",
     "  __syncthreads();                     // the window table\n"
     "  MARK(0)\n"),
    ("          v[u][a][y] = f < nk && a < e[1]",
     "          v[u][a][y] = !CUT_AAP && f < nk && a < e[1]"),
    ("  cp_async_wait_all();\n  __syncthreads();\n",
     "  cp_async_wait_all();\n  __syncthreads();\n  MARK(1)\n"),
    ("      gemv_lane<V>(fs, sw1", "      if (!CUT_FC1) gemv_lane<V>(fs, sw1"),
    ("    cluster_arrive();                  // this rank's sums are written\n",
     "    cluster_arrive();                  // this rank's sums are written\n"
     "    MARK(2)\n"),
    ("  for (int i = tid; i < Tn * kHid; i += kThreads) {",
     "  for (int i = tid; i < (CUT_RNN ? 0 : Tn * kHid); i += kThreads) {"),
    ("  for (int t = 0; t < Tn; ++t) {\n    const float* hc",
     "  for (int t = 0; t < (CUT_RNN ? 0 : Tn); ++t) {\n    const float* hc"),
    ("    for (int k = 0; k < kHid; ++k) s = fmaf(hf[k], w_bf1[k], s);",
     "    for (int k = 0; k < (CUT_BFC ? 0 : kHid); ++k) s = fmaf(hf[k], "
     "w_bf1[k], s);"),
    ("  cluster_wait();                      // every rank's fc1 sums are here\n",
     "  MARK(3)\n"
     "  cluster_wait();                      // every rank's fc1 sums are here\n"),
    ("    tmid[tid] = silu(s);\n  }\n  __syncthreads();\n",
     "    tmid[tid] = silu(s);\n  }\n  __syncthreads();\n  MARK(4)\n"),
    ("      gemv_lane<V>(tmid, st2", "      if (!CUT_FC2) gemv_lane<V>(tmid, st2"),
    ("      gemv_lane<V>(bmid, sb2", "      if (!CUT_BFC) gemv_lane<V>(bmid, sb2"),
    ("      out[(size_t)b * P + c0 + i] = sb * st;\n    }\n  }\n}",
     "      out[(size_t)b * P + c0 + i] = sb * st;\n    }\n  }\n  MARK(5)\n"
     "#ifdef TIMED\n  __syncthreads();\n  if (rank == 0 && tid == 0)\n"
     "    for (int k = 0; k < 6; ++k) out[(size_t)b * P + k] = "
     "(float)t_acc[k];\n#endif\n}"),
]
CONV_PHASES = ("stage", "conv1", "conv2", "exchange", "epilogue")
CRONET_BUILDS = {"full": [], "conv_only": ["NO_HEAD"],
                 "conv_no_conv1": ["NO_HEAD", "NO_CONV1"],
                 "conv_no_conv2": ["NO_HEAD", "NO_CONV2"],
                 "trunk_only": ["NO_HEAD", "NO_BRANCH"],
                 "branch_only": ["NO_HEAD", "NO_TRUNK"],
                 "head_only": ["NO_CONV"],
                 "head_no_aap3d": ["NO_CONV", "NO_AAP"],
                 "head_no_fc1": ["NO_CONV", "NO_FC1"],
                 "head_no_fc2": ["NO_CONV", "NO_FC2"],
                 "head_no_rnn": ["NO_CONV", "NO_RNN"],
                 "head_no_bfc": ["NO_CONV", "NO_BFC"],
                 "timed": ["TIMED"]}

# slstm_fused (csrc/slstm.cu): the step with the head's flag wait, the h
# re-read, the dot products or the gate update cut; the timed build counts
# each phase's SM cycles a step in thread 0 of block 0 (gate: the slice
# sums and the state update)
SLSTM_PHASES = ("wait", "h_read", "dots", "gate")
SLSTM_HOOKS = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     + _cuts(("BARRIER", "HREAD", "DOTS", "GATE"))),
    ("  for (int t = 0; t < S; ++t) {\n", _TIMER
     + "  for (int t = 0; t < S; ++t) {\n"),
    ("          while (ld_acquire(f) < t) {",
     "          while (!CUT_BARRIER && ld_acquire(f) < t) {"),
    ("      __syncthreads();   // the acquires order every thread's reads of h\n",
     "      __syncthreads();   // the acquires order every thread's reads of h\n"
     "      MARK(0)\n"),
    ("      if (vec_h) {", "      if (CUT_HREAD) {\n      } else if (vec_h) {"),
    ("          hT[k * hs + b] = __ldcg(hprev + (size_t)b * d + k);\n"
     "        }\n      }\n      __syncthreads();\n",
     "          hT[k * hs + b] = __ldcg(hprev + (size_t)b * d + k);\n"
     "        }\n      }\n      __syncthreads();\n      MARK(1)\n"),
    ("    for (int b0 = 0; b0 < bpad; b0 += kTileB) {",
     "    for (int b0 = 0; b0 < (CUT_DOTS ? 0 : bpad); b0 += kTileB) {"),
    ("    __syncthreads();\n\n    // each (b, unit)",
     "    __syncthreads();\n    MARK(2)\n\n    // each (b, unit)"),
    ("      const float z = tanhf(pb[0]);\n",
     "#if CUT_GATE\n      const float h = pb[0] + pb[1] + pb[2] + pb[3];"
     "\n#else\n      const float z = tanhf(pb[0]);\n"),
    ("      ms[idx] = m_new;\n", "      ms[idx] = m_new;\n#endif\n"),
    ("    if (t + 1 < S) {\n      __syncthreads();  // every h",
     "    MARK(3)\n    if (t + 1 < S) {\n      __syncthreads();  // every h"),
    ("        wxr[g] = own ? ld_now(wx_ptr(ob, ou, g, t + 1)) : 0.0f;\n"
     "    }\n  }\n}",
     "        wxr[g] = own ? ld_now(wx_ptr(ob, ou, g, t + 1)) : 0.0f;\n"
     "    }\n"
     "  }\n#ifdef TIMED\n  if (blockIdx.x == 0 && tid == 0)\n"
     "    for (int k = 0; k < 4; ++k) st(out, k, (float)t_acc[k] / S);\n"
     "#endif\n}"),
]
SLSTM_BUILDS = {"full": [], "no_barrier": ["NO_BARRIER"],
                "no_h_read": ["NO_HREAD"], "no_dots": ["NO_DOTS"],
                "no_gate": ["NO_GATE"], "timed": ["TIMED"]}


# the SIMT flash kernel (csrc/flash_attention.cu, simt::flash_kernel): the
# K/V copies, the score products, the softmax (its exponentials and row
# max shuffles) or the P.V products cut; the timed build counts each
# phase's SM cycles a kv tile in thread 0 of the block with the most tiles
# (q head 0, batch 0; stage: the wait for K and the barrier after it, and
# issuing V's copies; softmax: everything from the scores' end to the P.V
# loop, its two barriers and the wait for V included), written over the
# first values of that block's first output row with the tile count and a
# mark
FLASH_PHASES = ("stage", "scores", "softmax", "pv")
FLASH_HOOKS = [
    ("#include <cstdint>\n", "#include <cstdint>\n"
     + _cuts(("STAGE", "SCORES", "SOFTMAX", "PV"))),
    ("  for (int r = w.r0, c = w.c0; r < kBK; w.next(r, c)) {",
     "  for (int r = w.r0, c = w.c0; r < (CUT_STAGE ? 0 : kBK); "
     "w.next(r, c)) {"),
    ("  const int tid = threadIdx.x, ty = tid / kLanes, tx = tid % kLanes;\n",
     "  const int tid = threadIdx.x, ty = tid / kLanes, tx = tid % kLanes;\n"
     + _TIMER + "#ifdef TIMED\n  int n_done = 0;\n#endif\n"),
    ("    stage(Vs, DV, vb, v_step, k0, Sk, wv);\n    cp_async_commit();\n",
     "    stage(Vs, DV, vb, v_step, k0, Sk, wv);\n    cp_async_commit();\n"
     "    MARK(0)\n"),
    ("    for (int d0 = 0; d0 < D; d0 += 16) {",
     "    for (int d0 = 0; d0 < (CUT_SCORES ? 0 : D); d0 += 16) {"),
    ("              s[r][i] = fmaf(qv[r][e], kv[i][e], s[r][i]);\n      }\n"
     "    }\n",
     "              s[r][i] = fmaf(qv[r][e], kv[i][e], s[r][i]);\n      }\n"
     "    }\n    MARK(1)\n"),
    ("      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));\n"
     "      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));\n"
     "      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));\n",
     "      if (!CUT_SOFTMAX) {\n"
     "      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));\n"
     "      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));\n"
     "      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));\n      }\n"),
    ("      const float alpha = exp2f((m[r] - m_new) * c);",
     "      const float alpha = CUT_SOFTMAX ? 1.0f : exp2f((m[r] - m_new) * c);"),
    ("        const float pv = exp2f(fmaf(s[r][i], c, -mc));",
     "        const float pv = CUT_SOFTMAX ? s[r][i]\n"
     "                                     : exp2f(fmaf(s[r][i], c, -mc));"),
    ("    __syncthreads();      // and everyone's, and every p\n",
     "    __syncthreads();      // and everyone's, and every p\n    MARK(2)\n"),
    ("    for (int key = 0; key < kBK; ++key) {",
     "    for (int key = 0; key < (CUT_PV ? 0 : kBK); ++key) {"),
    ("            acc[r][j * VW + e] = fmaf(pv[r], vv[j][e], acc[r][j * VW + e]);"
     "\n    }\n  }\n",
     "            acc[r][j * VW + e] = fmaf(pv[r], vv[j][e], acc[r][j * VW + e]);"
     "\n    }\n    MARK(3)\n#ifdef TIMED\n    ++n_done;\n#endif\n  }\n"),
    ("      store<VW>(orow + VW * kLanes * j, o);\n    }\n  }\n}",
     "      store<VW>(orow + VW * kLanes * j, o);\n    }\n  }\n"
     "#ifdef TIMED\n  __syncthreads();\n"
     "  if (tid == 0 && blockIdx.y == 0 && h == 0 && b == 0) {\n"
     "    float* o = reinterpret_cast<float*>(out) + (size_t)q0 * Hq * DV;\n"
     "    for (int k = 0; k < 4; ++k) o[k] = (float)t_acc[k] / n_done;\n"
     "    o[4] = (float)n_done;\n    o[5] = -12345.0f;\n  }\n#endif\n}"),
]
FLASH_BUILDS = {"full": [], "no_stage": ["NO_STAGE"],
                "no_scores": ["NO_SCORES"], "no_softmax": ["NO_SOFTMAX"],
                "no_pv": ["NO_PV"], "timed": ["TIMED"]}

def _edit(src: str, hooks, name: str) -> str:
    for anchor, repl in hooks:
        if anchor not in src:
            raise RuntimeError(f"kernel_probe: anchor not found in {name}: "
                               f"{anchor!r}")
        src = src.replace(anchor, repl)
    return src


def build(out_dir: Path, source: str, hooks, builds, extra):
    """One library per build of ``source``, all nvcc processes at once."""
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{source}_probe.cu"
    cu.write_text(_edit((_build.CSRC / f"{source}.cu").read_text(), hooks,
                        f"{source}.cu"))
    procs = {}
    for name, macros in builds.items():
        so = out_dir / f"lib{source}_probe_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.ARCH, *_build.COMMON_FLAGS,
             *_build.INCLUDE, *extra,
             *[f"-D{m}" for m in macros], "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"kernel_probe: nvcc failed for {source} "
                               f"{name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _plan_variants(M, K, N, dt):
    from repro_torch.kernels import gemm
    rule = gemm.gemm_plan(M, K, N, dt, dt)
    out = {"rule": rule}
    if rule.cluster > 1:
        for c in (1, 2, 4):
            kb = -(-K // c)
            kl = min(gemm.MAX_THREADS // rule.groups,
                     max(32 // rule.groups,
                         gemm._pow2_ceil(-(-kb // gemm.LOADS))))
            out[f"cluster{c}"] = rule._replace(
                cluster=c, kblock=kb, klanes=kl, threads=rule.groups * kl)
    else:
        for f, tag in ((0.5, "half_klanes"), (2, "double_klanes")):
            kl = int(rule.klanes * f)
            if 32 <= kl * rule.groups <= gemm.MAX_THREADS:
                out[tag] = rule._replace(klanes=kl, threads=rule.groups * kl)
        if rule.groups >= 4:     # narrower column tiles, four times as many
            g = rule.groups // 4
            kl = max(32 // g, rule.klanes)
            out["narrow_tiles"] = rule._replace(
                groups=g, klanes=kl, threads=g * kl, tiles=rule.tiles * 4)
    return out


def probe_gemm(out_dir: Path):
    import torch
    from repro_torch.kernels import _build
    from repro_torch.timing import graph_ms
    libs = build(out_dir, "gemm", GEMM_HOOKS, GEMM_BUILDS, [])
    for lib in libs.values():
        lib.gemm_forward.argtypes = ([ctypes.c_int] * 2
                                     + [ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 11
                                     + [ctypes.c_void_p])
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    report = {}
    for case, (M, K, N, act, per_fwd) in GEMM_CASES.items():
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn((M, K), generator=gen) * 0.3).to(dt).to(dev)
            w = (torch.randn((K, N), generator=gen) * 0.3).to(dt).to(dev)
            out = torch.empty((M, N), dtype=dt, device=dev)
            code = _build.dtype_code(x)
            a = {None: 0, "silu": 1, "tanh": 2}[act]
            row = {"per_forward": per_fwd}
            for pname, p in _plan_variants(M, K, N, dt).items():
                row[f"{pname}/plan"] = p._asdict()
                for bname, lib in libs.items():
                    def call(lib=lib, p=p):
                        err = lib.gemm_forward(
                            code, code, x.data_ptr(), w.data_ptr(),
                            out.data_ptr(), M, K, N, a, p.vec, p.groups,
                            p.klanes, p.cluster, p.kblock, p.tiles, 0,
                            torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"kernel_probe: gemm error "
                                               f"{err} in {pname}")
                    row[f"{pname}/{bname}_us"] = 1e3 * graph_ms(
                        call, reps=20, replays=10)
            row["torch_matmul_us"] = 1e3 * graph_ms(
                lambda: torch.matmul(x, w), reps=20, replays=10)
            row["trivial_add_us"] = 1e3 * graph_ms(
                lambda: out.add_(0), reps=20, replays=10)
            report[f"{case}/{str(dt).split('.')[-1]}"] = row
    return report


def _cg_case():
    """chip_smoke.py's need_idle_warm batch: (bp, X, U0, need)."""
    import torch
    from repro_torch.configs.cronet import get_cronet_config
    from repro_torch.fea import fea2d
    from repro_torch.kernels import cg_fused
    import chip_smoke
    cfg = get_cronet_config("medium")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    probs = chip_smoke.problems(fea2d, cfg, 3, seed=1)
    idle = fea2d.idle_problem(cfg.nelx, cfg.nely)
    bp = fea2d.stack_problems([probs[0], probs[1], idle, probs[2]],
                              device=dev)
    X = (0.2 + 0.8 * torch.rand((4, cfg.nely, cfg.nelx),
                                generator=gen)).to(dev)
    U0, _ = cg_fused.solve_b_plain(bp, X, max_iter=5)
    need = torch.tensor([True, False, True, True], device=dev)
    return bp, X, U0, need


def probe_cg_wrapper():
    """A solve_b_fused call on the need_idle_warm batch: eager, by graph
    replay, and the device kernels torch.profiler sees in it. It uses only
    the wrapper's public signature, so it also times another tree's port
    (run this file by path with that tree's src first on PYTHONPATH)."""
    import torch
    from repro_torch.kernels import cg_fused
    from repro_torch.timing import cuda_ms, graph_ms
    bp, X, U0, need = _cg_case()
    report = {}
    # the wrapper: eager, by graph replay, and what torch.profiler sees
    call = lambda: cg_fused.solve_b_fused(bp, X, U0=U0, need=need)  # noqa
    report["wrapper_ms_eager"] = cuda_ms(call, reps=10)
    report["wrapper_ms_graph"] = graph_ms(call, reps=3, replays=3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    kern_us, other_us, other_n = 0.0, 0.0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "cg_solve_kernel" in e.name:
            kern_us += e.device_time
        else:
            other_us += e.device_time
            other_n += 1
    report["profiled_per_call"] = {
        "cg_solve_kernel_us": kern_us / 5, "setup_kernels_us": other_us / 5,
        "setup_kernels": other_n / 5}
    return report


def probe_cg(out_dir: Path):
    import torch
    from repro_torch.kernels import cg_fused
    from repro_torch.timing import graph_ms
    libs = build(out_dir, "cg_fused", CG_HOOKS, CG_BUILDS, ["--fmad=false"])
    dev = torch.device("cuda")
    bp, X, U0, need = _cg_case()
    ins = [t.to(torch.float32).contiguous() for t in
           (X, bp.f, bp.free_mask, need, U0)]
    ke = cg_fused._host_ke(bp.KE)
    B, nely, nelx = X.shape
    nnode = (nelx + 1) * (nely + 1)
    pn = 1 << (nnode - 1).bit_length()
    U_out = torch.empty((B, 2 * nnode), device=dev)
    its = torch.empty((B,), dtype=torch.int32, device=dev)
    rule = cg_fused.block_threads(pn)
    report = {"iterations": CG_ITERS, "rule_threads": rule}
    for lib in libs.values():
        lib.cg_fused_solve.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
            + [ctypes.c_float] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    runs = [("full", t) for t in (128, 256, 512, 1024)]  # NPT 8 .. 1
    runs += [(name, rule) for name in libs if name not in ("full", "timed")]
    for name, threads in runs:
        lib, times = libs[name], {}
        for n_it in (0, CG_ITERS):
            def call(lib=lib, n_it=n_it, threads=threads):
                p = [t.data_ptr() for t in ins]
                err = lib.cg_fused_solve(
                    p[0], None, p[1], p[2], ctypes.cast(ke, ctypes.c_void_p),
                    p[3], p[4], U_out.data_ptr(), its.data_ptr(), B, nelx,
                    nely, pn, threads, float(bp.e_min), float(1 - bp.e_min),
                    1e-6, n_it, 0, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"kernel_probe: cg error {err}")
            times[n_it] = 1e3 * graph_ms(call, reps=5, replays=4)
        report[f"{name}/threads{threads}"] = {
            "us_at_0": times[0], f"us_at_{CG_ITERS}": times[CG_ITERS],
            "us_per_iteration": (times[CG_ITERS] - times[0]) / CG_ITERS}
    report.update(probe_cg_wrapper())
    # cycles by phase, the timed build at each block size, the slots that
    # iterate (0 and 3)
    for threads in (256, 512, 1024):
        lib = libs["timed"]
        err = lib.cg_fused_solve(
            ins[0].data_ptr(), None, ins[1].data_ptr(), ins[2].data_ptr(),
            ctypes.cast(ke, ctypes.c_void_p), ins[3].data_ptr(),
            ins[4].data_ptr(), U_out.data_ptr(), its.data_ptr(), B, nelx,
            nely, pn, threads, float(bp.e_min), float(1 - bp.e_min), 1e-6,
            CG_ITERS, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kernel_probe: cg error {err}")
        torch.cuda.synchronize()
        cyc = U_out[:, :6].double().cpu()
        n_it = its.cpu()
        report[f"cycles_per_iteration/threads{threads}"] = {
            f"slot{b}": dict(zip(CG_PHASES, (cyc[b] / max(int(n_it[b]), 1))
                                 .tolist()))
            for b in (0, 3)}
    return report


def probe_cronet(out_dir: Path):
    """cronet_fused at medium, B = 1 and 4, fp32 and bf16: us by graph
    replay of each build, and the timed build's head cycles by phase and
    conv cycles by phase (the first trunk block and the last branch block
    of slot 0)."""
    import torch
    from repro_torch.common import init_params
    from repro_torch.configs.cronet import get_cronet_config
    from repro_torch.fea import fea2d, hybrid
    from repro_torch.kernels import cronet_pipeline
    from repro_torch.timing import graph_ms
    libs = build(out_dir, "cronet_fused", CRONET_HOOKS, CRONET_BUILDS, [])
    for lib in libs.values():
        lib.cronet_fused_forward.argtypes = cronet_pipeline.ARGTYPES
    import chip_smoke
    cfg = get_cronet_config("medium")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    p32 = hybrid.cast_params(init_params(cfg, seed=0, device=dev), "fp32")
    report = {}
    for B in (1, 4):
        bp = fea2d.stack_problems(chip_smoke.problems(fea2d, cfg, B),
                                  device=dev)
        lv = fea2d.load_volume_b(bp)
        hist = torch.rand((B, cfg.hist_len, cfg.nely, cfg.nelx, 1),
                          generator=gen).to(dev)
        for dname, prec in (("float32", "fp32"), ("bfloat16", "bf16")):
            p = hybrid.cast_params(p32, prec)
            dt = getattr(torch, dname)
            args, out, keep = cronet_pipeline.launch_args(
                cfg, p, lv.to(dt), hist.to(dt))
            row = {}
            for name, lib in libs.items():
                if name == "timed":
                    continue

                def call(lib=lib):     # on the capturing stream
                    err = lib.cronet_fused_forward(
                        *args[:-1], torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"kernel_probe: cronet error "
                                           f"{err} in {name}")
                row[f"{name}_us"] = 1e3 * graph_ms(call, reps=20, replays=10)
            err = libs["timed"].cronet_fused_forward(*args)
            if err:
                raise RuntimeError(f"kernel_probe: cronet error {err}")
            torch.cuda.synchronize()
            cyc = out[:, :len(CRONET_PHASES)].double().cpu()
            row["head_cycles"] = dict(zip(CRONET_PHASES, cyc[0].tolist()))
            conv = (ctypes.c_longlong * 16)()
            fn = libs["timed"].probe_conv_cycles
            fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_void_p]
            if fn(conv):
                raise RuntimeError("kernel_probe: probe_conv_cycles failed")
            for kind, off in (("trunk", 0), ("branch", 8)):
                ends = list(conv[off:off + 6])
                row[f"conv_cycles/{kind}"] = dict(zip(
                    CONV_PHASES, [b_ - a_ for a_, b_ in zip(ends, ends[1:])]))
            report[f"B{B}/{dname}"] = row
    return report


def cronet_kernels_per_call(calls: int = 3):
    """The device kernels torch.profiler sees per ``cronet_fused`` call at
    medium, B = 1 and 4, fp32 and bf16, by kernel name. Run it in a process
    of its own (``--cronet-kernels``): once a profile has run in a process,
    each later cudaFuncSetAttribute (which some kernels' first launch
    makes) costs a later profile a kernel record, so every configuration
    is launched once before the first profile here."""
    import collections
    import re
    import torch
    from repro_torch.common import init_params
    from repro_torch.configs.cronet import get_cronet_config
    from repro_torch.fea import fea2d, hybrid
    from repro_torch.kernels import cronet_pipeline
    import chip_smoke
    cfg = get_cronet_config("medium")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    p32 = hybrid.cast_params(init_params(cfg, seed=0, device=dev), "fp32")
    lv = fea2d.load_volume_b(fea2d.stack_problems(
        chip_smoke.problems(fea2d, cfg, 4), device=dev))
    hist = torch.rand((4, cfg.hist_len, cfg.nely, cfg.nelx, 1),
                      generator=gen).to(dev)
    calls_of = {}
    for B in (1, 4):
        for dname, prec in (("float32", "fp32"), ("bfloat16", "bf16")):
            dt, p = getattr(torch, dname), hybrid.cast_params(p32, prec)
            calls_of[f"B{B}/{dname}"] = (
                lambda p=p, a=lv[:B].to(dt), h=hist[:B].to(dt):
                cronet_pipeline.cronet_fused(cfg, p, a, h))
    for fn in calls_of.values():          # every first launch, first
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    report = {}
    for key, fn in calls_of.items():
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = collections.Counter(
            (re.search(r"(\w+_kernel)", e.name) or re.search(r"(\w+)", e.name)
             ).group(1) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        report[key] = {n: c / calls for n, c in names.items()}
    return report


def probe_slstm(out_dir: Path):
    """slstm_fused at xlstm-1.3b's widths (B 8, S 4096, 4 heads of 512,
    fp32 wx, R scaled by 1/sqrt(dh)): ms by CUDA events of each build, and
    the timed build's SM cycles a step by phase."""
    import torch
    from repro_torch.kernels import slstm
    from repro_torch.timing import cuda_ms
    libs = build(out_dir, "slstm", SLSTM_HOOKS, SLSTM_BUILDS, [])
    for lib in libs.values():
        lib.slstm_forward.argtypes = slstm.ARGTYPES
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    B, S, nh, dh = 8, 4096, 4, 512
    wx = torch.randn((B, S, 4 * nh * dh), generator=gen, device=dev)
    r = torch.randn((nh, dh, 4 * dh), generator=gen, device=dev) * dh ** -0.5
    args, out, keep = slstm.launch_args(wx, r)
    report = {"shape": [B, S, nh, dh]}
    for name, lib in libs.items():
        def call(lib=lib):
            err = lib.slstm_forward(*args)
            if err:
                raise RuntimeError(f"kernel_probe: slstm error {err} in "
                                   f"{name}")
        ms = cuda_ms(call, reps=3)
        if name == "timed":
            torch.cuda.synchronize()
            report["cycles_per_step"] = dict(zip(
                SLSTM_PHASES, out.reshape(-1)[:len(SLSTM_PHASES)].tolist()))
            report["timed_ms"] = ms
        else:
            report[f"{name}_ms"] = ms
            report[f"{name}_us_per_step"] = 1e3 * ms / S
    return report


def probe_flash_simt(out_dir: Path):
    """The SIMT flash kernel at qwen2.5-32b's widths (B 1, S 1024, 40 q on
    8 kv heads, D 128, fp32), non-causal and causal: ms by CUDA events of
    each build, and the timed build's SM cycles a kv tile by phase."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.timing import cuda_ms
    libs = build(out_dir, "flash_attention", FLASH_HOOKS, FLASH_BUILDS, [])
    for lib in libs.values():
        lib.flash_attention_forward.argtypes = fa.SIMT_ARGTYPES
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    B, S, hq, hkv, d = 1, 1024, 40, 8, 128
    q = torch.randn((B, S, hq, d), generator=gen, device=dev)
    k = torch.randn((B, S, hkv, d), generator=gen, device=dev)
    v = torch.randn((B, S, hkv, d), generator=gen, device=dev)
    report = {"shape": [B, S, hq, hkv, d], "dtype": "float32"}
    for causal in (False, True):
        kernel, args, out, keep = fa.launch_args(q, k, v, causal)
        if kernel != "simt":
            raise RuntimeError("kernel_probe: the case must run the SIMT "
                               "kernel")
        row = {}
        for name, lib in libs.items():
            def call(lib=lib):
                err = lib.flash_attention_forward(*args)
                if err:
                    raise RuntimeError(f"kernel_probe: flash error {err} "
                                       f"in {name}")
            ms = cuda_ms(call, reps=5)
            if name == "timed":
                torch.cuda.synchronize()
                # the block with the most tiles writes its cycles over the
                # first values of its first row, and a mark after them
                first = out[0].reshape(S, -1)
                rows = (first[:, 5] == -12345.0).nonzero().flatten()
                vals = first[rows[0]].double().cpu()
                row["tiles_of_timed_block"] = int(vals[4])
                row["cycles_per_tile"] = dict(zip(FLASH_PHASES,
                                                  vals[:4].tolist()))
                row["timed_ms"] = ms
            else:
                row[f"{name}_ms"] = ms
        report["causal" if causal else "noncausal"] = row
    report["widths_S1024"] = probe_flash_widths()
    return report


def probe_flash_widths():
    """The flash wrapper beside F.scaled_dot_product_attention at the other
    configurations' attention widths (chip_smoke.SIMT_WIDTHS), S 1024,
    fp32 and bf16, non-causal and causal: ms by CUDA events."""
    import torch
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.timing import cuda_ms
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    report = {}
    for label, (hq, hkv, d, dv) in chip_smoke.SIMT_WIDTHS.items():
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                       for shape in ((1, 1024, hq, d), (1, 1024, hkv, d),
                                     (1, 1024, hkv, dv)))
            for causal in (False, True):
                call = (lambda: fa.flash_attention_causal_gqa(q, k, v)) \
                    if causal else \
                    (lambda: fa.flash_attention(q, k, v, causal=False))
                report[f"{label}/{str(dt).split('.')[-1]}/"
                       f"{'causal' if causal else 'noncausal'}"] = {
                    "kernel": fa.kernel_for(dt, d, dv),
                    "ms": cuda_ms(call, reps=5),
                    "sdpa_ms": cuda_ms(
                        lambda: chip_smoke.sdpa(q, k, v, causal), reps=5)}
    return report


def probe_maxpool():
    """maxpool2d at CRONet medium's branch shape (10, 20, 30, 32) and its
    trunk-sized neighbours, fp32 and bf16: us by graph replay through the
    public wrapper (so any tree's port can be timed: run this file by path
    with that tree's src first on PYTHONPATH), beside F.max_pool2d."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import pool
    from repro_torch.timing import graph_ms
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {}
    for shape in ((10, 20, 30, 32), (4, 21, 31, 64), (3, 7, 9, 8)):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device=dev).to(dt)
            xc = x.permute(0, 3, 1, 2)
            report[f"{'x'.join(map(str, shape))}/{str(dt).split('.')[-1]}"] = {
                "kernel_us": 1e3 * graph_ms(lambda: pool.maxpool2d(x, 2),
                                            reps=50, replays=10),
                "f_max_pool2d_us": 1e3 * graph_ms(
                    lambda: F.max_pool2d(xc, 2), reps=50, replays=10)}
    return report


def silu_call(lib, name: str, x, plan=None):
    """A call of ``lib``'s ``name`` kernel (a build of csrc/silu.cu) with
    the arguments the wrapper would pass for x under ``plan`` (default
    ``silu_plan``'s), on the current stream."""
    import torch
    from repro_torch.kernels import silu
    entry, args, _, keep = silu.launch_args(name, x, plan)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = silu.ARGTYPES[entry]

    def call():
        err = fn(*args[:-1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kernel_probe: silu error {err}")
    call.keep = keep        # the tensors the arguments point into
    return call


def _silu_plan_variants(plan):
    """The plans silu_plan's was chosen over: the other vectors a thread
    (1, 2 or 4) and the other block sizes (64, 128 or 256 threads), each
    over as many blocks as the vectors fill."""
    from repro_torch.kernels import silu
    out = {f"vpt{v}": plan._replace(vpt=v, blocks=max(
        1, -(-plan.nvec // (plan.threads * v)))) for v in silu.VPTS
        if v != plan.vpt}
    out.update({f"threads{t}": plan._replace(threads=t, blocks=max(
        1, -(-plan.nvec // (t * plan.vpt)))) for t in (64, 128, 256)
        if t != plan.threads})
    return out


def probe_silu(out_dir: Path):
    """silu_lut and silu_exact through their wrappers, the same kernels
    under the plans silu_plan's was chosen over, the ``empty``,
    ``ldg_table`` / ``nvcc_div`` and ``streaming`` builds of csrc/silu.cu
    launched with the wrappers' arguments, and F.silu, at chip_smoke's
    timed SiLU sizes, fp32 and bf16, on normal draws (scale 4): us by graph
    replay, and the rate in TB/s (one read and one write an element)."""
    import torch
    import torch.nn.functional as F
    import chip_smoke
    from repro_torch.kernels import _build, silu
    from repro_torch.timing import graph_ms
    libs = build(out_dir, "silu", SILU_HOOKS, SILU_BUILDS, [])
    libs["wrapper"] = _build.load("silu")
    dev = torch.device("cuda")
    sms = silu.sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {"sm_count": sms}
    for label in chip_smoke.SILU_TIMED:
        n = chip_smoke.SILU_CASES[label][0]
        reps, replays = (5, 5) if n > 1 << 22 else (50, 10)
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn((n,), generator=gen, device=dev) * 4).to(dt)
            nbytes = 2 * n * x.element_size()
            plan = silu.silu_plan(n, dt, sms, x.data_ptr() % 16)
            row = {"n": n, "plan": plan._asdict()}
            for name in ("silu_lut", "silu_exact"):
                wrapper = getattr(silu, name)
                us = {"": 1e3 * graph_ms(lambda: wrapper(x), reps=reps,
                                         replays=replays)}
                for b in ("empty", "streaming") + (
                        ("ldg_table",) if name == "silu_lut" else
                        ("nvcc_div",)):
                    us[f"_{b}"] = 1e3 * graph_ms(
                        silu_call(libs[b], name, x), reps=reps,
                        replays=replays)
                for pname, p in _silu_plan_variants(plan).items():
                    us[f"_{pname}"] = 1e3 * graph_ms(
                        silu_call(libs["wrapper"], name, x, p), reps=reps,
                        replays=replays)
                for k, t in us.items():
                    row[f"{name}{k}_us"] = t
                row[f"{name}_tb_per_s"] = nbytes / us[""] / 1e6
            row["f_silu_us"] = 1e3 * graph_ms(lambda: F.silu(x), reps=reps,
                                              replays=replays)
            row["f_silu_tb_per_s"] = nbytes / row["f_silu_us"] / 1e6
            report[f"{label}/{str(dt).split('.')[-1]}"] = row
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--build-dir", default="build/kernel_probe")
    ap.add_argument("--cg-wrapper-only", action="store_true",
                    help="only time solve_b_fused calls (any tree's port)")
    ap.add_argument("--cronet", action="store_true",
                    help="only cronet_fused, by kernel and by head phase")
    ap.add_argument("--slstm", action="store_true",
                    help="only slstm_fused, by phase of a step")
    ap.add_argument("--maxpool", action="store_true",
                    help="only maxpool2d by graph replay (any tree's port)")
    ap.add_argument("--flash-simt", action="store_true",
                    help="only the SIMT flash kernel, by phase of a tile")
    ap.add_argument("--silu", action="store_true",
                    help="only silu_lut / silu_exact beside their empty "
                         "build and F.silu (any tree's port)")
    ap.add_argument("--cronet-kernels", action="store_true",
                    help="only the device kernels of a cronet_fused call")
    args = ap.parse_args()
    import sys
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(args.build_dir)
    if args.cg_wrapper_only:
        text = json.dumps({"card": smi, "cg": probe_cg_wrapper()})
    elif args.cronet_kernels:
        text = json.dumps({"card": smi,
                           "cronet_kernels_per_call": cronet_kernels_per_call()})
    elif (args.cronet or args.slstm or args.flash_simt or args.maxpool
          or args.silu):
        rep = {"card": smi}
        if args.cronet:
            rep["cronet"] = probe_cronet(out_dir)
        if args.slstm:
            rep["slstm"] = probe_slstm(out_dir)
        if args.flash_simt:
            rep["flash_simt"] = probe_flash_simt(out_dir)
        if args.maxpool:
            rep["maxpool"] = probe_maxpool()
        if args.silu:
            rep["silu"] = probe_silu(out_dir)
        text = json.dumps(rep)
    else:
        text = json.dumps({"card": smi, "gemm": probe_gemm(out_dir),
                           "cg": probe_cg(out_dir)})
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    main()
