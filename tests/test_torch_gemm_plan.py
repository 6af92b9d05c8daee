"""The launch plan of the cluster split-K GEMV kernel (csrc/gemm.cu), on
the CPU, where no kernel can run.

  * ``gemm.gemm_plan`` covers every (k, n) of the weight exactly once, with
    at most 8 blocks a cluster, full warps and no half-empty column tile, at
    the fusion path's shapes and at edge shapes. The enumeration below
    repeats the kernel's index arithmetic (gemm_kernel: g = tid % groups,
    q = tid / groups, rank = blockIdx.x % cluster, rows k0 + q + i * klanes
    in chunks of LOADS).
  * An emulation of the kernel's arithmetic in that plan (each thread's FMA
    chain, the shuffle tree, warps in order, ranks in order, the epilogue)
    agrees with ``gemm_plain`` within the fusion tolerances, and plans that
    drop or repeat a k are shown to fail the cover test.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gemm

F32, BF16 = torch.float32, torch.bfloat16
# (M, K, N, activation): the fusion path's GEMMs (core/fusion.py)
FUSION_SHAPES = {
    "trunk_fc1": (1, 4800, 40, "silu"),
    "fc2": (1, 40, 2560, None),
    "rnn_wx": (1, 32, 64, None),
    "rnn_wh": (1, 64, 64, None),
    "branch_fc1": (1, 64, 40, "silu"),
    "odd_33x70x9": (33, 70, 9, "tanh"),
}
EDGE_SHAPES = {"k1": (1, 1, 40), "n1": (1, 300, 1), "k1_n1": (1, 1, 1),
               "k0": (2, 0, 8), "k7_n13": (3, 7, 13), "k4801_n42": (1, 4801, 42),
               "k9_n6": (1, 9, 6), "k70000_n8": (1, 70000, 8),
               "n2562": (1, 33, 2562)}
DTYPE_PAIRS = {"f32": (F32, F32), "bf16": (BF16, BF16), "x32_w16": (F32, BF16),
               "x16_w32": (BF16, F32)}


def loads(plan, K, N):
    """How often the kernel loads each weight (k, n) under ``plan``."""
    count = np.zeros((K, N), np.int64)
    for tile in range(plan.tiles):
        for rank in range(plan.cluster):
            k0 = rank * plan.kblock
            k1 = min(K, k0 + plan.kblock)
            for tid in range(plan.threads):
                g, q = tid % plan.groups, tid // plan.groups
                n0 = (tile * plan.groups + g) * plan.vec
                if n0 >= N:
                    continue
                assert n0 + plan.vec <= N, "a vector straddles N"
                for kc in range(k0 + q, k1, plan.klanes * gemm.LOADS):
                    for i in range(gemm.LOADS):
                        k = kc + i * plan.klanes
                        if k < k1:
                            count[k, n0:n0 + plan.vec] += 1
    return count


def check_plan(plan, M, K, N, w_dtype):
    assert 1 <= plan.cluster <= gemm.MAX_CLUSTER
    assert plan.cluster * plan.kblock >= K
    assert K == 0 or (plan.cluster - 1) * plan.kblock < K, "an empty rank"
    assert plan.threads == plan.groups * plan.klanes
    assert plan.threads % 32 == 0 and plan.threads <= gemm.MAX_THREADS
    assert 32 % plan.groups == 0 and plan.groups <= gemm.MAX_GROUPS
    width = 16 // torch.empty((), dtype=w_dtype).element_size()
    assert plan.vec in (1, width)
    if plan.vec > 1:
        assert N % plan.vec == 0
    # no half-empty tile: every tile's columns are all below N
    assert plan.tiles * plan.groups * plan.vec == -(-N // plan.vec) * plan.vec
    assert plan.rows == min(M, 65535)
    np.testing.assert_array_equal(loads(plan, K, N), 1)


@pytest.mark.parametrize("dtypes", list(DTYPE_PAIRS))
@pytest.mark.parametrize("shape", list(FUSION_SHAPES) + list(EDGE_SHAPES))
def test_gemm_plan_covers_every_weight_once(shape, dtypes):
    M, K, N = (FUSION_SHAPES.get(shape) or EDGE_SHAPES[shape])[:3]
    x_dt, w_dt = DTYPE_PAIRS[dtypes]
    plan = gemm.gemm_plan(M, K, N, x_dt, w_dt)
    check_plan(plan, M, K, N, w_dt)
    # an unaligned weight pointer takes one column a vector
    check_plan(gemm.gemm_plan(M, K, N, x_dt, w_dt, w_aligned=False),
               M, K, N, w_dt)


def test_gemm_plan_at_the_fusion_shapes():
    """trunk fc1 splits K over a full cluster; N = 40 and N = 64 fill every
    tile; the short-K calls are one block a tile."""
    p = gemm.gemm_plan(1, 4800, 40, F32, F32)
    assert (p.vec, p.groups, p.cluster, p.tiles) == (4, 2, 8, 5)
    p = gemm.gemm_plan(1, 4800, 40, BF16, BF16)
    assert (p.vec, p.groups, p.cluster, p.tiles) == (8, 1, 8, 5)
    for K, N in ((32, 64), (64, 64), (64, 40), (40, 2560)):
        p = gemm.gemm_plan(1, K, N, F32, F32)
        assert p.cluster == 1 and p.vec == 4
        assert N % (p.groups * p.vec) == 0


def test_gemm_plan_rejects_other_dtypes():
    with pytest.raises(TypeError):
        gemm.gemm_plan(1, 8, 8, torch.float16, F32)


@pytest.mark.parametrize("fault", ["short_kblock", "half_klanes"])
def test_cover_check_fails_a_wrong_plan(fault):
    """The cover test is not vacuous: ranks one k short leave the last k
    unread, and k lanes of half the stride read rows twice."""
    plan = gemm.gemm_plan(1, 4800, 40, F32, F32)
    bad = (plan._replace(kblock=plan.kblock - 1) if fault == "short_kblock"
           else plan._replace(klanes=plan.klanes // 2))
    with pytest.raises(AssertionError):
        np.testing.assert_array_equal(loads(bad, 4800, 40), 1)


def _fma(a, b, c):
    # fp32 fma: the product is exact in float64, one rounding of the sum
    # (a double rounding may differ from fmaf by an ulp, inside the bar)
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate(x, w, plan, act):
    """The kernel's result in fp32, in its order of operations."""
    M, K = x.shape
    N = w.shape[1]
    out = np.zeros((M, N), np.float32)
    lanes = np.arange(32)
    for m in range(M):
        for tile in range(plan.tiles):
            cols = plan.groups * plan.vec
            ncol = np.arange(cols) + tile * cols
            rank_sums = []
            for rank in range(plan.cluster):
                k0 = rank * plan.kblock
                k1 = min(K, k0 + plan.kblock)
                acc = np.zeros((plan.threads, plan.vec), np.float32)
                tid = np.arange(plan.threads)
                g, q = tid % plan.groups, tid // plan.groups
                n0 = (tile * plan.groups + g) * plan.vec
                for j in range(-(-max(plan.kblock, 1) // plan.klanes)):
                    k = k0 + q + j * plan.klanes
                    ok = (k < k1) & (n0 < N)
                    kk = np.where(ok, k, 0)
                    xv = np.where(ok, x[m, kk], 0).astype(np.float32)
                    wv = np.stack([np.where(ok, w[kk, np.minimum(n0 + v, N - 1)],
                                            0) for v in range(plan.vec)], 1)
                    acc = _fma(xv[:, None], wv.astype(np.float32), acc)
                acc = acc.reshape(-1, 32, plan.vec)     # warps, lanes
                off = 16
                while off >= plan.groups:
                    src = np.where(lanes + off < 32, lanes + off, lanes)
                    acc = acc + acc[:, src]
                    off //= 2
                part = acc[:, :plan.groups].reshape(acc.shape[0], cols)
                s = part[0].copy()
                for i in range(1, part.shape[0]):
                    s = s + part[i]
                rank_sums.append(s)
            s = rank_sums[0]
            for r in rank_sums[1:]:
                s = s + r
            keep = ncol < N
            out[m, ncol[keep]] = s[keep]
    t = torch.from_numpy(out)
    if act == "silu":
        t = t / (1 + torch.exp(-t))
    elif act == "tanh":
        t = torch.tanh(t)
    return t


@pytest.mark.parametrize("shape", list(FUSION_SHAPES))
def test_gemm_kernel_arithmetic_matches_plain(shape):
    """The emulated kernel vs gemm_plain, fp32: rtol 2e-5 / atol 2e-4, the
    tolerance chip_smoke.py holds the kernel to (another summation order,
    fp32 accumulation)."""
    M, K, N, act = FUSION_SHAPES[shape]
    rng = np.random.default_rng(K * 100 + N)
    x = (rng.standard_normal((M, K)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.3).astype(np.float32)
    plan = gemm.gemm_plan(M, K, N, F32, F32)
    got = emulate(x, w, plan, act)
    want = gemm.gemm_plain(torch.from_numpy(x), torch.from_numpy(w), act)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-4)
