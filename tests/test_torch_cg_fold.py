"""The reduction order of the CG kernel (csrc/cg_fused.cu, ``fold``), on
the CPU, where no kernel can run.

The kernel's sums must be bitwise those of ``fea2d.tree_sum`` (zero-pad to a
power of two, fold halves), or the kernel would part from the plain loop
``solve_b_plain`` it is held to bit for bit on the card. ``kernel_fold``
below repeats the kernel's steps in float32 numpy: node n = r * T + w * 32
+ l of thread (w, l) at register r; the registers fold in halves inside the
thread, then the warps (one warp per dof parity c), then the lanes as
``__shfl_down_sync`` does, and last (c = 0) + (c = 1). It equals
``tree_sum`` on random vectors at the dof counts of the 12x4, 30x10, 30x20
and 60x20 meshes, at the kernel's thread count; stand-ins that fold in
another order fail the same test.
"""
import numpy as np
import pytest
import torch

from repro_torch.fea import fea2d
from repro_torch.kernels import cg_fused

MESHES = {"12x4": (12, 4), "30x10": (30, 10), "30x20": (30, 20),
          "60x20": (60, 20), "2x1": (2, 1), "7x7": (7, 7)}


def kernel_threads(pn: int) -> int:
    """The wrapper's block size, kernels.cg_fused.block_threads."""
    return cg_fused.block_threads(pn)


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def kernel_fold(values: np.ndarray, threads: int, order: str = "kernel"):
    """Sum the float32 dof values as the kernel's fold does. ``order``
    other than "kernel" is a stand-in that folds in another order."""
    v = np.asarray(values, np.float32)
    nnode = v.size // 2
    pn = _pow2(nnode)
    npt = max(1, pn // threads)
    held = min(threads, pn)
    nw, nl = (held // 32, 32) if held >= 32 else (1, pn)
    if order == "parity_first":     # x + y of each node, then the nodes
        v = np.stack([v[0::2] + v[1::2], np.zeros(nnode, np.float32)], 1)
        v = v.reshape(-1)
    sums = []
    for c in (0, 1):
        x = np.zeros(npt * threads, np.float32)
        x[:nnode] = v[c::2]
        if order == "node_major":   # thread t owns nodes t*NPT .. +NPT-1
            regs = x.reshape(threads, npt).T
        else:
            regs = x.reshape(npt, threads)      # regs[r, tid]
        while regs.shape[0] > 1:                # inside each thread
            h = regs.shape[0] // 2
            regs = regs[:h] + regs[h:]
        a = regs[0][:nw * nl].reshape(nw, nl)   # a[w, l]
        if order == "lanes_first":              # shuffles before warps
            a = a.T
        while a.shape[0] > 1:                   # warp levels
            h = a.shape[0] // 2
            a = a[:h] + a[h:]
        x = np.zeros(32, np.float32)
        x[:a.shape[1]] = a[0]
        h = 16
        while h >= 1:                           # lane levels
            if 2 * h <= nl:
                x = x + np.concatenate([x[h:], x[-h:]])  # x[l] + x[l + h]
            h //= 2
        sums.append(x[0])
    return np.float32(sums[0] + sums[1])


def _vectors(ndof, n, seed):
    """Random float32 vectors with magnitudes over six decades, so that
    another summation order rounds differently."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-3, 3, size=(n, ndof))
    return (rng.standard_normal((n, ndof)) * mag).astype(np.float32)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_kernel_fold_equals_tree_sum_bitwise(mesh):
    nelx, nely = MESHES[mesh]
    nnode = (nelx + 1) * (nely + 1)
    threads = kernel_threads(_pow2(nnode))
    vecs = _vectors(2 * nnode, 64, seed=nnode)
    want = fea2d.tree_sum(torch.from_numpy(vecs)).numpy()
    got = np.array([kernel_fold(v, threads) for v in vecs], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# node_major differs only where a thread owns two nodes: 60x20
@pytest.mark.parametrize("mesh,order", [
    ("30x20", "parity_first"), ("30x20", "lanes_first"),
    ("60x20", "parity_first"), ("60x20", "lanes_first"),
    ("60x20", "node_major")])
def test_fold_in_another_order_fails(mesh, order):
    """Each stand-in differs from tree_sum on some vector, so the bitwise
    test above can tell a wrong fold from the kernel's."""
    nelx, nely = MESHES[mesh]
    nnode = (nelx + 1) * (nely + 1)
    threads = kernel_threads(_pow2(nnode))
    vecs = _vectors(2 * nnode, 64, seed=7)
    want = fea2d.tree_sum(torch.from_numpy(vecs)).numpy()
    got = np.array([kernel_fold(v, threads, order) for v in vecs],
                   np.float32)
    assert not np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_block_plan_fits_the_kernel(mesh):
    """The block size the wrapper passes is one the kernel takes: a power of
    two from 32 to 1024 threads, at most 8 nodes a thread and at most 2048
    nodes a block (the kernel's launch bound); 30x20 and 60x20 give every
    thread four nodes."""
    nelx, nely = MESHES[mesh]
    pn = _pow2((nelx + 1) * (nely + 1))
    t = kernel_threads(pn)
    npt = max(1, pn // t)
    assert 32 <= t <= 1024 and t & (t - 1) == 0
    assert npt in (1, 2, 4, 8) and npt * t <= cg_fused.MAX_NODES
    if mesh in ("30x20", "60x20"):
        assert npt == 4
