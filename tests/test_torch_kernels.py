"""Port parity: the per-op kernel wrappers of repro_torch.kernels (conv,
gemm, pool) against the Pallas kernels of repro.kernels in interpret mode,
on the CPU, where each wrapper runs its plain version.

The cases mirror tests/test_kernels.py, with its tolerances: rtol 2e-5 /
atol 2e-4 at fp32, rtol 2e-2 / atol 2e-1 at bf16. Inputs come from numpy
seeds and reach both packages as the same values (bf16 by round to nearest
even on both sides). No call here may move a launch counter.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cronet import _adaptive_bounds as j_adaptive_bounds
from repro.kernels import conv as jconv
from repro.kernels import gemm as jgemm
from repro.kernels import pool as jpool
from repro_torch import kernels
from repro_torch.kernels import conv, gemm, pool

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor in ``dtype``."""
    t = torch.from_numpy(a)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            t.bfloat16() if dtype == "bfloat16" else t)


def _close(port, ref, dtype):
    assert port.dtype == (torch.bfloat16 if dtype == "bfloat16"
                          else torch.float32)
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype] * 10)


@pytest.fixture(autouse=True)
def no_launches():
    """On CPU tensors no wrapper launches, so no counter moves."""
    before = kernels.launch_counts()
    yield
    assert kernels.launch_counts() == before


# ---------------------------------------------------------------- GEMM
@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (33, 70, 9), (1, 4800, 40),
                                   (40, 40, 2560)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", [None, "silu", "tanh"])
def test_gemm_matches_pallas(m, k, n, dtype, act):
    rng = np.random.default_rng(m * 1000 + k)
    jx, tx = _pair((rng.standard_normal((m, k)) * 0.3).astype(np.float32),
                   dtype)
    jw, tw = _pair((rng.standard_normal((k, n)) * 0.3).astype(np.float32),
                   dtype)
    ref = jgemm.gemm(jx, jw, activation=act, interpret=True)
    _close(gemm.gemm(tx, tw, activation=act), ref, dtype)


@pytest.mark.parametrize("op", ["gemm", "conv2d"])
@pytest.mark.parametrize("x_dtype,w_dtype", [("bfloat16", "float32"),
                                             ("float32", "bfloat16")])
def test_mixed_dtypes_compute_in_fp32(op, x_dtype, w_dtype):
    """An fp32 and a bf16 operand: both read as fp32, output in x's dtype,
    as the Pallas kernels cast both operands."""
    rng = np.random.default_rng(5)
    shapes = {"gemm": ((3, 50), (50, 7)), "conv2d": ((2, 6, 7, 3),
                                                     (3, 3, 3, 4))}[op]
    jx, tx = _pair((rng.standard_normal(shapes[0]) * 0.3
                    ).astype(np.float32), x_dtype)
    jw, tw = _pair((rng.standard_normal(shapes[1]) * 0.3
                    ).astype(np.float32), w_dtype)
    if op == "gemm":
        ref = jgemm.gemm(jx, jw, activation="silu", interpret=True)
        out = gemm.gemm(tx, tw, activation="silu")
    else:
        ref = jconv.conv2d(jx, jw, fuse_silu=True, interpret=True)
        out = conv.conv2d(tx, tw, fuse_silu=True)
    _close(out, ref, x_dtype)


# ---------------------------------------------------------------- Conv
@pytest.mark.parametrize("b,h,w,cin,cout", [(1, 10, 30, 1, 16),
                                            (10, 20, 30, 16, 32),
                                            (2, 7, 9, 3, 5)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fuse_silu", [False, True])
def test_conv2d_matches_pallas(b, h, w, cin, cout, dtype, fuse_silu):
    rng = np.random.default_rng(0)
    jx, tx = _pair((rng.standard_normal((b, h, w, cin)) * 0.5
                    ).astype(np.float32), dtype)
    jw, tw = _pair((rng.standard_normal((3, 3, cin, cout)) * 0.3
                    ).astype(np.float32), dtype)
    ref = jconv.conv2d(jx, jw, fuse_silu=fuse_silu, interpret=True)
    _close(conv.conv2d(tx, tw, fuse_silu=fuse_silu), ref, dtype)


@pytest.mark.parametrize("kd,depth_padding", [(2, "causal_same"),
                                              (1, "same")])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fuse_silu", [False, True])
def test_conv3d_matches_pallas(kd, depth_padding, dtype, fuse_silu):
    rng = np.random.default_rng(1)
    jx, tx = _pair((rng.standard_normal((2, 4, 11, 21, 3)) * 0.5
                    ).astype(np.float32), dtype)
    jw, tw = _pair((rng.standard_normal((kd, 3, 3, 3, 8)) * 0.3
                    ).astype(np.float32), dtype)
    ref = jconv.conv3d(jx, jw, depth_padding=depth_padding,
                       fuse_silu=fuse_silu, interpret=True)
    _close(conv.conv3d(tx, tw, depth_padding=depth_padding,
                       fuse_silu=fuse_silu), ref, dtype)


@pytest.mark.parametrize("call", [
    lambda: conv.conv2d(torch.zeros(1, 5, 5, 2), torch.zeros(2, 2, 2, 3)),
    lambda: conv.conv2d(torch.zeros(1, 5, 5, 2), torch.zeros(3, 3, 4, 3)),
    lambda: conv.conv3d(torch.zeros(1, 4, 5, 5, 1),
                        torch.zeros(2, 3, 3, 1, 3), depth_padding="same"),
    lambda: conv.conv3d(torch.zeros(1, 4, 5, 5, 1),
                        torch.zeros(2, 3, 3, 1, 3), depth_padding="valid"),
    lambda: gemm.gemm(torch.zeros(2, 3), torch.zeros(4, 5)),
    lambda: gemm.gemm(torch.zeros(2, 3), torch.zeros(3, 5),
                      activation="relu"),
    lambda: pool.maxpool2d(torch.zeros(1, 4, 4), 2),
    lambda: pool.adaptive_avg_pool2d(torch.zeros(1, 4, 4, 2), (0, 1)),
    lambda: conv.conv2d(torch.zeros(1, 5, 5, 2, device="meta"),
                        torch.zeros(3, 3, 2, 3, device="meta")),
    lambda: gemm.gemm(torch.zeros(2, 3, device="meta"),
                      torch.zeros(3, 5, device="meta")),
    lambda: pool.maxpool2d(torch.zeros(1, 4, 4, 2, device="meta")),
    lambda: pool.adaptive_avg_pool3d(
        torch.zeros(1, 4, 4, 4, 2, device="meta"), (2, 2, 2)),
], ids=["even-kernel", "cin-mismatch", "same-needs-kd1", "bad-padding",
        "gemm-shapes", "gemm-activation", "pool-rank", "aap-zero-out",
        "conv-meta", "gemm-meta", "maxpool-meta", "aap-meta"])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    """Shapes the kernels do not compute raise on every device, and a
    tensor on neither the CPU nor a CUDA device raises (no plain run)."""
    with pytest.raises(ValueError):
        call()


# ---------------------------------------------------------------- Pools
@pytest.mark.parametrize("h,w", [(20, 30), (10, 15), (7, 9)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_maxpool2d_matches_pallas(h, w, dtype):
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.standard_normal((3, h, w, 8)).astype(np.float32),
                   dtype)
    out = pool.maxpool2d(tx)
    assert out.shape == (3, h // 2, w // 2, 8)
    ref = jpool.maxpool2d(jx, interpret=True)
    # a max is exact: the same element in both
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("hw,out", [((10, 15), (1, 1)), ((21, 31), (5, 5)),
                                    ((7, 9), (3, 4))])
@pytest.mark.parametrize("dtype", DTYPES)
def test_aap2d_matches_pallas(hw, out, dtype):
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng.standard_normal((2, *hw, 6)).astype(np.float32),
                   dtype)
    ref = jpool.adaptive_avg_pool2d(jx, out, interpret=True)
    _close(pool.adaptive_avg_pool2d(tx, out), ref, dtype)


@pytest.mark.parametrize("c", [32, 40], ids=["branch", "ragged_c40"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_aap2d_branch_shape_matches_pallas(c, dtype):
    """CRONet medium's branch pool, (10, 10, 15, 32) -> (1, 1), and the same
    windows at 40 channels (the card's kernel reduces 32-channel tiles, the
    second one ragged)."""
    rng = np.random.default_rng(c)
    jx, tx = _pair(rng.standard_normal((10, 10, 15, c)).astype(np.float32),
                   dtype)
    ref = jpool.adaptive_avg_pool2d(jx, (1, 1), interpret=True)
    _close(pool.adaptive_avg_pool2d(tx, (1, 1)), ref, dtype)


@pytest.mark.parametrize("dhw,out", [((4, 21, 31), (3, 5, 5)),
                                     ((5, 8, 9), (2, 3, 3))])
@pytest.mark.parametrize("dtype", DTYPES)
def test_aap3d_matches_pallas(dhw, out, dtype):
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng.standard_normal((2, *dhw, 6)).astype(np.float32),
                   dtype)
    ref = jpool.adaptive_avg_pool3d(jx, out, interpret=True)
    _close(pool.adaptive_avg_pool3d(tx, out), ref, dtype)


@pytest.mark.parametrize("n_in,n_out", [(4, 3), (21, 5), (31, 5), (15, 1),
                                        (9, 4), (3, 7)])
def test_adaptive_windows_are_the_reference_windows(n_in, n_out):
    """The port's bounds are the reference's, and the plain pool averages
    exactly those windows (overlapping ones included: 4 -> 3 is [0,2),
    [1,3), [2,4))."""
    starts, ends = pool.adaptive_bounds(n_in, n_out)
    assert (starts, ends) == tuple(j_adaptive_bounds(n_in, n_out))
    x = torch.from_numpy(np.random.default_rng(n_in).standard_normal(
        (1, n_in, 3, 2)).astype(np.float32))
    out = pool.adaptive_avg_pool2d(x, (n_out, 1))
    want = torch.stack([x[:, s:e].mean(dim=(1, 2))
                        for s, e in zip(starts, ends)], dim=1)
    torch.testing.assert_close(out[:, :, 0], want, rtol=1e-6, atol=1e-6)
