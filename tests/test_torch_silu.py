"""Port parity: the SiLU wrappers of repro_torch.kernels.silu against the
Pallas kernels of repro.kernels.silu in interpret mode, and the port's
Fig 7 layer breakdown against benchmarks/layer_breakdown.py, on the CPU,
where each wrapper runs its plain version.

Tolerances: fp32 within 1e-6 (both frameworks' silu differ by up to two
ulps; the LUT's table by up to 4.8e-7, its grid not at all), with the LUT's
table indices equal; bf16 within one bf16 ulp. Inputs come from numpy
seeds and include every table point and midpoint with their neighbouring
floats, and both tails.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import silu as jsilu
from repro_torch import kernels, layer_breakdown
from repro_torch.kernels import ref, silu

ROOT = Path(__file__).resolve().parents[1]


def _inputs(n=6000, seed=0):
    grid = np.asarray(jnp.linspace(-8.0, 8.0, 256), np.float32)
    mids = grid[:-1] + (grid[1:] - grid[:-1]) / 2
    ties = ((np.arange(255) + 0.5) * 16 / 255 - 8).astype(np.float32)
    pts = np.concatenate([grid, mids, ties])
    tails = np.array([-1e4, -20, -8, 8, 20, 1e4, 0], np.float32)
    tails = np.concatenate([tails, np.nextafter(tails, tails * 2)])
    special = np.concatenate([pts, np.nextafter(pts, np.float32(np.inf)),
                              np.nextafter(pts, np.float32(-np.inf)), tails])
    x = (np.random.default_rng(seed).standard_normal(n) * 4).astype(np.float32)
    x[:special.size] = special
    return x.reshape(60, n // 60)


def _pair(a, dtype):
    t = torch.from_numpy(a)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            t.bfloat16() if dtype == "bfloat16" else t)


def _close(port, ref_, dtype):
    """fp32: within 1e-6; bf16: within one bf16 ulp of the larger value."""
    got = port.float().numpy()
    want = np.asarray(ref_, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        assert port.dtype == torch.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        assert port.dtype == torch.bfloat16
        _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= np.ldexp(1.0, e - 8))


@pytest.fixture(autouse=True)
def no_launches():
    """On CPU tensors no wrapper launches, so no counter moves."""
    before = kernels.launch_counts()
    yield
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_exact_matches_pallas(dtype):
    jx, tx = _pair(_inputs(seed=1), dtype)
    _close(silu.silu_exact(tx), jsilu.silu_exact(jx, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_lut_matches_pallas(dtype):
    jx, tx = _pair(_inputs(seed=2), dtype)
    _close(silu.silu_lut(tx), jsilu.silu_lut(jx, interpret=True), dtype)
    # the same table entry is chosen for every input
    jf = jx.astype(jnp.float32)
    jidx = jnp.clip(jnp.round((jf - jsilu.LO) / (jsilu.HI - jsilu.LO)
                              * (jsilu.N_ENTRIES - 1)), 0, jsilu.N_ENTRIES - 1)
    tf = tx.float()
    tidx = torch.clamp(torch.round((tf - silu.LO) / (silu.HI - silu.LO)
                                   * (silu.N_ENTRIES - 1)),
                       0, silu.N_ENTRIES - 1)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


# NaN of both signs, the infinities and the signed zeros: XLA turns NaN
# into index 0, so both kernels (and the port's plain version) take
# table[0] = silu(-8) for it
SPECIALS = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0],
                    np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_lut_nan_matches_pallas(dtype):
    jx, tx = _pair(SPECIALS, dtype)
    out = silu.silu_lut(tx)
    want = np.asarray(jsilu.silu_lut(jx, interpret=True), np.float32)
    finite = np.isfinite(want)        # inf passes the identity tail
    _close(out[torch.from_numpy(finite)], want[finite], dtype)
    np.testing.assert_array_equal(out.float().numpy()[~finite],
                                  want[~finite])
    jf = jx.astype(jnp.float32)
    jidx = jnp.clip(jnp.round((jf - jsilu.LO) / (jsilu.HI - jsilu.LO)
                              * (jsilu.N_ENTRIES - 1)), 0,
                    jsilu.N_ENTRIES - 1).astype(jnp.int32)
    tidx = ref.silu_lut_index(tx.float(), silu.N_ENTRIES, silu.LO, silu.HI)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tidx[0] == 0 and tidx[1] == 0
    table0 = silu.make_table()[0].to(tx.dtype)
    assert out[0] == table0 and out[1] == table0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_exact_nan_matches_pallas(dtype):
    """NaN stays NaN, inf stays inf, -inf gives NaN, in both packages."""
    jx, tx = _pair(SPECIALS, dtype)
    got = silu.silu_exact(tx).float().numpy()
    want = np.asarray(jsilu.silu_exact(jx, interpret=True), np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got, want, rtol=tol, atol=1e-6,
                               equal_nan=True)


def test_silu_lut_table_matches_jax():
    """The grid is jnp.linspace's value for value; the table differs only by
    the two frameworks' silu."""
    assert (silu.N_ENTRIES, silu.LO, silu.HI) == (
        jsilu.N_ENTRIES, jsilu.LO, jsilu.HI)
    np.testing.assert_array_equal(
        ref.linspace(silu.LO, silu.HI, silu.N_ENTRIES).numpy(),
        np.asarray(jnp.linspace(jsilu.LO, jsilu.HI, jsilu.N_ENTRIES)))
    np.testing.assert_allclose(silu.make_table().numpy(),
                               np.asarray(jsilu.make_table()), rtol=0,
                               atol=1e-6)


def test_silu_wrappers_keep_shape_and_empty():
    x = torch.zeros((0, 3))
    assert silu.silu_lut(x).shape == (0, 3)
    assert silu.silu_exact(x).shape == (0, 3)
    t = torch.tensor([[-9.0, 9.0], [8.0, -8.0]])
    out = silu.silu_lut(t)
    assert out[0, 0] == 0.0 and out[0, 1] == 9.0
    assert out[1, 0] == silu.make_table()[-1] and out[1, 1] == silu.make_table()[0]


def test_layer_breakdown_rows_match_jax(monkeypatch):
    """The port's run(size="small", device="cpu") returns the JAX module's
    rows: the same names in the same order, the paper's shares on the same
    layers. JAX's timing loop is stubbed out (its kernels run in interpret
    mode); its layer inputs are still computed."""
    spec = importlib.util.spec_from_file_location(
        "jax_layer_breakdown", ROOT / "benchmarks" / "layer_breakdown.py")
    jlb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jlb)
    monkeypatch.setattr(jlb, "_time", lambda fn, reps=3: 1.0)
    jrows = jlb.run(True)
    rows = layer_breakdown.run("small", device="cpu")
    assert [r[0] for r in rows] == [r[0] for r in jrows]
    assert [("paper" in r[2]) for r in rows] == [("paper" in r[2])
                                                 for r in jrows]
    assert layer_breakdown.PAPER_SHARES == jlb.PAPER_SHARES
    assert all(np.isfinite(r[1]) and r[1] > 0 for r in rows)
