"""Port parity: repro_torch.kernels.slstm.slstm_fused against the Pallas
kernel repro.kernels.slstm.slstm_fused in interpret mode, on the CPU, where
the wrapper runs its plain version (ref.slstm_sequential).

The shapes are tests/test_kernels_extra.py::
test_slstm_fused_matches_sequential's, with its tolerance (atol 2e-5 at
fp32); inputs come from numpy seeds. The tiling keywords must not change
the result. The last test records why the card's full-width comparison
scales R by 1/sqrt(dh): at the JAX package's init scale the fp32 recurrence
is chaotic at xlstm-1.3b's widths.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.kernels import slstm as jslstm
from repro_torch import kernels
from repro_torch.configs.lm import get_lm_config
from repro_torch.kernels import ref, slstm


def _inputs(b, s, nh, dh, seed, r_scale=0.3, wx_scale=1.0):
    rng = np.random.default_rng(seed)
    wx = (rng.standard_normal((b, s, 4 * nh * dh)) * wx_scale
          ).astype(np.float32)
    r = (rng.standard_normal((nh, dh, 4 * dh)) * r_scale).astype(np.float32)
    return wx, r


@pytest.fixture(autouse=True)
def no_launches():
    before = kernels.launch_counts()
    yield
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("time_block,batch_tile", [(16, 2), (64, 1), (8, 1)])
def test_slstm_fused_matches_pallas(time_block, batch_tile):
    """Each tiling against JAX's kernel at the same tiling (atol 2e-5), and
    the port's output the same for every tiling."""
    wx, r = _inputs(2, 64, 2, 8, seed=0)
    want = jslstm.slstm_fused(jnp.asarray(wx), jnp.asarray(r),
                              time_block=time_block, batch_tile=batch_tile,
                              interpret=True)
    got = slstm.slstm_fused(torch.from_numpy(wx), torch.from_numpy(r),
                            time_block=time_block, batch_tile=batch_tile)
    assert got.dtype == torch.float32 and got.shape == (2, 64, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    default = slstm.slstm_fused(torch.from_numpy(wx), torch.from_numpy(r))
    assert torch.equal(got, default)


def test_slstm_output_in_wx_dtype():
    """bf16 wx: the state stays fp32 and only the output is rounded, in
    both packages."""
    wx, r = _inputs(2, 32, 2, 8, seed=1)
    want = jslstm.slstm_fused(jnp.asarray(wx, jnp.bfloat16), jnp.asarray(r),
                              time_block=16, batch_tile=2, interpret=True)
    got = slstm.slstm_fused(torch.from_numpy(wx).bfloat16(),
                            torch.from_numpy(r), time_block=16, batch_tile=2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-2)


def test_slstm_rejects_what_jax_rejects():
    wx, r = _inputs(3, 64, 2, 8, seed=2)
    with pytest.raises(AssertionError):
        jslstm.slstm_fused(jnp.asarray(wx), jnp.asarray(r), time_block=16,
                           batch_tile=2, interpret=True)
    with pytest.raises(ValueError, match="do not divide"):
        slstm.slstm_fused(torch.from_numpy(wx), torch.from_numpy(r),
                          time_block=16, batch_tile=2)
    with pytest.raises(ValueError, match="does not match"):
        slstm.slstm_fused(torch.from_numpy(wx[..., :-4]), torch.from_numpy(r))


def _sequential_fp64(wx, r):
    """The recurrence in float64 (numpy), as the JAX test writes it."""
    b, s, _ = wx.shape
    nh, dh, _ = r.shape
    d = nh * dh
    h, c, n, m = (np.zeros((b, d)) for _ in range(4))
    out = []
    for t in range(s):
        rh = np.einsum("bhk,hkj->bhj", h.reshape(b, nh, dh), r)
        rh = rh.reshape(b, nh, 4, dh).transpose(0, 2, 1, 3).reshape(b, 4 * d)
        pre = wx[:, t] + rh
        z, i_pre = np.tanh(pre[:, :d]), pre[:, d:2 * d]
        f_pre = pre[:, 2 * d:3 * d]
        log_f = np.minimum(f_pre, 0) - np.log1p(np.exp(-np.abs(f_pre)))
        o = 1 / (1 + np.exp(-pre[:, 3 * d:]))
        m_new = np.maximum(log_f + m, i_pre)
        i_g, f_g = np.exp(i_pre - m_new), np.exp(log_f + m - m_new)
        c, n = f_g * c + i_g * z, f_g * n + i_g
        h = o * c / np.maximum(np.abs(n), 1.0)
        m = m_new
        out.append(h)
    return np.stack(out, 1)


def test_slstm_sequential_float64_matches_numpy():
    """float64 wx keeps R and the state in float64: the plain version then
    equals the numpy float64 recurrence, and the card's check at the JAX
    package's init scale may use it as its float64 reference."""
    wx, r = _inputs(3, 24, 2, 12, seed=5, r_scale=0.5, wx_scale=2.0)
    wx, r = wx.astype(np.float64), r.astype(np.float64)
    got = ref.slstm_sequential(torch.from_numpy(wx), torch.from_numpy(r))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _sequential_fp64(wx, r),
                               rtol=0, atol=1e-12)


def test_slstm_conditioning_at_full_width():
    """xlstm-1.3b's sLSTM widths (4 heads of 512), one sequence of 256
    steps, fp32 plain version against float64. With R scaled by 1/sqrt(dh)
    (the fan-in of the recurrent product) the two stay within 1e-5; with
    R at the JAX package's init scale for this stack (std 1/sqrt(6), the
    fan-in rule applied to the stacked-layer axis of r_zifo) they part by
    more than 1e-2 within 64 steps, so no fp32 implementation can be held to
    another at 1e-4 there."""
    cfg = get_lm_config("xlstm-1.3b")
    nh, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    wx, r = _inputs(1, 256, nh, dh, seed=3, r_scale=dh ** -0.5)
    got = ref.slstm_sequential(torch.from_numpy(wx), torch.from_numpy(r))
    assert np.abs(got.numpy() - _sequential_fp64(wx.astype(np.float64),
                                                 r.astype(np.float64))
                  ).max() < 1e-5
    wx, r = _inputs(1, 64, nh, dh, seed=3, r_scale=6 ** -0.5)
    got = ref.slstm_sequential(torch.from_numpy(wx), torch.from_numpy(r))
    assert np.abs(got.numpy() - _sequential_fp64(wx.astype(np.float64),
                                                 r.astype(np.float64))
                  ).max() > 1e-2


def test_xlstm_widths_match_reference_config():
    mine, theirs = get_lm_config("xlstm-1.3b"), get_config("xlstm-1.3b")
    assert (mine.d_model, mine.num_heads, mine.num_kv_heads, mine.head_dim,
            mine.dtype) == (theirs.d_model, theirs.num_heads,
                            theirs.num_kv_heads, theirs.hd, theirs.dtype)
    assert theirs.num_layers // theirs.slstm_every == 6   # sLSTM layers
