"""Plain PyTorch versions of the per-op kernels' functions: the port's
counterpart of ``repro/kernels/ref.py``.

They keep the JAX package's layouts — channels-last activations, HWIO /
DHWIO convolution weights, (K, N) GEMM weights — and are written with
``torch.nn.functional``. The convolutions and pools compute in the inputs'
dtype, as the JAX oracles do; ``core.cronet.forward`` is built from them.
``gemm`` accumulates in fp32 and rounds to x's dtype, as its JAX oracle
does. Each kernel module wraps these into the plain version of its kernel
(fp32 accumulation, one rounding to x's dtype at the end).

The LM-side oracles: ``silu_exact`` and ``silu_lut`` (the JAX oracles of
``repro/kernels/ref.py``), ``slstm_sequential`` (the zero-state recurrence
of ``repro/models/recurrent.py::apply_slstm_block`` as a loop over time),
and ``attention``, re-exported from ``models.layers`` as the flash
kernel's plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import attention  # noqa: F401  (re-exported)


def conv2d_same(x, w):
    """x: (B, H, W, Cin); w: (kh, kw, Cin, Cout); SAME padding, no bias."""
    kh, kw = w.shape[:2]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1)


def conv3d(x, w, depth_padding: str):
    """x: (B, D, H, W, Cin); w: (kd, kh, kw, Cin, Cout). Spatial SAME;
    'causal_same' pads depth (0, kd-1), so output depth equals input depth
    (repro/core/cronet.py:65-79)."""
    kd, kh, kw = w.shape[:3]
    pad_d = kd - 1 if depth_padding == "causal_same" else 0
    xc = x.permute(0, 4, 1, 2, 3)                       # NCDHW
    xc = F.pad(xc, (kw // 2, kw // 2, kh // 2, kh // 2, 0, pad_d))
    y = F.conv3d(xc, w.permute(4, 3, 0, 1, 2))          # OIDHW
    return y.permute(0, 2, 3, 4, 1)


def maxpool2d(x, k: int = 2):
    """x: (B, H, W, C) -> (B, H//k, W//k, C); floor windows (edge dropped)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


def adaptive_avg_pool2d(x, out_hw: Tuple[int, int]):
    """x: (B, H, W, C) -> (B, oh, ow, C), PyTorch-style irregular windows."""
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2),
                                 out_hw).permute(0, 2, 3, 1)


def adaptive_avg_pool3d(x, out_dhw: Tuple[int, int, int]):
    """x: (B, D, H, W, C) -> (B, od, oh, ow, C)."""
    return F.adaptive_avg_pool3d(x.permute(0, 4, 1, 2, 3),
                                 out_dhw).permute(0, 2, 3, 4, 1)


def gemm(x, w, activation: Optional[str] = None):
    """x: (M, K) @ w: (K, N), fp32 accumulation, optional "silu" / "tanh"
    activation, output in x's dtype."""
    out = x.float() @ w.float()
    if activation == "silu":
        out = F.silu(out)
    elif activation == "tanh":
        out = torch.tanh(out)
    return out.to(x.dtype)


def silu_exact(x):
    """silu(x) in fp32, rounded to x's dtype."""
    return F.silu(x.float()).to(x.dtype)


def linspace(lo: float, hi: float, n: int, device=None):
    """``jnp.linspace(lo, hi, n)`` in fp32, value for value: XLA computes
    it as ``lo * (1 - i * r) + i * (hi * r)`` with ``r = fp32(1 / (n - 1))``
    and the last product fused into the add; ``torch.linspace`` rounds
    differently in most entries. The fused add is done in fp64, where
    ``i * (hi * r)`` and the sum are exact, then rounded once."""
    i = torch.arange(n - 1, dtype=torch.float32, device=device)
    r = torch.tensor(1.0 / (n - 1), dtype=torch.float32)   # a CPU scalar
    a = lo * (1.0 - i * r)
    grid = (a.double() + i.double() * (hi * r).double()).float()
    return torch.cat([grid, torch.full((1,), hi, dtype=torch.float32,
                                       device=device)])


def silu_lut_index(xf, n_entries: int = 256, lo: float = -8.0,
                   hi: float = 8.0):
    """The table entry ``silu_lut`` takes for each fp32 value: the index
    (x - lo) / (hi - lo) * (n_entries - 1) rounded half to even and
    clamped to [0, n_entries - 1]. NaN takes entry 0, as XLA's
    float-to-int conversion (and the CUDA kernel's clamp) gives it."""
    idx = torch.nan_to_num(torch.round((xf - lo) / (hi - lo)
                                       * (n_entries - 1)), nan=0.0)
    return torch.clamp(idx, 0, n_entries - 1).long()


def silu_lut(x, n_entries: int = 256, lo: float = -8.0, hi: float = 8.0):
    """Nearest-entry lookup in an ``n_entries`` table of silu over
    [lo, hi]; identity above ``hi``, zero below ``lo``. fp32 arithmetic,
    output in x's dtype (NaN takes entry 0: ``silu_lut_index``)."""
    table = F.silu(linspace(lo, hi, n_entries, device=x.device))
    xf = x.float()
    val = table[silu_lut_index(xf, n_entries, lo, hi)]
    val = torch.where(xf > hi, xf, val)
    val = torch.where(xf < lo, torch.zeros_like(val), val)
    return val.to(x.dtype)


def slstm_sequential(wx, r_zifo):
    """The sLSTM recurrence from a zero state (h, c, n, m all 0), one time
    step at a time. wx: (B, S, 4d) input projections in [z|i|f|o] layout;
    r_zifo: (nh, dh, 4dh) block-diagonal recurrent weights. R and the state
    are fp32 (float64 for float64 wx). Returns h (B, S, d) in wx's dtype."""
    b, s, _ = wx.shape
    nh, dh, _ = r_zifo.shape
    d = nh * dh
    acc = torch.float64 if wx.dtype == torch.float64 else torch.float32
    r = r_zifo.to(acc)
    h = torch.zeros((b, d), dtype=acc, device=wx.device)
    c, n, m = torch.zeros_like(h), torch.zeros_like(h), torch.zeros_like(h)
    out = torch.empty((b, s, d), dtype=wx.dtype, device=wx.device)
    for t in range(s):
        rh = torch.einsum("bhk,hkj->bhj", h.reshape(b, nh, dh), r)
        # per-head gate groups -> the global [z|i|f|o] layout of wx
        rh = rh.reshape(b, nh, 4, dh).transpose(1, 2).reshape(b, 4 * d)
        pre = wx[:, t].to(acc) + rh
        z, i_pre, f_pre, o = pre.split(d, dim=-1)
        z = torch.tanh(z)
        o = torch.sigmoid(o)
        log_f = F.logsigmoid(f_pre)
        m_new = torch.maximum(log_f + m, i_pre)
        i_g = torch.exp(i_pre - m_new)
        f_g = torch.exp(log_f + m - m_new)
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        h = o * c / torch.clamp(n.abs(), min=1.0)
        m = m_new
        out[:, t] = h.to(wx.dtype)
    return out
