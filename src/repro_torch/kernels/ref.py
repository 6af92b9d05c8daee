"""Plain PyTorch versions of the per-op kernels' functions: the port's
counterpart of ``repro/kernels/ref.py``.

They keep the JAX package's layouts — channels-last activations, HWIO /
DHWIO convolution weights, (K, N) GEMM weights — and are written with
``torch.nn.functional``. The convolutions and pools compute in the inputs'
dtype, as the JAX oracles do; ``core.cronet.forward`` is built from them.
``gemm`` accumulates in fp32 and rounds to x's dtype, as its JAX oracle
does. Each kernel module wraps these into the plain version of its kernel
(fp32 accumulation, one rounding to x's dtype at the end).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


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
