"""``conv2d`` and ``conv3d``: SAME convolutions, one CUDA kernel for both.

Replace the Pallas kernels ``repro/kernels/conv.py::conv2d`` and
``::conv3d``. ``csrc/conv.cu`` computes a 3D convolution straight from the
unpadded channels-last input with the filter in shared memory; ``conv2d``
calls it with D = kd = 1. See that file for the design and what bounds it.
Each wrapper counts its own launches.

Plain versions (``conv2d_plain``, ``conv3d_plain``): the convolution of
``ref`` in fp32, SiLU if fused, rounded once to x's dtype — the Pallas
kernels' arithmetic. They run only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ref

_DEPTH_PADDINGS = ("same", "causal_same")


def conv2d_plain(x, w, *, fuse_silu: bool = False):
    y = ref.conv2d_same(x.float(), w.float())
    return (F.silu(y) if fuse_silu else y).to(x.dtype)


def conv3d_plain(x, w, *, depth_padding: str = "same",
                 fuse_silu: bool = False):
    y = ref.conv3d(x.float(), w.float(), depth_padding)
    return (F.silu(y) if fuse_silu else y).to(x.dtype)


def _check(name, x, w, ndim, depth_padding="same"):
    if x.dim() != ndim or w.dim() != ndim:
        raise ValueError(f"{name}: need a {ndim}-d input and filter, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[-1] != w.shape[-2]:
        raise ValueError(f"{name}: input has {x.shape[-1]} channels, the "
                         f"filter takes {w.shape[-2]}")
    if w.shape[-4] % 2 == 0 or w.shape[-3] % 2 == 0:
        raise ValueError(f"{name}: SAME padding needs odd kh, kw; filter "
                         f"{tuple(w.shape)}")
    if depth_padding not in _DEPTH_PADDINGS:
        raise ValueError(f"{name}: depth_padding {depth_padding!r} not in "
                         f"{_DEPTH_PADDINGS}")
    if ndim == 5 and depth_padding == "same" and w.shape[0] != 1:
        raise ValueError(f"{name}: depth_padding 'same' needs kd == 1, "
                         f"got kd = {w.shape[0]}")


def _launch(wrapper, x5, w5, fuse_silu):
    """The kernel on x5 (B, D, H, W, Cin), w5 (KD, KH, KW, Cin, Cout),
    depth causal_same (which is "same" for KD = 1); counts the launch on
    ``wrapper``."""
    name = wrapper.__name__
    if x5.device.type != "cuda" or w5.device != x5.device:
        raise ValueError(f"{name}: input on {x5.device}, filter on "
                         f"{w5.device}; need one CUDA device")
    B, D, H, W, Cin = x5.shape
    KD, KH, KW, _, Cout = w5.shape
    out = torch.empty((B, D, H, W, Cout), dtype=x5.dtype, device=x5.device)
    if out.numel() == 0:
        return out
    x5, w5 = x5.contiguous(), w5.contiguous()
    lib, fn = _build.function(
        "conv", "conv3d_forward", ctypes.c_int,
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p])
    dims = (ctypes.c_int * 9)(B, D, H, W, Cin, KD, KH, KW, Cout)
    err = fn(_build.dtype_code(x5), _build.dtype_code(w5), x5.data_ptr(),
             w5.data_ptr(), out.data_ptr(), dims, int(fuse_silu),
             *_build.device_stream(x5.device))
    _build.check(lib, "conv", err)
    wrapper.launches += 1
    return out


def conv2d(x: torch.Tensor, w: torch.Tensor, *,
           fuse_silu: bool = False) -> torch.Tensor:
    """x (B, H, W, Cin), w (kh, kw, Cin, Cout) -> (B, H, W, Cout) in x's
    dtype; SAME padding, no bias. CUDA tensors launch the kernel (or
    raise); CPU tensors run ``conv2d_plain``."""
    _check("conv2d", x, w, 4)
    if x.device.type == "cpu":
        return conv2d_plain(x, w, fuse_silu=fuse_silu)
    return _launch(conv2d, x[:, None], w[None], fuse_silu)[:, 0]


def conv3d(x: torch.Tensor, w: torch.Tensor, *, depth_padding: str = "same",
           fuse_silu: bool = False) -> torch.Tensor:
    """x (B, D, H, W, Cin), w (kd, kh, kw, Cin, Cout) -> (B, D, H, W, Cout)
    in x's dtype. Spatial SAME; depth 'causal_same' (pad (0, kd-1)) or
    'same' (kd == 1). CUDA tensors launch the kernel (or raise); CPU
    tensors run ``conv3d_plain``."""
    _check("conv3d", x, w, 5, depth_padding)
    if x.device.type == "cpu":
        return conv3d_plain(x, w, depth_padding=depth_padding,
                            fuse_silu=fuse_silu)
    return _launch(conv3d, x, w, fuse_silu)


conv2d.launches = 0
conv3d.launches = 0
