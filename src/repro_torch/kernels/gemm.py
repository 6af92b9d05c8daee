"""``gemm``: (M, K) @ (K, N) with an fp32 accumulator and an optional
silu / tanh epilogue, for any M, K, N.

Replaces the Pallas kernel ``repro/kernels/gemm.py::gemm``.
``csrc/gemm.cu`` splits K across the warps of a block and, for long K,
across blocks (a second launch adds the chunks in order); see that file for
the design and what bounds it. The two launches of a long-K call count as
one.

Plain version: ``ref.gemm`` (fp32 product, activation, rounded to x's
dtype). It runs only for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

_ACTIVATIONS = {None: 0, "silu": 1, "tanh": 2}


def gemm_plain(x, w, activation: Optional[str] = None):
    return ref.gemm(x, w, activation)


def gemm(x: torch.Tensor, w: torch.Tensor, *,
         activation: Optional[str] = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype; x and w may each be fp32
    or bf16. CUDA tensors launch the kernel (or raise); CPU tensors run
    ``gemm_plain``."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"gemm: activation {activation!r} not in "
                         f"{list(_ACTIVATIONS)}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.device.type == "cpu":
        return gemm_plain(x, w, activation)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"gemm: x on {x.device}, w on {w.device}; need one "
                         "CUDA device")
    (M, K), N = x.shape, w.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    x, w = x.contiguous(), w.contiguous()
    lib, fn = _build.function(
        "gemm", "gemm_forward", ctypes.c_int,
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    _, size = _build.function("gemm", "gemm_partial_size",
                              ctypes.c_longlong, [ctypes.c_int] * 3)
    n_partial = size(M, K, N)
    partial = (torch.empty((n_partial,), dtype=torch.float32, device=x.device)
               if n_partial else None)
    err = fn(_build.dtype_code(x), _build.dtype_code(w), x.data_ptr(),
             w.data_ptr(), out.data_ptr(),
             0 if partial is None else partial.data_ptr(), M, K, N,
             _ACTIVATIONS[activation], *_build.device_stream(x.device))
    _build.check(lib, "gemm", err)
    gemm.launches += 1
    return out


gemm.launches = 0
