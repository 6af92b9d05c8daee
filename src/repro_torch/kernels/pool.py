"""``maxpool2d``, ``adaptive_avg_pool2d``, ``adaptive_avg_pool3d``: two CUDA
kernels, one thread per output.

Replace the Pallas kernels ``repro/kernels/pool.py::maxpool2d``,
``::adaptive_avg_pool2d`` and ``::adaptive_avg_pool3d``. ``csrc/pool.cu``
holds a floor-window max pool and a 3D adaptive average pool, which the 2D
pool calls with D = od = 1; see that file for the design. Each wrapper
counts its own launches.

Plain versions: ``ref.maxpool2d`` (exact in any dtype) and the adaptive
pools of ``ref`` in fp32, rounded once to x's dtype, as the Pallas kernels
sum in fp32. They run only for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from repro_torch.kernels import _build, ref


def adaptive_bounds(n_in: int, n_out: int) -> Tuple[List[int], List[int]]:
    """Window starts and ends of an adaptive pool along one axis: output i
    averages [floor(i*n_in/n_out), ceil((i+1)*n_in/n_out)), PyTorch's rule
    (``repro.core.cronet._adaptive_bounds``; ``csrc/pool.cu`` computes the
    same integers)."""
    starts = [(i * n_in) // n_out for i in range(n_out)]
    ends = [-(-((i + 1) * n_in) // n_out) for i in range(n_out)]
    return starts, ends


def maxpool2d_plain(x, k: int = 2):
    return ref.maxpool2d(x, k)


def adaptive_avg_pool2d_plain(x, out_hw: Tuple[int, int]):
    return ref.adaptive_avg_pool2d(x.float(), out_hw).to(x.dtype)


def adaptive_avg_pool3d_plain(x, out_dhw: Tuple[int, int, int]):
    return ref.adaptive_avg_pool3d(x.float(), out_dhw).to(x.dtype)


def _on_card(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.contiguous()


def maxpool2d(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """x (B, H, W, C) -> (B, H//k, W//k, C), floor windows (the odd edge is
    dropped). CUDA tensors launch the kernel (or raise); CPU tensors run
    ``maxpool2d_plain``."""
    if x.dim() != 4 or k < 1:
        raise ValueError(f"maxpool2d: input {tuple(x.shape)}, k {k}")
    if x.device.type == "cpu":
        return maxpool2d_plain(x, k)
    x = _on_card("maxpool2d", x)
    B, H, W, C = x.shape
    out = torch.empty((B, H // k, W // k, C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib, fn = _build.function(
        "pool", "maxpool2d_forward", ctypes.c_int,
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6
        + [ctypes.c_void_p])
    err = fn(_build.dtype_code(x), x.data_ptr(), out.data_ptr(), B, H, W, C,
             k, *_build.device_stream(x.device))
    _build.check(lib, "pool", err)
    maxpool2d.launches += 1
    return out


def _aap(wrapper, x5, out_dhw):
    """The adaptive-pool kernel on x5 (B, D, H, W, C); counts the launch on
    ``wrapper``."""
    x5 = _on_card(wrapper.__name__, x5)
    B, D, H, W, C = x5.shape
    OD, OH, OW = out_dhw
    out = torch.empty((B, OD, OH, OW, C), dtype=x5.dtype, device=x5.device)
    if out.numel() == 0:
        return out
    lib, fn = _build.function(
        "pool", "aap3d_forward", ctypes.c_int,
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p])
    dims = (ctypes.c_int * 8)(B, D, H, W, C, OD, OH, OW)
    err = fn(_build.dtype_code(x5), x5.data_ptr(), out.data_ptr(), dims,
             *_build.device_stream(x5.device))
    _build.check(lib, "pool", err)
    wrapper.launches += 1
    return out


def _check_adaptive(name, x, out_size):
    if (x.dim() != len(out_size) + 2 or min(x.shape[1:-1]) < 1
            or min(out_size) < 1):
        raise ValueError(f"{name}: input {tuple(x.shape)} to output "
                         f"{tuple(out_size)}")


def adaptive_avg_pool2d(x: torch.Tensor,
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    """x (B, H, W, C) -> (B, oh, ow, C) in x's dtype, fp32 window sums.
    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``adaptive_avg_pool2d_plain``."""
    _check_adaptive("adaptive_avg_pool2d", x, out_hw)
    if x.device.type == "cpu":
        return adaptive_avg_pool2d_plain(x, out_hw)
    return _aap(adaptive_avg_pool2d, x[:, None], (1, *out_hw))[:, 0]


def adaptive_avg_pool3d(x: torch.Tensor,
                        out_dhw: Tuple[int, int, int]) -> torch.Tensor:
    """x (B, D, H, W, C) -> (B, od, oh, ow, C) in x's dtype, fp32 window
    sums. CUDA tensors launch the kernel (or raise); CPU tensors run
    ``adaptive_avg_pool3d_plain``."""
    _check_adaptive("adaptive_avg_pool3d", x, out_dhw)
    if x.device.type == "cpu":
        return adaptive_avg_pool3d_plain(x, out_dhw)
    return _aap(adaptive_avg_pool3d, x, out_dhw)


maxpool2d.launches = 0
adaptive_avg_pool2d.launches = 0
adaptive_avg_pool3d.launches = 0
