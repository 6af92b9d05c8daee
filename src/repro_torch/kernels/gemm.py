"""``gemm``: (M, K) @ (K, N) with an fp32 accumulator and an optional
silu / tanh epilogue, for any M, K, N, in one launch.

Replaces the Pallas kernel ``repro/kernels/gemm.py::gemm``.
``csrc/gemm.cu`` splits K across the blocks of a thread-block cluster and
adds their column sums in rank 0's shared memory; see that file for the
design and what bounds it. ``gemm_plan`` computes the launch plan that the
wrapper passes to the kernel.

Plain version: ``ref.gemm`` (fp32 product, activation, rounded to x's
dtype). It runs only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, ref

_ACTIVATIONS = {None: 0, "silu": 1, "tanh": 2}
# csrc/gemm.cu's limits: threads a block, column vectors a block, blocks a
# cluster (the portable size), and the weight vectors a thread loads before
# its first FMA
MAX_THREADS, MAX_GROUPS, MAX_CLUSTER, LOADS = 256, 8, 8, 8
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}


class GemmPlan(NamedTuple):
    """A block owns ``groups`` column vectors of ``vec`` columns and
    ``kblock`` k values; its ``threads`` are (``klanes`` x ``groups``);
    ``cluster`` blocks share a column tile and split K. The grid is
    (``tiles * cluster``, ``rows``)."""
    vec: int
    groups: int
    klanes: int
    cluster: int
    kblock: int
    tiles: int
    threads: int
    rows: int


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@functools.lru_cache(maxsize=256)     # a forward asks for the same few
def gemm_plan(M: int, K: int, N: int, x_dtype: torch.dtype,
              w_dtype: torch.dtype, w_aligned: bool = True) -> GemmPlan:
    """The launch plan of ``csrc/gemm.cu`` for x (M, K) @ w (K, N).

    * Columns: 16-byte vectors along N (4 fp32 or 8 bf16 weights) when N is
      a multiple of that width and w is 16-byte aligned, else one column a
      vector; a block owns the largest power of two up to 8 of them that
      divides N's vectors, so every block is full (N = 40 fp32: 2 vectors of
      4; N = 64 fp32: 8 of 4).
    * K: split over a cluster of up to 8 blocks when a block of 256
      threads would load more than two weight vectors a thread; inside a
      block, as few warps as hold the slice at about 16 weights a thread
      (4 fp32 or 2 bf16 vectors, all in flight at once).
    """
    for dt in (x_dtype, w_dtype):
        if dt not in _ELEMENT_BYTES:
            raise TypeError(f"gemm_plan: dtype {dt}: float32 or bfloat16")
    if min(M, K, N) < 0:
        raise ValueError(f"gemm_plan: shape ({M}, {K}, {N})")
    width = 16 // _ELEMENT_BYTES[w_dtype]
    vec = width if N % width == 0 and w_aligned else 1
    nvec = -(-N // vec)
    groups = 1
    while groups < MAX_GROUPS and nvec % (2 * groups) == 0:
        groups *= 2
    klanes_max = MAX_THREADS // groups
    cluster = min(MAX_CLUSTER, max(1, -(-K // (2 * klanes_max))))
    kblock = -(-K // cluster)
    if kblock:
        cluster = -(-K // kblock)       # no rank without a k
    rows = min(LOADS, max(1, 16 // vec))    # ~16 weights a thread
    klanes = min(klanes_max,
                 max(32 // groups, _pow2_ceil(-(-kblock // rows))))
    return GemmPlan(vec=vec, groups=groups, klanes=klanes, cluster=cluster,
                    kblock=kblock, tiles=nvec // groups,
                    threads=groups * klanes, rows=min(M, 65535))


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
    plan = gemm_plan(M, K, N, x.dtype, w.dtype,
                     w_aligned=w.data_ptr() % 16 == 0)
    lib, fn = _build.function(
        "gemm", "gemm_forward", ctypes.c_int,
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p] + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    err = fn(_build.dtype_code(x), _build.dtype_code(w), x.data_ptr(),
             w.data_ptr(), out.data_ptr(), M, K, N, _ACTIVATIONS[activation],
             plan.vec, plan.groups, plan.klanes, plan.cluster, plan.kblock,
             plan.tiles, *_build.device_stream(x.device))
    _build.check(lib, "gemm", err)
    gemm.launches += 1
    return out


gemm.launches = 0
