"""``silu_lut`` and ``silu_exact``: two elementwise CUDA kernels.

Replace the Pallas kernels ``repro/kernels/silu.py::silu_lut`` and
``::silu_exact``. ``csrc/silu.cu`` covers the flat tensor in 16-byte vectors
(4 fp32 or 8 bf16 elements) under the plan ``silu_plan`` computes here: a
scalar head up to x's first 16-byte boundary, the vectors in one pass of
blocks, a scalar tail. See that file for the design. The output is
placed at x's offset from a 16-byte boundary, so that x and out share the
plan; no input is copied (a non-contiguous x is made contiguous first).
Each wrapper counts its own launches.

Plain versions: ``ref.silu_lut`` (whose table is ``make_table``'s, built
the same way on the same device) and ``ref.silu_exact``. They run only for
CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ref

N_ENTRIES = 256
LO, HI = -8.0, 8.0

_tables: Dict[torch.device, torch.Tensor] = {}


def make_table(device=None) -> torch.Tensor:
    """silu on the ``N_ENTRIES``-point grid of [LO, HI] (fp32), the grid
    computed as ``jnp.linspace`` computes it (``ref.linspace``)."""
    return F.silu(ref.linspace(LO, HI, N_ENTRIES, device=device))


def silu_lut_plain(x):
    return ref.silu_lut(x, N_ENTRIES, LO, HI)


def silu_exact_plain(x):
    return ref.silu_exact(x)


BLOCK_ELEMS = 1024     # a block's elements at a vector a thread
SM_THREADS = 1024      # a wave's threads an SM: __launch_bounds__(256, 4)
VPTS = (1, 2, 4)       # vectors a thread: the kernel's cases


class SiluPlan(NamedTuple):
    """Elements [0, head) and the last ``tail`` are scalar; the ``nvec``
    16-byte vectors of ``vec`` elements between them are covered in one
    pass by ``blocks`` blocks of ``threads``, thread t of block b loading
    the ``vpt`` vectors b * threads * vpt + t + j * threads. Block 0's
    first ``head + tail`` threads take the scalars."""
    vec: int
    head: int
    nvec: int
    tail: int
    blocks: int
    threads: int
    vpt: int


def silu_plan(n: int, dtype: torch.dtype, sm_count: int,
              ptr_offset: int = 0) -> SiluPlan:
    """The launch plan of ``csrc/silu.cu`` for n elements of ``dtype``
    (fp32 or bf16) whose first lies ``ptr_offset`` bytes past a 16-byte
    boundary, on a card of ``sm_count`` SMs.

    Blocks of ``BLOCK_ELEMS`` elements at a vector a thread (256 fp32 or
    128 bf16 threads: at 2^14 both spread over 16 SMs). One pass: while
    the vectors fit one wave (``SM_THREADS`` threads an SM) at 4 vectors a
    thread, the fewest vectors a thread (1, 2, 4) that fit it, over as many
    blocks as they fill; past that, one vector a thread over as many
    blocks as they fill (``kernel_probe --silu``: at 2^26 fp32 that is 5%
    faster than one wave walking passes and 0.5% faster than 4 vectors a
    thread; at 768,000, 1.4 waves at one vector a thread, one wave at 2 is
    3-15% faster)."""
    esize = {torch.float32: 4, torch.bfloat16: 2}.get(dtype)
    if esize is None:
        raise TypeError(f"silu_plan: dtype {dtype}: fp32 or bf16 only")
    if n < 1 or ptr_offset % esize or not 0 <= ptr_offset < 16:
        raise ValueError(f"silu_plan: n {n}, pointer offset {ptr_offset}")
    vec = 16 // esize
    head = min(n, (16 - ptr_offset) % 16 // esize)
    nvec = (n - head) // vec
    tail = n - head - nvec * vec
    threads = BLOCK_ELEMS // vec
    wave = sm_count * SM_THREADS                    # threads of one wave
    vpt = next((v for v in VPTS if nvec <= wave * v), 1)
    blocks = max(1, -(-nvec // (threads * vpt)))
    return SiluPlan(vec, head, nvec, tail, blocks, threads, vpt)


_sm_counts: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, queried once per device."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = \
            torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


PLAN_ARGS = [ctypes.c_longlong] + [ctypes.c_int] * 5   # n, head, tail, ...
ARGTYPES = {   # the C entry points' signatures
    "silu_lut_forward": [ctypes.c_int] + [ctypes.c_void_p] * 3 + PLAN_ARGS
    + [ctypes.c_int, ctypes.c_void_p],
    "silu_exact_forward": [ctypes.c_int] + [ctypes.c_void_p] * 2 + PLAN_ARGS
    + [ctypes.c_int, ctypes.c_void_p],
}


def launch_args(name: str, x: torch.Tensor, plan: SiluPlan = None):
    """``(entry, args, out, keep)`` for a CUDA tensor x and ``name``
    "silu_lut" or "silu_exact": the C entry point (``ARGTYPES[entry]``),
    its arguments under ``plan`` (default ``silu_plan``'s), the output
    they write and the tensors that must outlive the launch."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    code = _build.dtype_code(x)
    x = x.contiguous()
    n, esize = x.numel(), x.element_size()
    # out at x's offset from a 16-byte boundary: x's vectors are out's
    buf = torch.empty(n + 16 // esize - 1, dtype=x.dtype, device=x.device)
    shift = (x.data_ptr() - buf.data_ptr()) % 16 // esize
    out = buf[shift:shift + n].view(x.shape)
    if n == 0:
        return f"{name}_forward", (), out, (x,)
    if plan is None:
        plan = silu_plan(n, x.dtype, sm_count(x.device), x.data_ptr() % 16)
    table = []
    if name == "silu_lut":
        table = _tables.get(x.device)
        if table is None:
            table = _tables[x.device] = make_table(x.device)
        table = [table]
    args = (code, x.data_ptr(), *[t.data_ptr() for t in table],
            out.data_ptr(), n, plan.head, plan.tail, plan.blocks,
            plan.threads, plan.vpt, *_build.device_stream(x.device))
    return f"{name}_forward", args, out, (x, out, *table)


def _launch(wrapper, x):
    """The kernel of ``wrapper`` over the flat CUDA tensor x; counts the
    launch on ``wrapper``."""
    entry, args, out, keep = launch_args(wrapper.__name__, x)
    if out.numel() == 0:
        return out
    lib, fn = _build.function("silu", entry, ctypes.c_int, ARGTYPES[entry])
    _build.check(lib, "silu", fn(*args))
    wrapper.launches += 1
    return out


def silu_lut(x: torch.Tensor) -> torch.Tensor:
    """Nearest-entry table SiLU of x (any shape, fp32 or bf16), identity
    above 8 and zero below -8, in x's dtype. CUDA tensors launch the kernel
    (or raise); CPU tensors run ``silu_lut_plain``."""
    if x.device.type == "cpu":
        return silu_lut_plain(x)
    return _launch(silu_lut, x)


def silu_exact(x: torch.Tensor) -> torch.Tensor:
    """silu(x) in fp32, rounded to x's dtype (any shape, fp32 or bf16).
    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``silu_exact_plain``."""
    if x.device.type == "cpu":
        return silu_exact_plain(x)
    return _launch(silu_exact, x)


silu_lut.launches = 0
silu_exact.launches = 0
