"""``silu_lut`` and ``silu_exact``: two elementwise CUDA kernels.

Replace the Pallas kernels ``repro/kernels/silu.py::silu_lut`` and
``::silu_exact``. ``csrc/silu.cu`` walks the flat tensor with a grid-stride
loop; the LUT kernel keeps the 256-entry table in shared memory. See that
file for the design. Each wrapper counts its own launches.

Plain versions: ``ref.silu_lut`` (whose table is ``make_table``'s, built
the same way on the same device) and ``ref.silu_exact``. They run only for
CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Dict

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


def _launch(wrapper, x, *table):
    """The kernel of ``wrapper`` over the flat CUDA tensor x; counts the
    launch on ``wrapper``."""
    if x.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    name = f"{wrapper.__name__}_forward"
    lib, fn = _build.function(
        "silu", name, ctypes.c_int,
        [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_void_p] * len(table)
        + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_void_p])
    err = fn(_build.dtype_code(x), x.data_ptr(),
             *[t.data_ptr() for t in table], out.data_ptr(), x.numel(),
             *_build.device_stream(x.device))
    _build.check(lib, "silu", err)
    wrapper.launches += 1
    return out


def silu_lut(x: torch.Tensor) -> torch.Tensor:
    """Nearest-entry table SiLU of x (any shape, fp32 or bf16), identity
    above 8 and zero below -8, in x's dtype. CUDA tensors launch the kernel
    (or raise); CPU tensors run ``silu_lut_plain``."""
    if x.device.type == "cpu":
        return silu_lut_plain(x)
    table = _tables.get(x.device)
    if table is None:
        table = _tables[x.device] = make_table(x.device)
    return _launch(silu_lut, x, table)


def silu_exact(x: torch.Tensor) -> torch.Tensor:
    """silu(x) in fp32, rounded to x's dtype (any shape, fp32 or bf16).
    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``silu_exact_plain``."""
    if x.device.type == "cpu":
        return silu_exact_plain(x)
    return _launch(silu_exact, x)


silu_lut.launches = 0
silu_exact.launches = 0
