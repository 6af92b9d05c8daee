"""``slstm_fused``: the sLSTM recurrence in one persistent cooperative CUDA
launch.

Replaces the Pallas kernel ``repro/kernels/slstm.py::slstm_fused``, with
its signature and its divisibility checks. ``csrc/slstm.cu`` spreads the
hidden units over the card, one block per U units of a head with their
columns of R resident in shared memory, and separates the time steps with
grid barriers; see that file for the design. The launch needs every block
resident at once (``cudaLaunchCooperativeKernel``): when the card cannot
hold them the wrapper raises, and never falls back to a loop of launches or
to the plain version. ``time_block`` and ``batch_tile`` are checked as JAX
checks them and do not change the result. ``launch_plan`` reports the
blocks, threads and shared memory a shape needs.

Plain version: ``ref.slstm_sequential``. It runs only for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build, ref


def slstm_plain(wx, r_zifo):
    return ref.slstm_sequential(wx, r_zifo)


def _check(wx, r_zifo, time_block, batch_tile):
    if wx.dim() != 3 or r_zifo.dim() != 3:
        raise ValueError(f"slstm_fused: wx {tuple(wx.shape)}, r_zifo "
                         f"{tuple(r_zifo.shape)}")
    b, s, d4 = wx.shape
    nh, dh, dh4 = r_zifo.shape
    if d4 != 4 * nh * dh or dh4 != 4 * dh:
        raise ValueError(f"slstm_fused: wx {tuple(wx.shape)} does not match "
                         f"r_zifo {tuple(r_zifo.shape)}")
    bt, ts = min(batch_tile, b), min(time_block, s)
    if bt < 1 or ts < 1 or b % bt or s % ts:
        raise ValueError(f"slstm_fused: batch_tile {bt} / time_block {ts} "
                         f"do not divide B {b} / S {s}")


def launch_plan(batch: int, nh: int, dh: int) -> Dict[str, int]:
    """The kernel's launch for B = ``batch`` and ``nh`` heads of ``dh``
    units: blocks, threads per block, dynamic shared bytes, units per
    block, dot-product slices."""
    lib = _build.load("slstm")
    fn = lib.slstm_plan
    fn.restype = None
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = (ctypes.c_longlong * 5)()
    fn(batch, nh, dh, out)
    return dict(zip(("blocks", "threads", "smem_bytes", "units_per_block",
                     "slices"), out))


def slstm_fused(wx: torch.Tensor, r_zifo: torch.Tensor, *,
                time_block: int = 256, batch_tile: int = 8) -> torch.Tensor:
    """wx: (B, S, 4d) precomputed input projections ([z|i|f|o] layout);
    r_zifo: (nh, dh, 4dh) block-diagonal recurrent weights (used in fp32).
    Returns the hidden states (B, S, d) in wx's dtype, from a zero state.
    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``slstm_plain``."""
    _check(wx, r_zifo, time_block, batch_tile)
    if wx.device.type == "cpu":
        return slstm_plain(wx, r_zifo)
    if wx.device.type != "cuda" or r_zifo.device != wx.device:
        raise ValueError(f"slstm_fused: wx on {wx.device}, r_zifo on "
                         f"{r_zifo.device}")
    b, s, _ = wx.shape
    nh, dh, _ = r_zifo.shape
    wx = wx.contiguous()
    r = r_zifo.float().contiguous()
    out = torch.empty((b, s, nh * dh), dtype=wx.dtype, device=wx.device)
    if out.numel() == 0:
        return out
    hbuf = torch.empty((2, b, nh * dh), dtype=torch.float32,
                       device=wx.device)
    lib, fn = _build.function(
        "slstm", "slstm_forward", ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_void_p])
    err = fn(_build.dtype_code(wx), wx.data_ptr(), r.data_ptr(),
             out.data_ptr(), hbuf.data_ptr(), b, s, nh, dh,
             *_build.device_stream(wx.device))
    _build.check(lib, "slstm", err)
    slstm_fused.launches += 1
    return out


slstm_fused.launches = 0
