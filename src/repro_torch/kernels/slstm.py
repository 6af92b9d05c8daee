"""``slstm_fused``: the sLSTM recurrence in one persistent cooperative CUDA
launch.

Replaces the Pallas kernel ``repro/kernels/slstm.py::slstm_fused``, with
its signature and its divisibility checks. ``csrc/slstm.cu`` spreads the
hidden units over the card, one block per U units of a head with their
columns of R resident in shared memory; each step a block waits only for
the blocks of its own head, through one flag a block; see that file for the
design. ``slstm_plan`` computes the launch plan that the wrapper passes to
the kernel. The launch needs every block resident at once
(``cudaLaunchCooperativeKernel``): when the card cannot hold them the
wrapper raises, and never falls back to a loop of launches or to the plain
version. ``time_block`` and ``batch_tile`` are checked as JAX checks them
and do not change the result. ``launch_plan`` reports the plan as a dict.

Plain version: ``ref.slstm_sequential``. It runs only for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from repro_torch.kernels import _build, ref


def slstm_plain(wx, r_zifo):
    return ref.slstm_sequential(wx, r_zifo)


# slstm_forward's C signature
ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
# csrc/slstm.cu's register tile (4 gate columns x 8 batch rows), the
# largest block, units a block and dot-product slices at most
TILE_Q, TILE_B, MAX_THREADS, MAX_UNITS, MAX_SLICES = 4, 8, 256, 16, 16


class SlstmPlan(NamedTuple):
    """The launch plan of ``csrc/slstm.cu`` (its ``Plan``, field for
    field). A block owns ``units`` units of one head (``per_head`` blocks
    a head, ``blocks`` in all) and their 4 * units gate columns of R; its
    ``threads`` are (column group of 4, slice): slice s takes k = s,
    s + slices, ... of the head's ``dh`` (at most ``slice_len`` of them).
    The batch is padded to ``bpad`` rows (a multiple of 8) in shared
    memory; ``smem`` dynamic shared bytes a block."""
    units: int
    slices: int
    slice_len: int
    threads: int
    blocks: int
    per_head: int
    bpad: int
    smem: int


def slstm_plan(batch: int, nh: int, dh: int) -> SlstmPlan:
    """The launch plan of ``csrc/slstm.cu`` for B = ``batch`` and ``nh``
    heads of ``dh`` units: the largest divisor of dh up to 16 units a block
    (xlstm-1.3b: 16, so 32 blocks a head and 128 in all), and min(16, dh)
    slices of k, taken with a stride. Everything that orders a sum (units,
    slices) depends on dh only; batch sets ``bpad`` and ``smem``."""
    if min(batch, nh, dh) < 1:
        raise ValueError(f"slstm_plan: B {batch}, nh {nh}, dh {dh}")
    units = max(u for u in range(1, MAX_UNITS + 1) if dh % u == 0)
    slices = min(MAX_SLICES, dh)
    slice_len = -(-dh // slices)
    bpad = -(-batch // TILE_B) * TILE_B
    four_u = 4 * units
    smem = 4 * (dh * four_u + dh * (bpad + 4) + slices * bpad * four_u
                + 3 * bpad * units)
    return SlstmPlan(units=units, slices=slices, slice_len=slice_len,
                     threads=units * slices, blocks=nh * (dh // units),
                     per_head=dh // units, bpad=bpad, smem=smem)


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
    """``slstm_plan`` as a dict, with the names chip_smoke.py reports:
    blocks, threads per block, dynamic shared bytes, units per block,
    dot-product slices, blocks a head (the group a step waits for)."""
    p = slstm_plan(batch, nh, dh)
    return {"blocks": p.blocks, "threads": p.threads, "smem_bytes": p.smem,
            "units_per_block": p.units, "slices": p.slices,
            "slice_len": p.slice_len, "blocks_per_head": p.per_head,
            "batch_padded": p.bpad}


def launch_args(wx: torch.Tensor, r_zifo: torch.Tensor):
    """``(args, out, keep)``: the arguments of ``slstm_forward`` for CUDA
    inputs, the output they write, and the tensors that must outlive the
    launch."""
    b, s, _ = wx.shape
    nh, dh, _ = r_zifo.shape
    plan = slstm_plan(b, nh, dh)
    wx = wx.contiguous()
    r = r_zifo.float().contiguous()
    out = torch.empty((b, s, nh * dh), dtype=wx.dtype, device=wx.device)
    hbuf = torch.empty((2, b, nh * dh), dtype=torch.float32,
                       device=wx.device)
    flags = torch.empty((plan.blocks,), dtype=torch.int32, device=wx.device)
    c_plan = (ctypes.c_int * len(plan))(*plan)
    args = (_build.dtype_code(wx), wx.data_ptr(), r.data_ptr(),
            out.data_ptr(), hbuf.data_ptr(), flags.data_ptr(), b, s, nh, dh,
            c_plan, *_build.device_stream(wx.device))
    return args, out, (wx, r, hbuf, flags, c_plan)


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
    args, out, keep = launch_args(wx, r_zifo)
    if out.numel() == 0:
        return out
    lib, fn = _build.function("slstm", "slstm_forward", ctypes.c_int,
                              ARGTYPES)
    err = fn(*args)
    _build.check(lib, "slstm", err)
    slstm_fused.launches += 1
    return out


slstm_fused.launches = 0
