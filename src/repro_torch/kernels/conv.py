"""``conv2d`` and ``conv3d``: SAME convolutions, two CUDA kernels for both.

Replace the Pallas kernels ``repro/kernels/conv.py::conv2d`` and
``::conv3d``. ``csrc/conv.cu`` computes a 3D convolution straight from the
unpadded channels-last input; ``conv2d`` calls it with D = kd = 1. See that
file for the design and what bounds it.

Which kernel a CUDA call launches is a fixed rule on dtype and channels
(``kernel_for``): bfloat16 x and w with Cin % 16 == 0 and Cout % 8 == 0 go
to the tensor-core kernel (``mma.sync``, ``"tc"``); every other call, fp32
included, to the SIMT kernel (``"simt"``). A kernel that fails to build or
launch raises; there is no second try on the other one. The wrapper cuts
the output into blocks (``tile_plan``) and passes the plan to the kernel.
Each wrapper counts every launch on ``.launches`` and each kernel's on
``.tc_launches`` or ``.simt_launches``.

Plain versions (``conv2d_plain``, ``conv3d_plain``): the convolution of
``ref`` in fp32, SiLU if fused, rounded once to x's dtype — the Pallas
kernels' arithmetic. They run only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ref

_DEPTH_PADDINGS = ("same", "causal_same")

# The tile plan. A block owns one (b, d) slice, a band of ``rows`` output
# rows by ``cols`` columns and ``ct`` output channels.
TARGET_BLOCKS = 132          # one block per SM of an H100
MAX_COLS = 128               # columns of a band (full width up to here)
MAX_PIXELS = 256             # output pixels of a block
MAX_SLOT_THREADS = 256       # threads over a block's output slots
MAX_THREADS = 768            # the SIMT kernel's __launch_bounds__
SMEM_BUDGET = 200 * 1024     # dynamic shared memory a block may take
SIMT_PX, SIMT_CO = 2, 4      # a SIMT thread's register tile: pixels x channels
TC_M = 16                    # output pixels of one mma.sync tile
TC_MIN_WARPS = 4             # tensor cores: warps that share the copy-in


def conv2d_plain(x, w, *, fuse_silu: bool = False):
    y = ref.conv2d_same(x.float(), w.float())
    return (F.silu(y) if fuse_silu else y).to(x.dtype)


def conv3d_plain(x, w, *, depth_padding: str = "same",
                 fuse_silu: bool = False):
    y = ref.conv3d(x.float(), w.float(), depth_padding)
    return (F.silu(y) if fuse_silu else y).to(x.dtype)


def kernel_for(dtype: torch.dtype, cin: int, cout: int) -> str:
    """The kernel a CUDA call launches for x and w of ``dtype`` (a mixed
    pair counts as float32), Cin input and Cout output channels: ``"tc"``
    (tensor cores) or ``"simt"``."""
    if dtype == torch.bfloat16 and cin % 16 == 0 and cout % 8 == 0:
        return "tc"
    return "simt"


class TilePlan(NamedTuple):
    kernel: str                  # "tc" or "simt"
    rows: int                    # output rows of a block's band
    cols: int                    # output columns of a block's band
    ct: int                      # output channels of a block (8, 16, 32)
    split: int                   # SIMT thread groups over the taps (TC: 1)
    threads: int
    smem: int                    # dynamic shared memory, bytes
    grid: Tuple[int, int]        # (slices x row bands x column bands,
                                 #  channel tiles)


def _plan(kernel, dims, rows, cols, ct, split=None) -> TilePlan:
    """The plan of a tile shape: its threads, shared memory and grid;
    ``split`` (SIMT thread groups over the taps) defaults to KH, as many as
    ``MAX_THREADS`` allows."""
    B, D, H, W, cin, kd, kh, kw, cout = dims
    halo = kd * (rows + kh - 1) * (cols + kw - 1)
    taps = kd * kh * kw
    if kernel == "tc":        # a warp per 16-pixel tile, 4 to 8 warps
        split = 1
        threads = 32 * max(TC_MIN_WARPS, min(MAX_SLOT_THREADS // 32,
                                             math.ceil(rows * cols / TC_M)))
        cts = ct if (ct // 8) % 2 else ct + 8
        smem = 2 * (halo * (cin + 8) + taps * cin * cts
                    + threads // 32 * TC_M * cts)
    else:
        slots = math.ceil(rows * cols / SIMT_PX) * (ct // SIMT_CO)
        slot_threads = min(MAX_SLOT_THREADS, 32 * math.ceil(slots / 32))
        if split is None:
            split = min(kh, MAX_THREADS // slot_threads)
        threads = split * slot_threads
        cks = cin + 4 if cin % 4 == 0 else cin
        smem = 4 * ((halo * cks + 3) // 4 * 4 + taps * cin * ct
                    + (split - 1) * SIMT_PX * SIMT_CO * slot_threads
                    + 2 * taps)
    grid = (B * D * math.ceil(H / rows) * math.ceil(W / cols),
            math.ceil(cout / ct))
    return TilePlan(kernel, rows, cols, ct, split, threads, smem, grid)


@functools.lru_cache(maxsize=256)
def tile_plan(kernel: str, dims: Tuple[int, ...]) -> TilePlan:
    """The blocks of one call. ``dims``: B, D, H, W, Cin, KD, KH, KW, Cout.

    ct is the smallest of 8, 16, 32 that holds Cout (32 at most), halved
    while a one-row band gives fewer than ``TARGET_BLOCKS`` blocks; the band
    is as many rows as keep the grid at ``TARGET_BLOCKS`` or more (one row
    if none does), at full width up to ``MAX_COLS``. The tile then shrinks
    (rows, columns, channels) until its shared memory fits; a call whose
    smallest tile does not fit raises."""
    B, D, H, W, cin, kd, kh, kw, cout = dims
    cols = min(W, MAX_COLS)

    def blocks(rows, cols, ct):
        return (B * D * math.ceil(H / rows) * math.ceil(W / cols)
                * math.ceil(cout / ct))

    ct = 8 if cout <= 8 else 16 if cout <= 16 else 32
    while ct > 8 and blocks(1, cols, ct) < TARGET_BLOCKS:
        ct //= 2
    rows = 1
    while (rows < H and (rows + 1) * cols <= MAX_PIXELS
           and blocks(rows + 1, cols, ct) >= TARGET_BLOCKS):
        rows += 1
    while _plan(kernel, dims, rows, cols, ct).smem > SMEM_BUDGET:
        if rows > 1:
            rows -= 1
        elif cols > 8:
            cols = math.ceil(cols / 2)
        elif ct > 8:
            ct //= 2
        else:
            raise ValueError(f"conv: a {kd}x{kh}x{kw} filter over {cin} "
                             "channels does not fit the kernel's shared "
                             "memory")
    return _plan(kernel, dims, rows, cols, ct)


def tile_of(plan: TilePlan, dims, bx: int, by: int):
    """Block (bx, by)'s output tile as csrc/conv.cu's ``tile_of`` decodes
    it: (b, d, rows y0:y1, columns x0:x1, channels c0:c1), clipped."""
    B, D, H, W, _, _, _, _, cout = dims
    ncb, nrb = math.ceil(W / plan.cols), math.ceil(H / plan.rows)
    cb, t = bx % ncb, bx // ncb
    rb, t = t % nrb, t // nrb
    y0, x0, c0 = rb * plan.rows, cb * plan.cols, by * plan.ct
    return (t // D, t % D, y0, min(y0 + plan.rows, H), x0,
            min(x0 + plan.cols, W), c0, min(c0 + plan.ct, cout))


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


def _aligned(t):
    """t contiguous, its data 16-byte aligned (the kernels' vector copies)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(wrapper, x5, w5, fuse_silu):
    """The kernel ``kernel_for`` picks on x5 (B, D, H, W, Cin), w5 (KD, KH,
    KW, Cin, Cout), depth causal_same (which is "same" for KD = 1); counts
    the launch on ``wrapper``."""
    name = wrapper.__name__
    if x5.device.type != "cuda" or w5.device != x5.device:
        raise ValueError(f"{name}: input on {x5.device}, filter on "
                         f"{w5.device}; need one CUDA device")
    x_code, w_code = _build.dtype_code(x5), _build.dtype_code(w5)
    B, D, H, W, Cin = x5.shape
    KD, KH, KW, _, Cout = w5.shape
    out = torch.empty((B, D, H, W, Cout), dtype=x5.dtype, device=x5.device)
    if out.numel() == 0:
        return out
    x5, w5 = _aligned(x5), _aligned(w5)
    dims = (B, D, H, W, Cin, KD, KH, KW, Cout)
    kernel = kernel_for(x5.dtype if x5.dtype == w5.dtype else torch.float32,
                        Cin, Cout)
    plan = tile_plan(kernel, dims)
    c_dims = (ctypes.c_int * 9)(*dims)
    c_plan = (ctypes.c_int * 8)(plan.rows, plan.cols, plan.ct, plan.split,
                                plan.threads, plan.smem, *plan.grid)
    tail = (out.data_ptr(), c_dims, c_plan, int(fuse_silu),
            *_build.device_stream(x5.device))
    ptrs = [ctypes.c_void_p] * 5
    tail_types = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    if kernel == "tc":
        lib, fn = _build.function("conv", "conv3d_tc_forward", ctypes.c_int,
                                  ptrs + tail_types)
        err = fn(x5.data_ptr(), w5.data_ptr(), *tail)
    else:
        lib, fn = _build.function("conv", "conv3d_forward", ctypes.c_int,
                                  [ctypes.c_int] * 2 + ptrs + tail_types)
        err = fn(x_code, w_code, x5.data_ptr(), w5.data_ptr(), *tail)
    _build.check(lib, "conv", err)
    wrapper.launches += 1
    if kernel == "tc":
        wrapper.tc_launches += 1
    else:
        wrapper.simt_launches += 1
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


for _fn in (conv2d, conv3d):
    _fn.launches = _fn.tc_launches = _fn.simt_launches = 0
