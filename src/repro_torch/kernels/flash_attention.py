"""``flash_attention`` and ``flash_attention_causal_gqa``: two CUDA kernels.

Replace the Pallas kernels ``repro/kernels/flash_attention.py::
flash_attention`` and ``::flash_attention_causal_gqa``, with their
signatures and their checks: a call the JAX functions reject (a block size
that does not divide the sequence, causal attention with grouped q heads
through ``flash_attention``) raises here too. ``csrc/flash_attention.cu``
runs one thread block per (batch, q head, q tile) with q head h reading kv
head h // g, so the grouped causal call is one launch over all q heads
instead of JAX's loop over the group; see that file for the design. The
block sizes are checked but do not tile the kernels.

Which kernel a CUDA call launches is a fixed rule on dtype and head width
(``kernel_for``): bfloat16 q, k, v with D == Dv in (64, 128) go to the
tensor-core kernel (wgmma fed by TMA, ``"tc"``); float32, and bfloat16 at
any other width, go to the SIMT kernel (``"simt"``), whose tiles and shared
memory come from ``simt_plan``. The kernels take D a multiple of 16 up to
256 and Dv in ``SIMT_DV`` (every attention width of the repository's LM
configurations: 80, 128, 256, and MLA's D 192 with Dv 128); other widths
raise. A kernel that fails to build or launch raises; there is no second
try on the other one. Both
wrappers count every launch on ``flash_attention.launches`` and each
kernel's on ``flash_attention.tc_launches`` or ``.simt_launches``.

Plain version: ``ref.attention`` (``models.layers.attention``). It runs
only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref


def flash_attention_plain(q, k, v, *, causal: bool = True):
    return ref.attention(q, k, v, causal=causal)


def _check(name, q, k, v, block_q, block_k, fold: bool):
    """JAX's shape assertions; ``fold``: the q-head group is folded into q
    rows (``flash_attention``), not looped (the causal GQA wrapper)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: need (B, S, H, D) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, sk, hkv, dv = v.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d
            or hkv < 1 or hq % hkv):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not form grouped attention")
    g = hq // hkv if fold else 1
    bq = min(block_q, sq) * g
    bk = min(block_k, sk)
    if (sq * g) % bq or sk % bk:
        raise ValueError(f"{name}: blocks ({bq}, {bk}) do not divide "
                         f"Sq * g = {sq * g} and Sk = {sk}")


TC_WIDTHS = (64, 128)
SIMT_DV = (16, 32, 64, 80, 128, 256)   # the SIMT kernel's Dv instances
MAX_D = 256

# The SIMT kernel's fixed shape (csrc/flash_attention.cu, namespace simt):
# 128 threads as 16 row groups x 8 lanes, 4 keys a lane, so 32-key tiles;
# 16-byte pads on the Q, K and P^T rows; __launch_bounds__(128, 3) keeps a
# thread at 168 registers or fewer, so the registers allow 3 blocks an SM.
SIMT_THREADS = 128
SIMT_ROW_GROUPS = 16
SIMT_LANES = 8
SIMT_KEYS = 32
SIMT_PAD = 16
SIMT_REG_BLOCKS = 3
SMEM_BLOCK_MAX = 232448     # dynamic shared bytes a block may have
SMEM_SM = 233472            # shared bytes an SM has for its blocks
SMEM_RESERVED = 1024        # bytes the system keeps for each block


class SimtPlan(NamedTuple):
    """The SIMT kernel's launch plan for one (D, Dv, dtype); the kernel
    checks it (``simt::plan_ok``) and computes the same layout."""
    rows_per_thread: int      # TR: q rows ty + 16 r, r < TR
    rows: int                 # q rows a block
    keys: int                 # keys a kv tile
    threads: int
    smem: int                 # dynamic shared bytes
    blocks_per_sm: int        # what shared memory and registers allow


def check_widths(d: int, dv: int):
    """Raise unless the kernels take head widths D, Dv."""
    if d % 16 or not 16 <= d <= MAX_D or dv not in SIMT_DV:
        raise ValueError(f"flash_attention: the kernels take D a multiple "
                         f"of 16 in [16, {MAX_D}] and Dv in {SIMT_DV}, got "
                         f"D {d}, Dv {dv}")


def simt_layout(d: int, dv: int, rows: int, esize: int) -> dict:
    """Byte offsets of the SIMT kernel's shared arrays: Q fp32 [rows][D+4],
    K [32][D + 16/esize] and V [32][Dv] in the inputs' dtype, P^T fp32
    [32][rows+4] (``simt::layout`` in the .cu)."""
    q = rows * (d + SIMT_PAD // 4) * 4
    k = SIMT_KEYS * (d + SIMT_PAD // esize) * esize
    v = SIMT_KEYS * dv * esize
    p = SIMT_KEYS * (rows + SIMT_PAD // 4) * 4
    return {"q": 0, "k": q, "v": q + k, "p": q + k + v,
            "bytes": q + k + v + p}


def simt_plan(d: int, dv: int, dtype: torch.dtype) -> SimtPlan:
    """Rows, keys, threads and shared bytes of the SIMT kernel at head
    widths D, Dv and q/k/v ``dtype``: 4 rows a thread (64 a block) for
    Dv <= 128, 2 (32 a block) above, where the accumulator would
    otherwise pass 128 registers."""
    check_widths(d, dv)
    esize = {torch.float32: 4, torch.bfloat16: 2}[dtype]
    tr = 4 if dv <= 128 else 2
    rows = SIMT_ROW_GROUPS * tr
    smem = simt_layout(d, dv, rows, esize)["bytes"]
    blocks = min(SMEM_SM // (smem + SMEM_RESERVED), SIMT_REG_BLOCKS)
    return SimtPlan(tr, rows, SIMT_KEYS, SIMT_THREADS, smem, blocks)


def kernel_for(dtype: torch.dtype, d: int, dv: int) -> str:
    """The kernel a CUDA call with q, k, v of ``dtype`` and head widths D,
    Dv launches: ``"tc"`` (tensor cores) or ``"simt"``."""
    if dtype == torch.bfloat16 and d == dv and d in TC_WIDTHS:
        return "tc"
    return "simt"


def _aligned(t):
    """t, or a copy of it whose data is 16-byte aligned (the rule of TMA
    and of the SIMT kernel's 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


_TAIL = [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
SIMT_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6 + _TAIL
TC_ARGTYPES = [ctypes.c_void_p] * 5 + _TAIL


def _check_launch(q, k, v):
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: q, k, v dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype} differ")
    check_widths(q.shape[3], v.shape[3])


def launch_args(q, k, v, causal: bool):
    """``(kernel, args, out, keep)`` for CUDA q, k, v: the kernel
    ``kernel_for`` picks, the arguments of its C entry point
    (``flash_attention_tc_forward`` with ``TC_ARGTYPES`` or
    ``flash_attention_forward`` with ``SIMT_ARGTYPES``), the output they
    write and the tensors that must outlive the launch."""
    _check_launch(q, k, v)
    b, sq, hq, d = q.shape
    _, sk, hkv, dv = v.shape
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    kernel = kernel_for(q.dtype, d, dv)
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=q.device)
    dims = (ctypes.c_int * 7)(b, sq, sk, hq, hkv, d, dv)
    tail = (int(causal), 1.0 / math.sqrt(d), *_build.device_stream(q.device))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dims)
    if kernel == "tc":
        return kernel, (*ptrs, *tail), out, (q, k, v, dims)
    plan = (ctypes.c_int * 5)(*simt_plan(d, dv, q.dtype)[:5])
    args = (_build.dtype_code(q), *ptrs, plan, *tail)
    return kernel, args, out, (q, k, v, dims, plan)


def _launch(q, k, v, causal: bool):
    """One launch of the kernel ``kernel_for`` picks, over all q heads;
    counts it on ``flash_attention``."""
    kernel, args, out, keep = launch_args(q, k, v, causal)
    if out.numel() == 0:
        return out
    if kernel == "tc":
        lib, fn = _build.function("flash_attention",
                                  "flash_attention_tc_forward", ctypes.c_int,
                                  TC_ARGTYPES)
    else:
        lib, fn = _build.function("flash_attention",
                                  "flash_attention_forward", ctypes.c_int,
                                  SIMT_ARGTYPES)
    _build.check(lib, "flash_attention", fn(*args))
    flash_attention.launches += 1
    if kernel == "tc":
        flash_attention.tc_launches += 1
    else:
        flash_attention.simt_launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 256,
                    block_k: int = 256) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D/Dv); returns (B, Sq, Hq, Dv)
    in q's dtype. Causal is top-left aligned (kpos <= qpos) and, as in the
    JAX kernel, only for Hq == Hkv: use ``flash_attention_causal_gqa`` for
    grouped heads. CUDA tensors launch the kernel (or raise); CPU tensors
    run ``flash_attention_plain``."""
    _check("flash_attention", q, k, v, block_q, block_k, fold=True)
    if causal and q.shape[2] != v.shape[2]:
        raise ValueError("flash_attention: causal with grouped q heads; use "
                         "flash_attention_causal_gqa")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    return _launch(q, k, v, causal)


def flash_attention_causal_gqa(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, block_q: int = 256,
                               block_k: int = 256) -> torch.Tensor:
    """Causal grouped-query flash attention, q head h on kv head h // g.
    CUDA tensors launch the kernel once (or raise); CPU tensors run
    ``flash_attention_plain``."""
    _check("flash_attention_causal_gqa", q, k, v, block_q, block_k,
           fold=False)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=True)
    return _launch(q, k, v, True)


flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.simt_launches = 0
