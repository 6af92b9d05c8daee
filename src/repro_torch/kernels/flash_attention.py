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
any other width, go to the SIMT kernel (``"simt"``). A kernel that fails to
build or launch raises; there is no second try on the other one. Both
wrappers count every launch on ``flash_attention.launches`` and each
kernel's on ``flash_attention.tc_launches`` or ``.simt_launches``.

Plain version: ``ref.attention`` (``models.layers.attention``). It runs
only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math

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


def kernel_for(dtype: torch.dtype, d: int, dv: int) -> str:
    """The kernel a CUDA call with q, k, v of ``dtype`` and head widths D,
    Dv launches: ``"tc"`` (tensor cores) or ``"simt"``."""
    if dtype == torch.bfloat16 and d == dv and d in TC_WIDTHS:
        return "tc"
    return "simt"


def _aligned(t):
    """t, or a copy of it whose data is 16-byte aligned (TMA's rule)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, causal: bool):
    """One launch of the kernel ``kernel_for`` picks, over all q heads;
    counts it on ``flash_attention``."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: q, k, v dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype} differ")
    b, sq, hq, d = q.shape
    _, sk, hkv, dv = v.shape
    if not 1 <= d <= 128 or dv not in (16, 32, 64, 128):
        raise ValueError(f"flash_attention: the kernel takes head widths "
                         f"D <= 128 and Dv in (16, 32, 64, 128), got D {d}, "
                         f"Dv {dv}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    dims = (ctypes.c_int * 7)(b, sq, sk, hq, hkv, d, dv)
    tail = [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    args = (out.data_ptr(), dims, int(causal), 1.0 / math.sqrt(d),
            *_build.device_stream(q.device))
    kernel = kernel_for(q.dtype, d, dv)
    if kernel == "tc":
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        lib, fn = _build.function(
            "flash_attention", "flash_attention_tc_forward", ctypes.c_int,
            [ctypes.c_void_p] * 5 + tail)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *args)
    else:
        lib, fn = _build.function(
            "flash_attention", "flash_attention_forward", ctypes.c_int,
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + tail)
        err = fn(_build.dtype_code(q), q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), *args)
    _build.check(lib, "flash_attention", err)
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
