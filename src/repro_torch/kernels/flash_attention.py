"""``flash_attention`` and ``flash_attention_causal_gqa``: one CUDA kernel.

Replace the Pallas kernels ``repro/kernels/flash_attention.py::
flash_attention`` and ``::flash_attention_causal_gqa``, with their
signatures and their checks: a call the JAX functions reject (a block size
that does not divide the sequence, causal attention with grouped q heads
through ``flash_attention``) raises here too. ``csrc/flash_attention.cu``
runs one thread block per (batch, q head, 64-row q tile) with q head h
reading kv head h // g, so the grouped causal call is one launch over all q
heads instead of JAX's loop over the group; see that file for the design.
The block sizes are checked but do not tile the kernel. Both wrappers count
their launches on ``flash_attention.launches`` (one kernel).

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


def _launch(q, k, v, causal: bool):
    """One launch of the kernel over all q heads; counts it on
    ``flash_attention``."""
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
    lib, fn = _build.function(
        "flash_attention", "flash_attention_forward", ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 5
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    dims = (ctypes.c_int * 7)(b, sq, sk, hq, hkv, d, dv)
    err = fn(_build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), dims, int(causal), 1.0 / math.sqrt(d),
             *_build.device_stream(q.device))
    _build.check(lib, "flash_attention", err)
    flash_attention.launches += 1
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
