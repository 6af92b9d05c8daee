"""Grouped-query attention with online-softmax KV chunking.

A port of ``attention`` and its two paths from ``repro/models/layers.py``;
the rest of that module (norms, MLPs, embeddings) is not ported. It is the
plain version of the flash-attention kernel (``kernels/ref.py`` re-exports
it). Scores are fp32: bf16 operands are widened to fp32 before each
product, which is what JAX's bf16 contraction with an fp32 accumulator
computes (a product of two bf16 values is exact in fp32). Masked scores
are ``NEG_INF`` (-1e30), not -inf, and ``p`` is rounded to v's dtype
before the PV product, as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _mask(sq, kpos, *, causal, window, q_offset, kv_len, device):
    """Boolean mask of valid scores, broadcastable to (B, Hk, G, Sq, Sk)."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]      # (Sq, 1)
    kpos = kpos[None, :]                                              # (1, Sk)
    mask = torch.ones((sq, kpos.shape[1]), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    mask = mask[None, None, None]
    if kv_len is not None:        # (B,) valid prefix lengths (decode w/ cache)
        vmask = kpos[0][None, :] < kv_len[:, None]                    # (B, Sk)
        mask = mask & vmask[:, None, None, None, :]
    return mask


def _direct_attention(q, k, v, *, causal, window, q_offset, kv_len):
    """Reference path for short KV / single-token decode.
    q: (B, Sq, Hk, G, D), k/v: (B, Sk, Hk, D)."""
    sq, d = q.shape[1], q.shape[-1]
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    mask = _mask(sq, torch.arange(sk, device=q.device), causal=causal,
                 window=window, q_offset=q_offset, kv_len=kv_len,
                 device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _chunked_attention(q, k, v, *, causal, window, q_offset, kv_len, chunk):
    """Online-softmax loop over KV chunks (flash-style): never holds the
    (Sq, Sk) score matrix; peak extra memory is (B, Hk, G, Sq, chunk)
    fp32."""
    b, sq, hk, g, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    if sk % chunk:
        raise ValueError(f"Sk {sk} is not a multiple of chunk {chunk}")
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    m = torch.full((b, hk, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hk, g, sq, dv), dtype=torch.float32,
                      device=q.device)
    for start in range(0, sk, chunk):
        kblk = k[:, start:start + chunk]
        vblk = v[:, start:start + chunk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kblk.float()) * scale
        mask = _mask(sq, start + torch.arange(chunk, device=q.device),
                     causal=causal, window=window, q_offset=q_offset,
                     kv_len=kv_len, device=q.device)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vblk.dtype).float(),
                          vblk.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).to(q.dtype)   # (B, Sq, Hk, G, Dv)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset=0, kv_len: Optional[torch.Tensor] = None,
              chunk: int = 1024) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); Hq % Hkv == 0; q head h reads
    kv head h // (Hq // Hkv). Returns (B, Sq, Hq, Dv) in q's dtype. Uses
    online-softmax chunking when Sq > 1, Sk > 2 * chunk and Sk % chunk == 0.
    """
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} q heads do not group onto {hkv} kv heads")
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    if sq > 1 and k.shape[1] > 2 * chunk and k.shape[1] % chunk == 0:
        o = _chunked_attention(qg, k, v, causal=causal, window=window,
                               q_offset=q_offset, kv_len=kv_len, chunk=chunk)
    else:
        o = _direct_attention(qg, k, v, causal=causal, window=window,
                              q_offset=q_offset, kv_len=kv_len)
    return o.reshape(b, sq, hq, o.shape[-1])
