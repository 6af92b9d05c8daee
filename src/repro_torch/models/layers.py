"""Shared model layers: RMSNorm, LayerNorm, RoPE, grouped-query attention
(online-softmax chunked for long sequences), SwiGLU and GELU MLPs,
embeddings, logits and the cross-entropy loss. A port of
``repro/models/layers.py``; pure functions of tensors.

The reference's sharding annotations (``constrain``, ``gathered``) stand
at its sites: on DTensors they redistribute, on plain tensors they do
nothing. ``attention`` is also the plain version
of the flash-attention kernel (``kernels/ref.py`` re-exports it). Its
scores are fp32: bf16 operands are widened to fp32 before each product,
which is what JAX's bf16 contraction with an fp32 accumulator computes (a
product of two bf16 values is exact in fp32). Masked scores are
``NEG_INF`` (-1e30), not -inf, and ``p`` is rounded to v's dtype before the
PV product, as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.parallel import shard_map as SM
from repro_torch.parallel.shard_map import batch_local
from repro_torch.parallel.sharding import (constrain, gathered, is_dtensor,
                                           mesh_axes)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms: fp32 inside, cast back (layers.py:25-41)
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


# ---------------------------------------------------------------------------
# RoPE: the head's two halves rotate together, not interleaved pairs
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integers. Angles are fp32
    ``positions * 1/theta^(2i/D)``."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)                 # (D/2,)
    angles = positions[..., None].float() * freqs                 # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Grouped-query attention with online-softmax KV chunking
# ---------------------------------------------------------------------------


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


def seq_attention(seq, q, k, v, *, causal: bool = True,
                  window: Optional[int] = None, q_offset=0,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``attention`` of q against a cache share: ``seq`` is the rank's
    ``shard_map.SeqShard`` (k, v hold positions ``seq.offset`` on). On a
    split cache each rank takes its keys' partial softmax and
    ``seq.combine`` sums them over model (flash-decode); else this is
    ``attention`` itself."""
    if not seq.split:
        return attention(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, kv_len=kv_len)
    b, sq, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) \
        * (1.0 / math.sqrt(d))
    kpos = seq.offset + torch.arange(k.shape[1], device=q.device)
    mask = _mask(sq, kpos, causal=causal, window=window, q_offset=q_offset,
                 kv_len=kv_len, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    o = seq.combine(m, p.sum(dim=-1), o)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP / embeddings
# ---------------------------------------------------------------------------


def swiglu_mlp(x, w_gate, w_up, w_down):
    """SwiGLU: silu(x W_g) * (x W_u) W_d, with TP sharding on d_ff and
    the FSDP weights gathered at the use site."""
    w_gate = gathered(w_gate, ("fsdp", "tp"))
    w_up = gathered(w_up, ("fsdp", "tp"))
    w_down = gathered(w_down, ("tp_in", "fsdp"))
    h = F.silu(x @ w_gate) * (x @ w_up)
    h = constrain(h, ("batch", "act_q_seq", "act_tp"))
    return h @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    """``jax.nn.gelu`` defaults to the tanh approximation; PyTorch's
    default is the exact erf form."""
    h = F.gelu(x @ w_in + b_in, approximate="tanh")
    h = constrain(h, ("batch", None, "act_tp"))
    return h @ w_out + b_out


def embed(tokens, table):
    """tokens: (B, S) integers -> (B, S, D). On a mesh the lookup (and
    its backward's scatter-add) runs on each rank's batch rows against the
    whole table: DTensor has no working strategy for that ``index_put``
    on a sharded table in every release."""
    return batch_local(_lookup, (tokens, table), (True, False))


def _lookup(tokens, table):
    return table[tokens.long()]


def logits(x, unembed_table, real_vocab: Optional[int] = None):
    """x: (B, S, D) @ (D, Vpad) -> (B, S, Vpad); padded entries are set to
    ``NEG_INF`` (-1e30), not -inf, as in the reference. On a mesh the
    table's FSDP dim is gathered first, as at every other weight's use:
    left to DTensor, the product of batch-sharded rows with a table
    sharded over the same axis gathers the rows instead (every rank's
    logits, 1.3 TB a device at recurrentgemma-2b's train_4k)."""
    out = x @ gathered(unembed_table, ("embed_d", "embed_vocab"))
    out = constrain(out, ("batch", None, "embed_vocab"))
    if real_vocab is not None and real_vocab < out.shape[-1]:
        col = torch.arange(out.shape[-1], device=out.device)
        out = torch.where(col < real_vocab, out, NEG_INF)
    return out


def cross_entropy_loss(lgts, labels, real_vocab: int):
    """Mean next-token CE over valid labels (label == -1 is padding). On a
    mesh whose model axis shards the vocab, each rank reduces its own
    share of it (``_vocab_parallel_ce``)."""
    if is_dtensor(lgts):
        n = mesh_axes(lgts.device_mesh).get("model", 1)
        if n > 1 and lgts.shape[-1] % n == 0:
            return _vocab_parallel_ce(lgts, labels)
    return _gathered_ce(lgts, labels)


def _gathered_ce(lgts, labels):
    # the vocab dim is gathered first: DTensor's gather from vocab-sharded
    # logits (its masked partial) fails on this (B, S, V) layout
    lgts = constrain(lgts, ("batch", None, None)).float()
    lse = torch.logsumexp(lgts, dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    picked = torch.gather(lgts, -1, safe[..., None])[..., 0]
    nll = (lse - picked) * valid
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def _vocab_parallel_ce(lgts, labels):
    """``cross_entropy_loss`` on each rank's rows and share of the vocab:
    the log-sum-exp from one ``pmax`` of the rows' maxima (a constant for
    the gradient) and one ``psum`` of the shifted sums over model, the
    label's logit picked on the rank that holds it and summed over model,
    the sums over the batch axes. Gathering the vocab instead holds every
    rank's full-vocab logits in fp32: 67 GB a copy at recurrentgemma-2b's
    train_4k on 16x16."""
    mesh = lgts.device_mesh
    bspec = SM.batch_spec(mesh, lgts.shape)
    rows = bspec[0] if bspec else None
    batch_axes = () if rows is None else (
        rows if isinstance(rows, tuple) else (rows,))

    def body(axes, lg, lab):
        lg = lg.float()
        width = lg.shape[-1]
        v0 = axes.index("model") * width
        m = SM.pmax(lg.detach().amax(dim=-1), axes, "model")
        lse = m + torch.log(SM.psum(torch.exp(lg - m[..., None]).sum(-1),
                                    axes, "model"))
        mine = (lab >= v0) & (lab < v0 + width)
        idx = torch.where(mine, lab - v0, 0).long()
        picked = SM.psum(torch.where(
            mine, torch.gather(lg, -1, idx[..., None])[..., 0], 0.0),
            axes, "model")
        valid = lab >= 0
        nll = ((lse - picked) * valid).sum()
        count = valid.sum().to(nll.dtype)
        if batch_axes:
            nll = SM.psum(nll, axes, batch_axes)
            count = SM.psum(count, axes, batch_axes)
        return nll, count

    nll, count = SM.shard_map(body, mesh, ((rows, None, "model"),
                                           (rows, None)), ((), ()))(
        lgts, labels)
    return nll / torch.clamp(count, min=1)
