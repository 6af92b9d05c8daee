"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437): a port of
``repro/models/mla.py``.

Queries and KV are projected through low-rank latents; the KV cache stores
only the compressed latent (``kv_lora_rank``) and the shared RoPE key.
Prefill and full-sequence forward use the materialized form (per-head K/V
rebuilt from the latents, then ``layers.attention``); a one-token call
with a cache uses the absorbed form (W_uk folded into the query, W_uv
applied to the attended latent), as the reference does.

The cache ``{'ckv': (B, Smax, kvr), 'krope': (B, Smax, dr)}`` is written
in place at the start JAX's ``dynamic_update_slice`` clamps to
(``transformer._cache_start``); the absorbed form masks on the unclamped
index, as the reference does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common import ParamSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import _cache_start
from repro_torch.parallel.shard_map import SeqShard, heads_local, seq_local
from repro_torch.parallel.sharding import constrain, is_dtensor, split_heads


def mla_specs(cfg: ModelConfig, n: int) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = cfg.torch_dtype
    return {
        "wdq": ParamSpec((n, d, qr), ("layers", "fsdp", None), "normal", dt),
        "q_norm": ParamSpec((n, qr), ("layers", None), "ones", dt),
        "wuq": ParamSpec((n, qr, h * (dn + dr)), ("layers", "fsdp", "tp"), "normal", dt),
        "wdkv": ParamSpec((n, d, kvr), ("layers", "fsdp", None), "normal", dt),
        "kv_norm": ParamSpec((n, kvr), ("layers", None), "ones", dt),
        "wkr": ParamSpec((n, d, dr), ("layers", "fsdp", None), "normal", dt),
        "wuk": ParamSpec((n, kvr, h * dn), ("layers", None, "tp"), "normal", dt),
        "wuv": ParamSpec((n, kvr, h * dv), ("layers", None, "tp"), "normal", dt),
        "wo": ParamSpec((n, h * dv, d), ("layers", "tp_in", "fsdp"), "normal", dt),
    }


def _project_q(cfg, p, x, positions):
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = L.rms_norm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = split_heads(cq @ p["wuq"], h, dn + dr, "act_q_seq", h)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _latents(cfg, p, x, positions):
    ckv = L.rms_norm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)  # (B,S,kvr)
    krope = x @ p["wkr"]                                          # (B,S,dr)
    krope = L.apply_rope(krope[:, :, None, :], positions,
                         cfg.rope_theta)[:, :, 0]
    return ckv, krope


def _write(seq, c_ckv, c_krope, ckv, krope, start: int):
    """The new latents into the rank's share of the cache, in place, from
    position ``start`` (``_cache_start`` of the whole cache)."""
    seq.write(c_ckv, ckv, start)
    seq.write(c_krope, krope, start)


def apply_mla(cfg: ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor, *, kv_cache: Optional[dict] = None,
              cache_index=None):
    """Returns (out, cache or None); ``p`` holds one layer's weights."""
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank

    q_nope, q_rope = _project_q(cfg, p, x, positions)
    ckv, krope = _latents(cfg, p, x, positions)
    if kv_cache is not None:
        start = _cache_start(cache_index, s, kv_cache["ckv"].shape[1])

    if kv_cache is not None and s == 1:
        # ---- absorbed decode, on each rank's batch rows and its share of
        # the cache's positions (every head; flash-decode on a mesh) ----
        def absorbed(seq, q_nope, q_rope, ckv, krope, c_ckv, c_krope, wuk,
                     wuv):
            _write(seq, c_ckv, c_krope, ckv, krope, start)
            cckv, ckr = c_ckv.float(), c_krope.float()
            # fold W_uk into q in the model dtype: (B,1,H,dn) x (kvr,H,dn)
            q_lat = torch.einsum("bshd,khd->bshk", q_nope,
                                 wuk.reshape(kvr, h, dn))
            scores = torch.einsum("bshk,btk->bhst", q_lat.float(), cckv)
            scores = scores + torch.einsum("bshd,btd->bhst", q_rope.float(),
                                           ckr)
            scores = scores * (dn + dr) ** -0.5
            valid = seq.offset + torch.arange(
                cckv.shape[1], device=cckv.device) <= int(cache_index)
            scores = torch.where(valid, scores, L.NEG_INF)
            if seq.split:
                m = scores.amax(dim=-1)
                pr = torch.exp(scores - m[..., None])
                ctx_lat = seq.combine(
                    m.transpose(1, 2), pr.sum(dim=-1).transpose(1, 2),
                    torch.einsum("bhst,btk->bshk", pr, cckv))
            else:
                probs = torch.softmax(scores, dim=-1)
                ctx_lat = torch.einsum("bhst,btk->bshk", probs, cckv)
            o = torch.einsum("bshk,khd->bshd", ctx_lat,
                             wuv.reshape(kvr, h, dv).float())
            return o.to(q_nope.dtype)

        o = seq_local(absorbed, (q_nope, q_rope, ckv, krope,
                                 kv_cache["ckv"], kv_cache["krope"],
                                 p["wuk"], p["wuv"]),
                      ("b", "b", "b", "b", "sw", "sw", None, None))
        o = constrain(o.reshape(b, s, h * dv), ("batch", None, "act_tp"))
        return o @ p["wo"], kv_cache

    # ---- materialized prefill / forward ----
    ckv_full, kr_full, kv_len = ckv, krope, None
    if kv_cache is not None and is_dtensor(kv_cache["ckv"]):
        # a prefill on a mesh: the prompt's own latents, written into the
        # cache's layout (the mesh's prefill starts at 0)
        if int(cache_index):
            raise ValueError("a prefill on a mesh starts at index 0")
        seq_local(lambda seq, *a: _write(seq, *a, start),
                  (kv_cache["ckv"], kv_cache["krope"], ckv, krope),
                  ("sw", "sw", "b", "b"))
    elif kv_cache is not None:
        _write(SeqShard(), kv_cache["ckv"], kv_cache["krope"], ckv, krope,
               start)
        ckv_full, kr_full = kv_cache["ckv"], kv_cache["krope"]
        kv_len = torch.full((b,), int(cache_index) + s, dtype=torch.int32,
                            device=x.device)
    sk = ckv_full.shape[1]
    k_nope = split_heads(ckv_full @ p["wuk"], h, dn, "act_kv_seq", h)
    v = split_heads(ckv_full @ p["wuv"], h, dv, "act_kv_seq", h)
    k = torch.cat([k_nope, kr_full[:, :, None, :].expand(b, sk, h, dr)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = heads_local(lambda q, k, v, kv_len: L.attention(
        q, k, v, causal=True, q_offset=int(cache_index or 0), kv_len=kv_len),
        (q, k, v, kv_len), ("h", "h", "h", "b"))
    o = constrain(o.reshape(b, s, h * dv), ("batch", None, "act_tp"))
    return o @ p["wo"], kv_cache
