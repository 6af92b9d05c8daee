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
from repro_torch.parallel.shard_map import batch_local, heads_local
from repro_torch.parallel.sharding import constrain


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
    q = (cq @ p["wuq"]).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _latents(cfg, p, x, positions):
    ckv = L.rms_norm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)  # (B,S,kvr)
    krope = x @ p["wkr"]                                          # (B,S,dr)
    krope = L.apply_rope(krope[:, :, None, :], positions,
                         cfg.rope_theta)[:, :, 0]
    return ckv, krope


def _write(cache: dict, ckv, krope, cache_index: int):
    s = ckv.shape[1]
    start = _cache_start(cache_index, s, cache["ckv"].shape[1])
    cache["ckv"][:, start:start + s] = ckv
    cache["krope"][:, start:start + s] = krope


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

    if kv_cache is not None and s == 1:
        # ---- absorbed decode, on each rank's batch rows and heads ----
        def absorbed(q_nope, q_rope, ckv, krope, c_ckv, c_krope, wuk, wuv):
            _write({"ckv": c_ckv, "krope": c_krope}, ckv, krope, cache_index)
            cckv, ckr = c_ckv.float(), c_krope.float()
            # fold W_uk into q in the model dtype: (B,1,H,dn) x (kvr,H,dn)
            q_lat = torch.einsum("bshd,khd->bshk", q_nope, wuk)
            scores = torch.einsum("bshk,btk->bhst", q_lat.float(), cckv)
            scores = scores + torch.einsum("bshd,btd->bhst", q_rope.float(),
                                           ckr)
            scores = scores * (dn + dr) ** -0.5
            valid = torch.arange(cckv.shape[1],
                                 device=cckv.device) <= int(cache_index)
            scores = torch.where(valid, scores, L.NEG_INF)
            probs = torch.softmax(scores, dim=-1)
            ctx_lat = torch.einsum("bhst,btk->bshk", probs, cckv)
            o = torch.einsum("bshk,khd->bshd", ctx_lat, wuv.float())
            return o.to(q_nope.dtype)

        o = heads_local(absorbed, (q_nope, q_rope, ckv, krope,
                                   kv_cache["ckv"], kv_cache["krope"],
                                   p["wuk"].reshape(kvr, h, dn),
                                   p["wuv"].reshape(kvr, h, dv)),
                        ("h", "h", "b", "b", "bw", "bw", "w1", "w1"))
        o = constrain(o.reshape(b, s, h * dv), ("batch", None, "act_tp"))
        return o @ p["wo"], kv_cache

    # ---- materialized prefill / forward ----
    if kv_cache is not None:
        def write(c_ckv, c_krope, ckv, krope):
            _write({"ckv": c_ckv, "krope": c_krope}, ckv, krope, cache_index)
            return c_ckv, c_krope

        ckv_full, kr_full = batch_local(
            write, (kv_cache["ckv"], kv_cache["krope"], ckv, krope),
            (True,) * 4)
        kv_len = torch.full((b,), int(cache_index) + s, dtype=torch.int32,
                            device=x.device)
    else:
        ckv_full, kr_full, kv_len = ckv, krope, None
    sk = ckv_full.shape[1]
    k_nope = (ckv_full @ p["wuk"]).reshape(b, sk, h, dn)
    v = (ckv_full @ p["wuv"]).reshape(b, sk, h, dv)
    k = torch.cat([k_nope, kr_full[:, :, None, :].expand(b, sk, h, dr)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = heads_local(lambda q, k, v, kv_len: L.attention(
        q, k, v, causal=True, q_offset=int(cache_index or 0), kv_len=kv_len),
        (q, k, v, kv_len), ("h", "h", "h", "b"))
    o = constrain(o.reshape(b, s, h * dv), ("batch", None, "act_tp"))
    return o @ p["wo"], kv_cache
