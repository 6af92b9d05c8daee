"""Serving: prefill + single-token decode for every family. A port of
``repro/serve/decode.py``.

The cache's tensors are written in place (the reference's engine donates
its cache to the jitted step, so XLA writes it in place too); the returned
cache holds the same tensors and the next ``index``. Past ``max_len`` a
write lands on the last slot, as JAX's clamped ``dynamic_update_slice``
puts it (``transformer._cache_start``).

Sub-quadratic families carry O(1)-ish state: ``hybrid`` keeps a rolling
window-sized K/V (RecurrentGemma's local attention: position p in slot
p % w, ``slot_pos`` naming the position each slot holds, so decode runs
past the window by overwriting its oldest slot) and the RG-LRU states;
``ssm`` keeps the mLSTM and sLSTM states.

With a ``mesh`` the params are expected on it, the tokens are sharded over
its batch axes, the cache is ``model.init_cache``'s sharded one, and the
logits come back as DTensors; every write into the cache and every
attention over it runs on each rank's batch rows.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import recurrent as REC
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.shard_map import batch_local
from repro_torch.parallel.sharding import constrain, split_heads


# ---------------------------------------------------------------------------
# Rolling-window attention (hybrid decode)
# ---------------------------------------------------------------------------


def _rolling_attn_decode(cfg, p, x, cache_k, cache_v, slot_pos, index: int):
    """x: (B,1,d); cache_k/v: (B,W,Hkv,hd) rope'd at write; slot_pos: (W,).
    Writes the new K/V to slot ``index % W`` and ``index`` to its
    ``slot_pos``, in place; returns the attention's output."""
    b, _, d = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    w = cache_k.shape[1]
    pos = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, hq, hd, None, hq, hkv)
    k = split_heads(k, hkv, hd, None, hq, hkv)
    v = split_heads(v, hkv, hd, None, hq, hkv)
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    slot = index % w

    def attend(q, k, v, cache_k, cache_v, slot_pos):
        bl = q.shape[0]
        cache_k[:, slot] = k[:, 0]
        cache_v[:, slot] = v[:, 0]
        slot_pos[slot] = index
        g = hq // hkv
        qg = q.reshape(bl, hkv, g, hd)
        s = torch.einsum("bhgd,bwhd->bhgw", qg.float(),
                         cache_k.float()) * hd ** -0.5
        valid = (slot_pos >= 0) & (slot_pos <= index) \
            & (slot_pos > index - (cfg.attn_window or 10 ** 9))
        s = torch.where(valid[None, None, None, :], s, L.NEG_INF)
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgw,bwhd->bhgd", pr, cache_v.float())
        return o.reshape(bl, 1, hq * hd).to(q.dtype)

    o = batch_local(attend, (q, k, v, cache_k, cache_v, slot_pos),
                    (True,) * 5 + (False,))
    return o.to(x.dtype) @ p["wo"]


def _fill_rolling_cache(k, v, width: int):
    """k,v: (B,S,Hkv,hd) rope'd at their absolute positions. Returns
    (cache_k, cache_v, slot_pos) of exactly ``width`` slots holding the
    last min(S, width) positions at slot p % width."""
    ck, cv = batch_local(lambda k, v: _fill_rolling_kv(k, v, width), (k, v),
                         (True, True))
    return ck, cv, _slot_positions(k.shape[1], width, k.device)


def _kept(s: int, width: int, device):
    ps = torch.arange(max(s - width, 0), s, device=device)  # last kept
    return ps, ps % width


def _fill_rolling_kv(k, v, width: int):
    b, s, hkv, hd = k.shape
    ps, slots = _kept(s, width, k.device)
    ck = torch.zeros((b, width, hkv, hd), dtype=k.dtype, device=k.device)
    cv = torch.zeros((b, width, hkv, hd), dtype=v.dtype, device=v.device)
    ck[:, slots] = k[:, ps]
    cv[:, slots] = v[:, ps]
    return ck, cv


def _slot_positions(s: int, width: int, device):
    ps, slots = _kept(s, width, device)
    slot_pos = torch.full((width,), -1, dtype=torch.int32, device=device)
    slot_pos[slots] = ps.to(torch.int32)
    return slot_pos


def _hybrid_layers(cfg, params, x, positions, cache, index: int,
                   prefill: bool):
    """The hybrid family's layers against ``cache`` (written in place):
    the RG-LRU blocks carry their states; the attention layers fill the
    rolling cache from the prompt (prefill) or attend to it (decode)."""
    w = cache["k"].shape[2]
    ai = ri = 0
    for kind, p in M.hybrid_layers(cfg, params):
        if kind == "rec":
            st = M.layer_state(cache, "rglru", ri)
            x, nst = REC.apply_rglru_block(cfg, p, x, state=st)
            M.store_state(st, nst)
            ri += 1
            continue
        xr = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        if prefill:
            o, kv = T.apply_attn(cfg, p["attn"], xr, positions,
                                 window=cfg.attn_window, return_kv=True)
            ck, cv, sp = _fill_rolling_cache(kv["k"], kv["v"], w)
            cache["k"][ai].copy_(ck)
            cache["v"][ai].copy_(cv)
            cache["slot_pos"].copy_(sp)
        else:
            o = _rolling_attn_decode(cfg, p["attn"], xr, cache["k"][ai],
                                     cache["v"][ai], cache["slot_pos"], index)
        x = x + o
        x = x + L.swiglu_mlp(L.rms_norm(x, p["ln2"], cfg.norm_eps),
                             p["mlp"]["w_gate"], p["mlp"]["w_up"],
                             p["mlp"]["w_down"])
        ai += 1
    return x


def _layers(cfg: ModelConfig, params, x, positions, cache, index: int,
            prefill: bool, mesh=None):
    """Every layer against ``cache`` (written in place) from ``index``."""
    if cfg.family == "moe":
        x, _ = M.moe_layers(cfg, params, x, positions, mesh, cache=cache,
                            cache_index=index)
        return x
    if cfg.family == "hybrid":
        return _hybrid_layers(cfg, params, x, positions, cache, index,
                              prefill)
    if cfg.family == "ssm":
        return M.xlstm_layers(cfg, params, x, cache=cache)
    if cfg.family in ("dense", "vlm"):
        x, _ = T.scan_dense_blocks(cfg, params["blocks"], x, positions,
                                   kv_cache={"k": cache["k"],
                                             "v": cache["v"]},
                                   cache_index=index)
        return x
    raise ValueError(cfg.family)


def decode_step(cfg: ModelConfig, params, tokens, cache, mesh=None):
    """tokens: (B, 1) integers -> (logits (B, 1, V), cache with index + 1)."""
    if mesh is None:
        return _decode_step(cfg, params, tokens, cache, None)
    with SH.replicate_plain():
        tokens = SH.place_batch({"tokens": tokens}, mesh)["tokens"]
        return _decode_step(cfg, params, tokens, cache, mesh)


def _decode_step(cfg, params, tokens, cache, mesh):
    idx = int(cache["index"])
    x = L.embed(tokens, params["embed"])
    pos = torch.full((x.shape[0], 1), idx, dtype=torch.int32, device=x.device)
    x = constrain(x, ("batch", None, None))
    x = _layers(cfg, params, x, pos, cache, idx, prefill=False, mesh=mesh)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return M.unembed_logits(cfg, params, x), dict(cache, index=idx + 1)


def prefill(cfg: ModelConfig, params, batch, max_len: int, mesh=None):
    """Run the prompt through the model, returning (last_logits, cache).

    max_len is the cache capacity (>= prompt length); decode_step then
    appends from cache['index'] onward.
    """
    if mesh is None:
        return _prefill(cfg, params, batch, max_len, None)
    with SH.replicate_plain():
        return _prefill(cfg, params, SH.place_batch(batch, mesh), max_len,
                        mesh)


def _prefill(cfg, params, batch, max_len, mesh):
    x = M.embed_inputs(cfg, params, batch)
    b, s = x.shape[:2]
    positions = M.positions_for(cfg, x)
    cache = M.init_cache(cfg, b, max_len, device=x.device, mesh=mesh)
    x = _layers(cfg, params, x, positions, cache, 0, prefill=True, mesh=mesh)
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return M.unembed_logits(cfg, params, x), dict(cache, index=s)
