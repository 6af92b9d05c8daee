"""Top-level model assembly: a port of ``repro/models/model.py``.

API (pure functions of (cfg, params, ...)):
  param_specs(cfg)                       -> ParamSpec tree, every family
  forward(cfg, params, batch, mesh=None) -> (logits, aux_loss)
  init_cache_shapes(cfg, batch, maxlen)  -> tree of "meta" tensors
  init_cache(cfg, batch, maxlen, device) -> zeroed cache, index 0

Every family runs: ``dense``, ``vlm`` and ``audio`` (the stacked
transformer blocks), ``moe`` (MoE and MLA: ``moe_layers``), ``hybrid``
(RG-LRU blocks and local attention: ``hybrid_layers``) and ``ssm`` (sLSTM
and mLSTM blocks: ``xlstm_layers``).

The cache's ``index`` is a Python int, not a device scalar: slicing the
cache needs it on the host, and a device scalar would cost a sync a step.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.common import ParamSpec, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import recurrent as REC
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.sharding import constrain

# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def _embedding_specs(cfg: ModelConfig) -> dict:
    dt = cfg.torch_dtype
    s = {
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model),
                           ("embed_vocab", "embed_d"), "normal", dt),
        "final_norm": ParamSpec((cfg.d_model,), (None,), "ones", dt),
    }
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((cfg.d_model, cfg.padded_vocab),
                                 ("embed_d", "embed_vocab"), "normal", dt)
    return s


def _hybrid_layout(cfg: ModelConfig):
    """(n_super, remainder_pattern) for pattern-tiled hybrid archs."""
    pat = cfg.block_pattern
    n_super = cfg.num_layers // len(pat)
    rem = cfg.num_layers - n_super * len(pat)
    return n_super, pat[:rem]


def _xlstm_layout(cfg: ModelConfig):
    """xlstm: superblock = 1 sLSTM + (slstm_every-1) mLSTM."""
    per = cfg.slstm_every
    if cfg.num_layers % per:
        raise ValueError(f"{cfg.num_layers} layers do not tile by {per}")
    return cfg.num_layers // per, per - 1


def _dense_pair_specs(cfg: ModelConfig, n: int, attn_fn, ffn: dict) -> dict:
    dt = cfg.torch_dtype
    return {"ln1": ParamSpec((n, cfg.d_model), ("layers", None), "ones", dt),
            "ln2": ParamSpec((n, cfg.d_model), ("layers", None), "ones", dt),
            "attn": attn_fn(cfg, n), **ffn}


def param_specs(cfg: ModelConfig) -> dict:
    specs: Dict[str, Any] = _embedding_specs(cfg)
    n = cfg.num_layers
    dt = cfg.torch_dtype
    if cfg.family in ("dense", "vlm", "audio"):
        specs["blocks"] = T.block_specs(cfg, n)
        if cfg.family == "vlm":
            specs["projector"] = {
                "w1": ParamSpec((cfg.frontend_dim, cfg.d_model), (None, "fsdp"), "normal", dt),
                "b1": ParamSpec((cfg.d_model,), (None,), "zeros", dt),
                "w2": ParamSpec((cfg.d_model, cfg.d_model), ("fsdp", None), "normal", dt),
                "b2": ParamSpec((cfg.d_model,), (None,), "zeros", dt),
            }
        if cfg.family == "audio":
            specs["frontend_proj"] = ParamSpec(
                (cfg.frontend_dim, cfg.d_model), (None, "fsdp"), "normal", dt)
    elif cfg.family == "moe":
        nd, nm = cfg.num_dense_layers, n - cfg.num_dense_layers
        ep = cfg.num_experts % 16 == 0  # production model-axis = 16
        attn_fn = MLA.mla_specs if cfg.use_mla else T.attn_specs
        if nd:
            specs["dense_blocks"] = _dense_pair_specs(
                cfg, nd, attn_fn, {"mlp": T.mlp_specs(cfg, nd)})
        specs["moe_blocks"] = _dense_pair_specs(
            cfg, nm, attn_fn, {"moe": MOE.moe_specs(cfg, nm, ep)})
        if cfg.mtp_depth:
            specs["mtp"] = {
                "proj": ParamSpec((2 * cfg.d_model, cfg.d_model), ("fsdp", None),
                                  "normal", dt),
                "ln": ParamSpec((cfg.d_model,), (None,), "ones", dt),
                "block": _dense_pair_specs(cfg, 1, attn_fn,
                                           {"mlp": T.mlp_specs(cfg, 1)}),
            }
    elif cfg.family == "hybrid":
        n_super, rem = _hybrid_layout(cfg)
        super_specs = {}
        for j, kind in enumerate(cfg.block_pattern):
            if kind == "rec":
                super_specs[f"l{j}_rec"] = REC.rglru_specs(cfg, n_super)
            else:
                super_specs[f"l{j}_attn"] = T.block_specs(cfg, n_super)
        specs["superblocks"] = super_specs
        for j, kind in enumerate(rem):
            specs[f"rem{j}"] = (REC.rglru_specs(cfg, 1) if kind == "rec"
                                else T.block_specs(cfg, 1))
    elif cfg.family == "ssm":
        n_super, n_m = _xlstm_layout(cfg)
        specs["superblocks"] = {
            "slstm": REC.slstm_specs(cfg, n_super),
            "mlstm": REC.mlstm_specs(cfg, n_super * n_m),  # (n_super*n_m) flat
        }
    else:
        raise ValueError(cfg.family)
    return specs


# ---------------------------------------------------------------------------
# Input embedding per family
# ---------------------------------------------------------------------------


def embed_inputs(cfg: ModelConfig, params, batch) -> torch.Tensor:
    if cfg.family == "vlm":
        txt = L.embed(batch["tokens"], params["embed"])
        pj = params["projector"]
        # jax.nn.gelu's default is the tanh approximation
        vis = F.gelu(batch["patch_embeds"].to(cfg.torch_dtype) @ pj["w1"]
                     + pj["b1"], approximate="tanh")
        vis = vis @ pj["w2"] + pj["b2"]
        x = torch.cat([vis, txt], dim=1)
    elif cfg.family == "audio":
        x = batch["frames"].to(cfg.torch_dtype) @ params["frontend_proj"]
    else:
        x = L.embed(batch["tokens"], params["embed"])
    return constrain(x, ("batch", "act_q_seq", None))


def positions_for(cfg, x, offset=0):
    b, s = x.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=x.device)
    return offset + pos.expand(b, s)


# ---------------------------------------------------------------------------
# Forward (train / full-sequence)
# ---------------------------------------------------------------------------


def _attn_fn(cfg: ModelConfig):
    return MLA.apply_mla if cfg.use_mla else T.apply_attn


def _dense_block(cfg, p, x, positions, *, kv_cache=None, cache_index=None):
    """A leading dense block of the moe family: MLA or GQA, then SwiGLU."""
    h, _ = _attn_fn(cfg)(cfg, p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
                         positions, kv_cache=kv_cache, cache_index=cache_index)
    x = x + h
    x = x + L.swiglu_mlp(L.rms_norm(x, p["ln2"], cfg.norm_eps),
                         p["mlp"]["w_gate"], p["mlp"]["w_up"],
                         p["mlp"]["w_down"])
    return constrain(x, ("batch", None, None))


def _moe_block(cfg, p, x, positions, mesh=None, *, kv_cache=None,
               cache_index=None):
    """MLA or GQA, then the routed experts and the shared expert on the
    same normed input -> (x, aux)."""
    h, _ = _attn_fn(cfg)(cfg, p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
                         positions, kv_cache=kv_cache, cache_index=cache_index)
    x = x + h
    xn = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = MOE.apply_moe(cfg, p["moe"], xn, mesh)
    if cfg.num_shared_experts:
        sh = p["moe"]["shared"]
        y = y + L.swiglu_mlp(xn, sh["wg"], sh["wu"], sh["wd"])
    return constrain(x + y, ("batch", None, None)), aux


def moe_layers(cfg: ModelConfig, params, x, positions, mesh=None, *,
               cache=None, cache_index=None):
    """The moe family's layers in order: ``num_dense_layers`` dense blocks,
    then the MoE blocks (the MTP module does not run here, as in the
    reference); without a cache each layer is one remat unit. ``cache``
    holds the stacked ``d_*`` / ``m_*`` leaves, written in place. Returns
    (x, aux summed over the MoE layers)."""
    keys = ("ckv", "krope") if cfg.use_mla else ("k", "v")

    def layer_cache(pre, i):
        return (None if cache is None else
                {k: cache[f"{pre}_{k}"][i] for k in keys})

    def dense(xv, p, i):
        return _dense_block(cfg, p, xv, positions,
                            kv_cache=layer_cache("d", i),
                            cache_index=cache_index)

    def moe(xv, p, i):
        return _moe_block(cfg, p, xv, positions, mesh,
                          kv_cache=layer_cache("m", i),
                          cache_index=cache_index)

    if cache is None:       # one remat unit a layer, the reference's scan body
        dense, moe = T._maybe_remat(dense, cfg), T._maybe_remat(moe, cfg)
    for i in range(cfg.num_dense_layers):
        x = dense(x, T.layer_params(params["dense_blocks"], i), i)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers - cfg.num_dense_layers):
        x, aux = moe(x, T.layer_params(params["moe_blocks"], i), i)
        aux_total = aux_total + aux
    return x, aux_total


def hybrid_layers(cfg: ModelConfig, params) -> list:
    """The hybrid family's layers in order as (kind, per-layer params):
    the superblocks' pattern ``n_super`` times, then the remainder layers
    ``rem{j}`` (the reference's ``_hybrid_pattern_list`` and
    ``_hybrid_layer_params``, serve/decode.py:371-387)."""
    n_super, rem = _hybrid_layout(cfg)
    sb = params["superblocks"]
    out = []
    for s in range(n_super):
        for j, kind in enumerate(cfg.block_pattern):
            key = f"l{j}_rec" if kind == "rec" else f"l{j}_attn"
            out.append((kind, T.layer_params(sb[key], s)))
    for j, kind in enumerate(rem):
        out.append((kind, T.layer_params(params[f"rem{j}"], 0)))
    return out


# each recurrent block's state keys -> the stacked cache's keys
STATE_KEYS = {"rglru": {"h": "lru_h", "conv": "conv"},
              "mlstm": {"C": "m_C", "n": "m_n", "m": "m_m", "conv": "m_conv"},
              "slstm": {"h": "s_h", "c": "s_c", "n": "s_n", "m": "s_m"}}


def layer_state(cache, kind: str, i: int):
    """Views of recurrent layer ``i``'s state of ``kind`` in the stacked
    ``cache``, under the block's keys (None without a cache)."""
    if cache is None:
        return None
    return {k: cache[v][i] for k, v in STATE_KEYS[kind].items()}


def store_state(views, new):
    """Write a block's new state into the cache's views of it (a leaf the
    block updated in place is already there)."""
    if views is None:
        return
    for key, t in new.items():
        if t is not views[key]:
            views[key].copy_(t)


def xlstm_layers(cfg: ModelConfig, params, x, *, cache=None):
    """The ssm family's layers in order: each superblock is one sLSTM, then
    ``slstm_every - 1`` mLSTM from the flat ``mlstm`` stack, and without
    a cache one remat unit (the reference's scan body). ``cache`` holds
    the stacked ``s_*`` and ``m_*`` states, read and written in place."""
    n_super, n_m = _xlstm_layout(cfg)
    sb = params["superblocks"]

    def superblock(xv, si):
        st = layer_state(cache, "slstm", si)
        xv, nst = REC.apply_slstm_block(
            cfg, T.layer_params(sb["slstm"], si), xv, state=st)
        store_state(st, nst)
        for mi in range(si * n_m, (si + 1) * n_m):
            st = layer_state(cache, "mlstm", mi)
            xv, nst = REC.apply_mlstm_block(
                cfg, T.layer_params(sb["mlstm"], mi), xv, state=st)
            store_state(st, nst)
        return xv

    if cache is None:       # one remat unit a superblock
        superblock = T._maybe_remat(superblock, cfg)
    for si in range(n_super):
        x = superblock(x, si)
    return x


def forward(cfg: ModelConfig, params, batch, mesh=None, return_hidden=False):
    """Full-sequence forward -> (logits, aux_loss). With a ``mesh`` the
    params are expected on it (``parallel.sharding.shard_tree``), the
    batch is sharded over its batch axes, and the logits (or hidden
    states) come back as DTensors."""
    if mesh is None:
        return _forward(cfg, params, batch, None, return_hidden)
    with SH.replicate_plain():
        return _forward(cfg, params, SH.place_batch(batch, mesh), mesh,
                        return_hidden)


def _forward(cfg, params, batch, mesh, return_hidden):
    x = embed_inputs(cfg, params, batch)
    positions = positions_for(cfg, x)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("dense", "vlm", "audio"):
        x, _ = T.scan_dense_blocks(cfg, params["blocks"], x, positions)
    elif cfg.family == "moe":
        x, aux_total = moe_layers(cfg, params, x, positions, mesh)
    elif cfg.family == "hybrid":
        layers = hybrid_layers(cfg, params)
        per = len(cfg.block_pattern)
        n_super = _hybrid_layout(cfg)[0]

        def run(xv, group):
            for kind, p in group:
                if kind == "rec":
                    xv, _ = REC.apply_rglru_block(cfg, p, xv)
                else:
                    xv, _ = T.apply_block(cfg, p, xv, positions,
                                          window=cfg.attn_window)
            return xv

        superblock = T._maybe_remat(run, cfg)   # the remainder runs plain
        for s in range(n_super):
            x = superblock(x, layers[s * per:(s + 1) * per])
        x = run(x, layers[n_super * per:])
    elif cfg.family == "ssm":
        x = xlstm_layers(cfg, params, x)
    else:
        raise ValueError(cfg.family)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, aux_total
    return unembed_logits(cfg, params, x), aux_total


def unembed_logits(cfg: ModelConfig, params, x):
    unembed = (params["embed"].T if cfg.tie_embeddings else params["unembed"])
    return L.logits(x, unembed, cfg.vocab_size)


# ---------------------------------------------------------------------------
# KV / state caches
# ---------------------------------------------------------------------------


def init_cache_shapes(cfg: ModelConfig, batch_size: int, max_len: int):
    """The decode cache as "meta" tensors (shapes and dtypes, nothing
    allocated), with the reference's dtypes: K/V, latents and conv states
    in the configuration's dtype, recurrent states fp32, ``index`` and the
    hybrid's ``slot_pos`` int32."""
    return {key: torch.empty(shape, dtype=dtype, device="meta")
            for key, (shape, dtype) in cache_layout(
                cfg, batch_size, max_len).items()}


def cache_layout(cfg: ModelConfig, batch_size: int, max_len: int):
    """``{key: (shape, dtype)}`` of the decode cache
    (``init_cache_shapes`` without the tensors)."""
    f32 = torch.float32

    def meta(shape, dtype=cfg.torch_dtype):
        return tuple(shape), dtype

    cache: Dict[str, Any] = {"index": meta((), torch.int32)}
    if cfg.family in ("dense", "vlm"):
        shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads,
                 cfg.hd)
        cache["k"], cache["v"] = meta(shape), meta(shape)
    elif cfg.family == "moe":
        nd = cfg.num_dense_layers
        widths = ({"ckv": (cfg.kv_lora_rank,),
                   "krope": (cfg.qk_rope_head_dim,)} if cfg.use_mla else
                  {"k": (cfg.num_kv_heads, cfg.hd),
                   "v": (cfg.num_kv_heads, cfg.hd)})
        for pre, cnt in (("d", nd), ("m", cfg.num_layers - nd)):
            if cnt:
                for key, w in widths.items():
                    cache[f"{pre}_{key}"] = meta(
                        (cnt, batch_size, max_len) + w)
    elif cfg.family == "hybrid":
        n_super, rem = _hybrid_layout(cfg)
        kinds = list(cfg.block_pattern) * n_super + list(rem)
        n_attn, n_rec = kinds.count("attn"), kinds.count("rec")
        w = min(max_len, cfg.attn_window or max_len)    # a rolling window
        shape = (n_attn, batch_size, w, cfg.num_kv_heads, cfg.hd)
        cache["k"], cache["v"] = meta(shape), meta(shape)
        cache["slot_pos"] = meta((w,), torch.int32)
        cache["lru_h"] = meta((n_rec, batch_size, cfg.lru_width), f32)
        cache["conv"] = meta((n_rec, batch_size, cfg.conv1d_width - 1,
                              cfg.lru_width))
    elif cfg.family == "ssm":
        inner = 2 * cfg.d_model
        h, dh = cfg.num_heads, inner // cfg.num_heads
        n_super, n_m = _xlstm_layout(cfg)
        nm = n_super * n_m
        cache["m_C"] = meta((nm, batch_size, h, dh, dh), f32)
        cache["m_n"] = meta((nm, batch_size, h, dh), f32)
        cache["m_m"] = meta((nm, batch_size, h), f32)
        cache["m_conv"] = meta((nm, batch_size, cfg.conv1d_width - 1, inner))
        for key in ("s_h", "s_c", "s_n", "s_m"):
            cache[key] = meta((n_super, batch_size, cfg.d_model), f32)
    else:
        raise ValueError(cfg.family)
    return cache


def cache_logical_axes(cfg: ModelConfig):
    """Logical sharding axes of each cache entry (the reference's
    ``cache_logical_axes``): the K/V and MLA latents' sequence on
    ``kv_seq`` (over ``model``), the hybrid's rolling window on the batch
    only, the recurrent states' width on ``act_tp``."""
    ax: Dict[str, tuple] = {"index": ()}
    if cfg.family in ("dense", "vlm"):
        ax["k"] = ax["v"] = ("layers", "batch", "kv_seq", None, None)
    elif cfg.family == "moe":
        for key in ("d_ckv", "m_ckv", "d_krope", "m_krope"):
            ax[key] = ("layers", "batch", "kv_seq", None)
        for key in ("d_k", "d_v", "m_k", "m_v"):
            ax[key] = ("layers", "batch", "kv_seq", None, None)
    elif cfg.family == "hybrid":
        ax["k"] = ax["v"] = ("layers", "batch", None, None, None)
        ax["slot_pos"] = (None,)
        ax["lru_h"] = ("layers", "batch", "act_tp")
        ax["conv"] = ("layers", "batch", None, "act_tp")
    elif cfg.family == "ssm":
        ax["m_C"] = ("layers", "batch", "act_tp", None, None)
        ax["m_n"] = ("layers", "batch", "act_tp", None)
        ax["m_m"] = ("layers", "batch", "act_tp")
        ax["m_conv"] = ("layers", "batch", None, None)
        for key in ("s_h", "s_c", "s_n", "s_m"):
            ax[key] = ("layers", "batch", None)
    return ax


#: cache leaves placed by ``cache_logical_axes`` on a mesh (the K/V and
#: MLA latents); the recurrent states keep the batch-only layout
SEQ_SHARDED = ("k", "v", "ckv", "krope")


def cache_placements(cfg: ModelConfig, key: str, shape, mesh) -> tuple:
    """Placements of cache leaf ``key`` on ``mesh``: the transformer's K/V
    (not the hybrid's window) and the MLA latents by
    ``cache_logical_axes``, sequence over ``model`` where it divides;
    every other leaf on its batch dim (dim 1) only; ``slot_pos``
    replicated."""
    if key == "slot_pos":
        axes = (None,)
    elif key.split("_")[-1] in SEQ_SHARDED and cfg.family != "hybrid":
        axes = cache_logical_axes(cfg)[key]
    else:
        axes = ("layers", "batch") + (None,) * (len(shape) - 2)
    return SH.logical_placements(axes, shape, mesh)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device="cuda", mesh=None):
    """A zeroed decode cache on ``device`` (the card unless the caller
    asks for the CPU); ``index`` is the int 0 and the hybrid's
    ``slot_pos`` -1 (no position held). On a ``mesh`` every leaf is a
    DTensor placed by ``cache_placements``: the K/V and MLA latents with
    their sequence over ``model`` (the decode attention runs on each
    rank's share of it, ``shard_map.seq_local``), the rest on the batch.
    On a "meta" ``device`` nothing is allocated (the dry-run)."""
    layout = cache_layout(cfg, batch_size, max_len)
    if mesh is None:
        device = resolve_device(device)
        cache = {key: 0 if key == "index" else
                 torch.zeros(shape, dtype=dtype, device=device)
                 for key, (shape, dtype) in layout.items()}
    else:
        from torch.distributed.tensor import zeros

        meta = torch.device(device).type == "meta"

        def placed(key, shape, dtype):
            pls = cache_placements(cfg, key, shape, mesh)
            if meta:
                return SH.meta_dtensor(shape, dtype, mesh, pls)
            return zeros(shape, dtype=dtype, device_mesh=mesh,
                         placements=pls)

        cache = {key: 0 if key == "index" else placed(key, *sd)
                 for key, sd in layout.items()}
    if "slot_pos" in cache:
        cache["slot_pos"].fill_(-1)
    return cache
