"""Top-level model assembly: a port of ``repro/models/model.py``.

API (pure functions of (cfg, params, ...)):
  param_specs(cfg)                       -> ParamSpec tree, every family
  forward(cfg, params, batch)            -> (logits, aux_loss)
  init_cache_shapes(cfg, batch, maxlen)  -> tree of "meta" tensors
  init_cache(cfg, batch, maxlen, device) -> zeroed cache, index 0

``forward`` and the caches run the families ``dense``, ``vlm``,
``audio`` and ``moe`` (MoE and MLA: ``moe_layers``). ``hybrid`` and
``ssm`` declare their parameters here (so every configuration's
``param_specs`` ports) and raise ``NotImplementedError`` elsewhere until
their slice (ROADMAP §A.7.2).

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
from repro_torch.models import transformer as T

RUNS = ("dense", "vlm", "audio", "moe")


def not_ported(cfg: ModelConfig, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} for the {cfg.family!r} family ({cfg.name}) is not ported "
        f"yet: see ROADMAP §A.7; the port runs {', '.join(RUNS)}")


# ---------------------------------------------------------------------------
# Param specs of the families not ported yet: copies of the reference's
# rglru_specs (recurrent.py:29), mlstm_specs (:113) and slstm_specs
# (:268). Their apply functions come with their slice (ROADMAP §A.7.2).
# ---------------------------------------------------------------------------


def _rglru_specs(cfg: ModelConfig, n: int) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    dt = cfg.torch_dtype
    return {
        "ln": ParamSpec((n, d), ("layers", None), "ones", dt),
        "w_gate_in": ParamSpec((n, d, w), ("layers", "fsdp", "tp"), "normal", dt),
        "w_rec_in": ParamSpec((n, d, w), ("layers", "fsdp", "tp"), "normal", dt),
        "conv_w": ParamSpec((n, cfg.conv1d_width, w), ("layers", None, "tp"), "normal", dt),
        "conv_b": ParamSpec((n, w), ("layers", "tp"), "zeros", dt),
        "w_a": ParamSpec((n, w, w), ("layers", "fsdp", "tp"), "normal", dt),
        "w_i": ParamSpec((n, w, w), ("layers", "fsdp", "tp"), "normal", dt),
        "lam": ParamSpec((n, w), ("layers", "tp"), ("uniform", 1.0), torch.float32),
        "w_out": ParamSpec((n, w, d), ("layers", "tp_in", "fsdp"), "normal", dt),
        "mlp": {
            "w_gate": ParamSpec((n, d, cfg.d_ff), ("layers", "fsdp", "tp"), "normal", dt),
            "w_up": ParamSpec((n, d, cfg.d_ff), ("layers", "fsdp", "tp"), "normal", dt),
            "w_down": ParamSpec((n, cfg.d_ff, d), ("layers", "tp_in", "fsdp"), "normal", dt),
        },
        "ln2": ParamSpec((n, d), ("layers", None), "ones", dt),
    }


def _mlstm_specs(cfg: ModelConfig, n: int) -> dict:
    d = cfg.d_model
    inner = 2 * d
    dh = inner // cfg.num_heads
    dt = cfg.torch_dtype
    heads = ParamSpec((n, cfg.num_heads, dh, dh), ("layers", "tp", None, None),
                      "normal", dt)
    return {
        "ln": ParamSpec((n, d), ("layers", None), "ones", dt),
        "w_up": ParamSpec((n, d, inner), ("layers", "fsdp", "tp"), "normal", dt),
        "w_gate": ParamSpec((n, d, inner), ("layers", "fsdp", "tp"), "normal", dt),
        "conv_w": ParamSpec((n, cfg.conv1d_width, inner), ("layers", None, "tp"), "normal", dt),
        "conv_b": ParamSpec((n, inner), ("layers", "tp"), "zeros", dt),
        "wq": heads,
        "wk": heads,
        "wv": heads,
        "w_if": ParamSpec((n, inner, 2 * cfg.num_heads), ("layers", "fsdp", None), "normal", dt),
        "w_down": ParamSpec((n, inner, d), ("layers", "tp_in", "fsdp"), "normal", dt),
    }


def _slstm_specs(cfg: ModelConfig, n: int) -> dict:
    d = cfg.d_model
    dt = cfg.torch_dtype
    h = cfg.num_heads
    dh = d // h
    f = max(128, round(d * 4 / 3 / 128) * 128)
    return {
        "ln": ParamSpec((n, d), ("layers", None), "ones", dt),
        "w_zifo": ParamSpec((n, d, 4 * d), ("layers", "fsdp", "tp"), "normal", dt),
        "r_zifo": ParamSpec((n, h, dh, 4 * dh), ("layers", None, None, None), "normal", dt),
        "w_out": ParamSpec((n, d, d), ("layers", "fsdp", "tp"), "normal", dt),
        "ln2": ParamSpec((n, d), ("layers", None), "ones", dt),
        "mlp_up": ParamSpec((n, d, f), ("layers", "fsdp", "tp"), "normal", dt),
        "mlp_down": ParamSpec((n, f, d), ("layers", "tp_in", "fsdp"), "normal", dt),
    }


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
                super_specs[f"l{j}_rec"] = _rglru_specs(cfg, n_super)
            else:
                super_specs[f"l{j}_attn"] = T.block_specs(cfg, n_super)
        specs["superblocks"] = super_specs
        for j, kind in enumerate(rem):
            specs[f"rem{j}"] = (_rglru_specs(cfg, 1) if kind == "rec"
                                else T.block_specs(cfg, 1))
    elif cfg.family == "ssm":
        n_super, n_m = _xlstm_layout(cfg)
        specs["superblocks"] = {
            "slstm": _slstm_specs(cfg, n_super),
            "mlstm": _mlstm_specs(cfg, n_super * n_m),  # (n_super*n_m) flat
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
        return torch.cat([vis, txt], dim=1)
    if cfg.family == "audio":
        return batch["frames"].to(cfg.torch_dtype) @ params["frontend_proj"]
    return L.embed(batch["tokens"], params["embed"])


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
    return x + L.swiglu_mlp(L.rms_norm(x, p["ln2"], cfg.norm_eps),
                            p["mlp"]["w_gate"], p["mlp"]["w_up"],
                            p["mlp"]["w_down"])


def _moe_block(cfg, p, x, positions, *, kv_cache=None, cache_index=None):
    """MLA or GQA, then the routed experts and the shared expert on the
    same normed input -> (x, aux)."""
    h, _ = _attn_fn(cfg)(cfg, p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
                         positions, kv_cache=kv_cache, cache_index=cache_index)
    x = x + h
    xn = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = MOE.apply_moe(cfg, p["moe"], xn)
    if cfg.num_shared_experts:
        sh = p["moe"]["shared"]
        y = y + L.swiglu_mlp(xn, sh["wg"], sh["wu"], sh["wd"])
    return x + y, aux


def moe_layers(cfg: ModelConfig, params, x, positions, *, cache=None,
               cache_index=None):
    """The moe family's layers in order: ``num_dense_layers`` dense blocks,
    then the MoE blocks (the MTP module does not run here, as in the
    reference). ``cache`` holds the stacked ``d_*`` / ``m_*`` leaves,
    written in place. Returns (x, aux summed over the MoE layers)."""
    keys = ("ckv", "krope") if cfg.use_mla else ("k", "v")

    def layer_cache(pre, i):
        return (None if cache is None else
                {k: cache[f"{pre}_{k}"][i] for k in keys})

    for i in range(cfg.num_dense_layers):
        x = _dense_block(cfg, T.layer_params(params["dense_blocks"], i), x,
                         positions, kv_cache=layer_cache("d", i),
                         cache_index=cache_index)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers - cfg.num_dense_layers):
        x, aux = _moe_block(cfg, T.layer_params(params["moe_blocks"], i), x,
                            positions, kv_cache=layer_cache("m", i),
                            cache_index=cache_index)
        aux_total = aux_total + aux
    return x, aux_total


def forward(cfg: ModelConfig, params, batch, return_hidden=False):
    """Full-sequence forward -> (logits, aux_loss)."""
    if cfg.family not in RUNS:
        raise not_ported(cfg, "forward")
    x = embed_inputs(cfg, params, batch)
    positions = positions_for(cfg, x)
    if cfg.family == "moe":
        x, aux_total = moe_layers(cfg, params, x, positions)
    else:
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        x, _ = T.scan_dense_blocks(cfg, params["blocks"], x, positions)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, aux_total
    return unembed_logits(cfg, params, x), aux_total


def unembed_logits(cfg: ModelConfig, params, x):
    unembed = (params["embed"].T if cfg.tie_embeddings else params["unembed"])
    return L.logits(x, unembed, cfg.vocab_size)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


def init_cache_shapes(cfg: ModelConfig, batch_size: int, max_len: int):
    """The decode cache as "meta" tensors (shapes and dtypes, nothing
    allocated); ``index`` an int32 scalar, as in the reference."""
    def meta(shape):
        return torch.empty(shape, dtype=cfg.torch_dtype, device="meta")

    cache: Dict[str, Any] = {
        "index": torch.empty((), dtype=torch.int32, device="meta")}
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
    else:
        raise not_ported(cfg, "the decode cache")
    return cache


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device="cuda"):
    """A zeroed decode cache on ``device`` (the card unless the caller
    asks for the CPU); ``index`` is the int 0."""
    shapes = init_cache_shapes(cfg, batch_size, max_len)
    device = resolve_device(device)
    return {key: 0 if key == "index" else
            torch.zeros(m.shape, dtype=m.dtype, device=device)
            for key, m in shapes.items()}
