"""Dense GQA transformer blocks (qwen2.5 / qwen2 / granite / internvl2
backbone / hubert encoder): a port of ``repro/models/transformer.py``.
Declarative ParamSpecs + pure apply functions; layers are stacked on a
leading 'layers' axis and run in a Python loop over it (the reference's
``scan_layers=False`` path; its ``lax.scan`` computes the same).

KV caches are written in place: the reference's ``lax.dynamic_update_slice``
on a donated cache (serve/server.py) is an in-place write under XLA. Its
start index is clamped as JAX clamps it (``_cache_start``).

Rematerialization (``_maybe_remat``, ``cfg.remat``) wraps one unit of
layers, the reference's scan body, in ``torch.utils.checkpoint`` while
autograd records; serving runs the plain function:
- ``"full"`` (``nothing_saveable``): the unit keeps only its inputs and
  recomputes everything inside it in the backward pass.
- ``"dots"`` (``checkpoint_dots_with_no_batch_dims``): the unit saves the
  outputs of ``aten.mm`` / ``aten.addmm``, the ``x @ w`` products of a
  weight matrix with the tokens folded into rows, and recomputes the rest:
  norms, activations, RoPE, and the batched products over heads
  (``bmm``, the attention scores and the recurrent einsums).
- ``"none"``: autograd saves what each op needs.
The arithmetic is the same under all three: a recomputed op gives the
same bits.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.common import ParamSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel.shard_map import heads_local, seq_local
from repro_torch.parallel.sharding import (constrain, gathered, is_dtensor,
                                           split_heads)


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig, n: int) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = cfg.torch_dtype
    s = {
        "wq": ParamSpec((n, d, hq * hd), ("layers", "fsdp", "tp"), "normal", dt),
        "wk": ParamSpec((n, d, hkv * hd), ("layers", "fsdp", "tp"), "normal", dt),
        "wv": ParamSpec((n, d, hkv * hd), ("layers", "fsdp", "tp"), "normal", dt),
        "wo": ParamSpec((n, hq * hd, d), ("layers", "tp_in", "fsdp"), "normal", dt),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((n, hq * hd), ("layers", "tp"), "zeros", dt)
        s["bk"] = ParamSpec((n, hkv * hd), ("layers", "tp"), "zeros", dt)
        s["bv"] = ParamSpec((n, hkv * hd), ("layers", "tp"), "zeros", dt)
    return s


def mlp_specs(cfg: ModelConfig, n: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.torch_dtype
    return {
        "w_gate": ParamSpec((n, d, f), ("layers", "fsdp", "tp"), "normal", dt),
        "w_up": ParamSpec((n, d, f), ("layers", "fsdp", "tp"), "normal", dt),
        "w_down": ParamSpec((n, f, d), ("layers", "tp_in", "fsdp"), "normal", dt),
    }


def block_specs(cfg: ModelConfig, n: int) -> dict:
    d = cfg.d_model
    dt = cfg.torch_dtype
    return {
        "ln1": ParamSpec((n, d), ("layers", None), "ones", dt),
        "ln2": ParamSpec((n, d), ("layers", None), "ones", dt),
        "attn": attn_specs(cfg, n),
        "mlp": mlp_specs(cfg, n),
    }


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _cache_start(index: int, sq: int, max_len: int) -> int:
    """Where ``lax.dynamic_update_slice`` writes ``sq`` rows into a
    ``max_len`` cache at ``index``: JAX clamps the start into
    ``[0, max_len - sq]``, so a write past the end lands on the last
    ``sq`` slots and overwrites what was there."""
    if sq > max_len:
        raise ValueError(f"{sq} new positions do not fit a cache of {max_len}")
    return min(max(int(index), 0), max_len - sq)


def apply_attn(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor, *, kv_cache: Optional[dict] = None,
               cache_index=None, window: Optional[int] = None,
               return_kv: bool = False):
    """One attention sub-layer. p holds per-layer (unstacked) weights.

    kv_cache: {'k','v'}: (B, Smax, Hkv, hd), written in place when given
    (decode). Returns (out, kv_cache_or_None).
    """
    b, sq, d = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = x @ gathered(p["wq"], ("fsdp", "tp"))
    k = x @ gathered(p["wk"], ("fsdp", "tp"))
    v = x @ gathered(p["wv"], ("fsdp", "tp"))
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = split_heads(q, hq, hd, "act_q_seq", hq, hkv)
    k = split_heads(k, hkv, hd, "act_kv_seq", hq, hkv)
    v = split_heads(v, hkv, hd, "act_kv_seq", hq, hkv)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    # context-parallel attention (the placement pass's rules for archs
    # whose head count doesn't divide the model axis): q on seq, K/V whole
    q = constrain(q, ("batch", "act_q_seq", None, None))
    k = constrain(k, ("batch", "act_kv_seq", None, None))
    v = constrain(v, ("batch", "act_kv_seq", None, None))

    # the attention runs on each rank's batch rows and, where the model
    # axis divides the head counts, its heads; against a cache, on each
    # rank's share of the cache's positions (all heads, flash-decode)
    if kv_cache is not None:
        index = int(cache_index)
        start = _cache_start(index, sq, kv_cache["k"].shape[1])
        if sq > 1 and is_dtensor(kv_cache["k"]):
            # a prefill on a mesh: the prompt's own K/V, written into
            # the cache's layout (the mesh's prefill starts at 0)
            if index:
                raise ValueError("a prefill on a mesh starts at index 0")
            o = heads_local(lambda q, k, v: L.attention(
                q, k, v, causal=True, window=window), (q, k, v), ("h",) * 3)
            seq_local(lambda seq, k, v, ck, cv: (seq.write(ck, k, start),
                                                 seq.write(cv, v, start)),
                      (k, v, kv_cache["k"], kv_cache["v"]),
                      ("b", "b", "sw", "sw"))
        else:
            def attend(seq, q, k, v, ck, cv):
                seq.write(ck, k, start)
                seq.write(cv, v, start)
                kv_len = torch.full((q.shape[0],), index + sq,
                                    dtype=torch.int32, device=q.device)
                return L.seq_attention(seq, q, ck, cv, causal=sq > 1,
                                       window=window, q_offset=index,
                                       kv_len=kv_len)

            o = seq_local(attend, (q, k, v, kv_cache["k"], kv_cache["v"]),
                          ("b", "b", "b", "sw", "sw"))
        new_cache = kv_cache
    else:
        o = heads_local(lambda q, k, v: L.attention(
            q, k, v, causal=cfg.decoder, window=window), (q, k, v),
            ("h",) * 3)
        new_cache = {"k": k, "v": v} if return_kv else None
    o = constrain(o.reshape(b, sq, hq * hd), ("batch", "act_q_seq", "act_tp"))
    return o @ gathered(p["wo"], ("tp_in", "fsdp")), new_cache


def apply_block(cfg, p, x, positions, *, kv_cache=None, cache_index=None,
                window=None, return_kv=False):
    h, new_cache = apply_attn(
        cfg, p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), positions,
        kv_cache=kv_cache, cache_index=cache_index, window=window,
        return_kv=return_kv,
    )
    x = x + h
    x = x + L.swiglu_mlp(L.rms_norm(x, p["ln2"], cfg.norm_eps),
                         p["mlp"]["w_gate"], p["mlp"]["w_up"],
                         p["mlp"]["w_down"])
    # sequence parallelism under the context-parallel rules; the default
    # rules leave act_q_seq whole
    x = constrain(x, ("batch", "act_q_seq", None))
    return x, new_cache


def _dots_policy(ctx, op, *args, **kwargs):
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat``'s policy while autograd records (see the
    module docstring); ``fn`` itself otherwise."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        context_fn = ckpt.noop_context_fn
    elif cfg.remat == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    else:
        raise ValueError(f"remat {cfg.remat!r}: full | dots | none")

    @functools.wraps(fn)
    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # the models draw no random numbers: no RNG state to replay
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=context_fn)
    return run


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def scan_dense_blocks(cfg, stacked, x, positions, *, kv_cache=None,
                      cache_index=None, window=None):
    """Run n stacked dense blocks in order, each block one remat unit.

    kv_cache here is stacked: {'k','v'}: (n, B, Smax, Hkv, hd), written in
    place. Returns (x, kv_cache_or_None).
    """
    n = stacked["ln1"].shape[0]
    if kv_cache is None:
        body = _maybe_remat(lambda xv, p: apply_block(
            cfg, p, xv, positions, window=window)[0], cfg)
        for i in range(n):
            x = body(x, layer_params(stacked, i))
        return x, None
    for i in range(n):
        layer_cache = {"k": kv_cache["k"][i], "v": kv_cache["v"][i]}
        x, _ = apply_block(cfg, layer_params(stacked, i), x, positions,
                           kv_cache=layer_cache, cache_index=cache_index,
                           window=window)
    return x, kv_cache
