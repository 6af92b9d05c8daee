"""Serving: prefill + single-token decode. A port of
``repro/serve/decode.py`` for the families ``dense`` and ``vlm``
(decode.py:82-110 and 237-260); ``moe``, ``hybrid`` and ``ssm`` raise
``NotImplementedError`` until their slice (ROADMAP §A.7).

The cache's tensors are written in place (the reference's engine donates
its cache to the jitted step, so XLA writes it in place too); the returned
cache holds the same tensors and the next ``index``. Past ``max_len`` a
write lands on the last slot, as JAX's clamped ``dynamic_update_slice``
puts it (``transformer._cache_start``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T


def _check_family(cfg: ModelConfig, what: str):
    if cfg.family not in ("dense", "vlm"):
        raise M.not_ported(cfg, what)


def decode_step(cfg: ModelConfig, params, tokens, cache):
    """tokens: (B, 1) integers -> (logits (B, 1, V), cache with index + 1)."""
    _check_family(cfg, "decode_step")
    idx = int(cache["index"])
    x = L.embed(tokens, params["embed"])
    pos = torch.full((x.shape[0], 1), idx, dtype=torch.int32, device=x.device)
    x, kv = T.scan_dense_blocks(cfg, params["blocks"], x, pos,
                                kv_cache={"k": cache["k"], "v": cache["v"]},
                                cache_index=idx)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return M.unembed_logits(cfg, params, x), {"index": idx + 1, **kv}


def prefill(cfg: ModelConfig, params, batch, max_len: int):
    """Run the prompt through the model, returning (last_logits, cache).

    max_len is the cache capacity (>= prompt length); decode_step then
    appends from cache['index'] onward.
    """
    _check_family(cfg, "prefill")
    x = M.embed_inputs(cfg, params, batch)
    b, s = x.shape[:2]
    positions = M.positions_for(cfg, x)
    cache = M.init_cache(cfg, b, max_len, device=x.device)
    x, kv = T.scan_dense_blocks(cfg, params["blocks"], x, positions,
                                kv_cache={"k": cache["k"], "v": cache["v"]},
                                cache_index=0)
    new_cache: Dict[str, Any] = {"index": s, **kv}
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return M.unembed_logits(cfg, params, x), new_cache
