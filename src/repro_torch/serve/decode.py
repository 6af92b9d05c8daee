"""Serving: prefill + single-token decode. A port of
``repro/serve/decode.py`` for the families ``dense``, ``vlm`` and ``moe``
(decode.py:82-163 and 237-306); ``hybrid`` and ``ssm`` raise
``NotImplementedError`` until their slice (ROADMAP §A.7.2).

The cache's tensors are written in place (the reference's engine donates
its cache to the jitted step, so XLA writes it in place too); the returned
cache holds the same tensors and the next ``index``. Past ``max_len`` a
write lands on the last slot, as JAX's clamped ``dynamic_update_slice``
puts it (``transformer._cache_start``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T


def _check_family(cfg: ModelConfig, what: str):
    if cfg.family not in ("dense", "vlm", "moe"):
        raise M.not_ported(cfg, what)


def _layers(cfg: ModelConfig, params, x, positions, cache, index: int):
    """Every layer against ``cache`` (written in place) from ``index``."""
    if cfg.family == "moe":
        x, _ = M.moe_layers(cfg, params, x, positions, cache=cache,
                            cache_index=index)
        return x
    x, _ = T.scan_dense_blocks(cfg, params["blocks"], x, positions,
                               kv_cache={"k": cache["k"], "v": cache["v"]},
                               cache_index=index)
    return x


def decode_step(cfg: ModelConfig, params, tokens, cache):
    """tokens: (B, 1) integers -> (logits (B, 1, V), cache with index + 1)."""
    _check_family(cfg, "decode_step")
    idx = int(cache["index"])
    x = L.embed(tokens, params["embed"])
    pos = torch.full((x.shape[0], 1), idx, dtype=torch.int32, device=x.device)
    x = _layers(cfg, params, x, pos, cache, idx)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return M.unembed_logits(cfg, params, x), dict(cache, index=idx + 1)


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
    x = _layers(cfg, params, x, positions, cache, 0)
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return M.unembed_logits(cfg, params, x), dict(cache, index=s)
