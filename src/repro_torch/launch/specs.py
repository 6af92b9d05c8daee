"""Allocation-free input stand-ins per (arch x shape) and their shardings:
a port of ``repro/launch/specs.py``.

``input_specs`` gives the batch as "meta" tensors (shapes and dtypes, no
storage) where the reference gives ``ShapeDtypeStruct``s; decode's cache
comes from ``models.model.init_cache_shapes`` (its ``index`` is a meta
int32 scalar, as the reference's is a ``ShapeDtypeStruct``).
``batch_shardings`` gives the matching ``parallel.sharding.Sharding``
tree: the batch dim over the batch axes, the cache by
``models.model.cache_logical_axes``, and any dim its mesh axes do not
divide replicated (e.g. long_500k's global batch of 1).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.parallel.sharding import (Sharding, _trim_indivisible,
                                           active_rules, logical_to_pspec)


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Abstract batch for train/prefill, or (tokens, cache) for decode."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1)),
                "cache": M.init_cache_shapes(cfg, b, s)}
    batch: Dict[str, Any] = {}
    if cfg.family == "vlm":
        ft = cfg.frontend_tokens
        batch["tokens"] = _meta((b, s - ft))
        batch["patch_embeds"] = _meta((b, ft, cfg.frontend_dim),
                                      torch.float32)
    elif cfg.family == "audio":
        batch["frames"] = _meta((b, s, cfg.frontend_dim), torch.float32)
    else:
        batch["tokens"] = _meta((b, s))
    if shape.kind == "train":
        batch["labels"] = _meta((b, s))
    return batch


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """``Sharding`` tree matching ``input_specs``. ``mesh`` is a
    DeviceMesh, or a ``{axis: size}`` dict for the specs alone (then each
    leaf is its spec tuple)."""
    rules = active_rules()

    def shard_for(axes, shp):
        spec = _trim_indivisible(logical_to_pspec(axes, rules, mesh), shp,
                                 mesh)
        return spec if isinstance(mesh, dict) else Sharding(mesh, spec)

    specs = input_specs(cfg, shape)
    if shape.kind == "decode":
        cache_ax = M.cache_logical_axes(cfg)
        cache = {k: shard_for(() if k == "index" else
                              cache_ax.get(k, ())[:v.dim()], v.shape)
                 for k, v in specs["cache"].items()}
        return {"tokens": shard_for(("batch", None), specs["tokens"].shape),
                "cache": cache}
    return {k: shard_for(("batch",) + (None,) * (v.dim() - 1), v.shape)
            for k, v in specs.items()}
