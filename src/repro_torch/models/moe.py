"""Mixture-of-Experts FFN: a port of ``repro/models/moe.py``'s
single-device path (``apply_moe`` with ``mesh is None``, moe.py:144-149).
The expert-parallel and tensor-parallel ``shard_map`` bodies wait for the
mesh slice (ROADMAP §A.7.4); ``moe_specs`` keeps their logical axes.

The dispatch is the reference's sort-based capacity buffer: each token's
top-k assignments are placed, in the stable order of their expert ids,
into an ``(E, cap, d)`` buffer with ``cap = max(4, ceil(t k f / E))`` for
``t`` tokens in the call; assignments past ``cap`` go to a trash row and
come back as zeros. ``t`` counts every token of the call (a serving
engine's left padding and duplicated pad slots too), so at a small
capacity factor a token's output depends on its batch, as in the
reference. Every expert multiplies its buffer, full or empty.

Two reference behaviours decide the routing and are kept: ``lax.top_k``
puts the lower index first among equal scores (a stable descending sort
here; ``torch.topk`` does not), and sigmoid scores that round to 1.0 tie
for many experts at once at deepseek-v3's width.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common import ParamSpec
from repro_torch.configs.base import ModelConfig


def moe_specs(cfg: ModelConfig, n: int, ep: bool) -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
    dt = cfg.torch_dtype
    exp_axes = ("layers", "expert", "fsdp", None) if ep else ("layers", None, "fsdp", "tp")
    exp_axes_dn = ("layers", "expert", None, "fsdp") if ep else ("layers", None, "tp_in", "fsdp")
    s = {
        "router": ParamSpec((n, d, e), ("layers", None, None), "normal", torch.float32),
        "wg": ParamSpec((n, e, d, f), exp_axes, "normal", dt),
        "wu": ParamSpec((n, e, d, f), exp_axes, "normal", dt),
        "wd": ParamSpec((n, e, f, d), exp_axes_dn, "normal", dt),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        s["shared"] = {
            "wg": ParamSpec((n, d, fs), ("layers", "fsdp", "tp"), "normal", dt),
            "wu": ParamSpec((n, d, fs), ("layers", "fsdp", "tp"), "normal", dt),
            "wd": ParamSpec((n, fs, d), ("layers", "tp_in", "fsdp"), "normal", dt),
        }
    return s


def ep_capable(cfg: ModelConfig, model_axis: int) -> bool:
    return cfg.num_experts % max(model_axis, 1) == 0


# ---------------------------------------------------------------------------
# Routing + dispatch
# ---------------------------------------------------------------------------


def top_k(scores: torch.Tensor, k: int):
    """``lax.top_k``: the k largest of the last axis, the lower index
    first among equal values (a stable descending sort)."""
    vals, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def route(cfg: ModelConfig, x_flat: torch.Tensor, w_router: torch.Tensor):
    """x_flat: (t, d) -> top-k ids (t, k), weights (t, k), aux load loss.

    Sigmoid scores for deepseek (a ``-smoke`` name routes as its parent
    does), softmax otherwise; the weights are normalised with a 1e-9
    floor. ``aux`` is the switch-style balance term on each token's first
    choice (informational for sigmoid routers)."""
    logits = x_flat.float() @ w_router.float()
    if cfg.name.startswith("deepseek"):
        scores = torch.sigmoid(logits)
        w, ids = top_k(scores, cfg.top_k)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, ids = top_k(probs, cfg.top_k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    e = logits.shape[-1]
    me = probs.mean(dim=0)
    ce = F.one_hot(ids[:, 0], e).float().mean(dim=0)
    aux = e * (me * ce).sum()
    return ids, w, aux


def _dispatch_indices(ids: torch.Tensor, num_experts: int, capacity: int):
    """ids: (t, k) -> (order, buf_idx): the stable sort of the flat
    expert ids and each sorted assignment's row of the ``E * capacity``
    buffer, ``E * capacity`` (the trash row) past an expert's capacity."""
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    # torch.bincount(flat, minlength=E), without its host sync on the card
    counts = torch.zeros(num_experts, dtype=flat.dtype, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat.numel(), device=flat.device) - starts[sorted_e]
    buf_idx = torch.where(pos < capacity, sorted_e * capacity + pos,
                          num_experts * capacity)
    return order, buf_idx


def _repeat_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """``jnp.repeat(x, k, axis=0)``: each row k times in a row
    (``repeat_interleave``, not a tiling)."""
    t, d = x.shape
    return x[:, None].expand(t, k, d).reshape(t * k, d)


def _expert_ffn(xe, wg, wu, wd):
    """xe: (E, C, d); weights (E, d, f) / (E, f, d)."""
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, wg)) \
        * torch.einsum("ecd,edf->ecf", xe, wu)
    return torch.einsum("ecf,efd->ecd", h, wd)


def _moe_local(cfg: ModelConfig, x, w_router, wg, wu, wd,
               capacity_factor: float):
    """x: (t, d) -> (out (t, d), aux): route, dispatch into the capacity
    buffer, every expert's FFN, gather, unsort, weighted sum."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    ids, w, aux = route(cfg, x, w_router)
    cap = max(4, math.ceil(t * k * capacity_factor / e))
    order, buf_idx = _dispatch_indices(ids, e, cap)
    xk = _repeat_rows(x, k)[order]      # (t*k, d) in sorted order
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[buf_idx] = xk                  # the dropped all land on the last row
    y = _expert_ffn(buf[:-1].reshape(e, cap, d), wg, wu, wd)
    # a zero row for the trash index: JAX's .get(mode="fill", fill_value=0)
    y_flat = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))])
    gathered = y_flat[buf_idx]                          # (t*k, d), sorted
    unsorted = torch.empty_like(gathered)
    unsorted[order] = gathered
    out = (unsorted.reshape(t, k, d) * w[..., None].to(x.dtype)).sum(dim=1)
    return out, aux


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
              capacity_factor: float = None):
    """x: (B, S, d) -> ((B, S, d), aux); ``p`` holds one layer's weights.
    The capacity factor defaults to ``cfg.moe_capacity_factor``."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    b, s, d = x.shape
    out, aux = _moe_local(cfg, x.reshape(-1, d), p["router"], p["wg"],
                          p["wu"], p["wd"], capacity_factor)
    return out.reshape(b, s, d), aux
