"""Mixture-of-Experts FFN: a port of ``repro/models/moe.py``.

Without a mesh (or a mesh without a ``model`` axis) every token runs
through one local body. On a mesh, the reference's three ``shard_map``
bodies run through ``parallel.shard_map`` with explicit collectives:
  * EP decode (``s == 1`` or a sequence the model axis does not divide,
    experts dividing it): tokens all-gathered over ``data`` (and ``pod``),
    a partial-d expert FFN, ``psum`` over ``data``, ``psum`` of the expert
    contributions over ``model``, this rank's tokens sliced back.
  * EP sequence-sharded: tokens sharded over ``model`` on the sequence,
    the capacity buffer sent to its experts' ranks and back by two tiled
    ``all_to_all``s over ``model``.
  * TP (experts that ``model`` does not divide): every rank routes all of
    its tokens, each holds a ``d_ff`` slice of every expert, ``psum``
    over ``model``.
Each body routes with the stable top-k and drops past the capacity of its
own buffer, as the reference's bodies do: ``t`` below is the tokens a
body routes at once (a rank's tokens, or all of them in EP decode).

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
from repro_torch.parallel import shard_map as SM


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
               capacity_factor: float, axes=None, axis=None):
    """x: (t, d) -> (out (t, d), aux): route, dispatch into the capacity
    buffer, every expert's FFN, gather, unsort, weighted sum. ``axis``:
    None = experts all local; "model" = this rank holds ``E / m`` experts
    and the buffer goes to them by ``all_to_all`` over that axis."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    ids, w, aux = route(cfg, x, w_router)
    cap = max(4, math.ceil(t * k * capacity_factor / e))
    order, buf_idx = _dispatch_indices(ids, e, cap)
    buf = _fill_buffer(x, k, order, buf_idx, e * cap).reshape(e, cap, d)
    if axis is not None:
        buf = SM.all_to_all(buf, axes, axis, split=0, concat=1)
        y = _expert_ffn(buf, wg, wu, wd)           # (e/m, cap*m, d)
        y = SM.all_to_all(y, axes, axis, split=1, concat=0)
    else:
        y = _expert_ffn(buf, wg, wu, wd)
    return _combine(y.reshape(e * cap, d), buf_idx, order, w, t, k), aux


def _fill_buffer(x, k, order, buf_idx, rows):
    """The ``(rows, d)`` capacity buffer: each token's k copies in sorted
    order at their rows; the dropped all land on a trash row, cut off."""
    xk = _repeat_rows(x, k)[order]      # (t*k, d) in sorted order
    buf = torch.zeros((rows + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    buf = buf.index_put((buf_idx,), xk)
    return buf[:-1]


def _combine(y_flat, buf_idx, order, w, t, k):
    """Each assignment's expert output (zero when dropped: JAX's
    ``.get(mode="fill", fill_value=0)``), unsorted, weighted, summed."""
    d = y_flat.shape[1]
    y_flat = torch.cat([y_flat, y_flat.new_zeros((1, d))])
    gathered = y_flat[buf_idx]                          # (t*k, d), sorted
    unsorted = torch.zeros_like(gathered).index_put((order,), gathered)
    return (unsorted.reshape(t, k, d) * w[..., None].to(y_flat.dtype)).sum(dim=1)


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor, mesh=None, *,
              capacity_factor: float = None):
    """x: (B, S, d) -> ((B, S, d), aux); ``p`` holds one layer's weights.
    The capacity factor defaults to ``cfg.moe_capacity_factor``. On a mesh
    with a ``model`` axis one of the three bodies runs (module docstring);
    the results are DTensors."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    b, s, d = x.shape
    if mesh is None or "model" not in mesh.mesh_dim_names:
        out, aux = _moe_local(cfg, x.reshape(-1, d), p["router"], p["wg"],
                              p["wu"], p["wd"], capacity_factor)
        return out.reshape(b, s, d), aux

    names = mesh.mesh_dim_names
    m = mesh.size(names.index("model"))
    batch_axes = ("pod", "data") if "pod" in names else ("data",)
    bspec = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    ep = ep_capable(cfg, m)
    seq_shardable = s % m == 0 and s > 1
    e = cfg.num_experts
    if ep and not seq_shardable:
        # decode: the expert weights stay sharded (expert -> model, d ->
        # data); the tokens move instead
        dp = "data"
        in_specs = ((bspec, None, None), (),
                    ("model", dp, None), ("model", dp, None),
                    ("model", None, dp))

        def body(axes, xs, wr, wg, wu, wd):
            bl, sl, _ = xs.shape
            xf = xs.reshape(-1, d)
            xall = SM.all_gather(xf, axes, dp, dim=0)            # (T, d)
            if "pod" in names:
                xall = SM.all_gather(xall, axes, "pod", dim=0)
            t = xall.shape[0]
            ids, w, aux = route(cfg, xall, wr)
            cap = max(4, math.ceil(t * cfg.top_k * capacity_factor / e))
            order, buf_idx = _dispatch_indices(ids, e, cap)
            buf = _fill_buffer(xall, cfg.top_k, order, buf_idx,
                               e * cap).reshape(e, cap, d)
            el = e // axes.size("model")
            rank_e = axes.index("model")
            dsl = d // axes.size(dp)
            rank_d = axes.index(dp)
            local = buf[rank_e * el:(rank_e + 1) * el]
            local_d = local[..., rank_d * dsl:(rank_d + 1) * dsl]
            # partial-d contraction + psum over data completes the hidden
            hg = SM.psum(torch.einsum("ecd,edf->ecf", local_d, wg), axes, dp)
            hu = SM.psum(torch.einsum("ecd,edf->ecf", local_d, wu), axes, dp)
            y_ld = torch.einsum("ecf,efd->ecd", F.silu(hg) * hu, wd)
            y_local = SM.all_gather(y_ld, axes, dp, dim=2)       # (el, cap, d)
            y = torch.cat([y_local.new_zeros((rank_e * el, cap, d)), y_local,
                           y_local.new_zeros((e - (rank_e + 1) * el, cap, d))])
            out_all = SM.psum(_combine(y.reshape(e * cap, d), buf_idx, order,
                                       w, t, cfg.top_k), axes, "model")
            # slice back this data-shard's tokens
            tl = xf.shape[0]
            row = rank_d
            if "pod" in names:
                row = axes.index("pod") * axes.size(dp) + rank_d
            out = out_all[row * tl:(row + 1) * tl]
            aux = SM.pmean(aux, axes, ("model",) + batch_axes)
            return out.reshape(bl, sl, d), aux

        out_specs = ((bspec, None, None), ())
    elif ep:
        in_specs = ((bspec, "model", None), (),
                    ("model", None, None), ("model", None, None),
                    ("model", None, None))

        def body(axes, xs, wr, wg, wu, wd):
            bl, sl, _ = xs.shape
            out, aux = _moe_local(cfg, xs.reshape(-1, d), wr, wg, wu, wd,
                                  capacity_factor, axes, axis="model")
            aux = SM.pmean(aux, axes, ("model",) + batch_axes)
            return out.reshape(bl, sl, d), aux

        out_specs = ((bspec, "model", None), ())
    else:
        in_specs = ((bspec, None, None), (),
                    (None, None, "model"), (None, None, "model"),
                    (None, "model", None))

        def body(axes, xs, wr, wg, wu, wd):
            bl, sl, _ = xs.shape
            out, aux = _moe_local(cfg, xs.reshape(-1, d), wr, wg, wu, wd,
                                  capacity_factor)
            out = SM.psum(out, axes, "model")
            aux = SM.pmean(aux, axes, ("model",) + batch_axes)
            return out.reshape(bl, sl, d), aux

        out_specs = ((bspec, None, None), ())
    return SM.shard_map(body, mesh, in_specs, out_specs)(
        x, p["router"], p["wg"], p["wu"], p["wd"])
