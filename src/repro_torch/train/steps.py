"""Training step: loss, gradient accumulation over microbatches, optional
EF-int8 gradient compression, the MTP auxiliary loss. The counterpart of
``repro.train.steps``.

``make_train_step(cfg, tc, mesh=None)`` returns
    (params, opt_state, batch[, error_state])
        -> (params, opt_state, metrics[, error_state])
with the reference's metric keys. On a mesh the params, moments and error
state are DTensors (placed by the caller, ``parallel.sharding``), each
microbatch is sharded over the batch axes, and the gradient norm, the
clip, AdamW and EF-int8 act on the DTensors, reducing over the whole leaf
as GSPMD does on the global array; the metrics come back as plain
tensors. Gradients come from
``torch.autograd.grad`` with respect to detached aliases of the param
leaves, so the tree passed in (which may be serving) is never written and
needs no ``requires_grad``. With one microbatch they keep each param's
dtype, as ``jax.value_and_grad`` gives them; with several they are summed
into fp32 zeros and divided, and so are the metrics.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, compress
from repro_torch.parallel import sharding as SH


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1          # gradient accumulation
    aux_loss_weight: float = 0.01  # MoE load-balance
    mtp_weight: float = 0.3        # deepseek multi-token-prediction
    compress_pod_grads: bool = False
    optimizer: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)


def _mtp_loss(cfg: ModelConfig, params, batch, hidden):
    """DeepSeek MTP: one extra block sees [h_i ; emb(t_{i+1})] and
    predicts t_{i+2}."""
    p = params["mtp"]
    shifted = torch.roll(batch["tokens"], -1, dims=1)
    emb = L.embed(shifted, params["embed"])
    h = torch.cat([L.rms_norm(hidden, p["ln"], cfg.norm_eps), emb],
                  dim=-1) @ p["proj"]
    positions = M.positions_for(cfg, h)
    blk = T.layer_params(p["block"], 0)
    if cfg.use_mla:
        a, _ = MLA.apply_mla(cfg, blk["attn"],
                             L.rms_norm(h, blk["ln1"], cfg.norm_eps),
                             positions)
        h = h + a
        h = h + L.swiglu_mlp(L.rms_norm(h, blk["ln2"], cfg.norm_eps),
                             blk["mlp"]["w_gate"], blk["mlp"]["w_up"],
                             blk["mlp"]["w_down"])
    else:
        h, _ = T.apply_block(cfg, blk, h, positions)
    lgts = M.unembed_logits(cfg, params, h)
    labels2 = torch.roll(batch["labels"], -1, dims=1)
    labels2[:, -2:] = -1
    return L.cross_entropy_loss(lgts, labels2, cfg.vocab_size)


def loss_fn(cfg: ModelConfig, tc: TrainConfig, params, batch, mesh=None):
    """(total loss, {"ce", "aux"[, "mtp"]}): CE plus ``aux_loss_weight``
    times the MoE balance loss, plus ``mtp_weight`` times the MTP loss."""
    if mesh is not None:
        # the labels too: a plain (replicated) label tensor would make
        # DTensor gather every rank's logits for the loss
        batch = SH.place_batch(batch, mesh)
    want_hidden = bool(cfg.mtp_depth)
    out, aux = M.forward(cfg, params, batch, mesh, return_hidden=want_hidden)
    lgts = M.unembed_logits(cfg, params, out) if want_hidden else out
    ce = L.cross_entropy_loss(lgts, batch["labels"], cfg.vocab_size)
    total = ce + tc.aux_loss_weight * aux
    metrics = {"ce": ce, "aux": aux}
    if want_hidden:
        mtp = _mtp_loss(cfg, params, batch, out)
        total = total + tc.mtp_weight * mtp
        metrics["mtp"] = mtp
    return total, metrics


def _split_microbatches(batch, n):
    """Microbatch i of n: rows [i*B/n, (i+1)*B/n) of every leaf."""
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n)]


def _value_and_grad(cfg, tc, params, batch, mesh=None):
    """((loss, metrics), grads): grads in each param's dtype, a new tree
    shaped as ``params``."""
    paths = adamw._paths(params)
    leaves = [adamw._get(params, q).detach().requires_grad_(True)
              for q in paths]
    with torch.enable_grad():
        total, metrics = loss_fn(cfg, tc, adamw._unflatten(
            params, paths, leaves), batch, mesh)
        # a leaf the family never reads (hubert's token embedding) gets
        # zeros, as jax.grad gives it
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics), adamw._unflatten(params, paths, grads)


def make_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None):
    """The train step (see the module docstring)."""

    def train_step(params, opt_state, batch, error_state=None):
        if mesh is None:
            return _step(params, opt_state, batch, error_state)
        # microbatches are split before they are sharded: each is spread
        # over the batch axes
        with SH.replicate_plain():
            out = _step(params, opt_state, batch, error_state)
        metrics = {k: SH.full(v) for k, v in out[2].items()}
        return out[:2] + (metrics,) + out[3:]

    def _step(params, opt_state, batch, error_state):
        if tc.microbatches > 1:
            grads = adamw.tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            metrics = None
            for mb in _split_microbatches(batch, tc.microbatches):
                (lv, m), g = _value_and_grad(cfg, tc, params, mb, mesh)
                for acc, gi in zip(adamw.leaves(grads), adamw.leaves(g)):
                    acc.add_(gi)
                del g
                m = {"loss": lv, **m}
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in metrics}
            for acc in adamw.leaves(grads):
                acc.div_(tc.microbatches)
            metrics = {k: v / tc.microbatches for k, v in metrics.items()}
        else:
            (lv, metrics), grads = _value_and_grad(cfg, tc, params, batch,
                                                   mesh)
            metrics = {"loss": lv, **metrics}

        new_error = error_state
        if tc.compress_pod_grads and error_state is not None:
            grads, new_error = compress.ef_compress_grads(grads, error_state)

        params2, opt_state2, opt_metrics = adamw.apply_updates(
            tc.optimizer, params, grads, opt_state)
        metrics.update(opt_metrics)
        if tc.compress_pod_grads:
            return params2, opt_state2, metrics, new_error
        return params2, opt_state2, metrics

    return train_step
