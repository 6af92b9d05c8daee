"""AdamW with optional fp32 master weights, a warmup-cosine schedule and
global-norm clipping, as plain functions on parameter trees (the
counterpart of ``repro.optim.adamw``).

A tree is the port's nested dict of tensors. Every walk visits the
leaves in sorted key order, as ``jax.tree.leaves`` does, so
``global_norm`` sums in the reference's order. The arithmetic is the
reference's, in fp32: the moments step first, then the decoupled weight
decay on the same base. ``torch.optim.AdamW`` decays before the moment
step and has neither the clip nor this schedule, so it is not used.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, NamedTuple, Tuple

import torch

from repro_torch.parallel import sharding as SH


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    master_fp32: bool = True


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32, on the CPU; 0 before the first update
    mu: Any
    nu: Any
    master: Any          # fp32 copy of the params, or () without masters


def _paths(tree, prefix: Tuple = ()) -> List[Tuple]:
    """Key paths of a nested dict's leaves, in sorted key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_paths(tree[k], prefix + (k,)))
        return out
    return [prefix]


def _get(tree, path: Tuple):
    for k in path:
        tree = tree[k]
    return tree


def leaves(tree) -> List[torch.Tensor]:
    """A tree's leaves in sorted key order (``jax.tree.leaves``)."""
    return [_get(tree, p) for p in _paths(tree)]


def tree_map(fn, tree):
    """``jax.tree.map`` over a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unflatten(like, paths: List[Tuple], values: List):
    out = tree_map(lambda _: None, like)
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = v
    return out


def init_state(cfg: AdamWConfig, params) -> AdamWState:
    # zeros_like: a DTensor param gets moments of its own placements
    mu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    nu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    master = (tree_map(lambda p: p.detach().float().clone(), params)
              if cfg.master_fp32 else ())
    return AdamWState(torch.zeros((), dtype=torch.int32), mu, nu, master)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine to ``min_lr_frac * lr`` at
    ``total_steps``; fp32, a 0-d CPU tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in sorted key order, of each leaf's
    sum of squares (fp32)."""
    sq = [torch.sum(torch.square(leaf.float())) for leaf in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState):
    """Returns (new_params, new_state, metrics). New tensors throughout:
    nothing the caller passed in is written."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)

    def upd(p, g, mu, nu, master):
        g = SH.placed_like(g, p).float() * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
        mhat = mu / b1c          # 0-d CPU tensors act as scalars
        nhat = nu / b2c
        base = master if cfg.master_fp32 else p.detach().float()
        new = base - lr * (
            mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * base)
        return tuple(SH.placed_like(t, p) for t in (new.to(p.dtype), mu, nu, new))

    paths = _paths(params)
    flat_master = ([_get(state.master, q) for q in paths]
                   if cfg.master_fp32 else [None] * len(paths))
    with torch.no_grad():
        outs = [upd(_get(params, q), _get(grads, q), _get(state.mu, q),
                    _get(state.nu, q), m)
                for q, m in zip(paths, flat_master)]
    new_p = _unflatten(params, paths, [o[0] for o in outs])
    new_mu = _unflatten(params, paths, [o[1] for o in outs])
    new_nu = _unflatten(params, paths, [o[2] for o in outs])
    new_master = (_unflatten(params, paths, [o[3] for o in outs])
                  if cfg.master_fp32 else ())
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(step, new_mu, new_nu, new_master), metrics
