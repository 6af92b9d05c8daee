"""``shard_map`` on DTensor: a function of local shards, with explicit
collectives on the mesh's axes (the counterpart of ``jax.shard_map`` and
its ``lax`` collectives).

``shard_map(body, mesh, in_specs, out_specs)`` redistributes each DTensor
argument to its spec (a plain tensor is taken as the same full tensor on
every rank), calls ``body`` on the local shards, and wraps the results as
DTensors of ``out_specs``. Specs are partition-spec tuples
(``parallel.sharding.logical_to_pspec``'s form).

Gradients. Inside a body every rank's local tensor is its own variable and
the collectives are ``torch.distributed.nn.functional``'s ``all_reduce``
and ``all_to_all_single``, whose backward is each one's transpose:
``psum`` <-> ``psum``, ``all_gather`` <-> a reduce-scatter, ``all_to_all``
<-> the inverse ``all_to_all``. Every backend runs the same calls. At the edges: an input replicated over a mesh dim gets a
partial gradient there (summed by DTensor when the gradient is read), and
an output replicated over mesh dims hands each rank its full gradient
divided by the ranks it is replicated over, so the transposes sum it back
once.

``batch_local(fn, args, batched)`` is the case every recurrence uses: the
arguments flagged ``batched`` are sharded on dim 0 over the batch axes
(replicated over the rest), the others (weights) are replicated, and
``fn`` runs on each rank's rows, on plain tensors. ``heads_local`` is the
attention's: each rank's rows and, where the model axis divides the head
counts, its share of the heads. ``seq_local`` is decode's: each rank's
rows and its share of a cache's positions, the partial softmaxes summed
over model.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed.nn.functional as DF

from repro_torch.parallel.sharding import (_trim_indivisible, is_dtensor,
                                           mesh_axes, placements)


# ---------------------------------------------------------------------------
# collectives over one mesh axis
# ---------------------------------------------------------------------------


class Axes:
    """The mesh seen from inside a body: sizes, this rank's index, and
    process groups by axis name."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)

    def size(self, axis: str) -> int:
        return self.mesh.size(self.names.index(axis))

    def index(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.mesh.get_group(axis)


#: collectives issued by bodies in this process, by kind (forward calls;
#: a one-rank axis still goes through its process group)
CALLS = {"psum": 0, "pmax": 0, "all_gather": 0, "all_to_all": 0}


def psum(x, axes: Axes, names):
    """``lax.psum`` over one axis name or a tuple of them."""
    for a in (names,) if isinstance(names, str) else names:
        CALLS["psum"] += 1
        # deprecated from torch 2.13 in favour of the functional
        # collectives' all_reduce, whose backward is the same psum
        x = DF.all_reduce(x, group=axes.group(a))
    return x


def pmax(x, axes: Axes, name: str):
    """``lax.pmax`` over one axis; forward only (decode's combine)."""
    import torch.distributed as dist

    CALLS["pmax"] += 1
    return DF.all_reduce(x, op=dist.ReduceOp.MAX, group=axes.group(name))


def pmean(x, axes: Axes, names):
    names = (names,) if isinstance(names, str) else tuple(names)
    return psum(x, axes, names) / math.prod(axes.size(a) for a in names)


def _exchange(xt, axes: Axes, name: str):
    """Block i of ``xt``'s dim 0 to rank i; the blocks received stacked
    on dim 0 in rank order. Its backward is the inverse exchange."""
    return DF.all_to_all_single(torch.empty_like(xt), xt,
                                group=axes.group(name))


def all_gather(x, axes: Axes, name: str, dim: int):
    """``lax.all_gather(..., tiled=True)`` along ``dim``: a copy of ``x``
    to every rank through the exchange, so the backward (the exchange
    back, then the sum over the copies) is the reduce-scatter."""
    CALLS["all_gather"] += 1
    n = axes.size(name)
    got = _exchange(x.unsqueeze(0).expand(n, *x.shape).contiguous(), axes,
                    name)
    return torch.cat(got.unbind(0), dim=dim)


def all_to_all(x, axes: Axes, name: str, split: int, concat: int):
    """``lax.all_to_all(x, name, split_axis, concat_axis, tiled=True)``:
    chunk i of ``split`` goes to rank i; the chunks received are
    concatenated along ``concat`` in rank order."""
    CALLS["all_to_all"] += 1
    got = _exchange(x.movedim(split, 0).contiguous(), axes, name)
    return torch.cat([c.movedim(0, split)
                      for c in got.chunk(axes.size(name), dim=0)], dim=concat)


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------


def _as_dtensor(x, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    if is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _enter(x, mesh, want):
    """The local shard of ``x`` on placements ``want``; its gradient is
    partial where ``want`` replicates."""
    from torch.distributed.tensor import Partial, Replicate

    x = _as_dtensor(x, mesh)
    if tuple(x.placements) != tuple(want):
        x = x.redistribute(mesh, want)
    grad = tuple(Partial() if isinstance(p, Replicate) else p for p in want)
    return x.to_local(grad_placements=grad)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def _leave(t, mesh, want):
    from torch.distributed.tensor import DTensor, Replicate

    reps = math.prod(mesh.size(i) for i, p in enumerate(want)
                     if isinstance(p, Replicate))
    if reps > 1 and t.requires_grad:
        t = _ScaleGrad.apply(t, 1.0 / reps)
    return DTensor.from_local(t, mesh, want, run_check=False)


def shard_map(body, mesh, in_specs: Sequence[tuple], out_specs):
    """``jax.shard_map(body, mesh=mesh, in_specs=..., out_specs=...)``:
    ``body(axes, *local_args)`` gets an ``Axes`` first. ``out_specs`` is
    one spec or a tuple of specs (one a result)."""

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments, {len(in_specs)} specs")
        local = [_enter(a, mesh, placements(s, mesh))
                 for a, s in zip(args, in_specs)]
        out = body(Axes(mesh), *local)
        if isinstance(out, tuple):
            return tuple(_leave(o, mesh, placements(s, mesh))
                         for o, s in zip(out, out_specs))
        return _leave(out, mesh, placements(out_specs, mesh))

    return run


def batch_spec(mesh, shape) -> tuple:
    """Dim 0 over the mesh's batch axes (pod, data) when they divide it,
    the rest whole."""
    names = tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))
    if not names:
        return ()
    return _trim_indivisible((names if len(names) > 1 else names[0],),
                             shape, mesh)


def _run_local(fn, args, specs, out_spec):
    """``fn`` on the local shards of ``args`` (``specs[i](mesh, shape)``
    gives argument i's spec; a spec of ``"same"`` demands that the
    argument already lies so, since ``fn`` writes it in place), its
    results (tensors or nested tuples of them) as DTensors of
    ``out_spec(mesh, shape)``."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)

    def enter(a, spec):
        if not isinstance(a, torch.Tensor):
            return a
        pl, want = spec
        want = placements(want(mesh, a.shape), mesh)
        if pl == "same" and tuple(_as_dtensor(a, mesh).placements) != want:
            raise ValueError(f"an argument written in place lies on "
                             f"{_as_dtensor(a, mesh).placements}, not {want}")
        return _enter(a, mesh, want)

    local = [enter(a, s) for a, s in zip(args, specs)]
    # the results lie as the first argument entered on ``out_spec``: its
    # spec comes from that argument's global shape (a result's local
    # shape may not divide the mesh where the global one does)
    ref = next((a.shape for a, (_, want) in zip(args, specs)
                if want is out_spec and isinstance(a, torch.Tensor)), None)

    def wrap(o):
        if o is None:
            return None
        if isinstance(o, torch.Tensor):
            spec = out_spec(mesh, o.shape) if ref is None else \
                out_spec(mesh, ref)[:o.dim()]
            return _leave(o, mesh, placements(spec, mesh))
        return tuple(wrap(v) for v in o)

    return wrap(fn(*local))


def _whole(mesh, shape):
    return ()


def batch_local(fn, args, batched: Sequence[bool]):
    """``fn(*args)`` on each rank's batch rows when any argument is a
    DTensor, else ``fn(*args)`` as it is. ``batched[i]``: argument i has
    the batch on dim 0 (the rest are replicated weights); arguments that
    are not tensors pass through. The results (a tensor or nested tuples
    of tensors) all have the batch on dim 0."""
    return _run_local(fn, args, [("any", batch_spec if b else _whole)
                                 for b in batched], batch_spec)


def heads_split(mesh, *heads: int) -> bool:
    """Whether attention runs on a share of the heads: the mesh's model
    axis has more than one rank and divides every head count given."""
    n = mesh_axes(mesh).get("model", 1)
    return n > 1 and all(h % n == 0 for h in heads)


def heads_spec(mesh, shape) -> tuple:
    """``batch_spec`` with dim 2 (the heads) over model."""
    parts = list(batch_spec(mesh, shape)) or [None]
    return tuple(parts) + (None, "model")


def heads_local(fn, args, kinds: Sequence):
    """Attention on each rank's batch rows and its share of the heads.
    ``kinds[i]``: ``"h"`` (batch dim 0, heads dim 2: q, k, v), ``"b"``
    (batch dim 0 only), ``None`` (replicated, or not a tensor). When
    ``heads_split`` holds for every head count (q head h reads kv head
    h // (Hq // Hkv), so equal shares keep each group whole) ``fn`` gets
    its rank's heads and its results have them on dim 2; else ``fn`` gets
    every head, as ``batch_local`` gives them. (Decode against a cache
    runs on the cache's positions instead: ``seq_local``.)"""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    split = heads_split(mesh, *(a.shape[2] for a, k in zip(args, kinds)
                                if k == "h"))
    head = heads_spec if split else batch_spec
    table = {"h": ("any", head), "b": ("any", batch_spec),
             None: ("any", _whole)}
    return _run_local(fn, args, [table[k] for k in kinds], head)


# ---------------------------------------------------------------------------
# a sequence-sharded cache (flash-decode)
# ---------------------------------------------------------------------------


def seq_split(mesh, length: int) -> bool:
    """Whether a cache of ``length`` positions lies split over ``model``:
    the model axis has more than one rank and divides it (else the cache
    is whole on every model rank, as ``_trim_indivisible`` places it)."""
    n = mesh_axes(mesh).get("model", 1)
    return n > 1 and length % n == 0


def seq_spec(mesh, shape) -> tuple:
    """``batch_spec`` with dim 1 (a cache's positions) over model where
    it divides (``models.model.cache_logical_axes``' ``kv_seq``)."""
    parts = list(batch_spec(mesh, shape)) or [None]
    if "model" not in mesh_axes(mesh):
        return tuple(parts)
    return _trim_indivisible(tuple(parts) + ("model",), shape, mesh)


class SeqShard:
    """This rank's share of a cache's positions, inside ``seq_local``'s
    body: ``offset`` is the first position it holds. Off a split cache
    (no mesh, or a cache whole on every model rank) the share is the
    whole cache and ``combine`` only normalises."""

    def __init__(self, axes: Axes = None, offset: int = 0):
        self.axes, self.offset = axes, offset

    @property
    def split(self) -> bool:
        return self.axes is not None

    def write(self, cache, new, start: int):
        """Positions ``[start, start + new.shape[1])`` of ``new`` into the
        rank's share of ``cache`` (dim 1), in place: only the rank holding
        a position writes it."""
        n, t = new.shape[1], cache.shape[1]
        lo, hi = max(start, self.offset), min(start + n, self.offset + t)
        if lo < hi:
            cache[:, lo - self.offset:hi - self.offset] = \
                new[:, lo - start:hi - start]

    def combine(self, m, l, o):
        """The attention over every rank's share from each rank's partial
        softmax: ``m`` the max of its scores, ``l`` the sum of their
        exponentials past ``m``, ``o`` (``m``'s shape plus the value dim)
        the unnormalised output. One ``pmax`` of the maxes, then one
        ``psum`` of the rescaled outputs and sums over model."""
        if not self.split:
            return o / l[..., None]
        scale = torch.exp(m - pmax(m, self.axes, "model"))
        both = torch.cat([o * scale[..., None], (l * scale)[..., None]], -1)
        both = psum(both, self.axes, "model")
        return both[..., :-1] / both[..., -1:]


def seq_local(fn, args, kinds: Sequence):
    """``fn(seq, *local)`` on each rank's batch rows and its share of a
    cache's positions: ``kinds[i]`` is ``"b"`` (batch dim 0: the new
    tokens' q, k, v), ``"sw"`` (a cache written in place, batch dim 0 and
    positions dim 1, already lying on ``seq_spec``: ``model.init_cache``
    places it so) or ``None`` (replicated, or not a tensor). ``seq`` is
    the rank's ``SeqShard``; results have the batch on dim 0 and are
    whole over model (``seq.combine`` makes them so). Without a DTensor
    argument ``fn(SeqShard(), *args)``."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(SeqShard(), *args)
    length = next(a.shape[1] for a, k in zip(args, kinds) if k == "sw")
    split = seq_split(mesh, length)

    def body(*local):
        if not split:
            return fn(SeqShard(), *local)
        axes = Axes(mesh)
        share = next(a.shape[1] for a, k in zip(local, kinds) if k == "sw")
        return fn(SeqShard(axes, axes.index("model") * share), *local)

    table = {"b": ("any", batch_spec), "sw": ("same", seq_spec),
             None: ("any", _whole)}
    return _run_local(body, args, [table[k] for k in kinds], batch_spec)
