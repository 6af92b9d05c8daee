"""Logical-axis -> mesh-axis sharding rules (MaxText-style): a port of
``repro/parallel/sharding.py`` onto DTensor.

Every ParamSpec carries logical axis names; ``logical_to_pspec`` turns them
into a partition spec under a rule table. The spec is the reference's
``PartitionSpec`` as a plain tuple (one entry a tensor dim: ``None``, a
mesh axis name, or a tuple of names, trailing ``None`` trimmed), computed
from the mesh's axis names and sizes only, so it can be held against JAX
on meshes that cannot be built here. ``placements`` turns it into a
DTensor's placements: ``Shard(d)`` on every mesh dim that tensor dim ``d``
maps to, ``Replicate()`` on the rest. A dim on two mesh axes
(``("pod", "data")``) is sharded on both, the first (pod) major, as in
JAX.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims, or, for the pure functions, a ``{axis name: size}`` dict.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import common

# Default rules. "fsdp" axes shard parameters over the data axis (ZeRO-3
# style: the use sites gather them, ``gathered``); "tp" axes shard over the
# model axis (Megatron style). Activations: batch over (pod, data);
# model-parallel activation dims over model.
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    # parameter axes
    "embed_vocab": ("model",),      # vocab dim of embedding/logits
    "embed_d": ("data",),           # d_model dim of embedding (fsdp)
    "fsdp": ("data",),              # generic fsdp param dim
    "tp": ("model",),               # generic tensor-parallel param dim
    "tp_in": ("model",),            # row-parallel input dim (2nd matmul)
    "expert": ("model",),           # expert-parallel expert dim
    "layers": (),                   # stacked-scan layer dim: never sharded
    "none": (),
    # activation axes
    "batch": ("pod", "data"),
    "act_seq": (),                  # sequence dim (context parallel opt-in)
    "act_q_seq": (),                # query seq dim (context-parallel attn)
    "act_kv_seq": (),               # key/value seq dim
    "act_tp": ("model",),           # activation model-parallel dim
    "kv_seq": ("model",),           # sequence-sharded KV cache (flash-decode)
}


def rules_without_pod(rules: Dict[str, Tuple[str, ...]]):
    return {k: tuple(a for a in v if a != "pod") for k, v in rules.items()}


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in the mesh's dim order."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dims have no names")
    return dict(zip(names, mesh.mesh.shape))


def _mesh_axes_for(logical: Optional[str], rules, names) -> Optional[Tuple[str, ...]]:
    if logical is None:
        return None
    axes = rules.get(logical, ())
    axes = tuple(a for a in axes if a in names)
    return axes if axes else None


def logical_to_pspec(logical_axes: Sequence[Optional[str]], rules, mesh) -> tuple:
    """The reference's ``PartitionSpec`` as a tuple: each logical axis's
    mesh axes under ``rules``, present in the mesh and not yet used by an
    earlier dim."""
    names = set(mesh_axes(mesh))
    parts = []
    used = set()
    for ax in logical_axes:
        maxes = _mesh_axes_for(ax, rules, names)
        if maxes is None:
            parts.append(None)
            continue
        maxes = tuple(a for a in maxes if a not in used)
        used.update(maxes)
        if not maxes:
            parts.append(None)
        elif len(maxes) == 1:
            parts.append(maxes[0])
        else:
            parts.append(maxes)
    # trim trailing Nones (canonical form)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


_ACTIVE_RULES = [DEFAULT_RULES]


def active_rules() -> Dict[str, Tuple[str, ...]]:
    return _ACTIVE_RULES[-1]


class use_rules:
    """Context manager: placement pass installs rewritten rules under which
    the model runs (core/placement.py)."""

    def __init__(self, rules):
        self.rules = rules

    def __enter__(self):
        _ACTIVE_RULES.append(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE_RULES.pop()


def _trim_indivisible(pspec: tuple, shape, mesh) -> tuple:
    """Replicate any dim whose size doesn't divide its mesh axes."""
    sizes = mesh_axes(mesh)
    parts = list(pspec)
    parts += [None] * (len(shape) - len(parts))
    for i, p in enumerate(parts):
        if p is None:
            continue
        names = p if isinstance(p, tuple) else (p,)
        degree = math.prod(sizes[n] for n in names)
        if degree and shape[i] % degree != 0:
            parts[i] = None
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements(pspec: tuple, mesh) -> tuple:
    """A partition spec -> one placement a mesh dim. A tensor dim on
    several mesh axes must name them in the mesh's order (pod before
    data), which DTensor shards major to minor."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh_axes(mesh))
    out = [Replicate()] * len(order)
    for dim, p in enumerate(pspec):
        if p is None:
            continue
        names = p if isinstance(p, tuple) else (p,)
        idx = [order.index(n) for n in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {p!r} is not in the mesh's order {order}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def logical_placements(logical_axes, shape, mesh, rules=None) -> tuple:
    """Placements of a tensor of ``shape`` under its logical axes: the
    reference's spec, with indivisible dims replicated."""
    rules = rules or active_rules()
    return placements(_trim_indivisible(
        logical_to_pspec(logical_axes, rules, mesh), shape, mesh), mesh)


class Sharding:
    """The counterpart of a ``NamedSharding``: a mesh and the placements
    of one tensor on it (and the spec they came from)."""

    def __init__(self, mesh, spec: tuple):
        self.mesh, self.spec = mesh, tuple(spec)
        self.placements = placements(self.spec, mesh)

    def place(self, t: torch.Tensor):
        """``t`` (the full tensor, the same on every rank) as a DTensor on
        this sharding; a DTensor is redistributed. A "meta" tensor (the
        dry-run's) becomes a DTensor of meta shards of this rank's shape:
        nothing is allocated and no collective is issued."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        if isinstance(t, DTensor):
            return t.redistribute(self.mesh, self.placements)
        if t.device.type == "meta":
            return meta_dtensor(t.shape, t.dtype, self.mesh, self.placements)
        return distribute_tensor(t.to(self.mesh.device_type), self.mesh,
                                 self.placements)

    def __repr__(self):
        return f"Sharding({self.spec}, {self.placements})"


def local_shape(shape, mesh, pls) -> tuple:
    """The shape of this rank's shard of a ``shape`` tensor on placements
    ``pls``: DTensor's ``torch.chunk`` split, mesh dim by mesh dim."""
    out = list(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(pls):
        if p.is_shard():
            n, d = mesh.size(i), p.dim
            chunk = -(-out[d] // n)
            out[d] = max(min(chunk, out[d] - coord[i] * chunk), 0)
    return tuple(out)


def meta_dtensor(shape, dtype, mesh, pls):
    """A DTensor of ``shape`` on ``pls`` whose local shard is a "meta"
    tensor: shapes, dtypes and strides without storage (the dry-run's
    stand-in for an allocated tensor)."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(local_shape(shape, mesh, pls), dtype=dtype,
                        device="meta")
    stride, step = [], 1
    for n in reversed(shape):       # contiguous, as the global tensor's
        stride.insert(0, step)
        step *= max(n, 1)
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def spec_tree_to_shardings(specs, mesh, rules=None):
    """ParamSpec tree -> ``Sharding`` tree."""
    rules = rules or active_rules()
    return common.map_params(
        lambda s: Sharding(mesh, _trim_indivisible(
            logical_to_pspec(s.logical_axes, rules, mesh), s.shape, mesh)),
        specs)


def shard_tree(tree, shardings):
    """Place every leaf of ``tree`` on its ``Sharding`` (the same tree
    shape): each rank passes the same full tensors."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings[k]) for k, v in tree.items()}
    return shardings.place(tree)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x, logical_axes, mesh=None, rules=None):
    """``with_sharding_constraint`` by logical axis names: a DTensor is
    redistributed to the placements its axes map to (indivisible dims
    replicated); any other tensor comes back unchanged, as the reference
    is a no-op off a mesh."""
    if not is_dtensor(x):
        return x
    want = logical_placements(logical_axes, x.shape, x.device_mesh, rules)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def batch_sharding(mesh, shape) -> Sharding:
    """Dim 0 over the mesh's batch axes (``"batch"``), the rest whole."""
    return Sharding(mesh, _trim_indivisible(
        logical_to_pspec(("batch",), active_rules(), mesh), shape, mesh))


def place_batch(batch: dict, mesh) -> dict:
    """A batch's leaves (each the same full tensor on every rank) as
    DTensors sharded on dim 0 over the batch axes."""
    return {k: v if is_dtensor(v) else batch_sharding(mesh, v.shape).place(v)
            for k, v in batch.items()}


_REPLICATING = [0]


@contextlib.contextmanager
def replicate_plain():
    """Inside, a plain tensor meeting a DTensor in an op counts as the same
    full tensor on every rank (``implicit_replication``, entered once
    however deep the calls nest)."""
    if _REPLICATING[0]:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _REPLICATING[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _REPLICATING[0] -= 1


def full(x):
    """A DTensor's full value on every rank; anything else unchanged."""
    return x.full_tensor() if is_dtensor(x) else x


def placed_like(t, like):
    """A DTensor on ``like``'s placements (an update of a sharded leaf
    stays sharded as the leaf is, as under GSPMD); anything else as is."""
    want = getattr(like, "placements", None)
    if want is None or tuple(t.placements) == tuple(want):
        return t
    return t.redistribute(like.device_mesh, want)


def named_sharding(mesh, *parts) -> Sharding:
    return Sharding(mesh, parts)


def split_heads(t, h: int, hd: int, seq_axis: str, *heads: int):
    """(B, S, h * hd) -> (B, S, h, hd). On a mesh whose model axis does
    not divide every head count the projection's last dim (sharded over
    model) is gathered first: DTensor cannot split a dim sharded 16 ways
    into 8 or 24 heads, and the attention then runs on every head
    (``shard_map.heads_local``)."""
    if is_dtensor(t):
        n = mesh_axes(t.device_mesh).get("model", 1)
        if n > 1 and any(c % n for c in heads):
            t = constrain(t, ("batch", seq_axis, None))
    return t.reshape(t.shape[0], t.shape[1], h, hd)


def gathered(w, logical_axes):
    """FSDP weight-gather at the use site: constrain the weight to its
    fsdp-axes-dropped sharding (a weight all-gather over ``data``)."""
    axes = tuple(None if a in ("fsdp", "embed_d") else a for a in logical_axes)
    return constrain(w, axes)
