"""Device resolution, parameter declaration and creation, tree helpers.

Parameters are nested dicts of tensors in the JAX package's layouts:
CRONet's ``{"trunk": {...}, "branch": {...}}`` (``repro.core.cronet
.param_specs``: DHWIO / HWIO conv weights, ``(K, N)`` FC weights), and
the LM models' ``ParamSpec`` trees (``repro/common.py``: stacked layers,
``(K, N)`` weights), materialized under the same key paths.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.cronet import CRONetConfig

Params = Dict[str, Any]         # nested dicts of tensors
PyTree = Any


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point. A CUDA device without a GPU is
    an error, never a silent move to the CPU: the caller asks for the CPU
    explicitly (``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def param_shapes(cfg: CRONetConfig) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Weight shapes, in the JAX package's layouts."""
    c = cfg
    return {
        "branch": {
            "conv1": (3, 3, 1, c.b_c1),
            "conv2": (3, 3, c.b_c1, c.b_c2),
            "fc1": (c.rnn_hidden, c.mid),
            "fc2": (c.mid, c.p),
            "rnn_wh": (c.rnn_hidden, c.rnn_hidden),
            "rnn_wx": (c.branch_features, c.rnn_hidden),
        },
        "trunk": {
            "conv1": (2, 3, 3, 1, c.t_c1),
            "conv2": (1, 3, 3, c.t_c1, c.t_c2),
            "fc1": (c.trunk_features, c.mid),
            "fc2": (c.mid, c.p),
        },
    }


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name ("float32", "bfloat16")."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def init_params(cfg: CRONetConfig, seed: int = 0, device="cuda",
                dtype: Optional[str] = None) -> Params:
    """Random CRONet weights with the JAX package's rule (common.py
    ``_resolve_init``, init ``"normal"``): N(0, 1) scaled by
    ``1/sqrt(shape[0])``, in ``cfg.dtype`` unless ``dtype`` is given.

    Draws come from one ``torch.Generator`` seeded with ``seed``, on the
    CPU, leaf by leaf in sorted key order, then move to ``device`` — so the
    CPU and the GPU get the same weights. They are not JAX's numbers for
    the same seed; tests carry JAX weights over with ``params_from_jax``.
    """
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    gen = torch.Generator().manual_seed(int(seed))
    out: Params = {}
    for part, shapes in sorted(param_shapes(cfg).items()):
        out[part] = {}
        for name, shape in sorted(shapes.items()):
            std = 1.0 / math.sqrt(max(shape[0], 1))
            w = torch.randn(shape, generator=gen, dtype=torch.float32) * std
            out[part][name] = w.to(dt).to(dev)
    return out


def params_from_jax(tree, device="cuda") -> Params:
    """A JAX parameter tree (nested dicts of arrays of any depth, e.g.
    ``jax.device_get`` of ``repro.core.cronet`` or ``repro.models.model``
    parameters) as the port's parameters on ``device`` (the card unless
    the caller asks for the CPU). Layouts and key paths are shared, so
    this is a copy; bfloat16 leaves stay bfloat16, everything else
    becomes float32."""
    dev = resolve_device(device)

    def leaf(a):
        bf16 = "bfloat16" in str(getattr(a, "dtype", ""))
        t = torch.from_numpy(np.asarray(a, dtype=np.float32).copy())
        return t.to(torch.bfloat16 if bf16 else torch.float32).to(dev)

    return map_params(leaf, tree)


def map_params(fn, params: PyTree) -> PyTree:
    """Apply ``fn`` to every leaf of a tree of nested dicts (the port's
    ``jax.tree.map``); keys keep their order."""
    if isinstance(params, dict):
        return {k: map_params(fn, v) for k, v in params.items()}
    return fn(params)


def tree_leaves(tree: PyTree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs of a tree of nested dicts in JAX's flatten
    order (sorted keys), paths joined by "/" (e.g. ``blocks/attn/wq``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


# ---------------------------------------------------------------------------
# Parameter declarations (repro/common.py:26-129)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor.

    shape        : tensor shape
    logical_axes : one logical axis name per dim (the reference's sharding
                   names; kept for the mesh slice); None = replicated dim
    init         : 'normal' | 'zeros' | 'ones' | ('scaled', fan_in) |
                   ('uniform', scale) | ('constant', value)
    dtype        : parameter dtype
    """

    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    init: Any = "normal"
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"shape {self.shape} vs axes {self.logical_axes}")


def _resolve_init(spec: ParamSpec, gen: torch.Generator,
                  dev: torch.device) -> torch.Tensor:
    """One leaf under the reference's rules (``_resolve_init``). "normal"
    takes ``fan_in = shape[0]``: on a stacked ``(layers, d, k)`` weight
    that is the layer count, as in the reference."""
    init, shape = spec.init, spec.shape
    if init == "zeros":
        return torch.zeros(shape, dtype=spec.dtype, device=dev)
    if init == "ones":
        return torch.ones(shape, dtype=spec.dtype, device=dev)
    if init == "normal" or (isinstance(init, tuple) and init[0] == "scaled"):
        fan_in = (shape[0] if shape else 1) if init == "normal" else init[1]
        std = 1.0 / math.sqrt(max(fan_in, 1))
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return w.mul_(std).to(spec.dtype)
    if isinstance(init, tuple) and init[0] == "uniform":
        w = torch.rand(shape, generator=gen, dtype=torch.float32, device=dev)
        return w.mul_(2 * init[1]).sub_(init[1]).to(spec.dtype)
    if isinstance(init, tuple) and init[0] == "constant":
        return torch.full(shape, init[1], dtype=spec.dtype, device=dev)
    raise ValueError(f"unknown init {init!r}")


def materialize(specs: PyTree, seed: int = 0, device="cuda") -> Params:
    """Real parameters from a ParamSpec tree, on ``device`` (the card
    unless the caller asks for the CPU). Draws come from one
    ``torch.Generator`` on ``device`` seeded with ``seed``, leaf by leaf in
    sorted key order: billions of draws stay on the card. They are not
    JAX's numbers for the same seed, nor the CPU's for the same seed on
    the card; tests carry JAX weights over with ``params_from_jax``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    made = {path: _resolve_init(spec, gen, dev)
            for path, spec in tree_leaves(specs)}

    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in tree.items()}
        return made[prefix[:-1]]

    return build(specs)


def param_count(specs: PyTree) -> int:
    return sum(math.prod(s.shape) for _, s in tree_leaves(specs))


def param_bytes(specs: PyTree) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for _, s in tree_leaves(specs))


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def tree_bytes(tree: PyTree) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def cast_tree(tree: PyTree, dtype) -> PyTree:
    return map_params(
        lambda t: t.to(dtype) if isinstance(t, torch.Tensor) else t, tree)
