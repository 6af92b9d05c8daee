"""Device resolution and CRONet parameter creation.

Parameters are a nested dict ``{"trunk": {...}, "branch": {...}}`` of
tensors in the JAX package's layouts (``repro.core.cronet.param_specs``):
DHWIO / HWIO conv weights and ``(K, N)`` FC weights.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.cronet import CRONetConfig

Params = Dict[str, Dict[str, torch.Tensor]]


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


def params_from_jax(tree, device="cpu") -> Params:
    """The JAX parameter tree (nested dict of arrays in
    ``repro.core.cronet.param_specs`` layout, e.g. ``jax.device_get`` of
    it) as the port's parameters. Layouts are shared, so this is a copy;
    bfloat16 leaves stay bfloat16, everything else becomes float32."""
    dev = torch.device(device)
    out: Params = {}
    for part, leaves in tree.items():
        out[part] = {}
        for name, a in leaves.items():
            bf16 = "bfloat16" in str(getattr(a, "dtype", ""))
            t = torch.from_numpy(np.asarray(a, dtype=np.float32).copy())
            out[part][name] = t.to(torch.bfloat16 if bf16 else torch.float32
                                   ).to(dev)
    return out


def map_params(fn, params: Params) -> Params:
    """Apply ``fn`` to every weight tensor (the port's ``jax.tree.map``)."""
    return {part: {k: fn(v) for k, v in leaves.items()}
            for part, leaves in params.items()}
