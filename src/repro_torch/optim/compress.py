"""Per-tensor symmetric int8 quantization and error-feedback (EF-int8)
gradient compression: the counterpart of ``repro.optim.compress``.

``quantize_int8`` / ``dequantize_int8`` also serve the serving path's
``cast_params("int8")`` fake-quant weights. ``ef_compress_grads`` is the
reference's gradient transformation for the cross-pod hop: each gradient
plus its carried residual is quantized to int8 and back, and what the
round trip lost is the next residual (EF-SGD). It reproduces the numerics
of a compressed reduction; the wire saving is ``POD_WIRE_BYTES_SCALE``,
accounted analytically. ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.parallel.sharding import placed_like

from repro_torch.common import map_params


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8. Returns (q, scale)."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params) -> Any:
    """fp32 zeros shaped as ``params``, on each leaf's device (a DTensor
    leaf's on its placements)."""
    return map_params(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params)


def ef_compress_grads(grads, error_state):
    """EF-int8 transform: returns (decompressed_grads, new_error_state),
    new trees of ``grads``' structure; neither argument is written."""

    def walk(g, e):
        if isinstance(g, dict):
            pairs = {k: walk(g[k], e[k]) for k in g}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        # a sharded gradient on its error leaf's placements first: the
        # scale is the whole leaf's amax either way
        compensated = placed_like(g, e).float() + e
        deq = dequantize_int8(*quantize_int8(compensated))
        return deq.to(g.dtype), compensated - deq

    with torch.no_grad():
        return walk(grads, error_state)


#: analytic wire-format scale for pod-crossing collectives when EF-int8 is
#: enabled (int8 payload + negligible fp32 scale per tensor).
POD_WIRE_BYTES_SCALE = 0.25
