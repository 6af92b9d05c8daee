"""Per-tensor symmetric int8 quantization (``repro.optim.compress``'s
``quantize_int8`` / ``dequantize_int8``), used by the serving path's
``cast_params("int8")`` fake-quant weights."""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8. Returns (q, scale)."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
