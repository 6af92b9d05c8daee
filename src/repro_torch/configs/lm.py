"""The attention and sLSTM widths of an LM configuration, for the kernel
phases and probes (``chip_smoke.phase_lm_kernels``, ``kernel_probe``).

Read from the port's registry (``configs/base.get_config``), so the LM
widths have one source: ``head_dim`` is the configuration's ``hd``
(xlstm-1.3b's sLSTM heads are ``d_model // num_heads`` = 512 wide).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import get_config


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    dtype: str = "bfloat16"


def get_lm_config(name: str) -> LMConfig:
    cfg = get_config(name)
    return LMConfig(cfg.name, d_model=cfg.d_model, num_heads=cfg.num_heads,
                    num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
                    dtype=cfg.dtype)
