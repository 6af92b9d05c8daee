"""The widths of the two LM configurations whose kernels the port runs.

Copied from ``repro/configs/qwen2_5_32b.py`` and ``repro/configs/xlstm_1_3b.py``
(the port imports nothing from ``repro``); only the fields the attention
and sLSTM kernels need. ``dtype`` is ``repro/configs/base.py``'s default.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    dtype: str = "bfloat16"


CONFIGS = {
    # 64L d5120 40H (GQA kv=8) [hf:Qwen/Qwen2.5-*; arXiv:2412.15115]
    "qwen2.5-32b": LMConfig("qwen2.5-32b", d_model=5120, num_heads=40,
                            num_kv_heads=8, head_dim=128),
    # 48L d2048 4H, sLSTM every 8th block [arXiv:2405.04517]; sLSTM heads
    # are d_model // num_heads = 512 wide
    "xlstm-1.3b": LMConfig("xlstm-1.3b", d_model=2048, num_heads=4,
                           num_kv_heads=4, head_dim=512),
}


def get_lm_config(name: str) -> LMConfig:
    if name in CONFIGS:
        return CONFIGS[name]
    raise KeyError(f"unknown LM config {name!r}; have {sorted(CONFIGS)}")
