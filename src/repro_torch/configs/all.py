"""Import every assigned architecture config for registry side-effects."""
from repro_torch.configs import (  # noqa: F401
    qwen2_5_32b,
    qwen2_72b,
    granite_3_8b,
    granite_8b,
    recurrentgemma_2b,
    internvl2_1b,
    xlstm_1_3b,
    deepseek_v3_671b,
    granite_moe_3b,
    hubert_xlarge,
)

ASSIGNED = [
    "qwen2.5-32b",
    "qwen2-72b",
    "granite-3-8b",
    "granite-8b",
    "recurrentgemma-2b",
    "internvl2-1b",
    "xlstm-1.3b",
    "deepseek-v3-671b",
    "granite-moe-3b-a800m",
    "hubert-xlarge",
]
