"""recurrentgemma-2b [hybrid] — 26L d2560 10H (GQA kv=1) d_ff=7680 vocab=256000.

RG-LRU recurrent blocks + local attention, pattern (rec, rec, attn)
[arXiv:2402.19427 (Griffin)]. Sub-quadratic: runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    conv1d_width=4,
    attn_window=2048,
    rope_theta=1e4,
))
