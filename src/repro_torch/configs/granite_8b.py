"""granite-8b (code) [dense] — 36L d4096 32H (GQA kv=8) d_ff=14336 vocab=49152.

Llama-style architecture [arXiv:2405.04324].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    qkv_bias=False,
    rope_theta=1e4,
))
