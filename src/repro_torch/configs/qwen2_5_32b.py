"""qwen2.5-32b [dense] — 64L d5120 40H (GQA kv=8) d_ff=27648 vocab=152064.

GQA with QKV bias [hf:Qwen/Qwen2.5-*; arXiv:2412.15115].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
))
