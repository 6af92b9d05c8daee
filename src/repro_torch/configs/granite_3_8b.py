"""granite-3-8b [dense] — 40L d4096 32H (GQA kv=8) d_ff=12800 vocab=49155.

GQA [hf:ibm-granite/granite-3.0-8b-base].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,   # padded to 49408 for TP-16 (base.padded_vocab)
    qkv_bias=False,
    rope_theta=1e4,
))
