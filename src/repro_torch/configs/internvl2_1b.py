"""internvl2-1b [vlm] — 24L d896 14H (GQA kv=2) d_ff=4864 vocab=151655.

InternViT-300M frontend (STUBBED per assignment: input_specs() provides
precomputed patch embeddings of dim 1024) + Qwen2-0.5B-style LM backbone
[arXiv:2404.16821].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,  # padded to 151808 for TP-16
    qkv_bias=True,
    rope_theta=1e6,
    frontend_tokens=256,   # 448x448 image, patch 28 -> 256 visual tokens
    frontend_dim=1024,     # InternViT-300M hidden size
))
