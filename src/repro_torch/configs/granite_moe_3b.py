"""granite-moe-3b-a800m [moe] — 32L d1536 24H (GQA kv=8) d_ff_expert=512
vocab=49155, 40 experts top-8 [hf:ibm-granite/granite-3.0-3b-a800m-base].

Experts are TP-sharded (d_ff 512 over model axis) rather than
expert-parallel: 40 experts do not divide the 16-way model axis —
see DESIGN.md §7.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=0,
    vocab_size=49155,
    num_experts=40,
    num_shared_experts=0,
    top_k=8,
    d_ff_expert=512,
    rope_theta=1e4,
))
