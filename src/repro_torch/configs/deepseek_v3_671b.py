"""deepseek-v3-671b [moe] — 61L d7168 128H d_ff_expert=2048 vocab=129280.

MLA attention (q_lora 1536, kv_lora 512, nope 128 + rope 64, v 128),
1 shared + 256 routed experts top-8, first 3 layers dense (d_ff 18432),
MTP depth 1 [arXiv:2412.19437].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,       # MLA: per-head KV reconstructed from 512-d latent
    d_ff=18432,             # dense-layer FFN width (layers 0..2)
    vocab_size=129280,
    num_experts=256,
    num_shared_experts=1,
    top_k=8,
    d_ff_expert=2048,
    num_dense_layers=3,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mtp_depth=1,
    rope_theta=1e4,
))
