"""hubert-xlarge [audio] — 48L d1280 16H d_ff=5120 vocab=504, encoder-only.

Same backbone as wav2vec2-xlarge [arXiv:2106.07447]. The convolutional
waveform frontend is STUBBED per assignment: input_specs() provides
precomputed 512-d frame embeddings; the model owns the 512->1280
projection. Encoder-only => no decode shapes.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    decoder=False,
    vocab_pad_multiple=16,   # 504 -> 512 (tiny head; pad to 16 not 256)
    frontend_tokens=0,       # seq comes from the shape set
    frontend_dim=512,        # conv feature extractor output dim (stubbed)
))
