"""xlstm-1.3b [ssm] — 48L d2048 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks [arXiv:2405.04517]; block ratio ~7 mLSTM : 1 sLSTM
(slstm_every=8). d_ff=0 per assignment: feed-forward lives inside the
xLSTM block projections (mLSTM up-projection factor 2). Sub-quadratic:
runs long_500k with O(1) recurrent state.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
))
