"""Architecture config schema + registry: a copy of
``repro/configs/base.py`` (the port imports nothing from ``repro``).

Every assigned architecture registers one ``ModelConfig`` (full size, from
the published literature) plus a reduced smoke variant via ``reduce()``.
``torch_dtype`` stands where the reference has ``jnp_dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.common import pad_to_multiple, torch_dtype


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    decoder: bool = True            # False => encoder-only (no causal mask, no decode)

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    num_dense_layers: int = 0       # leading dense layers (deepseek-v3: 3)
    moe_router_dtype: str = "float32"
    moe_capacity_factor: float = 1.25

    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0              # multi-token-prediction modules

    # --- hybrid/ssm (recurrentgemma, xlstm) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec","rec","attn") tiled
    lru_width: int = 0
    conv1d_width: int = 4
    attn_window: int = 0            # local attention window (0 = global)
    slstm_every: int = 0            # xlstm: sLSTM block period (else mLSTM)

    # --- modality stubs (vlm/audio) ---
    frontend_tokens: int = 0        # stub frontend sequence contribution
    frontend_dim: int = 0

    # --- numerics/runtime ---
    dtype: str = "bfloat16"
    remat: str = "full"             # full | dots | none
    scan_layers: bool = True
    vocab_pad_multiple: int = 256

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, self.vocab_pad_multiple)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def subquadratic(self) -> bool:
        """Supports O(1)-state or windowed decode at 500k context."""
        return self.family in ("hybrid", "ssm")

    @property
    def has_decode(self) -> bool:
        return self.decoder

    def reduce(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        small = dict(
            num_layers=min(self.num_layers, 4 if not self.block_pattern else
                           max(len(self.block_pattern), 3)),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            vocab_pad_multiple=32,
        )
        if self.num_experts:
            small.update(num_experts=min(self.num_experts, 8),
                         num_shared_experts=min(self.num_shared_experts, 1),
                         top_k=min(self.top_k, 2), d_ff_expert=32,
                         num_dense_layers=min(self.num_dense_layers, 1),
                         moe_capacity_factor=8.0)
        if self.use_mla:
            small.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                         qk_rope_head_dim=8, v_head_dim=16, head_dim=None)
        if self.lru_width:
            small.update(lru_width=64)
        if self.slstm_every:
            small.update(slstm_every=2, num_layers=4)
        if self.attn_window:
            small.update(attn_window=8)
        if self.frontend_dim:
            small.update(frontend_dim=32, frontend_tokens=min(self.frontend_tokens, 16))
        if self.mtp_depth:
            small.update(mtp_depth=1)
        small["name"] = self.name + "-smoke"
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Shape sets (assigned: 4 per LM arch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig):
    """Which of the 4 assigned shapes a config runs (skips per DESIGN.md §7)."""
    out = []
    for s in SHAPES.values():
        if s.kind == "decode" and not cfg.has_decode:
            continue  # encoder-only: no decode step
        if s.name == "long_500k" and not cfg.subquadratic:
            continue  # pure full-attention: no sub-quadratic path
        if s.kind == "prefill" and not cfg.decoder:
            # encoder-only "prefill" = one full forward; keep it.
            pass
        out.append(s)
    return out


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # import for side-effect registration
    import repro_torch.configs.all  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    import repro_torch.configs.all  # noqa: F401

    return dict(_REGISTRY)
