"""Mixtral-8x7B — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, SWA 4096.
8 experts do not divide the 16-way model axis, so expert_sharding resolves to TP-MoE
(experts replicated, per-expert FFN hidden sharded — see DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, reduce_model

ARCH_ID = "mixtral-8x7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        activation="swiglu",
        sliding_window=4096,
        num_experts=8,
        num_experts_per_tok=2,
        rope_theta=1e6,
        source="[arXiv:2401.04088; hf]",
    )


def reduced() -> ModelConfig:
    return reduce_model(full())
