"""Phi-3.5-MoE (42B total / 6.6B active) — 16-expert top-2 MoE.

[hf:microsoft/Phi-3.5-MoE-instruct; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, 16 experts top-2. 16 experts divide the 16-way model axis exactly, so
expert_sharding resolves to EP (sort-based capacity dispatch, all_to_all over 'model').
"""
from repro_torch.configs.base import ModelConfig, reduce_model

ARCH_ID = "phi3.5-moe-42b-a6.6b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32064,
        activation="swiglu",
        num_experts=16,
        num_experts_per_tok=2,
        rope_theta=10000.0,
        source="[hf:microsoft/Phi-3.5-MoE-instruct; hf]",
    )


def reduced() -> ModelConfig:
    return reduce_model(full())
