"""Jamba-v0.1 (52B) — Mamba+attention 1:7 interleave with 16-expert MoE every 2nd layer.

[arXiv:2403.19887; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Layer i is attention iff i % 8 == 4 (1:7 attn:mamba); MoE iff i % 2 == 1.
16 experts divide the model axis -> EP. Hybrid => long_500k runs (attn layers use the
SSM-free KV cache; full-attn layers are only 4/32 of the stack and cache is head-sharded).
Jamba v0.1 uses Mamba-1 blocks; we substitute our Mamba-2 SSD block (noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, reduce_model

ARCH_ID = "jamba-v0.1-52b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        activation="swiglu",
        use_rope=False,  # jamba omits positional embeddings (mamba layers carry position)
        num_experts=16,
        num_experts_per_tok=2,
        moe_layer_period=2,
        attn_layer_period=8,
        attn_layer_offset=4,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_conv_dim=4,
        ssm_chunk=128,
        source="[arXiv:2403.19887; hf]",
    )


def reduced() -> ModelConfig:
    return reduce_model(full(), attn_layer_period=4, attn_layer_offset=1, num_layers=8)
