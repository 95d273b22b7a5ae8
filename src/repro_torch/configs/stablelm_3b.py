"""StableLM-3B — dense decoder with full multi-head KV (kv=heads).

[hf:stabilityai/stablelm-2-1_6b; unverified] 32L d_model=2560 32H (GQA kv=32)
d_ff=6912 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig, reduce_model

ARCH_ID = "stablelm-3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=32,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=6912,
        vocab_size=50304,
        activation="swiglu",
        norm="layernorm",
        source="[hf:stabilityai/stablelm-2-1_6b; unverified]",
    )


def reduced() -> ModelConfig:
    return reduce_model(full(), num_kv_heads=4)
