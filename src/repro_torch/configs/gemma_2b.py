"""Gemma-2B — GeGLU MLP, MQA (single KV head), head_dim=256, 256k vocab.

[arXiv:2403.08295; hf] 18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000.
The huge vocabulary makes the embedding/logits layers the TP-sharding stress case.
"""
from repro_torch.configs.base import ModelConfig, reduce_model

ARCH_ID = "gemma-2b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        activation="geglu",
        tie_embeddings=True,
        source="[arXiv:2403.08295; hf]",
    )


def reduced() -> ModelConfig:
    return reduce_model(full(), head_dim=64)
