"""SmolLM-135M — llama-architecture small dense model.

[hf:HuggingFaceTB/SmolLM-135M; hf] 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig, reduce_model

ARCH_ID = "smollm-135m"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=30,
        d_model=576,
        num_heads=9,
        num_kv_heads=3,
        head_dim=64,
        d_ff=1536,
        vocab_size=49152,
        activation="swiglu",
        tie_embeddings=True,
        source="[hf:HuggingFaceTB/SmolLM-135M; hf]",
    )


def reduced() -> ModelConfig:
    return reduce_model(full())
