"""H2O-Danube-1.8B — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf] 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA.
"""
from repro_torch.configs.base import ModelConfig, reduce_model

ARCH_ID = "h2o-danube-1.8b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=80,
        d_ff=6912,
        vocab_size=32000,
        activation="swiglu",
        sliding_window=4096,
        source="[arXiv:2401.16818; hf]",
    )


def reduced() -> ModelConfig:
    return reduce_model(full())
