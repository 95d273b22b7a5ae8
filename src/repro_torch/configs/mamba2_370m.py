"""Mamba2-370M — attention-free SSM with state-space duality (SSD).

[arXiv:2405.21060; unverified] 48L d_model=1024, ssm_state=128, vocab=50280.
"""
from repro_torch.configs.base import ModelConfig, reduce_model

ARCH_ID = "mamba2-370m"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        num_layers=48,
        d_model=1024,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_conv_dim=4,
        ssm_chunk=128,
        tie_embeddings=True,
        source="[arXiv:2405.21060; unverified]",
    )


def reduced() -> ModelConfig:
    return reduce_model(full())
