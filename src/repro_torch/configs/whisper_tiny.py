"""Whisper-tiny — encoder-decoder; conv/audio frontend is a stub per spec.

[arXiv:2212.04356; unverified] 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
The encoder takes precomputed frame embeddings [B, T_enc, d_model] (``batch["frames"]``);
the decoder trains/serves text tokens with cross-attention into encoder states.
"""
from repro_torch.configs.base import ModelConfig, reduce_model

ARCH_ID = "whisper-tiny"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="encdec",
        num_layers=4,  # decoder layers
        num_encoder_layers=4,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51865,
        activation="gelu",
        norm="layernorm",
        use_rope=False,  # whisper uses absolute positions; we use learned embeddings
        frontend="frame_stub",
        source="[arXiv:2212.04356; unverified]",
    )


def reduced() -> ModelConfig:
    return reduce_model(full())
