"""Qwen2-VL-72B — VLM backbone with M-RoPE; vision frontend is a patch-embedding stub.

[arXiv:2409.12191; hf] 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
The decoder takes precomputed patch/text embeddings (``batch["embeddings"]``) plus 3D
(t,h,w) position ids (``batch["positions"]``), or token ids with 1-D positions.
"""
from repro_torch.configs.base import ModelConfig, reduce_model

ARCH_ID = "qwen2-vl-72b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        activation="swiglu",
        m_rope=True,
        m_rope_sections=(16, 24, 24),
        rope_theta=1e6,
        frontend="patch_stub",
        source="[arXiv:2409.12191; hf]",
    )


def reduced() -> ModelConfig:
    return reduce_model(full(), m_rope_sections=(8, 4, 4))
