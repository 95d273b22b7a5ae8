"""Configs of the port: ``base`` (LM architecture, run, rehearsal, scenario,
training), the paper's ResNet (``resnet50_cl``) and every LM architecture
the JAX package registers (dense, SSM, MoE, hybrid, encoder-decoder and
VLM), resolved by ``get_config(arch_id)`` / ``get_reduced(arch_id)``.
"""
from repro_torch.configs import (
    gemma_2b,
    h2o_danube_1_8b,
    jamba_v01,
    mamba2_370m,
    mixtral_8x7b,
    phi35_moe,
    qwen2_vl_72b,
    resnet50_cl,
    smollm_135m,
    stablelm_3b,
    whisper_tiny,
)
from repro_torch.configs.base import (
    ModelConfig,
    ObsConfig,
    OnlineConfig,
    RehearsalConfig,
    RunConfig,
    SHAPES,
    ScenarioConfig,
    ShapeConfig,
    StrategyConfig,
    TrainConfig,
    cell_applicable,
    reduce_model,
)

REGISTRY = {m.ARCH_ID: m for m in (smollm_135m, h2o_danube_1_8b, stablelm_3b, gemma_2b,
                                   mamba2_370m, mixtral_8x7b, phi35_moe, jamba_v01,
                                   whisper_tiny, qwen2_vl_72b)}
ARCHS = tuple(REGISTRY)


def _module(arch_id: str):
    if arch_id in REGISTRY:
        return REGISTRY[arch_id]
    raise KeyError(f"unknown arch {arch_id!r}; the port has {sorted(REGISTRY)}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).full()


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()


__all__ = ["ARCHS", "REGISTRY", "ModelConfig", "ObsConfig", "OnlineConfig", "RehearsalConfig",
           "RunConfig", "SHAPES", "ScenarioConfig", "ShapeConfig", "StrategyConfig", "TrainConfig", "get_config",
           "get_reduced", "cell_applicable", "reduce_model", "resnet50_cl"]
