"""Configs of the port: ``base`` (LM architecture, run, rehearsal, scenario,
training), the paper's ResNet (``resnet50_cl``) and the ported LM
architectures (dense, SSM, MoE and hybrid), resolved by
``get_config(arch_id)`` / ``get_reduced(arch_id)``.
"""
from repro_torch.configs import (
    gemma_2b,
    h2o_danube_1_8b,
    jamba_v01,
    mamba2_370m,
    mixtral_8x7b,
    phi35_moe,
    resnet50_cl,
    smollm_135m,
    stablelm_3b,
)
from repro_torch.configs.base import (
    ModelConfig,
    ObsConfig,
    OnlineConfig,
    RehearsalConfig,
    RunConfig,
    ScenarioConfig,
    StrategyConfig,
    TrainConfig,
    reduce_model,
)

REGISTRY = {m.ARCH_ID: m for m in (smollm_135m, h2o_danube_1_8b, stablelm_3b, gemma_2b,
                                   mamba2_370m, mixtral_8x7b, phi35_moe, jamba_v01)}
ARCHS = tuple(REGISTRY)
# Architectures the JAX package registers that the port does not have yet
# (ROADMAP Queue 1 item 11: the enc-dec and VLM stacks).
UNPORTED = ("whisper-tiny", "qwen2-vl-72b")


def _module(arch_id: str):
    if arch_id in REGISTRY:
        return REGISTRY[arch_id]
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP Queue 1 item 11); the port "
            f"has {sorted(REGISTRY)}")
    raise KeyError(f"unknown arch {arch_id!r}; the port has {sorted(REGISTRY)}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).full()


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()


__all__ = ["ARCHS", "REGISTRY", "ModelConfig", "ObsConfig", "OnlineConfig", "RehearsalConfig",
           "RunConfig", "ScenarioConfig", "StrategyConfig", "TrainConfig", "get_config",
           "get_reduced", "reduce_model", "resnet50_cl"]
