"""Configs of the port: ``base`` (run, rehearsal, scenario, training) and the
model config of the paper's ResNet (``resnet50_cl``)."""
from repro_torch.configs import resnet50_cl
from repro_torch.configs.base import (
    RehearsalConfig,
    RunConfig,
    ScenarioConfig,
    TrainConfig,
)

__all__ = ["RehearsalConfig", "RunConfig", "ScenarioConfig", "TrainConfig",
           "resnet50_cl"]
