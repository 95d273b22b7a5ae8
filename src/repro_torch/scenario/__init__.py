"""Scenario-first continual-learning API of the port.

    from repro_torch.configs.base import RunConfig, ScenarioConfig
    from repro_torch.scenario import ContinualTrainer

    result = ContinualTrainer(RunConfig(), device="cpu").fit()
"""
from repro_torch.scenario.base import (
    Problem,
    SCENARIOS,
    Scenario,
    get_scenario,
    register_scenario,
)
from repro_torch.scenario.scenarios import (
    BlurryBoundary,
    ClassIncremental,
    DomainIncremental,
    DriftStream,
    TokenClassIncremental,
    build_token_lm,
)
from repro_torch.scenario.trainer import ContinualTrainer

__all__ = ["BlurryBoundary", "ClassIncremental", "ContinualTrainer", "DomainIncremental",
           "DriftStream", "Problem", "SCENARIOS", "Scenario", "TokenClassIncremental",
           "build_token_lm", "get_scenario", "register_scenario"]
