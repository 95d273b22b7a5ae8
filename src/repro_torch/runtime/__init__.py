"""The fault-tolerant runtime: the resilient loop and its straggler policy,
the pipeline race sanitizer, elastic resharding, autoscaling and real
multi-process groups."""
from repro_torch.runtime import multiproc
from repro_torch.runtime.autoscale import Autoscaler, TrafficSignal, scale_carry
from repro_torch.runtime.elastic import reshard_carry, reshard_tiered
from repro_torch.runtime.fault_tolerance import (
    TRANSIENT_EXCEPTIONS,
    InjectedFailure,
    ResilientLoop,
    StragglerPolicy,
)
from repro_torch.runtime.sanitizer import (
    PipelineRaceSanitizer,
    SanitizerError,
    sanitize_enabled,
)

__all__ = ["Autoscaler", "InjectedFailure", "PipelineRaceSanitizer", "ResilientLoop",
           "SanitizerError", "StragglerPolicy", "TRANSIENT_EXCEPTIONS", "TrafficSignal",
           "multiproc", "reshard_carry", "reshard_tiered", "sanitize_enabled",
           "scale_carry"]
