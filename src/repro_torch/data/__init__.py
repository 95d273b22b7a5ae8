"""Data streams and the host prefetch pipeline of the port."""
from repro_torch.data.pipeline import Cursor, Prefetcher
from repro_torch.data.synthetic import (
    BlurryBoundaryImages,
    BlurryStreamConfig,
    ClassIncrementalImages,
    DomainIncrementalImages,
    DomainStreamConfig,
    DriftStreamConfig,
    DriftTokenStream,
    ImageStreamConfig,
    TaskTokenStream,
    TokenStreamConfig,
)

__all__ = ["BlurryBoundaryImages", "BlurryStreamConfig", "ClassIncrementalImages", "Cursor",
           "DomainIncrementalImages", "DomainStreamConfig", "DriftStreamConfig",
           "DriftTokenStream", "ImageStreamConfig", "Prefetcher", "TaskTokenStream",
           "TokenStreamConfig"]
