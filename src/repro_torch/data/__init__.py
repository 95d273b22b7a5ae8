"""Data streams and the host prefetch pipeline of the port."""
from repro_torch.data.pipeline import Cursor, Prefetcher
from repro_torch.data.synthetic import (
    ClassIncrementalImages,
    DriftStreamConfig,
    DriftTokenStream,
    ImageStreamConfig,
    TaskTokenStream,
    TokenStreamConfig,
)

__all__ = ["ClassIncrementalImages", "Cursor", "DriftStreamConfig", "DriftTokenStream",
           "ImageStreamConfig", "Prefetcher", "TaskTokenStream", "TokenStreamConfig"]
