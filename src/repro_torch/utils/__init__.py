"""Small shared utilities: rank-aware logging."""
from repro_torch.utils.logging import get_logger, process_rank

__all__ = ["get_logger", "process_rank"]
