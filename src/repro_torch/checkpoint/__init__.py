from repro_torch.checkpoint.manager import CheckpointManager, reshard_buffer

__all__ = ["CheckpointManager", "reshard_buffer"]
