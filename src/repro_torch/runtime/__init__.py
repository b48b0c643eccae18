from repro_torch.runtime.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
