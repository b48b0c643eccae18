from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.resilience import ElasticPlan

__all__ = ["CheckpointManager", "ElasticPlan"]
