from repro_torch.nn.core import glorot, zeros
from repro_torch.nn.optim import (AdamState, Optimizer, adamw,
                                  apply_updates, clip_by_global_norm, sgd)

__all__ = ["glorot", "zeros", "AdamState", "Optimizer", "adamw",
           "apply_updates", "clip_by_global_norm", "sgd"]
