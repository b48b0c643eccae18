from repro_torch.nn.core import (REMAT_POLICIES, accumulate_gradients,
                                 count_params, glorot, maybe_remat,
                                 tree_bytes, zeros)
from repro_torch.nn.optim import (AdamState, Optimizer, adamw,
                                  apply_updates, clip_by_global_norm, sgd)

__all__ = ["REMAT_POLICIES", "accumulate_gradients", "count_params",
           "glorot", "maybe_remat", "tree_bytes", "zeros", "AdamState",
           "Optimizer", "adamw", "apply_updates", "clip_by_global_norm",
           "sgd"]
