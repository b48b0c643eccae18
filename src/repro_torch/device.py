"""Device resolution for the port's entry points.

Every entry point takes an explicit `device=` and defaults to "cuda".
Asking for CUDA on a host without a visible GPU raises: nothing drifts
to the CPU unless the caller passes device="cpu" (as the CPU tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device, raising when it names CUDA and no GPU
    is visible. On CUDA it also pins the fp32 matmul contract."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA GPU is "
                f"visible; pass device='cpu' to run on the host")
        # The serving contract is fp32: TF32 keeps ~3 decimal digits and
        # would break parity with the host oracle, so it is switched off
        # explicitly for matmuls (and for cuDNN, which defaults to on).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' "
                         f"or 'cpu'")
    return dev
