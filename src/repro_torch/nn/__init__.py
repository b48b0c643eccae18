from repro_torch.nn.core import glorot, zeros

__all__ = ["glorot", "zeros"]
