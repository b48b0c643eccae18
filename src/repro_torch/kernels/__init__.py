"""Kernels of the port: hand-written CUDA for Hopper (`csrc/`), each with
its plain PyTorch version (`ref`) and a wrapper that picks one by the
device of its inputs; host-side block-ELL builders in `ops`."""
from repro_torch.kernels.block_spmm import spmm_block_ell
from repro_torch.kernels.ops import (TileBufferPool, block_ell_from_csr,
                                     block_ell_needed_k)
from repro_torch.kernels.ref import spmm_block_ell_ref

__all__ = ["spmm_block_ell", "spmm_block_ell_ref", "TileBufferPool",
           "block_ell_from_csr", "block_ell_needed_k"]
