"""Kernels of the port: hand-written CUDA for Hopper (`csrc/`), each with
its plain PyTorch version (`ref`) and a wrapper that picks one by the
device of its inputs; host-side block-ELL builders and the SpMM dispatch
in `ops`."""
from repro_torch.kernels.block_spmm import (BlockEllAdj, spmm_block_ell,
                                            spmm_ell, spmm_fused,
                                            spmm_fused_block_ell)
from repro_torch.kernels.ops import (TileBufferPool, block_ell_adj_from_csr,
                                     block_ell_adj_from_dense,
                                     block_ell_from_csr,
                                     block_ell_from_dense,
                                     block_ell_needed_k,
                                     block_ell_transpose, spmm, spmm_dense,
                                     spmm_xw)
from repro_torch.kernels.ref import spmm_block_ell_ref, spmm_fused_ref

__all__ = ["BlockEllAdj", "spmm_block_ell", "spmm_ell", "spmm_fused",
           "spmm_fused_block_ell", "spmm_block_ell_ref", "spmm_fused_ref",
           "TileBufferPool", "block_ell_adj_from_csr",
           "block_ell_adj_from_dense", "block_ell_from_csr",
           "block_ell_from_dense", "block_ell_needed_k",
           "block_ell_transpose", "spmm", "spmm_dense", "spmm_xw"]
