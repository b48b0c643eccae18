"""Kernels of the port: hand-written CUDA for Hopper (`csrc/`), each with
its plain PyTorch version (`ref`) and a wrapper that picks one by the
device of its inputs; host-side block-ELL builders and the SpMM dispatch
in `ops`, with the attention dispatch `multi_head_attention` (the flash
kernel's wrapper is `kernels.flash_attention.flash_attention`; the
module keeps its name, so its `LAUNCHES` count stays reachable)."""
from repro_torch.kernels.block_spmm import (BlockEllAdj, BlockEllCoords,
                                            scatter_tiles, spmm_block_ell,
                                            spmm_ell, spmm_fused,
                                            spmm_fused_block_ell)
from repro_torch.kernels.ops import (TileBufferPool, block_ell_adj_from_csr,
                                     block_ell_adj_from_dense,
                                     block_ell_coords_from_csr,
                                     block_ell_from_csr,
                                     block_ell_from_dense,
                                     block_ell_needed_k,
                                     block_ell_transpose,
                                     multi_head_attention, spmm, spmm_dense,
                                     spmm_xw)
from repro_torch.kernels.ref import (flash_attention_ref, mha_ref,
                                     multi_head_attention_ref,
                                     spmm_block_ell_ref, spmm_fused_ref)

__all__ = ["BlockEllAdj", "BlockEllCoords", "scatter_tiles",
           "spmm_block_ell", "spmm_ell", "spmm_fused",
           "spmm_fused_block_ell", "spmm_block_ell_ref", "spmm_fused_ref",
           "flash_attention_ref", "mha_ref",
           "multi_head_attention", "multi_head_attention_ref",
           "TileBufferPool", "block_ell_adj_from_csr",
           "block_ell_adj_from_dense", "block_ell_coords_from_csr",
           "block_ell_from_csr",
           "block_ell_from_dense", "block_ell_needed_k",
           "block_ell_transpose", "spmm", "spmm_dense", "spmm_xw"]
