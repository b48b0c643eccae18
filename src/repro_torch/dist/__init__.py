"""Step builders and gradient compression — `repro.dist` on
torch.distributed: the LM training step and its state spec, the LM
serving steps (prefill, decode, encode) and the data-parallel GCN step
(`steps`), the compressed all-reduce (`compression`), and the per-cell
policy (`sharding.CellPolicy`; the reference's mesh sharding rules wait
for ROADMAP A7)."""
from repro_torch.dist.compression import (DEFAULT_GROUP_SIZE,
                                          bf16_psum_mean,
                                          compressed_psum_mean, dequantize,
                                          psum_mean, quantize_symmetric)
from repro_torch.dist.sharding import CellPolicy
from repro_torch.dist.steps import (init_gcn_train_state,
                                    make_decode_step, make_encode_step,
                                    make_gcn_train_step, make_prefill_step,
                                    make_train_step, spec_train_state)

__all__ = ["CellPolicy", "make_train_step", "spec_train_state",
           "DEFAULT_GROUP_SIZE", "bf16_psum_mean", "compressed_psum_mean",
           "dequantize", "psum_mean", "quantize_symmetric",
           "init_gcn_train_state", "make_decode_step",
           "make_encode_step", "make_gcn_train_step", "make_prefill_step"]
