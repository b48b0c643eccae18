"""Step builders and gradient compression — `repro.dist` on
torch.distributed: the LM serving steps (prefill, decode, encode) and
the data-parallel GCN step (`steps`), and the compressed all-reduce
(`compression`). The reference's model-axis sharding rules
(`dist/sharding.py`) belong to the LM training stack and are not
ported yet."""
from repro_torch.dist.compression import (DEFAULT_GROUP_SIZE,
                                          bf16_psum_mean,
                                          compressed_psum_mean, dequantize,
                                          psum_mean, quantize_symmetric)
from repro_torch.dist.steps import (init_gcn_train_state,
                                    make_decode_step, make_encode_step,
                                    make_gcn_train_step, make_prefill_step)

__all__ = ["DEFAULT_GROUP_SIZE", "bf16_psum_mean", "compressed_psum_mean",
           "dequantize", "psum_mean", "quantize_symmetric",
           "init_gcn_train_state", "make_decode_step",
           "make_encode_step", "make_gcn_train_step", "make_prefill_step"]
