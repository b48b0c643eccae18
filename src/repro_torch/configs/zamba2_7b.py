"""zamba2-7b [hybrid] — 81L d=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64; Mamba2 backbone + 2 alternating shared attention blocks
applied at every 6-layer group boundary [arXiv:2411.15242; unverified]

81 layers = 13 × 6 mamba2 (scanned) + 3 mamba2 tail; shared attn+MLP
(d_ff=14336) invoked after each group (weights shared, per-invocation KV).
"""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="zamba2-7b", family="hybrid", num_layers=81, d_model=3584,
    num_heads=32, num_kv_heads=32, d_ff=14336, vocab_size=32000,
    pattern=("mamba2",) * 6, tail=("mamba2",) * 3, head_dim=112,
    rope_theta=10_000.0, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    shared_attn=True, shared_attn_count=2)

SMOKE = ArchConfig(
    name="zamba2-7b-smoke", family="hybrid", num_layers=9, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
    pattern=("mamba2",) * 3, tail=("mamba2",) * 3, head_dim=16,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16,
    shared_attn=True, shared_attn_count=2)
