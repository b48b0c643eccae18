"""dbrx-132b [moe] — 40L d=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4 [hf:databricks/dbrx-base; unverified]"""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="dbrx-132b", family="moe", num_layers=40, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=0, vocab_size=100352,
    pattern=("moe",), head_dim=128, rope_theta=500_000.0,
    num_experts=16, experts_per_token=4, moe_d_ff=10752)

SMOKE = ArchConfig(
    name="dbrx-132b-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=0, vocab_size=512,
    pattern=("moe",), head_dim=16, num_experts=4, experts_per_token=2,
    moe_d_ff=64)
