"""granite-moe-1b-a400m [moe] — 24L d=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="granite-moe-1b-a400m", family="moe", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=8, d_ff=0, vocab_size=49155,
    pattern=("moe",), head_dim=64, rope_theta=10_000.0,
    num_experts=32, experts_per_token=8, moe_d_ff=512,
    tie_embeddings=True)

SMOKE = ArchConfig(
    name="granite-moe-1b-a400m-smoke", family="moe", num_layers=2,
    d_model=64, num_heads=4, num_kv_heads=2, d_ff=0, vocab_size=512,
    pattern=("moe",), head_dim=16, num_experts=8, experts_per_token=2,
    moe_d_ff=32, tie_embeddings=True)
