"""gemma3-1b [dense] — 26L d=1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5:1 local:global sliding window [hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.config import ArchConfig

# 26 layers = 4 × (5 local + 1 global) + 2 local tail
ARCH = ArchConfig(
    name="gemma3-1b", family="dense", num_layers=26, d_model=1152,
    num_heads=4, num_kv_heads=1, d_ff=6912, vocab_size=262144,
    pattern=("local",) * 5 + ("attn",), tail=("local", "local"),
    head_dim=256, rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    sliding_window=512, qk_norm=True, post_norm=True, act="gelu",
    tie_embeddings=True, emb_scale_by_sqrt_dim=True)

SMOKE = ArchConfig(
    name="gemma3-1b-smoke", family="dense", num_layers=8, d_model=64,
    num_heads=4, num_kv_heads=1, d_ff=128, vocab_size=512,
    pattern=("local",) * 2 + ("attn",), tail=("local", "local"),
    head_dim=16, rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    sliding_window=8, qk_norm=True, post_norm=True, act="gelu",
    tie_embeddings=True, emb_scale_by_sqrt_dim=True)
