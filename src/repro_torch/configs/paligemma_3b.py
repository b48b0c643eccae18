"""paligemma-3b [vlm] — 18L d=2048 8H (GQA kv=1) d_ff=16384 vocab=257216;
SigLIP vision frontend is a STUB: input_specs() provides 256 precomputed
patch embeddings prepended to the text sequence [arXiv:2407.07726; hf]"""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="paligemma-3b", family="vlm", num_layers=18, d_model=2048,
    num_heads=8, num_kv_heads=1, d_ff=16384, vocab_size=257216,
    pattern=("attn",), head_dim=256, rope_theta=10_000.0, act="gelu",
    num_prefix_embeddings=256, tie_embeddings=True,
    emb_scale_by_sqrt_dim=True)

SMOKE = ArchConfig(
    name="paligemma-3b-smoke", family="vlm", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=1, d_ff=128, vocab_size=512,
    pattern=("attn",), head_dim=16, act="gelu",
    num_prefix_embeddings=8, tie_embeddings=True,
    emb_scale_by_sqrt_dim=True)
