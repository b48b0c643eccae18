"""internlm2-20b [dense] — 48L d=6144 48H (GQA kv=8) d_ff=16384 vocab=92544
[arXiv:2403.17297; hf]"""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="internlm2-20b", family="dense", num_layers=48, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=16384, vocab_size=92544,
    pattern=("attn",), head_dim=128, rope_theta=1_000_000.0)

SMOKE = ArchConfig(
    name="internlm2-20b-smoke", family="dense", num_layers=2, d_model=96,
    num_heads=6, num_kv_heads=2, d_ff=192, vocab_size=512,
    pattern=("attn",), head_dim=16, rope_theta=1_000_000.0)
