"""hubert-xlarge [audio] — 48L d=1280 16H (kv=16) d_ff=5120 vocab=504;
encoder-only; conv waveform frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, S, d) [arXiv:2106.07447; unverified]"""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="hubert-xlarge", family="audio", num_layers=48, d_model=1280,
    num_heads=16, num_kv_heads=16, d_ff=5120, vocab_size=504,
    pattern=("enc",), head_dim=80, act="gelu", is_encoder=True,
    input_mode="embeddings")

SMOKE = ArchConfig(
    name="hubert-xlarge-smoke", family="audio", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=64,
    pattern=("enc",), head_dim=16, act="gelu", is_encoder=True,
    input_mode="embeddings")
