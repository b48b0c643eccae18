"""xlstm-1.3b [ssm] — 48L d=2048 4H d_ff=0 vocab=50304; mLSTM + sLSTM
blocks in a 7:1 pattern [arXiv:2405.04517; unverified]

Deviations noted in DESIGN.md: log-sigmoid-bounded gates instead of
exp-gate + max-stabilizer; qk dim = v dim = lstm_inner/heads.
"""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="xlstm-1.3b", family="ssm", num_layers=48, d_model=2048,
    num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
    pattern=("mlstm",) * 7 + ("slstm",), lstm_expand=2, ssm_chunk=128)

SMOKE = ArchConfig(
    name="xlstm-1.3b-smoke", family="ssm", num_layers=8, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=512,
    pattern=("mlstm",) * 3 + ("slstm",), lstm_expand=2, ssm_chunk=16)
