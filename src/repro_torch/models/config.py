"""Architecture configuration for the unified pattern-stacked LM — a
copy of `repro.models.config` whose `dtype` is a `torch.dtype`.

Block types usable in `pattern` / `tail`:
  attn    — causal global attention + dense MLP
  local   — causal sliding-window attention + dense MLP
  enc     — bidirectional attention + dense MLP (encoder-only archs)
  moe     — causal global attention + MoE FFN
  mamba2  — Mamba2 SSD mixer (no FFN)
  mlstm   — xLSTM matrix-LSTM mixer (no FFN)
  slstm   — xLSTM scalar-LSTM mixer (no FFN)

A model is `num_groups` repetitions of `pattern` (params stacked on a
leading group axis) followed by `tail` (unstacked). `shared_attn` adds
Zamba2-style shared attention+MLP blocks invoked at the end of every
group (weights shared across groups, alternating between
`shared_attn_count` blocks).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

ATTN_KINDS = ("attn", "local", "enc", "moe")
SSM_KINDS = ("mamba2", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[str, ...] = ("attn",)
    tail: Tuple[str, ...] = ()
    head_dim: Optional[int] = None   # default d_model // num_heads

    # attention details
    rope_theta: float = 1e4
    rope_theta_global: Optional[float] = None   # gemma3 global layers
    sliding_window: Optional[int] = None
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    qk_norm: bool = False
    post_norm: bool = False          # gemma3 post-attn/post-ffn norms
    act: str = "silu"                # silu|gelu

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25

    # Mamba2
    ssm_state: int = 0               # N
    ssm_head_dim: int = 64           # P
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # xLSTM
    lstm_expand: int = 2             # mLSTM proj factor
    lstm_conv: int = 4

    # Zamba2 shared blocks
    shared_attn: bool = False
    shared_attn_count: int = 2       # alternating shared blocks

    # embeddings / io
    is_encoder: bool = False
    input_mode: str = "tokens"       # tokens|embeddings (stub frontends)
    num_prefix_embeddings: int = 0   # paligemma image patches
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    emb_scale_by_sqrt_dim: bool = False   # gemma-style

    # numerics
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        body = self.num_groups * len(self.pattern) + len(self.tail)
        assert body == self.num_layers, \
            f"{self.name}: pattern×groups+tail = {body} != {self.num_layers}"

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_groups(self) -> int:
        return (self.num_layers - len(self.tail)) // len(self.pattern)

    @property
    def d_inner(self) -> int:        # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def lstm_inner(self) -> int:
        return self.lstm_expand * self.d_model

    @property
    def lstm_head_v(self) -> int:    # mLSTM value head dim (P)
        return self.lstm_inner // self.num_heads

    @property
    def lstm_head_qk(self) -> int:   # mLSTM query/key head dim (N)
        return self.lstm_inner // self.num_heads

    @property
    def dtype(self) -> torch.dtype:
        dt = getattr(torch, self.compute_dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"{self.name}: compute_dtype "
                             f"{self.compute_dtype!r} is not a torch dtype")
        return dt

    def block_kinds(self) -> Tuple[str, ...]:
        """Every layer's kind in order (groups unrolled + tail)."""
        return self.pattern * self.num_groups + self.tail

    def uses_attention(self) -> bool:
        kinds = set(self.block_kinds())
        return bool(kinds & set(ATTN_KINDS)) or self.shared_attn

    def is_subquadratic(self) -> bool:
        """Eligible for long_500k: no full-attention-over-full-context in
        the *scanned body* (shared/global blocks handled via seq-sharded
        decode are allowed — see DESIGN.md)."""
        kinds = set(self.block_kinds())
        full_attn = {"attn", "moe", "enc"} & kinds
        return not full_attn


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    kind: str                 # train|prefill|decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
