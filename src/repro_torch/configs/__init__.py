"""Paper dataset presets (Table 4 and the §4.3 deep recipe) as
ExperimentSpec factories — copies of `repro.configs.{ppi,reddit,amazon2m}`
building the port's spec classes — and the LM architecture registry of
`repro.configs`: `get_arch`, `ARCH_NAMES` (every arch of the reference),
`cell_supported`, and the model inputs of a cell (`input_specs`,
`make_inputs`)."""
from __future__ import annotations

import importlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig, ShapeConfig

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "gemma3-1b": "gemma3_1b",
    "granite-3-2b": "granite_3_2b",
    "internlm2-20b": "internlm2_20b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "dbrx-132b": "dbrx_132b",
    "hubert-xlarge": "hubert_xlarge",
    "paligemma-3b": "paligemma_3b",
    "xlstm-1.3b": "xlstm_1_3b",
    "zamba2-7b": "zamba2_7b",
}
ARCH_NAMES = tuple(_MODULES)


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port runs "
                       f"{list(ARCH_NAMES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.ARCH


def cell_supported(cfg: ArchConfig, shape: ShapeConfig
                   ) -> Tuple[bool, Optional[str]]:
    """The reference's skip rules for an (arch, shape) cell."""
    if cfg.is_encoder and shape.is_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k":
        ok = cfg.is_subquadratic() or cfg.name.startswith("gemma3")
        if not ok:
            return False, "pure full-attention arch; 500k context skipped"
    return True, None


def input_specs(cfg: ArchConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of the model's data inputs for a cell —
    the reference's keys, global-batch shapes and dtypes."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((B, 1), torch.int32)}
    if cfg.input_mode == "embeddings":           # hubert
        specs = {"embeddings": ((B, S, cfg.d_model), torch.float32)}
        if shape.kind == "train":
            specs["targets"] = ((B, S), torch.int32)
        return specs
    if cfg.num_prefix_embeddings:                # paligemma
        npfx = cfg.num_prefix_embeddings
        return {"prefix_embeddings": ((B, npfx, cfg.d_model),
                                      torch.float32),
                "tokens": ((B, S - npfx), torch.int32)}
    return {"tokens": ((B, S), torch.int32)}


def make_inputs(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Random inputs matching `input_specs` on `device`, drawn in key
    order from a torch.Generator seeded with `seed`: integers uniform
    in [0, vocab), floats standard normal. The reference draws from
    jax.random, which torch cannot reproduce: the two agree in keys,
    shapes and dtypes, not in values."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, (shp, dtype) in input_specs(cfg, shape).items():
        if dtype.is_floating_point:
            out[name] = torch.randn(shp, generator=gen, dtype=dtype,
                                    device=dev)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, shp, generator=gen,
                                      dtype=dtype, device=dev)
    return out
