"""Paper dataset presets (Table 4 and the §4.3 deep recipe) as
ExperimentSpec factories — copies of `repro.configs.{ppi,reddit,amazon2m}`
building the port's spec classes — and the LM architecture registry of
`repro.configs`: `get_arch`, `ARCH_NAMES` (the archs the port runs) and
`cell_supported`. An arch of the reference that the port does not run
yet raises NotImplementedError naming its ROADMAP item."""
from __future__ import annotations

import importlib
from typing import Optional, Tuple

from repro_torch.models.config import ArchConfig, ShapeConfig

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
}
# the reference's other archs and the slice that brings each
_LATER = {
    "gemma3-1b": "ROADMAP A7.2: gemma3-1b",
    "granite-moe-1b-a400m": "ROADMAP A7.3: the MoE FFN",
    "dbrx-132b": "ROADMAP A7.3: the MoE FFN",
    "hubert-xlarge": "ROADMAP A7.4: hubert/paligemma inputs",
    "paligemma-3b": "ROADMAP A7.4: hubert/paligemma inputs",
    "xlstm-1.3b": "ROADMAP A7.5: the SSM blocks",
    "zamba2-7b": "ROADMAP A7.5: the SSM blocks",
    "internlm2-20b": "ROADMAP A7.7: the remaining dense archs",
    "granite-3-2b": "ROADMAP A7.7: the remaining dense archs",
}
ARCH_NAMES = tuple(_MODULES)


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    if name in _LATER:
        raise NotImplementedError(f"arch {name!r} is not ported yet "
                                  f"({_LATER[name]})")
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
