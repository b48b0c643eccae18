"""Model config and parameters, experiment specs and the host oracle."""
from repro_torch.core.experiment import (ExperimentSpec, apply_overrides,
                                         build_gcn_config, build_graph,
                                         build_partition, list_presets,
                                         parse_set_items, preset,
                                         register_preset, validate)
from repro_torch.core.gcn import (GCN, GCNConfig, GCNLayer, init_gcn,
                                  params_from_numpy, params_to_numpy)
from repro_torch.core.kslots import pow2_ceil
from repro_torch.core.trainer import full_graph_logits

__all__ = [
    "ExperimentSpec", "apply_overrides", "build_gcn_config", "build_graph",
    "build_partition", "list_presets", "parse_set_items", "preset",
    "register_preset", "validate", "GCN", "GCNConfig", "GCNLayer",
    "init_gcn", "params_from_numpy", "params_to_numpy", "pow2_ceil",
    "full_graph_logits",
]
