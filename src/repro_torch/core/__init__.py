"""Model, batching, training engine, experiment specs and the host
oracle."""
from repro_torch.core.batching import (ClusterBatch, ClusterBatcher, Sampler,
                                       batch_to_device,
                                       normalized_subgraph_csr,
                                       subgraph_payload)
from repro_torch.core.engine import (CheckpointHook, Engine, EvalHook,
                                     LoggingHook, PreemptionHook,
                                     SingleDeviceBackend, StepBackend,
                                     StopAtStepHook, TrainResult,
                                     make_train_step, resolve_eval_mask)
from repro_torch.core.experiment import (Experiment, ExperimentSpec,
                                         apply_overrides, build_batcher,
                                         build_experiment, build_gcn_config,
                                         build_graph, build_hooks,
                                         build_optimizer, build_partition,
                                         list_presets, parse_set_items,
                                         preset, register_preset,
                                         run_experiment, validate)
from repro_torch.core.gcn import (GCN, GCNConfig, GCNLayer, gcn_forward,
                                  gcn_loss, init_gcn, init_params, micro_f1,
                                  params_from_numpy, params_to_numpy,
                                  params_tree)
from repro_torch.core.kslots import pow2_ceil
from repro_torch.core.prefetch import prefetch_iter
from repro_torch.core.trainer import (evaluate, full_graph_logits,
                                      train_cluster_gcn)

__all__ = [
    "ClusterBatch", "ClusterBatcher", "Sampler", "batch_to_device",
    "normalized_subgraph_csr", "subgraph_payload", "CheckpointHook",
    "Engine", "EvalHook", "LoggingHook", "PreemptionHook",
    "SingleDeviceBackend", "StepBackend", "StopAtStepHook", "TrainResult",
    "make_train_step", "resolve_eval_mask", "Experiment", "ExperimentSpec",
    "apply_overrides", "build_batcher", "build_experiment",
    "build_gcn_config", "build_graph", "build_hooks", "build_optimizer",
    "build_partition", "list_presets", "parse_set_items", "preset",
    "register_preset", "run_experiment", "validate", "GCN", "GCNConfig",
    "GCNLayer", "gcn_forward", "gcn_loss", "init_gcn", "init_params",
    "micro_f1", "params_from_numpy", "params_to_numpy", "params_tree",
    "pow2_ceil", "prefetch_iter", "evaluate", "full_graph_logits",
    "train_cluster_gcn",
]
