"""Model, batching, training engine, experiment specs and the host
oracle."""
from repro_torch.core.baselines import (expansion_stats, lhop_closure,
                                        train_expansion_sgd,
                                        train_full_batch, train_sage,
                                        train_vrgcn)
from repro_torch.core.batching import (ClusterBatch, ClusterBatcher, Sampler,
                                       batch_to_device,
                                       label_entropy_per_cluster,
                                       normalized_subgraph_csr,
                                       subgraph_payload, utilization_stats)
from repro_torch.core.engine import (CheckpointHook, DataParallelBackend,
                                     Engine, EvalHook, LoggingHook,
                                     PreemptionHook, SingleDeviceBackend,
                                     StepBackend, StopAtStepHook,
                                     TrainResult, make_train_step,
                                     resolve_eval_mask)
from repro_torch.core.experiment import (Experiment, ExperimentSpec,
                                         apply_overrides, build_batcher,
                                         build_experiment, build_gcn_config,
                                         default_saint_budget,
                                         build_graph, build_hooks,
                                         build_optimizer, build_partition,
                                         build_process_group,
                                         list_presets, parse_set_items,
                                         preset, register_preset,
                                         run_experiment, validate)
from repro_torch.core.gcn import (GCN, GCNConfig, GCNLayer, gcn_forward,
                                  gcn_loss, init_gcn, init_params, micro_f1,
                                  params_from_numpy, params_to_numpy,
                                  params_tree)
from repro_torch.core.kslots import (KSlotsPlan, fill_stats,
                                     plan_k_buckets, pow2_ceil)
from repro_torch.core.prefetch import prefetch_iter
from repro_torch.core.samplers import SaintEdgeSampler, SaintNodeSampler
from repro_torch.core.trainer import (evaluate, full_graph_logits,
                                      train_cluster_gcn)

__all__ = [
    "ClusterBatch", "ClusterBatcher", "Sampler", "batch_to_device",
    "normalized_subgraph_csr", "subgraph_payload", "utilization_stats",
    "label_entropy_per_cluster", "CheckpointHook",
    "Engine", "EvalHook", "LoggingHook", "PreemptionHook",
    "SingleDeviceBackend", "DataParallelBackend", "StepBackend",
    "StopAtStepHook", "TrainResult",
    "make_train_step", "resolve_eval_mask", "Experiment", "ExperimentSpec",
    "apply_overrides", "build_batcher", "build_experiment",
    "build_gcn_config", "build_graph", "build_hooks", "build_optimizer",
    "build_partition", "build_process_group", "list_presets", "parse_set_items", "preset",
    "register_preset", "run_experiment", "validate", "GCN", "GCNConfig",
    "GCNLayer", "gcn_forward", "gcn_loss", "init_gcn", "init_params",
    "micro_f1", "params_from_numpy", "params_to_numpy", "params_tree",
    "pow2_ceil", "prefetch_iter", "evaluate", "full_graph_logits",
    "train_cluster_gcn", "default_saint_budget", "KSlotsPlan",
    "fill_stats", "plan_k_buckets", "SaintEdgeSampler", "SaintNodeSampler",
    "expansion_stats", "lhop_closure", "train_expansion_sgd",
    "train_full_batch", "train_sage", "train_vrgcn",
]
