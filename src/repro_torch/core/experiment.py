"""Declarative experiment spec: the port's `repro.core.experiment`.

The spec dataclasses are copied field for field — same names, defaults
and `doc` metadata — so any spec JSON the reference writes round-trips
through `ExperimentSpec.from_json` here unchanged, and one spec file
drives both packages. This slice materializes what serving needs from a
spec: the graph (`build_graph`), its partition (`build_partition`) and
the model config (`build_gcn_config`). The training builders (batcher,
optimizer, engine) come with the training slice.

Preset registry: `preset("ppi"|"ppi_sota"|"ppi_tiny"|...)` returns a
fresh spec from `repro_torch.configs.{ppi,reddit,amazon2m}`.
"""
from __future__ import annotations

import copy
import dataclasses
import importlib
import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from repro_torch.core.gcn import GCNConfig
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.generators import make_dataset
from repro_torch.graph.partition import partition_graph

_NORMS = ("eq1", "eq9", "eq10", "eq11")
_PARTITION_METHODS = ("metis", "cluster", "random")
_COMPRESSIONS = (None, "bf16", 4, 8)
_OPTIMIZERS = ("adamw", "sgd")
_SAMPLERS = ("cluster", "saint_node", "saint_edge")
_PRECISIONS = ("fp32", "bf16")
_LOSS_SCALINGS = ("none", "static", "dynamic")
_EVAL_SPLITS = ("auto", "train", "val", "test")


def _f(default: Any, doc: str) -> Any:
    """A spec field with its reference documentation attached. The
    field-by-field reference (docs/experiment-spec.md) is GENERATED
    from this metadata by docs/gen_spec_reference.py, so the docs
    cannot drift from the dataclasses — new fields must carry a doc
    (enforced by tests/test_docs.py)."""
    return dataclasses.field(default=default, metadata={"doc": doc})


# ----------------------------------------------------------------------
# spec sections
# ----------------------------------------------------------------------
@dataclasses.dataclass
class DataSpec:
    """Which graph to materialize (repro.graph.generators.make_dataset)."""
    name: str = _f("ppi", "dataset name in the generator registry: "
                   "synthetic ppi, reddit, amazon2m, cora, structural "
                   "(seeded generators), or the real benchmarks "
                   "ppi_real, reddit_real, ogbn_arxiv, ogbn_products "
                   "(downloaded + disk-cached, repro.graph.datasets)")
    scale: float = _f(1.0, "node-count multiplier on the paper-sized "
                      "graph (*_tiny presets use small scales for CPU); "
                      "must stay 1.0 for real datasets — real graphs "
                      "cannot be resampled")
    seed: int = _f(0, "generator seed — one spec = one exact graph "
                   "(ignored by real datasets: their splits are fixed "
                   "upstream)")
    cache_dir: Optional[str] = _f(None, "real datasets only: dataset "
                                  "cache root; None uses "
                                  "$REPRO_DATASETS_CACHE or "
                                  "~/.cache/repro-datasets")
    mmap: bool = _f(True, "real datasets only: memory-map the processed "
                    "feature matrix instead of loading it into RAM "
                    "(Amazon2M-class features don't fit otherwise)")


@dataclasses.dataclass
class PartitionSpec:
    """Graph clustering (repro.graph.partition_graph). Only used by the
    cluster sampler; SAINT samplers skip partitioning entirely."""
    num_parts: int = _f(50, "number of clusters p (paper Table 4)")
    method: str = _f("metis", "partitioner: metis, cluster or random")
    seed: int = _f(0, "partitioner seed")
    cache: bool = _f(True, "memoize partition assignments to disk keyed "
                     "on (graph fingerprint, num_parts, method, seed, "
                     "partitioner version) — a METIS pass over a "
                     "2M-node graph is minutes; `--set "
                     "partition.cache=false` recomputes every run")
    cache_dir: Optional[str] = _f(None, "partition cache directory; "
                                  "None uses <dataset cache "
                                  "root>/partitions")


@dataclasses.dataclass
class BatchSpec:
    """Per-step subgraph construction — the sampler and its payload
    format (repro.core.batching / repro.core.samplers)."""
    sampler: str = _f("cluster", "subgraph sampler: 'cluster' (paper "
                      "Algorithm 1 over the partition), 'saint_node' or "
                      "'saint_edge' (GraphSAINT-style i.i.d. subgraphs "
                      "with unbiased loss normalization)")
    clusters_per_batch: int = _f(1, "q clusters per batch (cluster "
                                 "sampler only, paper §3.2)")
    budget: Optional[int] = _f(None, "SAINT draws per batch — nodes "
                               "(saint_node) or edges (saint_edge); "
                               "None derives a cluster-batch-sized "
                               "default from N, num_parts and q")
    batches_per_epoch: Optional[int] = _f(None, "SAINT steps per epoch; "
                                          "None derives one "
                                          "pass-over-the-data "
                                          "equivalent (N/budget resp. "
                                          "E/budget)")
    degree_weighted: bool = _f(False, "saint_node only: draw nodes "
                               "with p ∝ degree+1 instead of uniformly")
    norm: str = _f("eq10", "per-batch adjacency normalization: eq1, "
                   "eq9, eq10 or eq11 (paper equation numbers)")
    diag_lambda: float = _f(0.0, "λ of the Eq. 11 diagonal enhancement "
                            "(used by the deep §4.3 recipe)")
    node_cap: Optional[int] = _f(None, "fixed padded batch size; None "
                                 "sizes it from partition statistics "
                                 "(cluster) or the sampling budget "
                                 "(SAINT)")
    pad_multiple: int = _f(128, "node_cap is rounded up to this "
                           "multiple (MXU tile alignment)")
    seed: int = _f(0, "batch-stream seed; the epoch stream is a pure "
                   "function of (seed, epoch) — the basis of "
                   "resume-exact training")
    drop_overflow: bool = _f(True, "cluster sampler only: truncate "
                             "batches exceeding node_cap (warns once, "
                             "counted in padding_stats) instead of "
                             "raising")
    sparse_adj: bool = _f(False, "emit block-ELL adjacency "
                          "(kernels.BlockEllAdj) instead of the dense "
                          "(cap, cap) block — the differentiable "
                          "Pallas spmm path")
    block_size: int = _f(128, "tile edge B of the block-ELL format "
                         "(node_cap must be divisible by it)")
    k_slots: Union[int, str] = _f("cap", "block-ELL slot policy: 'cap' "
                                  "(lossless worst case), 'auto' "
                                  "(fill-adaptive pow2 buckets, "
                                  "repro.core.kslots) or a fixed int "
                                  "(lossless or raise)")
    reuse_tile_buffers: bool = _f(False, "sparse path: recycle the "
                                  "host-side block tile buffers across "
                                  "batches (kernels.ops.TileBufferPool) "
                                  "instead of zero-filling fresh arrays "
                                  "— identical payload values")


@dataclasses.dataclass
class ModelSpec:
    """GCN architecture (repro.core.gcn.GCNConfig). None-valued fields
    are inferred from the materialized graph's features/labels."""
    hidden_dim: int = _f(512, "hidden width of every inner layer")
    num_layers: int = _f(3, "number of GCN layers")
    dropout: float = _f(0.2, "feature dropout rate (paper §4: 20%)")
    residual: bool = _f(False, "add the paper Eq. 8 residual "
                        "connection where shapes allow")
    layernorm: bool = _f(True, "layer-norm between inner layers (the "
                         "deep-GCN experiments use it)")
    precompute_ax: bool = _f(False, "paper §6.2: the payload builder "
                             "aggregates A'X once per batch on the "
                             "host and the first layer skips its "
                             "propagation (the sampler is built to "
                             "match automatically)")
    precision: str = _f("fp32", "compute dtype of activations/matmul "
                        "operands: 'fp32' (default, bitwise-identical "
                        "to the pre-policy model) or 'bf16' (params "
                        "and matmul accumulators stay fp32)")
    loss_scaling: str = _f("none", "mixed-precision loss scaling: "
                           "'none', 'static' (constant loss_scale) or "
                           "'dynamic' (grow/backoff with non-finite "
                           "step skipping)")
    loss_scale: float = _f(32768.0, "initial (static: constant) loss "
                           "scale when loss_scaling is enabled")
    remat: bool = _f(False, "wrap layer chunks in jax.checkpoint so "
                     "the backward recomputes activations — the "
                     "memory knob for deep GCNs")
    remat_chunk: int = _f(2, "layers per remat chunk (remat=true only)")
    fuse_spmm: bool = _f(False, "route each layer's A'(XW+b) through "
                         "the fused one-pass kernel seam (ops.spmm_xw: "
                         "W resident in VMEM, row_k-specialized K loop) "
                         "instead of matmul-then-spmm; same math on "
                         "every backend, no XW HBM round-trip")
    multilabel: Optional[bool] = _f(None, "sigmoid BCE (True) vs "
                                    "softmax CE (False); None infers "
                                    "from the label array's rank")
    in_dim: Optional[int] = _f(None, "input feature dim; None infers "
                               "from graph.features")
    out_dim: Optional[int] = _f(None, "output dim; None infers from "
                                "the labels")


@dataclasses.dataclass
class OptimSpec:
    """Optimizer (repro.nn.optim)."""
    name: str = _f("adamw", "optimizer: adamw or sgd")
    lr: float = _f(1e-2, "learning rate")
    weight_decay: float = _f(0.0, "adamw decoupled weight decay")
    b1: float = _f(0.9, "adamw β1")
    b2: float = _f(0.999, "adamw β2")
    eps: float = _f(1e-8, "adamw ε")
    clip_norm: Optional[float] = _f(None, "global gradient-norm clip; "
                                    "None disables")
    momentum: float = _f(0.0, "sgd momentum (sgd only)")


@dataclasses.dataclass
class ExecutionSpec:
    """Where/how steps execute (repro.dist, repro.core.prefetch)."""
    data_shards: Optional[int] = _f(None, "None → single device; N → "
                                    "shard_map data-parallel mesh over "
                                    "the first N local devices (one "
                                    "batch per shard per step)")
    dp_axis: str = _f("data", "mesh axis name of the DP dimension")
    compression: Optional[Union[str, int]] = _f(None, "gradient "
                                                "all-reduce wire "
                                                "format: None (fp32), "
                                                "'bf16', 4 or 8 "
                                                "(int4/int8 with error "
                                                "feedback)")
    compression_group_size: Optional[int] = _f(1024, "elements per "
                                               "quantization scale "
                                               "bucket of the int4/int8 "
                                               "all-reduce; None uses "
                                               "the compression "
                                               "module's default")
    microbatches: int = _f(1, "per-shard gradient-accumulation chunks "
                           "(DP mesh only): each shard scans this many "
                           "batches per optimizer step, so only one "
                           "chunk's backward graph is live at a time")
    prefetch: Union[int, str] = _f(
        0, "batches built ahead on a background thread (incl. DP "
        "stacking + device_put); 0 is fully synchronous, 'auto' "
        "measures the host-build/device-step time ratio during a "
        "synchronous warmup epoch and picks the depth itself (logged "
        "per epoch as prefetch_depth/host_build_over_step in history "
        "rows) — trajectories are identical for every setting")
    prefetch_timeout_s: float = _f(600.0, "seconds a training step may "
                                   "wait on the prefetch producer before "
                                   "the run aborts with a diagnosable "
                                   "PrefetchError naming the dead/hung "
                                   "producer (docs/robustness.md) "
                                   "instead of blocking forever")


@dataclasses.dataclass
class RunSpec:
    """Loop length, eval cadence, checkpointing (repro.core.engine)."""
    epochs: int = _f(10, "training epochs")
    seed: int = _f(0, "init/step RNG seed (separate from batch.seed)")
    eval_every: int = _f(0, "full-graph eval every k epochs; 0 disables")
    eval_split: str = _f("auto", "eval split: train/val/test, or "
                         "'auto' (val, falling back to test with a "
                         "warning)")
    checkpoint_dir: Optional[str] = _f(None, "checkpoint directory; "
                                       "None disables checkpointing "
                                       "(and resume)")
    checkpoint_every: int = _f(1, "epochs between async cadence "
                               "checkpoints")
    checkpoint_keep: int = _f(3, "newest checkpoints retained")
    verbose: bool = _f(False, "per-epoch metric printing (LoggingHook)")
    faults: Optional[Dict[str, Any]] = _f(
        None, "fault-injection plan (runtime.faults.FaultPlan.to_dict "
        "format: {'seed': int, 'rules': {site: {at/times/prob/value}}}); "
        "None — every production run — keeps injection provably "
        "zero-cost. Chaos testing only; see docs/robustness.md for the "
        "site table")
    max_consecutive_skipped: Optional[int] = _f(
        None, "divergence guard: abort cleanly (last-good checkpoint "
        "kept, structured stop_reason in metrics) after this many "
        "consecutive non-finite losses; None disables the guard")
    divergence_factor: Optional[float] = _f(
        None, "divergence guard: abort and roll back to the last-good "
        "checkpoint when a finite loss exceeds this factor × the "
        "trailing median loss (window 32, warmup 8); None disables "
        "(must be > 1 when set)")


@dataclasses.dataclass
class ServeSpec:
    """Serving-layer configuration (repro.serve / launch.serve_gcn):
    per-cluster embedding cache + jit'd query path. Training ignores
    this section entirely — it exists so one spec JSON describes both
    halves of a model's life and serving inherits the training run's
    dataset/partition/normalization without re-stating them."""
    cache_dir: Optional[str] = _f(None, "root of the per-cluster "
                                  "embedding cache; None uses "
                                  "<dataset cache root>/serving/<spec "
                                  "name> (the $REPRO_DATASETS_CACHE "
                                  "tree)")
    max_batch: int = _f(256, "largest query batch answered in one "
                        "jit'd step; bigger requests are chunked")
    buckets: Optional[List[int]] = _f(None, "explicit request-padding "
                                      "bucket ladder (ascending); None "
                                      "derives (1, 8, 64, ..., "
                                      "pow2(max_batch)) — each bucket "
                                      "is one compiled shape, so a "
                                      "short ladder bounds "
                                      "recompilation at ≤2x padding "
                                      "waste")
    top_k: int = _f(5, "classes returned per query (clamped to the "
                    "model's out_dim)")
    imbalance_threshold: float = _f(2.0, "max/mean cluster-size ratio "
                                    "past which live growth triggers "
                                    "the re-partition warning (must "
                                    "be > 1; warn-only)")


_SECTIONS = {"data": DataSpec, "partition": PartitionSpec,
             "batch": BatchSpec, "model": ModelSpec, "optim": OptimSpec,
             "execution": ExecutionSpec, "run": RunSpec,
             "serve": ServeSpec}


@dataclasses.dataclass
class ExperimentSpec:
    name: str = "experiment"
    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    partition: PartitionSpec = dataclasses.field(
        default_factory=PartitionSpec)
    batch: BatchSpec = dataclasses.field(default_factory=BatchSpec)
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    optim: OptimSpec = dataclasses.field(default_factory=OptimSpec)
    execution: ExecutionSpec = dataclasses.field(
        default_factory=ExecutionSpec)
    run: RunSpec = dataclasses.field(default_factory=RunSpec)
    serve: ServeSpec = dataclasses.field(default_factory=ServeSpec)

    # -- JSON round trip ------------------------------------------------
    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_dict(d: Dict) -> "ExperimentSpec":
        d = dict(d)
        kw: Dict[str, Any] = {"name": d.pop("name", "experiment")}
        for key, cls in _SECTIONS.items():
            sec = d.pop(key, None)
            if sec is not None:
                known = {f.name for f in dataclasses.fields(cls)}
                unknown = set(sec) - known
                if unknown:
                    raise ValueError(
                        f"unknown field(s) {sorted(unknown)} in spec "
                        f"section {key!r} (known: {sorted(known)})")
                kw[key] = cls(**sec)
        if d:
            raise ValueError(f"unknown spec section(s) {sorted(d)} "
                             f"(known: {sorted(_SECTIONS)} + name)")
        return ExperimentSpec(**kw)

    @staticmethod
    def from_json(s: str) -> "ExperimentSpec":
        return ExperimentSpec.from_dict(json.loads(s))

    def copy(self) -> "ExperimentSpec":
        return copy.deepcopy(self)


# ----------------------------------------------------------------------
# overrides (--set section.field=value)
# ----------------------------------------------------------------------
def _parse_value(text: str) -> Any:
    """JSON literal (2, 0.5, true, null, "auto") with plain-string
    fallback, so `--set batch.k_slots=auto` and `--set run.epochs=2`
    both do the obvious thing."""
    try:
        return json.loads(text)
    except (json.JSONDecodeError, ValueError):
        return text


def set_override(spec: ExperimentSpec, path: str, value: Any) -> None:
    """Set one dotted-path field (e.g. "execution.prefetch") in place.
    String values are parsed as JSON literals with string fallback."""
    parts = path.split(".")
    obj: Any = spec
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise KeyError(f"spec has no section {p!r} (in {path!r})")
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not dataclasses.is_dataclass(obj) or not hasattr(obj, leaf):
        raise KeyError(f"spec has no field {path!r}")
    if isinstance(value, str):
        value = _parse_value(value)
    setattr(obj, leaf, value)


def apply_overrides(spec: ExperimentSpec,
                    overrides: Dict[str, Any]) -> ExperimentSpec:
    for path, value in overrides.items():
        set_override(spec, path, value)
    return spec


def parse_set_items(items: Sequence[str]) -> Dict[str, str]:
    """CLI `--set section.field=value` strings → overrides dict (shared
    by every driver so the error message never drifts)."""
    overrides: Dict[str, str] = {}
    for item in items or []:
        if "=" not in item:
            raise ValueError(f"--set expects section.field=value; "
                             f"got {item!r}")
        path, value = item.split("=", 1)
        overrides[path.strip()] = value
    return overrides


def validate(spec: ExperimentSpec) -> ExperimentSpec:
    """Cheap structural validation before any expensive materialization
    — every ValueError here names the offending field."""
    def check(cond, field, msg):
        if not cond:
            raise ValueError(f"spec.{field}: {msg}")

    check(spec.batch.sampler in _SAMPLERS, "batch.sampler",
          f"must be one of {_SAMPLERS}; got {spec.batch.sampler!r}")
    from repro_torch.graph.datasets import REAL_DATASETS
    check(spec.data.name.lower() not in REAL_DATASETS
          or spec.data.scale == 1.0, "data.scale",
          f"must be 1.0 for the real dataset {spec.data.name!r} — real "
          f"graphs cannot be resampled (*_real_tiny presets shrink the "
          f"recipe, not the data)")
    bud = spec.batch.budget
    check(bud is None or bud >= 1, "batch.budget", "must be None or >= 1")
    bpe = spec.batch.batches_per_epoch
    check(bpe is None or bpe >= 1, "batch.batches_per_epoch",
          "must be None or >= 1")
    check(spec.batch.norm in _NORMS, "batch.norm",
          f"must be one of {_NORMS}; got {spec.batch.norm!r}")
    check(spec.partition.method in _PARTITION_METHODS, "partition.method",
          f"must be one of {_PARTITION_METHODS}; "
          f"got {spec.partition.method!r}")
    check(spec.partition.num_parts >= 1, "partition.num_parts", ">= 1")
    ks = spec.batch.k_slots
    check(isinstance(ks, int) or ks in ("cap", "auto"), "batch.k_slots",
          f"must be 'cap', 'auto' or an int; got {ks!r}")
    check(spec.run.eval_split in _EVAL_SPLITS, "run.eval_split",
          f"must be one of {_EVAL_SPLITS}; got {spec.run.eval_split!r}")
    check(spec.execution.compression in _COMPRESSIONS,
          "execution.compression",
          f"must be one of {_COMPRESSIONS}; "
          f"got {spec.execution.compression!r}")
    check(spec.optim.name in _OPTIMIZERS, "optim.name",
          f"must be one of {_OPTIMIZERS}; got {spec.optim.name!r}")
    check(spec.run.epochs >= 1, "run.epochs", ">= 1")
    pf = spec.execution.prefetch
    check(pf == "auto" or (isinstance(pf, int) and pf >= 0),
          "execution.prefetch", f"must be 'auto' or an int >= 0; "
          f"got {pf!r}")
    check(spec.serve.max_batch >= 1, "serve.max_batch", ">= 1")
    check(spec.serve.top_k >= 1, "serve.top_k", ">= 1")
    check(spec.serve.imbalance_threshold > 1.0,
          "serve.imbalance_threshold", "> 1")
    bks = spec.serve.buckets
    check(bks is None or (len(bks) > 0
                          and all(isinstance(b, int) and b >= 1
                                  for b in bks)
                          and list(bks) == sorted(set(bks))),
          "serve.buckets",
          f"must be None or a strictly ascending list of ints >= 1; "
          f"got {bks!r}")
    ds = spec.execution.data_shards
    check(ds is None or ds >= 1, "execution.data_shards",
          "must be None or >= 1")
    check(spec.model.precision in _PRECISIONS, "model.precision",
          f"must be one of {_PRECISIONS}; got {spec.model.precision!r}")
    check(spec.model.loss_scaling in _LOSS_SCALINGS, "model.loss_scaling",
          f"must be one of {_LOSS_SCALINGS}; "
          f"got {spec.model.loss_scaling!r}")
    check(spec.model.loss_scale > 0, "model.loss_scale", "> 0")
    check(spec.model.remat_chunk >= 1, "model.remat_chunk", ">= 1")
    check(spec.execution.microbatches >= 1, "execution.microbatches",
          ">= 1")
    gs = spec.execution.compression_group_size
    check(gs is None or gs >= 1, "execution.compression_group_size",
          "must be None or >= 1")
    check(spec.execution.prefetch_timeout_s > 0,
          "execution.prefetch_timeout_s", "> 0")
    mcs = spec.run.max_consecutive_skipped
    check(mcs is None or mcs >= 1, "run.max_consecutive_skipped",
          "must be None or >= 1")
    df = spec.run.divergence_factor
    check(df is None or df > 1.0, "run.divergence_factor",
          "must be None or > 1")
    # the full FaultPlan check comes with the port of runtime/faults.py;
    # serving never injects faults, so only the plan's shape is checked
    check(spec.run.faults is None or isinstance(spec.run.faults, dict),
          "run.faults", "must be None or a fault-plan dict")
    return spec


# ----------------------------------------------------------------------
# builders: spec → materialized pieces
# ----------------------------------------------------------------------
def build_graph(spec: ExperimentSpec) -> CSRGraph:
    return make_dataset(spec.data.name, scale=spec.data.scale,
                        seed=spec.data.seed,
                        cache_dir=spec.data.cache_dir,
                        mmap=spec.data.mmap)


def build_partition(spec: ExperimentSpec, graph: CSRGraph):
    # explicit cache_dir wins; cache=True → default dir; cache=False off
    cache = (spec.partition.cache_dir if spec.partition.cache_dir
             else spec.partition.cache)
    return partition_graph(graph, spec.partition.num_parts,
                           method=spec.partition.method,
                           seed=spec.partition.seed, cache=cache)


def build_gcn_config(spec: ExperimentSpec, graph: CSRGraph) -> GCNConfig:
    """ModelSpec → GCNConfig, inferring in_dim/out_dim/multilabel from
    the graph when unset — multilabel follows the label array's rank
    ((N, C) float → multilabel BCE; (N,) int → multiclass CE), so a
    preset can't silently run the wrong loss on a dataset."""
    m = spec.model
    multilabel = (bool(graph.labels.ndim == 2) if m.multilabel is None
                  else m.multilabel)
    if m.out_dim is not None:
        out_dim = m.out_dim
    elif multilabel:
        out_dim = int(graph.labels.shape[1])
    else:
        out_dim = int(graph.labels.max()) + 1
    return GCNConfig(
        in_dim=m.in_dim if m.in_dim is not None
        else int(graph.features.shape[1]),
        hidden_dim=m.hidden_dim, out_dim=out_dim,
        num_layers=m.num_layers, dropout=m.dropout, residual=m.residual,
        multilabel=multilabel, layernorm=m.layernorm,
        precompute_ax=m.precompute_ax, precision=m.precision,
        loss_scaling=m.loss_scaling, loss_scale=m.loss_scale,
        remat=m.remat, remat_chunk=m.remat_chunk,
        fuse_spmm=m.fuse_spmm)


# ----------------------------------------------------------------------
# preset registry — configs/{ppi,reddit,amazon2m}.py as runnable specs
# ----------------------------------------------------------------------
_PRESETS: Dict[str, Union[str, Callable[[], ExperimentSpec]]] = {
    # "module:function", resolved lazily (keeps configs ↔ core acyclic)
    "ppi": "repro_torch.configs.ppi:spec",
    "ppi_sota": "repro_torch.configs.ppi:sota_spec",
    "ppi_tiny": "repro_torch.configs.ppi:tiny_spec",
    "ppi_tiny_saint": "repro_torch.configs.ppi:tiny_saint_spec",
    "ppi_deep_tiny": "repro_torch.configs.ppi:deep_tiny_spec",
    "ppi_real": "repro_torch.configs.ppi:real_spec",
    "ppi_real_tiny": "repro_torch.configs.ppi:real_tiny_spec",
    "reddit": "repro_torch.configs.reddit:spec",
    "reddit_tiny": "repro_torch.configs.reddit:tiny_spec",
    "reddit_tiny_saint": "repro_torch.configs.reddit:tiny_saint_spec",
    "reddit_real": "repro_torch.configs.reddit:real_spec",
    "amazon2m": "repro_torch.configs.amazon2m:spec",
    "amazon2m_tiny": "repro_torch.configs.amazon2m:tiny_spec",
    "amazon2m_real": "repro_torch.configs.amazon2m:real_spec",
}


def register_preset(name: str,
                    factory: Callable[[], ExperimentSpec]) -> None:
    _PRESETS[name] = factory


def list_presets() -> List[str]:
    return sorted(_PRESETS)


def preset(name: str) -> ExperimentSpec:
    """A fresh (mutation-safe) ExperimentSpec for a registered preset."""
    entry = _PRESETS.get(name)
    if entry is None:
        raise KeyError(f"unknown preset {name!r}; "
                       f"known: {list_presets()}")
    if isinstance(entry, str):
        mod, fn = entry.split(":")
        factory = getattr(importlib.import_module(mod), fn)
    else:
        factory = entry
    spec = factory()
    spec.name = name
    return validate(spec)
