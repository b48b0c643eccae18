"""Host-side graph stages (numpy): CSR container, generators,
normalization, METIS-like partitioning — copies of `repro.graph`."""
from repro_torch.graph.csr import (CSRGraph, append_graph, edge_cut,
                                   within_cut_fraction)
from repro_torch.graph.datasets import (REAL_DATASETS, cache_root,
                                        dataset_meta,
                                        default_serving_cache_dir,
                                        load_dataset)
from repro_torch.graph.generators import (CoPurchaseSpec, SBMSpec,
                                          copurchase_graph, make_dataset,
                                          stochastic_block_model)
from repro_torch.graph.normalization import normalize_csr, normalize_dense
from repro_torch.graph.partition import (PARTITIONER_VERSION,
                                         PartitionStats,
                                         default_partition_cache_dir,
                                         graph_fingerprint,
                                         metis_like_partition,
                                         partition_fingerprint,
                                         partition_graph, random_partition)

__all__ = [
    "CSRGraph", "append_graph", "edge_cut", "within_cut_fraction",
    "REAL_DATASETS", "cache_root", "dataset_meta",
    "default_serving_cache_dir", "load_dataset",
    "CoPurchaseSpec", "SBMSpec", "copurchase_graph", "make_dataset",
    "stochastic_block_model", "normalize_csr", "normalize_dense",
    "PARTITIONER_VERSION", "PartitionStats", "default_partition_cache_dir",
    "graph_fingerprint", "metis_like_partition", "partition_fingerprint",
    "partition_graph", "random_partition",
]
