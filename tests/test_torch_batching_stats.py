"""The partition-quality helpers of the port's `core.batching`
(`utilization_stats`, paper §3.1, and `label_entropy_per_cluster`,
paper Fig. 2) against the reference's, bit for bit, on seeded graphs:
multilabel PPI and multi-class Reddit stand-ins, METIS-like and random
partitions."""
import numpy as np
import pytest

from repro.core.batching import label_entropy_per_cluster as ref_entropy
from repro.core.batching import utilization_stats as ref_utilization
from repro.graph.generators import make_dataset as ref_make_dataset
from repro_torch.core import label_entropy_per_cluster, utilization_stats
from repro_torch.graph.generators import make_dataset
from repro_torch.graph.partition import partition_graph


@pytest.fixture(scope="module", params=["ppi", "reddit"])
def graph(request):
    g = make_dataset(request.param, scale=0.02, seed=3)
    rg = ref_make_dataset(request.param, scale=0.02, seed=3)
    return g, rg


@pytest.mark.parametrize("method", ["metis", "random"])
def test_label_entropy_is_the_reference_s(graph, method):
    g, rg = graph
    parts, _ = partition_graph(g, 10, method=method, seed=1, cache=False)
    got = label_entropy_per_cluster(g, parts)
    want = ref_entropy(rg, parts)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got >= 0).all() and got.max() > 0


@pytest.mark.parametrize("q", [1, 3])
def test_utilization_stats_are_the_reference_s(graph, q):
    g, rg = graph
    parts, _ = partition_graph(g, 10, method="metis", seed=1, cache=False)
    got = utilization_stats(g, parts, q, trials=7, seed=5)
    assert got == ref_utilization(rg, parts, q, trials=7, seed=5)
    assert 0.0 < got["mean_within"] <= 1.0
