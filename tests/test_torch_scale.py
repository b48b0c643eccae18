"""The paper's two scale recipes, `amazon2m` and `reddit`, at mid scales
on the CPU against the reference: the host stages bit-equal, one step at
the recipes' full widths within tolerance.

Scales: `amazon2m` at 0.01 (24,490 nodes; 150 parts, the preset's
15,000 at the same scale) and `reddit` at 0.1 (5,800 nodes; 150 parts,
the preset's 1,500 at the same scale), where the co-purchase graph's
power-law tail is already present. Both packages run the same
generators, partitioner and batcher (the preset's q, eq10, block-ELL
at B 128, k_slots "cap"):

* the graphs, the partition (assignment and within-cluster share) and
  the batcher's node_cap, K and first 3 block-ELL payloads are
  bit-equal;
* one `gcn_loss` + backward at the recipe's widths (amazon2m 100 → 400
  → 400 → 47, reddit 128 → 128 → 128 → 128 → 41; fused, dropout 0)
  from the reference's params (carried over by `params_from_numpy`)
  on the same batch: loss within 1e-5 relative, every gradient leaf
  within 1e-4·max(1, max|g|) (the bound of
  tests/test_torch_train.py). Readings: amazon2m loss 1.0e-7
  relative, worst gradient leaf 1.2e-3 of its bound; reddit 1.1e-7
  relative, 8.9e-4 of its bound;
* with node_cap below the q-cluster union (Amazon2M's cluster sizes
  spread 120-187 here), both packages subsample the same nodes.

The reference's products run as its own CPU tests run them: `auto`
resolves to its plain jax version on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.batching import ClusterBatcher as RefBatcher
from repro.core.gcn import GCNConfig as RefCfg
from repro.core.gcn import gcn_loss as ref_gcn_loss
from repro.core.gcn import init_gcn as ref_init_gcn
from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro.kernels.block_spmm import BlockEllAdj as RefAdj
from repro_torch.core.batching import ClusterBatcher, batch_to_device
from repro_torch.core.experiment import preset
from repro_torch.core import trainer
from repro_torch.core.gcn import GCNConfig, gcn_loss, params_from_numpy
from repro_torch.graph import csr, generators, partition

SCALES = {"amazon2m": 0.01, "reddit": 0.1}
GRAPH_FIELDS = ("indptr", "indices", "data", "features", "labels",
                "train_mask", "val_mask", "test_mask")
ADJ_FIELDS = ("blocks", "block_cols", "blocks_t", "block_cols_t", "row_k",
              "row_k_t")
PAYLOAD_FIELDS = ("features", "labels", "node_mask", "loss_mask",
                  "num_real")
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_bit_equal(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@dataclasses.dataclass
class Recipe:
    name: str
    spec: object
    graph: object
    ref_graph: object
    parts: np.ndarray
    stats: object
    ref_parts: np.ndarray
    ref_stats: object


@pytest.fixture(scope="module", params=sorted(SCALES))
def recipe(request):
    name, scale = request.param, SCALES[request.param]
    spec = preset(name)
    num_parts = round(spec.partition.num_parts * scale)
    g = generators.make_dataset(name, scale, seed=spec.data.seed)
    rg = ref_gen.make_dataset(name, scale, seed=spec.data.seed)
    parts, stats = partition.partition_graph(g, num_parts, method="metis",
                                             seed=0, cache=False)
    ref_parts, ref_stats = ref_part.partition_graph(
        rg, num_parts, method="metis", seed=0, cache=False)
    return Recipe(name, spec, g, rg, parts, stats, ref_parts, ref_stats)


def _batcher_kw(spec, **over):
    b = spec.batch
    kw = dict(clusters_per_batch=b.clusters_per_batch, norm=b.norm,
              sparse_adj=True, block_size=b.block_size,
              pad_multiple=b.pad_multiple, seed=b.seed)
    kw.update(over)
    return kw


def _first_batches(batcher, n):
    it = batcher.epoch(0)
    return [next(it) for _ in range(n)]


def test_generator_bit_equal(recipe):
    n = {"amazon2m": 24_490, "reddit": 5_800}[recipe.name]
    assert recipe.graph.num_nodes == n
    for f in GRAPH_FIELDS:
        _assert_bit_equal(getattr(recipe.graph, f),
                          getattr(recipe.ref_graph, f))


def test_partition_bit_equal(recipe):
    _assert_bit_equal(recipe.parts, recipe.ref_parts)
    assert recipe.stats.within_fraction == recipe.ref_stats.within_fraction
    for f in ("num_parts", "edge_cut", "max_part", "min_part", "imbalance"):
        assert getattr(recipe.stats, f) == getattr(recipe.ref_stats, f)


def test_group_members_equals_the_where_loop(recipe):
    """The port lists cluster members with one stable sort; the lists
    equal the reference's `np.where` loop, empty groups included."""
    k = recipe.stats.num_parts + 2            # two empty trailing groups
    got = csr.group_members(recipe.parts, k)
    assert len(got) == k
    for g, members in enumerate(got):
        _assert_bit_equal(members, np.where(recipe.parts == g)[0])


def test_batcher_payloads_bit_equal(recipe):
    kw = _batcher_kw(recipe.spec)
    pb = ClusterBatcher(recipe.graph, recipe.parts, **kw)
    rb = RefBatcher(recipe.ref_graph, recipe.ref_parts, **kw)
    assert pb.node_cap == rb.node_cap
    assert pb.steps_per_epoch() == rb.steps_per_epoch()
    for p, r in zip(_first_batches(pb, 3), _first_batches(rb, 3)):
        p_adj = p.adj.to("cpu")          # the tiles the payload expands to
        assert p_adj.blocks.shape[1] == np.asarray(r.adj.blocks).shape[1] \
            == pb.node_cap // kw["block_size"]
        for f in ADJ_FIELDS:
            _assert_bit_equal(getattr(p_adj, f), getattr(r.adj, f))
        for f in PAYLOAD_FIELDS:
            _assert_bit_equal(getattr(p, f), getattr(r, f))


def test_overflow_subsample_matches_reference(recipe):
    """node_cap one pad multiple below the mean q-cluster union: most
    batches overflow, and both packages keep the same nodes (the
    uniform, per-(seed, epoch, step) subsample)."""
    sizes = np.bincount(recipe.parts)
    q = recipe.spec.batch.clusters_per_batch
    cap = (int(q * sizes.mean()) // 128 - 1) * 128
    kw = _batcher_kw(recipe.spec, node_cap=cap)
    pb = ClusterBatcher(recipe.graph, recipe.parts, **kw)
    rb = RefBatcher(recipe.ref_graph, recipe.ref_parts, **kw)
    with pytest.warns(UserWarning, match="overflow"):
        got = _first_batches(pb, 3)
    with pytest.warns(UserWarning, match="overflow"):
        want = _first_batches(rb, 3)
    assert pb.overflow_count == rb.overflow_count > 0
    for p, r in zip(got, want):
        assert int(p.num_real) == cap
        p_adj = p.adj.to("cpu")
        for f in ADJ_FIELDS:
            _assert_bit_equal(getattr(p_adj, f), getattr(r.adj, f))
        for f in PAYLOAD_FIELDS:
            _assert_bit_equal(getattr(p, f), getattr(r, f))
    if recipe.name == "amazon2m":
        assert 100 <= sizes.min() and sizes.max() <= 200


def _ref_tuple(batch):
    t = list(batch.astuple())
    t[0] = RefAdj(*(None if x is None else jnp.asarray(x) for x in (
        t[0].blocks, t[0].block_cols, t[0].blocks_t, t[0].block_cols_t,
        t[0].row_k, t[0].row_k_t)))
    return tuple(t)


def test_full_width_step_matches_reference(recipe):
    spec, g = recipe.spec, recipe.graph
    m = spec.model
    cfg_kw = dict(in_dim=int(g.features.shape[1]), hidden_dim=m.hidden_dim,
                  out_dim=int(g.labels.max()) + 1, num_layers=m.num_layers,
                  dropout=0.0, multilabel=False, fuse_spmm=True)
    assert (cfg_kw["in_dim"], cfg_kw["out_dim"]) == {
        "amazon2m": (100, 47), "reddit": (128, 41)}[recipe.name]
    rcfg, pcfg = RefCfg(**cfg_kw), GCNConfig(**cfg_kw)
    kw = _batcher_kw(spec)
    pbatch = _first_batches(ClusterBatcher(g, recipe.parts, **kw), 1)[0]
    rbatch = _first_batches(RefBatcher(recipe.ref_graph, recipe.ref_parts,
                                       **kw), 1)[0]
    params = jax.tree_util.tree_map(
        np.asarray, ref_init_gcn(jax.random.PRNGKey(0), rcfg))
    (want_loss, _), want_g = jax.value_and_grad(ref_gcn_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), _ref_tuple(rbatch),
        rcfg, train=True, rng=jax.random.PRNGKey(1))
    model = params_from_numpy(params, "cpu")
    loss, _ = gcn_loss(model, batch_to_device(pbatch.astuple(), "cpu"),
                       pcfg, train=True)
    loss.backward()
    rel = abs(float(loss.detach()) - float(want_loss)) / abs(
        float(want_loss))
    assert rel <= LOSS_TOL, rel
    worst = 0.0
    for layer, want in zip(model.layers, want_g["layers"]):
        for k in ("w", "b"):
            got = getattr(layer, k).grad.numpy()
            w = np.asarray(want[k])
            assert got.shape == w.shape
            bound = GRAD_TOL * max(1.0, float(np.abs(w).max()))
            worst = max(worst, float(np.abs(got - w).max()) / bound)
    assert worst <= 1.0, worst


@pytest.mark.parametrize("width", [1, 47, 400])
def test_host_spmm_is_bitwise_one_call(recipe, monkeypatch, width):
    """The host oracle's row-chunked threaded product equals scipy's one
    call bit for bit (chunks of 1,000 rows: up to one per core)."""
    import scipy.sparse as sp
    from repro_torch.graph.normalization import normalize_csr
    g = recipe.graph
    ip, ix, dt = normalize_csr(g.indptr, g.indices, g.data, "eq10")
    a = sp.csr_matrix((dt, ix, ip), shape=(g.num_nodes,) * 2)
    x = np.random.default_rng(width).standard_normal(
        (g.num_nodes, width)).astype(np.float32)
    monkeypatch.setattr(trainer, "SPMM_CHUNK_ROWS", 1000)
    _assert_bit_equal(trainer.host_spmm(a, x), a @ x)


@pytest.mark.parametrize("seed", range(4))
def test_last_max_per_run_equals_the_stable_lexsort(seed):
    """The partitioner's run-wise argmax picks what the reference's
    stable lexsort by (row, gain) puts last in each row: ties, -0.0
    against 0.0, and rows whose every gain is -inf included."""
    rng = np.random.default_rng(seed)
    n = [0, 1, 40, 5000][seed]
    keys = np.sort(rng.integers(0, max(1, n // 4), n))
    vals = rng.choice([-np.inf, -1.0, -0.0, 0.0, 0.5, 2.0], n)
    o2 = np.lexsort((vals, keys))
    last = np.zeros(len(o2), bool)
    if len(o2):
        last[-1] = True
        last[:-1] = keys[o2][:-1] != keys[o2][1:]
    _assert_bit_equal(partition._last_max_per_run(keys, vals),
                      o2[last].astype(np.intp))
