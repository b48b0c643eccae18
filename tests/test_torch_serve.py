"""The port's serving slice against the reference, on the CPU.

The reference's `init_gcn` params move across with `params_from_numpy`;
both packages then serve the same graph and partition. Held equal:
`full_graph_embeddings` and `embed_cluster` (against the JAX functions
and the reference's host oracle `full_graph_logits`, at max|Δ| <= 1e-5,
the reference's serving parity contract), `ServeEngine.query`
probs/top-k, `apply_delta` invalidation, checkpoints in both
directions, and the serve_gcn CLI.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import experiment as ref_exp
from repro.core.gcn import init_gcn as ref_init_gcn
from repro.core.trainer import full_graph_logits as ref_full_graph_logits
from repro.graph.partition import partition_fingerprint
from repro.runtime.checkpoint import CheckpointManager as RefCheckpointManager
from repro.serve import EmbeddingCache as RefEmbeddingCache
from repro.serve import GraphDelta as RefGraphDelta
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import apply_delta as ref_apply_delta
from repro.serve import embed_cluster as ref_embed_cluster
from repro.serve import full_graph_embeddings as ref_full_graph_embeddings
from repro_torch.core import experiment as exp
from repro_torch.core.gcn import (GCNConfig, init_gcn, params_from_numpy,
                                  params_to_numpy)
from repro_torch.core.trainer import full_graph_logits
from repro_torch.launch import serve_gcn
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.serve import (EmbeddingCache, GraphDelta, ServeEngine,
                               apply_delta, embed_cluster,
                               full_graph_embeddings)

TOL = 1e-5
VARIANTS = {
    # name: (preset, GCNConfig overrides, batch overrides)
    "ppi_tiny": ("ppi_tiny", {}, {}),
    "deep": ("ppi_tiny", dict(num_layers=4, hidden_dim=50, residual=True,
                              precompute_ax=True),
             dict(norm="eq11", diag_lambda=1.0)),
    "reddit_plain": ("reddit_tiny", dict(layernorm=False), {}),
}


@dataclasses.dataclass
class Setup:
    graph: object
    parts: np.ndarray
    ref_cfg: object
    cfg: GCNConfig
    jax_params: dict          # jnp leaves (ROADMAP C1)
    tree: dict                # the same params as numpy
    norm: str
    diag_lambda: float

    def gcn(self):
        return params_from_numpy(self.tree, "cpu")


@functools.lru_cache(maxsize=None)
def _setup(variant: str) -> Setup:
    name, cfg_over, batch_over = VARIANTS[variant]
    spec = ref_exp.preset(name)
    for k, v in batch_over.items():
        setattr(spec.batch, k, v)
    graph = ref_exp.build_graph(spec)
    parts, _ = ref_exp.build_partition(spec, graph)
    ref_cfg = dataclasses.replace(ref_exp.build_gcn_config(spec, graph),
                                  **cfg_over)
    params = ref_init_gcn(jax.random.PRNGKey(0), ref_cfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return Setup(graph, parts, ref_cfg,
                 GCNConfig(**dataclasses.asdict(ref_cfg)),
                 jax.tree_util.tree_map(jnp.asarray, tree), tree,
                 spec.batch.norm, spec.batch.diag_lambda)


def _engines(s: Setup, tmp_path, **kw):
    fp = partition_fingerprint(s.graph, s.parts)
    ref = RefServeEngine(
        s.jax_params, s.graph, s.parts, s.ref_cfg,
        cache=RefEmbeddingCache(tmp_path / "ref", checkpoint_step=0,
                                partition_fingerprint=fp),
        norm=s.norm, diag_lambda=s.diag_lambda, **kw)
    port = ServeEngine(
        s.gcn(), s.graph, s.parts, s.cfg, device="cpu",
        cache=EmbeddingCache(tmp_path / "port", checkpoint_step=0,
                             partition_fingerprint=fp),
        norm=s.norm, diag_lambda=s.diag_lambda, **kw)
    return ref, port


# ----------------------------------------------------------------------
# the two compute paths
# ----------------------------------------------------------------------
@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_full_graph_embeddings_match_reference(variant, block):
    s = _setup(variant)
    kw = dict(norm=s.norm, diag_lambda=s.diag_lambda, block=block)
    got = full_graph_embeddings(s.gcn(), s.graph, s.parts, s.cfg, **kw)
    want = ref_full_graph_embeddings(s.jax_params, s.graph, s.parts,
                                     s.ref_cfg, **kw)
    oracle = np.asarray(ref_full_graph_logits(
        s.jax_params, s.graph, s.ref_cfg, norm=s.norm,
        diag_lambda=s.diag_lambda))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got - oracle).max() <= TOL


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_embed_cluster_matches_reference(variant):
    s = _setup(variant)
    kw = dict(norm=s.norm, diag_lambda=s.diag_lambda, block=16)
    oracle = np.asarray(ref_full_graph_logits(
        s.jax_params, s.graph, s.ref_cfg, norm=s.norm,
        diag_lambda=s.diag_lambda))
    gcn = s.gcn()
    for c in (0, int(s.parts.max())):
        rows = np.where(s.parts == c)[0][::-1]       # caller's order kept
        got = embed_cluster(gcn, s.graph, s.cfg, rows, **kw)
        want = ref_embed_cluster(s.jax_params, s.graph, s.ref_cfg, rows,
                                 **kw)
        assert np.abs(got - want).max() <= TOL
        assert np.abs(got - oracle[rows]).max() <= TOL


def test_host_oracle_matches_reference_oracle():
    s = _setup("deep")
    got = full_graph_logits(s.gcn(), s.graph, s.cfg, norm=s.norm,
                            diag_lambda=s.diag_lambda)
    want = np.asarray(ref_full_graph_logits(
        s.jax_params, s.graph, s.ref_cfg, norm=s.norm,
        diag_lambda=s.diag_lambda))
    assert np.abs(got - want).max() <= TOL


def test_params_round_trip_numpy():
    s = _setup("ppi_tiny")
    gcn = s.gcn()
    assert len(gcn.layers) == s.cfg.num_layers
    assert gcn.layers[-1].ln_scale is None
    back = params_to_numpy(gcn)
    assert jax.tree_util.tree_structure(back) \
        == jax.tree_util.tree_structure(s.tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(s.tree)):
        np.testing.assert_array_equal(a, b)


def test_init_gcn_is_seeded_and_shaped_like_the_reference():
    s = _setup("ppi_tiny")
    a = init_gcn(s.cfg, generator=torch.Generator().manual_seed(3),
                 device="cpu")
    b = init_gcn(s.cfg, generator=torch.Generator().manual_seed(3),
                 device="cpu")
    ta, tb = params_to_numpy(a), params_to_numpy(b)
    assert jax.tree_util.tree_structure(ta) \
        == jax.tree_util.tree_structure(s.tree)
    for x, y, r in zip(jax.tree_util.tree_leaves(ta),
                       jax.tree_util.tree_leaves(tb),
                       jax.tree_util.tree_leaves(s.tree)):
        np.testing.assert_array_equal(x, y)
        assert x.shape == r.shape and x.dtype == r.dtype
    w = ta["layers"][0]["w"]
    lim = np.sqrt(6.0 / sum(w.shape))
    assert np.abs(w).max() <= lim and w.std() > lim / 4


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
def _distinct(scores, j, eps=1e-5):
    s = scores[:, j]
    ok = np.ones(len(s), bool)
    if j > 0:
        ok &= np.abs(scores[:, j - 1] - s) > eps
    if j + 1 < scores.shape[1]:
        ok &= np.abs(scores[:, j + 1] - s) > eps
    return ok


@pytest.mark.parametrize("variant", ["ppi_tiny", "reddit_plain"])
def test_query_probs_and_topk_match_reference(variant, tmp_path):
    s = _setup(variant)
    ref, port = _engines(s, tmp_path, max_batch=64, top_k=4)
    assert port.buckets == ref.buckets
    assert ref.warm() == port.warm() == ref.num_parts
    rng = np.random.default_rng(0)
    for n in (1, 7, 64, 150):                   # 150 > top bucket: chunked
        ids = rng.integers(0, s.graph.num_nodes, size=n)
        a, b = ref.query(ids), port.query(ids)
        assert b.bucket == a.bucket
        np.testing.assert_array_equal(b.node_ids, a.node_ids)
        assert np.abs(b.logits - a.logits).max() <= TOL
        np.testing.assert_allclose(b.probs, a.probs, atol=1e-6)
        np.testing.assert_allclose(b.topk_scores, a.topk_scores, atol=1e-6)
        assert b.topk_ids.dtype == np.int32
        for j in range(a.topk_ids.shape[1]):
            keep = _distinct(a.topk_scores, j)
            np.testing.assert_array_equal(b.topk_ids[keep, j],
                                          a.topk_ids[keep, j])
        assert np.isfinite(b.latency_s) and b.latency_s > 0


def test_apply_delta_invalidates_the_same_clusters(tmp_path):
    s = _setup("ppi_tiny")
    ref, port = _engines(s, tmp_path)
    ref.warm()
    port.warm()
    n = s.graph.num_nodes
    feats = np.random.default_rng(1).normal(
        size=(2, s.graph.features.shape[1])).astype(np.float32)
    kw = dict(src=(3, n, n + 1), dst=(n, 40, 41), num_new_nodes=2,
              features=feats)
    a = ref.apply_delta(RefGraphDelta(**kw))
    b = port.apply_delta(GraphDelta(**kw))
    assert b == a
    assert b["invalidated_clusters"]            # the delta did touch some
    assert port.cache.dir.name == ref.cache.dir.name
    ids = np.arange(n + 2)
    qa, qb = ref.query(ids), port.query(ids)    # lazy halo re-embeds
    assert np.abs(qb.logits - qa.logits).max() <= TOL


def test_apply_delta_function_matches_reference():
    s = _setup("ppi_tiny")
    kw = dict(src=(0, 5, 9), dst=(9, 400, 5))
    for layers in (1, 3):
        g1, p1, t1 = apply_delta(s.graph, s.parts, GraphDelta(**kw),
                                 num_layers=layers)
        g2, p2, t2 = ref_apply_delta(s.graph, s.parts, RefGraphDelta(**kw),
                                     num_layers=layers)
        assert t1 == t2
        np.testing.assert_array_equal(p1, p2)
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(g1, f), getattr(g2, f))


# ----------------------------------------------------------------------
# checkpoints: one on-disk layout for both packages
# ----------------------------------------------------------------------
def test_reference_checkpoint_restores_in_the_port(tmp_path):
    s = _setup("ppi_tiny")
    RefCheckpointManager(str(tmp_path), async_save=False).save(
        5, {"params": s.jax_params, "opt": {"m": s.jax_params}},
        blocking=True)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.steps() == [5]
    mgr.verify_step(5)
    tree, step = mgr.restore_params(s.tree, device="cpu")
    assert step == 5
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(s.tree)):
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(a.numpy(), b)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    s = _setup("ppi_tiny")
    gcn = s.gcn()
    CheckpointManager(str(tmp_path / "port")).save(
        7, {"params": params_to_numpy(gcn)}, metadata={"note": "port"})
    RefCheckpointManager(str(tmp_path / "ref"), async_save=False).save(
        7, {"params": s.jax_params}, blocking=True)
    ref_mgr = RefCheckpointManager(str(tmp_path / "port"))
    ref_mgr.verify_step(7)
    params, step = ref_mgr.restore_params(s.jax_params)
    assert step == 7
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(s.tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the manifests agree array for array (keys, shapes, dtypes, crc32)
    man = [json.loads((tmp_path / d / "step_0000000007" / "manifest.json")
                      .read_text()) for d in ("port", "ref")]
    assert man[0]["arrays"] == man[1]["arrays"]
    assert man[0]["step"] == 7 and man[0]["metadata"] == {"note": "port"}


def test_port_checkpoint_walks_back_past_corrupt_newest(tmp_path):
    tree = {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3),
            "b": np.ones(3, np.float32)}
    m = CheckpointManager(str(tmp_path), keep=5)
    m.save(1, {"params": tree})
    m.save(2, {"params": {k: v + 100 for k, v in tree.items()}})
    shard = tmp_path / "step_0000000002" / "shard_0.npz"
    z = dict(np.load(shard))
    z["params__w"] = z["params__w"] + 1.0            # crc mismatch
    np.savez(shard, **z)
    with pytest.raises(IOError, match="checksum"):
        m.restore_params(tree, step=2)
    with pytest.warns(UserWarning, match="quarantined"):
        params, step = m.restore_params(tree)
    assert step == 1
    np.testing.assert_array_equal(params["w"].numpy(), tree["w"])
    assert m.latest_valid_step() == 1


def test_port_restores_dist_params_layout_and_keeps_k(tmp_path):
    tree = {"w": np.ones((2, 2), np.float32)}
    RefCheckpointManager(str(tmp_path), async_save=False).save(
        3, {"dist": {"params": tree}}, blocking=True)
    params, step = CheckpointManager(str(tmp_path)).restore_params(tree)
    assert step == 3 and params["w"].shape == (2, 2)
    m = CheckpointManager(str(tmp_path / "k"), keep=2)
    for step in range(4):
        m.save(step, {"params": tree})
    assert m.steps() == [2, 3]
    with pytest.raises(KeyError, match="params"):
        m2 = CheckpointManager(str(tmp_path / "other"))
        m2.save(1, {"opt_state": tree})
        m2.restore_params(tree)


def test_from_checkpoint_serves_what_the_reference_serves(tmp_path):
    spec = ref_exp.preset("ppi_tiny")
    s = _setup("ppi_tiny")
    RefCheckpointManager(str(tmp_path / "ck"), async_save=False).save(
        4, {"params": s.jax_params}, blocking=True)
    ref = RefServeEngine.from_checkpoint(spec, str(tmp_path / "ck"),
                                         cache_root=tmp_path / "rc")
    port = ServeEngine.from_checkpoint(exp.preset("ppi_tiny"),
                                       str(tmp_path / "ck"), device="cpu",
                                       cache_root=tmp_path / "pc")
    assert port.cache.dir.name == ref.cache.dir.name
    ids = np.arange(0, s.graph.num_nodes, 5)
    a, b = ref.query(ids), port.query(ids)
    assert np.abs(b.logits - a.logits).max() <= TOL


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
def test_serve_gcn_cli_on_cpu_with_parity(tmp_path):
    s = _setup("ppi_tiny")
    RefCheckpointManager(str(tmp_path / "ck"), async_save=False).save(
        2, {"params": s.jax_params}, blocking=True)
    bench = tmp_path / "bench.json"
    rc = serve_gcn.main(["--preset", "ppi_tiny", "--device", "cpu",
                         "--checkpoint-dir", str(tmp_path / "ck"),
                         "--set", f"serve.cache_dir={tmp_path / 'cache'}",
                         "--queries", "96", "--verify-parity",
                         "--bench-out", str(bench)])
    assert rc == 0
    doc = json.loads(bench.read_text())
    assert doc["device"] == "cpu" and doc["qps"] > 0
    buckets = [r for r in doc["rows"] if "p50_s" in r]
    assert len(buckets) >= 2
    assert all(np.isfinite(r["p50_s"]) and r["p50_s"] > 0 for r in buckets)
    assert any(r["name"].endswith("/precompute") for r in doc["rows"])


def test_serve_gcn_trains_on_a_cold_start(tmp_path, capsys):
    """An empty checkpoint directory: the CLI trains the preset on the
    CPU (as the reference's `_train_if_needed` does), writes step_*,
    then serves the new checkpoint and passes --verify-parity."""
    ck = tmp_path / "empty"
    rc = serve_gcn.main(["--preset", "ppi_tiny", "--device", "cpu",
                         "--checkpoint-dir", str(ck),
                         "--set", "run.epochs=2",
                         "--set", f"serve.cache_dir={tmp_path / 'cache'}",
                         "--queries", "64", "--verify-parity"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "training ppi_tiny for 2 epoch(s) first" in err
    assert "parity vs host full-graph oracle" in err and "[OK]" in err
    steps = sorted(ck.glob("step_*"))
    assert steps
    spec = exp.preset("ppi_tiny")
    graph = exp.build_graph(spec)
    parts, _ = exp.build_partition(spec, graph)
    per_epoch = exp.build_batcher(spec, graph, parts).steps_per_epoch()
    assert CheckpointManager(str(ck)).latest_valid_step() == 2 * per_epoch
