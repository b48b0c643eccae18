"""The port's real-dataset path (`repro_torch.graph.datasets`) on the CPU:
download → checksum → extract → parse → processed cache → mmap, offline,
against archives in the real formats served through
$REPRO_DATASETS_MIRROR as `file://` (the fixture writers of
tests/test_datasets.py, and the port's own PPI writer
`repro_torch.graph.archives`).

* Every case of tests/test_datasets.py, on the port: the four parsers
  through the cache, the val mask wiring, `make_dataset` on real names,
  trust-on-first-use checksums and a pinned-hash mismatch, retry with
  backoff under both download.* faults, partial-file cleanup, and the
  ppi_real_tiny preset training end to end.
* Each processed array equal (exactly) to the reference's
  `load_dataset` on the same archive, and a cache processed by either
  package loading in the other without touching raw/.
* Memory-mapped features through the batch builders, the SAINT
  samplers and the serving forward: identical payloads and logits to
  the in-memory graph, no copy of the whole matrix and no warning about
  a non-writable array.
"""
import hashlib
import json
import shutil
import warnings

import numpy as np
import pytest
import torch

from repro.graph import datasets as ref_ds
from repro_torch.core.engine import resolve_eval_mask
from repro_torch.graph import datasets as ds
from repro_torch.graph.archives import write_graphsage_ppi
from repro_torch.graph.datasets import (REAL_DATASETS, dataset_meta,
                                        load_dataset)
from repro_torch.graph.generators import make_dataset
from repro_torch.runtime.faults import (FaultPlan, FaultRule, InjectedFault,
                                        fault_scope)
from test_datasets import (N_OGB, N_PPI, N_REDDIT, make_ogb_zip,
                           make_ppi_zip, make_reddit_zip)

ARRAYS = ("indptr", "indices", "data", "features", "labels", "train_mask",
          "val_mask", "test_mask")


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
    """Archives under the exact filenames the registry downloads."""
    d = tmp_path_factory.mktemp("mirror")
    make_ppi_zip(d / "ppi.zip")
    make_reddit_zip(d / "reddit.zip")
    make_ogb_zip(d / "arxiv.zip", folder="arxiv", split="time")
    make_ogb_zip(d / "products.zip", n=70, folder="products",
                 split="sales_ranking", seed=3)
    return d


@pytest.fixture
def dataset_env(mirror, tmp_path, monkeypatch):
    """A fresh cache root and the module's mirror."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("REPRO_DATASETS_CACHE", str(cache))
    monkeypatch.setenv("REPRO_DATASETS_MIRROR", mirror.as_uri())
    return cache


# ----------------------------------------------------------------------
# the four parsers through the cache
# ----------------------------------------------------------------------
def test_ppi_real_pipeline_and_processed_cache(dataset_env):
    g = load_dataset("ppi_real")
    assert g.num_nodes == N_PPI
    assert g.features.shape == (N_PPI, 10)
    assert g.labels.shape[1] == 6 and g.labels.dtype == np.float32
    assert g.train_mask.any() and g.val_mask.any() and g.test_mask.any()
    assert not (g.train_mask & (g.val_mask | g.test_mask)).any()
    assert isinstance(g.features, np.memmap)
    g2 = load_dataset("ppi_real", mmap=False)
    assert not isinstance(g2.features, np.memmap)
    np.testing.assert_array_equal(np.asarray(g.features), g2.features)
    shutil.rmtree(dataset_env / "ppi_real" / "raw")    # cache hit
    g3 = load_dataset("ppi_real")
    np.testing.assert_array_equal(g.indptr, g3.indptr)
    meta = dataset_meta("ppi_real")
    assert meta["num_nodes"] == N_PPI and meta["feature_dim"] == 10
    assert meta["version"] == ds.PROCESSED_VERSION


def test_reddit_real_pipeline(dataset_env):
    g = load_dataset("reddit_real")
    assert g.num_nodes == N_REDDIT
    assert g.features.shape == (N_REDDIT, 8)
    assert g.labels.ndim == 1
    assert (int(g.train_mask.sum() + g.val_mask.sum()
                + g.test_mask.sum()) == N_REDDIT)


@pytest.mark.parametrize("name,n", [("ogbn_arxiv", N_OGB),
                                    ("ogbn_products", 70)])
def test_ogb_pipeline(dataset_env, name, n):
    g = load_dataset(name)
    assert g.num_nodes == n
    assert g.features.shape == (n, 6)
    assert g.labels.ndim == 1
    assert int(g.train_mask.sum()) == n // 2
    assert not (g.train_mask & g.val_mask).any()
    assert not (g.val_mask & g.test_mask).any()


def test_real_masks_resolve_to_val_not_test(dataset_env):
    calls = []
    for name in ("ppi_real", "reddit_real", "ogbn_arxiv"):
        g = load_dataset(name)
        split, mask = resolve_eval_mask(g, "auto", warner=calls.append)
        assert split == "val" and mask.any()
    assert calls == []


@pytest.mark.parametrize("name", sorted(REAL_DATASETS))
def test_processed_arrays_equal_reference(dataset_env, name):
    """Both packages load the same archive; the reference first, into
    its own cache, then the port into another."""
    want = ref_ds.load_dataset(name, cache_dir=str(dataset_env / "ref"),
                               mmap=False)
    got = load_dataset(name, cache_dir=str(dataset_env / "port"),
                       mmap=False)
    for field in ARRAYS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert dataset_meta(name, str(dataset_env / "port")) == \
        ref_ds.dataset_meta(name, str(dataset_env / "ref"))


@pytest.mark.parametrize("first", ["reference", "port"])
def test_cache_processed_by_one_package_loads_in_the_other(
        dataset_env, monkeypatch, first):
    loaders = {"reference": ref_ds.load_dataset, "port": load_dataset}
    second = "port" if first == "reference" else "reference"
    written = loaders[first]("ppi_real", mmap=False)
    shutil.rmtree(dataset_env / "ppi_real" / "raw")
    monkeypatch.delenv("REPRO_DATASETS_MIRROR")       # no download
    read = loaders[second]("ppi_real")
    assert isinstance(read.features, np.memmap)
    for field in ARRAYS:
        np.testing.assert_array_equal(getattr(read, field),
                                      getattr(written, field))


def test_make_dataset_serves_real_names(dataset_env):
    assert make_dataset("ppi_real").num_nodes == N_PPI


def test_make_dataset_rejects_scale_on_real(dataset_env):
    with pytest.raises(ValueError, match="cannot be resampled"):
        make_dataset("ppi_real", scale=0.5)


def test_unknown_real_dataset():
    with pytest.raises(KeyError, match="unknown real dataset"):
        load_dataset("nope_real")


# ----------------------------------------------------------------------
# checksums
# ----------------------------------------------------------------------
def test_tofu_checksum_rejects_changed_upstream(tmp_path, monkeypatch):
    own_mirror = tmp_path / "mirror"
    own_mirror.mkdir()
    make_ppi_zip(own_mirror / "ppi.zip", seed=0)
    cache = tmp_path / "cache"
    monkeypatch.setenv("REPRO_DATASETS_CACHE", str(cache))
    monkeypatch.setenv("REPRO_DATASETS_MIRROR", own_mirror.as_uri())
    load_dataset("ppi_real")        # records the first-seen sha256
    make_ppi_zip(own_mirror / "ppi.zip", seed=99)
    raw = cache / "ppi_real" / "raw"
    db = (raw / "CHECKSUMS.json").read_text()
    shutil.rmtree(raw)
    shutil.rmtree(cache / "ppi_real" / "processed")
    raw.mkdir(parents=True)
    (raw / "CHECKSUMS.json").write_text(db)
    with pytest.raises(ValueError, match="previously recorded"):
        load_dataset("ppi_real")


def test_missing_file_error_is_actionable(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_DATASETS_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("REPRO_DATASETS_MIRROR",
                       (tmp_path / "empty").as_uri())
    with pytest.raises(RuntimeError, match="REPRO_DATASETS_MIRROR"):
        load_dataset("ppi_real")


# ----------------------------------------------------------------------
# download hardening
# ----------------------------------------------------------------------
@pytest.fixture
def flaky_env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_DOWNLOAD_BACKOFF", "0.01")
    src = tmp_path / "mirror" / "file.bin"
    src.parent.mkdir()
    src.write_bytes(b"x" * 4096)
    sha = hashlib.sha256(src.read_bytes()).hexdigest()
    return ds.RemoteFile("file.bin", src.as_uri(), sha256=sha), \
        tmp_path / "raw"


@pytest.mark.parametrize("site,times", [("download.error", 2),
                                        ("download.partial", 1)])
def test_download_converges_under_transient_faults(flaky_env, site, times):
    rf, raw = flaky_env
    with fault_scope(FaultPlan(rules={site: FaultRule(times=times)})):
        dest = ds.fetch(rf, raw)
    assert dest.read_bytes() == b"x" * 4096
    assert not list(raw.glob("*.part-*"))    # no truncated leftovers


def test_exhausted_attempts_keep_actionable_hint(flaky_env):
    rf, raw = flaky_env
    with fault_scope(FaultPlan(rules={"download.error": FaultRule()})):
        with pytest.raises(RuntimeError,
                           match="REPRO_DATASETS_MIRROR") as ei:
            ds.fetch(rf, raw)
    assert "attempt" in str(ei.value)
    assert isinstance(ei.value.__cause__, InjectedFault)
    assert not list(raw.glob("*.part-*"))


def test_pinned_checksum_mismatch_is_fatal_not_retried(flaky_env,
                                                       monkeypatch):
    import dataclasses
    rf, raw = flaky_env
    bad = dataclasses.replace(rf, sha256="0" * 64)
    calls = []
    real = ds._download_once
    monkeypatch.setattr(ds, "_download_once",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    with pytest.raises(ValueError, match="checksum mismatch"):
        ds.fetch(bad, raw)
    assert len(calls) == 1


def test_stale_part_files_swept_before_download(flaky_env):
    rf, raw = flaky_env
    raw.mkdir(parents=True)
    stale = raw / "file.bin.part-leftover"
    stale.write_bytes(b"junk from a crashed run")
    ds.fetch(rf, raw)
    assert not stale.exists()


def test_backoff_is_capped_deterministic_and_equal_to_reference():
    delays = [ds._backoff_delay("f.zip", a, base=1.0) for a in range(1, 12)]
    assert delays == [ref_ds._backoff_delay("f.zip", a, base=1.0)
                      for a in range(1, 12)]
    assert all(d <= ds.DOWNLOAD_BACKOFF_CAP_S for d in delays)
    assert 0.5 <= delays[0] < 1.0


def test_build_experiment_scopes_download_faults(dataset_env, monkeypatch):
    """A spec's run.faults fire while its dataset downloads, and the
    retry absorbs them."""
    from repro_torch.core.experiment import apply_overrides, preset
    from repro_torch.runtime import faults
    monkeypatch.setenv("REPRO_DOWNLOAD_BACKOFF", "0.01")
    fired = []
    real = faults.maybe_fail
    monkeypatch.setattr(ds.faults, "maybe_fail", lambda site, **k: (
        fired.append(site) if site.startswith("download") else None,
        real(site, **k))[1])
    spec = apply_overrides(preset("ppi_real_tiny"), {
        "partition.num_parts": 4, "model.hidden_dim": 16,
        "run.epochs": 1, "run.eval_every": 0,
        "run.faults": {"rules": {"download.error": {"times": 1}}}})
    from repro_torch.core.experiment import build_experiment
    build_experiment(spec, device="cpu")
    assert fired.count("download.error") == 2      # failed once, retried


# ----------------------------------------------------------------------
# the port's PPI writer and memory-mapped features
# ----------------------------------------------------------------------
def test_port_ppi_writer_loads_identically_in_both_packages(tmp_path,
                                                            monkeypatch):
    mirror = tmp_path / "mirror"
    counts = write_graphsage_ppi(mirror / "ppi.zip", num_nodes=600,
                                 num_links=4000, feature_dim=7,
                                 num_labels=5, val=80, test=70,
                                 num_graphs=8, seed=1)
    monkeypatch.setenv("REPRO_DATASETS_MIRROR", mirror.as_uri())
    got = load_dataset("ppi_real", cache_dir=str(tmp_path / "port"))
    want = ref_ds.load_dataset("ppi_real", cache_dir=str(tmp_path / "ref"))
    for field in ARRAYS:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert counts["links"] == 4000
    assert (int(got.val_mask.sum()), int(got.test_mask.sum()),
            int(got.train_mask.sum())) == (80, 70, 450)
    assert got.features.shape == (600, 7) and got.labels.shape == (600, 5)
    # links stay inside the 8 graphs: no edge joins two splits
    src = np.repeat(np.arange(600), np.diff(got.indptr))
    split = got.val_mask.astype(int) + 2 * got.test_mask
    assert (split[src] == split[got.indices]).all()


@pytest.fixture
def mapped(dataset_env):
    """ppi_real loaded memory-mapped and in memory."""
    return load_dataset("ppi_real", mmap=True), \
        load_dataset("ppi_real", mmap=False)


def _leaves(batch):
    out = []
    for leaf in batch.astuple():
        out.extend(leaf.tensors() if hasattr(leaf, "tensors") else [leaf])
    return [np.asarray(x) for x in out if x is not None]


@pytest.mark.parametrize("sampler", ["cluster", "saint_node", "saint_edge"])
def test_memmap_features_give_identical_batches(mapped, sampler):
    from repro_torch.core.batching import ClusterBatcher
    from repro_torch.core.samplers import SaintEdgeSampler, SaintNodeSampler
    from repro_torch.graph.partition import graph_fingerprint, partition_graph
    mm, mem = mapped
    assert isinstance(mm.features, np.memmap)
    assert not mm.features.flags.writeable
    assert graph_fingerprint(mm) == graph_fingerprint(mem)
    parts, _ = partition_graph(mem, 4, method="metis", seed=0, cache=False)

    def make(g):
        if sampler == "cluster":
            return ClusterBatcher(g, parts, clusters_per_batch=2, seed=0,
                                  sparse_adj=True, precompute_ax=True)
        cls = SaintNodeSampler if sampler == "saint_node" \
            else SaintEdgeSampler
        return cls(g, 40, seed=0, sparse_adj=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # e.g. a non-writable array
        got = [_leaves(b) for b in make(mm).epoch(0)]
    want = [_leaves(b) for b in make(mem).epoch(0)]
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("residual", [False, True])
def test_memmap_features_serve_identically(mapped, residual):
    from repro_torch.core.gcn import GCNConfig, init_gcn
    from repro_torch.graph.partition import partition_graph
    from repro_torch.serve.embedding_cache import (embed_cluster,
                                                   full_graph_embeddings)
    mm, mem = mapped
    parts, _ = partition_graph(mem, 4, method="metis", seed=0, cache=False)
    cfg = GCNConfig(in_dim=10, hidden_dim=10, out_dim=6, num_layers=2,
                    dropout=0.0, residual=residual, precompute_ax=residual)
    model = init_gcn(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = full_graph_embeddings(model, mm, parts, cfg, row_chunk=37)
        rows = np.where(parts == 1)[0]
        got_rows = embed_cluster(model, mm, cfg, rows)
    want = full_graph_embeddings(model, mem, parts, cfg)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_rows, want[rows], rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# end to end
# ----------------------------------------------------------------------
def test_ppi_real_preset_trains_end_to_end(dataset_env):
    from repro_torch.core.experiment import (apply_overrides,
                                             build_experiment, preset)
    spec = preset("ppi_real_tiny")
    apply_overrides(spec, {"partition.num_parts": 4,
                           "batch.clusters_per_batch": 2,
                           "model.hidden_dim": 16,
                           "run.epochs": 2, "run.eval_every": 1})
    exp = build_experiment(spec, device="cpu")
    res = exp.fit()
    assert len(res.history) == 2
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert all(h["eval_split"] == "val" for h in res.history)
    exp2 = build_experiment(spec, device="cpu")
    assert exp.partition_stats.cached is False
    assert exp2.partition_stats.cached is True
    np.testing.assert_array_equal(exp.parts, exp2.parts)
    assert json.loads(json.dumps(dataset_meta("ppi_real")))["name"] == \
        "ppi_real"
