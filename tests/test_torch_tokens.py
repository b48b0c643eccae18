"""The port's LM data pipelines (`repro_torch.data`) against
`repro.data`: every batch, feature and cluster assignment bit for bit
(both are numpy; the port keeps its own copy)."""
import numpy as np
import pytest

from repro.data import clustered_batching as ref_cb
from repro.data import tokens as ref_tokens
from repro_torch.data import clustered_batching as cb
from repro_torch.data import tokens


@pytest.mark.parametrize("vocab,order", [(512, 512), (50304, 512),
                                         (97, 512)])
@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (3, 1, 4)])
def test_token_pipeline_batches_are_the_references(vocab, order, seed,
                                                   shard, num_shards):
    kw = dict(vocab_size=vocab, batch_size=3, seq_len=33, seed=seed,
              shard_id=shard, num_shards=num_shards, order=order)
    ref, port = ref_tokens.TokenPipeline(**kw), tokens.TokenPipeline(**kw)
    for step in (0, 1, 17, 1000):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert list(got) == list(want) == ["tokens"]
        assert got["tokens"].dtype == want["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for (_, a), b in zip(zip(range(3), iter(port)), iter(ref)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_token_pipeline_is_a_pure_function_of_its_key():
    a = tokens.TokenPipeline(256, 2, 16, seed=5)
    b = tokens.TokenPipeline(256, 2, 16, seed=5)
    np.testing.assert_array_equal(a.batch_at(9)["tokens"],
                                  b.batch_at(9)["tokens"])
    assert not np.array_equal(a.batch_at(9)["tokens"],
                              a.batch_at(10)["tokens"])


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetcher_yields_the_iterator_in_order(depth):
    items = [{"tokens": np.full((2, 3), i, np.int32)} for i in range(7)]
    got = list(tokens.Prefetcher(iter(items), depth=depth))
    want = list(ref_tokens.Prefetcher(iter(items), depth=depth))
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_prefetcher_of_the_pipeline_matches_batch_at():
    pipe = tokens.TokenPipeline(300, 2, 12, seed=1)
    pre = tokens.Prefetcher(iter(pipe), depth=2)
    for step in range(4):
        np.testing.assert_array_equal(next(pre)["tokens"],
                                      pipe.batch_at(step)["tokens"])


def _docs(seed, n=120):
    """Documents from a few topics (each a vocabulary slice), ragged."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        topic = i % 6
        length = int(rng.integers(0, 40))
        docs.append(rng.integers(topic * 50, topic * 50 + 60,
                                 size=length).astype(np.int32))
    return docs


@pytest.mark.parametrize("n,dim", [(1, 256), (2, 64)])
def test_ngram_features_and_kmeans_are_the_references(n, dim):
    docs = _docs(0)
    want = ref_cb.ngram_features(docs, dim=dim, n=n)
    got = cb.ngram_features(docs, dim=dim, n=n)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for k, seed in ((6, 0), (10, 3)):
        np.testing.assert_array_equal(cb.kmeans(got, k, seed=seed),
                                      ref_cb.kmeans(want, k, seed=seed))


@pytest.mark.parametrize("q,batch_docs", [(2, 8), (4, 5)])
def test_clustered_batcher_is_the_references(q, batch_docs):
    docs = _docs(1)
    kw = dict(docs=docs, num_clusters=12, clusters_per_batch=q,
              batch_docs=batch_docs, seed=2)
    ref, port = ref_cb.ClusteredBatcher(**kw), cb.ClusteredBatcher(**kw)
    np.testing.assert_array_equal(port.assign, ref.assign)
    for a, b in zip(port.members, ref.members):
        np.testing.assert_array_equal(a, b)
    for epoch in (0, 1):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert port.within_batch_vocab_locality(a) == \
                ref.within_batch_vocab_locality(b)
