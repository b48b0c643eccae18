"""LM training data — `repro.data` on the host, in numpy: the
deterministic token pipeline and its prefetcher (`tokens`), and the
cluster-drawn document batches (`clustered_batching`). Batches are
bit-equal to the reference's for each seed, step and shard."""
from repro_torch.data.clustered_batching import (ClusteredBatcher, kmeans,
                                                 ngram_features)
from repro_torch.data.tokens import Prefetcher, TokenPipeline

__all__ = ["ClusteredBatcher", "Prefetcher", "TokenPipeline", "kmeans",
           "ngram_features"]
