"""PyTorch/CUDA port of the `repro` Cluster-GCN system.

The JAX package `repro` is the reference; this package mirrors its
layout and names module for module, in PyTorch idiom, and never imports
JAX or `repro` (numpy-only stages are copied, not imported). Every
Pallas TPU kernel on a ported path is a hand-written CUDA kernel for
Hopper (sm_90a) under `kernels/csrc/`, with a plain PyTorch version
beside it that CPU tensors take.

Ported so far: Cluster-GCN training (`core/engine.py`,
`launch/run_experiment.py`) on one device or data parallel over a
torch.distributed process group with optional gradient compression
(`dist/steps.py`, `dist/compression.py`; `torchrun`), on the cluster
batcher or the GraphSAINT samplers (`core/samplers.py`), on synthetic
graphs or the real benchmarks (`graph/datasets.py`: download,
checksums, the processed mmap cache shared with the reference), the
paper's baselines (`core/baselines.py`: full-batch, exact L-hop SGD,
GraphSAGE, VR-GCN), the GCN serving path (`serve/`,
`launch/serve_gcn.py`, which trains first on a cold start), with the
host stages they need, and LM serving (`models/`, `dist/steps.py`,
`launch/serve.py`: prefill through the flash-attention kernel, greedy
decode over the KV cache). LM training and the other LM block kinds
come in later slices.
"""
