"""PyTorch/CUDA port of the `repro` Cluster-GCN system.

The JAX package `repro` is the reference; this package mirrors its
layout and names module for module, in PyTorch idiom, and never imports
JAX or `repro` (numpy-only stages are copied, not imported). Every
Pallas TPU kernel on a ported path is a hand-written CUDA kernel for
Hopper (sm_90a) under `kernels/csrc/`, with a plain PyTorch version
beside it that CPU tensors take.

Ported so far: single-device Cluster-GCN training (`core/engine.py`,
`launch/run_experiment.py`), the GCN serving path (`serve/`,
`launch/serve_gcn.py`), with the host stages they need, and LM serving
(`models/`, `dist/steps.py`, `launch/serve.py`: prefill through the
flash-attention kernel, greedy decode over the KV cache). The
GraphSAINT samplers, data parallelism, the baselines, LM training and
the other LM block kinds come in later slices.
"""
