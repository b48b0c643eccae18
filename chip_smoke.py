#!/usr/bin/env python3
"""On-GPU smoke of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA GPU (sm_90a: H100/H200) and nvcc; fails on any other
host, and fails in a directory holding nothing of the repository but
this script. Phases, each of which must pass (no failure is caught):

1. Build: compiles every CUDA kernel of the port from the sources in
   this checkout (one nvcc per source, in parallel) and prints the GPU's
   name and power limit (nvidia-smi) and the build time. Counts the
   HGMMA (wgmma) instructions in the SASS of the bf16 flash library
   (`cuobjdump -sass`) and fails at 0. For both GCN libraries (the tile
   mainloop of `csrc/block_tile.cuh`) counts the asynchronous-copy
   instructions (LDGSTS for cp.async, UTMALDG for TMA) and fails at 0,
   and prints ptxas's registers per kernel, failing on any spill.
2. Kernels vs their plain versions on the GPU, same inputs:
   `spmm_block_ell` over B in {8, 16, 128}, F in {1, 121, 2048}, fp32 and
   bf16, row_k None and given, K = 0, the ppi_sota serving cluster shape
   and the training backward's transposed shape (with row_k_t);
   `spmm_fused_block_ell` over B in {8, 16, 128}, D and F in {1, 121,
   2048}, fp32 and bf16, row_k None and given, K = 0, and the three
   ppi_sota training shapes (D 50 → F 2048, 2048 → 2048, 2048 → 121;
   nrb 3, K 3, B 128). Tolerance max|Δ| <= 1e-5·max(1, max|y_ref|) in
   fp32 (different summation order) and 8e-3·max(1, max|y_ref|) in bf16
   (one bf16 rounding of the output); every case is also called twice
   and must be bitwise equal (split contractions reduce in a fixed
   order). Each case prints the error, kernel ms, plain ms and bound ms
   (CUDA events after warm-up); the main shapes also time one library
   call as a yardstick (torch.bmm on the gathered operands; torch.addmm
   then that bmm for the fused product) — timed only, the port never
   calls them — and print the kernel's factor against it, its share of
   the bound and its launch plan (tile width, splits, copy width).
   `scatter_tiles` (the block-ELL tiles of a batch's compact adjacency,
   `BlockEllCoords.to("cuda")`) at a ppi_sota and a reddit batch's
   shape (12 x 12 and 27 x 27 tiles of 128, about 27,500 and 15,200
   nonzeros) must equal the tiles the host builds from the same CSR
   bit for bit, in one launch; each prints the kernel's ms against its
   plain version (the host's numpy scatter), its bound (the zero fill
   and the scattered words) and torch's indexed assignment, and the
   blocking copy of the host tiles it replaces beside the packed
   buffer's.
3. Train ppi_sota (5 layers, 2048 wide, block-ELL batches, fused
   layers) for 2 epochs through `repro_torch.launch.run_experiment.main`
   — the main path: 5 fused launches and 5 block-ELL launches (the
   backward on the transposed tiles) per step, one scatter launch per
   step (the batch's tiles written on the card), a finite loss that falls
   from epoch 1 to 2. Then where a step's time goes: host batch build
   vs device step (medians), and one step under torch.profiler (device
   time by kernel, idle share).
4. One-step parity: the same params and batch (dropout 0), `gcn_loss` +
   backward on the GPU (kernels) against the CPU (plain versions); loss
   within 1e-4 relative, grads within 1e-4·max(1, max|g_cpu|).
   Then the step as CUDA graphs: 20 steps of the recipe (dropout on)
   from one seed on 20 payloads already on the card, once eager (the
   `make_train_step` body, op by op) and once through the backend
   (captured at step 2, replayed after): each one's median host time a
   step and nodes/s over steps 3-20, and every loss, aux and state leaf
   bitwise equal. Phase 18 does the same for reddit and amazon2m.
5. One epoch of the unfused path (`model.fuse_spmm=false`): 10 block-ELL
   launches per step, none fused.
6. Serve the checkpoint that phase 3 trained: `serve_gcn.main
   --verify-parity` precomputes the embedding cache, answers 1024
   lookups and holds them against the host oracle; launch
   count (non-empty clusters x 5 propagations), served logits against
   the host oracle `full_graph_logits` (max|Δ| <= 1e-4·max(1,
   max|ref|)), the lazy halo re-embed of an invalidated cluster, and
   where the serving time goes (torch.profiler; host gather vs device
   step of a 256-id query).
7. The flash-attention kernels against their plain version on the GPU
   (fp32: the CUDA-core kernel; bf16: the wgmma/TMA kernel): causal,
   non-causal, window 17, softcap 30; D in {16, 64, 80, 128, 256} at
   B 1, Hq 4 over Hkv 1, ragged T 100; GQA 32/8 at T 256; Tq 1 with
   Tk 96 and Tq 96 with Tk 64 (rows that see no key); fp32 and bf16;
   the same tolerances as phase 2. Then bf16 only: D 128 and 256 at
   T 2048 causal, gemma3's local layer (Hq 4 over 1, D 256, window 512,
   softcap 30), Tk 1000 (not a multiple of 128) with Tq 300 and 1000,
   and the model's transposed (B, T, H, D) views at T 1000. At the
   llama3.2-1b prefill shape (B 4, Hq 32 over Hkv 8, T 2048, D 64,
   bf16, causal) kernel ms, TFLOP/s, % of the bound, plain ms and one
   library call timed as a yardstick (`scaled_dot_product_attention(
   is_causal=True, enable_gqa=True)`; the port never calls it).
8. Serve llama3.2-1b (16 layers x 2048, GQA 32/8, random weights from
   seed 0) through `repro_torch.launch.serve.main` — batch 4, prompt
   2048, 32 generated tokens: exactly 16 flash launches in the prefill,
   all of them the bf16 wgmma kernel, and none in decode, finite
   logits, prefill seconds and decode tok/s.
   Then, same params, two comparisons: the prefill's logits with the
   kernel against the same prefill with the plain attention, and
   prefill(S) against prefill(S-1) + one decode step. In fp32 (the
   same random weights, uncast) both within 1e-4·max|ref|. In bf16,
   the served dtype, both within twice the bf16 floor — the distance
   of the plain bf16 prefill from the fp32 one — because at 16 layers
   x 2048 bf16 rounding alone moves the logits by more than the
   reference's 1e-2 (PERF.md). Then warm prefill and decode-step
   times, and one prefill and four decode steps under torch.profiler
   (device time by kernel, idle share).
9. Cold-start serving: `serve_gcn.main` on an EMPTY checkpoint directory
   (ppi_sota, 1 epoch, block-ELL, fused, node_cap 384, 256 queries,
   --verify-parity) trains first, then serves: exactly 5 fused and 5
   block-ELL launches per training step plus non-empty clusters x 5
   propagations for the precompute, a checkpoint written, and the
   served logits against the host oracle within phase 6's bound.
10. GraphSAINT training at ppi_sota's width and depth (5 x 2048, the
   14,000-node stand-in, block-ELL, fused, node_cap 384) through
   `run_experiment.main`: `saint_node` for 2 epochs (budget 280 draws,
   50 steps an epoch) and `saint_edge` for 1 epoch (budget 140 edge
   draws, 200 steps, cut from a pass's 1,347): exactly 5 fused and 5
   block-ELL launches per step, finite losses, the node sampler's loss
   falling from epoch 1 to 2, peak device memory. Then the step split
   (host build, copy, step; medians of 20) and the tile occupancy of
   SAINT batches (mean live K slots per row-block, block fill) against
   the cluster batches of phase 3, and one-step GPU vs CPU parity on a
   SAINT batch
   (fractional loss weights) under phase 4's bounds.
11. The paper's baselines at ppi_sota's widths (5 x 2048, the same
   graph, AdamW 1e-2, batch 512, their default eq10 normalisation):
   full-batch GCN for 3 epochs, then exact L-hop SGD, GraphSAGE
   (fanouts 25/10/10/10/10) and VR-GCN for 1 epoch each (18 steps):
   finite losses, seconds per epoch and peak device memory
   (`reset_peak_memory_stats` before each run, `max_memory_allocated`
   after), VR-GCN's host history exactly N x 2048 x 4 layers x 4 bytes;
   one table of them beside the Cluster-GCN run of phase 3 and the
   saint_node run of phase 10. Then one full-batch step GPU vs CPU
   from the same params (dropout 0; `index_add` sums with atomics on
   the card): loss within 1e-4 relative.
12. A real-format dataset at the published PPI size: the port's writer
   (`repro_torch.graph.archives`) puts a GraphSAGE-format ppi.zip from
   seed 0 into a temporary `file://` mirror — 56,944 nodes in 24 graphs,
   818,716 links, 50 features, 121 labels, splits 44,906 / 6,514 /
   5,524 — and `load_dataset("ppi_real")` runs into a fresh cache
   (fetch, checksum, extract, parse, processed write: timed), then
   reloads it memory-mapped (timed). Then ppi_sota's recipe (5 x 2048,
   block-ELL, fused) on that graph (`data.name=ppi_real`) trains one
   epoch through `run_experiment.main` on the card: exactly 5 fused and 5
   block-ELL launches per step, finite loss, peak device memory; the
   step split (medians of 20) and one step card vs CPU under phase 4's
   bounds. The links, features and labels are random: no F1 is claimed.
13. Data-parallel training, in child processes of this script:
   (a) a world of 1 over NCCL (env:// rendezvous at 127.0.0.1): for
   compression None, "bf16", 8 and 4, 20 steps of ppi_sota (5 x 2048,
   block-ELL, fused) through `build_experiment(...).fit()` with
   execution.data_shards=1 (exactly 5 + 5 launches per step), the step
   median and the host build of the rank's slice (synchronised, 20
   steps), the all-reduce's share of the step (one
   all-reduce of the step's flat gradient buffer, CUDA events), and the
   first step against `SingleDeviceBackend` on the same batch and params
   (dropout 0): the synced gradient, read from AdamW's first moment,
   within STEP_TOL·max(1, max|m|) (None), 2^-8 of each element plus that
   (bf16: one bf16 rounding), or max|m|/(2·qmax) plus that (int8/int4:
   half a quantization step of the leaf's largest group).
   (b) two ranks on cuda:0 over gloo (NCCL refuses two ranks on one
   card; gloo stages CUDA tensors through the host): one step of two
   different batches; the synced gradient against the mean of the two
   ranks' own gradients and the updated params against one AdamW step
   of that mean, under STEP_TOL·max(1, max|ref|); 5 + 5 launches per
   rank; the host build of a rank's slice (every rank builds both
   batches of the group); gloo's all-reduce time for the gradient
   buffer of CUDA tensors.
   Nothing here is NCCL across cards: the machine has one.
14. The reference's other attention-only LMs at their published widths
   (random weights from seed 0; B 4, 2048 prompt tokens, 8 generated):
   gemma3-1b, granite-3-2b, internlm2-20b, granite-moe-1b-a400m and
   paligemma-3b (256 prefix embeddings before the prompt, so T 2304)
   through `repro_torch.launch.serve.main`; dbrx-132b at 4 of its 40
   layers through `init_serving` + `make_prefill_step` /
   `make_decode_step`; hubert-xlarge through `make_encode_step` on 4 ×
   2048 frame embeddings. Each: exactly `num_layers` flash launches per
   prefill or encode, all of them the bf16 wgmma kernel, and none in
   decode; finite logits; first and warm (median of 3) prefill seconds,
   decode tok/s and step ms, peak device memory; one warm prefill under
   torch.profiler. At each distinct flash shape the arch serves: kernel
   ms against its plain version (error within phase 7's bf16 tolerance),
   its bound (visible pairs only, so a window's masked work is not
   counted) and one SDPA call timed as a yardstick (with a window: an
   explicit mask and kv repeated to the q heads). Parity, as in phase
   8 but bf16 only: the prefill (encode) with the kernel against the
   same with the plain attention, and prefill(S) against prefill(S-1) +
   one decode step, both within twice the bf16 floor (plain bf16 vs
   plain fp32, same params); internlm2-20b and dbrx-132b on a 2-layer
   copy at full width, whose fp32 copy fits beside the bf16 one. For the
   MoE archs it also counts the tokens whose top-k experts differ
   between the kernel and the plain run and the assignments dropped
   past capacity; their prefill(S) vs prefill(S-1) + decode is held on
   a copy with capacity C = T (the served prefill drops, decode never
   does) and the served value is reported. granite-moe-1b-a400m's
   first MoE layer runs `moe_apply` at the served shape (B 4 x 2048,
   capacity 640, the served prefill's own input) on the card and on
   CPU copies, fp32 and bf16, on the card's routing: output within
   1e-5 (fp32) or twice the bf16 floor, aux within 1e-5, drops
   present; the router's probabilities against the CPU's, and a top-k
   that differs only at ties within their measured difference.
15. The SSM and hybrid LMs at their published width and depth (bf16,
   random weights from seed 0; B 4, 2048 prompt tokens, 8 generated)
   through `repro_torch.launch.serve.main`: xlstm-1.3b (48 layers,
   mLSTM:sLSTM 7:1, no attention: 0 flash launches) and zamba2-7b (81
   Mamba2 layers and 13 invocations of its two alternating shared
   attention blocks: 13 flash launches per prefill, one per group, all
   the bf16 wgmma kernel, 0 per decode step). First and warm prefill
   seconds, decode tok/s and step ms, peak memory, one warm prefill
   under torch.profiler. Parity as in phase 14 (kernel vs plain
   attention for zamba2-7b; prefill(S) vs prefill(S-1) + decode, which
   holds the decode recurrences and conv/sLSTM states against the
   chunked prefill; each within twice the bf16 floor; xlstm-1.3b's on
   one 8-layer group, mLSTM 7 : sLSTM 1), every prefill on freshly
   zeroed caches (a prefill starts each SSM block from its cache's
   state). The flash kernel at zamba2-7b's shape (B 4, 32/32,
   T 2048, D 112, causal): kernel, plain and SDPA ms, the bound, the
   error against the plain version.
16. LM training. (a) `repro_torch.launch.train.main` on llama3.2-1b at
   full width and depth (B 4 x 2048, 2 microbatches, remat, loss chunk
   512, lr 1e-3): 4 steps with `--ckpt`, then a second call with
   `--steps 5` that restores step 4 ("restored checkpoint at step 4")
   and takes step 5. Every step launches the bf16 flash forward
   16 layers x 2 microbatches x 2 (forward and the remat recompute) =
   64 times, and no GCN kernel; the loss falls from step 1 to step 4;
   step seconds (median after the first), peak memory, one step under
   torch.profiler. (b) One `make_train_step` of a 2-layer fp32 copy
   (full width, B 2 x 256) on the card against the CPU, same state and
   batch: loss and step metrics within 1e-4 relative, every gradient
   leaf within 1e-4·max(1, max|g_cpu|). Then in bf16 on the card, at
   (a)'s microbatch shape (2 layers, B 2 x 2048), the gradient through
   the kernel (forward by the kernel, backward by the VJP of
   `blocked_attention`) against autograd of the plain version, within
   twice the bf16 floor (plain bf16 vs plain fp32 gradients), with the
   forward's and the backward's launches counted apart (the backward
   launches only the remat recompute). (c) One step of every other
   arch at full width, B 2 x 512, at the largest depth whose params
   stay under TRAIN_CUT_PARAMS, at least one group; AdamW up to
   TRAIN_ADAM_PARAMS (dbrx-132b, at 1 of 40 layers, takes the gradient
   alone with no AdamW state); each cut printed: finite loss
   and gradient norm, flash launches as the arch implies.

17. The sharding layer. (a) `make_train_step` with a DeviceMesh: an NCCL
   world of 1 in this process, a 1 x 1 ("data", "model") mesh, FSDP on,
   every state leaf a DTensor (`dist.sharding.distribute_tree`), the
   flash kernel under `local_map` on the local shards. llama3.2-1b at
   full width (2048, 32/8 heads, vocab 128256), cut to 2 layers, B 2 x
   256: one step sharded and one unsharded from the same state and batch
   (AdamW without clipping, so the first moment is 0.1 x the gradient),
   in fp32 (loss, every gradient leaf and the new params within
   1e-4·max(1, max|g|)) and in bf16 (within twice the bf16 floor: the
   unsharded bf16 step against the unsharded fp32 one); the sharded
   step's flash launches counted from 0 (2 layers x forward and remat
   recompute). Then the bf16 step at 4 layers, B 2 x 2048, unsharded
   and sharded in turns (plain, sharded, sharded, plain): step ms, peak
   memory, and each sharded run's flash launches counted from 0 (4
   layers x 2 x the steps). (d) On the same world, `launch.serve.main`
   with phase 8's argv and `--mesh host`: DTensor params and caches,
   flash under `local_map`, the vocab-parallel argmax; 16 flash
   launches in prefill and none in decode (counted from 0), the prefill
   logits bit-equal to phase 8's (else within twice the bf16 floor) and
   the same greedy tokens (else equal in each row up to the first step
   whose top-2 gap in phase 8's run, replayed, is within twice that
   bound); prefill s and decode tok/s beside phase 8's.
   (b) `launch/train.py --mesh host` under `torchrun --nproc_per_node
   1` (NCCL, a (1, 1) mesh) for 2 steps and, at the same time,
   `launch/serve.py --mesh host` the same way (B 2 x 512, 8 tokens):
   rc 0 and rank 0's banner.
   (c) On the host's CPU (no card visible), started once (a) and (d)'s
   timed runs are done, beside (b): `launch/dryrun.py --shape train_4k
   --mesh pod` for llama3.2-1b and xlstm-1.3b (full depth) and
   `launch/dryrun_gcn.py --variant all`
   on a fake world of 256 ranks: per-device FLOPs, bytes, collective
   bytes, peak bytes and the roofline time at the H100 constants of
   `launch/mesh.py`; the GCN `base` variant within 2% of the reference's
   1-device step (1.5356e11 FLOP) with one gradient all-reduce, `tp`
   below it.
18. The paper's own graphs at their published size (block-ELL, fused,
   data.scale=1.0). Once the kernels are built, the script spawns one
   `chip_smoke.py --scale-prep <dir> <preset>` child per preset, each on
   one host core without the card: it generates `reddit` (58,000 nodes)
   or `amazon2m` (2,449,029 nodes), saves the graph's arrays, and
   partitions it (1,500 or 15,000 parts) into the partition cache of
   this run's dataset directory, beside phases 2-17. Phase 18 waits for
   each (SCALE_PREP_TIMEOUT_S; a failure or timeout fails the run),
   prints each graph's nodes and edges and the partition's seconds,
   within-cluster share and imbalance, and fails unless every
   build_partition of the phase reads that cache (`cached: True`). Its
   builds take the children's graphs (the same seeded graph, not
   generated again): passed to `build_experiment` and the serving
   engine, and, around the two CLIs, through `_prepared_graph`, which
   fails unless every graph the CLI builds was the child's.
   reddit: 2 epochs through `run_experiment.main` (75 steps an epoch,
   4 fused + 4 block-ELL launches a step, loss finite and falling, a
   checkpoint), the step split and one step card vs CPU under phase 4's
   bounds, then `serve_gcn.main --verify-parity` on the checkpoint
   (1,500 clusters x 4 propagations = 6,000 launches; precompute s,
   p50/p99, QPS) and the served logits against the host oracle within
   phase 6's bound, and both kernels at its widths. amazon2m: first
   VR-GCN (r 2, batch 512, AdamW 1e-2) one epoch on its graph while the
   child still partitions (epoch s, peak device memory, host history
   exactly 2 x N x 400 x 4 bytes); then 2 epochs through
   `run_experiment.main` (1,500 steps an epoch, 3 + 3 launches a step,
   the loss finite and falling, epoch s, peak device memory, the test
   accuracy of the host evaluation), the batcher's node_cap, the step
   split, one step card vs CPU, phase 4's eager-against-graphed steps
   (reddit too), the kernels at its widths, the Table 8
   comparison with the paper's figures beside, and serving's tiles for
   one median-size cluster against all column blocks at width 400 (K,
   tile bytes, host build, copy and kernel ms, held against the plain
   product) with that arithmetic for the whole graph. The kernels at
   the recipes' widths run on one real batch's nrb x K (fused 100 ->
   400, 400 -> 400, 400 -> 47, 128 -> 128, 128 -> 41; the SpMM backward
   at F 400, 47, 128, 41), fp32, against their plain versions under
   phase 2's tolerance and bitwise repeat, with the library yardstick.
Phase 7 also times the fp32 kernel at the llama3.2-1b prefill shape
(phase 8's fp32 prefill launches it) against its bound, its plain
version and fp32 SDPA. Each phase's wall seconds are printed
(`[phase] ...`), and the whole run's.

Every count is set to 0 just before its path runs and read just after.
The last three lines of stdout are the nvidia-smi line, a JSON line of
per-kernel numbers (`{"kernels": [...]}`), and `{"ok": true, "device":
{...}}`. Full per-case results also go to chiprun_out/chip_smoke.json.
Datasets, partitions, checkpoints and the serving cache live in a
temporary directory that is removed at the end, the prep child's
output and log with them.

    python3 chip_smoke.py --host-oracle amazon2m [scale]

is not part of that run: it times the host oracle's full-graph
evaluation with Â's products split over the host's cores and with one
scipy call each, and checks that both give the same logits bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 1e-5, "bfloat16": 8e-3}
PPI_SHAPE = dict(nrb=3, K=110, B=128, ncb=110, F=2048)
# the training step's shapes at ppi_sota: node_cap 384 → nrb = ncb = 3,
# K = cap/B = 3 slots, B 128; layer widths 50 → 2048 → ... → 121
TRAIN_BWD_SHAPE = dict(nrb=3, K=3, B=128, ncb=3, F=2048)
FUSED_TRAIN_SHAPES = ((50, 2048), (2048, 2048), (2048, 121))
FUSED_MAIN = (2048, 2048)
GCN_LIBS = ("block_ell_spmm", "block_ell_spmm_fused")
SERVE_TOL = 1e-4
STEP_TOL = 1e-4
TRAIN_SETS = ["batch.sparse_adj=true", "model.fuse_spmm=true"]
# the GraphSAINT runs of phase 10: the same model and kernels, i.i.d.
# subgraph batches (default budget: 280 node draws, 140 edge draws)
SAINT_SETS = TRAIN_SETS + ["batch.node_cap=384"]
# (sampler, epochs, extra sets): saint_edge's epoch is cut from a pass's
# 1,347 steps (E / budget) to 200, to keep the script inside its time limit
SAINT_RUNS = (("saint_node", 2, []),
              ("saint_edge", 1, ["batch.batches_per_epoch=200"]))
BASELINE_BATCH = 512
# phase 12: ppi_sota's recipe on the real-format PPI graph
REAL_SETS = TRAIN_SETS + ["data.name=ppi_real"]
# phase 13: the data-parallel runs
DP_COMPRESSIONS = (None, "bf16", 8, 4)
DP_STEPS = 20
DP_TIMEOUT_S = 300
# llama3.2-1b prefill: B 4, Hq 32 over Hkv 8, T 2048, head dim 64, bf16
FLASH_MAIN = dict(B=4, Hq=32, Hkv=8, Tq=2048, Tk=2048, D=64)
LM_ARGV = ["--arch", "llama3.2-1b", "--batch", "4", "--prompt-len", "2048",
           "--gen", "32", "--seed", "0"]
LM_TOL = 1e-2       # the reference's bound (tests/test_models.py)
LM_FP32_TOL = 1e-4  # fp32 logits: summation order over 16 layers
# phase 14: the reference's other attention-only LMs at their published
# widths, B 4 x 2048 prompt tokens (after paligemma's 256-patch prefix),
# 8 generated (cut from 32 for the script's time limit: the decode rate is
# read over 7 steps); dbrx-132b at 4 of its 40 layers (264 GB of bf16 weights
# do not fit one card); internlm2-20b and dbrx-132b hold parity on a
# 2-layer copy (their fp32 copy does not fit beside the bf16 one), and
# phase 15's xlstm-1.3b on one 8-layer group of its 48 (to keep the
# script inside its time limit)
ARCH_NAMES_14 = ("gemma3-1b", "granite-3-2b", "internlm2-20b",
                 "granite-moe-1b-a400m", "dbrx-132b", "hubert-xlarge",
                 "paligemma-3b")
ARCH_CLI = ("gemma3-1b", "granite-3-2b", "internlm2-20b",
            "granite-moe-1b-a400m", "paligemma-3b")
ARCH_BATCH, ARCH_PROMPT, ARCH_GEN = 4, 2048, 8
ARCH_DBRX_LAYERS = 4
ARCH_PARITY_LAYERS = {"internlm2-20b": 2, "dbrx-132b": 2,
                      "xlstm-1.3b": 8}
# the arch whose first MoE layer is held on the card against the CPU at
# the served shape (dbrx-132b's, 16 x 640 slots x 6144 x 10752 per row,
# is ~1.6e13 FLOP: minutes on the host's cores)
ARCH_MOE_CPU = "granite-moe-1b-a400m"
# phase 15: the SSM and hybrid LMs, served through the CLI at full depth
ARCH_SSM = ("xlstm-1.3b", "zamba2-7b")
# phase 16: LM training; (a) llama3.2-1b through the CLI, 4 steps and a
# resumed call to step 5 (cut from 6 and 8 for the script's time limit;
# the checkpoint's save and restore, ≈2 minutes, stay)
TRAIN_ARGV = ["--arch", "llama3.2-1b", "--batch", "4", "--seq", "2048",
              "--microbatches", "2", "--lr", "1e-3", "--seed", "0",
              "--log-every", "1"]
TRAIN_STEPS = (4, 5)
# (b) card vs CPU on a 2-layer fp32 copy at B 2 x 256; the bf16 kernel
# gradient vs the plain one on the card at (a)'s microbatch, B 2 x 2048
TRAIN_PARITY = dict(layers=2, batch=2, seq=256)
TRAIN_GRAD_BF16 = dict(batch=2, seq=2048, loss_chunk=512)
# (c) every other arch, B 2 x 512, cut to the depth whose params stay
# under TRAIN_CUT_PARAMS (0.9 B, to keep the script inside its time
# limit), at least one group. The functional AdamW holds the old and the
# new moments and params, the grads and the updates at once, ≈36 bytes a
# param at the update (llama3.2-1b's step peaks at 40.9 GiB), so 1.8 B
# params (≈60 GiB, TRAIN_ADAM_PARAMS) is what an AdamW step of the card
# holds: internlm2-20b and zamba2-7b, whose one group is above the cut,
# still take it. An arch whose one group is larger still (dbrx-132b:
# ≈4.5 B params with its embeddings) takes the gradient alone, without
# AdamW state (≈8 bytes a param)
TRAIN_OTHER = dict(batch=2, seq=512)
TRAIN_CUT_PARAMS = 0.9e9
TRAIN_ADAM_PARAMS = 1.8e9
# phase 17: the sharding layer. (a) llama3.2-1b at full width, its depth
# cut to 2 layers for the parity copies (fp32 and bf16 states and their
# updates, sharded and not, side by side) and to 4 for the timed bf16
# steps; (b) the CLI under torchrun; (c) the dry-runs on the host's CPU
SHARD_PARITY = dict(layers=2, batch=2, seq=256)
SHARD_TIMED = dict(layers=4, batch=2, seq=2048, steps=4)
SHARD_CLI = ["--arch", "llama3.2-1b", "--mesh", "host", "--steps", "2",
             "--batch", "2", "--seq", "512", "--log-every", "1",
             "--seed", "0"]
SHARD_TIMEOUT_S = 300
# (c)'s LM cells: llama3.2-1b and xlstm-1.3b train_4k at full depth
# (xlstm's traces in ≈90 s on a free host core: its sLSTM loop is one
# op per layer on local shards)
DRYRUN_LM = ("llama3.2-1b", "xlstm-1.3b")
DRYRUN_TIMEOUT_S = 600
# (d) the serving CLI on the mesh: phase 8's argv in process (compared
# with phase 8's run), and a shorter one under torchrun
SHARD_SERVE_CLI = ["--arch", "llama3.2-1b", "--mesh", "host", "--batch",
                   "2", "--prompt-len", "512", "--gen", "8", "--seed", "0"]
# phase 18: the paper's own graphs at their published size (reddit: 58,000
# nodes, 1,500 parts, q 20, 4 x 128; amazon2m: 2,449,029 nodes, 15,000
# parts, q 10, 3 x 400), block-ELL and fused. A child process per preset
# (`--scale-prep`) generates and partitions it into the partition cache
# while phases 2-17 run; every phase-18 build reads that cache
SCALE_SETS = TRAIN_SETS + ["data.scale=1.0"]
SCALE_PRESETS = ("reddit", "amazon2m")
SCALE_PREP_TIMEOUT_S = 900
# the kernels at the recipes' widths, on one real batch's nrb x K
SCALE_FUSED = {"amazon2m": ((100, 400), (400, 400), (400, 47)),
               "reddit": ((128, 128), (128, 41))}
SCALE_BWD = {"amazon2m": (400, 47), "reddit": (128, 41)}
# one Amazon2M serving cluster's tiles at layer 1's width
SCALE_SERVE_WIDTH = 400
# the paper's Table 8 on Amazon2M (3 x 400): whole trainings on its own
# hardware, seconds and GB — context beside this run's epochs, not a target
PAPER_TABLE8 = {"cluster_gcn": (1523, 2.2), "vrgcn": (1961, 11.2)}
# what phase 8's one-device serving returned (tensors; not in the JSON)
_PHASE8: dict = {}
# the reference's own 1-device Cluster-GCN step at the PPI-SOTA shape:
# `analyze_hlo` of `repro.launch.dryrun_gcn.build("base")` on a 1 x 1
# mesh (jax 0.9, CPU); the port's per-device count on 16 x 16 matches it
GCN_REF_FLOPS = 1.5356e11


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _sass_count(lib: pathlib.Path, *opcodes: str) -> int:
    """Instructions with any of these opcodes in a built library's SASS."""
    from repro_torch.kernels import _build
    cuobjdump = pathlib.Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return sum(any(op in line for op in opcodes)
               for line in sass.splitlines())


def _ptxas_entries(log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) per
    entry function, from nvcc's `-Xptxas -v` report."""
    out, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spill))
            name, spill = None, (0, 0)
    return out


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _reset_peak_memory() -> int:
    """Start a peak-memory window; returns the bytes allocated at its
    start (tensors earlier phases still hold)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_memory(start: int) -> dict:
    import torch
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return dict(peak_gib=peak / 2 ** 30,
                above_start_gib=(peak - start) / 2 ** 30)


def _case_inputs(nrb, K, B, ncb, F, dtype, row_k_mode, seed):
    """Block-ELL operands in the format the host builders emit: slots
    past each row's live count hold zero tiles pointing at column-block
    0. row_k_mode: None (row_k not passed), "given" (random live counts,
    row-block 0 empty), "full" (row_k passed, every slot live — what a
    training batch at ppi_sota carries)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    blocks = torch.randn(nrb, K, B, B, generator=g)
    cols = torch.randint(0, ncb, (nrb, K), generator=g, dtype=torch.int32)
    x = torch.randn(ncb * B, F, generator=g)
    row_k = None
    if row_k_mode == "given":
        live = torch.randint(0, K + 1, (nrb,), generator=g,
                             dtype=torch.int32)
        live[0] = 0                      # an empty row-block
        for i in range(nrb):
            blocks[i, int(live[i]):] = 0
            cols[i, int(live[i]):] = 0
        row_k = live.cuda()
    elif row_k_mode == "full":
        row_k = torch.full((nrb,), K, dtype=torch.int32).cuda()
    return (blocks.to(dtype).cuda(), cols.cuda(), x.to(dtype).cuda(),
            row_k)


def _bound(flops: float, tensors, dtype) -> tuple:
    """(ms, what bounds it): the least time on the card for this call,
    the larger of the bytes (each input read once, each output written
    once) over the peak memory rate and the FLOPs the function needs
    over the dtype's peak rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    peak = PEAK_FLOPS[str(dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _live_slots(blocks, row_k) -> int:
    nrb, K = blocks.shape[:2]
    return int(row_k.clamp(0, K).sum()) if row_k is not None else nrb * K


def _check_case(name, row, err, scale, dname):
    # the GCN rows also hold the kernel to itself on a repeated call
    ok = err <= TOL[dname] * scale and row.get("bitwise_repeat", True)
    row.update(max_abs_err=err, max_abs_ref=scale, tol=TOL[dname] * scale,
               ok=ok)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version, or "
                             f"with itself on a repeated call: {row}")


def _spmm_case(results: dict, seed: int, nrb, K, B, ncb, F, dtype, mode,
               library: bool) -> dict:
    """One block-ELL SpMM case against its plain version (and itself on a
    repeated call); `library` also times the library yardstick and the
    device times. Appends its row to results["kernel_cases"]."""
    import torch
    from repro_torch.kernels import block_spmm
    from repro_torch.kernels.ref import spmm_block_ell_ref

    blocks, cols, x, row_k = _case_inputs(nrb, K, B, ncb, F, dtype, mode,
                                          seed=seed)
    y = block_spmm.spmm_block_ell(blocks, cols, x, row_k=row_k)
    again = block_spmm.spmm_block_ell(blocks, cols, x, row_k=row_k)
    torch.cuda.synchronize()
    ref = spmm_block_ell_ref(blocks, cols, x)
    err = float((y.float() - ref.float()).abs().max()) if y.numel() \
        else 0.0
    scale = max(1.0, float(ref.float().abs().max())) if y.numel() \
        else 1.0
    dname = str(dtype).replace("torch.", "")
    reps = 10 if library else 5
    ms = (_time_ms(lambda: block_spmm._launch(blocks, cols, x, row_k),
                   reps) if K else None)  # K = 0 launches nothing
    plain_ms = _time_ms(lambda: spmm_block_ell_ref(blocks, cols, x), reps)
    row = dict(nrb=nrb, K=K, B=B, ncb=ncb, F=F, dtype=dname,
               row_k=mode, ms=ms, plain_ms=plain_ms,
               bitwise_repeat=bool(torch.equal(y, again)))
    if K:
        row["plan"] = dataclasses.asdict(block_spmm.spmm_plan(
            nrb, K, B, F, dtype, (blocks.data_ptr(), x.data_ptr()),
            block_spmm._sms(x.device)))
    flops = 2.0 * _live_slots(blocks, row_k) * B * B * F
    row["bound_ms"], row["bound_by"] = _bound(
        flops, (blocks, cols, x, y, row_k), dtype)
    if library:
        gathered = x.reshape(-1, B, F)[cols.long()].reshape(nrb, K * B, F)
        a = blocks.permute(0, 2, 1, 3).reshape(nrb, B, K * B)
        row["library_ms"] = _time_ms(lambda: torch.bmm(a, gathered), reps)
        row["device_ms"] = _device_ms(
            lambda: block_spmm._launch(blocks, cols, x, row_k))
        row["library_device_ms"] = _device_ms(lambda: torch.bmm(a, gathered))
        del gathered, a
    _check_case("block_ell_spmm", row, err, scale, dname)
    results["kernel_cases"].append(row)
    print(f"[kernels] spmm B={B:>3} F={F:>4} nrb={nrb} K={K:>3} "
          f"{dname:>8} row_k={mode or 'None':>5}  max|Δ|={err:.3e} "
          f"(tol {TOL[dname] * scale:.3e})  "
          f"kernel {'-' if ms is None else f'{ms:.4f}'} ms  "
          f"plain {plain_ms:.4f} ms  bound {row['bound_ms']:.4f} ms"
          + (f"  bmm {row['library_ms']:.4f} ms"
             if "library_ms" in row else ""))
    return row


def phase_kernels(results: dict) -> dict:
    """The block-ELL SpMM against its plain version; returns the rows of
    the serving cluster shape (fp32) and the training backward shape."""
    import torch

    cases = []
    for B in (8, 16, 128):
        nrb, K, ncb = (3, 8, 16) if B == 128 else (5, 6, 9)
        for F in (1, 121, 2048):
            for dtype in (torch.float32, torch.bfloat16):
                for mode in (None, "given"):
                    cases.append((nrb, K, B, ncb, F, dtype, mode))
        cases.append((4, 0, B, 3, 121, torch.float32, None))     # K = 0
    p, t = PPI_SHAPE, TRAIN_BWD_SHAPE
    for dtype, mode in ((torch.float32, None), (torch.bfloat16, None),
                        (torch.float32, "given")):
        cases.append((p["nrb"], p["K"], p["B"], p["ncb"], p["F"], dtype,
                      mode))
    for F in (2048, 121):                # the backward's g̃ = Âᵀḡ widths
        cases.append((t["nrb"], t["K"], t["B"], t["ncb"], F,
                      torch.float32, "full"))
    main = {}
    for n, (nrb, K, B, ncb, F, dtype, mode) in enumerate(cases):
        is_ppi = (nrb, K, B, ncb, F) == tuple(p.values())
        is_bwd = mode == "full"
        row = _spmm_case(results, n, nrb, K, B, ncb, F, dtype, mode,
                         library=is_ppi or is_bwd)
        if is_ppi and dtype == torch.float32 and mode is None:
            main["serve"] = row          # the shape and call serving makes
        if is_bwd and F == 2048:
            main["train_bwd"] = row      # the hidden layers' backward
    for tag, row in (("serving", main["serve"]),
                     ("training backward", main["train_bwd"])):
        _print_vs_library(f"spmm at the {tag} shape", row, "bmm")
    return main


def _device_ms(fn, reps: int = 10):
    """Device time of one call of fn: the sum of its kernels' times under
    torch.profiler, per call, or None when the trace holds none. Unlike
    `_time_ms` it leaves out the host's launch overhead, which sets the
    pace of a call that is shorter on the card than on the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # CPU activity too, as in `_profile`: traces of CUDA activity alone
    # have come back without the kernels of a few of these short calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_events_ms(prof).values())
    return total / reps if total else None


def _print_vs_library(what: str, row: dict, library: str) -> None:
    """A main row's factor against its library call and its share of the
    bound (both from this run's times), in wall time per call and in
    device time."""
    row["vs_library"] = row["ms"] / row["library_ms"]
    row["bound_share"] = row["bound_ms"] / row["ms"]
    dev, lib = row["device_ms"], row["library_device_ms"]
    row["device_vs_library"] = dev / lib if dev and lib else None
    device = (f"device time {dev:.4f} ms = {row['device_vs_library']:.2f} x "
              f"{library}'s ({lib:.4f} ms)" if row["device_vs_library"]
              else "device time not measured (no kernel in the trace)")
    plan = row.get("plan") or row.get("plans")
    print(f"[kernels] {what}: kernel {row['ms']:.4f} ms = "
          f"{row['vs_library']:.2f} x {library} ({row['library_ms']:.4f} ms); "
          f"{100 * row['bound_share']:.1f}% of the {row['bound_ms']:.4f} ms "
          f"bound; {device}; plan {plan}")


def _fused_inputs(nrb, K, B, ncb, D, F, dtype, mode, seed):
    import torch
    blocks, cols, _, row_k = _case_inputs(nrb, K, B, ncb, 1, dtype, mode,
                                          seed)
    g = torch.Generator().manual_seed(seed + 7)
    x = torch.randn(ncb * B, D, generator=g).to(dtype).cuda()
    w = (torch.randn(D, F, generator=g) / max(1, D) ** 0.5).to(dtype).cuda()
    b = torch.randn(F, generator=g).cuda()
    return blocks, cols, x, w, b, row_k


def _fused_case(results: dict, seed: int, nrb, K, B, ncb, D, F, dtype,
                mode, library: bool) -> dict:
    """One fused Â·(XW + b) case against its plain version (and itself on
    a repeated call); `library` also times the library yardstick and the
    device times. Appends its row to results["fused_cases"]."""
    import torch
    from repro_torch.kernels import block_spmm
    from repro_torch.kernels.ref import spmm_fused_ref

    blocks, cols, x, w, b, row_k = _fused_inputs(nrb, K, B, ncb, D, F,
                                                 dtype, mode, seed=seed)
    y = block_spmm.spmm_fused_block_ell(blocks, cols, x, w, b, row_k=row_k)
    again = block_spmm.spmm_fused_block_ell(blocks, cols, x, w, b,
                                            row_k=row_k)
    torch.cuda.synchronize()
    ref = spmm_fused_ref(blocks, cols, x, w, b)
    err = float((y.float() - ref.float()).abs().max()) if y.numel() \
        else 0.0
    scale = max(1.0, float(ref.float().abs().max())) if y.numel() \
        else 1.0
    dname = str(dtype).replace("torch.", "")
    reps = 10 if mode == "full" else 3
    ms = (_time_ms(lambda: block_spmm._launch_fused(blocks, cols, x, w, b,
                                                    row_k), reps)
          if K else None)
    plain_ms = _time_ms(lambda: spmm_fused_ref(blocks, cols, x, w, b), reps)
    live = _live_slots(blocks, row_k)
    # the function: XW over every row of x once, then the live tiles;
    # the kernel computes each row of XW once too, so it does the same
    fn_flops = 2.0 * x.shape[0] * D * F + 2.0 * live * B * B * F
    row = dict(nrb=nrb, K=K, B=B, ncb=ncb, D=D, F=F, dtype=dname,
               row_k=mode, ms=ms, plain_ms=plain_ms,
               function_flops=fn_flops, kernel_flops=fn_flops,
               bitwise_repeat=bool(torch.equal(y, again)))
    if K:
        sms = block_spmm._sms(x.device)
        row["plans"] = dict(
            xw=dataclasses.asdict(block_spmm.xw_plan(
                x.shape[0], D, F, dtype, (x.data_ptr(), w.data_ptr()), sms)),
            spmm=dataclasses.asdict(block_spmm.spmm_plan(
                nrb, K, B, F, dtype, (blocks.data_ptr(), 0), sms)))
    row["bound_ms"], row["bound_by"] = _bound(
        fn_flops, (blocks, cols, x, w, b, y, row_k), dtype)
    if library:
        def lib():
            xw = torch.addmm(b.to(x.dtype), x, w)
            gathered = xw.reshape(-1, B, F)[cols.long()].reshape(
                nrb, K * B, F)
            return torch.bmm(
                blocks.permute(0, 2, 1, 3).reshape(nrb, B, K * B), gathered)
        row["library_ms"] = _time_ms(lib, reps)
        row["device_ms"] = _device_ms(lambda: block_spmm._launch_fused(
            blocks, cols, x, w, b, row_k))
        row["library_device_ms"] = _device_ms(lib)
    _check_case("block_ell_spmm_fused", row, err, scale, dname)
    results["fused_cases"].append(row)
    print(f"[fused] B={B:>3} D={D:>4} F={F:>4} nrb={nrb} K={K} "
          f"{dname:>8} row_k={mode or 'None':>5}  max|Δ|={err:.3e} "
          f"(tol {TOL[dname] * scale:.3e})  "
          f"kernel {'-' if ms is None else f'{ms:.4f}'} ms  "
          f"plain {plain_ms:.4f} ms  bound {row['bound_ms']:.4f} ms"
          + (f"  addmm+bmm {row['library_ms']:.4f} ms"
             if "library_ms" in row else ""))
    return row


def phase_fused(results: dict) -> dict:
    """The fused Â·(XW + b) kernel against its plain version; returns the
    row of the ppi_sota hidden layer (2048 → 2048, fp32)."""
    import torch

    cases = []
    for B in (8, 16, 128):
        nrb, K, ncb = (3, 4, 6) if B == 128 else (5, 6, 9)
        for D in (1, 121, 2048):
            for F in (1, 121, 2048):
                for dtype in (torch.float32, torch.bfloat16):
                    for mode in (None, "given"):
                        cases.append((nrb, K, B, ncb, D, F, dtype, mode))
        cases.append((4, 0, B, 3, 121, 121, torch.float32, None))  # K = 0
    t = TRAIN_BWD_SHAPE
    for D, F in FUSED_TRAIN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((t["nrb"], t["K"], t["B"], t["ncb"], D, F, dtype,
                          "full"))
    train_rows = {}
    for n, (nrb, K, B, ncb, D, F, dtype, mode) in enumerate(cases):
        is_train = mode == "full" and dtype == torch.float32
        row = _fused_case(results, n, nrb, K, B, ncb, D, F, dtype, mode,
                          library=is_train)
        if is_train:
            train_rows[(D, F)] = row
    for (D, F), row in train_rows.items():
        _print_vs_library(f"fused {D} -> {F}", row, "addmm+bmm")
    return train_rows[FUSED_MAIN]


# (row blocks of 128, real rows, nonzeros drawn): the training batches
# of ppi_sota (cap 1536) and reddit (cap 3456)
SCATTER_SHAPES = {"ppi": (12, 1140, 27_540), "reddit": (27, 3104, 15_200)}
ADJ_FIELDS = ("blocks", "block_cols", "blocks_t", "block_cols_t", "row_k",
              "row_k_t")


def _batch_coords(nrb: int, n: int, nnz: int, seed: int):
    """A batch-shaped adjacency at K = nrb (k_slots "cap"): its compact
    form and the BlockEllAdj the host builds from the same CSR."""
    import numpy as np
    from repro_torch.kernels.ops import (block_ell_adj_from_csr,
                                         block_ell_coords_from_csr)
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n, nnz).astype(np.int64) * n
                    + rng.integers(0, n, nnz))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(key // n, minlength=n), out=indptr[1:])
    indices = (key % n).astype(np.int32)
    data = (rng.random(len(key)) + 0.01).astype(np.float32)
    cap = nrb * 128
    kw = dict(n_cols=cap, block=128, n_rows=cap, k_slots=nrb, k_slots_t=nrb)
    return (block_ell_coords_from_csr(indptr, indices, data, **kw),
            block_ell_adj_from_csr(indptr, indices, data,
                                   assume_unique=True, **kw))


def _host_ms(fn, reps: int) -> float:
    """Median wall ms of fn() with the device drained after each call."""
    import numpy as np
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _scatter_case(results: dict, name: str, seed: int) -> dict:
    """`BlockEllCoords.to("cuda")` at one batch shape: one launch, the
    host's tiles bit for bit; the kernel (zero fill and launch) timed
    against its plain version, its bound and torch's indexed
    assignment, and the packed buffer's copy against the host tiles'.
    Appends its row to results["scatter_cases"]."""
    import torch
    from repro_torch.kernels import block_spmm

    nrb, n, nnz = SCATTER_SHAPES[name]
    coords, want = _batch_coords(nrb, n, nnz, seed)
    before = block_spmm.LAUNCHES_SCATTER
    got = coords.to("cuda")
    torch.cuda.synchronize()
    launched = block_spmm.LAUNCHES_SCATTER - before
    equal = {f: bool(torch.equal(getattr(got, f).cpu(), getattr(want, f)))
             for f in ADJ_FIELDS}
    err = max(float((getattr(got, f).cpu() - getattr(want, f)).abs().max())
              for f in ("blocks", "blocks_t"))
    dev = coords.sections(coords.packed.cuda())
    host = coords.sections()
    v, off, off_t = dev["values"], dev["offsets"], dev["offsets_t"]
    nt, nt_t = got.blocks.numel(), got.blocks_t.numel()

    def kernel():
        return block_spmm.scatter_tiles(v, off, off_t, nt, nt_t)
    off_l, off_tl = off.long(), off_t.long() + nt

    def library():
        both = torch.zeros(nt + nt_t, dtype=torch.float32, device="cuda")
        both[off_l] = v
        both[off_tl] = v
        return both
    ms = _time_ms(kernel, 20)
    # the zero fill writes both arrays; each nonzero reads its value and
    # two offsets and writes two words
    nbytes = 4 * (nt + nt_t) + 20 * coords.nnz
    tile_bytes = 4 * (nt + nt_t)
    row = dict(
        case=name, nrb=nrb, K=int(got.blocks.shape[1]), B=128,
        nnz=coords.nnz, launches=launched, fields_equal=equal,
        bitwise=all(equal.values()), max_abs_err=err, ms=ms,
        plain_ms=_host_ms(lambda: block_spmm.scatter_tiles(
            host["values"], host["offsets"], host["offsets_t"], nt, nt_t),
            5),
        bound_ms=nbytes / PEAK_BYTES_S * 1e3, bound_by="bytes",
        library_ms=_time_ms(library, 20),
        device_ms=_device_ms(kernel), library_device_ms=_device_ms(library),
        packed_bytes=coords.packed.numel() * 4, tile_bytes=tile_bytes,
        packed_copy_ms=_host_ms(lambda: coords.packed.to("cuda"), 5),
        tiles_copy_ms=_host_ms(lambda: (want.blocks.to("cuda"),
                                        want.blocks_t.to("cuda")), 5))
    row["bound_share"] = row["bound_ms"] / ms
    results["scatter_cases"].append(row)
    print(f"[scatter] {name}: nrb {nrb} K {row['K']} nnz {coords.nnz}  "
          f"bitwise {row['bitwise']}  launches {launched}  kernel "
          f"{ms:.4f} ms (device {row['device_ms']})  plain {row['plain_ms']:.4f}"
          f" ms  bound {row['bound_ms']:.4f} ms  indexed assignment "
          f"{row['library_ms']:.4f} ms; copy {row['packed_bytes']} B "
          f"{row['packed_copy_ms']:.4f} ms against the host tiles' "
          f"{tile_bytes} B {row['tiles_copy_ms']:.4f} ms")
    if not row["bitwise"] or launched != 1:
        raise AssertionError(f"block_ell_scatter: not the host's tiles bit "
                             f"for bit, or not one launch: {row}")
    return row


def phase_scatter(results: dict) -> dict:
    """The block-ELL scatter at a ppi_sota and a reddit batch's shape;
    returns both rows by name."""
    results["scatter_cases"] = []
    return {name: _scatter_case(results, name, seed=n)
            for n, name in enumerate(SCATTER_SHAPES)}


def _train_argv(work: pathlib.Path, name: str, sets,
                preset: str = "ppi_sota") -> list:
    argv = ["--preset", preset, "--results-dir", str(work / name)]
    for s in sets:
        argv += ["--set", s]
    return argv


def phase_train(results: dict, work: pathlib.Path, preset: str = "ppi_sota",
                sets=TRAIN_SETS, key: str = "train", tag: str = "train",
                graph=None) -> dict:
    """Train `preset` 2 epochs through the CLI — the main path: one fused
    and one block-ELL launch per layer and step, a finite loss that falls
    from epoch 1 to 2. A `graph` given is the CLI's (`_prepared_graph`)."""
    from repro_torch.kernels import block_spmm
    from repro_torch.launch import run_experiment
    from repro_torch.launch.run_experiment import load_spec

    spec = load_spec(_spec_args(sets, preset))
    per_epoch = -(-spec.partition.num_parts // spec.batch.clusters_per_batch)
    layers = spec.model.num_layers
    ck = work / f"{key}_ck"
    argv = _train_argv(work, key, sets + [
        "run.epochs=2", "run.eval_every=2", f"run.checkpoint_dir={ck}"],
        preset)
    print(f"[{tag}] run_experiment {' '.join(argv)}")
    mem0 = _reset_peak_memory()
    t0 = time.perf_counter()
    # --- the main path: every launch count starts at 0 here -------------
    block_spmm.LAUNCHES = 0
    block_spmm.LAUNCHES_FUSED = 0
    block_spmm.LAUNCHES_SCATTER = 0
    with _prepared_graph(spec, graph):
        rc = run_experiment.main(argv)
    launches = {"block_ell_spmm": block_spmm.LAUNCHES,
                "block_ell_spmm_fused": block_spmm.LAUNCHES_FUSED,
                "block_ell_scatter": block_spmm.LAUNCHES_SCATTER}
    # ---------------------------------------------------------------------
    wall = time.perf_counter() - t0
    memory = _peak_memory(mem0)
    if rc != 0:
        raise AssertionError(f"run_experiment returned {rc}")
    metrics = json.loads((work / key / spec.name / "metrics.json")
                         .read_text())
    steps = metrics["global_step"]
    losses = [h["loss"] for h in metrics["history"]]
    print(f"[{tag}] {steps} steps in {wall:.2f} s (incl. data, partition, "
          f"eval); epoch losses {losses}; final "
          f"{metrics['final']['split']} micro-F1 "
          f"{metrics['final']['score']:.4f}")
    print(f"[{tag}] launches: fused {launches['block_ell_spmm_fused']}, "
          f"block_ell_spmm {launches['block_ell_spmm']} (expected {layers} "
          f"x {steps} each), block_ell_scatter "
          f"{launches['block_ell_scatter']} (expected {steps})")
    results[key] = dict(steps=steps, wall_s=wall, launches=launches,
                        history=metrics["history"],
                        epoch_s=_epoch_seconds(metrics["history"]),
                        final=metrics["final"],
                        seconds=metrics["seconds"], **memory)
    print(f"[{tag}] peak device memory {memory['peak_gib']:.3f} GiB "
          f"({memory['above_start_gib']:.3f} GiB above the start)")
    if steps != 2 * per_epoch \
            or launches["block_ell_spmm_fused"] != layers * steps \
            or launches["block_ell_spmm"] != layers * steps \
            or launches["block_ell_scatter"] != steps:
        raise AssertionError(f"expected {2 * per_epoch} steps with "
                             f"{layers} launches of each product kernel "
                             f"and one scatter per step: {steps} steps, "
                             f"{launches}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[1] < losses[0]:
        raise AssertionError(f"loss not finite or not falling: {losses}")
    return dict(launches=launches, checkpoint=ck)


def _spec_args(sets, preset: str = "ppi_sota"):
    """`preset` with `--set` overrides, as the CLIs parse them."""
    import argparse
    return argparse.Namespace(preset=preset, spec=None, set=list(sets))


def _step_parts(spec_sets, preset: str = "ppi_sota", graph=None):
    from repro_torch.core.experiment import build_experiment
    from repro_torch.launch.run_experiment import load_spec
    return build_experiment(load_spec(_spec_args(spec_sets, preset)),
                            graph=graph, device="cuda")


def _occupancy(batches) -> dict:
    """Tile occupancy of block-ELL batches: live K slots per row-block
    (row_k, forward; row_k_t, transposed) against the K they are padded
    to, and the nonzero share of the live tiles."""
    import numpy as np
    rk, rkt, fill = [], [], []
    for b in batches:
        adj = b.adj.to("cpu")          # the tiles the compact payload makes
        B = adj.blocks.shape[-1]
        live = adj.row_k.numpy()
        rk.append(float(live.mean()))
        rkt.append(float(adj.row_k_t.numpy().mean()))
        fill.append(float((adj.blocks != 0).sum()) / max(1, live.sum() * B * B))
    nrb, K = adj.blocks.shape[:2]
    return dict(batches=len(rk), nrb=int(nrb), K=int(K),
                mean_live_k=float(np.mean(rk)),
                mean_live_k_t=float(np.mean(rkt)),
                live_tile_fill=float(np.mean(fill)))


def phase_step_profile(results: dict, exp, key="train_step",
                       tag="step") -> None:
    """Where a training step's time goes: host batch build, the
    payload's copy to the device, and the step (medians over an epoch's
    first 20 steps, each part synchronised), the tile occupancy of those
    20 batches, and one step under torch.profiler, on the built
    experiment `exp` (`_step_parts`)."""
    import numpy as np
    import torch
    from repro_torch.core.batching import batch_to_device

    backend, engine = exp.engine.backend, exp.engine
    state = engine.init_state()
    build, copy, step, hosts = [], [], [], []
    it = iter(exp.batcher.epoch(0))
    for _ in range(20):
        t0 = time.perf_counter()
        batch = next(it)
        payload = batch.astuple()
        build.append(time.perf_counter() - t0)
        hosts.append(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload = batch_to_device(payload, "cuda")
        torch.cuda.synchronize()
        copy.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        state, loss, _ = backend.step(state, payload)
        torch.cuda.synchronize()
        step.append(time.perf_counter() - t0)
    occ = _occupancy(hosts)
    payload = batch_to_device(next(it).astuple(), "cuda")
    prof = _profile(lambda: backend.step(state, payload), top_n=8)
    results[key] = dict(
        host_build_ms=float(np.median(build)) * 1e3,
        copy_ms=float(np.median(copy)) * 1e3,
        step_ms=float(np.median(step)) * 1e3, occupancy=occ,
        profiled_step=prof)
    print(f"[{tag}] host batch build {np.median(build) * 1e3:.3f} ms, "
          f"copy to device {np.median(copy) * 1e3:.3f} ms, step "
          f"{np.median(step) * 1e3:.3f} ms (medians of 20, synchronised)")
    print(f"[{tag}] tile occupancy of those 20 batches: "
          f"{occ['mean_live_k']:.3f} live of K {occ['K']} slots per "
          f"row-block (transposed {occ['mean_live_k_t']:.3f}), nrb "
          f"{occ['nrb']}, live tiles {100 * occ['live_tile_fill']:.2f}% "
          f"nonzero")
    _print_profile(f"{tag}: one step profiled", prof)


def phase_step_parity(results: dict, exp, key="step_parity",
                      tag="parity") -> None:
    """One gcn_loss + backward, same params and batch (dropout 0), on the
    GPU (kernels) and on the CPU (plain versions): one launch of each
    kernel per layer on the GPU, none on the CPU; `exp` as in
    `phase_step_profile`."""
    import dataclasses
    import torch
    from repro_torch.core.batching import batch_to_device
    from repro_torch.core.gcn import gcn_loss, init_params
    from repro_torch.kernels import block_spmm
    from repro_torch.nn.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(exp.cfg, dropout=0.0)
    params = init_params(cfg, generator=torch.Generator().manual_seed(3),
                         device="cpu")
    host = next(iter(exp.batcher.epoch(0))).astuple()
    out = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev).requires_grad_(True), params)
        before = (block_spmm.LAUNCHES, block_spmm.LAUNCHES_FUSED)
        loss, _ = gcn_loss(p, batch_to_device(host, dev), cfg, train=True)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        if dev == "cuda":
            torch.cuda.synchronize()
        launched = (block_spmm.LAUNCHES - before[0],
                    block_spmm.LAUNCHES_FUSED - before[1])
        out[dev] = (float(loss.detach()),
                    [g.detach().float().cpu() for g in grads],
                    launched)
    loss_err = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    worst = 0.0
    for gg, gc in zip(out["cuda"][1], out["cpu"][1]):
        bound = STEP_TOL * max(1.0, float(gc.abs().max()))
        err = float((gg - gc).abs().max())
        worst = max(worst, err / bound)
    loss_mask = host[4]
    results[key] = dict(loss_gpu=out["cuda"][0], loss_cpu=out["cpu"][0],
                        loss_rel_err=loss_err,
                        worst_grad_err_over_bound=worst,
                        launches_gpu=out["cuda"][2],
                        launches_cpu=out["cpu"][2],
                        loss_weights_fractional=bool(
                            ((loss_mask != 0) & (loss_mask != 1)).any()))
    print(f"[{tag}] one step GPU vs CPU: loss {out['cuda'][0]:.6f} vs "
          f"{out['cpu'][0]:.6f} (rel {loss_err:.3e}, bound {STEP_TOL}); "
          f"worst grad err / bound {worst:.3f}; launches GPU "
          f"{out['cuda'][2]}, CPU {out['cpu'][2]}")
    layers = cfg.num_layers
    if not loss_err <= STEP_TOL or not worst <= 1.0 \
            or out["cuda"][2] != (layers, layers) \
            or out["cpu"][2] != (0, 0):
        raise AssertionError(f"GPU step disagrees with the CPU step: "
                             f"{results[key]}")


def phase_step_graph(results: dict, exp, key="step_graph",
                     tag="step graph", steps: int = 20) -> None:
    """`steps` steps of `exp`'s recipe from one seed on the same payloads
    (already on the card), eager (the `make_train_step` body launched op
    by op) and through the backend (replayed as a CUDA graph from its
    second step): the median host time a step and nodes/s over steps 3
    on, and every loss, aux and state leaf bitwise equal."""
    import numpy as np
    import torch
    from repro_torch.core.batching import batch_to_device
    from repro_torch.core.engine import make_train_step
    from repro_torch.core.precision import policy_from_config
    from repro_torch.nn.tree import tree_leaves

    batches = []
    epoch = 0
    while len(batches) < steps:
        batches += list(itertools.islice(exp.batcher.epoch(epoch),
                                         steps - len(batches)))
        epoch += 1
    nodes = sum(int(b.num_real) for b in batches[2:])
    payloads = [batch_to_device(b.astuple(), "cuda") for b in batches]
    body = make_train_step(exp.cfg, exp.opt)
    keys = ["params", "opt", "rng"] + (
        ["scale"] if policy_from_config(exp.cfg).scaled else [])

    def eager(state, payload):
        *new, loss, aux = body(*(state[k] for k in keys), payload)
        return dict(zip(keys, new)), loss, aux

    runs = {}
    for name, step in (("eager", eager), ("graphed", exp.engine.backend.step)):
        state = exp.engine.init_state()
        outs, host = [], []
        for i, payload in enumerate(payloads):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            t = time.perf_counter()
            state, loss, aux = step(state, payload)
            host.append(time.perf_counter() - t)
            outs.append((loss, aux))
        torch.cuda.synchronize()
        runs[name] = dict(state=state, outs=outs,
                          host_ms=float(np.median(host[2:])) * 1e3,
                          nodes_per_s=nodes / (time.perf_counter() - t0))
    e, g = runs["eager"], runs["graphed"]
    same_out = all(torch.equal(a[0], b[0]) and all(
        torch.equal(a[1][k], b[1][k]) for k in a[1])
        for a, b in zip(e["outs"], g["outs"]))
    leaves = [(a, b) for a, b in zip(tree_leaves(e["state"]),
                                     tree_leaves(g["state"]))
              if torch.is_tensor(a)]
    same_state = all(torch.equal(a, b) for a, b in leaves)
    results[key] = dict(steps=steps, leaves=len(leaves),
                        losses_bitwise=same_out, state_bitwise=same_state,
                        **{f"{n}_{k}": runs[n][k] for n in runs
                           for k in ("host_ms", "nodes_per_s")})
    print(f"[{tag}] {steps} steps from one seed: host a step eager "
          f"{e['host_ms']:.3f} ms, graphed {g['host_ms']:.3f} ms; nodes/s "
          f"eager {e['nodes_per_s']:.0f}, graphed {g['nodes_per_s']:.0f} "
          f"(steps 3-{steps}, payloads on the card); losses and aux "
          f"bitwise {same_out}, {len(leaves)} state leaves bitwise "
          f"{same_state}")
    if not (same_out and same_state):
        raise AssertionError(f"the graphed step differs from the eager "
                             f"one: {results[key]}")


def phase_unfused(results: dict, work: pathlib.Path) -> None:
    """One epoch with model.fuse_spmm=false: matmul, then the block-ELL
    SpMM forward and backward."""
    from repro_torch.kernels import block_spmm
    from repro_torch.launch import run_experiment

    argv = _train_argv(work, "unfused", ["batch.sparse_adj=true",
                                         "model.fuse_spmm=false",
                                         "run.epochs=1", "run.eval_every=0"])
    block_spmm.LAUNCHES = 0
    block_spmm.LAUNCHES_FUSED = 0
    rc = run_experiment.main(argv)
    launches = (block_spmm.LAUNCHES, block_spmm.LAUNCHES_FUSED)
    metrics = json.loads((work / "unfused" / "ppi_sota" / "metrics.json")
                         .read_text())
    steps = metrics["global_step"]
    results["unfused"] = dict(steps=steps, launches=launches,
                              history=metrics["history"])
    print(f"[unfused] {steps} steps, loss {metrics['history'][0]['loss']:.4f}"
          f", launches block_ell_spmm {launches[0]}, fused {launches[1]} "
          f"(expected 10 x {steps}, 0)")
    if rc != 0 or launches != (10 * steps, 0) or \
            not math.isfinite(metrics["history"][0]["loss"]):
        raise AssertionError(f"unfused epoch: rc {rc}, launches "
                             f"{launches}, {steps} steps")


def _breakdown(engine, results: dict) -> None:
    """Where the serving time goes: one more full precompute under
    torch.profiler (device time by kernel, device idle share), and one
    256-id query split into its host gather and its device step."""
    import numpy as np
    import torch
    from repro_torch.serve import full_graph_embeddings

    prof = _profile(lambda: full_graph_embeddings(
        engine.params, engine.graph, engine.parts, engine.cfg,
        norm=engine.norm, diag_lambda=engine.diag_lambda,
        block=engine.block), top_n=6)
    results["precompute_profile"] = prof
    _print_profile("profile: precompute", prof)

    rng = np.random.default_rng(2)
    ids = rng.integers(0, engine.graph.num_nodes, size=256)
    gather, step = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        logits = engine._gather_logits(ids)
        gather.append(time.perf_counter() - t0)
        x = torch.from_numpy(logits).to(engine.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._step(x)
        torch.cuda.synchronize()
        step.append(time.perf_counter() - t0)
    results["query_256_split"] = dict(gather_ms=float(np.median(gather)) * 1e3,
                                      step_ms=float(np.median(step)) * 1e3)
    print(f"[profile] 256-id query: host gather "
          f"{np.median(gather) * 1e3:.3f} ms, device step "
          f"{np.median(step) * 1e3:.3f} ms (medians of 5)")


def _served_parity(engine, results: dict, key: str, tag: str):
    """Logits served from the engine's warm cache for 2048 random ids
    against the host oracle `full_graph_logits`: max|Δ| <= 1e-4·max(1,
    max|ref|). Returns the ids."""
    import numpy as np
    from repro_torch.core.trainer import full_graph_logits
    if engine.warm() != 0:
        raise AssertionError("the rebuilt engine did not find the warm "
                             "cache")
    n = engine.graph.num_nodes
    ids = np.random.default_rng(1).choice(n, size=min(2048, n),
                                          replace=False)
    served = engine.query(ids).logits
    t0 = time.perf_counter()
    ref = full_graph_logits(engine.params, engine.graph, engine.cfg,
                            norm=engine.norm,
                            diag_lambda=engine.diag_lambda)
    oracle_s = time.perf_counter() - t0
    bound = SERVE_TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(served - ref[ids]).max())
    results[key] = dict(ids=len(ids), max_abs_err=err, bound=bound,
                        oracle_s=oracle_s)
    print(f"[{tag}] parity vs host oracle over {len(ids)} ids: "
          f"max|Δ| = {err:.3e} (bound {bound:.3e})")
    if not err <= bound:
        raise AssertionError("served logits disagree with the oracle")
    return ids


def _serve_checkpoint(results: dict, work: pathlib.Path, ck: pathlib.Path,
                      preset: str = "ppi_sota", sets=(), key: str = "serve",
                      tag: str = "serve", graph=None):
    """`serve_gcn.main --verify-parity` on the checkpoint in `ck`: its
    block-ELL launches counted from 0 (non-empty clusters x
    propagations), its latency rows, then the served logits of a rebuilt
    engine against the host oracle. A `graph` given is the preset's
    (built otherwise), the CLI's too (`_prepared_graph`). Returns
    (launches, engine, parts, ids)."""
    import numpy as np
    from repro_torch.core.experiment import (build_gcn_config, build_graph,
                                             build_partition)
    from repro_torch.kernels import block_spmm
    from repro_torch.launch import serve_gcn
    from repro_torch.launch.run_experiment import load_spec
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.serve import ServeEngine

    spec = load_spec(_spec_args(sets, preset))
    prepared = graph
    if graph is None:
        graph = build_graph(spec)
    cfg = build_gcn_config(spec, graph)
    parts, _ = build_partition(spec, graph)
    nonempty = int((np.bincount(parts, minlength=spec.partition.num_parts)
                    > 0).sum())
    propagations = cfg.num_layers + int(cfg.precompute_ax)
    step = CheckpointManager(str(ck)).latest_valid_step()
    bench_path = work / f"{key}_bench.json"
    print(f"[{tag}] {preset}: {graph.num_nodes} nodes, {graph.num_edges} "
          f"edge slots, {nonempty} non-empty clusters, {cfg.num_layers} "
          f"layers x {cfg.hidden_dim} wide; trained checkpoint step {step}")
    argv = ["--preset", preset, "--checkpoint-dir", str(ck), "--queries",
            "1024", "--verify-parity", "--bench-out", str(bench_path)]
    for s in sets:
        argv += ["--set", s]

    # --- the main path: every launch count starts at 0 here -------------
    block_spmm.LAUNCHES = 0
    with _prepared_graph(spec, prepared):
        rc = serve_gcn.main(argv)
    launches = block_spmm.LAUNCHES
    # ---------------------------------------------------------------------
    if rc != 0:
        raise AssertionError(f"serve_gcn returned {rc}")
    expected = nonempty * propagations
    print(f"[{tag}] block_ell_spmm launches: {launches} (expected "
          f"{nonempty} clusters x {propagations} propagations = "
          f"{expected})")
    if launches != expected:
        raise AssertionError(f"launch count {launches} != {expected}")
    bench = json.loads(bench_path.read_text())
    results[key] = bench
    for row in bench["rows"]:
        if "p50_ms" in row:
            print(f"[{tag}] {row['name']}: {row['requests']} req  "
                  f"p50 {row['p50_ms']:.4f} ms  p99 {row['p99_ms']:.4f} ms")
        else:
            print(f"[{tag}] {row['name']}: {row['seconds']:.4f} s "
                  f"({row['warmed_clusters']} clusters)")
    print(f"[{tag}] QPS {bench['qps']:.1f} over {bench['queries']} lookups")

    # --- parity of the served logits with the host oracle ---------------
    engine = ServeEngine.from_checkpoint(spec, str(ck), device="cuda",
                                         graph=graph)
    ids = _served_parity(engine, results, f"{key}_parity", tag)
    return launches, engine, parts, ids


def phase_serve(results: dict, work: pathlib.Path,
                ck: pathlib.Path) -> int:
    """Serve the checkpoint in `ck` (the one phase 3 trained), then where
    the serving time goes and the lazy re-embed of one cluster."""
    import numpy as np
    from repro_torch.kernels import block_spmm

    launches, engine, parts, ids = _serve_checkpoint(results, work, ck)
    _breakdown(engine, results)

    # --- lazy halo re-embed of an invalidated cluster --------------------
    c = int(parts[ids[0]])
    rows = np.where(engine.parts == c)[0]
    warm_value = np.array(engine.cache.load(c))
    engine.cache.invalidate(c)
    before = block_spmm.LAUNCHES
    t0 = time.perf_counter()
    lazy = engine.query(rows).logits
    lazy_s = time.perf_counter() - t0
    relaunch = block_spmm.LAUNCHES - before
    bound = SERVE_TOL * max(1.0, float(np.abs(warm_value).max()))
    err = float(np.abs(lazy - warm_value).max())
    results["lazy_reembed"] = dict(cluster=c, rows=len(rows),
                                   max_abs_err=err, bound=bound,
                                   launches=relaunch, seconds=lazy_s)
    print(f"[serve] lazy re-embed of cluster {c} ({len(rows)} rows, "
          f"{relaunch} launches, {lazy_s:.3f} s): max|Δ| vs warm = "
          f"{err:.3e} (bound {bound:.3e})")
    if relaunch < 1 or not err <= bound:
        raise AssertionError("lazy re-embed did not go through the "
                             "kernel or disagrees with the warm value")
    return launches


def _flash_inputs(B, Hq, Hkv, Tq, Tk, D, dtype, seed, strided=False):
    """q, k, v as (B, H, T, D); strided: transposed views of (B, T, H, D)
    tensors, as the model hands them over."""
    import torch
    g = torch.Generator().manual_seed(seed)
    out = []
    for H, T in ((Hq, Tq), (Hkv, Tk), (Hkv, Tk)):
        shape = (B, T, H, D) if strided else (B, H, T, D)
        x = torch.randn(*shape, generator=g).to(dtype).cuda()
        out.append(x.transpose(1, 2) if strided else x)
    return tuple(out)


def phase_flash(results: dict) -> dict:
    """The flash-attention kernel against its plain version; returns the
    row of the llama3.2-1b prefill shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import (attention_mask,
                                         multi_head_attention_ref)

    masks = (dict(causal=True), dict(causal=False),
             dict(causal=True, window=17), dict(causal=True, softcap=30.0))
    dtypes = (torch.float32, torch.bfloat16)
    cases = []
    for D in (16, 64, 80, 128, 256):
        cases += [((1, 4, 1, 100, 100, D), dt, kw)
                  for dt in dtypes for kw in masks]
    for shape in ((1, 32, 8, 256, 256, 64), (1, 4, 2, 1, 96, 64),
                  (1, 4, 2, 96, 64, 64)):
        cases += [(shape, dt, kw) for dt in dtypes for kw in masks]
    cases = [(shape, dt, kw, False) for shape, dt, kw in cases]
    bf16, causal = torch.bfloat16, dict(causal=True)
    cases += [((1, 8, 2, 2048, 2048, 128), bf16, causal, False),
              ((1, 8, 2, 2048, 2048, 256), bf16, causal, False),
              ((1, 4, 1, 2048, 2048, 256), bf16,     # gemma3's local layer
               dict(causal=True, window=512, softcap=30.0), False),
              ((2, 8, 2, 300, 1000, 64), bf16, causal, False),
              ((1, 4, 2, 1000, 1000, 128), bf16, dict(causal=False), False),
              ((2, 32, 8, 1000, 1000, 64), bf16, causal, True)]
    cases.append((tuple(FLASH_MAIN.values()), bf16, causal, False))
    # the fp32 kernel at the same shape: phase 8's fp32 prefill runs it
    cases.append((tuple(FLASH_MAIN.values()), torch.float32, causal, False))
    main = main_fp32 = None
    for n, (shape, dtype, kw, strided) in enumerate(cases):
        B, Hq, Hkv, Tq, Tk, D = shape
        q, k, v = _flash_inputs(*shape, dtype, seed=n, strided=strided)
        y = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = multi_head_attention_ref(q, k, v, **kw)
        err = float((y.float() - ref.float()).abs().max())
        scale = max(1.0, float(ref.float().abs().max()))
        dname = str(dtype).replace("torch.", "")
        is_main = shape == tuple(FLASH_MAIN.values())
        reps = 10 if is_main else 3
        launch_kw = dict(dict(causal=True, window=None, softcap=None), **kw,
                         scale=1.0 / D ** 0.5)
        ms = _time_ms(lambda: fa._launch(q, k, v, **launch_kw), reps)
        plain_ms = _time_ms(lambda: multi_head_attention_ref(q, k, v, **kw),
                            reps)
        pairs = int(attention_mask(Tq, Tk, kw.get("causal", True),
                                   kw.get("window"), "cpu").sum())
        row = dict(B=B, Hq=Hq, Hkv=Hkv, Tq=Tq, Tk=Tk, D=D, dtype=dname,
                   mask={k_: v_ for k_, v_ in kw.items()}, strided=strided,
                   ms=ms, plain_ms=plain_ms, visible_pairs=pairs)
        # QK^T and P.V: 2 FLOP per multiply-add each, over visible pairs
        row["flops"] = 4.0 * B * Hq * D * pairs
        row["bound_ms"], row["bound_by"] = _bound(row["flops"], (q, k, v, y),
                                                  dtype)
        if is_main:
            def library():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
            lib = library()
            row["library_ms"] = _time_ms(library, reps)
            row["library_max_abs_err_vs_plain"] = float(
                (lib.float() - ref.float()).abs().max())
            if dtype == bf16:
                main = row
            else:
                main_fp32 = row
        _check_case("flash_attention", row, err, scale, dname)
        results["flash_cases"].append(row)
        print(f"[flash] B={B} Hq={Hq:>2}/{Hkv} Tq={Tq:>4} Tk={Tk:>4} D={D:>3} "
              f"{dname:>8} {kw}{' strided' if strided else ''}  "
              f"max|Δ|={err:.3e} "
              f"(tol {TOL[dname] * scale:.3e})  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  bound {row['bound_ms']:.4f} ms"
              + (f"  sdpa {row['library_ms']:.4f} ms"
                 if "library_ms" in row else ""))
        del q, k, v, y, ref
    main["tflop_s"] = main["flops"] / main["ms"] / 1e9
    main["bound_share"] = main["bound_ms"] / main["ms"]
    main["vs_library"] = main["ms"] / main["library_ms"]
    print(f"[flash] prefill shape: kernel {main['ms']:.4f} ms, "
          f"{main['tflop_s']:.1f} TFLOP/s, {100 * main['bound_share']:.1f}% "
          f"of the {main['bound_ms']:.4f} ms bound; plain "
          f"{main['plain_ms']:.4f} ms; sdpa {main['library_ms']:.4f} ms "
          f"(kernel / sdpa = {main['vs_library']:.2f})")
    m32 = main_fp32
    m32["bound_share"] = m32["bound_ms"] / m32["ms"]
    m32["vs_library"] = m32["ms"] / m32["library_ms"]
    results["flash_main_fp32"] = m32
    print(f"[flash] prefill shape, fp32 kernel: {m32['ms']:.4f} ms, "
          f"{100 * m32['bound_share']:.1f}% of the {m32['bound_ms']:.4f} ms "
          f"bound ({m32['bound_by']}); plain {m32['plain_ms']:.4f} ms; sdpa "
          f"fp32 {m32['library_ms']:.4f} ms (kernel / sdpa = "
          f"{m32['vs_library']:.2f})")
    return main


def _device_events_ms(prof) -> dict:
    """Device time by name (kernels, copies, memsets) summed straight from
    a trace's raw events: `key_averages()` builds a Python object per
    event, which takes minutes for hundreds of thousands of launches
    (xlstm-1.3b's sLSTM loop), and has come back without the device
    events of a trace that holds them. User annotations (the ranges of
    `repro_torch.runtime.trace` spans on the device) are left out."""
    from torch.autograd import DeviceType
    device = {}
    for evt in prof.profiler.kineto_results.events():
        user = getattr(evt, "is_user_annotation", None)
        if evt.device_type() == DeviceType.CUDA and not (user and user()):
            name = evt.name()
            device[name] = device.get(name, 0.0) + evt.duration_ns() / 1e6
    return device


def _profile(fn, top_n: int = 10) -> dict:
    """Run fn once under torch.profiler: wall ms, device busy ms, idle
    share and device time by kernel (`_device_events_ms`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = _device_events_ms(prof)
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:top_n]
    # (name, ms) pairs: names cut to 80 characters can collide
    return dict(wall_ms=wall, device_busy_ms=busy,
                idle_share=1.0 - busy / wall,
                top_device_ms=[(k[:80], v) for k, v in top])


def _print_profile(tag: str, prof: dict) -> None:
    print(f"[{tag}] {prof['wall_ms']:.3f} ms wall, device busy "
          f"{prof['device_busy_ms']:.3f} ms, idle share "
          f"{prof['idle_share']:.3f}")
    for name, ms in prof["top_device_ms"]:
        print(f"[{tag}]   {ms:9.4f} ms  {name}")


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _zeroed(caches):
    """`caches` zeroed in place and returned: a prefill starts each SSM
    block from its cache's state (attention caches it rewrites whole,
    so zeroing changes nothing there)."""
    from repro_torch.nn.tree import tree_leaves
    for t in tree_leaves(caches):
        t.zero_()
    return caches


def _prefill_then_decode(lm, params, cfg, batch, caches, S):
    """Logits of the last prompt position by prefill(S-1), on zeroed
    caches, and one decode step at its position (after the prefix, if
    any)."""
    short = dict(batch, tokens=batch["tokens"][:, :S - 1])
    _, c = lm.prefill(params, cfg, short, _zeroed(caches))
    pos = cfg.num_prefix_embeddings + S - 1
    dec, _ = lm.decode_step(params, cfg, batch["tokens"][:, S - 1:], c, pos)
    return dec


def phase_lm_serve(results: dict) -> int:
    """Serve llama3.2-1b at full width through the CLI — the main path
    of the flash kernel — then parity, consistency and the breakdown."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import multi_head_attention_ref
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.spec import init_tree

    print(f"[lm] serve {' '.join(LM_ARGV)}")
    # --- the main path: the launch count starts at 0 here ---------------
    fa.LAUNCHES = fa.LAUNCHES_SM90 = 0
    out = serve.main(LM_ARGV)
    launches, launches_sm90 = fa.LAUNCHES, fa.LAUNCHES_SM90
    # ---------------------------------------------------------------------
    cfg = get_arch("llama3.2-1b")
    finite = bool(torch.isfinite(out["prefill_logits"]).all()
                  and torch.isfinite(out["last_logits"]).all())
    results["lm_serve"] = dict(
        prefill_s=out["prefill_s"], decode_s=out["decode_s"],
        decode_steps=out["decode_steps"], decode_tok_s=out["decode_tok_s"],
        launches=out["launches"], launches_total=launches,
        launches_sm90=launches_sm90,
        first_row=out["tokens"][0].tolist(), finite=finite)
    print(f"[lm] flash launches: prefill {out['launches']['prefill']}, "
          f"decode {out['launches']['decode']} (expected "
          f"{cfg.num_layers}, 0), of them the bf16 wgmma kernel "
          f"{launches_sm90}; logits finite: {finite}")
    if launches != cfg.num_layers or launches_sm90 != cfg.num_layers \
            or out["launches"] != {
            "prefill": cfg.num_layers, "decode": 0} or not finite:
        raise AssertionError(f"LM serving: {results['lm_serve']}")
    # phase 17d serves the same argv on a mesh and compares with this run
    _PHASE8.update({k: out[k] for k in ("prefill_logits", "tokens",
                                        "prefill_s", "decode_tok_s")})
    del out

    B, S, G = 4, 2048, 32
    torch.cuda.reset_peak_memory_stats()
    params, caches = serve.init_serving(cfg, B, S + G, 0, "cuda")
    batch = serve.make_batch(cfg, B, S, 0, "cuda")
    with torch.no_grad():
        prefill_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = lm.prefill(params, cfg, batch, caches)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain, _ = lm.prefill(params, cfg, batch, caches,
                              attn_fn=multi_head_attention_ref)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        dec = _prefill_then_decode(lm, params, cfg, batch, caches, S)
        # the same params in fp32: where the paths must agree tightly
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        params32 = init_tree(lm.spec_params(cfg32), torch.Generator(
            device="cuda").manual_seed(0), "cuda")
        caches32 = init_tree(lm.spec_caches(cfg32, B, S + G),
                             torch.Generator(), "cuda")
        logits32, _ = lm.prefill(params32, cfg32, batch, caches32)
        plain32, _ = lm.prefill(params32, cfg32, batch, caches32,
                                attn_fn=multi_head_attention_ref)
        dec32 = _prefill_then_decode(lm, params32, cfg32, batch, caches32, S)
        del params32, caches32
        parity = dict(
            bf16_kernel_vs_plain=_rel(logits, plain),
            bf16_prefill_vs_decode=_rel(dec, logits),
            fp32_kernel_vs_plain=_rel(logits32, plain32),
            fp32_prefill_vs_decode=_rel(dec32, logits32),
            bf16_plain_vs_fp32=_rel(plain, plain32),
            bf16_kernel_vs_fp32=_rel(logits, plain32))

        c, tok = caches, dec.argmax(-1).to(torch.int32)[:, None]
        step_s = []
        for i in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, c = lm.decode_step(params, cfg, tok, c, S + i)
            tok = lg.argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

        prof_prefill = _profile(lambda: lm.prefill(params, cfg, batch,
                                                   caches))

        def four_steps():
            t, cc = tok, c
            for i in range(4):
                lg, cc = lm.decode_step(params, cfg, t, cc, S + 10 + i)
                t = lg.argmax(-1).to(torch.int32)[:, None]
        prof_decode = _profile(four_steps)
    floor = parity["bf16_plain_vs_fp32"]
    parity.update(fp32_bound=LM_FP32_TOL, bf16_bound=2 * floor,
                  issue_bound=LM_TOL)
    results["lm_parity"] = parity
    results["lm_time"] = dict(
        prefill_warm_s=[float(x) for x in prefill_s],
        prefill_warm_median_s=float(np.median(prefill_s)),
        prefill_plain_attention_s=plain_s,
        decode_step_median_ms=float(np.median(step_s)) * 1e3,
        peak_memory_gib=peak_gb)
    results["lm_prefill_profile"] = prof_prefill
    results["lm_decode_profile"] = prof_decode
    print(f"[lm] fp32, same params: prefill logits kernel vs plain "
          f"attention rel {parity['fp32_kernel_vs_plain']:.3e}, prefill(S) "
          f"vs prefill(S-1) + decode rel "
          f"{parity['fp32_prefill_vs_decode']:.3e} (bound {LM_FP32_TOL})")
    print(f"[lm] bf16: kernel vs plain rel "
          f"{parity['bf16_kernel_vs_plain']:.3e}, prefill vs decode rel "
          f"{parity['bf16_prefill_vs_decode']:.3e} (bound 2 x the bf16 "
          f"floor = {2 * floor:.3e}); floor = plain bf16 vs plain fp32 "
          f"{floor:.3e}, kernel bf16 vs plain fp32 "
          f"{parity['bf16_kernel_vs_fp32']:.3e}")
    print(f"[lm] warm prefill {np.median(prefill_s):.4f} s (median of 3; "
          f"plain attention {plain_s:.4f} s); decode step "
          f"{np.median(step_s) * 1e3:.3f} ms (median of 10, synchronised); "
          f"peak memory {peak_gb:.2f} GiB")
    _print_profile("lm prefill profile", prof_prefill)
    _print_profile("lm decode profile (4 steps)", prof_decode)
    if not (parity["fp32_kernel_vs_plain"] <= LM_FP32_TOL
            and parity["fp32_prefill_vs_decode"] <= LM_FP32_TOL
            and parity["bf16_kernel_vs_plain"] <= 2 * floor
            and parity["bf16_prefill_vs_decode"] <= 2 * floor):
        raise AssertionError(f"LM parity: {parity}")
    return launches


def _epoch_seconds(history) -> list:
    """Each epoch's seconds from a history's cumulative `time`."""
    times = [0.0] + [h["time"] for h in history]
    return [b - a for a, b in zip(times, times[1:])]


def phase_cold_start(results: dict, work: pathlib.Path) -> dict:
    """Serve ppi_sota from an EMPTY checkpoint directory: serve_gcn
    trains first (1 epoch, block-ELL, fused), writes the checkpoint,
    precomputes the cache and answers 256 lookups."""
    import numpy as np
    from repro_torch.core.experiment import (build_batcher, build_gcn_config,
                                             build_graph, build_partition)
    from repro_torch.kernels import block_spmm
    from repro_torch.launch import serve_gcn
    from repro_torch.launch.run_experiment import load_spec
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.serve import ServeEngine

    ck = work / "cold_ck"
    sets = TRAIN_SETS + ["run.epochs=1", "batch.node_cap=384",
                         f"serve.cache_dir={work / 'cold_cache'}"]
    argv = ["--preset", "ppi_sota", "--checkpoint-dir", str(ck),
            "--queries", "256", "--verify-parity"]
    for s in sets:
        argv += ["--set", s]
    spec = load_spec(_spec_args(sets))
    graph = build_graph(spec)
    cfg = build_gcn_config(spec, graph)
    parts, _ = build_partition(spec, graph)
    per_epoch = build_batcher(spec, graph, parts).steps_per_epoch()
    nonempty = int((np.bincount(parts, minlength=spec.partition.num_parts)
                    > 0).sum())
    propagations = cfg.num_layers + int(cfg.precompute_ax)
    if CheckpointManager(str(ck)).latest_valid_step() is not None:
        raise AssertionError(f"{ck} is not empty")
    print(f"[cold] serve_gcn {' '.join(argv)}")
    t0 = time.perf_counter()
    # --- the main path: every launch count starts at 0 here -------------
    block_spmm.LAUNCHES = 0
    block_spmm.LAUNCHES_FUSED = 0
    rc = serve_gcn.main(argv)
    launches = {"block_ell_spmm": block_spmm.LAUNCHES,
                "block_ell_spmm_fused": block_spmm.LAUNCHES_FUSED}
    # ---------------------------------------------------------------------
    wall = time.perf_counter() - t0
    step = CheckpointManager(str(ck)).latest_valid_step()
    expected = {"block_ell_spmm": cfg.num_layers * per_epoch
                + nonempty * propagations,
                "block_ell_spmm_fused": cfg.num_layers * per_epoch}
    results["cold_start"] = dict(rc=rc, wall_s=wall, checkpoint_step=step,
                                 launches=launches, expected=expected)
    print(f"[cold] rc {rc} in {wall:.2f} s (train 1 epoch + precompute + "
          f"256 lookups); checkpoint step {step}; launches {launches} "
          f"(expected {cfg.num_layers} fused + {cfg.num_layers} block-ELL "
          f"per step x {per_epoch} steps, + {nonempty} clusters x "
          f"{propagations} propagations: {expected})")
    if rc != 0 or step != per_epoch or launches != expected:
        raise AssertionError(f"cold start: {results['cold_start']}")
    engine = ServeEngine.from_checkpoint(spec, str(ck), device="cuda")
    _served_parity(engine, results, "cold_start_parity", "cold")
    return launches


def phase_saint(results: dict, work: pathlib.Path) -> dict:
    """GraphSAINT training of ppi_sota through the CLI, then the step
    split, tile occupancy and one-step parity on SAINT batches."""
    import numpy as np
    from repro_torch.kernels import block_spmm
    from repro_torch.launch import run_experiment

    launches = {}
    for sampler, epochs, extra in SAINT_RUNS:
        argv = _train_argv(work, sampler, SAINT_SETS + extra + [
            f"batch.sampler={sampler}", f"run.epochs={epochs}",
            "run.eval_every=0"])
        print(f"[saint] run_experiment {' '.join(argv)}")
        mem0 = _reset_peak_memory()
        t0 = time.perf_counter()
        # --- the main path: every launch count starts at 0 here ---------
        block_spmm.LAUNCHES = 0
        block_spmm.LAUNCHES_FUSED = 0
        rc = run_experiment.main(argv)
        got = {"block_ell_spmm": block_spmm.LAUNCHES,
               "block_ell_spmm_fused": block_spmm.LAUNCHES_FUSED}
        # -----------------------------------------------------------------
        wall = time.perf_counter() - t0
        memory = _peak_memory(mem0)
        metrics = json.loads((work / sampler / "ppi_sota" / "metrics.json")
                             .read_text())
        steps = metrics["global_step"]
        losses = [h["loss"] for h in metrics["history"]]
        epoch_s = _epoch_seconds(metrics["history"])
        results[sampler] = dict(rc=rc, steps=steps, wall_s=wall,
                                launches=got, losses=losses,
                                epoch_s=epoch_s, final=metrics["final"],
                                **memory)
        print(f"[saint] {sampler}: {steps} steps in {wall:.2f} s; epoch "
              f"losses {losses}; epoch seconds {epoch_s}; launches {got} "
              f"(expected 5 x {steps} each); peak device memory "
              f"{memory['peak_gib']:.3f} GiB; final "
              f"{metrics['final']['split']} micro-F1 "
              f"{metrics['final']['score']:.4f}")
        if rc != 0 or steps == 0 or got != {
                "block_ell_spmm": 5 * steps,
                "block_ell_spmm_fused": 5 * steps}:
            raise AssertionError(f"{sampler}: {results[sampler]}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{sampler}: loss not finite: {losses}")
        if sampler == "saint_node" and not losses[1] < losses[0]:
            raise AssertionError(f"saint_node: loss not falling: {losses}")
        launches[sampler] = got
    for sampler, _, _ in SAINT_RUNS:
        phase_step_profile(results, _step_parts(
            SAINT_SETS + [f"batch.sampler={sampler}"]),
            key=f"{sampler}_step", tag=f"{sampler} step")
    cl, node = (results["train_step"]["occupancy"],
                results["saint_node_step"]["occupancy"])
    print(f"[saint] live K slots per row-block: cluster batches "
          f"{cl['mean_live_k']:.3f}, saint_node {node['mean_live_k']:.3f}, "
          f"saint_edge "
          f"{results['saint_edge_step']['occupancy']['mean_live_k']:.3f} "
          f"(of K {cl['K']}); live tiles nonzero: cluster "
          f"{100 * cl['live_tile_fill']:.2f}%, saint_node "
          f"{100 * node['live_tile_fill']:.2f}%")
    key = "saint_step_parity"
    phase_step_parity(results, _step_parts(
        SAINT_SETS + ["batch.sampler=saint_node"]), key=key,
        tag="saint parity")
    if not results[key]["loss_weights_fractional"]:
        raise AssertionError("the SAINT batch carries no fractional loss "
                             "weights")
    return launches


def phase_baselines(results: dict) -> None:
    """The paper's baselines at ppi_sota's widths on the card: losses,
    seconds per epoch, peak device memory; then a full-batch step GPU
    vs CPU."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import baselines
    from repro_torch.core.experiment import (build_gcn_config, build_graph,
                                             build_optimizer, preset)

    spec = preset("ppi_sota")
    graph = build_graph(spec)
    cfg = build_gcn_config(spec, graph)
    batch = dict(batch_size=BASELINE_BATCH)
    runs = (("full_batch", baselines.train_full_batch, 3, {}),
            ("expansion_sgd", baselines.train_expansion_sgd, 1, batch),
            ("sage", baselines.train_sage, 1, batch),
            ("vrgcn", baselines.train_vrgcn, 1, batch))
    steps = max(1, int(graph.train_mask.sum()) // BASELINE_BATCH)
    rows = {}
    for name, fn, epochs, kw in runs:
        torch.cuda.empty_cache()
        mem0 = _reset_peak_memory()
        res = fn(graph, cfg, build_optimizer(spec), epochs, device="cuda",
                 **kw)
        memory = _peak_memory(mem0)
        losses = [h["loss"] for h in res["history"]]
        epoch_s = _epoch_seconds(res["history"])
        row = dict(epochs=epochs, steps_per_epoch=1 if name == "full_batch"
                   else steps, losses=losses, epoch_s=epoch_s,
                   seconds=res["seconds"], **memory)
        if name == "vrgcn":
            want = graph.num_nodes * cfg.hidden_dim * (cfg.num_layers - 1) * 4
            row.update(history_bytes=res["history_bytes"],
                       history_bytes_expected=want)
            print(f"[baselines] vrgcn host history {res['history_bytes']} "
                  f"bytes (expected N x {cfg.hidden_dim} x "
                  f"{cfg.num_layers - 1} layers x 4 = {want})")
            if res["history_bytes"] != want:
                raise AssertionError("VR-GCN history size")
        rows[name] = row
        print(f"[baselines] {name}: losses {losses}; epoch seconds "
              f"{epoch_s}; peak device memory {memory['peak_gib']:.3f} GiB")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: loss not finite: {losses}")
        del res
    results["baselines"] = rows

    train, node = results["train"], results["saint_node"]
    table = {"cluster_gcn": dict(
        epochs=2, steps_per_epoch=train["steps"] // 2,
        epoch_s=[train["history"][0]["time"]], peak_gib=train["peak_gib"],
        above_start_gib=train["above_start_gib"]),
        "saint_node": dict(epochs=2, steps_per_epoch=node["steps"] // 2,
                           epoch_s=node["epoch_s"], peak_gib=node["peak_gib"],
                           above_start_gib=node["above_start_gib"]),
        **rows}
    results["comparison"] = {k: {c: v[c] for c in (
        "epochs", "steps_per_epoch", "epoch_s", "peak_gib",
        "above_start_gib")} for k, v in table.items()}
    print("[compare] ppi_sota 5 x 2048, 14,000 nodes; epoch seconds "
          "(first epoch, then later ones) and peak device memory")
    print(f"[compare] {'method':<14} {'epochs':>6} {'steps/ep':>8} "
          f"{'epoch 1 s':>10} {'later s':>10} {'peak GiB':>9} "
          f"{'above GiB':>9}")
    for k, v in table.items():
        later = (f"{np.mean(v['epoch_s'][1:]):10.3f}"
                 if len(v["epoch_s"]) > 1 else f"{'-':>10}")
        print(f"[compare] {k:<14} {v['epochs']:>6} {v['steps_per_epoch']:>8} "
              f"{v['epoch_s'][0]:10.3f} {later} {v['peak_gib']:9.3f} "
              f"{v['above_start_gib']:9.3f}")

    # one full-batch step on the card and on the CPU, same init, no dropout
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    loss = {dev: baselines.train_full_batch(
        graph, cfg0, build_optimizer(spec), 1,
        device=dev)["history"][0]["loss"] for dev in ("cuda", "cpu")}
    rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    results["full_batch_parity"] = dict(loss_gpu=loss["cuda"],
                                        loss_cpu=loss["cpu"], loss_rel_err=rel,
                                        bound=STEP_TOL)
    print(f"[baselines] full-batch step GPU vs CPU: loss {loss['cuda']:.6f} "
          f"vs {loss['cpu']:.6f} (rel {rel:.3e}, bound {STEP_TOL})")
    if not rel <= STEP_TOL:
        raise AssertionError(f"full batch: {results['full_batch_parity']}")


def phase_real(results: dict, work: pathlib.Path) -> dict:
    """GraphSAGE-format PPI at its published size through the real-dataset
    path, then one epoch of ppi_sota's recipe on it through the CLI."""
    import numpy as np
    from repro_torch.graph import archives
    from repro_torch.graph.datasets import load_dataset
    from repro_torch.kernels import block_spmm
    from repro_torch.launch import run_experiment

    mirror = work / "mirror"
    t0 = time.perf_counter()
    counts = archives.write_graphsage_ppi(mirror / "ppi.zip", seed=0)
    write_s = time.perf_counter() - t0
    os.environ["REPRO_DATASETS_MIRROR"] = mirror.as_uri()
    t0 = time.perf_counter()
    g = load_dataset("ppi_real")
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = load_dataset("ppi_real")
    reload_s = time.perf_counter() - t0
    splits = tuple(int(m.sum()) for m in (g.train_mask, g.val_mask,
                                          g.test_mask))
    row = dict(archive=counts, archive_mb=(mirror / "ppi.zip").stat()
               .st_size / 1e6, write_s=write_s, first_load_s=first_s,
               reload_s=reload_s, nodes=g.num_nodes, edge_slots=g.num_edges,
               splits=splits, mmap=isinstance(g.features, np.memmap))
    print(f"[real] ppi.zip ({row['archive_mb']:.1f} MB, {counts['nodes']} "
          f"nodes, {counts['links']} links, {counts['graphs']} graphs) "
          f"written in {write_s:.2f} s; load_dataset: first call (fetch, "
          f"checksum, extract, parse, processed write) {first_s:.2f} s, "
          f"cached mmap reload {reload_s * 1e3:.1f} ms; {g.num_edges} edge "
          f"slots, splits {splits}, features memory-mapped {row['mmap']}")
    if (g.num_nodes, g.features.shape[1], g.labels.shape[1]) != (
            archives.PPI_NODES, archives.PPI_FEATURES, archives.PPI_LABELS) \
            or splits != (counts["train"], counts["val"], counts["test"]) \
            or not row["mmap"]:
        raise AssertionError(f"ppi_real loaded wrong: {row}")

    argv = ["--preset", "ppi_sota", "--results-dir", str(work / "real")]
    for s in REAL_SETS + ["run.epochs=1", "run.eval_every=0"]:
        argv += ["--set", s]
    print(f"[real] run_experiment {' '.join(argv)}")
    mem0 = _reset_peak_memory()
    t0 = time.perf_counter()
    # --- the main path: every launch count starts at 0 here -------------
    block_spmm.LAUNCHES = 0
    block_spmm.LAUNCHES_FUSED = 0
    rc = run_experiment.main(argv)
    launches = {"block_ell_spmm": block_spmm.LAUNCHES,
                "block_ell_spmm_fused": block_spmm.LAUNCHES_FUSED}
    # ---------------------------------------------------------------------
    wall = time.perf_counter() - t0
    memory = _peak_memory(mem0)
    metrics = json.loads((work / "real" / "ppi_sota" / "metrics.json")
                         .read_text())
    steps = metrics["global_step"]
    losses = [h["loss"] for h in metrics["history"]]
    row.update(rc=rc, steps=steps, wall_s=wall, launches=launches,
               losses=losses, epoch_s=_epoch_seconds(metrics["history"]),
               **memory)
    results["real"] = row
    print(f"[real] {steps} steps in {wall:.2f} s (incl. build, partition "
          f"and the final host eval); epoch {row['epoch_s'][0]:.3f} s; loss "
          f"{losses}; launches {launches} (expected 5 x {steps} each); peak "
          f"device memory {memory['peak_gib']:.3f} GiB")
    if rc != 0 or steps == 0 or launches != {
            "block_ell_spmm": 5 * steps, "block_ell_spmm_fused": 5 * steps} \
            or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"ppi_real training: {row}")
    phase_step_profile(results, _step_parts(REAL_SETS), key="real_step",
                       tag="real step")
    phase_step_parity(results, _step_parts(REAL_SETS),
                      key="real_step_parity", tag="real parity")
    return launches


def _dp_spawn(mode: str, world: int, work: pathlib.Path) -> list:
    """`python chip_smoke.py --dp-worker <mode> <out>` on `world` ranks
    (torchrun's environment, rendezvous at 127.0.0.1), each killed if it
    outlives DP_TIMEOUT_S; returns each rank's result."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for r in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK="0")
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-worker", mode,
             str(work / f"dp_{mode}_{r}.json")], env=env))
    try:
        rcs = [p.wait(timeout=DP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise AssertionError(f"data-parallel {mode} ranks exited {rcs}")
    return [json.loads((work / f"dp_{mode}_{r}.json").read_text())
            for r in range(world)]


def _dp_spec(sets):
    from repro_torch.core.experiment import apply_overrides
    from repro_torch.launch.run_experiment import load_spec
    spec = load_spec(_spec_args(TRAIN_SETS))
    return apply_overrides(spec, sets)


def _allreduce_ms(numel: int, device, reps: int = 20) -> float:
    """Median of `reps` all-reduces of one fp32 buffer of `numel`."""
    import numpy as np
    import torch
    import torch.distributed as dist
    buf = torch.ones(numel, dtype=torch.float32, device=device)
    times = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times[2:])) * 1e3


def _first_moment_err(got, want, comp) -> float:
    """Worst |Δm| / bound over the leaves of two AdamW first moments
    (phase 13a's bounds, module docstring)."""
    import torch
    worst = 0.0
    for g, w in zip(got, want):
        top = float(w.abs().max())
        bound = STEP_TOL * max(1.0, top) + torch.zeros_like(w)
        if comp == "bf16":
            bound = bound + 2.0 ** -8 * w.abs()
        elif comp in (8, 4):
            bound = bound + top / (2 * (2 ** (comp - 1) - 1))
        worst = max(worst, float(((g - w).abs() / bound).max()))
    return worst


def _dp_nccl() -> dict:
    """Phase 13a in a world of 1 over NCCL (one process)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.batching import batch_to_device
    from repro_torch.core.engine import (DataParallelBackend,
                                         SingleDeviceBackend, StopAtStepHook)
    from repro_torch.core.experiment import build_experiment
    from repro_torch.core.gcn import init_params
    from repro_torch.kernels import block_spmm
    from repro_torch.nn.tree import tree_leaves

    out = {}
    for comp in DP_COMPRESSIONS:
        spec = _dp_spec({"execution.data_shards": 1,
                         "execution.compression": comp,
                         "run.epochs": 1, "run.eval_every": 0})
        exp = build_experiment(spec, device="cuda",
                               extra_hooks=[StopAtStepHook(DP_STEPS)])
        backend, dev = exp.engine.backend, exp.engine.device
        # --- the main path: every launch count starts at 0 here ---------
        block_spmm.LAUNCHES = 0
        block_spmm.LAUNCHES_FUSED = 0
        res = exp.fit()
        torch.cuda.synchronize()
        launches = {"block_ell_spmm": block_spmm.LAUNCHES,
                    "block_ell_spmm_fused": block_spmm.LAUNCHES_FUSED}
        # -----------------------------------------------------------------
        steps = exp.engine.global_step
        # the step split, each step synchronised
        state = exp.engine.state
        it = backend.stream(b.astuple() for b in exp.batcher.epoch(0))
        times, builds = [], []
        for _ in range(DP_STEPS):
            t0 = time.perf_counter()
            host = next(it)
            builds.append(time.perf_counter() - t0)
            payload = batch_to_device(host, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss, _ = backend.step(state, payload)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        numel = sum(p.numel() for p in tree_leaves(backend.params(state)))
        allreduce = _allreduce_ms(numel + 5, dev)
        # the first step against the single-device step, dropout 0
        cfg0 = dataclasses.replace(exp.cfg, dropout=0.0)
        dp0 = DataParallelBackend(cfg0, exp.opt, None, device=dev,
                                  compression=comp)
        single = SingleDeviceBackend(cfg0, exp.opt, device=dev)
        params = init_params(cfg0, generator=torch.Generator().manual_seed(3),
                             device=dev)
        host = next(iter(exp.batcher.epoch(0))).astuple()
        gen = torch.Generator(device=dev).manual_seed(1)
        s_state, s_loss, _ = single.step(single.init(params, gen),
                                         batch_to_device(host, dev))
        d_state, d_loss, _ = dp0.step(dp0.init(params, gen),
                                      batch_to_device([host], dev))
        worst = _first_moment_err(tree_leaves(d_state["dist"]["opt"].mu),
                                  tree_leaves(s_state["opt"].mu), comp)
        out[str(comp)] = dict(
            steps=steps, launches=launches,
            losses=[h["loss"] for h in res.history] or None,
            step_ms=float(np.median(times)) * 1e3,
            build_ms=float(np.median(builds)) * 1e3,
            allreduce_ms=allreduce,
            allreduce_share=allreduce / (float(np.median(times)) * 1e3),
            grad_numel=numel, loss_single=float(s_loss),
            loss_dp=float(d_loss), worst_moment_err_over_bound=worst,
            finite=bool(math.isfinite(float(loss))))
    return out


def _dp_gloo() -> dict:
    """Phase 13b on one of two ranks sharing cuda:0 over gloo."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.batching import batch_to_device
    from repro_torch.core.experiment import build_experiment
    from repro_torch.core.gcn import gcn_loss, init_params
    from repro_torch.kernels import block_spmm
    from repro_torch.nn.optim import apply_updates
    from repro_torch.nn.tree import tree_leaves, tree_map

    rank = dist.get_rank()
    spec = _dp_spec({"execution.data_shards": 2, "model.dropout": 0.0})
    exp = build_experiment(spec, device="cuda:0")
    backend, dev = exp.engine.backend, exp.engine.device
    params = init_params(exp.cfg, generator=torch.Generator().manual_seed(3),
                         device=dev)
    # host cost of this rank's slice: every rank builds the whole group
    it = backend.stream(b.astuple() for b in exp.batcher.epoch(0))
    builds = []
    for _ in range(4):
        t0 = time.perf_counter()
        host = next(it)
        builds.append(time.perf_counter() - t0)
        if len(builds) == 1:
            mine = batch_to_device(host, dev)
    # this rank's own gradient, and the other rank's, for the reference
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = gcn_loss(live, mine[0], exp.cfg, train=True)
    own = torch.cat([g.reshape(-1) for g in
                     torch.autograd.grad(loss, tree_leaves(live))])
    both = [torch.empty_like(own) for _ in range(2)]
    dist.all_gather(both, own)
    mean = (both[0] + both[1]) / 2
    # --- the main path: every launch count starts at 0 here -------------
    block_spmm.LAUNCHES = 0
    block_spmm.LAUNCHES_FUSED = 0
    state, dp_loss, _ = backend.step(backend.init(
        params, torch.Generator(device=dev).manual_seed(1)), mine)
    torch.cuda.synchronize()
    launches = {"block_ell_spmm": block_spmm.LAUNCHES,
                "block_ell_spmm_fused": block_spmm.LAUNCHES_FUSED}
    # ---------------------------------------------------------------------
    b1 = 0.9
    synced = torch.cat([m.reshape(-1) for m in
                        tree_leaves(state["dist"]["opt"].mu)]) / (1 - b1)
    grad_err = float((synced - mean).abs().max()) / (
        STEP_TOL * max(1.0, float(mean.abs().max())))
    offsets, grads = 0, []
    for p in tree_leaves(params):
        grads.append(mean[offsets:offsets + p.numel()].view(p.shape))
        offsets += p.numel()
    it = iter(grads)
    tree = tree_map(lambda _: next(it), params)
    updates, _ = exp.opt.update(tree, exp.opt.init(params), params)
    want = apply_updates(params, updates)
    param_err = max(
        float((a - b).abs().max()) / (STEP_TOL * max(1.0, float(b.abs().max())))
        for a, b in zip(tree_leaves(state["dist"]["params"]),
                        tree_leaves(want)))
    return dict(rank=rank, launches=launches,
                build_ms=float(np.median(builds)) * 1e3,
                loss_local=float(loss.detach()),
                loss_dp=float(dp_loss), grad_err_over_bound=grad_err,
                param_err_over_bound=param_err, grad_numel=own.numel(),
                gloo_allreduce_ms=_allreduce_ms(own.numel(), dev, reps=5),
                gloo_backend=dist.get_backend(), device=str(dev))


def dp_worker(mode: str, out: str) -> int:
    """One rank of phase 13 (the environment is torchrun's)."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl" if mode == "nccl" else "gloo")
    try:
        res = _dp_nccl() if mode == "nccl" else _dp_gloo()
    finally:
        dist.destroy_process_group()
    pathlib.Path(out).write_text(json.dumps(res))
    return 0


def phase_dp(results: dict, work: pathlib.Path) -> dict:
    """Phase 13: data parallel over NCCL (a world of 1) and over gloo (two
    ranks on the one card)."""
    nccl = _dp_spawn("nccl", 1, work)[0]
    launches = {}
    for comp in DP_COMPRESSIONS:
        r = nccl[str(comp)]
        per = {k: v / max(1, r["steps"]) for k, v in r["launches"].items()}
        print(f"[dp] NCCL world 1, compression {comp}: {r['steps']} steps "
              f"through fit(), launches {r['launches']} ({per} per rank per "
              f"step); host build {r['build_ms']:.3f} ms, step median "
              f"{r['step_ms']:.3f} ms, all-reduce of "
              f"{r['grad_numel']} fp32 {r['allreduce_ms']:.3f} ms (share "
              f"{r['allreduce_share']:.3f}); first step vs SingleDevice"
              f"Backend: loss {r['loss_dp']:.6f} vs {r['loss_single']:.6f}, "
              f"worst synced-gradient err / bound "
              f"{r['worst_moment_err_over_bound']:.3f}")
        if r["steps"] != DP_STEPS or r["launches"] != {
                "block_ell_spmm": 5 * DP_STEPS,
                "block_ell_spmm_fused": 5 * DP_STEPS} \
                or not r["worst_moment_err_over_bound"] <= 1.0 \
                or r["loss_dp"] != r["loss_single"] or not r["finite"]:
            raise AssertionError(f"data parallel over NCCL, {comp}: {r}")
        launches[f"dp_nccl_{comp}"] = r["launches"]
    gloo = _dp_spawn("gloo", 2, work)
    for r in gloo:
        print(f"[dp] gloo rank {r['rank']} on {r['device']}: host build of "
              f"its slice (both batches of the group) {r['build_ms']:.3f} "
              f"ms; launches {r['launches']}; loss {r['loss_dp']:.6f} (own batch "
              f"{r['loss_local']:.6f}); synced gradient vs the mean of the "
              f"two ranks' gradients: err / bound "
              f"{r['grad_err_over_bound']:.3e}; params vs one AdamW step "
              f"of that mean: {r['param_err_over_bound']:.3e}; gloo "
              f"all-reduce of {r['grad_numel']} fp32 on the card "
              f"{r['gloo_allreduce_ms']:.3f} ms")
        if r["launches"] != {"block_ell_spmm": 5, "block_ell_spmm_fused": 5} \
                or not r["grad_err_over_bound"] <= 1.0 \
                or not r["param_err_over_bound"] <= 1.0:
            raise AssertionError(f"data parallel over gloo: {r}")
        launches[f"dp_gloo_rank{r['rank']}"] = r["launches"]
    if gloo[0]["loss_dp"] != gloo[1]["loss_dp"]:
        raise AssertionError("the ranks disagree on the global loss")
    results["dp"] = dict(nccl=nccl, gloo=gloo)
    return launches


# ----------------------------------------------------------------------
# phase 14: the reference's other attention-only LMs
# ----------------------------------------------------------------------
@contextlib.contextmanager
def _patched(module, name: str, wrap):
    """`module.name` replaced by `wrap(original)` while the body runs;
    the callers look the name up in its module at each call."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _recorded_routes(store: list):
    """Record every MoE block's routing, `moe_route`'s (probs, topv,
    topi), while the body runs."""
    from repro_torch.models import layers

    def wrap(route):
        def recording(params, cfg, h):
            out = route(params, cfg, h)
            store.append(out)
            return out
        return recording
    return _patched(layers, "moe_route", wrap)


def _given_route(route):
    """Every `moe_route` call returns `route` while the body runs."""
    from repro_torch.models import layers
    return _patched(layers, "moe_route", lambda _: lambda p, c, h: route)


def _first_moe_input(store: list):
    """Record the params and input x of a forward's first MoE block."""
    from repro_torch.models import lm

    def wrap(apply):
        def recording(params, cfg, x):
            if not store:
                store.extend((params, x))
            return apply(params, cfg, x)
        return recording
    return _patched(lm, "moe_apply", wrap)


def _capacity_drops(routes: list, cfg, T: int) -> dict:
    """Assignments past their expert's capacity in a prefill's recorded
    routes: all of them, and those of each dispatch row's last token,
    which comes last in its experts' queues and which decode (dropless)
    never drops. B·T ≤ 512 is one row with C = B·T, as `moe_apply`
    dispatches it."""
    import torch
    from repro_torch.models.layers import moe_capacity
    dropped = last = max_load = n = 0
    for _, _, topi in routes:
        n += topi.numel()
        if topi.shape[0] * T <= 512:
            topi = topi.reshape(1, -1, topi.shape[-1])
            C = topi.shape[1]
        else:
            C = moe_capacity(cfg, T)
        B = topi.shape[0]
        load = torch.zeros(B, cfg.num_experts, dtype=torch.long,
                           device=topi.device)
        load.scatter_add_(1, topi.reshape(B, -1), torch.ones_like(
            topi.reshape(B, -1)))
        dropped += int((load - C).clamp_min(0).sum())
        last += int((load.gather(1, topi[:, -1]) > C).sum())
        max_load = max(max_load, int(load.max()))
    return dict(capacity=C, max_load=max_load, dropped=dropped,
                of_assignments=n, last_token_dropped=last)


def _route_changes(a: list, b: list) -> dict:
    """Tokens whose top-k set differs between two runs' recorded routes:
    summed over the MoE layers, and distinct (row, token) positions."""
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} vs {len(b)} MoE routes recorded")
    changed = [(x[2].sort(-1).values != y[2].sort(-1).values).any(-1)
               for x, y in zip(a, b)]
    anywhere = changed[0].clone()
    for c in changed[1:]:
        anywhere |= c
    return dict(token_layers=int(sum(int(c.sum()) for c in changed)),
                tokens=int(anywhere.sum()),
                of_tokens=int(anywhere.numel()), layers=len(a))


def _moe_card_vs_cpu(cfg, params, x) -> dict:
    """One MoE layer's `moe_apply` at the served shape — the params and
    input x of a served prefill's first MoE block — on the card against
    the same call on CPU copies, in fp32 and bf16, output and aux.

    The CPU call is given the card's routing (`moe_route` returns it),
    so the sort-based dispatch, the capacity drops into the overflow
    row, the expert products, the collect and the aux loss are held on
    the same assignments; the drops are counted and must be there. The
    router is held on its own: the card's probabilities against the
    CPU's (fp32 within TOL, bf16 within twice its floor, the CPU's bf16
    probabilities against its fp32 ones), and the card's top-k may
    differ from the CPU's only where the CPU's probabilities tie within
    that measured difference. y: fp32 within TOL["float32"] relative,
    bf16 within twice its floor (the CPU's bf16 call against its fp32
    call on the same routing); aux within 1e-5 relative."""
    import torch
    from repro_torch.models import layers
    from repro_torch.models.lm import cast_matmul_weights
    from repro_torch.nn.tree import tree_map

    def cast(dt, device):
        c = dataclasses.replace(cfg, compute_dtype=dt)
        p = tree_map(lambda a: a.to(device),
                     cast_matmul_weights(params, c.dtype))
        return c, p, x.to(device, c.dtype)

    def route_on_cpu(dt):
        c, p, xd = cast(dt, "cpu")
        return layers.moe_route(p, c, layers.rmsnorm(p["norm"], xd,
                                                     c.norm_eps))

    def on_cpu(dt, route):
        c, p, xd = cast(dt, "cpu")
        with _given_route(route):
            y, aux = layers.moe_apply(p, c, xd)
        return y.float(), float(aux)

    T = x.shape[1]
    out, card = {}, {}
    with torch.no_grad():
        for dt in ("float32", "bfloat16"):
            c, p, xd = cast(dt, "cuda")
            routes = []
            with _recorded_routes(routes):
                y, aux = layers.moe_apply(p, c, xd)
            route = tuple(a.cpu() for a in routes[0])
            card[dt] = (y.float().cpu(), float(aux), route)
            del p, xd, y
        own = {dt: route_on_cpu(dt) for dt in card}
        ref = {dt: on_cpu(dt, card[dt][2]) for dt in card}
        # the bf16 floor: the CPU's fp32 call on the card's bf16 routing
        y32_on_bf16_route, _ = on_cpu("float32", card["bfloat16"][2])
    probs_floor = _rel(own["bfloat16"][0], own["float32"][0])
    y_floor = _rel(ref["bfloat16"][0], y32_on_bf16_route)
    for dt, (y, aux, (probs, _, topi)) in card.items():
        own_probs, own_topv, own_topi = own[dt]
        y_ref, aux_ref = ref[dt]
        delta = float((probs - own_probs).abs().max())
        chosen = own_probs.gather(-1, topi).min(-1).values
        tie_gap = float((own_topv[..., -1] - chosen).max())
        row = dict(
            y_rel=_rel(y, y_ref),
            y_bound=TOL["float32"] if dt == "float32" else 2 * y_floor,
            aux=aux, aux_rel=abs(aux - aux_ref) / abs(aux_ref),
            probs_rel=_rel(probs, own_probs),
            probs_bound=(TOL["float32"] if dt == "float32"
                         else 2 * probs_floor),
            probs_max_abs_delta=delta, topk_tie_gap=tie_gap,
            topk_changed_tokens=int((topi.sort(-1).values
                                     != own_topi.sort(-1).values)
                                    .any(-1).sum()),
            drops=_capacity_drops([card[dt][2]], cfg, T))
        if dt == "bfloat16":
            row.update(y_floor=y_floor, probs_floor=probs_floor)
        out[dt] = row
        if not (row["y_rel"] <= row["y_bound"] and row["aux_rel"] <= 1e-5
                and row["probs_rel"] <= row["probs_bound"]
                and tie_gap <= delta and row["drops"]["dropped"] > 0):
            raise AssertionError(f"moe_apply on the card vs the CPU, {dt}: "
                                 f"{row}")
    return out


def _arch_batch(cfg) -> dict:
    """The phase's inputs from seed 0: ARCH_BATCH prompts of ARCH_PROMPT
    tokens (after a VLM's prefix embeddings, as the CLI draws them), or
    the encoder's frame embeddings."""
    from repro_torch.configs import make_inputs
    from repro_torch.launch import serve
    from repro_torch.models.config import ShapeConfig
    if cfg.is_encoder:
        return make_inputs(cfg, ShapeConfig("encode", "prefill", ARCH_PROMPT,
                                            ARCH_BATCH), 0, "cuda")
    return serve.make_batch(cfg, ARCH_BATCH, ARCH_PROMPT, 0, "cuda")


def _arch_cfg(name: str, layers: int = None):
    from repro_torch.configs import get_arch
    cfg = get_arch(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


def _flash_shapes(cfg, T: int) -> list:
    """The distinct flash calls of one prefill (or encode) of cfg at B 4
    × T tokens: (Hq, Hkv, T, D, causal, window) and the attention blocks
    (or shared-block calls) each serves."""
    from repro_torch.models.config import ATTN_KINDS
    kinds = [k for k in cfg.block_kinds() if k in ATTN_KINDS]
    kinds += ["attn"] * (cfg.num_groups if cfg.shared_attn else 0)
    shapes = {}
    for kind in kinds:
        window = cfg.sliding_window if kind == "local" else None
        key = (cfg.num_heads, cfg.num_kv_heads, T, cfg.hd, kind != "enc",
               window)
        shapes[key] = shapes.get(key, 0) + 1
    return [dict(Hq=k[0], Hkv=k[1], T=k[2], D=k[3], causal=k[4],
                 window=k[5], layers=n) for k, n in shapes.items()]


def _attention_calls(cfg) -> int:
    """Flash launches of one prefill: one per attention block and one
    per shared-block call (one per group)."""
    return sum(shape["layers"] for shape in _flash_shapes(cfg, 0))


def _flash_at(shape: dict, seed: int) -> dict:
    """The bf16 flash kernel at one served shape (B 4): kernel, plain and
    SDPA ms, the bound (window-masked pairs excluded) and the kernel's
    error against its plain version. SDPA is a timed yardstick only: with
    a window it gets an explicit mask and kv repeated to Hq heads."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import (attention_mask,
                                         multi_head_attention_ref)
    B, Hq, Hkv, T, D = (ARCH_BATCH, shape["Hq"], shape["Hkv"], shape["T"],
                        shape["D"])
    kw = dict(causal=shape["causal"], window=shape["window"])
    q, k, v = _flash_inputs(B, Hq, Hkv, T, T, D, torch.bfloat16, seed)
    y = fa.flash_attention(q, k, v, **kw)
    ref = multi_head_attention_ref(q, k, v, **kw)
    err = float((y.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    launch_kw = dict(kw, softcap=None, scale=1.0 / D ** 0.5)
    row = dict(shape, B=B, dtype="bfloat16", max_abs_err=err,
               tol=TOL["bfloat16"] * scale)
    row["ms"] = _time_ms(lambda: fa._launch(q, k, v, **launch_kw), 10)
    row["plain_ms"] = _time_ms(
        lambda: multi_head_attention_ref(q, k, v, **kw), 3)
    mask = attention_mask(T, T, kw["causal"], kw["window"], "cuda")
    row["visible_pairs"] = int(mask.sum())
    row["flops"] = 4.0 * B * Hq * D * row["visible_pairs"]
    row["bound_ms"], row["bound_by"] = _bound(row["flops"], (q, k, v, y),
                                              torch.bfloat16)
    if kw["window"] is None:
        def library():
            return F.scaled_dot_product_attention(
                q, k, v, is_causal=kw["causal"], enable_gqa=True)
    else:
        kr = k.repeat_interleave(Hq // Hkv, dim=1)
        vr = v.repeat_interleave(Hq // Hkv, dim=1)

        def library():
            return F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask)
    row["library_max_abs_err_vs_plain"] = float(
        (library().float() - ref.float()).abs().max())
    row["library_ms"] = _time_ms(library, 10)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["vs_library"] = row["ms"] / row["library_ms"]
    if not err <= row["tol"]:
        raise AssertionError(f"flash at a served shape disagrees with its "
                             f"plain version: {row}")
    return row


def _arch_parity(name: str, cfg, batch, launches_per_call: int) -> dict:
    """Kernel vs plain attention, prefill(S) vs prefill(S-1) + decode (or,
    for the encoder, kernel vs plain encode), and the bf16 floor (plain
    bf16 vs plain fp32, the same params) on `cfg`."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import multi_head_attention_ref as plain
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.spec import init_tree

    encoder = cfg.is_encoder
    S = ARCH_PROMPT
    max_seq = cfg.num_prefix_embeddings + S + ARCH_GEN
    routes_k, routes_p, moe_in = [], [], []
    with torch.no_grad():
        params = serve.init_params(cfg, 0, "cuda")
        caches = None if encoder else init_tree(
            lm.spec_caches(cfg, ARCH_BATCH, max_seq), torch.Generator(),
            "cuda")
        before = fa.LAUNCHES_SM90
        with _recorded_routes(routes_k), _first_moe_input(moe_in):
            kern = lm.encode(params, cfg, batch) if encoder else \
                lm.prefill(params, cfg, batch, caches)[0]
        if fa.LAUNCHES_SM90 - before != launches_per_call:
            raise AssertionError(f"{name} parity copy: "
                                 f"{fa.LAUNCHES_SM90 - before} flash "
                                 f"launches, expected {launches_per_call}")
        with _recorded_routes(routes_p):
            pl = lm.encode(params, cfg, batch, attn_fn=plain) if encoder \
                else lm.prefill(params, cfg, batch, _zeroed(caches),
                                attn_fn=plain)[0]
        dec = None if encoder else _prefill_then_decode(
            lm, params, cfg, batch, caches, S)
        if cfg.num_experts:
            # the served prefill drops assignments past an expert's
            # capacity and decode drops none, so prefill(S) and
            # prefill(S-1) + decode differ by design wherever the last
            # token lost one; they are held equal on a copy whose
            # capacity (C = T) no expert can overflow
            dropless = dataclasses.replace(
                cfg, moe_capacity_factor=cfg.num_experts
                / cfg.experts_per_token)
            full_d = lm.prefill(params, dropless, batch,
                                _zeroed(caches))[0]
            dec_d = _prefill_then_decode(lm, params, dropless, batch,
                                         caches, S)
        moe_check = _moe_card_vs_cpu(cfg, *moe_in) \
            if name == ARCH_MOE_CPU else None
        del params, caches, moe_in
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        params32 = init_tree(lm.spec_params(cfg32), torch.Generator(
            device="cuda").manual_seed(0), "cuda")
        if encoder:
            pl32 = lm.encode(params32, cfg32, batch, attn_fn=plain)
        else:
            caches32 = init_tree(lm.spec_caches(cfg32, ARCH_BATCH, max_seq),
                                 torch.Generator(), "cuda")
            pl32 = lm.prefill(params32, cfg32, batch, caches32,
                              attn_fn=plain)[0]
            del caches32
        del params32
    floor = _rel(pl, pl32)
    out = dict(layers=cfg.num_layers, bf16_kernel_vs_plain=_rel(kern, pl),
               bf16_plain_vs_fp32=floor, bf16_kernel_vs_fp32=_rel(kern, pl32),
               bf16_bound=2 * floor,
               finite=bool(torch.isfinite(kern).all()))
    if not encoder:
        out["bf16_prefill_vs_decode"] = _rel(dec, kern)
    if cfg.num_experts:
        out["route_changes_kernel_vs_plain"] = _route_changes(routes_k,
                                                              routes_p)
        out["capacity_drops"] = _capacity_drops(
            routes_k, cfg, batch["tokens"].shape[1])
        out["bf16_prefill_vs_decode_served"] = out.pop(
            "bf16_prefill_vs_decode")
        out["bf16_prefill_vs_decode"] = _rel(dec_d, full_d)
    if moe_check is not None:
        out["moe_card_vs_cpu"] = moe_check
    return out


def _serve_arch(name: str) -> dict:
    """The main path of one arch, its launches counted from 0: the CLI
    (`serve.main`), dbrx at ARCH_DBRX_LAYERS layers through the steps,
    hubert through `make_encode_step`."""
    import torch
    from repro_torch.dist.steps import (make_decode_step, make_encode_step,
                                        make_prefill_step)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve

    start = _reset_peak_memory()
    if name in ARCH_CLI + ARCH_SSM:
        fa.LAUNCHES = fa.LAUNCHES_SM90 = 0
        out = serve.main(["--arch", name, "--batch", str(ARCH_BATCH),
                          "--prompt-len", str(ARCH_PROMPT), "--gen",
                          str(ARCH_GEN), "--seed", "0"])
        counts = (fa.LAUNCHES, fa.LAUNCHES_SM90)
        res = dict(first_prefill_s=out["prefill_s"],
                   decode_tok_s=out["decode_tok_s"],
                   decode_steps=out["decode_steps"],
                   launches=out["launches"],
                   finite=bool(torch.isfinite(out["prefill_logits"]).all()
                               and torch.isfinite(out["last_logits"]).all()))
    elif name == "dbrx-132b":
        cfg = _arch_cfg(name, ARCH_DBRX_LAYERS)
        max_seq = ARCH_PROMPT + ARCH_GEN
        params, caches = serve.init_serving(cfg, ARCH_BATCH, max_seq, 0,
                                            "cuda")
        batch = _arch_batch(cfg)
        prefill_fn, decode_fn = make_prefill_step(cfg), make_decode_step(cfg)
        with torch.no_grad():
            fa.LAUNCHES = fa.LAUNCHES_SM90 = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = prefill_fn(params, batch, caches)
            torch.cuda.synchronize()
            t_prefill = time.perf_counter() - t0
            n_prefill = fa.LAUNCHES
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            t0 = time.perf_counter()
            for i in range(ARCH_GEN - 1):
                tok, last, caches = decode_fn(params, tok, caches,
                                              ARCH_PROMPT + i)
            torch.cuda.synchronize()
            t_decode = time.perf_counter() - t0
            counts = (fa.LAUNCHES, fa.LAUNCHES_SM90)
        res = dict(first_prefill_s=t_prefill,
                   decode_tok_s=ARCH_BATCH * (ARCH_GEN - 1) / t_decode,
                   decode_steps=ARCH_GEN - 1,
                   launches={"prefill": n_prefill,
                             "decode": counts[0] - n_prefill},
                   finite=bool(torch.isfinite(logits).all()
                               and torch.isfinite(last).all()))
        del params, caches
    else:                                           # hubert-xlarge
        cfg = _arch_cfg(name)
        params = serve.init_params(cfg, 0, "cuda")
        batch = _arch_batch(cfg)
        encode_fn = make_encode_step(cfg)
        with torch.no_grad():
            fa.LAUNCHES = fa.LAUNCHES_SM90 = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = encode_fn(params, batch)
            torch.cuda.synchronize()
            t_encode = time.perf_counter() - t0
            counts = (fa.LAUNCHES, fa.LAUNCHES_SM90)
        res = dict(first_prefill_s=t_encode,
                   launches={"encode": counts[0]},
                   logits_shape=list(logits.shape),
                   finite=bool(torch.isfinite(logits).all()))
        del params
    res.update(launches_total=counts[0], launches_sm90=counts[1],
               peak=_peak_memory(start))
    return res


def _warm_arch(name: str, cfg) -> dict:
    """Warm prefill (or encode) seconds, decode-step ms and one warm
    prefill under torch.profiler, on freshly drawn params."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm

    batch = _arch_batch(cfg)
    with torch.no_grad():
        if cfg.is_encoder:
            params = serve.init_params(cfg, 0, "cuda")

            def forward():
                return lm.encode(params, cfg, batch)
        else:
            max_seq = cfg.num_prefix_embeddings + ARCH_PROMPT + ARCH_GEN
            params, caches = serve.init_serving(cfg, ARCH_BATCH, max_seq, 0,
                                                "cuda")

            def forward():
                return lm.prefill(params, cfg, batch, caches)[0]
        warm = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = forward()
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        res = dict(prefill_warm_s=warm,
                   prefill_warm_median_s=float(np.median(warm)))
        res["profile"] = _profile(forward, top_n=6)
        if not cfg.is_encoder:
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            pos = cfg.num_prefix_embeddings + ARCH_PROMPT
            steps = []
            for i in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, caches = lm.decode_step(params, cfg, tok, caches, pos + i)
                tok = lg.argmax(-1).to(torch.int32)[:, None]
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t0)
            res["decode_step_median_ms"] = float(np.median(steps)) * 1e3
    return res


def phase_lm_archs(results: dict, smi: str, names=ARCH_NAMES_14,
                   tag: str = "lm-archs", result_key: str = "lm_archs"
                   ) -> dict:
    """Phase 14 (the other attention-only LMs, `names` by default) and
    phase 15 (the SSM and hybrid LMs): serve each at its published
    width; returns the flash launches per arch and the kernel rows of
    the new flash shapes."""
    import torch

    archs, shape_rows, launches = {}, {}, {}
    for name in names:
        t_arch = time.perf_counter()
        cfg = _arch_cfg(name, ARCH_DBRX_LAYERS if name == "dbrx-132b"
                        else None)
        L = cfg.num_layers
        n = _attention_calls(cfg)
        # --- the main path: the launch counts start at 0 inside -------
        res = _serve_arch(name)
        # -----------------------------------------------------------------
        expect = {"encode": n} if cfg.is_encoder else {"prefill": n,
                                                       "decode": 0}
        ssm = set(cfg.block_kinds()) & {"mamba2", "mlstm", "slstm"}
        print(f"[{tag}] {name} ({L} layers{' of 40' if name == 'dbrx-132b' else ''}"
              f", d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
              f"D {cfg.hd}"
              + (f"; {'+'.join(sorted(ssm))} mixers" if ssm else "")
              + (f", {n} shared-block calls" if cfg.shared_attn else "")
              + f"): flash launches {res['launches']} (expected "
              f"{expect}), of them the bf16 wgmma kernel "
              f"{res['launches_sm90']}; logits finite: {res['finite']}; "
              f"first {'encode' if cfg.is_encoder else 'prefill'} "
              f"{res['first_prefill_s']:.4f} s"
              + ("" if cfg.is_encoder else
                 f"; decode {res['decode_tok_s']:.1f} tok/s over "
                 f"{res['decode_steps']} steps")
              + f"; peak {res['peak']['peak_gib']:.2f} GiB  ({smi})")
        if res["launches"] != expect or res["launches_total"] != n \
                or res["launches_sm90"] != n or not res["finite"]:
            raise AssertionError(f"{name} serving: {res}")
        launches[name] = res["launches"]
        res.update(_warm_arch(name, cfg))
        prof = res["profile"]
        print(f"[{tag}] {name}: warm {'encode' if cfg.is_encoder else 'prefill'} "
              f"{res['prefill_warm_median_s']:.4f} s (median of 3)"
              + ("" if cfg.is_encoder else
                 f", decode step {res['decode_step_median_ms']:.3f} ms "
                 f"(median of 5)") + f"  ({smi})")
        _print_profile(f"{tag} {name} profile", prof)
        for shape in _flash_shapes(cfg, cfg.num_prefix_embeddings
                                   + ARCH_PROMPT):
            key = tuple(shape[k] for k in ("Hq", "Hkv", "T", "D", "causal",
                                           "window"))
            if key not in shape_rows:
                row = _flash_at(shape, seed=len(shape_rows))
                row["archs"] = {}
                shape_rows[key] = row
                print(f"[{tag}] flash B {ARCH_BATCH} {shape['Hq']}/"
                      f"{shape['Hkv']} T {shape['T']} D {shape['D']} "
                      f"{'causal' if shape['causal'] else 'non-causal'}"
                      f"{'' if shape['window'] is None else ' window ' + str(shape['window'])}: "
                      f"kernel {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} "
                      f"ms ({row['bound_by']}, {100 * row['bound_share']:.1f}%), "
                      f"plain {row['plain_ms']:.4f} ms, sdpa "
                      f"{row['library_ms']:.4f} ms (kernel / sdpa = "
                      f"{row['vs_library']:.2f}); max|Δ| vs plain "
                      f"{row['max_abs_err']:.3e} (tol {row['tol']:.3e})  ({smi})")
            shape_rows[key]["archs"][name] = shape["layers"]
        pcfg = _arch_cfg(name, ARCH_PARITY_LAYERS.get(
            name, cfg.num_layers))
        par = _arch_parity(name, pcfg, _arch_batch(pcfg),
                           _attention_calls(pcfg))
        res["parity"] = par
        msg = (f"[{tag}] {name} parity ({par['layers']} layers, full "
               f"width): bf16 kernel vs plain rel "
               f"{par['bf16_kernel_vs_plain']:.3e}")
        if "bf16_prefill_vs_decode" in par:
            msg += (f", prefill(S) vs prefill(S-1) + decode rel "
                    f"{par['bf16_prefill_vs_decode']:.3e}")
        msg += (f" (bound 2 x the bf16 floor = {par['bf16_bound']:.3e}; "
                f"floor = plain bf16 vs plain fp32 "
                f"{par['bf16_plain_vs_fp32']:.3e}; kernel bf16 vs plain "
                f"fp32 {par['bf16_kernel_vs_fp32']:.3e})  ({smi})")
        if "route_changes_kernel_vs_plain" in par:
            rc = par["route_changes_kernel_vs_plain"]
            dr = par["capacity_drops"]
            msg += (f"; tokens whose top-{cfg.experts_per_token} changed, "
                    f"kernel vs plain: {rc['tokens']} of {rc['of_tokens']} "
                    f"({rc['token_layers']} token-layers over "
                    f"{rc['layers']} MoE layers); capacity {dr['capacity']}"
                    f" per expert and row, largest load {dr['max_load']}, "
                    f"{dr['dropped']} of {dr['of_assignments']} assignments "
                    f"dropped, {dr['last_token_dropped']} of them the last "
                    f"token's; the served prefill(S) vs prefill(S-1) + "
                    f"decode rel {par['bf16_prefill_vs_decode_served']:.3e} "
                    f"(drops included; the checked one above has capacity "
                    f"C = T)")
        print(msg)
        for dt, mc in par.get("moe_card_vs_cpu", {}).items():
            dr = mc["drops"]
            print(f"[{tag}] {name} layer-0 moe_apply at B {ARCH_BATCH} x "
                  f"{ARCH_PROMPT}, {dt}, card vs CPU on the card's routing: "
                  f"y rel {mc['y_rel']:.3e} (bound {mc['y_bound']:.3e}), aux "
                  f"{mc['aux']:.6f} rel {mc['aux_rel']:.3e} (bound 1e-5), "
                  f"{dr['dropped']} of {dr['of_assignments']} assignments "
                  f"dropped (capacity {dr['capacity']}); router probs rel "
                  f"{mc['probs_rel']:.3e} (bound {mc['probs_bound']:.3e}), "
                  f"{mc['topk_changed_tokens']} tokens with another top-"
                  f"{cfg.experts_per_token} than the CPU's (largest tie gap "
                  f"{mc['topk_tie_gap']:.3e} <= max|dprobs| "
                  f"{mc['probs_max_abs_delta']:.3e})  ({smi})")
        if not (par["finite"] and par["bf16_kernel_vs_plain"] <= par["bf16_bound"]
                and par.get("bf16_prefill_vs_decode", 0.0) <= par["bf16_bound"]):
            raise AssertionError(f"{name} parity: {par}")
        res["seconds"] = time.perf_counter() - t_arch
        print(f"[{tag}] {name}: {res['seconds']:.1f} s in this phase  "
              f"({smi})")
        archs[name] = res
        torch.cuda.empty_cache()
    results[result_key] = dict(gpu=smi, archs=archs,
                               flash_shapes=list(shape_rows.values()))
    return dict(launches=launches, flash_shapes=list(shape_rows.values()))


# ----------------------------------------------------------------------
# phase 16: LM training
# ----------------------------------------------------------------------
def _train_launches(cfg, microbatches: int, remat: bool = True) -> int:
    """Flash launches of one train step: each attention block (and
    shared-block invocation) of a group runs forward and, with remat,
    again in the backward's recompute; the tail is not checkpointed."""
    from repro_torch.models.config import ATTN_KINDS
    per_group = sum(k in ATTN_KINDS for k in cfg.pattern) \
        + int(cfg.shared_attn)
    tail = sum(k in ATTN_KINDS for k in cfg.tail)
    return microbatches * (cfg.num_groups * per_group * (1 + remat) + tail)


def _counts() -> tuple:
    from repro_torch.kernels import block_spmm
    from repro_torch.kernels import flash_attention as fa
    return (fa.LAUNCHES, fa.LAUNCHES_SM90, block_spmm.LAUNCHES,
            block_spmm.LAUNCHES_FUSED)


def _zero_counts() -> None:
    from repro_torch.kernels import block_spmm
    from repro_torch.kernels import flash_attention as fa
    fa.LAUNCHES = fa.LAUNCHES_SM90 = 0
    block_spmm.LAUNCHES = block_spmm.LAUNCHES_FUSED = 0


def _train_cli(argv: list) -> tuple:
    """`launch.train.main(argv)` with its stdout echoed and kept; the
    launch counts of the call, each from 0."""
    import io
    from repro_torch.launch import train

    buf = io.StringIO()
    _zero_counts()
    with contextlib.redirect_stdout(buf):
        out = train.main(argv)
    counts = _counts()
    sys.stdout.write(buf.getvalue())
    return out, buf.getvalue(), counts


def _grad_rel(got, want) -> float:
    """Largest per-leaf max|Δ| / max(1, max|want|)."""
    return max(float((g.float().cpu() - w.float().cpu()).abs().max())
               / max(1.0, float(w.float().abs().max()))
               for g, w in zip(got, want))


def _train_parity(smi: str) -> dict:
    """16b: one step of a 2-layer fp32 copy on the card vs the CPU, then
    the bf16 gradient through the kernel vs autograd of the plain
    version, against the bf16 floor."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.dist.sharding import CellPolicy
    from repro_torch.dist.steps import make_train_step, spec_train_state
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import multi_head_attention_ref
    from repro_torch.models import lm
    from repro_torch.models.spec import init_tree
    from repro_torch.nn.optim import adamw
    from repro_torch.nn.tree import tree_leaves, tree_map

    P = TRAIN_PARITY
    cfg = dataclasses.replace(get_arch("llama3.2-1b"),
                              num_layers=P["layers"], compute_dtype="float32")
    state = init_tree(spec_train_state(cfg),
                      torch.Generator().manual_seed(0), "cpu")
    toks = TokenPipeline(cfg.vocab_size, P["batch"], P["seq"],
                         seed=1).batch_at(0)["tokens"]
    policy = CellPolicy(microbatches=1, remat=True, loss_chunk=P["seq"])
    step = make_train_step(cfg, policy, adamw(1e-3, weight_decay=0.01,
                                              clip_norm=1.0))

    def grads(c, params, batch, attn_fn=None, remat=True,
              loss_chunk=P["seq"]):
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        kw = {} if attn_fn is None else dict(attn_fn=attn_fn)
        n0 = fa.LAUNCHES
        loss, _ = lm.lm_loss(live, c, batch, remat=remat,
                             loss_chunk=loss_chunk, **kw)
        n1 = fa.LAUNCHES
        g = torch.autograd.grad(loss, tree_leaves(live))
        return loss.detach(), g, (n1 - n0, fa.LAUNCHES - n1)

    out = {}
    for dev in ("cpu", "cuda"):
        st = tree_map(lambda t: t.to(dev), state)
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        loss, g, n = grads(cfg, st["params"], batch)
        t0 = time.perf_counter()
        _, metrics = step(st, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        out[dev] = dict(loss=float(loss), grads=[x.cpu() for x in g],
                        launches=n, metrics=metrics,
                        step_s=time.perf_counter() - t0)
        del st
    cpu, card = out["cpu"], out["cuda"]
    fp32 = dict(
        loss_rel=abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
        grad_rel=_grad_rel(card["grads"], cpu["grads"]),
        metrics_rel={k: abs(card["metrics"][k] - v) / max(1.0, abs(v))
                     for k, v in cpu["metrics"].items()},
        launches_fwd_bwd=card["launches"], cpu_launches=cpu["launches"],
        cpu_step_s=cpu["step_s"], card_step_s=card["step_s"])
    print(f"[lm-train] 16b {P['layers']}-layer fp32 copy, B {P['batch']} x "
          f"{P['seq']}, card vs CPU: loss rel {fp32['loss_rel']:.3e}, "
          f"grads {fp32['grad_rel']:.3e} (bound {STEP_TOL}·max(1, "
          f"max|g|)), step metrics "
          + ", ".join(f"{k} {v:.3e}" for k, v in fp32["metrics_rel"].items())
          + f"; flash launches forward/backward {card['launches']} (CPU "
          f"{cpu['launches']})  ({smi})")
    if not (fp32["loss_rel"] <= STEP_TOL and fp32["grad_rel"] <= STEP_TOL
            and max(fp32["metrics_rel"].values()) <= STEP_TOL
            and card["launches"] == (P["layers"], P["layers"])
            and cpu["launches"] == (0, 0)):
        raise AssertionError(f"training step card vs CPU: {fp32}")

    # bf16 on the card, at 16a's microbatch shape: the kernel's gradient
    # vs the plain version's
    G = TRAIN_GRAD_BF16
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    params = tree_map(lambda t: t.cuda(), state["params"])
    batch = {"tokens": torch.from_numpy(TokenPipeline(
        cfg.vocab_size, G["batch"], G["seq"], seed=1).batch_at(0)[
            "tokens"]).cuda()}
    kw = dict(loss_chunk=G["loss_chunk"])
    _, g_kern, n_kern = grads(cfg16, params, batch, **kw)
    _, g_kern_nr, n_nr = grads(cfg16, params, batch, remat=False, **kw)
    _, g_plain, n_plain = grads(cfg16, params, batch,
                                attn_fn=multi_head_attention_ref, **kw)
    _, g32, _ = grads(cfg, params, batch, attn_fn=multi_head_attention_ref,
                      **kw)
    floor = _grad_rel(g_plain, g32)
    bf16 = dict(shape=f"{P['layers']} layers, B {G['batch']} x {G['seq']}",
                kernel_vs_plain=_grad_rel(g_kern, g_plain),
                kernel_vs_fp32=_grad_rel(g_kern, g32), floor=floor,
                bound=2 * floor, launches_remat=n_kern,
                launches_no_remat=n_nr, launches_plain=n_plain,
                remat_vs_not=_grad_rel(g_kern, g_kern_nr))
    print(f"[lm-train] 16b bf16 on the card ({bf16['shape']}, 16a's "
          f"microbatch): gradient through the kernel "
          f"vs autograd of the plain version {bf16['kernel_vs_plain']:.3e} "
          f"(bound 2 x the bf16 floor = {bf16['bound']:.3e}; floor = plain "
          f"bf16 vs plain fp32 {floor:.3e}; kernel vs fp32 "
          f"{bf16['kernel_vs_fp32']:.3e}); remat on vs off "
          f"{bf16['remat_vs_not']:.3e}; flash launches forward/backward: "
          f"remat {n_kern}, no remat {n_nr}, plain {n_plain}  ({smi})")
    L = P["layers"]
    if not (bf16["kernel_vs_plain"] <= bf16["bound"]
            and n_kern == (L, L) and n_nr == (L, 0) and n_plain == (0, 0)):
        raise AssertionError(f"bf16 training gradient: {bf16}")
    return dict(fp32=fp32, bf16=bf16)


def _train_cfg(name: str):
    """(cfg, what was cut, whether the step holds AdamW state): full
    width, the largest number of groups whose params stay under
    TRAIN_CUT_PARAMS, at least one; a config above TRAIN_ADAM_PARAMS
    (dbrx-132b) takes the gradient alone."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.models.spec import spec_params
    full = get_arch(name)
    for g in range(full.num_groups, 0, -1):
        cfg = dataclasses.replace(
            full, num_layers=g * len(full.pattern) + len(full.tail))
        if spec_params(lm.spec_params(cfg)) <= TRAIN_CUT_PARAMS or g == 1:
            break
    n = spec_params(lm.spec_params(cfg))
    adam = n <= TRAIN_ADAM_PARAMS
    cut = "full depth" if cfg.num_layers == full.num_layers else \
        f"{cfg.num_layers} of {full.num_layers} layers"
    cut += f", {n / 1e9:.3f} B params"
    return cfg, cut + ("" if adam else ", gradient only (no AdamW state)"), \
        adam


def _grad_only_step(cfg, policy):
    """(state, batch) -> (state, metrics): `make_train_step`'s loss,
    acc and gradient norm, through `accumulate_gradients` of `lm_loss`,
    with no optimizer state and no update."""
    from repro_torch.models import lm
    from repro_torch.nn import accumulate_gradients
    from repro_torch.nn.optim import global_norm

    def loss_fn(params, mb):
        loss, metrics = lm.lm_loss(params, cfg, mb, remat=policy.remat,
                                   loss_chunk=policy.loss_chunk)
        return loss, {"acc": metrics["acc"]}

    def step(state, batch):
        loss, aux, grads = accumulate_gradients(
            loss_fn, state["params"], batch, policy.microbatches)
        return state, {"loss": loss, "acc": aux["acc"],
                       "grad_norm": global_norm(grads)}
    return step


def phase_lm_train(results: dict, smi: str, work: pathlib.Path) -> dict:
    """Phase 16: LM training through the CLI (a), card vs CPU and the
    bf16 gradient (b), one step of every other arch (c); returns the
    flash launches per training path."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCH_NAMES, get_arch, make_inputs
    from repro_torch.dist.sharding import CellPolicy
    from repro_torch.dist.steps import make_train_step, spec_train_state
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.spec import init_tree, spec_params
    from repro_torch.nn.optim import adamw, warmup_cosine_schedule

    cfg = get_arch("llama3.2-1b")
    per_step = _train_launches(cfg, 2)
    ck = work / "lm_ckpt"
    start = _reset_peak_memory()
    t0 = time.perf_counter()
    # --- the main path: the launch counts start at 0 inside -------------
    out1, _, n1 = _train_cli(TRAIN_ARGV + ["--steps", str(TRAIN_STEPS[0]),
                                           "--ckpt", str(ck)])
    t1 = time.perf_counter()
    out2, log2, n2 = _train_cli(TRAIN_ARGV + ["--steps", str(TRAIN_STEPS[1]),
                                              "--ckpt", str(ck)])
    # ---------------------------------------------------------------------
    t2 = time.perf_counter()
    peak = _peak_memory(start)
    hist = out1["history"] + out2["history"]
    losses = [r["loss"] for r in hist]
    step_s = [r["seconds"] for r in out1["history"][1:]
              + out2["history"][1:]]
    restored = f"restored checkpoint at step {TRAIN_STEPS[0]}" in log2
    a = dict(losses=losses, acc=[r["acc"] for r in hist],
             grad_norm=[r["grad_norm"] for r in hist],
             step_s=[r["seconds"] for r in hist],
             step_median_s=float(np.median(step_s)),
             call_s=[t1 - t0, t2 - t1], restored=restored,
             # outside the steps: init, the restore (the newest step is
             # verified, then read) and the final save of 15 GB of state
             outside_steps_s=[t1 - t0 - sum(r["seconds"]
                                            for r in out1["history"]),
                              t2 - t1 - sum(r["seconds"]
                                            for r in out2["history"])],
             launches={f"steps 1-{TRAIN_STEPS[0]}": n1[0],
                       f"steps {TRAIN_STEPS[0] + 1}-{TRAIN_STEPS[1]}":
                       n2[0]},
             launches_per_step=per_step, peak=peak)
    print(f"[lm-train] 16a llama3.2-1b (16 x 2048, "
          f"{spec_params(lm.spec_params(cfg)) / 1e9:.3f} B params), B 4 x "
          f"2048, 2 microbatches, remat: loss "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; step {a['step_median_s'] * 1e3:.1f} ms (median after the "
          f"first; first {hist[0]['seconds']:.2f} s); calls "
          f"{a['call_s'][0]:.1f} s and {a['call_s'][1]:.1f} s, of them "
          f"{a['outside_steps_s'][0]:.1f} s and "
          f"{a['outside_steps_s'][1]:.1f} s outside the steps (init, "
          f"checkpoint restore and save); restored at step "
          f"{TRAIN_STEPS[0]}: {restored}; flash launches {n1[0]} and "
          f"{n2[0]} ({per_step} a step expected), bf16 wgmma {n1[1]} and "
          f"{n2[1]}, GCN kernels {n1[2:] + n2[2:]}; peak "
          f"{peak['peak_gib']:.2f} GiB  ({smi})")
    steps1 = TRAIN_STEPS[0]
    steps2 = TRAIN_STEPS[1] - TRAIN_STEPS[0]
    if not (restored and out2["start_step"] == steps1
            and [r["step"] for r in hist] == list(
                range(1, TRAIN_STEPS[1] + 1))
            and all(np.isfinite(losses)) and losses[steps1 - 1] < losses[0]
            and n1 == (per_step * steps1, per_step * steps1, 0, 0)
            and n2 == (per_step * steps2, per_step * steps2, 0, 0)):
        raise AssertionError(f"LM training through the CLI: {a}")

    # one step under the profiler, from a fresh state
    state = init_tree(spec_train_state(cfg), torch.Generator(
        device="cuda").manual_seed(0), "cuda")
    step = make_train_step(cfg, CellPolicy(microbatches=2, loss_chunk=512),
                           adamw(warmup_cosine_schedule(1e-3, 10, 6),
                                 weight_decay=0.01, clip_norm=1.0))
    batch = {"tokens": torch.from_numpy(TokenPipeline(
        cfg.vocab_size, 4, 2048, seed=0).batch_at(0)["tokens"]).cuda()}
    state, _ = step(state, batch)
    holder = {}

    def one_step():
        holder["state"], _ = step(state, batch)
    a["profile"] = _profile(one_step, top_n=8)
    del state, holder
    torch.cuda.empty_cache()
    _print_profile("lm-train 16a step profile", a["profile"])
    results["lm_train"] = dict(gpu=smi, cli=a)

    results["lm_train"]["parity"] = _train_parity(smi)
    torch.cuda.empty_cache()

    others, launches = {}, {"llama3.2-1b": a["launches"]}
    for name in ARCH_NAMES:
        if name == "llama3.2-1b":
            continue
        c, cut, adam = _train_cfg(name)
        start = _reset_peak_memory()
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = make_inputs(c, ShapeConfig("train", "train",
                                           TRAIN_OTHER["seq"],
                                           TRAIN_OTHER["batch"]), 0, "cuda")
        policy = CellPolicy(microbatches=1, loss_chunk=512)
        if adam:
            state = init_tree(spec_train_state(c), gen, "cuda")
            step = make_train_step(c, policy, adamw(
                1e-3, weight_decay=0.01, clip_norm=1.0))
        else:
            state = {"params": init_tree(lm.spec_params(c), gen, "cuda")}
            step = _grad_only_step(c, policy)
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        seconds = time.perf_counter() - t0
        n = _counts()
        expect = _train_launches(c, 1)
        row = dict(cut=cut, layers=c.num_layers, metrics=metrics,
                   step_s=seconds, launches=n[0], expected=expect,
                   peak=_peak_memory(start))
        others[name] = row
        launches[name] = n[0]
        print(f"[lm-train] 16c {name} ({cut}), B {TRAIN_OTHER['batch']} x "
              f"{TRAIN_OTHER['seq']}: loss {metrics['loss']:.4f}, grad norm "
              f"{metrics['grad_norm']:.4f}, first step {seconds:.2f} s, "
              f"flash launches {n[0]} (expected {expect}), peak "
              f"{row['peak']['peak_gib']:.2f} GiB  ({smi})")
        del state, batch
        torch.cuda.empty_cache()
        if not (np.isfinite(metrics["loss"])
                and np.isfinite(metrics["grad_norm"])
                and n == (expect, expect, 0, 0)):
            raise AssertionError(f"{name} training step: {row}")
    results["lm_train"]["others"] = others
    return launches


# ----------------------------------------------------------------------
# phase 17: the sharding layer
# ----------------------------------------------------------------------
def _moment_grads(state) -> list:
    """The gradient leaves of a state after one AdamW step from zero
    moments without clipping: mu = (1 - b1)·g."""
    from repro_torch.nn.tree import tree_leaves
    return [(m.full_tensor() if hasattr(m, "full_tensor") else m)
            .float().cpu() / 0.1 for m in tree_leaves(state["mu"])]


def _shard_pair(cfg, mesh, batch: dict, layers_cut: str) -> dict:
    """One step of `make_train_step` sharded (FSDP on the mesh) and
    unsharded from the same state and batch: loss, the gradients
    (through AdamW's first moment), the new params, flash launches."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.dist.sharding import (CellPolicy, distribute_tree,
                                           make_rules, shardings_for)
    from repro_torch.dist.steps import make_train_step, spec_train_state
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.spec import init_tree
    from repro_torch.nn.optim import adamw
    from repro_torch.nn.tree import tree_leaves

    B, S = batch["tokens"].shape
    policy = CellPolicy(fsdp=True, microbatches=1, remat=True, loss_chunk=S)
    opt = adamw(1e-3, weight_decay=0.01)          # no clipping: mu = 0.1 g
    specs = spec_train_state(cfg)
    state = init_tree(specs, torch.Generator(device="cuda").manual_seed(0),
                      "cuda")
    plain_state, plain_m = make_train_step(
        cfg, dataclasses.replace(policy, fsdp=False), opt)(state, batch)
    plain = dict(loss=float(plain_m["loss"]), grads=_moment_grads(
        plain_state), params=[t.float().cpu() for t in tree_leaves(
            plain_state["params"])])
    del plain_state
    rules = make_rules(mesh, cfg, ShapeConfig("t", "train", S, B), policy)
    dstate = distribute_tree(state, shardings_for(specs, mesh, rules))
    del state
    step = make_train_step(cfg, policy, opt,
                           act_spec=(rules["batch"], None, None), mesh=mesh)
    torch.cuda.synchronize()
    # --- the main path: the launch counts start at 0 -------------------
    _zero_counts()
    new, metrics = step(dstate, batch)
    torch.cuda.synchronize()
    n = _counts()
    # ---------------------------------------------------------------------
    all_dt = all(isinstance(t, DTensor) for t in tree_leaves(new))
    sharded = dict(loss=float(metrics["loss"]), grads=_moment_grads(new),
                   params=[t.full_tensor().float().cpu()
                           for t in tree_leaves(new["params"])])
    del new, dstate
    torch.cuda.empty_cache()
    return dict(cut=layers_cut, plain=plain, sharded=sharded,
                all_dtensor=all_dt, launches=n,
                loss_rel=abs(sharded["loss"] - plain["loss"])
                / abs(plain["loss"]),
                grad_rel=_grad_rel(sharded["grads"], plain["grads"]),
                params_rel=_grad_rel(sharded["params"], plain["params"]))


def _shard_timed(cfg, mesh, smi: str) -> dict:
    """Step seconds (median after the first) and peak memory of the bf16
    step at SHARD_TIMED's shape, unsharded and sharded, in turns; the
    flash launches of each sharded run, counted from 0 (the host runs
    nothing else meanwhile)."""
    import numpy as np
    import torch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.dist.sharding import (CellPolicy, distribute_tree,
                                           make_rules, shardings_for)
    from repro_torch.dist.steps import make_train_step, spec_train_state
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.spec import init_tree
    from repro_torch.nn.optim import adamw

    T = SHARD_TIMED
    policy = CellPolicy(fsdp=True, microbatches=1, remat=True,
                        loss_chunk=512)
    specs = spec_train_state(cfg)
    rules = make_rules(mesh, cfg, ShapeConfig("t", "train", T["seq"],
                                              T["batch"]), policy)
    batch = {"tokens": torch.from_numpy(TokenPipeline(
        cfg.vocab_size, T["batch"], T["seq"], seed=0).batch_at(0)[
            "tokens"]).cuda()}
    opt = adamw(1e-3, weight_decay=0.01, clip_norm=1.0)
    out = {}
    for kind in ("plain", "sharded", "sharded", "plain"):
        start = _reset_peak_memory()
        state = init_tree(specs, torch.Generator(device="cuda")
                          .manual_seed(0), "cuda")
        if kind == "sharded":
            state = distribute_tree(state, shardings_for(specs, mesh, rules))
            step = make_train_step(cfg, policy, opt, act_spec=(
                rules["batch"], None, None), mesh=mesh)
        else:
            step = make_train_step(cfg, dataclasses.replace(
                policy, fsdp=False), opt)
        secs, losses = [], []
        torch.cuda.synchronize()
        # --- the main path (sharded runs): the counts start at 0 -------
        _zero_counts()
        for _ in range(T["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))        # ends synchronised
            secs.append(time.perf_counter() - t0)
        n = _counts()
        # -----------------------------------------------------------------
        del state
        row = out.setdefault(kind, dict(step_s=[], peak_gib=[], loss=[],
                                        launches=[]))
        row["launches"].append(n)
        row["step_s"].append(float(np.median(secs[1:])))
        row["peak_gib"].append(_peak_memory(start)["peak_gib"])
        row["loss"].append(losses)
        torch.cuda.empty_cache()
    for kind, row in out.items():
        print(f"[shard] 17a timed bf16 step ({T['layers']} of 16 layers, "
              f"full width, B {T['batch']} x {T['seq']}, remat), {kind}: "
              f"{' and '.join(f'{x * 1e3:.1f}' for x in row['step_s'])} ms "
              f"(median after the first of {T['steps']}), peak "
              f"{' and '.join(f'{x:.2f}' for x in row['peak_gib'])} GiB, "
              f"loss {row['loss'][0][0]:.4f}, flash launches "
              f"{' and '.join(str(n[0]) for n in row['launches'])}  ({smi})")
    # forward and remat recompute of every layer, every step, bf16 kernel
    expect = T["layers"] * 2 * T["steps"]
    out["launches_expected"] = expect
    if not (all(np.isfinite(x) for r in (out["plain"], out["sharded"])
                for l_ in r["loss"] for x in l_)
            and all(n == (expect, expect, 0, 0)
                    for n in out["sharded"]["launches"])):
        raise AssertionError(f"timed steps: {out}")
    return out


def _free_ports(n: int) -> list:
    """n distinct free ports (bound all at once while they are chosen)."""
    import socket
    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in range(n)]
        for s_ in socks:
            s_.bind(("127.0.0.1", 0))
        return [s_.getsockname()[1] for s_ in socks]


def _shard_cli(smi: str, port: int) -> dict:
    """17b: `launch/train.py --mesh host` under torchrun, one rank."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           "1", "--master_addr", "127.0.0.1", "--master_port",
           str(port), "-m", "repro_torch.launch.train", *SHARD_CLI]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=SHARD_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    mesh_line = [line for line in out.stdout.splitlines()
                 if "params, mesh" in line]
    res = dict(rc=out.returncode, seconds=seconds, steps=rows,
               mesh=mesh_line)
    print(f"[shard] 17b torchrun --nproc_per_node 1 launch.train "
          f"{' '.join(SHARD_CLI)}: rc {out.returncode} in {seconds:.1f} s; "
          f"{mesh_line[0].strip() if mesh_line else 'no mesh line'}; loss "
          + " ".join(f"{r['loss']:.4f}" for r in rows) + f"  ({smi})")
    import math as _m
    if not (out.returncode == 0 and [r["step"] for r in rows] == [1, 2]
            and all(_m.isfinite(r["loss"]) for r in rows)
            and mesh_line and "{'data': 1, 'model': 1} on cuda"
            in mesh_line[0]):
        raise AssertionError(f"train --mesh host under torchrun: {res}\n"
                             f"{out.stderr[-3000:]}")
    return res


def _shard_serve_cli(smi: str, port: int) -> dict:
    """17d: `launch/serve.py --mesh host` under torchrun, one rank."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           "1", "--master_addr", "127.0.0.1", "--master_port",
           str(port), "-m", "repro_torch.launch.serve",
           *SHARD_SERVE_CLI]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=SHARD_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    lines = [line.strip() for line in out.stdout.splitlines()
             if line.startswith("[serve]")]
    banner = [line for line in lines if "params, mesh" in line]
    res = dict(rc=out.returncode, seconds=seconds, lines=lines)
    print(f"[shard] 17d torchrun --nproc_per_node 1 launch.serve "
          f"{' '.join(SHARD_SERVE_CLI)}: rc {out.returncode} in "
          f"{seconds:.1f} s; " + "; ".join(lines) + f"  ({smi})")
    if not (out.returncode == 0 and banner
            and "{'data': 1, 'model': 1} on cuda" in banner[0]
            and any("prefill" in line for line in lines)):
        raise AssertionError(f"serve --mesh host under torchrun: {res}\n"
                             f"{out.stderr[-3000:]}")
    return res


def _dryrun_start(args: list):
    """Start a dry-run CLI on the host's CPU (no card visible to it), so
    it runs beside the card's work; `_dryrun_finish` reads it back."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return (args, time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env))


def _dryrun_finish(started, records: list) -> list:
    """Wait for a started dry-run (killed past DRYRUN_TIMEOUT_S) and read
    back its records (paths under results/dryrun_torch)."""
    args, t0, proc = started
    try:
        out, err = proc.communicate(
            timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    seconds = time.perf_counter() - t0
    for line in out.splitlines():
        print(f"[shard]   {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{args}: rc {proc.returncode}\n{err[-3000:]}")
    base = ROOT / "results" / "dryrun_torch"
    recs = [json.loads((base / r).read_text()) for r in records]
    for r in recs:
        r["cli_seconds"] = seconds
    return recs


def _shard_step(smi: str) -> dict:
    """17a: the sharded train step on a 1 x 1 mesh over an NCCL world of
    1 (the caller's) against the unsharded one (fp32, bf16), then the
    timed bf16 step."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import make_debug_mesh

    full = get_arch("llama3.2-1b")
    P = SHARD_PARITY
    mesh = make_debug_mesh(1, 1, device_type="cuda")
    cut = f"{P['layers']} of {full.num_layers} layers, full width"
    batch = {"tokens": torch.from_numpy(TokenPipeline(
        full.vocab_size, P["batch"], P["seq"], seed=1).batch_at(0)[
            "tokens"]).cuda()}
    pairs = {}
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(full, num_layers=P["layers"],
                                  compute_dtype=dt)
        pairs[dt] = _shard_pair(cfg, mesh, batch, cut)
    f32, b16 = pairs["float32"], pairs["bfloat16"]
    floor = _grad_rel(b16["plain"]["grads"], f32["plain"]["grads"])
    loss_floor = abs(b16["plain"]["loss"] - f32["plain"]["loss"]) \
        / abs(f32["plain"]["loss"])
    per_step = P["layers"] * 2            # forward and remat recompute
    a = dict(cut=cut, shape=f"B {P['batch']} x {P['seq']}",
             fp32={k: f32[k] for k in ("loss_rel", "grad_rel",
                                       "params_rel", "all_dtensor",
                                       "launches")},
             bf16={k: b16[k] for k in ("loss_rel", "grad_rel",
                                       "params_rel", "all_dtensor",
                                       "launches")},
             bf16_floor=floor, bf16_bound=2 * floor,
             bf16_loss_floor=loss_floor,
             launches_expected=per_step)
    for dt, r in (("fp32", a["fp32"]), ("bf16", a["bf16"])):
        print(f"[shard] 17a sharded step (NCCL world of 1, mesh 1 x 1, "
              f"FSDP, every state leaf a DTensor: {r['all_dtensor']}) vs "
              f"unsharded, llama3.2-1b {cut}, {a['shape']}, {dt}: loss "
              f"rel {r['loss_rel']:.3e}, grads {r['grad_rel']:.3e}, new "
              f"params {r['params_rel']:.3e} (bound "
              + (f"{STEP_TOL}·max(1, max|g|)" if dt == "fp32" else
                 f"2 x the bf16 floor = {a['bf16_bound']:.3e}, loss "
                 f"{2 * loss_floor:.3e}")
              + f"); flash launches {r['launches'][0]} (sm90 "
              f"{r['launches'][1]}; {per_step} expected)  ({smi})")
    ok32 = (f32["all_dtensor"] and f32["loss_rel"] <= STEP_TOL
            and f32["grad_rel"] <= STEP_TOL
            and f32["params_rel"] <= STEP_TOL
            and f32["launches"] == (per_step, 0, 0, 0))
    ok16 = (b16["all_dtensor"] and b16["grad_rel"] <= 2 * floor
            and b16["loss_rel"] <= 2 * loss_floor
            and b16["launches"] == (per_step, per_step, 0, 0))
    if not (ok32 and ok16):
        raise AssertionError(f"sharded train step: {a}")
    del pairs, f32, b16
    torch.cuda.empty_cache()
    cfg_t = dataclasses.replace(full, num_layers=SHARD_TIMED["layers"])
    a["timed"] = _shard_timed(cfg_t, mesh, smi)
    torch.cuda.empty_cache()
    return a


@contextlib.contextmanager
def _nccl_world():
    """An NCCL process group of one rank (this process, cuda:0), torn
    down on the way out."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def _phase8_margins(tokens):
    """Phase 8's greedy run replayed on one device, its tokens fed back:
    (B, gen) numpy, the gap between the two largest logits each token
    was taken from, over that step's max|logits|."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.dist.steps import make_decode_step, make_prefill_step
    from repro_torch.launch import serve

    cfg = get_arch("llama3.2-1b")
    B, S = tokens.shape[0], int(LM_ARGV[LM_ARGV.index("--prompt-len") + 1])
    G = tokens.shape[1]
    params, caches = serve.init_serving(cfg, B, S + G, 0, "cuda")
    batch = serve.make_batch(cfg, B, S, 0, "cuda")
    tok = torch.from_numpy(tokens).cuda()

    def gap(lg):
        top = lg.topk(2, -1).values
        return ((top[:, 0] - top[:, 1]) / lg.abs().max()).cpu()
    with torch.no_grad():
        logits, caches = make_prefill_step(cfg)(params, batch, caches)
        out = [gap(logits)]
        decode = make_decode_step(cfg)
        for i in range(G - 1):
            _, logits, caches = decode(params, tok[:, i:i + 1], caches, S + i)
            out.append(gap(logits))
    del params, caches
    torch.cuda.empty_cache()
    return torch.stack(out, 1).numpy()


def _shard_serve(smi: str, results: dict) -> dict:
    """17d: `launch.serve.main` with phase 8's argv and `--mesh host` in
    this process's NCCL world of 1 (a 1 x 1 mesh: DTensor params and
    caches, flash under `local_map`, the vocab-parallel argmax) against
    phase 8's one-device run of the same argv: flash launches, the
    prefill logits (bit-equal expected; else within twice the bf16
    floor) and the greedy tokens (all equal; else equal in each row up
    to the first step whose top-2 gap is within twice that bound)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve

    layers = get_arch("llama3.2-1b").num_layers
    print(f"[shard] 17d serve {' '.join(LM_ARGV)} --mesh host")
    # --- the main path: the launch counts start at 0 -------------------
    _zero_counts()
    out = serve.main(LM_ARGV + ["--mesh", "host"])
    n = _counts()
    # ---------------------------------------------------------------------
    p8 = _PHASE8
    bound = 2 * results["lm_parity"]["bf16_plain_vs_fp32"]
    got, want = out["prefill_logits"], p8["prefill_logits"]
    bit_equal = bool(torch.equal(got, want))
    rel = _rel(got, want)
    tokens_equal = bool(np.array_equal(out["tokens"], p8["tokens"]))
    agree = None
    if not bit_equal:
        gaps = _phase8_margins(p8["tokens"])
        close = gaps < 2 * bound
        agree = [int(np.argmax(row)) if row.any() else len(row)
                 for row in close]
    res = dict(mesh=out["mesh"], launches=out["launches"],
               launches_total=n[0], launches_sm90=n[1],
               prefill_s=out["prefill_s"], decode_tok_s=out["decode_tok_s"],
               phase8_prefill_s=p8["prefill_s"],
               phase8_decode_tok_s=p8["decode_tok_s"],
               prefill_bit_equal=bit_equal, prefill_rel=rel, bound=bound,
               tokens_equal=tokens_equal, agree_until=agree,
               finite=bool(torch.isfinite(got).all()
                           and torch.isfinite(out["last_logits"]).all()))
    print(f"[shard] 17d {out['mesh']}: prefill {out['prefill_s']:.4f} s "
          f"(phase 8 {p8['prefill_s']:.4f} s), decode "
          f"{out['decode_tok_s']:.1f} tok/s (phase 8 "
          f"{p8['decode_tok_s']:.1f}); prefill logits bit-equal to phase "
          f"8's: {bit_equal} (rel {rel:.3e}, bound {bound:.3e}); tokens "
          f"equal: {tokens_equal}"
          + ("" if agree is None else f" (rows agree up to {agree})")
          + f"; flash launches prefill {out['launches']['prefill']}, decode "
          f"{out['launches']['decode']} ({layers}, 0 expected; sm90 "
          f"{n[1]})  ({smi})")
    toks_ok = tokens_equal or (not bit_equal and all(
        np.array_equal(g[:k], w[:k]) for g, w, k in zip(
            out["tokens"], p8["tokens"], agree)))
    if not (res["finite"] and out["launches"] == {"prefill": layers,
                                                  "decode": 0}
            and n[:2] == (layers, layers)
            and (bit_equal or rel <= bound) and toks_ok):
        raise AssertionError(f"sharded serving: {res}")
    return res


def _dryruns_start() -> list:
    """Phase 17c's dry-runs, started (`_dryrun_start`): the LM cells of
    DRYRUN_LM, then the GCN variants last."""
    return [_dryrun_start(["repro_torch.launch.dryrun", "--arch", arch,
                           "--shape", "train_4k", "--mesh", "pod",
                           "--force"]) for arch in DRYRUN_LM] + [
        _dryrun_start(["repro_torch.launch.dryrun_gcn", "--variant",
                       "all"])]


def phase_shard(results: dict, smi: str, procs: list) -> dict:
    """Phase 17: the sharded train step on the card (a), the CLI's
    `--mesh host` under torchrun (b), the dry-runs on the host (c), whose
    processes join `procs`; returns the flash launches of (a)'s sharded
    steps."""
    from repro_torch.launch.mesh import (HARDWARE, HBM_BW, NVLINK_BW,
                                         PEAK_FLOPS_BF16)

    out = {}
    with _nccl_world():
        out["sharded_step"] = _shard_step(smi)
        out["sharded_serve"] = _shard_serve(smi, results)
    # (c) starts once (a) and (d)'s timed runs are done: the dry-runs use
    # the host's CPU only, so they run beside the CLIs and time nothing
    dry = _dryruns_start()
    procs += [proc for _, _, proc in dry]
    dry_lm, dry_gcn = dry[:-1], dry[-1]
    # both CLIs at once: each is a world of 1 on its own port, and neither
    # times more than its own wall
    ports = _free_ports(2)
    with ThreadPoolExecutor(2) as pool:
        cli = pool.submit(_shard_cli, smi, ports[0])
        serve_cli = pool.submit(_shard_serve_cli, smi, ports[1])
        out["cli"], out["serve_cli"] = cli.result(), serve_cli.result()

    lm = [rec for arch, started in zip(DRYRUN_LM, dry_lm)
          for rec in _dryrun_finish(started, [
              f"{arch}__train_4k__pod__baseline.json"])]
    gcn_variants = ("base", "bf16", "ax", "tp", "q4", "sparse", "sparsek")
    gcn = _dryrun_finish(dry_gcn, [
        f"clustergcn-ppi-sota__train_cluster__pod__{v}.json"
        for v in gcn_variants])
    dry_s = time.perf_counter() - min(t0 for _, t0, _ in dry)
    rows = []
    for rec in lm + gcn:
        r = rec["roofline"]
        row = dict(what=f"{rec['arch']} {rec['shape']} {rec['tag']}",
                   status=rec["status"], flops=rec["flops_per_device"],
                   bytes=rec["bytes_accessed_per_device"],
                   collective_bytes=r["collective_bytes"],
                   collectives=rec["collectives"],
                   peak_bytes=rec["memory"]["peak_memory_in_bytes"],
                   roofline=r, trace_s=rec.get("trace_s"))
        rows.append(row)
        print(f"[shard] 17c dry-run {row['what']} on the (16, 16) mesh, per "
              f"device: {row['flops']:.4e} FLOP, {row['bytes']:.4e} B, "
              f"collectives {row['collective_bytes']:.4e} B "
              f"({', '.join(f'{k} x{int(v['count'])}' for k, v in rec['collectives'].items())}), "
              f"peak {row['peak_bytes'] / 2**30:.2f} GiB; roofline at "
              f"{HARDWARE} constants ({PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s "
              f"bf16, {HBM_BW / 1e12:.2f} TB/s, NVLink "
              f"{NVLINK_BW / 1e9:.0f} GB/s): {r['bound_s'] * 1e3:.3f} ms "
              f"(compute {r['compute_s'] * 1e3:.3f}, memory "
              f"{r['memory_s'] * 1e3:.3f}, collectives "
              f"{r['collective_s'] * 1e3:.3f}); traced in "
              f"{row['trace_s']} s")
    base = gcn[0]
    n_ar = base["collectives"].get("all-reduce", {}).get("count")
    ratio = base["flops_per_device"] / GCN_REF_FLOPS
    print(f"[shard] 17c gcn base: {ratio:.4f} x the reference's 1-device "
          f"step ({GCN_REF_FLOPS:.4e} FLOP, jax 0.9 on the CPU); "
          f"{n_ar} gradient all-reduce; dry-runs read back {dry_s:.1f} s "
          f"after their start, beside (b)")
    if not (all(r["status"] == "ok" for r in lm + gcn) and n_ar == 1
            and abs(ratio - 1) <= 0.02
            and gcn[3]["flops_per_device"] < base["flops_per_device"]):
        raise AssertionError(f"dry-runs: {rows}")
    out["dryrun"] = dict(rows=rows, seconds=dry_s, gcn_ref_ratio=ratio)
    results["shard"] = out
    a = out["sharded_step"]
    return {"train sharded (phase 17)": a["fp32"]["launches"][0]
            + a["bf16"]["launches"][0]
            + sum(n[0] for n in a["timed"]["sharded"]["launches"]),
            "serve sharded (phase 17d)":
            out["sharded_serve"]["launches_total"]}


GRAPH_ARRAYS = ("indptr", "indices", "data", "features", "labels",
                "train_mask", "val_mask", "test_mask")


def _save_graph(graph, path: pathlib.Path) -> None:
    """A CSRGraph's arrays as .npy files (uncompressed: seconds, where
    `CSRGraph.save`'s compressed npz of Amazon2M takes minutes)."""
    import numpy as np
    path.mkdir(parents=True, exist_ok=True)
    for k in GRAPH_ARRAYS:
        np.save(path / f"{k}.npy", getattr(graph, k))


def _load_graph(path: pathlib.Path):
    import numpy as np
    from repro_torch.graph.csr import CSRGraph
    return CSRGraph(**{k: np.load(path / f"{k}.npy") for k in GRAPH_ARRAYS})


@contextlib.contextmanager
def _prepared_graph(spec, graph):
    """While the body runs (a CLI, which builds its own graph),
    `build_graph` of `spec`'s data section returns `graph`, the graph the
    prep child generated from that same section (the generators are
    seeded, so it is the graph a fresh build makes), instead of
    generating it again: ≈100 s for Amazon2M on the card's host. Fails
    unless the body built a graph and every one it built was `graph`.
    With no graph, the body runs as it is."""
    if graph is None:
        yield
        return
    from repro_torch.core import experiment
    taken = []

    def wrap(build):
        def prepared(s):
            taken.append(s.data == spec.data)
            return graph if taken[-1] else build(s)
        return prepared
    with _patched(experiment, "build_graph", wrap):
        yield
    if not taken or not all(taken):
        raise AssertionError(f"{spec.data.name}: a build_graph in the CLI "
                             f"did not take the prep child's graph "
                             f"(taken: {taken})")


def _write_json(path: pathlib.Path, obj) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(obj))
    tmp.replace(path)                    # the parent polls `path`


def scale_prep(out_dir: str, name: str) -> int:
    """`chip_smoke.py --scale-prep <dir> <preset>`: generate the preset's
    phase-18 graph, save its arrays under <dir>/<preset>/
    (`_save_graph`) and write <dir>/<preset>.graph.json; then partition
    it through the preset's host stages, into the partition cache under
    $REPRO_DATASETS_CACHE that phase 18's builds read, and write
    <dir>/<preset>.json."""
    import resource
    import numpy as np
    from repro_torch.core.experiment import build_graph, build_partition
    from repro_torch.launch.run_experiment import load_spec

    t_start, out = time.perf_counter(), pathlib.Path(out_dir)
    spec = load_spec(_spec_args(SCALE_SETS, name))
    t0 = time.perf_counter()
    graph = build_graph(spec)
    generate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _save_graph(graph, out / name)
    row = dict(nodes=graph.num_nodes, edge_slots=graph.num_edges,
               generate_s=generate_s, save_s=time.perf_counter() - t0,
               graph_dir=str(out / name),
               graph_ready_s=time.perf_counter() - t_start)
    _write_json(out / f"{name}.graph.json", row)
    parts, stats = build_partition(spec, graph)
    sizes = np.bincount(parts, minlength=stats.num_parts)
    row.update(partition_s=stats.seconds, cached=stats.cached,
               num_parts=stats.num_parts, nonempty=int((sizes > 0).sum()),
               within_fraction=stats.within_fraction,
               imbalance=stats.imbalance, min_part=stats.min_part,
               max_part=stats.max_part,
               ready_s=time.perf_counter() - t_start,
               peak_rss_gib=resource.getrusage(resource.RUSAGE_SELF)
               .ru_maxrss / 2 ** 20)
    _write_json(out / f"{name}.json", row)
    print(f"[scale-prep] {name}: {row}", flush=True)
    return 0


def host_oracle(name: str, scale: str = "1.0") -> int:
    """`chip_smoke.py --host-oracle <preset> [scale]`: the host oracle's
    full-graph evaluation (`core/trainer.py` `full_graph_logits`, behind
    every evaluation and serving's parity check) of the preset's model,
    seeded init, on its phase-18 graph at `scale`, timed with Â's
    products split by rows over the host's cores (`host_spmm`) and with
    one scipy call each, in turns (rows, one call, rows); the logits of
    both must be bit-equal. Needs no card; not part of a default run."""
    import numpy as np
    import torch
    from repro_torch.core import trainer
    from repro_torch.core.experiment import build_gcn_config, build_graph
    from repro_torch.core.gcn import init_params
    from repro_torch.launch.run_experiment import load_spec

    spec = load_spec(_spec_args(SCALE_SETS + [f"data.scale={scale}"], name))
    graph = build_graph(spec)
    cfg = build_gcn_config(spec, graph)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    one_call = functools.partial(_patched, trainer, "host_spmm",
                                 lambda _: lambda a, x: a @ x)
    rows, runs = contextlib.nullcontext, []
    for label, ctx in (("rows", rows), ("one call", one_call),
                       ("rows", rows)):
        with ctx():
            t0 = time.perf_counter()
            logits = trainer.full_graph_logits(
                params, graph, cfg, spec.batch.norm, spec.batch.diag_lambda)
            runs.append((label, time.perf_counter() - t0, logits))
    try:
        card = _smi()
    except (OSError, subprocess.CalledProcessError):
        card = "no card"
    print(f"[host-oracle] {name} at scale {scale}: {graph.num_nodes} nodes, "
          f"{graph.num_edges} edge slots, {cfg.num_layers} layers x "
          f"{cfg.hidden_dim}; {os.cpu_count()} host cores ({card})")
    for label, secs, _ in runs:
        print(f"[host-oracle] full_graph_logits, {label}: {secs:.3f} s")
    same = all(np.array_equal(runs[0][2], r[2]) for r in runs[1:])
    print(f"[host-oracle] logits bit-equal: {same}")
    return 0 if same else 1


def _scale_prep_start(work: pathlib.Path) -> dict:
    """One `--scale-prep` child per preset, each on one host core without
    the card, writing into this run's dataset cache."""
    out = work / "scale_prep"
    out.mkdir()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1",
               REPRO_DATASETS_CACHE=str(work / "datasets"))
    prep = {}
    for name in SCALE_PRESETS:
        log = out / f"{name}.log"
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--scale-prep",
                 str(out), name], env=env, cwd=str(ROOT), stdout=f,
                stderr=subprocess.STDOUT)
        prep[name] = dict(proc=proc, out=out, log=log)
    return prep


def _scale_prep_wait(prep: dict, name: str, stage: str) -> dict:
    """The `--scale-prep` child's row for preset `name` once its graph
    (stage "graph") or its partition (stage "partition", and the child
    has exited) is ready, waiting at most SCALE_PREP_TIMEOUT_S; a failed
    child fails the run."""
    child, t0 = prep[name], time.perf_counter()
    path = child["out"] / (f"{name}.graph.json" if stage == "graph"
                           else f"{name}.json")
    while True:
        rc = child["proc"].poll()
        if rc not in (None, 0) or (rc == 0 and not path.exists()):
            raise AssertionError(f"the {name} prep child exited {rc}: "
                                 f"{child['log'].read_text()[-3000:]}")
        if path.exists() and (rc == 0 or stage == "graph"):
            break
        if time.perf_counter() - t0 > SCALE_PREP_TIMEOUT_S:
            child["proc"].kill()
            child["proc"].wait()
            raise AssertionError(f"the {name} prep child gave no {stage} "
                                 f"within {SCALE_PREP_TIMEOUT_S} s")
        time.sleep(1.0)
    r = json.loads(path.read_text())
    print(f"[scale] {name} prep child: {stage} ready "
          f"{r['ready_s' if stage == 'partition' else 'graph_ready_s']:.1f} "
          f"s after the child's start (one host core); phase 18 waited "
          f"{time.perf_counter() - t0:.1f} s for it")
    if stage == "graph":
        print(f"[scale] {name}: {r['nodes']} nodes, {r['edge_slots']} edge "
              f"slots, generated in {r['generate_s']:.2f} s")
    else:
        print(f"[scale] {name}: partition into {r['num_parts']} parts "
              f"({r['nonempty']} non-empty) in {r['partition_s']:.2f} s, "
              f"within-cluster share {r['within_fraction']:.4f}, imbalance "
              f"{r['imbalance']:.4f} (sizes {r['min_part']}-"
              f"{r['max_part']}); the child's peak RSS "
              f"{r['peak_rss_gib']:.2f} GiB")
    return r


@contextlib.contextmanager
def _recorded_partitions(store: list):
    """Record `stats.cached` of every `build_partition` while the body
    runs (build_experiment, the serving engine, this script)."""
    from repro_torch.core import experiment

    def wrap(build):
        def recording(spec, graph):
            parts, stats = build(spec, graph)
            store.append(stats.cached)
            return parts, stats
        return recording
    with _patched(experiment, "build_partition", wrap):
        yield


def _batch_shape(exp) -> tuple:
    """(nrb, K) of the first block-ELL batch of an experiment's epoch 0
    (the tile shape of its compact adjacency)."""
    adj = next(iter(exp.batcher.epoch(0))).adj
    return tuple(int(n) for n in adj.shape[:2])


def _scale_kernels(results: dict, name: str, nrb: int, K: int,
                   smi: str) -> list:
    """The fused kernel at the recipe's layer widths and the SpMM at its
    backward widths (transposed tiles, row_k_t given, every slot live),
    fp32, on one real batch's nrb x K at B 128, against their plain
    versions and themselves, with the library yardstick."""
    import torch
    rows = []
    for n, (D, F) in enumerate(SCALE_FUSED[name]):
        row = _fused_case(results, 2000 + 10 * n, nrb, K, 128, nrb, D, F,
                          torch.float32, "full", library=True)
        _print_vs_library(f"fused {D} -> {F} ({name}, {smi})", row,
                          "addmm+bmm")
        rows.append(dict(row, preset=name, kernel="block_ell_spmm_fused"))
    for n, F in enumerate(SCALE_BWD[name]):
        row = _spmm_case(results, 2100 + 10 * n, nrb, K, 128, nrb, F,
                         torch.float32, "full", library=True)
        _print_vs_library(f"spmm backward F {F} ({name}, {smi})", row, "bmm")
        rows.append(dict(row, preset=name, kernel="block_ell_spmm"))
    return rows


def _scale_vrgcn(results: dict, graph, cfg, spec, smi: str) -> dict:
    """VR-GCN (r 2, batch 512, AdamW 1e-2) one epoch on the card, on the
    graph and model config the Cluster-GCN run trains."""
    from repro_torch.core import baselines
    from repro_torch.core.experiment import build_optimizer

    steps = max(1, int(graph.train_mask.sum()) // BASELINE_BATCH)
    mem0 = _reset_peak_memory()
    res = baselines.train_vrgcn(graph, cfg, build_optimizer(spec), 1,
                                batch_size=BASELINE_BATCH, r=2,
                                device="cuda")
    memory = _peak_memory(mem0)
    want = 2 * graph.num_nodes * cfg.hidden_dim * 4
    row = dict(epochs=1, steps_per_epoch=steps,
               losses=[h["loss"] for h in res["history"]],
               epoch_s=_epoch_seconds(res["history"]),
               history_bytes=res["history_bytes"],
               history_bytes_expected=want, **memory)
    results["amazon2m_vrgcn"] = row
    print(f"[table8] vrgcn: {steps} steps, loss {row['losses']}, epoch "
          f"{row['epoch_s'][0]:.3f} s, peak device memory "
          f"{memory['peak_gib']:.3f} GiB, host history "
          f"{res['history_bytes']} bytes (expected 2 x N x "
          f"{cfg.hidden_dim} x 4 = {want})  ({smi})")
    if res["history_bytes"] != want or \
            not all(math.isfinite(x) for x in row["losses"]):
        raise AssertionError(f"VR-GCN on amazon2m: {row}")
    return row


def _table8(results: dict, smi: str) -> None:
    """Cluster-GCN against VR-GCN on the same Amazon2M graph, the paper's
    Table 8 beside (whole trainings on its own hardware)."""
    cl, vr = results["amazon2m_train"], results["amazon2m_vrgcn"]
    table = {"cluster_gcn": dict(
        epochs=2, steps_per_epoch=cl["steps"] // 2, epoch_s=cl["epoch_s"],
        peak_gib=cl["peak_gib"], host_history_bytes=0),
        "vrgcn": dict(epochs=1, steps_per_epoch=vr["steps_per_epoch"],
                      epoch_s=vr["epoch_s"], peak_gib=vr["peak_gib"],
                      host_history_bytes=vr["history_bytes"])}
    results["table8"] = dict(this_run=table, paper={
        k: dict(train_s=v[0], memory_gb=v[1])
        for k, v in PAPER_TABLE8.items()}, gpu=smi)
    print(f"[table8] amazon2m, 2,449,029 nodes, 3 x 400, on {smi}")
    print(f"[table8] {'method':<12} {'epochs':>6} {'steps/ep':>8} "
          f"{'epoch s':>18} {'peak GiB':>9} {'host history B':>15}   "
          f"paper: training s, memory GB")
    for k, v in table.items():
        secs = ", ".join(f"{x:.3f}" for x in v["epoch_s"])
        print(f"[table8] {k:<12} {v['epochs']:>6} {v['steps_per_epoch']:>8} "
              f"{secs:>18} {v['peak_gib']:9.3f} "
              f"{v['host_history_bytes']:>15}   {PAPER_TABLE8[k][0]} s, "
              f"{PAPER_TABLE8[k][1]} GB")


def _scale_serving_cluster(results: dict, exp, smi: str) -> dict:
    """Serving's tiles for one median-size Amazon2M cluster (the rows of
    Â against all ⌈N/128⌉ column blocks, as `full_graph_embeddings`
    builds them) at layer 1's width: K, tile bytes, host build, copy and
    kernel ms, the product against its plain version, and the same
    arithmetic for every cluster and layer. Measured, not changed."""
    import numpy as np
    import torch
    from repro_torch.graph.normalization import normalize_csr
    from repro_torch.kernels.block_spmm import spmm_block_ell
    from repro_torch.kernels.ref import spmm_block_ell_ref
    from repro_torch.serve.embedding_cache import _cluster_tiles, _pad_to

    graph, parts, B = exp.graph, exp.parts, 128
    t0 = time.perf_counter()
    ip, ix, dt = normalize_csr(graph.indptr, graph.indices, graph.data,
                               exp.spec.batch.norm, exp.spec.batch.diag_lambda)
    normalize_s = time.perf_counter() - t0
    sizes = np.bincount(parts)
    c = int(np.argsort(sizes, kind="stable")[len(sizes) // 2])
    rows = np.where(parts == c)[0]
    n_pad = _pad_to(graph.num_nodes, B)
    t0 = time.perf_counter()
    blocks, cols = _cluster_tiles(ip, ix, dt, rows, n_pad, B)
    build_ms = (time.perf_counter() - t0) * 1e3
    nrb, K = blocks.shape[:2]
    live = int((np.abs(blocks).reshape(nrb, K, -1).max(-1) > 0).sum())
    x = torch.randn(n_pad, SCALE_SERVE_WIDTH, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bd = torch.from_numpy(blocks).cuda()
    cd = torch.from_numpy(cols).cuda()
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3
    y = spmm_block_ell(bd, cd, x)
    ref = spmm_block_ell_ref(bd, cd, x)
    err = float((y - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    ms = _time_ms(lambda: spmm_block_ell(bd, cd, x), 5)
    clusters, layers = int((sizes > 0).sum()), exp.cfg.num_layers
    row = dict(cluster=c, rows=len(rows), nrb=nrb, K=K, live_tiles=live,
               column_blocks=n_pad // B, tile_bytes=blocks.nbytes,
               normalize_s=normalize_s, host_build_ms=build_ms,
               copy_ms=copy_ms, kernel_ms=ms, max_abs_err=err,
               tol=TOL["float32"] * scale, clusters=clusters, layers=layers,
               whole_graph_tile_bytes=blocks.nbytes * clusters * layers,
               whole_graph_s=(build_ms + copy_ms + ms) / 1e3 * clusters
               * layers)
    results["amazon2m_serving_cluster"] = row
    print(f"[scale] amazon2m serving, one cluster ({len(rows)} rows, "
          f"median size): nrb {nrb} x K {K} of {n_pad // B} column blocks "
          f"({live} tiles hold a nonzero), {blocks.nbytes / 1e6:.1f} MB of "
          f"tiles; host build {build_ms:.1f} ms, copy {copy_ms:.1f} ms, "
          f"kernel {ms:.3f} ms at F {SCALE_SERVE_WIDTH}; max|Δ| vs plain "
          f"{err:.3e} (tol {row['tol']:.3e}); x {clusters} clusters x "
          f"{layers} layers: {row['whole_graph_tile_bytes'] / 1e12:.2f} TB "
          f"of tiles, ≈{row['whole_graph_s']:.0f} s  ({smi})")
    if not err <= row["tol"]:
        raise AssertionError(f"the serving cluster's product disagrees "
                             f"with its plain version: {row}")
    del x, bd, cd, y, ref
    torch.cuda.empty_cache()
    return row


def _scale_reddit(results: dict, work: pathlib.Path, smi: str,
                  graph) -> dict:
    """reddit at scale 1.0 on its prepared graph: train 2 epochs through
    the CLI, the step split and one step card vs CPU, serve the
    checkpoint, the kernels at its widths. Returns the launches of its
    main paths."""
    trained = phase_train(results, work, "reddit", SCALE_SETS,
                          key="reddit_train", tag="scale reddit",
                          graph=graph)
    exp = _step_parts(SCALE_SETS, "reddit", graph)
    nrb, K = _batch_shape(exp)
    results["reddit_node_cap"] = exp.batcher.node_cap
    print(f"[scale] reddit: node_cap {exp.batcher.node_cap}, a batch's "
          f"block-ELL nrb {nrb} x K {K}")
    phase_step_profile(results, exp, key="reddit_step", tag="reddit step")
    phase_step_parity(results, exp, key="reddit_parity",
                      tag="reddit parity")
    phase_step_graph(results, exp, key="reddit_step_graph",
                     tag="reddit step graph")
    del exp
    serve_launches, *_ = _serve_checkpoint(
        results, work, trained["checkpoint"], "reddit", SCALE_SETS,
        key="reddit_serve", tag="scale reddit serve", graph=graph)
    results.setdefault("scale_kernels", []).extend(
        _scale_kernels(results, "reddit", nrb, K, smi))
    return {"reddit_train": trained["launches"],
            "reddit_serve": {"block_ell_spmm": serve_launches,
                             "block_ell_spmm_fused": 0}}


def _scale_amazon2m(results: dict, work: pathlib.Path, smi: str,
                    graph) -> dict:
    """amazon2m at scale 1.0 on its prepared graph: train 2 epochs
    through the CLI (epoch s,
    peak memory, host-evaluated test accuracy), the step split and one
    step card vs CPU, the kernels at its widths, Table 8 beside the
    VR-GCN run, one serving cluster measured. Returns the launches of
    its main path."""
    import torch
    trained = phase_train(results, work, "amazon2m", SCALE_SETS,
                          key="amazon2m_train", tag="scale amazon2m",
                          graph=graph)
    t = results["amazon2m_train"]
    print(f"[scale] amazon2m: epoch s {t['epoch_s']}, peak device memory "
          f"{t['peak_gib']:.3f} GiB, final {t['final']['split']} accuracy "
          f"{t['final']['score']:.4f} (host evaluation)  ({smi})")
    exp = _step_parts(SCALE_SETS, "amazon2m", graph)
    nrb, K = _batch_shape(exp)
    results["amazon2m_node_cap"] = exp.batcher.node_cap
    print(f"[scale] amazon2m: node_cap {exp.batcher.node_cap}, a batch's "
          f"block-ELL nrb {nrb} x K {K}")
    phase_step_profile(results, exp, key="amazon2m_step",
                       tag="amazon2m step")
    phase_step_parity(results, exp, key="amazon2m_parity",
                      tag="amazon2m parity")
    phase_step_graph(results, exp, key="amazon2m_step_graph",
                     tag="amazon2m step graph")
    results.setdefault("scale_kernels", []).extend(
        _scale_kernels(results, "amazon2m", nrb, K, smi))
    _table8(results, smi)
    _scale_serving_cluster(results, exp, smi)
    del exp
    torch.cuda.empty_cache()
    return {"amazon2m_train": trained["launches"]}


def phase_scale(results: dict, work: pathlib.Path, smi: str,
                prep: dict) -> dict:
    """Phase 18: reddit and amazon2m at scale 1.0 on the block-ELL
    kernels, Table 8 on the Amazon2M graph, Reddit served. Returns the
    kernel launches of each main path."""
    import torch

    from repro_torch.core.experiment import build_gcn_config
    from repro_torch.launch.run_experiment import load_spec

    def graph_of(name):
        r = _scale_prep_wait(prep, name, "graph")
        t0 = time.perf_counter()
        graph = _load_graph(pathlib.Path(r["graph_dir"]))
        print(f"[scale] {name}: the prep child's graph loaded in "
              f"{time.perf_counter() - t0:.1f} s (saved in "
              f"{r['save_s']:.1f} s)")
        return graph

    launches, cached = {}, []
    with _recorded_partitions(cached):
        graph = graph_of("reddit")
        rows = {"reddit": _scale_prep_wait(prep, "reddit", "partition")}
        launches.update(_scale_reddit(results, work, smi, graph))
        # VR-GCN needs no partition: it runs while amazon2m's is computed
        spec = load_spec(_spec_args(SCALE_SETS, "amazon2m"))
        graph = graph_of("amazon2m")
        _scale_vrgcn(results, graph, build_gcn_config(spec, graph), spec,
                     smi)
        rows["amazon2m"] = _scale_prep_wait(prep, "amazon2m", "partition")
        launches.update(_scale_amazon2m(results, work, smi, graph))
    results["scale_prep"] = rows
    del graph
    torch.cuda.empty_cache()
    results["scale_partition_cached"] = cached
    print(f"[scale] {len(cached)} partition builds in this phase, cached: "
          f"{cached}")
    if not cached or not all(c is True for c in cached):
        raise AssertionError("a phase-18 build partitioned anew instead of "
                             f"reading the prep child's cache: {cached}")
    return launches


def main() -> int:
    import torch
    if len(sys.argv) == 4 and sys.argv[1] == "--dp-worker":
        return dp_worker(sys.argv[2], sys.argv[3])
    if len(sys.argv) == 4 and sys.argv[1] == "--scale-prep":
        return scale_prep(sys.argv[2], sys.argv[3])
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--host-oracle":
        return host_oracle(*sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs "
              "only on a GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    run_t0 = time.perf_counter()
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke-"))
    old_cache = os.environ.get("REPRO_DATASETS_CACHE")
    os.environ["REPRO_DATASETS_CACHE"] = str(work / "datasets")
    procs = []                 # every child process this run starts
    try:
        return _run(run_t0, work, procs)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if old_cache is None:
            os.environ.pop("REPRO_DATASETS_CACHE", None)
        else:
            os.environ["REPRO_DATASETS_CACHE"] = old_cache
        os.environ.pop("REPRO_DATASETS_MIRROR", None)
        shutil.rmtree(work, ignore_errors=True)


def _timed(phase_s: dict, label: str, fn, *args, **kw):
    """fn(*args, **kw), its wall seconds printed and kept under `label`."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    phase_s[label] = time.perf_counter() - t0
    print(f"[phase] {label}: {phase_s[label]:.1f} s")
    return out


def _run(run_t0: float, work: pathlib.Path, procs: list) -> int:
    """Every phase, in order (main() owns the work directory and stops
    the child processes listed in `procs`)."""
    import torch
    from repro_torch.kernels import _build

    smi = _smi()
    print(f"[build] {smi}")
    print(f"[build] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    builds = _build.build()
    build_s = time.perf_counter() - t0
    for b in builds:
        print(f"[build] {b.name}: {b.path.name} in {b.seconds:.2f} s"
              + (" (cached)" if b.cached else ""))
        if b.name in GCN_LIBS:
            continue             # summarised below, one line per library
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] all kernels built in {build_s:.2f} s")
    hgmma = _sass_count(_build.library_path("flash_attention_sm90"), "HGMMA")
    print(f"[build] flash_attention_sm90: {hgmma} HGMMA instructions in its "
          f"SASS")
    if hgmma == 0:
        raise AssertionError("the bf16 flash kernel has no wgmma (HGMMA) "
                             "instruction")
    gcn = {}
    logs = {b.name: b.log for b in builds}
    for name in GCN_LIBS:
        copies = _sass_count(_build.library_path(name), "LDGSTS", "UTMALDG")
        entries = _ptxas_entries(logs[name])
        spilled = [e for e in entries if e[2] or e[3]]
        gcn[name] = dict(async_copies=copies, entries=[
            dict(kernel=e[0], registers=e[1], spill_stores=e[2],
                 spill_loads=e[3]) for e in entries])
        regs = sorted({e[1] for e in entries})
        print(f"[build] {name}: {copies} asynchronous-copy instructions "
              f"(LDGSTS/UTMALDG) in its SASS; {len(entries)} kernels, "
              f"registers {regs}, {len(spilled)} with spills")
        if copies == 0:
            raise AssertionError(f"{name} has no cp.async/TMA instruction")
        if spilled or not entries:
            raise AssertionError(f"{name}: ptxas reports spills (or no "
                                 f"kernel): {spilled or logs[name]}")

    # phase 18's graphs and partitions, on the host beside phases 2-17
    prep = _scale_prep_start(work)
    procs += [child["proc"] for child in prep.values()]
    phase_s = {"1 build": time.perf_counter() - run_t0}
    results = {"gpu": smi, "build_s": build_s, "flash_sm90_hgmma": hgmma,
               "gcn_builds": gcn, "phase_s": phase_s,
               "kernel_cases": [], "fused_cases": [], "flash_cases": []}
    print(f"[phase] 1 build: {phase_s['1 build']:.1f} s")
    t = functools.partial(_timed, phase_s)
    spmm_rows = t("2 spmm kernels", phase_kernels, results)
    fused_row = t("2 fused kernels", phase_fused, results)
    scatter_rows = t("2 scatter kernel", phase_scatter, results)
    trained = t("3 train", phase_train, results, work)
    t("3 step profile", lambda: phase_step_profile(
        results, _step_parts(TRAIN_SETS)))
    t("4 step parity", lambda: phase_step_parity(
        results, _step_parts(TRAIN_SETS)))
    t("4 step graph", lambda: phase_step_graph(
        results, _step_parts(TRAIN_SETS)))
    t("5 unfused", phase_unfused, results, work)
    serve_launches = t("6 serve", phase_serve, results, work,
                       trained["checkpoint"])
    flash_row = t("7 flash", phase_flash, results)
    lm_launches = t("8 lm serve", phase_lm_serve, results)
    cold_launches = t("9 cold start", phase_cold_start, results, work)
    saint_launches = t("10 saint", phase_saint, results, work)
    t("11 baselines", phase_baselines, results)
    real_launches = t("12 real ppi", phase_real, results, work)
    dp_launches = t("13 data parallel", phase_dp, results, work)
    archs = t("14 lm archs", phase_lm_archs, results, smi)
    ssm = t("15 lm ssm", phase_lm_archs, results, smi, ARCH_SSM, "lm-ssm",
            "lm_ssm")
    train_launches = t("16 lm train", phase_lm_train, results, smi, work)
    shard_launches = t("17 shard", phase_shard, results, smi, procs)
    scale_launches = t("18 scale", phase_scale, results, work, smi, prep)
    results["wall_s"] = time.perf_counter() - run_t0
    print(f"[phase] whole run: {results['wall_s']:.1f} s  ({smi})")

    def numbers(row):
        return {k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}

    def gcn_numbers(row):
        # the GCN rows add their device time, factors and launch plan
        return dict(numbers(row), **{k: row[k] for k in (
            "device_ms", "library_device_ms", "vs_library",
            "device_vs_library", "bound_share") if k in row},
            plan=row.get("plan") or row.get("plans"))

    shape_keys = ("nrb", "K", "B", "ncb", "D", "F", "dtype", "row_k")
    serve, bwd = spmm_rows["serve"], spmm_rows["train_bwd"]
    def by_path(name):
        # the GCN paths that launch the kernel `name`, each counted from 0
        paths = {"train": trained["launches"][name],
                 "cold_start": cold_launches[name],
                 **{s: n[name] for s, n in saint_launches.items()},
                 "real_ppi": real_launches[name],
                 **{s: n[name] for s, n in dp_launches.items()},
                 **{s: n[name] for s, n in scale_launches.items()}}
        if name == "block_ell_spmm":
            paths["serve"] = serve_launches
        return paths

    def scale_rows(name):
        # phase 18's cases at the reddit and amazon2m widths
        return [dict(gcn_numbers(r), preset=r["preset"], shape={
            k: r[k] for k in shape_keys if k in r})
            for r in results["scale_kernels"] if r["kernel"] == name]

    spmm_paths = by_path("block_ell_spmm")
    fused_paths = by_path("block_ell_spmm_fused")
    # the paths that count the scatter: phase 3's and phase 18's training
    scatter_paths = {"train": trained["launches"]["block_ell_scatter"],
                     **{s: n["block_ell_scatter"]
                        for s, n in scale_launches.items()
                        if "block_ell_scatter" in n}}
    kernels = [{
        "name": "block_ell_spmm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_ell_spmm.cu",
        "replaces": "src/repro/kernels/block_spmm.py:103",
        "also_replaces": "src/repro/kernels/block_spmm.py:132",
        "launches": sum(spmm_paths.values()),
        "launches_by_path": spmm_paths,
        **gcn_numbers(serve),
        "shape": {k: serve[k] for k in shape_keys if k in serve},
        "train_bwd": dict(gcn_numbers(bwd), shape={
            k: bwd[k] for k in shape_keys if k in bwd}),
        "scale_shapes": scale_rows("block_ell_spmm"),
    }, {
        "name": "block_ell_spmm_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_ell_spmm_fused.cu",
        "replaces": "src/repro/kernels/block_spmm.py:254",
        "launches": sum(fused_paths.values()),
        "launches_by_path": fused_paths,
        **gcn_numbers(fused_row),
        "function_flops": fused_row["function_flops"],
        "kernel_flops": fused_row["kernel_flops"],
        "shape": {k: fused_row[k] for k in shape_keys if k in fused_row},
        "scale_shapes": scale_rows("block_ell_spmm_fused"),
    }, {
        "name": "block_ell_scatter",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_ell_scatter.cu",
        # no TPU kernel: the reference builds these tiles on the host
        "replaces": "src/repro/kernels/ops.py:475",
        "launches": sum(scatter_paths.values()),
        "launches_by_path": scatter_paths,
        **numbers(scatter_rows["reddit"]),
        "bitwise": scatter_rows["reddit"]["bitwise"],
        "shape": {k: scatter_rows["reddit"][k]
                  for k in ("nrb", "K", "B", "nnz")},
        "ppi": dict(numbers(scatter_rows["ppi"]),
                    bitwise=scatter_rows["ppi"]["bitwise"],
                    shape={k: scatter_rows["ppi"][k]
                           for k in ("nrb", "K", "B", "nnz")}),
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "fp32_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:27",
        "launches": lm_launches + sum(
            sum(n.values()) if isinstance(n, dict) else n for n in (
                *archs["launches"].values(), *ssm["launches"].values(),
                *train_launches.values())) + sum(shard_launches.values()),
        "launches_by_path": {"llama3.2-1b": results["lm_serve"]["launches"],
                             **archs["launches"], **ssm["launches"],
                             **{f"train {k}": n
                                for k, n in train_launches.items()},
                             **shard_launches},
        **numbers(flash_row),
        "fp32": dict(numbers(results["flash_main_fp32"]), **{
            k: results["flash_main_fp32"][k] for k in (
                "B", "Hq", "Hkv", "Tq", "Tk", "D", "dtype", "vs_library",
                "bound_share")}),
        "tflop_s": flash_row["tflop_s"],
        "shape": {k: flash_row[k] for k in ("B", "Hq", "Hkv", "Tq", "Tk",
                                            "D", "dtype", "mask")},
        "served_shapes": [dict(numbers(row), **{k: row[k] for k in (
            "B", "Hq", "Hkv", "T", "D", "causal", "window", "archs",
            "vs_library", "bound_share")})
            for row in archs["flash_shapes"] + ssm["flash_shapes"]],
    }]
    results["kernels"] = kernels
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
