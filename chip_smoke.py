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
   (`cuobjdump -sass`) and fails at 0.
2. Kernels vs their plain versions on the GPU, same inputs:
   `spmm_block_ell` over B in {8, 16, 128}, F in {1, 121, 2048}, fp32 and
   bf16, row_k None and given, K = 0, the ppi_sota serving cluster shape
   and the training backward's transposed shape (with row_k_t);
   `spmm_fused_block_ell` over B in {8, 16, 128}, D and F in {1, 121,
   2048}, fp32 and bf16, row_k None and given, K = 0, and the three
   ppi_sota training shapes (D 50 → F 2048, 2048 → 2048, 2048 → 121;
   nrb 3, K 3, B 128). Tolerance max|Δ| <= 1e-5·max(1, max|y_ref|) in
   fp32 (different summation order) and 8e-3·max(1, max|y_ref|) in bf16
   (one bf16 rounding of the output). Each case prints the error, kernel
   ms, plain ms and bound ms (CUDA events after warm-up); the main shapes
   also time one library call as a yardstick (torch.bmm on the gathered
   operands; torch.addmm then that bmm for the fused product) — timed
   only, the port never calls them.
3. Train ppi_sota (5 layers, 2048 wide, block-ELL batches, fused
   layers) for 2 epochs through `repro_torch.launch.run_experiment.main`
   — the main path: 5 fused launches and 5 block-ELL launches (the
   backward on the transposed tiles) per step, a finite loss that falls
   from epoch 1 to 2. Then where a step's time goes: host batch build
   vs device step (medians), and one step under torch.profiler (device
   time by kernel, idle share).
4. One-step parity: the same params and batch (dropout 0), `gcn_loss` +
   backward on the GPU (kernels) against the CPU (plain versions); loss
   within 1e-4 relative, grads within 1e-4·max(1, max|g_cpu|).
5. One epoch of the unfused path (`model.fuse_spmm=false`): 10 block-ELL
   launches per step, none fused.
6. Serve the checkpoint that phase 3 trained: `serve_gcn.main`
   precomputes the embedding cache and answers 1024 lookups; launch
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

Every count is set to 0 just before its path runs and read just after.
The last three lines of stdout are the nvidia-smi line, a JSON line of
per-kernel numbers (`{"kernels": [...]}`), and `{"ok": true, "device":
{...}}`. Full per-case results also go to chiprun_out/chip_smoke.json.
Datasets, partitions, checkpoints and the serving cache live in a
temporary directory that is removed at the end.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

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
SERVE_TOL = 1e-4
STEP_TOL = 1e-4
TRAIN_SETS = ["batch.sparse_adj=true", "model.fuse_spmm=true"]
# llama3.2-1b prefill: B 4, Hq 32 over Hkv 8, T 2048, head dim 64, bf16
FLASH_MAIN = dict(B=4, Hq=32, Hkv=8, Tq=2048, Tk=2048, D=64)
LM_ARGV = ["--arch", "llama3.2-1b", "--batch", "4", "--prompt-len", "2048",
           "--gen", "32", "--seed", "0"]
LM_TOL = 1e-2       # the reference's bound (tests/test_models.py)
LM_FP32_TOL = 1e-4  # fp32 logits: summation order over 16 layers


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _hgmma_count(lib: pathlib.Path) -> int:
    """HGMMA instructions in the SASS of a built library."""
    from repro_torch.kernels import _build
    cuobjdump = pathlib.Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return sum("HGMMA" in line for line in sass.splitlines())


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
    ok = err <= TOL[dname] * scale
    row.update(max_abs_err=err, max_abs_ref=scale, tol=TOL[dname] * scale,
               ok=ok)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{row}")


def phase_kernels(results: dict) -> dict:
    """The block-ELL SpMM against its plain version; returns the rows of
    the serving cluster shape (fp32) and the training backward shape."""
    import torch
    from repro_torch.kernels import block_spmm
    from repro_torch.kernels.ref import spmm_block_ell_ref

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
        blocks, cols, x, row_k = _case_inputs(nrb, K, B, ncb, F, dtype,
                                              mode, seed=n)
        y = block_spmm.spmm_block_ell(blocks, cols, x, row_k=row_k)
        torch.cuda.synchronize()
        ref = spmm_block_ell_ref(blocks, cols, x)
        err = float((y.float() - ref.float()).abs().max()) if y.numel() \
            else 0.0
        scale = max(1.0, float(ref.float().abs().max())) if y.numel() \
            else 1.0
        dname = str(dtype).replace("torch.", "")
        is_ppi = (nrb, K, B, ncb, F) == tuple(p.values())
        is_bwd = mode == "full"
        reps = 10 if (is_ppi or is_bwd) else 5
        ms = (_time_ms(lambda: block_spmm._launch(blocks, cols, x, row_k),
                       reps) if K else None)  # K = 0 launches nothing
        plain_ms = _time_ms(lambda: spmm_block_ell_ref(blocks, cols, x),
                            reps)
        row = dict(nrb=nrb, K=K, B=B, ncb=ncb, F=F, dtype=dname,
                   row_k=mode, ms=ms, plain_ms=plain_ms)
        flops = 2.0 * _live_slots(blocks, row_k) * B * B * F
        row["bound_ms"], row["bound_by"] = _bound(
            flops, (blocks, cols, x, y, row_k), dtype)
        if is_ppi or is_bwd:
            gathered = x.reshape(-1, B, F)[cols.long()].reshape(
                nrb, K * B, F)
            a = blocks.permute(0, 2, 1, 3).reshape(nrb, B, K * B)
            row["library_ms"] = _time_ms(lambda: torch.bmm(a, gathered),
                                         reps)
            del gathered, a
            if is_ppi and dtype == torch.float32 and mode is None:
                main["serve"] = row      # the shape and call serving makes
            if is_bwd and F == 2048:
                main["train_bwd"] = row  # the hidden layers' backward
        _check_case("block_ell_spmm", row, err, scale, dname)
        results["kernel_cases"].append(row)
        print(f"[kernels] spmm B={B:>3} F={F:>4} nrb={nrb} K={K:>3} "
              f"{dname:>8} row_k={mode or 'None':>5}  max|Δ|={err:.3e} "
              f"(tol {TOL[dname] * scale:.3e})  "
              f"kernel {'-' if ms is None else f'{ms:.4f}'} ms  "
              f"plain {plain_ms:.4f} ms  bound {row['bound_ms']:.4f} ms"
              + (f"  bmm {row['library_ms']:.4f} ms"
                 if "library_ms" in row else ""))
        del blocks, cols, x, y, ref
    return main


def _fused_inputs(nrb, K, B, ncb, D, F, dtype, mode, seed):
    import torch
    blocks, cols, _, row_k = _case_inputs(nrb, K, B, ncb, 1, dtype, mode,
                                          seed)
    g = torch.Generator().manual_seed(seed + 7)
    x = torch.randn(ncb * B, D, generator=g).to(dtype).cuda()
    w = (torch.randn(D, F, generator=g) / max(1, D) ** 0.5).to(dtype).cuda()
    b = torch.randn(F, generator=g).cuda()
    return blocks, cols, x, w, b, row_k


def phase_fused(results: dict) -> dict:
    """The fused Â·(XW + b) kernel against its plain version; returns the
    row of the ppi_sota hidden layer (2048 → 2048, fp32)."""
    import torch
    from repro_torch.kernels import block_spmm
    from repro_torch.kernels.ref import spmm_fused_ref

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
    main = None
    for n, (nrb, K, B, ncb, D, F, dtype, mode) in enumerate(cases):
        blocks, cols, x, w, b, row_k = _fused_inputs(nrb, K, B, ncb, D, F,
                                                     dtype, mode, seed=n)
        y = block_spmm.spmm_fused_block_ell(blocks, cols, x, w, b,
                                            row_k=row_k)
        torch.cuda.synchronize()
        ref = spmm_fused_ref(blocks, cols, x, w, b)
        err = float((y.float() - ref.float()).abs().max()) if y.numel() \
            else 0.0
        scale = max(1.0, float(ref.float().abs().max())) if y.numel() \
            else 1.0
        dname = str(dtype).replace("torch.", "")
        is_train = mode == "full"
        reps = 10 if is_train else 3
        ms = (_time_ms(lambda: block_spmm._launch_fused(blocks, cols, x, w,
                                                        b, row_k), reps)
              if K else None)
        plain_ms = _time_ms(lambda: spmm_fused_ref(blocks, cols, x, w, b),
                            reps)
        live = _live_slots(blocks, row_k)
        # the function: XW over every row of x once, then the live tiles;
        # the kernel recomputes XW per live slot, as the TPU kernel does
        fn_flops = 2.0 * x.shape[0] * D * F + 2.0 * live * B * B * F
        kernel_flops = live * (2.0 * B * D * F + 2.0 * B * B * F)
        row = dict(nrb=nrb, K=K, B=B, ncb=ncb, D=D, F=F, dtype=dname,
                   row_k=mode, ms=ms, plain_ms=plain_ms,
                   function_flops=fn_flops, kernel_flops=kernel_flops)
        row["bound_ms"], row["bound_by"] = _bound(
            fn_flops, (blocks, cols, x, w, b, y, row_k), dtype)
        if is_train and (D, F) == FUSED_MAIN:
            def library():
                xw = torch.addmm(b.to(x.dtype), x, w)
                gathered = xw.reshape(-1, B, F)[cols.long()].reshape(
                    nrb, K * B, F)
                return torch.bmm(
                    blocks.permute(0, 2, 1, 3).reshape(nrb, B, K * B),
                    gathered)
            row["library_ms"] = _time_ms(library, reps)
            if dtype == torch.float32:
                main = row
        _check_case("block_ell_spmm_fused", row, err, scale, dname)
        results["fused_cases"].append(row)
        print(f"[fused] B={B:>3} D={D:>4} F={F:>4} nrb={nrb} K={K} "
              f"{dname:>8} row_k={mode or 'None':>5}  max|Δ|={err:.3e} "
              f"(tol {TOL[dname] * scale:.3e})  "
              f"kernel {'-' if ms is None else f'{ms:.4f}'} ms  "
              f"plain {plain_ms:.4f} ms  bound {row['bound_ms']:.4f} ms"
              + (f"  addmm+bmm {row['library_ms']:.4f} ms"
                 if "library_ms" in row else ""))
        del blocks, cols, x, w, b, y, ref
    return main


def _train_argv(work: pathlib.Path, name: str, sets) -> list:
    argv = ["--preset", "ppi_sota", "--results-dir", str(work / name)]
    for s in sets:
        argv += ["--set", s]
    return argv


def phase_train(results: dict, work: pathlib.Path) -> dict:
    """Train ppi_sota 2 epochs through the CLI — the main path."""
    from repro_torch.kernels import block_spmm
    from repro_torch.launch import run_experiment

    ck = work / "train_ck"
    argv = _train_argv(work, "train", TRAIN_SETS + [
        "run.epochs=2", "run.eval_every=2", f"run.checkpoint_dir={ck}"])
    print(f"[train] run_experiment {' '.join(argv)}")
    t0 = time.perf_counter()
    # --- the main path: every launch count starts at 0 here -------------
    block_spmm.LAUNCHES = 0
    block_spmm.LAUNCHES_FUSED = 0
    rc = run_experiment.main(argv)
    launches = {"block_ell_spmm": block_spmm.LAUNCHES,
                "block_ell_spmm_fused": block_spmm.LAUNCHES_FUSED}
    # ---------------------------------------------------------------------
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"run_experiment returned {rc}")
    metrics = json.loads((work / "train" / "ppi_sota" / "metrics.json")
                         .read_text())
    steps = metrics["global_step"]
    losses = [h["loss"] for h in metrics["history"]]
    print(f"[train] {steps} steps in {wall:.2f} s (incl. data, partition, "
          f"eval); epoch losses {losses}; final "
          f"{metrics['final']['split']} micro-F1 "
          f"{metrics['final']['score']:.4f}")
    print(f"[train] launches: fused {launches['block_ell_spmm_fused']}, "
          f"block_ell_spmm {launches['block_ell_spmm']} (expected 5 x "
          f"{steps} each)")
    results["train"] = dict(steps=steps, wall_s=wall, launches=launches,
                            history=metrics["history"],
                            final=metrics["final"],
                            seconds=metrics["seconds"])
    if steps != 100 or launches["block_ell_spmm_fused"] != 5 * steps \
            or launches["block_ell_spmm"] != 5 * steps:
        raise AssertionError(f"expected 100 steps with 5 launches of each "
                             f"kernel per step: {steps} steps, {launches}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[1] < losses[0]:
        raise AssertionError(f"loss not finite or not falling: {losses}")
    return dict(launches=launches, checkpoint=ck)


def _step_parts(spec_sets):
    from repro_torch.core.experiment import build_experiment
    from repro_torch.launch.run_experiment import load_spec
    import argparse
    args = argparse.Namespace(preset="ppi_sota", spec=None, set=spec_sets)
    return build_experiment(load_spec(args), device="cuda")


def phase_step_profile(results: dict) -> None:
    """Where a training step's time goes: host batch build, the
    payload's copy to the device, and the step (medians over an epoch's
    first 20 steps, each part synchronised), and one step under
    torch.profiler."""
    import numpy as np
    import torch
    from repro_torch.core.batching import batch_to_device

    exp = _step_parts(TRAIN_SETS)
    backend, engine = exp.engine.backend, exp.engine
    state = engine.init_state()
    build, copy, step = [], [], []
    it = iter(exp.batcher.epoch(0))
    for _ in range(20):
        t0 = time.perf_counter()
        payload = next(it).astuple()
        build.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload = batch_to_device(payload, "cuda")
        torch.cuda.synchronize()
        copy.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        state, loss, _ = backend.step(state, payload)
        torch.cuda.synchronize()
        step.append(time.perf_counter() - t0)
    payload = batch_to_device(next(it).astuple(), "cuda")
    prof = _profile(lambda: backend.step(state, payload), top_n=8)
    results["train_step"] = dict(
        host_build_ms=float(np.median(build)) * 1e3,
        copy_ms=float(np.median(copy)) * 1e3,
        step_ms=float(np.median(step)) * 1e3, profiled_step=prof)
    print(f"[step] host batch build {np.median(build) * 1e3:.3f} ms, "
          f"copy to device {np.median(copy) * 1e3:.3f} ms, step "
          f"{np.median(step) * 1e3:.3f} ms (medians of 20, synchronised)")
    _print_profile("step: one step profiled", prof)


def phase_step_parity(results: dict) -> None:
    """One gcn_loss + backward, same params and batch (dropout 0), on the
    GPU (kernels) and on the CPU (plain versions)."""
    import dataclasses
    import torch
    from repro_torch.core.batching import batch_to_device
    from repro_torch.core.gcn import gcn_loss, init_params
    from repro_torch.kernels import block_spmm
    from repro_torch.nn.tree import tree_leaves, tree_map

    exp = _step_parts(TRAIN_SETS)
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
    results["step_parity"] = dict(loss_gpu=out["cuda"][0],
                                  loss_cpu=out["cpu"][0],
                                  loss_rel_err=loss_err,
                                  worst_grad_err_over_bound=worst,
                                  launches_gpu=out["cuda"][2],
                                  launches_cpu=out["cpu"][2])
    print(f"[parity] one step GPU vs CPU: loss {out['cuda'][0]:.6f} vs "
          f"{out['cpu'][0]:.6f} (rel {loss_err:.3e}, bound {STEP_TOL}); "
          f"worst grad err / bound {worst:.3f}; launches GPU "
          f"{out['cuda'][2]}, CPU {out['cpu'][2]}")
    if not loss_err <= STEP_TOL or not worst <= 1.0 \
            or out["cuda"][2] != (5, 5) or out["cpu"][2] != (0, 0):
        raise AssertionError(f"GPU step disagrees with the CPU step: "
                             f"{results['step_parity']}")


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


def phase_serve(results: dict, work: pathlib.Path,
                ck: pathlib.Path) -> int:
    """Serve the checkpoint in `ck` (the one phase 3 trained)."""
    import numpy as np
    from repro_torch.core.experiment import (build_gcn_config, build_graph,
                                             build_partition, preset)
    from repro_torch.core.trainer import full_graph_logits
    from repro_torch.kernels import block_spmm
    from repro_torch.launch import serve_gcn
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.serve import ServeEngine

    spec = preset("ppi_sota")
    graph = build_graph(spec)
    cfg = build_gcn_config(spec, graph)
    parts, _ = build_partition(spec, graph)
    nonempty = int((np.bincount(parts, minlength=spec.partition.num_parts)
                    > 0).sum())
    propagations = cfg.num_layers + int(cfg.precompute_ax)
    step = CheckpointManager(str(ck)).latest_valid_step()
    bench_path = work / "serve_bench.json"
    print(f"[serve] ppi_sota: {graph.num_nodes} nodes, {graph.num_edges} "
          f"edge slots, {nonempty} non-empty clusters, {cfg.num_layers} "
          f"layers x {cfg.hidden_dim} wide; trained checkpoint step {step}")

    # --- the main path: every launch count starts at 0 here -------------
    block_spmm.LAUNCHES = 0
    rc = serve_gcn.main(["--preset", "ppi_sota", "--checkpoint-dir",
                         str(ck), "--queries", "1024",
                         "--bench-out", str(bench_path)])
    launches = block_spmm.LAUNCHES
    # ---------------------------------------------------------------------
    if rc != 0:
        raise AssertionError(f"serve_gcn returned {rc}")
    expected = nonempty * propagations
    print(f"[serve] block_ell_spmm launches: {launches} (expected "
          f"{nonempty} clusters x {propagations} propagations = "
          f"{expected})")
    if launches != expected:
        raise AssertionError(f"launch count {launches} != {expected}")
    bench = json.loads(bench_path.read_text())
    results["serve"] = bench
    for row in bench["rows"]:
        if "p50_ms" in row:
            print(f"[serve] {row['name']}: {row['requests']} req  "
                  f"p50 {row['p50_ms']:.4f} ms  p99 {row['p99_ms']:.4f} ms")
        else:
            print(f"[serve] {row['name']}: {row['seconds']:.4f} s "
                  f"({row['warmed_clusters']} clusters)")
    print(f"[serve] QPS {bench['qps']:.1f} over {bench['queries']} lookups")

    # --- parity of the served logits with the host oracle ---------------
    engine = ServeEngine.from_checkpoint(spec, str(ck), device="cuda")
    if engine.warm() != 0:
        raise AssertionError("the rebuilt engine did not find the warm "
                             "cache")
    rng = np.random.default_rng(1)
    ids = rng.choice(graph.num_nodes, size=min(2048, graph.num_nodes),
                     replace=False)
    served = engine.query(ids).logits
    t0 = time.perf_counter()
    ref = full_graph_logits(engine.params, engine.graph, engine.cfg,
                            norm=engine.norm,
                            diag_lambda=engine.diag_lambda)
    oracle_s = time.perf_counter() - t0
    bound = SERVE_TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(served - ref[ids]).max())
    results["serve_parity"] = dict(ids=len(ids), max_abs_err=err,
                                   bound=bound, oracle_s=oracle_s)
    print(f"[serve] parity vs host oracle over {len(ids)} ids: "
          f"max|Δ| = {err:.3e} (bound {bound:.3e})")
    if not err <= bound:
        raise AssertionError("served logits disagree with the oracle")

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
    main = None
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
            main = row
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
    return main


def _profile(fn, top_n: int = 10) -> dict:
    """Run fn once under torch.profiler: wall ms, device busy ms, idle
    share and device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
            device[evt.key] = device.get(evt.key, 0.0) + us / 1e3
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:top_n]
    return dict(wall_ms=wall, device_busy_ms=busy,
                idle_share=1.0 - busy / wall,
                top_device_ms={k[:80]: v for k, v in top})


def _print_profile(tag: str, prof: dict) -> None:
    print(f"[{tag}] {prof['wall_ms']:.3f} ms wall, device busy "
          f"{prof['device_busy_ms']:.3f} ms, idle share "
          f"{prof['idle_share']:.3f}")
    for name, ms in prof["top_device_ms"].items():
        print(f"[{tag}]   {ms:9.4f} ms  {name}")


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _prefill_then_decode(lm, params, cfg, batch, caches, S):
    """Logits of position S-1 by prefill(S-1) and one decode step."""
    _, c = lm.prefill(params, cfg, {"tokens": batch["tokens"][:, :S - 1]},
                      caches)
    dec, _ = lm.decode_step(params, cfg, batch["tokens"][:, S - 1:], c, S - 1)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs "
              "only on a GPU", file=sys.stderr)
        return 1
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
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] all kernels built in {build_s:.2f} s")
    hgmma = _hgmma_count(_build.library_path("flash_attention_sm90"))
    print(f"[build] flash_attention_sm90: {hgmma} HGMMA instructions in its "
          f"SASS")
    if hgmma == 0:
        raise AssertionError("the bf16 flash kernel has no wgmma (HGMMA) "
                             "instruction")

    results = {"gpu": smi, "build_s": build_s, "flash_sm90_hgmma": hgmma,
               "kernel_cases": [], "fused_cases": [], "flash_cases": []}
    spmm_rows = phase_kernels(results)
    fused_row = phase_fused(results)

    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke-"))
    old_cache = os.environ.get("REPRO_DATASETS_CACHE")
    os.environ["REPRO_DATASETS_CACHE"] = str(work / "datasets")
    try:
        trained = phase_train(results, work)
        phase_step_profile(results)
        phase_step_parity(results)
        phase_unfused(results, work)
        serve_launches = phase_serve(results, work, trained["checkpoint"])
        flash_row = phase_flash(results)
        lm_launches = phase_lm_serve(results)
    finally:
        if old_cache is None:
            os.environ.pop("REPRO_DATASETS_CACHE", None)
        else:
            os.environ["REPRO_DATASETS_CACHE"] = old_cache
        shutil.rmtree(work, ignore_errors=True)

    def numbers(row):
        return {k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}

    shape_keys = ("nrb", "K", "B", "ncb", "D", "F", "dtype", "row_k")
    serve, bwd = spmm_rows["serve"], spmm_rows["train_bwd"]
    train_spmm = trained["launches"]["block_ell_spmm"]
    kernels = [{
        "name": "block_ell_spmm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_ell_spmm.cu",
        "replaces": "src/repro/kernels/block_spmm.py:103",
        "also_replaces": "src/repro/kernels/block_spmm.py:132",
        "launches": train_spmm + serve_launches,
        "launches_by_path": {"train": train_spmm, "serve": serve_launches},
        **numbers(serve),
        "shape": {k: serve[k] for k in shape_keys if k in serve},
        "train_bwd": dict(numbers(bwd), shape={k: bwd[k] for k in shape_keys
                                               if k in bwd}),
    }, {
        "name": "block_ell_spmm_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_ell_spmm_fused.cu",
        "replaces": "src/repro/kernels/block_spmm.py:254",
        "launches": trained["launches"]["block_ell_spmm_fused"],
        **numbers(fused_row),
        "function_flops": fused_row["function_flops"],
        "kernel_flops": fused_row["kernel_flops"],
        "shape": {k: fused_row[k] for k in shape_keys if k in fused_row},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "fp32_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:27",
        "launches": lm_launches,
        "launches_by_path": results["lm_serve"]["launches"],
        **numbers(flash_row),
        "tflop_s": flash_row["tflop_s"],
        "shape": {k: flash_row[k] for k in ("B", "Hq", "Hkv", "Tq", "Tk",
                                            "D", "dtype", "mask")},
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
