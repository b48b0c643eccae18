"""Process helpers for the port's data-parallel tests.

* `run_reference(code)`: the reference on a forced 2-device CPU host, in
  a subprocess of its own (XLA_FLAGS must be set before jax starts), as
  tests/conftest.py's `run_distributed` runs it.
* `run_plan(tasks)`: one gloo world of `world` CPU ranks, each
  `python _torch_dist.py <rank> <world> <port> <plan.json>`, that runs
  the plan's tasks in order inside one process group:
    {"kind": "experiment", "spec": <spec JSON path>, "p0": <npz of
     initial params or null>, "stop_at": <step or null>, "stop_rank":
     <the only rank that asks to stop, or null for all>, "resume":
     bool, "out": <dir>}  — `build_experiment(spec).fit()` on the port;
     rank r writes <out>/state_<r>.npz (its whole Engine state,
     checkpoint key → array) and rank 0 <out>/result.json (history,
     global step, preempted, stop reason).
    {"kind": "wrapper", "spec": <spec JSON path>, "out": <dir>}  —
     `train_cluster_gcn(..., mesh=<the world group>)` against the same
     spec's `build_experiment(...).fit()`; rank 0 writes
     <out>/result.json.
    {"kind": "steps", "inputs": <npz>, "cases": [[layout, compression,
     microbatches], ...], "steps": n, "out": <dir>}  — the bare
     `make_gcn_train_step` on the batches and params of `inputs`.
    {"kind": "sharded_lm", "arch": <SMOKE arch>, "mesh": [data, model],
     "fsdp": bool, "microbatches": m, "batch": B, "seq": S, "inputs":
     <npz>, "out": <dir>} — one LM `make_train_step` on a DeviceMesh of
     the world against the unsharded step, both from the train state
     and tokens of `inputs` (`tree_npz`); rank 0 writes
     <out>/sharded_lm.json (errors per part, the params' layouts) and
     <out>/sharded_lm.npz (the sharded step's new state and metrics).
    {"kind": "sharded_serve", "arch", "mesh", "batch", "seq", "gen",
     "inputs", "out"} — a sharded prefill and `gen` decode steps against
     the unsharded ones from the params and tokens of `inputs`; rank 0
     writes <out>/sharded_serve.json and <out>/sharded_serve.npz (the
     sharded logits of every step and the last caches).
    {"kind": "sharded_encode", "arch", "mesh", "inputs", "out"} — an
     encoder's `make_encode_step` sharded against unsharded, from the
     params and frame embeddings of `inputs`; rank 0 writes
     <out>/sharded_encode.json and <out>/sharded_encode.npz (the
     sharded frame logits).
    {"kind": "vocab", "inputs", "softcap", "out"} — the vocab-parallel
     loss pieces on a (1, world) mesh, the vocab over 'model': `lm.
     _ce_chunk` (sums and the gradients of the NLL sum), `layers.
     vocab_parallel_nll` per row and `layers.vocab_argmax`, on the
     inputs' hc (B, c, d), w (d, V), targets and mask; rank 0 writes
     <out>/vocab.npz (every result gathered, and the logits).
    {"kind": "serve_cli", "argv": [...], "out"} — `launch.serve.main`
     with `--mesh host` on the world (a (world, 1) mesh), fp32 compute;
     rank 0 writes <out>/serve_cli.json and <out>/serve_cli.npz (its
     tokens and logits).
  The model inputs in `inputs` are the npz keys of `INPUT_KEYS` present
  there: "tokens", and paligemma's "prefix_embeddings" or hubert's
  "embeddings" and "targets" (`configs.input_specs`).
  Every process has a timeout and is killed if it outlives it.

Inputs and results cross as files in a directory the caller owns.
"""
import json
import os
import socket
import subprocess
import sys

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TESTS = os.path.abspath(os.path.dirname(__file__))
ADJ_FIELDS = ("blocks", "block_cols", "blocks_t", "block_cols_t", "row_k",
              "row_k_t")
BATCH_FIELDS = ("features", "labels", "node_mask", "loss_mask", "num_real")
INPUT_KEYS = ("tokens", "prefix_embeddings", "embeddings", "targets")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, TESTS]),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_reference(code: str, devices: int = 2, timeout: float = 420) -> str:
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=timeout, env=_env(
            XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}"))
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def run_plan(tasks, workdir, world: int = 2, timeout: float = 420) -> None:
    """Run `tasks` on a gloo world of `world` ranks, asserting every rank
    exited 0 within `timeout` seconds."""
    plan = os.path.join(str(workdir), f"plan-{free_port()}.json")
    with open(plan, "w") as f:
        json.dump(tasks, f)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port), plan], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_env()) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (rc, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{err[-4000:]}"


# ----------------------------------------------------------------------
# batches and params as files
# ----------------------------------------------------------------------
def save_batches(arrays: dict, prefix: str, batches) -> None:
    """Host batch tuples (port `ClusterBatch.astuple()`) into `arrays`
    under `<prefix>_<i>_<field>`; a compact adjacency (`BlockEllCoords`)
    is saved as the tiles it expands to."""
    for i, (adj, *rest) in enumerate(batches):
        if hasattr(adj, "sections"):
            adj = adj.to("cpu")
        if hasattr(adj, "tensors"):
            for name, t in zip(ADJ_FIELDS, adj.tensors()):
                if t is not None:
                    arrays[f"{prefix}_{i}_adj_{name}"] = t.numpy()
        else:
            arrays[f"{prefix}_{i}_adj"] = adj
        for name, a in zip(BATCH_FIELDS, rest):
            arrays[f"{prefix}_{i}_{name}"] = a


def load_batches(data, prefix: str, n: int, make_adj):
    """The first `n` batches under `prefix`; a block-ELL adjacency goes
    through make_adj(dict of its fields)."""
    out = []
    for i in range(n):
        key = f"{prefix}_{i}_adj"
        if key in data:
            adj = data[key]
        else:
            adj = make_adj({f: data[f"{key}_{f}"] if f"{key}_{f}" in data
                            else None for f in ADJ_FIELDS})
        out.append((adj,) + tuple(data[f"{prefix}_{i}_{f}"]
                                  for f in BATCH_FIELDS))
    return out


def params_npz(params) -> dict:
    """A {"layers": [{name: array}]} tree as flat npz keys."""
    return {f"layers_{i}_{k}": v for i, layer in enumerate(params["layers"])
            for k, v in layer.items()}


def npz_params(data) -> dict:
    """The inverse of `params_npz` (a mapping or an opened npz)."""
    layers = {}
    for key in data:
        _, i, k = key.split("_", 2)
        layers.setdefault(int(i), {})[k] = data[key]
    return {"layers": [layers[i] for i in sorted(layers)]}


# ----------------------------------------------------------------------
# the ranks' side
# ----------------------------------------------------------------------
def _port_params(tree):
    import numpy as np
    import torch
    return {"layers": [{k: torch.from_numpy(np.array(v, np.float32))
                        for k, v in layer.items()}
                       for layer in tree["layers"]]}


def _save_state(path, state):
    import numpy as np
    from repro_torch.runtime.checkpoint import _flatten_with_paths, _to_host
    np.savez(path, **{k.replace("/", "__"): _to_host(v)
                      for k, v in _flatten_with_paths(state)})


def _experiment(task, rank):
    import numpy as np
    import torch
    from repro_torch.core.engine import StopAtStepHook
    from repro_torch.core.experiment import ExperimentSpec, build_experiment
    with open(task["spec"]) as f:
        spec = ExperimentSpec.from_json(f.read())
    stop_rank = task.get("stop_rank")
    hooks = ([StopAtStepHook(task["stop_at"])] if task.get("stop_at")
             and stop_rank in (None, rank) else [])
    exp = build_experiment(spec, device="cpu", extra_hooks=hooks)
    if task.get("p0"):
        backend = exp.engine.backend
        p0 = _port_params(npz_params(np.load(task["p0"])))
        exp.engine.init_state = lambda: backend.init(
            p0, torch.Generator().manual_seed(spec.run.seed + 1))
    res = exp.fit(resume=bool(task.get("resume")))
    os.makedirs(task["out"], exist_ok=True)
    _save_state(os.path.join(task["out"], f"state_{rank}.npz"),
                exp.engine.state)
    if rank == 0:
        with open(os.path.join(task["out"], "result.json"), "w") as f:
            json.dump({"history": res.history,
                       "global_step": exp.engine.global_step,
                       "preempted": exp.engine.preempted,
                       "stop_reason": exp.engine.stop_reason}, f)


def _wrapper(task, rank):
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.core.experiment import ExperimentSpec, build_experiment
    from repro_torch.core.trainer import train_cluster_gcn
    from repro_torch.nn.tree import tree_leaves
    with open(task["spec"]) as f:
        spec = ExperimentSpec.from_json(f.read())
    r_spec = build_experiment(spec, device="cpu").fit()
    one = dataclasses.replace(
        spec, execution=dataclasses.replace(spec.execution,
                                            data_shards=None))
    exp = build_experiment(one, device="cpu")
    r_wrap = train_cluster_gcn(
        exp.graph, exp.batcher, exp.cfg, exp.opt,
        num_epochs=spec.run.epochs, seed=spec.run.seed,
        eval_every=spec.run.eval_every, mesh=dist.group.WORLD,
        compression=spec.execution.compression, device="cpu")
    strip = lambda h: [{k: v for k, v in x.items()  # noqa: E731
                        if k not in ("time", "flagged_steps")} for x in h]
    if rank == 0:
        os.makedirs(task["out"], exist_ok=True)
        with open(os.path.join(task["out"], "result.json"), "w") as f:
            json.dump({
                "same_history": strip(r_wrap.history) == strip(
                    r_spec.history),
                "same_params": all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(r_wrap.params),
                    tree_leaves(r_spec.params))),
                "epochs": len(r_wrap.history)}, f)


def _steps(task, rank, world):
    import numpy as np
    import torch
    from repro_torch.core.batching import batch_to_device
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.dist.steps import (init_gcn_train_state,
                                        make_gcn_train_step)
    from repro_torch.kernels.block_spmm import BlockEllAdj
    from repro_torch.nn import optim
    data = np.load(task["inputs"])
    cfgs = json.loads(str(data["cfgs"]))
    p0 = npz_params({k[3:]: data[k] for k in data.files
                     if k.startswith("p0_")})
    os.makedirs(task["out"], exist_ok=True)
    for layout, comp, m in task["cases"]:
        cfg = GCNConfig(**cfgs[layout])
        opt = optim.adamw(task["lr"])
        n = task["steps"] * world * m
        batches = load_batches(data, layout, n, lambda d: BlockEllAdj(
            *(None if d[f] is None else torch.from_numpy(d[f])
              for f in ADJ_FIELDS)))
        step = make_gcn_train_step(cfg, opt, None, compression=comp,
                                   microbatches=m)
        state = init_gcn_train_state(_port_params(p0), opt, world, comp)
        gen = torch.Generator().manual_seed(0)
        out = {}
        for s in range(task["steps"]):
            group = batches[s * world * m:(s + 1) * world * m]
            mine = batch_to_device(group[rank * m:(rank + 1) * m], "cpu")
            state, loss, aux = step(state, gen, mine)
            out[f"loss_{s}"] = loss.numpy()
            for k, v in aux.items():
                out[f"aux_{s}_{k}"] = v.numpy()
        from repro_torch.runtime.checkpoint import _flatten_with_paths
        for k, v in _flatten_with_paths(state):
            if k.startswith("err/"):
                v = v[rank]            # this rank's row only
            out["state__" + k.replace("/", "__")] = v.numpy()
        np.savez(os.path.join(task["out"],
                              f"{layout}_{comp}_{m}_rank{rank}.npz"), **out)


def tree_npz(tree, prefix: str = "leaf") -> dict:
    """The leaves of a tree (in `tree_leaves` order, the reference's
    too: dict keys sorted) as flat npz keys `<prefix>_<i>`."""
    from repro_torch.nn.tree import tree_leaves
    return {f"{prefix}_{i}": leaf for i, leaf in enumerate(tree_leaves(tree))}


def npz_tree(data, template, prefix: str = "leaf"):
    """The inverse of `tree_npz`: `template`'s nesting, tensors from
    `data`."""
    import torch
    from repro_torch.nn.tree import tree_leaves, tree_unflatten
    n = len(tree_leaves(template))
    return tree_unflatten(template, [torch.from_numpy(data[f"{prefix}_{i}"])
                                     for i in range(n)])


def _full_numpy(tree, prefix: str = "leaf") -> dict:
    """`tree_npz` of the global values of a tree of (D)Tensors."""
    return {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
            .detach().float().numpy() for k, v in tree_npz(tree, prefix)
            .items()}


def _inputs(data) -> dict:
    """The model inputs saved in an npz (`INPUT_KEYS`), as tensors."""
    import torch
    return {k: torch.from_numpy(data[k]) for k in INPUT_KEYS
            if k in data.files}


def _fp32_arch(name: str):
    import dataclasses

    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(name, smoke=True),
                               compute_dtype="float32")


def _rel(got, want) -> float:
    import torch
    scale = float(want.abs().max()) if want.numel() else 0.0
    return float((got - want).abs().max()) / scale if scale else \
        float((got - want).abs().max())


def _sharded_lm(task, rank, world):
    """One sharded LM train step vs the unsharded one, fp32 compute.
    AdamW runs without clipping, so the first moment after one step is
    (1 - b1) times the gradient and the gradient is compared through it;
    its eps is 1e-4 (task "eps"), which keeps the first update Lipschitz
    in the gradient: at 1e-8 an element whose gradient is within
    rounding of zero may move its param by ±lr either way."""
    import dataclasses

    import numpy as np
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import (CellPolicy, distribute_tree,
                                           make_rules, shardings_for)
    from repro_torch.dist.steps import make_train_step, spec_train_state
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.nn.optim import adamw
    from repro_torch.nn.tree import tree_leaves
    from repro_torch.runtime.checkpoint import _flatten_with_paths

    cfg = dataclasses.replace(get_arch(task["arch"], smoke=True),
                              compute_dtype=task.get("dtype", "float32"))
    B, S = task["batch"], task["seq"]
    mesh = make_debug_mesh(*task["mesh"], device_type="cpu")
    policy = CellPolicy(fsdp=task["fsdp"], microbatches=task["microbatches"],
                        loss_chunk=S // 2)
    rules = make_rules(mesh, cfg, ShapeConfig("t", "train", S, B), policy)
    specs = spec_train_state(cfg)
    data = np.load(task["inputs"])
    state = npz_tree(data, specs)
    batch = _inputs(data)
    opt = adamw(1e-3, weight_decay=0.01, eps=task.get("eps", 1e-4))
    ref, ref_m = make_train_step(
        cfg, dataclasses.replace(policy, fsdp=False), opt)(state, batch)
    dstate = distribute_tree(state, shardings_for(specs, mesh, rules))
    new, m = make_train_step(cfg, policy, opt,
                             act_spec=(rules["batch"], None, None),
                             mesh=mesh)(dstate, batch)
    out = {"metrics": {k: _rel(m[k], ref_m[k]) for k in ref_m},
           "params": 0.0, "grads": 0.0, "nu": 0.0, "all_dtensor": True,
           "layouts": {}}
    for (key, got), want in zip(_flatten_with_paths(new),
                                tree_leaves(ref)):
        out["all_dtensor"] &= isinstance(got, DTensor)
        g = got.full_tensor() if isinstance(got, DTensor) else got
        part = key.split("/")[0]
        if part == "mu":
            part, g, want = "grads", g / 0.1, want / 0.1
        if part == "params":
            # zero-initialised leaves (norm scales) hold one update of
            # ~lr: their error is measured against max(1, max|p|)
            err = float((g.float() - want.float()).abs().max()) / max(
                1.0, float(want.abs().max()))
            out[part] = max(out[part], err)
        elif part in out:
            out[part] = max(out[part], _rel(g.float(), want.float()))

        if part == "params":
            out["layouts"][key] = [str(p) for p in got.placements]
    out["step"] = int(new["step"].full_tensor())
    arrays = _full_numpy(new)           # a collective: every rank gathers
    if rank == 0:
        os.makedirs(task["out"], exist_ok=True)
        with open(os.path.join(task["out"], "sharded_lm.json"), "w") as f:
            json.dump(out, f)
        np.savez(os.path.join(task["out"], "sharded_lm.npz"), **arrays,
                 **{f"metric_{k}": float(v) for k, v in m.items()})


def _sharded_serve(task, rank, world):
    """A sharded prefill (S prompt tokens, after a VLM's prefix) and
    `gen` decode steps against the unsharded ones, fp32 compute, from
    the same params and inputs; rank 0 writes <out>/sharded_serve.json
    (errors per part)."""
    import numpy as np
    import torch
    from repro_torch.dist.sharding import (CellPolicy, distribute_tree,
                                           make_rules, shardings_for)
    from repro_torch.dist.steps import make_decode_step, make_prefill_step
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.lm import spec_caches, spec_params
    from repro_torch.models.spec import init_tree
    from repro_torch.nn.tree import tree_leaves

    cfg = _fp32_arch(task["arch"])
    B, S, gen = task["batch"], task["seq"], task["gen"]
    npfx = cfg.num_prefix_embeddings
    ctx = npfx + S + gen
    mesh = make_debug_mesh(*task["mesh"], device_type="cpu")
    rules = make_rules(mesh, cfg, ShapeConfig("t", "prefill", ctx, B),
                       CellPolicy())
    act = (rules["batch"], None, None)
    p_specs = spec_params(cfg)
    c_specs = spec_caches(cfg, B, ctx)
    data = np.load(task["inputs"])
    params = npz_tree(data, p_specs)
    inputs = _inputs(data)
    toks = inputs.pop("tokens")

    def run(p, caches, prefill, decode):
        logits, caches = prefill(p, dict(inputs, tokens=toks[:, :S]),
                                 caches)
        out = [logits]
        for i in range(gen):
            _, logits, caches = decode(p, toks[:, S + i:S + i + 1], caches,
                                       npfx + S + i)
            out.append(logits)
        return out, caches

    zeros = lambda: init_tree(c_specs, torch.Generator(), "cpu")  # noqa: E731
    want, w_caches = run(params, zeros(), make_prefill_step(cfg),
                         make_decode_step(cfg))
    got, g_caches = run(
        distribute_tree(params, shardings_for(p_specs, mesh, rules)),
        distribute_tree(zeros(), shardings_for(c_specs, mesh, rules)),
        make_prefill_step(cfg, CellPolicy(), act_spec=act),
        make_decode_step(cfg, CellPolicy(), act_spec=act))
    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t
    out = {"logits": max(_rel(full(g).float(), w.float())
                         for g, w in zip(got, want)),
           "caches": max(_rel(full(g).float(), w.float()) for g, w in zip(
               tree_leaves(g_caches), tree_leaves(w_caches))),
           "kv_seq": rules["kv_seq"], "kv_heads": rules["kv_heads"]}
    arrays = dict(_full_numpy(g_caches, "cache"),
                  **{f"logits_{j}": full(t).float().numpy()
                     for j, t in enumerate(got)})
    if rank == 0:
        os.makedirs(task["out"], exist_ok=True)
        with open(os.path.join(task["out"], "sharded_serve.json"), "w") as f:
            json.dump(out, f)
        np.savez(os.path.join(task["out"], "sharded_serve.npz"), **arrays)


def _sharded_encode(task, rank, world):
    """An encoder's `make_encode_step` on DTensor params and embeddings
    against the unsharded step, fp32 compute, from the same params; rank
    0 writes <out>/sharded_encode.json (the error) and .npz (logits)."""
    import numpy as np
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.dist.sharding import (CellPolicy, distribute_tree,
                                           make_rules, placements,
                                           shardings_for)
    from repro_torch.dist.steps import make_encode_step
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.lm import spec_params

    cfg = _fp32_arch(task["arch"])
    data = np.load(task["inputs"])
    p_specs = spec_params(cfg)
    params = npz_tree(data, p_specs)
    batch = _inputs(data)
    B, S = batch["embeddings"].shape[:2]
    mesh = make_debug_mesh(*task["mesh"], device_type="cpu")
    rules = make_rules(mesh, cfg, ShapeConfig("t", "prefill", S, B),
                       CellPolicy())
    want = make_encode_step(cfg)(params, batch)
    act = (rules["batch"], None, None)
    dbatch = {k: distribute_tensor(v, mesh, placements(
        act[:v.dim()], mesh), src_data_rank=None) for k, v in batch.items()}
    got = make_encode_step(cfg, CellPolicy(), act_spec=act)(
        distribute_tree(params, shardings_for(p_specs, mesh, rules)),
        dbatch)
    got = got.full_tensor()
    if rank == 0:
        os.makedirs(task["out"], exist_ok=True)
        with open(os.path.join(task["out"], "sharded_encode.json"),
                  "w") as f:
            json.dump({"logits": _rel(got, want)}, f)
        np.savez(os.path.join(task["out"], "sharded_encode.npz"),
                 logits=got.numpy())


def _vocab(task, rank, world):
    """The vocab-parallel cross-entropy and argmax on a (1, world) mesh
    (module docstring); rank 0 writes <out>/vocab.npz."""
    import dataclasses

    import numpy as np
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.models.layers import vocab_argmax, vocab_parallel_nll

    cfg = dataclasses.replace(_fp32_arch("gemma3-1b"),
                              logit_softcap=task["softcap"])
    data = np.load(task["inputs"])
    hc, w = (torch.from_numpy(data[k]) for k in ("hc", "w"))
    tc, mc = torch.from_numpy(data["tc"]).long(), torch.from_numpy(
        data["mc"])
    mesh = make_debug_mesh(1, world, device_type="cpu")
    hc_d = distribute_tensor(hc, mesh, [Replicate(), Replicate()])
    w_d = distribute_tensor(w, mesh, [Replicate(), Shard(1)])
    hc_d.requires_grad_()
    w_d.requires_grad_()
    with implicit_replication():
        nll_sum, correct_sum = lm._ce_chunk(cfg, hc_d, tc, mc, w_d)
        nll_sum.backward()
        with torch.no_grad():
            logits = lm._softcap(cfg, lm._fp32_product(hc_d, w_d))
            rows, hits = vocab_parallel_nll(logits, tc)
            first = vocab_argmax(logits)
    out = {"nll_sum": nll_sum, "correct_sum": correct_sum,
           "grad_hc": hc_d.grad, "grad_w": w_d.grad, "logits": logits,
           "nll_rows": rows, "correct_rows": hits, "argmax": first}
    out = {k: v.full_tensor().detach().numpy() for k, v in out.items()}
    out["logits_placements"] = np.array([str(p) for p in logits.placements])
    if rank == 0:
        os.makedirs(task["out"], exist_ok=True)
        np.savez(os.path.join(task["out"], "vocab.npz"), **out)


def _serve_cli(task, rank, world):
    """`launch.serve.main(argv + --mesh host)` in this process group
    (its (world, 1) mesh), the arch's SMOKE config in fp32; rank 0
    writes <out>/serve_cli.json (the returned fields) and .npz (tokens,
    prefill and last logits)."""
    import numpy as np
    from repro_torch.launch import serve

    serve.get_arch = lambda name, smoke=False: _fp32_arch(name)
    res = serve.main(task["argv"] + ["--mesh", "host"])
    if rank == 0:
        os.makedirs(task["out"], exist_ok=True)
        with open(os.path.join(task["out"], "serve_cli.json"), "w") as f:
            json.dump({k: res[k] for k in ("mesh", "launches",
                                           "decode_steps")}, f)
        np.savez(os.path.join(task["out"], "serve_cli.npz"),
                 tokens=res["tokens"],
                 prefill_logits=res["prefill_logits"].numpy(),
                 last_logits=res["last_logits"].numpy())


def main(argv):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, port, plan = int(argv[1]), int(argv[2]), argv[3], argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        with open(plan) as f:
            for task in json.load(f):
                if task["kind"] == "experiment":
                    _experiment(task, rank)
                elif task["kind"] == "wrapper":
                    _wrapper(task, rank)
                elif task["kind"] == "sharded_lm":
                    _sharded_lm(task, rank, world)
                elif task["kind"] == "sharded_serve":
                    _sharded_serve(task, rank, world)
                elif task["kind"] == "sharded_encode":
                    _sharded_encode(task, rank, world)
                elif task["kind"] == "serve_cli":
                    _serve_cli(task, rank, world)
                elif task["kind"] == "vocab":
                    _vocab(task, rank, world)
                else:
                    _steps(task, rank, world)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
