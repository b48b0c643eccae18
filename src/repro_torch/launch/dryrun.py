"""Production-mesh dry-run of the LM cells — the port of
`repro.launch.dryrun`.

    python -m repro_torch.launch.dryrun --arch llama3.2-1b \
        --shape train_4k --mesh pod

The reference lowers and compiles every (arch × shape × mesh) cell on
512 fake XLA devices and reads the compiled program. Eager PyTorch has
no compiled program, so each cell is TRACED instead: this process joins
a fake process group of 256 (pod) or 512 (multipod) ranks as rank 0
(`torch.distributed`'s "fake" backend: collectives move nothing), builds
the production `DeviceMesh` on it, makes the step's state as DTensors of
fake local shards under `FakeTensorMode` (shapes from `shape_tree`'s
TensorSpecs, layouts from `dist.sharding.shardings_for`; no storage),
and runs the step once under the cost walker of `launch/cost_analysis`,
which counts rank 0's local ops: FLOPs, bytes, collectives, and the
live bytes of what the step allocates. Nothing computes, so a cell
takes seconds on the host's CPU.

Per cell it writes results/dryrun_torch/<arch>__<shape>__<mesh>__<tag>.json
with the reference's fields: status ("ok", "skip" or "error" — a failing
cell is recorded, not raised), memory.{argument,output,temp,peak}_size_in_bytes
per device, flops_per_device, bytes_accessed_per_device, collectives
({kind: {count, bytes}}), num_devices, mesh_shape, policy; plus
trace_s and the roofline terms at the H100 constants of
`launch/mesh.py` (`roofline`). Importing this module starts no process
group: `main()` and `run_cell` do.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_NAMES, cell_supported, get_arch,
                                 input_specs)
from repro_torch.dist.sharding import (CellPolicy, Sharding, batch_pspec,
                                       fake_tree, make_rules, shardings_for)
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_FP32, axis_size, data_axes,
                                     make_production_mesh, production_shape)
from repro_torch.models.config import SHAPES
from repro_torch.models.spec import TensorSpec

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"


def default_policy(cfg, shape, mesh) -> CellPolicy:
    """The reference's policy for a cell: FSDP, remat, the largest
    microbatch that plausibly fits (~16k tokens a microbatch for big
    models, ~32k for small), loss chunk 256 for vocabularies > 128k."""
    dsize = axis_size(mesh, data_axes(mesh))
    micro = 1
    if shape.kind == "train":
        b_dev = max(1, shape.global_batch // dsize)
        big = cfg.d_model > 2048 or bool(cfg.num_experts)
        rows = max(1, (16384 if big else 32768) // shape.seq_len)
        micro = max(1, b_dev // rows)
        while b_dev % micro:
            micro -= 1
    loss_chunk = 256 if cfg.vocab_size > 131072 else 512
    return CellPolicy(fsdp=True, microbatches=micro, remat=True,
                      loss_chunk=loss_chunk)


def fake_world(world: int) -> None:
    """Make the default process group a fake one of `world` ranks, this
    process rank 0 (replacing a default group of another size)."""
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _fake_inputs(bspecs, shardings: Dict[str, Sharding]):
    """DTensors of fake local shards for the model inputs."""
    specs = {k: TensorSpec(tuple(shp), (None,) * len(shp), dtype=dt)
             for k, (shp, dt) in bspecs.items()}
    return fake_tree(specs, shardings)


def trace_cell(cfg, shape, mesh, policy: CellPolicy):
    """(step, args) of one cell (an ArchConfig and a ShapeConfig), args
    DTensors on `mesh` of local shards made under the caller's
    FakeTensorMode."""
    from repro_torch.dist.steps import (make_decode_step, make_encode_step,
                                        make_prefill_step, make_train_step,
                                        spec_train_state)
    from repro_torch.models.lm import spec_caches, spec_params
    from repro_torch.nn.optim import adamw
    rules = make_rules(mesh, cfg, shape, policy)
    bspecs = input_specs(cfg, shape)
    batch = _fake_inputs(bspecs, batch_pspec(bspecs, mesh, rules))
    act_spec = (rules.get("batch"), None, None)
    if shape.kind == "train":
        st = spec_train_state(cfg)
        state = fake_tree(st, shardings_for(st, mesh, rules))
        step = make_train_step(cfg, policy, adamw(3e-4, clip_norm=1.0),
                               act_spec=act_spec, mesh=mesh)
        return step, (state, batch)
    p_specs = spec_params(cfg)
    params = fake_tree(p_specs, shardings_for(p_specs, mesh, rules))
    if shape.kind == "prefill" and cfg.is_encoder:
        return make_encode_step(cfg, policy, act_spec=act_spec), \
            (params, batch)
    c_specs = spec_caches(cfg, shape.global_batch, shape.seq_len)
    caches = fake_tree(c_specs, shardings_for(c_specs, mesh, rules))
    if shape.kind == "prefill":
        return make_prefill_step(cfg, policy, act_spec=act_spec), \
            (params, batch, caches)
    # decode: one new token against a seq_len-deep cache, at its last slot
    return make_decode_step(cfg, policy, act_spec=act_spec), \
        (params, batch["tokens"], caches, shape.seq_len - 1)


def roofline(rec: dict, peak_flops: float) -> dict:
    """Seconds of one step per device at the H100 constants: compute
    (FLOPs over `peak_flops`), memory (bytes over HBM), collectives
    (wire bytes over one NVLink direction), and their max."""
    coll = sum(c["bytes"] for c in rec["collectives"].values())
    t = {"compute_s": rec["flops_per_device"] / peak_flops,
         "memory_s": rec["bytes_accessed_per_device"] / HBM_BW,
         "collective_s": coll / NVLINK_BW}
    t["bound_s"] = max(t.values())
    t["collective_bytes"] = coll
    return t


def _peak_flops(cfg) -> float:
    return PEAK_FLOPS_BF16 if cfg.dtype == torch.bfloat16 \
        else PEAK_FLOPS_FP32


def run_cell(arch_name: str, shape_name: str, mesh_kind: str,
             policy: Optional[CellPolicy] = None, tag: str = "baseline",
             save: bool = True) -> dict:
    """Trace one cell on a fake world of the production mesh's size and
    return (and save) its record; a failing cell records its error."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.cost_analysis import run_step
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
           "tag": tag}
    if not ok:
        rec.update(status="skip", reason=reason)
    else:
        multi = mesh_kind == "multipod"
        shp, _ = production_shape(multi)
        fake_world(math.prod(shp))
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        policy = policy or default_policy(cfg, shape, mesh)
        rec["policy"] = dataclasses.asdict(policy)
        t0 = time.perf_counter()
        try:
            # the state and inputs are made under the fake mode; the step
            # runs outside it, so the model's own small constants
            # (positions, masks) are real tensors and DTensor's layout
            # bookkeeping (plain tensor math) never meets a fake tensor
            with FakeTensorMode(allow_non_fake_inputs=True):
                step, args = trace_cell(cfg, shape, mesh, policy)
            _, walker, memory = run_step(step, *args)
            walked = walker.summary()
            rec.update(
                status="ok", trace_s=round(time.perf_counter() - t0, 1),
                memory=memory,
                flops_per_device=float(walked["flops"]),
                bytes_accessed_per_device=float(walked["bytes"]),
                collectives=walked["collectives"],
                num_devices=int(math.prod(tuple(mesh.shape))),
                mesh_shape=dict(zip(mesh.mesh_dim_names,
                                    (int(s) for s in mesh.shape))))
            rec["roofline"] = roofline(rec, _peak_flops(cfg))
        except Exception as e:  # record failures — they are bugs to fix
            rec.update(status="error",
                       error=f"{type(e).__name__}: {e}"[:2000])
    if save:
        RESULTS.mkdir(parents=True, exist_ok=True)
        name = f"{arch_name}__{shape_name}__{mesh_kind}__{tag}.json"
        (RESULTS / name).write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.dryrun",
        description="Trace LM cells on a fake production mesh and record "
                    "per-device FLOPs, bytes, collectives and memory")
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, help="shape name or 'all'")
    ap.add_argument("--mesh", default="pod", choices=("pod", "multipod",
                                                      "both"))
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--loss-chunk", type=int, default=None)
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if args.arch in (None, "all") else [args.arch]
    shapes = list(SHAPES) if args.shape in (None, "all") else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    errors = 0
    try:
        for arch in archs:
            for shp in shapes:
                for mk in meshes:
                    out = RESULTS / f"{arch}__{shp}__{mk}__{args.tag}.json"
                    if out.exists() and not args.force:
                        prev = json.loads(out.read_text())
                        if prev.get("status") in ("ok", "skip"):
                            print(f"[cached] {arch} × {shp} × {mk}: "
                                  f"{prev['status']}")
                            continue
                    policy = None
                    if any(v is not None for v in (args.microbatches,
                                                   args.loss_chunk)) \
                            or args.no_fsdp or args.no_remat:
                        cfg, shape = get_arch(arch), SHAPES[shp]
                        stub = _MeshStub(*production_shape(mk == "multipod"))
                        base = default_policy(cfg, shape, stub)
                        policy = dataclasses.replace(
                            base, fsdp=not args.no_fsdp,
                            remat=not args.no_remat,
                            microbatches=args.microbatches
                            or base.microbatches,
                            loss_chunk=args.loss_chunk or base.loss_chunk)
                    t0 = time.perf_counter()
                    rec = run_cell(arch, shp, mk, policy, tag=args.tag)
                    dt = time.perf_counter() - t0
                    print(summary_line(rec, dt))
                    errors += rec["status"] == "error"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 1 if errors else 0


@dataclasses.dataclass(frozen=True)
class _MeshStub:
    """Axis sizes without ranks (`default_policy` reads only these)."""
    shape: tuple
    mesh_dim_names: tuple


def summary_line(rec: dict, seconds: float) -> str:
    name = f"{rec['arch']} × {rec['shape']} × {rec['mesh']}"
    if rec["status"] == "ok":
        r = rec["roofline"]
        return (f"[ok {seconds:6.1f}s] {name}: "
                f"{rec['flops_per_device']:.4g} FLOP/dev, "
                f"{rec['bytes_accessed_per_device']:.4g} B/dev, "
                f"collectives {r['collective_bytes']:.4g} B/dev, peak "
                f"{rec['memory']['peak_memory_in_bytes'] / 2**30:.2f} "
                f"GiB/dev; roofline {r['bound_s'] * 1e3:.2f} ms (compute "
                f"{r['compute_s'] * 1e3:.2f}, memory "
                f"{r['memory_s'] * 1e3:.2f}, collectives "
                f"{r['collective_s'] * 1e3:.2f})")
    if rec["status"] == "skip":
        return f"[skip] {name}: {rec['reason']}"
    return f"[ERROR {seconds:6.1f}s] {name}: {rec['error'][:300]}"


if __name__ == "__main__":
    raise SystemExit(main())
