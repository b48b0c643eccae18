"""Device meshes of the port — `repro.launch.mesh` on torch.distributed.

Functions, never module-level meshes: importing this module starts no
process group and touches no device. A mesh is a `DeviceMesh` over the
ranks of the current default process group (torchrun's, or the fake
group of the dry-run, `launch/dryrun.py`), built by `init_device_mesh`.

Production layout (the reference's): 256 ranks as (16, 16) over
("data", "model"), or 512 as (2, 16, 16) over ("pod", "data",
"model"):
  pod   — inter-node data parallelism
  data  — intra-node data parallelism and the FSDP shard axis
  model — tensor / expert / sequence parallelism

`data_axes` and `axis_size` read only `mesh_dim_names` and `shape`, so
tests pass a stub with those two attributes and no ranks behind it.

Hardware constants of the roofline are the NVIDIA H100 SXM's (per card,
dense, from NVIDIA's data sheet at the 700 W limit).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch.distributed as dist

HARDWARE = "NVIDIA H100 SXM 80GB"
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, H100 SXM bf16 tensor cores, dense
PEAK_FLOPS_FP32 = 67e12         # FLOP/s, H100 SXM fp32 CUDA cores
HBM_BW = 3.35e12                # B/s, H100 SXM HBM3
NVLINK_BW = 450e9               # B/s per direction, H100 SXM NVLink 4

_PRODUCTION = {False: ((16, 16), ("data", "model")),
               True: ((2, 16, 16), ("pod", "data", "model"))}


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(mesh shape, axis names) of the production mesh."""
    return _PRODUCTION[bool(multi_pod)]


def _mesh(shape: Sequence[int], axes: Sequence[str], device_type: str,
          what: str):
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"the {what} mesh {tuple(shape)} needs a process group of "
            f"{need} ranks and none is initialised (start the program "
            f"under torchrun --nproc_per_node ...)")
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(
            f"the {what} mesh {tuple(shape)} over {tuple(axes)} needs "
            f"{need} ranks; this process group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) or (2, 16, 16) mesh over the current process group,
    which must hold exactly 256 or 512 ranks (raises otherwise)."""
    shape, axes = production_shape(multi_pod)
    return _mesh(shape, axes, device_type,
                 "multipod" if multi_pod else "pod")


def make_debug_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A small (data, model) mesh over a process group of data × model
    ranks (tests: gloo on the CPU, `device_type="cpu"`)."""
    return _mesh((data, model), ("data", "model"), device_type, "debug")


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh (or a stub with `mesh_dim_names` and
    `shape`)."""
    return dict(zip(tuple(mesh.mesh_dim_names), tuple(mesh.shape)))


def data_axes(mesh) -> tuple:
    names = tuple(mesh.mesh_dim_names)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, names: Optional[Union[str, Sequence[str]]]) -> int:
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    sizes = mesh_axes(mesh)
    n = 1
    for a in names:
        n *= sizes[a]
    return n
