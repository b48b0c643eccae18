"""Checkpoints in the reference's on-disk layout.

The port's `repro.runtime.checkpoint.CheckpointManager`, reading and
writing the SAME format, so a checkpoint written by either package
restores in the other:

  * layout: <dir>/step_<N>/{manifest.json, shard_0.npz}, N zero-padded
    to 10 digits;
  * keys: the tree path of each leaf joined by "/" (dict keys sorted,
    list indices as numbers — e.g. "params/layers/0/w"), stored in the
    npz under the key with "/" replaced by "__";
  * integrity: shape, dtype and crc32 of every array in the manifest,
    checked on restore;
  * atomic publish: written to step_<N>.tmp-<nonce>/ then renamed; stale
    tmp dirs from crashed writers are swept when a manager is created;
  * self-healing restore: with step=None the newest step that verifies
    is used, and every corrupt newer step is quarantined to
    step_<N>.corrupt-<nonce> with a warning.

Trees are nested dicts/lists whose leaves are numpy arrays or torch
tensors; restores return torch tensors on the requested device. Saves
are blocking. The async writer and the fault-injection sites of the
reference come with the port of `runtime/faults.py`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import tempfile
import time
import uuid
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

Tree = Any


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the reference's order: dict keys sorted
    (as jax.tree_util flattens dicts), lists and tuples by index."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_flatten_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten(template, leaves):
    """Rebuild `template`'s nesting with the next values of `leaves`."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _structure(tree) -> str:
    """Human-readable tree structure for the manifest's `treedef` (the
    reference stores jax's treedef string there; neither restore path
    reads it)."""
    if isinstance(tree, dict):
        inner = ", ".join(f"{k!r}: {_structure(tree[k])}"
                          for k in sorted(tree))
        return "{" + inner + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        self.dir = pathlib.Path(self.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        # a crash mid-_write leaves step_*.tmp-* behind; they are never
        # read (steps() skips them), so sweep them here
        for stale in self.dir.glob("step_*.tmp-*"):
            shutil.rmtree(stale, ignore_errors=True)

    def _step_dir(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:010d}"

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Tree, *,
             metadata: Optional[Dict] = None) -> None:
        """Snapshot `tree` to host numpy and publish it as step `step`
        (blocking)."""
        host = [(k, _to_host(v)) for k, v in _flatten_with_paths(tree)]
        final = self._step_dir(step)
        tmp = pathlib.Path(tempfile.mkdtemp(
            prefix=f"step_{step:010d}.tmp-", dir=self.dir))
        try:
            manifest = {"step": step, "treedef": _structure(tree),
                        "metadata": metadata or {},
                        "time": time.time(), "arrays": {}}
            arrays = {}
            for key, arr in host:
                manifest["arrays"][key] = {
                    "shape": list(arr.shape), "dtype": str(arr.dtype),
                    "crc32": _crc(arr)}
                arrays[key.replace("/", "__")] = arr
            np.savez(tmp / "shard_0.npz", **arrays)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)                     # atomic publish
        finally:
            if tmp.exists():
                shutil.rmtree(tmp, ignore_errors=True)
        self._gc()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") \
                    and ".tmp-" not in p.name \
                    and ".corrupt-" not in p.name \
                    and (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    # -- integrity + fallback -------------------------------------------
    def verify_step(self, step: int) -> None:
        """Raise unless step's shard fully matches its manifest (every
        manifest array present, crc32/shape/dtype intact)."""
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "shard_0.npz") as data:
            for key, info in manifest["arrays"].items():
                name = key.replace("/", "__")
                if name not in data.files:
                    raise IOError(f"step {step}: array {key!r} missing "
                                  f"from shard")
                arr = data[name]
                if list(arr.shape) != list(info["shape"]) \
                        or str(arr.dtype) != info["dtype"]:
                    raise IOError(
                        f"step {step}: array {key!r} is {arr.dtype}"
                        f"{arr.shape}, manifest says {info['dtype']}"
                        f"{tuple(info['shape'])}")
                if _crc(arr) != info["crc32"]:
                    raise IOError(f"step {step}: checksum mismatch for "
                                  f"{key!r}")

    def quarantine(self, step: int, reason: str = "") -> pathlib.Path:
        """Move a corrupt step dir aside to step_N.corrupt-<nonce> (kept
        for post-mortem, invisible to steps()/restore) and warn."""
        src = self._step_dir(step)
        dest = self.dir / f"{src.name}.corrupt-{uuid.uuid4().hex[:8]}"
        os.rename(src, dest)
        warnings.warn(
            f"checkpoint step {step} in {self.dir} is corrupt"
            + (f" ({reason})" if reason else "")
            + f" — quarantined to {dest.name}, falling back to the "
            f"previous step", stacklevel=3)
        return dest

    def latest_valid_step(self) -> Optional[int]:
        """The newest step that passes verify_step(), quarantining every
        corrupt candidate it walks past. None when nothing valid is
        left."""
        for step in reversed(self.steps()):
            try:
                self.verify_step(step)
                return step
            except Exception as e:   # any torn-write failure mode
                self.quarantine(step, reason=str(e))
        return None

    # ------------------------------------------------------------------
    # inference loads: params only, optimizer/RNG state skipped
    # ------------------------------------------------------------------
    def restore_subtree(self, target_tree: Tree, prefix: str,
                        step: Optional[int] = None, *, device="cpu"
                        ) -> Tuple[Tree, int]:
        """Restore ONLY the arrays under `prefix/` into the structure of
        `target_tree` (its leaves give the expected shapes), as torch
        tensors on `device`. step=None walks back from the newest step,
        quarantining corrupt candidates; an explicit step is loaded
        as-is and raises on corruption. Returns (tree, step)."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_valid_step()
        if step is None:
            raise FileNotFoundError(f"no valid checkpoints in {self.dir}")
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        out = []
        with np.load(d / "shard_0.npz") as data:
            for key, ref in _flatten_with_paths(target_tree):
                full = f"{prefix}/{key}" if prefix else key
                info = manifest["arrays"].get(full)
                if info is None:
                    roots = sorted({k.split("/")[0]
                                    for k in manifest["arrays"]})
                    raise KeyError(
                        f"checkpoint step {step} has no array {full!r} "
                        f"(top-level prefixes present: {roots})")
                arr = data[full.replace("/", "__")]
                if _crc(arr) != info["crc32"]:
                    raise IOError(f"checksum mismatch for {full!r} "
                                  f"(corrupt checkpoint step {step})")
                if list(arr.shape) != list(ref.shape):
                    raise ValueError(
                        f"shape mismatch for {full!r}: ckpt {arr.shape} "
                        f"vs target {tuple(ref.shape)}")
                out.append(torch.from_numpy(arr).to(dev))
        return _unflatten(target_tree, iter(out)), step

    # where the reference's Engine backends keep the model params in
    # their state tree (SingleDeviceBackend / ShardMapBackend layouts)
    _PARAM_PREFIXES = ("params", "dist/params")

    def restore_params(self, template_params: Tree,
                       step: Optional[int] = None, *, device="cpu"
                       ) -> Tuple[Tree, int]:
        """Params-only inference load: finds the params subtree under
        'params/' (single device) or 'dist/params/' (data parallel) and
        restores just that onto `device`. step=None self-heals like
        training resume. Returns (params tree, step)."""
        step = step if step is not None else self.latest_valid_step()
        if step is None:
            raise FileNotFoundError(f"no valid checkpoints in {self.dir}")
        manifest = json.loads(
            (self._step_dir(step) / "manifest.json").read_text())
        for prefix in self._PARAM_PREFIXES:
            if any(k.startswith(prefix + "/")
                   for k in manifest["arrays"]):
                return self.restore_subtree(template_params, prefix,
                                            step=step, device=device)
        roots = sorted({k.split("/")[0] for k in manifest["arrays"]})
        raise KeyError(
            f"checkpoint step {step} has no params subtree under any of "
            f"{self._PARAM_PREFIXES} (top-level prefixes: {roots})")
