"""Checkpoints in the reference's on-disk layout — the port of
`repro.runtime.checkpoint.CheckpointManager`, reading and writing the
SAME format, so a checkpoint written by either package restores in the
other:

  * layout: <dir>/step_<N>/{manifest.json, shard_0.npz}, N zero-padded
    to 10 digits;
  * keys: the tree path of each leaf joined by "/" as jax names it:
    dict keys sorted, list and tuple items by index, NamedTuple fields
    as ".<field>" — e.g. "params/layers/0/w", "opt/.mu/layers/0/w" —
    stored in the npz under the key with "/" replaced by "__"; None is
    an empty subtree;
  * integrity: shape, dtype and crc32 of every array in the manifest,
    checked on restore;
  * atomic publish: written to step_<N>.tmp-<nonce>/ then renamed; stale
    tmp dirs from crashed writers are swept when a manager is created;
  * async: with async_save=True, save() snapshots the tree to host
    numpy, then writes on a background thread unless blocking (one save
    in flight at a time; a failed write surfaces on the next save() or
    wait()). The port's default is async_save=False, so a bare save()
    has published its step when it returns; the experiment builder
    turns it on for the Engine's cadence saves, as the reference runs;
  * self-healing restore: with step=None the newest step that verifies
    is used, and every corrupt newer step is quarantined to
    step_<N>.corrupt-<nonce> with a warning.

Leaves are numpy arrays, torch tensors, or `torch.Generator`s (stored
as their `get_state()` bytes — the port's training RNG lives under
"rng"). Restores return torch tensors on the requested device. The
fault sites checkpoint.crash_before_rename and checkpoint.corrupt_latest
(runtime.faults) fire inside the write, as in the reference.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import tempfile
import threading
import time
import uuid
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nn.tree import is_namedtuple
from repro_torch.runtime import faults

Tree = Any


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the reference's order and naming (module
    docstring)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif is_namedtuple(tree):
        items = [(f".{f}", v) for f, v in zip(tree._fields, tree)]
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
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if is_namedtuple(template):
        return type(template)(*(_unflatten(v, leaves) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _structure(tree) -> str:
    """Human-readable tree structure for the manifest's `treedef` (the
    reference stores jax's treedef string there; no restore path reads
    it)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        inner = ", ".join(f"{k!r}: {_structure(tree[k])}"
                          for k in sorted(tree))
        return "{" + inner + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy().copy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, torch.Generator):
        return tuple(leaf.get_state().shape)
    return tuple(np.shape(leaf) if not isinstance(leaf, torch.Tensor)
                 else leaf.shape)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _flip_one_bit(path: pathlib.Path) -> None:
    """Corrupt a file in place (the checkpoint.corrupt_latest fault):
    flip one bit at several spread-out offsets, as the reference does."""
    size = path.stat().st_size
    with open(path, "r+b") as f:
        for num, den in ((1, 3), (1, 2), (2, 3)):
            off = size * num // den
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0x01]))


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = False

    def __post_init__(self):
        self.dir = pathlib.Path(self.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # a crash mid-_write leaves step_*.tmp-* behind; they are never
        # read (steps() skips them), so sweep them here, where no writer
        # of this process can be in flight yet
        for stale in self.dir.glob("step_*.tmp-*"):
            shutil.rmtree(stale, ignore_errors=True)

    def _step_dir(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:010d}"

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Tree, *, blocking: bool = False,
             metadata: Optional[Dict] = None) -> None:
        """Snapshot `tree` to host numpy, then publish it as step `step`
        (on a background thread unless blocking or async_save is off)."""
        self.wait()                    # one in-flight save at a time
        host = [(k, _to_host(v)) for k, v in _flatten_with_paths(tree)]
        structure = _structure(tree)
        if self.async_save and not blocking:
            self._thread = threading.Thread(
                target=self._write_guarded,
                args=(step, host, structure, metadata), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, structure, metadata)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_guarded(self, *args):
        try:
            self._write(*args)
        except BaseException as e:     # surfaced on next save()/wait()
            self._error = e

    def _write(self, step: int, host, structure: str,
               metadata: Optional[Dict]) -> None:
        final = self._step_dir(step)
        tmp = pathlib.Path(tempfile.mkdtemp(
            prefix=f"step_{step:010d}.tmp-", dir=self.dir))
        try:
            manifest = {"step": step, "treedef": structure,
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
            if faults.maybe_fail("checkpoint.crash_before_rename"):
                # die right before the atomic publish: the tmp dir
                # leaks, exactly as a real crash leaves it
                tmp = None
                raise faults.InjectedFault("checkpoint.crash_before_rename")
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)                     # atomic publish
            if faults.maybe_fail("checkpoint.corrupt_latest"):
                _flip_one_bit(final / "shard_0.npz")
        finally:
            if tmp is not None and tmp.exists():
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

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

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

    def read_metadata(self, step: Optional[int] = None) -> Dict:
        """The `metadata` dict passed to save() (the Engine keeps its
        loop position — epoch, step-in-epoch, partial metric
        accumulators, history — here)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        manifest = json.loads(
            (self._step_dir(step) / "manifest.json").read_text())
        return manifest.get("metadata", {})

    # ------------------------------------------------------------------
    def _load(self, target_tree: Tree, prefix: str, step: int,
              device: torch.device) -> Tree:
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
                if tuple(arr.shape) != _shape(ref):
                    raise ValueError(
                        f"shape mismatch for {full!r}: ckpt {arr.shape} "
                        f"vs target {_shape(ref)}")
                if isinstance(ref, torch.Generator):
                    gen = torch.Generator(device=ref.device)
                    gen.set_state(torch.from_numpy(arr.copy()))
                    out.append(gen)
                else:
                    out.append(torch.from_numpy(arr).to(device))
        return _unflatten(target_tree, iter(out))

    def restore(self, target_tree: Tree, step: Optional[int] = None, *,
                device="cpu") -> Tree:
        """Restore into the structure of `target_tree` (its leaves give
        the expected shapes; values are ignored) as tensors on `device`
        (generators keep the template's device). step=None uses the
        newest VALID step, quarantining corrupt newer ones; an explicit
        step is restored as-is and raises on corruption."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_valid_step()
        if step is None:
            raise FileNotFoundError(f"no valid checkpoints in {self.dir}")
        return self._load(target_tree, "", step, dev)

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
        return self._load(target_tree, prefix, step, dev), step

    # where each Engine backend keeps the model params in its state tree
    # (SingleDeviceBackend / the reference's ShardMapBackend layouts)
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
