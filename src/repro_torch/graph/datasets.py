"""Real-dataset ingestion: download once, parse once, memory-mapped —
the port of `repro.graph.datasets` (host numpy, copied, not imported).

  name            format                          paper role
  --------------  ------------------------------  -----------------------
  ppi_real        GraphSAGE JSON (ppi.zip)        PPI (Table 4: 99.36 F1)
  reddit_real     DGL npz (reddit.zip)            Reddit (Table 4: 96.60)
  ogbn_arxiv      OGB csv.gz dir (arxiv.zip)      small modern benchmark
  ogbn_products   OGB csv.gz dir (products.zip)   Amazon2M stand-in
                                                  (2.4M-node co-purchase)

Both packages share one cache, byte for byte (root: $REPRO_DATASETS_CACHE,
default ~/.cache/repro-datasets), so a dataset that either package
processed loads in the other:

  <root>/<name>/raw/         downloaded archives + extracted files,
                             plus CHECKSUMS.json (sha256 per archive)
  <root>/<name>/processed/   parse-once artifacts (PROCESSED_VERSION):
      graph.npz              indptr/indices/data + labels + masks
      features.npy           (N, F) float32 — np.load(mmap_mode="r"),
                             so batch builders gather only the rows a
                             batch touches
      meta.json              processed-format version, shapes, source
                             checksums

Checksum policy: a registry entry may pin a sha256; without a pin the
hash of the first successful download is recorded in raw/CHECKSUMS.json
and every later download of the same file must match it (trust on first
use). Either mismatch raises with the file name and both hashes.

$REPRO_DATASETS_MIRROR rewrites every download URL to
<mirror>/<filename>: an internal mirror, or a `file://` directory of
archives in the real formats (`repro_torch.graph.archives` writes them
from a seed). Downloads retry with capped exponential backoff and
deterministic jitter ($REPRO_DOWNLOAD_ATTEMPTS, $REPRO_DOWNLOAD_BACKOFF,
$REPRO_DOWNLOAD_TIMEOUT); the fault sites download.error and
download.partial (`repro_torch.runtime.faults`) simulate a refused
connection and a stream cut mid-body.
"""
from __future__ import annotations

import dataclasses
import gzip
import hashlib
import json
import os
import pathlib
import shutil
import tempfile
import time
import urllib.request
import zipfile
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.runtime import faults

# download retry policy (flaky mirrors are the COMMON case at
# multi-GB archive sizes): capped exponential backoff with
# deterministic jitter, a per-attempt socket timeout, and partial-file
# cleanup between attempts. Checksum mismatches are NOT retried — a
# wrong file re-downloads wrong. Env overrides (tests drop the backoff
# to milliseconds): $REPRO_DOWNLOAD_ATTEMPTS, $REPRO_DOWNLOAD_BACKOFF
# (first-retry delay, seconds), $REPRO_DOWNLOAD_TIMEOUT (per attempt).
DOWNLOAD_ATTEMPTS = 4
DOWNLOAD_BACKOFF_S = 1.0
DOWNLOAD_BACKOFF_CAP_S = 30.0
DOWNLOAD_TIMEOUT_S = 120.0

# bump when the processed on-disk layout or parsing semantics change —
# old processed/ dirs are ignored (and rebuilt from raw/) on mismatch
PROCESSED_VERSION = 1


def cache_root() -> pathlib.Path:
    """Dataset cache root: $REPRO_DATASETS_CACHE or ~/.cache/repro-datasets."""
    env = os.environ.get("REPRO_DATASETS_CACHE")
    if env:
        return pathlib.Path(env).expanduser()
    return pathlib.Path.home() / ".cache" / "repro-datasets"


def default_serving_cache_dir() -> pathlib.Path:
    """Per-cluster serving embedding caches (repro_torch.serve) share the
    dataset cache root, so one env var ($REPRO_DATASETS_CACHE)
    relocates datasets, partitions and serving state together."""
    return cache_root() / "serving"


# ----------------------------------------------------------------------
# download + checksum layer
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RemoteFile:
    """One downloadable archive. sha256=None means no published pin —
    trust-on-first-use via raw/CHECKSUMS.json."""
    filename: str
    url: str
    sha256: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DatasetEntry:
    """A real dataset the loader layer knows how to materialize."""
    name: str
    files: Tuple[RemoteFile, ...]
    parse: Callable[[pathlib.Path], Dict[str, np.ndarray]]
    notes: str = ""


def _sha256_file(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _resolve_url(remote: RemoteFile) -> str:
    mirror = os.environ.get("REPRO_DATASETS_MIRROR")
    if mirror:
        return mirror.rstrip("/") + "/" + remote.filename
    return remote.url


def _checksum_db(raw_dir: pathlib.Path) -> pathlib.Path:
    return raw_dir / "CHECKSUMS.json"


def _read_checksums(raw_dir: pathlib.Path) -> Dict[str, str]:
    db = _checksum_db(raw_dir)
    if db.exists():
        return json.loads(db.read_text())
    return {}


def _record_checksum(raw_dir: pathlib.Path, filename: str,
                     digest: str) -> None:
    db = _read_checksums(raw_dir)
    db[filename] = digest
    _checksum_db(raw_dir).write_text(json.dumps(db, indent=1, sort_keys=True))


def verify_checksum(raw_dir: pathlib.Path, remote: RemoteFile,
                    digest: str) -> None:
    """Raise if `digest` contradicts the registry pin or the recorded
    trust-on-first-use hash; record it when seen for the first time."""
    if remote.sha256 is not None and digest != remote.sha256:
        raise ValueError(
            f"checksum mismatch for {remote.filename}: downloaded "
            f"sha256 {digest} != pinned {remote.sha256} — the source "
            f"file changed or the download was corrupted; delete it "
            f"and retry, or update the pin in repro_torch.graph.datasets")
    recorded = _read_checksums(raw_dir).get(remote.filename)
    if recorded is None:
        _record_checksum(raw_dir, remote.filename, digest)
    elif recorded != digest:
        raise ValueError(
            f"checksum mismatch for {remote.filename}: sha256 {digest} "
            f"!= previously recorded {recorded} "
            f"(see {_checksum_db(raw_dir)}) — the upstream file changed "
            f"since it was first cached; delete the raw/ dir (and the "
            f"CHECKSUMS.json entry) to re-accept it")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    return default if not raw else float(raw)


def _backoff_delay(filename: str, attempt: int, base: float) -> float:
    """Capped exponential backoff before retry `attempt` (1-based), with
    DETERMINISTIC jitter in [0.5, 1.0)× hashed from (filename, attempt)
    — desynchronizes a fleet hammering one mirror without making test
    runs flaky."""
    h = hashlib.blake2b(f"{filename}:{attempt}".encode(),
                        digest_size=8).digest()
    jitter = 0.5 + 0.5 * int.from_bytes(h, "big") / 2.0 ** 64
    return min(DOWNLOAD_BACKOFF_CAP_S, base * 2.0 ** (attempt - 1)) * jitter


def _download_once(url: str, out, timeout: float) -> None:
    """One streaming download attempt into the open file `out`. The
    fault sites simulate the two transient mirror failures: refusing
    the connection (download.error) and cutting the stream mid-body
    (download.partial — some bytes land, then the read dies)."""
    if faults.maybe_fail("download.error"):
        raise faults.InjectedFault("download.error")
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        if faults.maybe_fail("download.partial"):
            out.write(resp.read(1024))
            raise faults.InjectedFault("download.partial")
        shutil.copyfileobj(resp, out)


def fetch(remote: RemoteFile, raw_dir: pathlib.Path) -> pathlib.Path:
    """Download-once: return raw_dir/<filename>, downloading + checksum-
    verifying it first if absent. Transient failures (connection errors,
    truncated streams, per-attempt timeouts) retry up to
    $REPRO_DOWNLOAD_ATTEMPTS times with capped exponential backoff;
    every attempt writes to a fresh tmp file that is cleaned up on
    failure, and stale <filename>.part-* leftovers from crashed earlier
    runs are swept first. Partial downloads never land at the final
    path (tmp file + atomic rename), and a checksum mismatch on a
    COMPLETE download raises immediately — re-downloading a wrong file
    yields the same wrong file."""
    raw_dir.mkdir(parents=True, exist_ok=True)
    dest = raw_dir / remote.filename
    if dest.exists():
        return dest
    for stale in raw_dir.glob(remote.filename + ".part-*"):
        stale.unlink(missing_ok=True)
    url = _resolve_url(remote)
    attempts = max(1, int(_env_float("REPRO_DOWNLOAD_ATTEMPTS",
                                     DOWNLOAD_ATTEMPTS)))
    base = _env_float("REPRO_DOWNLOAD_BACKOFF", DOWNLOAD_BACKOFF_S)
    timeout = _env_float("REPRO_DOWNLOAD_TIMEOUT", DOWNLOAD_TIMEOUT_S)
    last_err: Optional[BaseException] = None
    for attempt in range(attempts):
        if attempt:
            time.sleep(_backoff_delay(remote.filename, attempt, base))
        tmp_fd, tmp_name = tempfile.mkstemp(
            dir=raw_dir, prefix=remote.filename + ".part-")
        tmp = pathlib.Path(tmp_name)
        try:
            try:
                with os.fdopen(tmp_fd, "wb") as out:
                    _download_once(url, out, timeout)
            except (OSError, ValueError, faults.InjectedFault) as e:
                last_err = e            # transient: retry (tmp cleaned
                continue                # up by the finally below)
            digest = _sha256_file(tmp)
            verify_checksum(raw_dir, remote, digest)   # fatal: no retry
            os.replace(tmp, dest)
            return dest
        finally:
            tmp.unlink(missing_ok=True)
    raise RuntimeError(
        f"could not download {remote.filename} from {url} after "
        f"{attempts} attempt(s): {last_err}. If this machine is "
        f"offline, fetch the file elsewhere and drop it at {dest}, or "
        f"set $REPRO_DATASETS_MIRROR to a reachable mirror "
        f"(file:// URLs work).") from last_err


def _extract_archives(raw_dir: pathlib.Path) -> None:
    """Extract every .zip in raw_dir in place (idempotent: a stamp file
    per archive skips re-extraction)."""
    for arc in sorted(raw_dir.glob("*.zip")):
        stamp = raw_dir / (arc.name + ".extracted")
        if stamp.exists():
            continue
        with zipfile.ZipFile(arc) as z:
            z.extractall(raw_dir)
        stamp.touch()


def _find(raw_dir: pathlib.Path, relpath: str) -> pathlib.Path:
    """Locate an extracted file anywhere under raw_dir (archives differ
    in whether they carry a top-level folder)."""
    direct = raw_dir / relpath
    if direct.exists():
        return direct
    hits = sorted(raw_dir.glob("**/" + relpath))
    if not hits:
        raise FileNotFoundError(
            f"{relpath} not found under {raw_dir} after extraction — "
            f"archive layout changed? Delete {raw_dir} and re-download.")
    return hits[0]


# ----------------------------------------------------------------------
# format parsers: raw/ -> {indptr, indices, data, features, labels, masks}
# ----------------------------------------------------------------------
def _csr_arrays(num_nodes: int, src: np.ndarray, dst: np.ndarray,
                **node_data) -> Dict[str, np.ndarray]:
    g = CSRGraph.from_edges(num_nodes, src, dst)
    out = dict(indptr=g.indptr, indices=g.indices, data=g.data)
    out.update(node_data)
    return out


def parse_graphsage_ppi(raw_dir: pathlib.Path) -> Dict[str, np.ndarray]:
    """GraphSAGE PPI: ppi-G.json (node_link graph with per-node
    test/val flags), ppi-feats.npy (N, 50), ppi-class_map.json
    (id -> 121-dim multilabel), ppi-id_map.json (id -> row index)."""
    G = json.loads(_find(raw_dir, "ppi-G.json").read_text())
    id_map = json.loads(_find(raw_dir, "ppi-id_map.json").read_text())
    class_map = json.loads(_find(raw_dir, "ppi-class_map.json").read_text())
    feats = np.load(_find(raw_dir, "ppi-feats.npy")).astype(np.float32)

    n = len(G["nodes"])
    idx = {k: int(v) for k, v in id_map.items()}

    def row(node_id) -> int:
        return idx.get(str(node_id), idx.get(node_id, -1))

    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    for node in G["nodes"]:
        i = row(node["id"])
        val_mask[i] = bool(node.get("val", False))
        test_mask[i] = bool(node.get("test", False))
    train_mask = ~(val_mask | test_mask)

    num_classes = len(next(iter(class_map.values())))
    labels = np.zeros((n, num_classes), np.float32)
    for k, v in class_map.items():
        labels[row(k)] = np.asarray(v, np.float32)

    src = np.fromiter((row(e["source"]) for e in G["links"]),
                      np.int64, len(G["links"]))
    dst = np.fromiter((row(e["target"]) for e in G["links"]),
                      np.int64, len(G["links"]))
    return _csr_arrays(n, src, dst, features=feats, labels=labels,
                       train_mask=train_mask, val_mask=val_mask,
                       test_mask=test_mask)


def parse_dgl_reddit(raw_dir: pathlib.Path) -> Dict[str, np.ndarray]:
    """DGL Reddit: reddit_data.npz (feature (N, 602), label (N,),
    node_types with 1=train 2=val 3=test) + reddit_graph.npz (scipy
    sparse adjacency)."""
    import scipy.sparse as sp
    data = np.load(_find(raw_dir, "reddit_data.npz"))
    adj = sp.load_npz(_find(raw_dir, "reddit_graph.npz")).tocoo()
    feats = np.asarray(data["feature"], np.float32)
    labels = np.asarray(data["label"], np.int32).reshape(-1)
    types = np.asarray(data["node_types"]).reshape(-1)
    n = feats.shape[0]
    return _csr_arrays(n, adj.row.astype(np.int64),
                       adj.col.astype(np.int64),
                       features=feats, labels=labels,
                       train_mask=types == 1, val_mask=types == 2,
                       test_mask=types == 3)


def _read_csv_gz(path: pathlib.Path, dtype) -> np.ndarray:
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def _parse_ogb_dir(raw_dir: pathlib.Path, split_name: str
                   ) -> Dict[str, np.ndarray]:
    """OGB node-property layout: raw/{edge,node-feat,node-label}.csv.gz
    + split/<split_name>/{train,valid,test}.csv.gz (row indices)."""
    edges = _read_csv_gz(_find(raw_dir, "raw/edge.csv.gz"), np.int64)
    feats = _read_csv_gz(_find(raw_dir, "raw/node-feat.csv.gz"),
                         np.float32)
    labels = _read_csv_gz(_find(raw_dir, "raw/node-label.csv.gz"),
                          np.int64).reshape(-1).astype(np.int32)
    n = feats.shape[0]
    masks = {}
    for split, mask_name in (("train", "train_mask"), ("valid", "val_mask"),
                             ("test", "test_mask")):
        idx = _read_csv_gz(
            _find(raw_dir, f"split/{split_name}/{split}.csv.gz"),
            np.int64).reshape(-1)
        m = np.zeros(n, bool)
        m[idx] = True
        masks[mask_name] = m
    return _csr_arrays(n, edges[:, 0], edges[:, 1], features=feats,
                       labels=labels, **masks)


def parse_ogbn_arxiv(raw_dir: pathlib.Path) -> Dict[str, np.ndarray]:
    return _parse_ogb_dir(raw_dir, "time")


def parse_ogbn_products(raw_dir: pathlib.Path) -> Dict[str, np.ndarray]:
    return _parse_ogb_dir(raw_dir, "sales_ranking")


# ----------------------------------------------------------------------
# the registry
# ----------------------------------------------------------------------
REAL_DATASETS: Dict[str, DatasetEntry] = {
    "ppi_real": DatasetEntry(
        name="ppi_real",
        files=(RemoteFile("ppi.zip",
                          "https://snap.stanford.edu/graphsage/ppi.zip"),),
        parse=parse_graphsage_ppi,
        notes="GraphSAGE PPI, 56944 nodes, 121 labels (multilabel), "
              "paper Table 4 / §4.3"),
    "reddit_real": DatasetEntry(
        name="reddit_real",
        files=(RemoteFile("reddit.zip",
                          "https://data.dgl.ai/dataset/reddit.zip"),),
        parse=parse_dgl_reddit,
        notes="DGL Reddit, 232965 nodes, 41 classes, paper Table 4"),
    "ogbn_arxiv": DatasetEntry(
        name="ogbn_arxiv",
        files=(RemoteFile(
            "arxiv.zip",
            "https://snap.stanford.edu/ogb/data/nodeproppred/arxiv.zip"),),
        parse=parse_ogbn_arxiv,
        notes="OGB arxiv citation graph, 169343 nodes, 40 classes"),
    "ogbn_products": DatasetEntry(
        name="ogbn_products",
        files=(RemoteFile(
            "products.zip",
            "https://snap.stanford.edu/ogb/data/nodeproppred/products.zip"),),
        parse=parse_ogbn_products,
        notes="OGB products co-purchase graph, 2.4M nodes — the modern "
              "public stand-in for the paper's (unreleased) Amazon2M"),
}


# ----------------------------------------------------------------------
# processed-artifact cache
# ----------------------------------------------------------------------
_GRAPH_KEYS = ("indptr", "indices", "data", "labels", "train_mask",
               "val_mask", "test_mask")


def _write_processed(proc_dir: pathlib.Path, arrays: Dict[str, np.ndarray],
                     entry: DatasetEntry, raw_dir: pathlib.Path) -> None:
    """Atomic parse-once write: build in a tmp dir, rename into place."""
    tmp = pathlib.Path(tempfile.mkdtemp(dir=proc_dir.parent,
                                        prefix="processed.tmp-"))
    try:
        np.save(tmp / "features.npy",
                np.ascontiguousarray(arrays["features"], np.float32))
        np.savez(tmp / "graph.npz",
                 **{k: arrays[k] for k in _GRAPH_KEYS})
        meta = {
            "version": PROCESSED_VERSION,
            "name": entry.name,
            "num_nodes": int(len(arrays["indptr"]) - 1),
            "num_edges": int(len(arrays["indices"])),
            "feature_dim": int(arrays["features"].shape[1]),
            "source_sha256": _read_checksums(raw_dir),
        }
        (tmp / "meta.json").write_text(json.dumps(meta, indent=1))
        try:
            os.rename(tmp, proc_dir)
        except OSError:
            if not (proc_dir / "meta.json").exists():   # not a lost race
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


def _processed_ok(proc_dir: pathlib.Path) -> bool:
    meta_path = proc_dir / "meta.json"
    if not meta_path.exists():
        return False
    try:
        meta = json.loads(meta_path.read_text())
    except (OSError, json.JSONDecodeError):
        return False
    return (meta.get("version") == PROCESSED_VERSION
            and (proc_dir / "graph.npz").exists()
            and (proc_dir / "features.npy").exists())


def _load_processed(proc_dir: pathlib.Path, mmap: bool) -> CSRGraph:
    feats = np.load(proc_dir / "features.npy",
                    mmap_mode="r" if mmap else None)
    z = np.load(proc_dir / "graph.npz")
    return CSRGraph(indptr=z["indptr"], indices=z["indices"],
                    data=z["data"], features=feats, labels=z["labels"],
                    train_mask=z["train_mask"], val_mask=z["val_mask"],
                    test_mask=z["test_mask"])


def dataset_meta(name: str,
                 cache_dir: Optional[str] = None) -> Optional[dict]:
    """meta.json of a materialized dataset (None if not processed yet)."""
    root = pathlib.Path(cache_dir).expanduser() if cache_dir \
        else cache_root()
    meta_path = root / name / "processed" / "meta.json"
    if not meta_path.exists():
        return None
    return json.loads(meta_path.read_text())


def load_dataset(name: str, *, cache_dir: Optional[str] = None,
                 mmap: bool = True) -> CSRGraph:
    """Materialize a real dataset: processed cache hit, else download →
    checksum → extract → parse → write processed → load.

    mmap=True (default) memory-maps the (N, F) feature matrix — batch
    builders only gather the rows a batch touches, so Amazon2M-scale
    features never fully materialize in RAM.
    """
    entry = REAL_DATASETS.get(name)
    if entry is None:
        raise KeyError(f"unknown real dataset {name!r}; known: "
                       f"{sorted(REAL_DATASETS)}")
    root = pathlib.Path(cache_dir).expanduser() if cache_dir \
        else cache_root()
    ds_dir = root / name
    proc_dir = ds_dir / "processed"
    if not _processed_ok(proc_dir):
        raw_dir = ds_dir / "raw"
        for remote in entry.files:
            fetch(remote, raw_dir)
        _extract_archives(raw_dir)
        arrays = entry.parse(raw_dir)
        ds_dir.mkdir(parents=True, exist_ok=True)
        _write_processed(proc_dir, arrays, entry, raw_dir)
    return _load_processed(proc_dir, mmap)
