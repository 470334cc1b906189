"""Disk checkpoint shards: pytree <-> .npz with structure-preserving keys
(the reference's key paths, ``repro_torch.tree``),
plus an async background writer (the paper's multi-level insurance persists
full state every ~500 iterations without blocking training)."""
from __future__ import annotations

import json
import queue
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.tree import (keystr, to_numpy, tree_flatten,
                               tree_flatten_with_path, tree_map, tree_unflatten)

PyTree = Any


def _flatten(tree: PyTree) -> Dict[str, np.ndarray]:
    return {keystr(path): to_numpy(leaf)
            for path, leaf in tree_flatten_with_path(tree)}


def save_pytree(path: Path, tree: PyTree, meta: Optional[Dict] = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **flat)
    tmp.rename(path)                      # atomic-ish publish
    if meta is not None:
        path.with_suffix(".json").write_text(json.dumps(meta))


def load_pytree(path: Path, like: PyTree) -> PyTree:
    """Restore into the structure of `like` (any leaves; numpy leaves out)."""
    data = np.load(Path(path))
    _, treedef = tree_flatten(like)
    leaves = [np.asarray(data[keystr(p)]) for p, _ in tree_flatten_with_path(like)]
    return tree_unflatten(treedef, leaves)


def load_meta(path: Path) -> Optional[Dict]:
    p = Path(path).with_suffix(".json")
    return json.loads(p.read_text()) if p.exists() else None


# ---------------- chunk manifests (StateStream integrity) ---------------- #
def manifest_path(path: Path) -> Path:
    return Path(path).with_suffix(".manifest.json")


def save_manifest(path: Path, manifest: Dict) -> None:
    """Persist a ChunkedStream manifest (per-chunk offsets + CRC32s) next to
    a checkpoint so a partially-fetched restore can verify and resume at
    chunk granularity."""
    p = manifest_path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(manifest))


def load_manifest(path: Path) -> Optional[Dict]:
    p = manifest_path(path)
    return json.loads(p.read_text()) if p.exists() else None


def verify_manifest(manifest: Dict, data: bytes) -> list:
    """Return the seqs of chunks whose CRC does not match `data` (empty list
    == artifact intact; non-empty == exactly what a resume must re-fetch)."""
    import zlib
    bad = []
    for entry in manifest["chunks"]:
        lo, hi = entry["offset"], entry["offset"] + entry["nbytes"]
        if zlib.crc32(data[lo:hi]) != entry["crc"]:
            bad.append(entry["seq"])
    return bad


class AsyncWriter:
    """Single background thread draining a save queue (bounded, coalescing:
    a newer snapshot for the same tag supersedes a queued older one)."""

    def __init__(self, max_queue: int = 2):
        self._q: "queue.Queue[Optional[Tuple[Path, PyTree, Dict]]]" = \
            queue.Queue(maxsize=max_queue)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self.saved = 0
        self.errors: list = []

    def submit(self, path: Path, tree: PyTree, meta: Optional[Dict] = None,
               block: bool = False) -> bool:
        item = (Path(path), tree_map(to_numpy, tree), meta or {})
        try:
            self._q.put(item, block=block)
            return True
        except queue.Full:
            return False                   # skip: a save is already in flight

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            path, tree, meta = item
            try:
                save_pytree(path, tree, meta)
                self.saved += 1
            except Exception as e:         # pragma: no cover
                self.errors.append(e)
            finally:
                self._q.task_done()

    def drain(self) -> None:
        self._q.join()

    def close(self) -> None:
        self._q.put(None)
        self._q.join()
        self._thread.join(timeout=5)
