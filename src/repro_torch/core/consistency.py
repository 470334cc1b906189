"""Checkpoint consistency (paper §4.2, §6.2): two recent optimizer snapshots
per worker + earliest-globally-available version resolution.

Failures can stall collectives mid-iteration, leaving DP groups at versions n
and n+1. The controller picks min(versions); workers ahead roll back one step
using the older kept snapshot. Because the unique state is snapshotted
immediately after each update, resuming from that iteration loses no progress
(paper §6.2, last paragraph)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.tree import to_numpy, tree_map

PyTree = Any


@dataclass
class Snapshot:
    iteration: int
    state: PyTree            # host-side (numpy) unique state


class SnapshotKeeper:
    """Holds the last TWO snapshots (a few GB of CPU RAM in production —
    paper: 'FFTrainer keeps two recent snapshots of optimizer state')."""

    def __init__(self, depth: int = 2):
        self.depth = depth
        self._snaps: List[Snapshot] = []

    def push(self, iteration: int, state: PyTree) -> None:
        host = tree_map(to_numpy, state)
        self._snaps.append(Snapshot(iteration, host))
        if len(self._snaps) > self.depth:
            self._snaps.pop(0)

    @property
    def iterations(self) -> List[int]:
        return [s.iteration for s in self._snaps]

    def get(self, iteration: int) -> Optional[Snapshot]:
        for s in reversed(self._snaps):
            if s.iteration == iteration:
                return s
        return None

    def latest(self) -> Optional[Snapshot]:
        return self._snaps[-1] if self._snaps else None


def resolve_global_iteration(versions: Dict[int, int]) -> int:
    """Earliest available checkpoint iteration across DP groups."""
    if not versions:
        raise ValueError("no checkpoint versions reported")
    return min(versions.values())


@dataclass(frozen=True)
class ReconcileAction:
    worker: int
    action: str              # "keep" | "rollback"
    target_iteration: int


def reconcile(worker_versions: Dict[int, int]) -> List[ReconcileAction]:
    """Per-worker action to converge on the globally consistent iteration.
    Raises if any worker is ahead by more than the snapshot depth (cannot
    happen with per-iteration snapshots + one-iteration skew, §4.2)."""
    target = resolve_global_iteration(worker_versions)
    out = []
    for w, v in sorted(worker_versions.items()):
        if v == target:
            out.append(ReconcileAction(w, "keep", target))
        elif v - target == 1:
            out.append(ReconcileAction(w, "rollback", target))
        elif v < target:
            raise AssertionError(f"worker {w} behind global target "
                                 f"({v} < {target}) — versions corrupt")
        else:
            raise AssertionError(
                f"worker {w} ahead by {v - target} > snapshot depth; "
                "multi-level insurance (full CKPT) required")
    return out
