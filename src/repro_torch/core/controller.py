"""State controller (paper §3.3, §4.3): a single control-plane process per job.

Responsibilities (all lightweight; scalability measured in fig10 benchmark):
  * liveness: lock-free heartbeat slots, one per reporting worker (local
    rank 0 per host => <= N/8 connections), failure detection within ~1 s;
  * role management: role<->rank decoupling via lccl.RoleTable; on failure it
    rebinds the failed role to the replacement so model loading can start
    before connections are up;
  * data indexing: computes the TID=(role, iter) -> data-index mapping each
    iteration and sends it only to each model-parallel group's rank 0;
  * consistency: tracks per-DP-group checkpoint versions and picks the
    earliest globally-available iteration for recovery (§4.2).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.lccl import LockFreeAddressArray, Role, RoleTable


class HeartbeatTable:
    """Lock-free array of last-seen timestamps; O(workers) vectorized scan."""

    def __init__(self, n_workers: int):
        self.last_seen = np.full(n_workers, -np.inf)

    def beat(self, worker: int, now: float) -> None:
        self.last_seen[worker] = now

    def beat_many(self, workers: np.ndarray, now: float) -> None:
        self.last_seen[workers] = now

    def failed(self, now: float, timeout: float = 1.0) -> np.ndarray:
        return np.flatnonzero(self.last_seen < now - timeout)


@dataclass
class DataAssignment:
    iteration: int
    # per dp-rank index ranges into the (virtual) global dataset order
    ranges: Dict[int, Tuple[int, int]]


class StateController:
    def __init__(self, *, dp: int, pp: int, tp: int, global_batch: int,
                 heartbeat_timeout: float = 1.0, seed: int = 0):
        self.dp, self.pp, self.tp = dp, pp, tp
        self.n_workers = dp * pp * tp
        self.global_batch = global_batch
        self.roles = RoleTable(dp, pp, tp)
        self.addresses = LockFreeAddressArray(self.n_workers)
        self.heartbeats = HeartbeatTable(self.n_workers)
        self.timeout = heartbeat_timeout
        self.iteration = 0
        self._rng = np.random.default_rng(seed)
        self._perm_epoch = -1
        self._perm: Optional[np.ndarray] = None
        # per-DP-group newest checkpoint iteration (consistency, §4.2)
        self.ckpt_versions = np.zeros(dp, dtype=np.int64)
        self.active_dp = dp

    # ---------------- liveness ---------------- #
    # `now` is the SIM clock and is required: the old wall-clock fallback
    # (`time.monotonic()` when now was None) coupled detection latency to
    # host scheduling and broke replay bit-identity (simlint SIM001).
    def beat(self, worker: int, now: float) -> None:
        self.heartbeats.beat(worker, now)

    def detect_failures(self, now: float) -> List[int]:
        return list(self.heartbeats.failed(now, self.timeout))

    # ---------------- data indexing (TID -> indices) ---------------- #
    def assignment(self, iteration: int, dataset_size: int,
                   epoch_shuffle: bool = True) -> DataAssignment:
        """Exact-cover partition of the iteration's global batch across the
        ACTIVE dp ranks (elastic: shrinks/grows with active_dp)."""
        per = self.global_batch // self.active_dp
        start = (iteration * self.global_batch) % max(dataset_size, 1)
        ranges = {}
        for d in range(self.active_dp):
            ranges[d] = (start + d * per, start + (d + 1) * per)
        return DataAssignment(iteration, ranges)

    def indices_for(self, assign: DataAssignment, dp_rank: int,
                    dataset_size: int) -> np.ndarray:
        lo, hi = assign.ranges[dp_rank]
        epoch = (lo // max(dataset_size, 1))
        if epoch != self._perm_epoch:
            self._perm = self._rng.permutation(dataset_size)
            self._perm_epoch = epoch
        idx = np.arange(lo, hi) % dataset_size
        return self._perm[idx]

    def fanout_targets(self) -> List[int]:
        """Controller sends indices only to each TP group's rank 0 (§4.3)."""
        return [self.roles.role_to_rank[(d, p, 0)]
                for d in range(self.dp) for p in range(self.pp)]

    # ---------------- consistency (§4.2) ---------------- #
    def report_ckpt(self, dp_group: int, iteration: int) -> None:
        self.ckpt_versions[dp_group] = iteration

    def resolve_recovery_iteration(self) -> int:
        """Earliest globally-available checkpoint: min over DP groups."""
        return int(self.ckpt_versions[:self.active_dp].min())

    # ---------------- failover hooks ---------------- #
    def replace_worker(self, failed_rank: int, new_rank: int) -> Role:
        return self.roles.rebind(failed_rank, new_rank)

    def shrink_dp(self, lost_dp_groups: Sequence[int]) -> int:
        """Elastic degrade: drop lost DP groups; data indexing re-partitions
        on the next assignment() call."""
        self.active_dp = max(1, self.active_dp - len(set(lost_dp_groups)))
        return self.active_dp

    def restore_dp(self, dp: Optional[int] = None) -> int:
        self.active_dp = self.dp if dp is None else dp
        return self.active_dp
