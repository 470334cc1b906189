"""Straggler detection & mitigation.

Synchronous SPMD training runs at the pace of the slowest worker. The
controller tracks per-worker step-time EWMAs; a worker persistently slower
than the cluster median by `threshold` is flagged, and mitigation migrates
its role to a spare (same path as failover, minus state loss — the straggler
itself provides its unique shard)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class StragglerPolicy:
    ewma_alpha: float = 0.2
    threshold: float = 1.5            # x median step time
    min_observations: int = 5


class StragglerDetector:
    def __init__(self, n_workers: int, policy: Optional[StragglerPolicy] = None):
        # default built per-instance: a shared StragglerPolicy() default
        # would alias tuning across every detector in the process
        self.policy = policy if policy is not None else StragglerPolicy()
        self.ewma = np.zeros(n_workers)
        self.count = np.zeros(n_workers, dtype=np.int64)

    def observe(self, worker: int, step_time: float) -> None:
        a = self.policy.ewma_alpha
        if self.count[worker] == 0:
            self.ewma[worker] = step_time
        else:
            self.ewma[worker] = a * step_time + (1 - a) * self.ewma[worker]
        self.count[worker] += 1

    def stragglers(self) -> List[int]:
        ready = self.count >= self.policy.min_observations
        if not ready.any():
            return []
        med = float(np.median(self.ewma[ready]))
        if med <= 0:
            return []
        flag = ready & (self.ewma > self.policy.threshold * med)
        return list(np.flatnonzero(flag))

    def cluster_step_time(self) -> float:
        """Synchronous step time = max over workers (what mitigation saves)."""
        ready = self.count > 0
        return float(self.ewma[ready].max()) if ready.any() else 0.0


def mitigation_speedup(step_times: np.ndarray, straggler_factor: float
                       ) -> float:
    """Expected step-time improvement from migrating the straggler away.

    `step_times` are the healthy per-worker baselines; the straggler runs at
    `straggler_factor` x the slowest of them. After migration the cluster
    paces at the max over the *remaining* workers — the straggler's own
    (inflated) time must not appear in the denominator.
    """
    base = np.sort(np.asarray(step_times, dtype=float))
    with_straggler = base[-1] * straggler_factor
    rest = base[:-1]
    without = rest[-1] if rest.size else with_straggler
    return with_straggler / max(without, 1e-9)
