"""TID-addressed data indexing (paper §4.1).

Workers never hold statically-partitioned data. The controller-side indexer
maps TID = (role, iteration) -> dataset indices with:

  * exact cover: each iteration's global batch partitions exactly across the
    ACTIVE dp ranks (no duplicates, no gaps) — property-tested;
  * determinism: same (seed, iteration, active_dp) -> same indices, so a
    recovered job replays identical data;
  * elasticity: shrinking/growing active_dp re-partitions the same global
    order, preserving the global sample sequence.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class Tid:
    dp: int
    pp: int
    tp: int
    iteration: int

    def key(self) -> Tuple[int, int, int, int]:
        return (self.dp, self.pp, self.tp, self.iteration)


class TidIndexer:
    def __init__(self, dataset_size: int, global_batch: int, seed: int = 0):
        if global_batch > dataset_size:
            raise ValueError("global_batch larger than dataset")
        self.dataset_size = dataset_size
        self.global_batch = global_batch
        self.seed = seed
        self._perms: Dict[int, np.ndarray] = {}

    def _perm(self, epoch: int) -> np.ndarray:
        if epoch not in self._perms:
            rng = np.random.default_rng(self.seed + epoch)
            self._perms[epoch] = rng.permutation(self.dataset_size)
            if len(self._perms) > 2:           # keep current + next epoch only
                self._perms.pop(min(self._perms))
        return self._perms[epoch]

    def global_slice(self, iteration: int) -> np.ndarray:
        """The iteration's global batch in canonical order (epoch-shuffled)."""
        start = iteration * self.global_batch
        idx = np.arange(start, start + self.global_batch)
        epochs = idx // self.dataset_size
        offs = idx % self.dataset_size
        out = np.empty(self.global_batch, dtype=np.int64)
        for e in np.unique(epochs):
            m = epochs == e
            out[m] = self._perm(int(e))[offs[m]]
        return out

    def indices(self, iteration: int, dp_rank: int, active_dp: int
                ) -> np.ndarray:
        """TID -> indices. Exact cover over active_dp ranks."""
        if not (0 <= dp_rank < active_dp):
            raise ValueError(f"dp_rank {dp_rank} outside active_dp {active_dp}")
        g = self.global_slice(iteration)
        per = self.global_batch // active_dp
        extra = self.global_batch % active_dp
        lo = dp_rank * per + min(dp_rank, extra)
        hi = lo + per + (1 if dp_rank < extra else 0)
        return g[lo:hi]
