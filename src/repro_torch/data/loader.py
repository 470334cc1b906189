"""FFTrainer data loader (paper §4.1): just-in-time preloading over the
training network with a bounded FIFO host buffer.

Buffer bound (paper): B = min(4*s*b*k, 6*s*b*phi*V/C) — never more than k
iterations ahead, never more than fits in the compute-hidden transfer window.

Sources: deterministic synthetic tokens (hash-seeded, reproducible across
recoveries) and a binary memmap corpus. Preloading is driven by the runtime:
STATE transfers are submitted to the LCCL link scheduler and only move when
the link is idle (§5.3).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from pathlib import Path
from typing import Deque, Dict, Optional, Tuple

import numpy as np

from repro_torch.data.indexer import TidIndexer


def buffer_bytes(seq_len: int, batch_per_rank: int, k: int, phi: float,
                 bandwidth: float, flops: float) -> float:
    """Paper §4.1: B = min(4 s b k, 6 s b phi V / C)."""
    return min(4.0 * seq_len * batch_per_rank * k,
               6.0 * seq_len * batch_per_rank * phi * bandwidth / flops)


class SyntheticTokens:
    """Deterministic virtual corpus: sample i is PRNG(seed, i) tokens."""

    def __init__(self, size: int, seq_len: int, vocab: int, seed: int = 0):
        self.size, self.seq_len, self.vocab, self.seed = size, seq_len, vocab, seed

    def fetch(self, indices: np.ndarray) -> np.ndarray:
        out = np.empty((len(indices), self.seq_len + 1), dtype=np.int32)
        for row, i in enumerate(indices):
            rng = np.random.default_rng((self.seed << 32) ^ int(i))
            out[row] = rng.integers(0, self.vocab, self.seq_len + 1)
        return out

    @property
    def sample_bytes(self) -> int:
        return 4 * (self.seq_len + 1)


class MemmapTokens:
    """Flat int32 binary corpus of shape (size, seq_len+1)."""

    def __init__(self, path: Path, seq_len: int):
        self.seq_len = seq_len
        self._mm = np.memmap(path, dtype=np.int32, mode="r")
        self._mm = self._mm.reshape(-1, seq_len + 1)
        self.size = self._mm.shape[0]

    def fetch(self, indices: np.ndarray) -> np.ndarray:
        return np.asarray(self._mm[indices])

    @property
    def sample_bytes(self) -> int:
        return 4 * (self.seq_len + 1)


@dataclass
class BufferedBatch:
    iteration: int
    tokens: np.ndarray


class PrefetchingLoader:
    """Per-DP-rank loader: FIFO buffer of up to k future iterations; evicts
    after consumption; throttles preloading against the buffer bound."""

    def __init__(self, source, indexer: TidIndexer, dp_rank: int,
                 active_dp: int, k: int = 10,
                 byte_limit: Optional[float] = None):
        self.source = source
        self.indexer = indexer
        self.dp_rank = dp_rank
        self.active_dp = active_dp
        self.k = k
        self.byte_limit = byte_limit
        self._buf: Deque[BufferedBatch] = collections.deque()
        self.preload_bytes_total = 0

    # ---- naming resolution: TID -> buffered batch (paper's get_item) ---- #
    def get(self, iteration: int) -> np.ndarray:
        while self._buf and self._buf[0].iteration < iteration:
            self._buf.popleft()                      # evict consumed
        if not self._buf or self._buf[0].iteration != iteration:
            self._load(iteration)                    # demand miss (recovery)
        batch = self._buf.popleft()
        assert batch.iteration == iteration
        return batch.tokens

    def _load(self, iteration: int) -> None:
        idx = self.indexer.indices(iteration, self.dp_rank, self.active_dp)
        self._buf.appendleft(BufferedBatch(iteration, self.source.fetch(idx)))
        self.preload_bytes_total += len(idx) * self.source.sample_bytes

    @property
    def buffered_bytes(self) -> int:
        return sum(b.tokens.nbytes for b in self._buf)

    def can_preload(self) -> bool:
        if len(self._buf) >= self.k:
            return False
        if self.byte_limit is not None and \
                self.buffered_bytes >= self.byte_limit:
            return False
        return True

    def preload_next(self, next_needed: int) -> Optional[int]:
        """Preload the next un-buffered iteration >= next_needed; returns the
        bytes transferred (for the STATE queue) or None if throttled."""
        if not self.can_preload():
            return None
        it = (self._buf[-1].iteration + 1) if self._buf else next_needed
        idx = self.indexer.indices(it, self.dp_rank, self.active_dp)
        self._buf.append(BufferedBatch(it, self.source.fetch(idx)))
        nbytes = len(idx) * self.source.sample_bytes
        self.preload_bytes_total += nbytes
        return nbytes

    def repartition(self, active_dp: int, dp_rank: Optional[int] = None
                    ) -> None:
        """Elastic rescale: drop buffered batches (indices changed)."""
        self.active_dp = active_dp
        if dp_rank is not None:
            self.dp_rank = dp_rank
        self._buf.clear()
