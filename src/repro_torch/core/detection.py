"""Cross-layer failure detection (paper §6.1): interruptible blocking
collectives.

Instead of waiting out a 10-minute NCCL timeout, a blocked worker waits on
EITHER communication completion OR a controller breakdown notification. The
runtime simulator implements the rendezvous with threading primitives; the
same wake-on-either-signal semantics a TPU runtime gets from its coordination
service."""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set


class WorkerInterrupted(Exception):
    """Raised inside a blocked collective when the controller signals a
    breakdown — lets the main thread exit cleanly and run lazy backup."""

    def __init__(self, failed_workers: List[int]):
        super().__init__(f"breakdown: failed workers {failed_workers}")
        self.failed_workers = failed_workers


class InterruptibleBarrier:
    """All-worker rendezvous standing in for a blocking collective. Waiting
    releases the GIL (threading.Condition), so the agent thread can deliver a
    breakdown notification — the paper's two benefits of the hybrid signal."""

    def __init__(self, n_workers: int):
        self.n = n_workers
        self._cond = threading.Condition()
        self._arrived: Set[int] = set()
        self._generation = 0
        self._broken: Optional[List[int]] = None

    def wait(self, worker: int, timeout: Optional[float] = None) -> int:
        with self._cond:
            if self._broken is not None:
                raise WorkerInterrupted(self._broken)
            gen = self._generation
            self._arrived.add(worker)
            if len(self._arrived) == self.n:
                self._arrived.clear()
                self._generation += 1
                self._cond.notify_all()
                return gen
            while gen == self._generation:
                ok = self._cond.wait(timeout)
                if self._broken is not None:
                    raise WorkerInterrupted(self._broken)
                if not ok:
                    raise TimeoutError(
                        f"collective timeout (worker {worker}) — this is the "
                        "slow path FFTrainer avoids")
            return gen

    def interrupt(self, failed_workers: List[int]) -> None:
        """Controller-triggered breakdown notification (fast path)."""
        with self._cond:
            self._broken = list(failed_workers)
            self._cond.notify_all()

    def reset(self, n_workers: Optional[int] = None) -> None:
        with self._cond:
            if n_workers is not None:
                self.n = n_workers
            self._arrived.clear()
            self._broken = None
            self._generation += 1
            self._cond.notify_all()


@dataclass
class DetectionTimeline:
    """Accounting of detection latency for the failover benchmarks."""
    heartbeat_period: float = 1.0
    controller_scan_period: float = 1.0
    notify_latency: float = 0.05

    def detection_time(self) -> float:
        """Worst-case: miss one heartbeat + one scan + notification."""
        return (self.heartbeat_period + self.controller_scan_period
                + self.notify_latency)

    def nccl_timeout_baseline(self) -> float:
        return 600.0  # NCCL default timeout (paper §3.1)
