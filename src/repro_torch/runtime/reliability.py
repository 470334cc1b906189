"""Self-driving reliability controller (paper §3.3, §4.3, §6.1 + the
ByteDance gray-failure operating report in PAPERS.md).

The dormant control-plane pieces — `core/controller.py` heartbeat liveness,
`core/detection.py` detection timeline, `runtime/straggler.py` step-time
EWMAs — become one closed loop driven by the *simulated* fabric clock:

  * **liveness**: live workers beat into the `StateController`'s lock-free
    heartbeat table every iteration (sim seconds, never wall time); the
    controller scans every `scan_period` and declares a breakdown
    `notify_latency` later. Detection latency is therefore a *measured*
    simulator output, and `SimCluster.recover()` books the measured leg
    instead of the analytic `DetectionTimeline` constant.
  * **stragglers**: per-worker modeled step times feed the
    `StragglerDetector`; a persistently slow worker's role is rebound to a
    spare (`StateController.replace_worker` — the same role-rebind path a
    failover takes, minus the state loss: the straggler itself is alive and
    provides its shard), and the cluster's synchronous step time drops back
    to the healthy pace on the next iteration.
  * **gray links**: per-edge observed-vs-expected throughput. The fabric's
    schedulers account delivered TRAIN bytes and transmit seconds; an edge
    whose observed rate over a scan window falls below
    ``degraded_ratio * spec_rate`` is *quarantined* (`fail_edge`), so BFS
    routing, the allreduce, and every recovery stream reroute around it —
    detection comes from the traffic that actually crossed the wire, not
    from reading the bandwidth knob.
  * **checkpoint cadence**: detected failures timestamp an observed-MTBF
    estimate; the full-checkpoint period is re-solved (Young–Daly,
    ``sqrt(2 * ckpt_cost * MTBF)``) and pushed to every worker's
    `CkptEngine`, so a stormy epoch checkpoints more often and a quiet one
    backs off — cadence is emergent from the failure trace.

Everything here is deterministic in sim time: the same scenario replays to
the same events, latencies, and verdicts (pinned in
`tests/test_scenario_fleet.py`).

Units: seconds of simulation time, bytes, bytes/second.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.lccl import Edge, edge_key
from repro_torch.runtime.straggler import StragglerDetector, StragglerPolicy


@dataclass(frozen=True)
class ReliabilityConfig:
    """Knobs of the self-driving loop. The detection triplet defaults match
    `DetectionTimeline` (heartbeat 1 s, scan 1 s, notify 50 ms) so the
    measured latency validates against the closed form out of the box."""
    heartbeat_period: float = 1.0      # worker beat cadence (sim s)
    scan_period: float = 1.0           # controller liveness-scan cadence
    notify_latency: float = 0.05       # breakdown-notification delay
    heartbeat_timeout: Optional[float] = None   # default: heartbeat_period
    # straggler mitigation
    straggler: Optional[StragglerPolicy] = None  # default StragglerPolicy()
    migrate_stragglers: bool = True
    # gray-failure (degraded link) detection
    quarantine_gray_edges: bool = True
    degraded_ratio: float = 0.5        # observed/spec rate below this = gray
    min_gray_observations: int = 2     # TRAIN transfers before judging
    # adaptive checkpoint cadence (Young–Daly on observed MTBF)
    adapt_cadence: bool = True
    ckpt_cost_s: float = 1.0           # modeled full-checkpoint cost
    min_full_every: int = 5
    max_full_every: int = 500

    @property
    def timeout(self) -> float:
        return self.heartbeat_timeout if self.heartbeat_timeout is not None \
            else self.heartbeat_period


@dataclass(frozen=True)
class ReliabilityEvent:
    """One control-plane decision, timestamped on the sim clock."""
    t: float
    kind: str        # detect | straggler_migrate | gray_edge | cadence
    detail: Dict[str, Any]


def adapted_full_interval(mtbf_s: float, ckpt_cost_s: float) -> float:
    """Young–Daly optimal checkpoint interval (seconds) for an observed
    MTBF: ``sqrt(2 * delta * MTBF)`` with `delta` the checkpoint cost."""
    return math.sqrt(2.0 * max(ckpt_cost_s, 1e-9) * max(mtbf_s, 1e-9))


def observed_mtbf(failure_times: List[float]) -> Optional[float]:
    """Mean inter-failure interval of a detection timestamp trace (needs at
    least two failures; None otherwise)."""
    if len(failure_times) < 2:
        return None
    ts = sorted(failure_times)
    return (ts[-1] - ts[0]) / (len(ts) - 1)


class ReliabilityController:
    """The closed loop. `SimCluster` owns one and ticks it every time the
    sim clock advances (each training step and each stalled idle window);
    everything the loop decides lands in `events` and mutates the cluster
    through its public surface (role rebind, edge quarantine, engine
    cadence) — never through wall time."""

    def __init__(self, cluster, cfg: Optional[ReliabilityConfig] = None):
        self.cluster = cluster
        self.cfg = cfg or ReliabilityConfig()
        self.events: List[ReliabilityEvent] = []
        self.straggler = StragglerDetector(
            cluster.dp, policy=self.cfg.straggler)
        # liveness bookkeeping
        self.failed_at: Dict[int, float] = {}     # noted failure instants
        self.detected: Dict[int, float] = {}      # wid -> detection instant
        self.detection_latencies: List[float] = []
        self.detection_times: List[float] = []    # for observed MTBF
        self._next_scan = self.cfg.scan_period
        # gray-edge bookkeeping: spec rate snapshot + per-edge counters seen
        self.quarantined: Dict[Edge, float] = {}  # edge -> spec bw
        self.tolerated: Dict[Edge, float] = {}    # gray but irreplaceable
        self._spec_bw: Dict[Edge, float] = {}
        self._seen: Dict[Edge, Tuple[float, float]] = {}
        self.resnapshot_fabric()
        # cadence
        self.current_full_every: Optional[int] = None
        self._migrations = 0
        self._rank_of: Dict[int, int] = {}   # wid -> current role-table rank

    # ------------------------- fabric snapshot ------------------------- #
    def resnapshot_fabric(self) -> None:
        """(Re)learn the fabric's spec rates — at attach and after an
        elastic rescale rebuilds the topology. The spec rate is what the
        link was *provisioned* at; later `set_bandwidth` degradations are
        exactly what the observed-throughput scan is there to catch."""
        topo = self.cluster.topology
        self._spec_bw = {e: sch.bw for e, sch in topo.links.items()}
        self._seen = {e: (sch.train_bytes_done, sch.train_tx_seconds)
                      for e, sch in topo.links.items()}

    # ------------------------- cluster callbacks ------------------------- #
    def note_failure(self, wids: List[int], t: float) -> None:
        """The cluster tells the loop WHEN something broke (fault injection
        time); the loop only finds out by scanning heartbeats."""
        for wid in wids:
            self.failed_at.setdefault(wid, t)

    def on_recovered(self, wids: List[int]) -> None:
        for wid in wids:
            self.failed_at.pop(wid, None)
            self.detected.pop(wid, None)
            if wid < len(self.straggler.count):
                self.straggler.count[wid] = 0
                self.straggler.ewma[wid] = 0.0

    def on_rescale(self) -> None:
        """Elastic shrink renumbered workers and rebuilt the fabric: every
        index-keyed book restarts (the new numbering shares nothing with
        the old)."""
        self.straggler = StragglerDetector(
            self.cluster.dp, policy=self.cfg.straggler)
        self.failed_at.clear()
        self.detected.clear()
        self.quarantined.clear()
        self.tolerated.clear()
        self._rank_of.clear()
        self.resnapshot_fabric()

    def pending_detected(self) -> List[int]:
        """Workers the loop has declared failed that are still down —
        what a self-driving runner should now recover."""
        return sorted(w for w in self.detected
                      if w < len(self.cluster.workers)
                      and not self.cluster.workers[w].alive)

    @property
    def last_detection_latency(self) -> Optional[float]:
        return self.detection_latencies[-1] if self.detection_latencies \
            else None

    # ------------------------- the loop ------------------------- #
    def tick(self, now: float) -> List[ReliabilityEvent]:
        """Advance the control loop to sim time `now`. Runs every due
        liveness scan (catching up if the clock jumped past several scan
        boundaries), then the straggler and gray-edge policies. Returns the
        events this tick produced."""
        start = len(self.events)
        while self._next_scan <= now:
            self._scan(self._next_scan)
            self._next_scan += self.cfg.scan_period
        self._observe_stragglers(now)
        return self.events[start:]

    def _scan(self, t_scan: float) -> None:
        ctl = self.cluster.controller
        fresh = [w for w in ctl.detect_failures(now=t_scan)
                 if w not in self.detected and w < len(self.cluster.workers)]
        for wid in fresh:
            t_detect = t_scan + self.cfg.notify_latency
            self.detected[wid] = t_detect
            lat = t_detect - self.failed_at[wid] \
                if wid in self.failed_at else None
            if lat is not None:
                self.detection_latencies.append(lat)
            self._emit(t_detect, "detect",
                       {"worker": wid, "latency_s": lat})
        if fresh:
            # one failure INCIDENT per scan, however many workers it took
            # down — the MTBF estimate is about events, not casualties
            self.detection_times.append(t_scan + self.cfg.notify_latency)
            # the measured detection leg replaces the analytic constant in
            # the next recover()'s timeline; the clock has ALREADY advanced
            # through it, so recover() must not re-pay it before streaming
            lat = [l for l in (self.detected[w] -
                               self.failed_at.get(w, self.detected[w])
                               for w in fresh)]
            self.cluster._measured_detection = max(lat)
            self.cluster._detection_elapsed = True
            if self.cfg.adapt_cadence:
                self._adapt_cadence(t_scan)
        self._scan_gray_edges(t_scan)

    # ------------------------- stragglers ------------------------- #
    def _observe_stragglers(self, now: float) -> None:
        last = getattr(self.cluster, "last_step_times", None)
        if not last:
            return
        for wid, dt in last.items():
            if wid < len(self.straggler.count):
                self.straggler.observe(wid, dt)
        self.cluster.last_step_times = None      # consume once
        if not self.cfg.migrate_stragglers:
            return
        for wid in self.straggler.stragglers():
            self._migrate(wid, now)

    def _migrate(self, wid: int, now: float) -> None:
        """Role-rebind mitigation: the straggler's role moves to a spare
        (rank `dp + k` in the role table — the same rebind a failover
        does), its unique shard streams over (overlapped with training,
        like lazy backup — not charged to the sync step), and the sim
        worker sheds its slowdown: it now models the spare."""
        cluster = self.cluster
        spare = cluster.dp + self._migrations
        self._migrations += 1
        role = cluster.controller.replace_worker(
            self._rank_of.get(wid, wid), spare)
        self._rank_of[wid] = spare
        cluster.clear_straggler(wid)
        self.straggler.count[wid] = 0
        self.straggler.ewma[wid] = 0.0
        self._emit(now, "straggler_migrate",
                   {"worker": wid, "spare_rank": spare,
                    "role": role.as_tuple(),
                    "shard_bytes": cluster.shard_nbytes()})

    # ------------------------- gray links ------------------------- #
    def _scan_gray_edges(self, t_scan: float) -> None:
        if not self.cfg.quarantine_gray_edges:
            return
        topo = self.cluster.topology
        for e, sch in topo.links.items():
            if e in self.quarantined or e in self.tolerated \
                    or e not in self._spec_bw:
                continue
            b0, s0 = self._seen.get(e, (0.0, 0.0))
            db = sch.train_bytes_done - b0
            ds = sch.train_tx_seconds - s0
            self._seen[e] = (sch.train_bytes_done, sch.train_tx_seconds)
            if ds <= 0 or db <= 0:
                continue
            if sch.n_finished < self.cfg.min_gray_observations:
                continue
            observed = db / ds
            spec = self._spec_bw[e]
            if observed >= self.cfg.degraded_ratio * spec:
                continue
            # quarantine ONLY if the fabric stays connected without the
            # edge: fencing the sole uplink between two pods would
            # partition the job — a slow link beats no link
            topo.fail_edge(*e)
            try:
                topo.path(*e)
                redundant = True
            except RuntimeError:
                redundant = False
                topo.restore_edge(*e)
            if redundant:
                self.quarantined[e] = spec
            else:
                self.tolerated[e] = spec
            self._emit(t_scan, "gray_edge",
                       {"edge": e, "observed_bps": observed,
                        "spec_bps": spec, "ratio": observed / spec,
                        "quarantined": redundant})

    def release_edge(self, u: int, v: int) -> None:
        """Lift a quarantine after the link is repaired (scenario heal)."""
        e = edge_key(u, v)
        if self.quarantined.pop(e, None) is not None:
            self.cluster.topology.restore_edge(*e)
        self.tolerated.pop(e, None)
        sch = self.cluster.topology.links.get(e)
        if sch is not None:
            self._seen[e] = (sch.train_bytes_done, sch.train_tx_seconds)

    # ------------------------- cadence ------------------------- #
    def _adapt_cadence(self, now: float) -> None:
        mtbf = observed_mtbf(self.detection_times)
        if mtbf is None:
            return
        interval = adapted_full_interval(mtbf, self.cfg.ckpt_cost_s)
        every = int(round(interval / max(self.cluster.t_iter_model, 1e-9)))
        every = max(self.cfg.min_full_every,
                    min(self.cfg.max_full_every, every))
        if every == self.current_full_every:
            return
        self.current_full_every = every
        for w in self.cluster.workers:
            w.engine.cfg.full_every = every
        self._emit(now, "cadence",
                   {"observed_mtbf_s": mtbf, "interval_s": interval,
                    "full_every": every})

    def _emit(self, t: float, kind: str, detail: Dict[str, Any]) -> None:
        self.events.append(ReliabilityEvent(t, kind, dict(detail)))
