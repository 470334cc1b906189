"""LCCL — lightweight collective communication layer (paper §5), control plane.

On TPU, the data plane (ring collectives) is compiler-scheduled, so what
transfers from the paper is:

  * role <-> rank decoupling (§5.2): a worker's logical role (r_d, r_p, r_t)
    is stable across restarts; its network rank is whatever slot it lands on.
    Model-partition loading keys off the ROLE and can start before
    connections finish — the overlap that cuts restart latency.
  * lock-free connection building (§5.1): a single address array, one slot per
    rank, written once and flagged; each rank reads only its ring targets —
    no barriers, O(1) work per worker, O(N) total.
  * group-free ring membership (§5.1): with static ring parallelism each
    worker has <=4 peers (prev/next in DP and PP rings); we materialize
    exactly those.
  * TRAIN/STATE two-queue link scheduling (§5.3): TRAIN preempts; STATE moves
    only when the link is idle.

The link model grows in layers, matching real cluster fabrics:

  * `LinkScheduler`  — one link: two queues, TRAIN preempts STATE, optional
    per-transfer delivery latency.
  * `LinkTopology`   — a graph of per-edge schedulers (flat ring or full
    mesh): per-edge contention, dark nodes/edges, BFS live-path routing,
    store-and-forward multi-hop items, and bidirectional (edge-disjoint)
    path splitting by residual bandwidth.
  * `PodFabric`      — the hierarchical tier: nodes grouped into pods, each
    pod an ICI ring at full link bandwidth, pods joined by lower-bandwidth /
    higher-latency DCN gateway edges. Failure *storms* (`inject_storm`)
    darken correlated pods/edges from a seed, so recovery has to race around
    a darkened pod over DCN.

Units, everywhere in this module: bandwidths are **bytes/second**, sizes are
**bytes**, times and latencies are **seconds** on the simulation clock.

These are real data structures measured by benchmarks (fig8/fig10) and driven
by the failover runtime.
"""
from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Role:
    """Logical position in the 3D-parallel job."""
    dp: int
    pp: int
    tp: int

    def as_tuple(self) -> Tuple[int, int, int]:
        return (self.dp, self.pp, self.tp)


class RoleTable:
    """Bidirectional role <-> rank mapping, stable roles across rank churn."""

    def __init__(self, dp: int, pp: int, tp: int):
        self.shape = (dp, pp, tp)
        self.role_to_rank: Dict[Tuple[int, int, int], int] = {}
        self.rank_to_role: Dict[int, Role] = {}
        rank = 0
        for d in range(dp):
            for p in range(pp):
                for t in range(tp):
                    self.bind(Role(d, p, t), rank)
                    rank += 1

    def bind(self, role: Role, rank: int) -> None:
        old = self.role_to_rank.get(role.as_tuple())
        if old is not None:
            self.rank_to_role.pop(old, None)
        self.role_to_rank[role.as_tuple()] = rank
        self.rank_to_role[rank] = role

    def rebind(self, failed_rank: int, new_rank: int) -> Role:
        """A replacement worker (new rank) takes over the failed worker's
        role. Returns the role so the newcomer knows WHICH partition to load
        — before any connection exists (the §5.2 overlap)."""
        role = self.rank_to_role.pop(failed_rank)
        self.bind(role, new_rank)
        return role

    def ring_peers(self, role: Role) -> Dict[str, Role]:
        """Group-free membership: the <=4 peers of ring 3D parallelism."""
        dp, pp, tp = self.shape
        return {
            "dp_next": Role((role.dp + 1) % dp, role.pp, role.tp),
            "dp_prev": Role((role.dp - 1) % dp, role.pp, role.tp),
            "pp_next": Role(role.dp, (role.pp + 1) % pp, role.tp),
            "pp_prev": Role(role.dp, (role.pp - 1) % pp, role.tp),
        }


class LockFreeAddressArray:
    """§5.1: one write-once slot per rank + a readiness flag; readers poll
    their targets only. NumPy slots stand in for the shared-memory array."""

    def __init__(self, n: int):
        self.addrs = np.zeros(n, dtype=np.int64)   # packed address stand-in
        self.ready = np.zeros(n, dtype=bool)

    def publish(self, rank: int, addr: int) -> None:
        self.addrs[rank] = addr
        self.ready[rank] = True        # flag write is the release

    def try_read(self, rank: int) -> Optional[int]:
        if self.ready[rank]:
            return int(self.addrs[rank])
        return None

    def connect_all(self, rank: int, targets: List[int]) -> List[int]:
        """Resolve this rank's ring targets (no barrier involved; spins until
        each target has published — bounded in tests/benchmarks)."""
        out = []
        for t in targets:
            a = self.try_read(t)
            while a is None:           # lock-free spin
                a = self.try_read(t)
            out.append(a)
        return out


# --------------------------------------------------------------------------- #
# TRAIN/STATE two-queue link scheduler (§5.3)
# --------------------------------------------------------------------------- #
@dataclass
class Transfer:
    kind: str        # "TRAIN" | "STATE"
    size: float      # bytes
    t_submit: float
    t_start: float = 0.0
    t_finish: float = 0.0
    finished: bool = False    # set by the scheduler (t_finish can be 0.0)


class LinkScheduler:
    """Event-driven single-link model: TRAIN monopolizes the link; STATE runs
    only when no TRAIN transfer is queued or in flight. STATE transfers are
    preemptible at `quantum` granularity (checkpoint/data chunks): a quantum
    interrupted by an arriving TRAIN transfer is aborted and retried once the
    link is idle again.

    `bandwidth` is bytes/second; `quantum` is the STATE preemption grain in
    bytes; `latency` (seconds) is the per-transfer delivery delay: a transfer
    occupies the link for ``size / bandwidth`` seconds and its receiver sees
    it ``latency`` seconds after transmission ends (`t_finish` includes the
    latency; link occupancy does not). Chunks of one stream pipeline on a
    link, so a chunked artifact pays the latency once per *hop*, not once
    per chunk.

    The simulation clock (`now`) persists across `run(until=...)` calls, and a
    partially-transferred STATE item (`_rem`/`_rem_bytes`) is carried over, so
    a scheduler can be advanced incrementally — e.g. one training iteration at
    a time — and residual state resumes exactly where it left off.

    Two event-clock primitives let `LinkTopology` advance a whole fabric of
    these schedulers in cross-edge event order: `peek_next_finish(until)`
    reports (without mutating anything) WHEN this link's next transfer would
    complete, and ``run(until, stop_after_finish=True)`` advances exactly to
    that completion, leaving the clock at the event instant instead of the
    window horizon."""

    def __init__(self, bandwidth: float, quantum: float = 1 << 20,
                 latency: float = 0.0):
        self.bw = bandwidth
        self.quantum = quantum
        self.latency = latency
        self.now = 0.0
        self.done: List[Transfer] = []
        self.n_finished = 0            # survives done-list pruning
        # observed-throughput accounting (gray-failure detection): delivered
        # TRAIN payload and the transmit seconds it actually took at the
        # CURRENT bw — a silently degraded link shows up as delivered bytes
        # per transmit second falling below the provisioned rate
        self.train_bytes_done = 0.0
        self.train_tx_seconds = 0.0
        self._train: List[Transfer] = []
        self._state: List[Transfer] = []
        self._rem: Optional[Transfer] = None   # STATE mid-flight across runs
        self._rem_bytes = 0.0

    def submit(self, kind: str, size: float, t: float) -> Transfer:
        tr = Transfer(kind, size, t)
        # queues stay sorted by t_submit at all times (insort_right keeps
        # same-instant submissions in submission order), so run/peek walk
        # from the head with cursors instead of re-sorting per call; run
        # prunes its consumed prefix in one slice. Submissions in
        # non-decreasing time order (the overwhelmingly common case) insert
        # at the tail, so insort costs no element shifts there
        q = self._train if kind == "TRAIN" else self._state
        bisect.insort_right(q, tr, key=lambda x: x.t_submit)
        return tr

    def cancel(self, tr: Transfer) -> bool:
        """Withdraw a queued transfer that has NOT started moving bytes.

        Returns True when `tr` was still sitting in its queue (removed by
        identity — equal-valued transfers of one chunked stream must not
        alias); False when it already finished or is the mid-flight STATE
        item (`_rem`), whose transmitted quanta cannot be un-sent. This is
        the substrate for mid-transfer re-balancing: only never-started
        chunks are re-routable, so delivered bytes are never re-sent."""
        if tr.finished or tr is self._rem:
            return False
        q = self._train if tr.kind == "TRAIN" else self._state
        for i, queued in enumerate(q):
            if queued is tr:
                del q[i]
                return True
        return False

    def _finish(self, tr: Transfer, tx_end: float) -> None:
        """Mark `tr` delivered: transmission ended at `tx_end`; the receiver
        sees it `latency` seconds later (`t_finish`). The link itself is free
        again at `tx_end`, so only transmission time gates later transfers."""
        tr.t_finish = tx_end + self.latency
        tr.finished = True
        self.done.append(tr)
        self.n_finished += 1
        if tr.kind == "TRAIN":
            self.train_bytes_done += tr.size
            self.train_tx_seconds += tr.size / self.bw

    @property
    def idle(self) -> bool:
        return not (self._train or self._state or self._rem is not None)

    def pending_bytes(self, kind: Optional[str] = None) -> float:
        out = 0.0
        if kind in (None, "TRAIN"):
            out += sum(x.size for x in self._train)
        if kind in (None, "STATE"):
            out += sum(x.size for x in self._state) + self._rem_bytes
        return out

    def run(self, until: float, *, stop_after_finish: bool = False) -> float:
        """Simulate from `now` to `until`; returns link-busy seconds. A
        transfer started before `until` runs to completion (TRAIN is never
        preempted; a STATE quantum is all-or-nothing), so `now` may end up
        slightly past `until`.

        With ``stop_after_finish=True`` (the event-clock stepping mode used
        by `LinkTopology.run`) the simulation stops right after the FIRST
        transfer completion and `now` is left at that completion's
        transmission-end instant — not clamped to `until` — so forwarded
        submissions landing at that instant are still in this link's
        future."""
        t = self.now
        busy = 0.0
        finished = False
        pend_t = self._train           # sorted by t_submit (see submit)
        pend_s = self._state
        it = is_ = 0                   # consumed-prefix cursors
        rem_s, rem_bytes = self._rem, self._rem_bytes
        while not finished and t < until and \
                (it < len(pend_t) or is_ < len(pend_s) or rem_s is not None):
            if it < len(pend_t) and pend_t[it].t_submit <= t:
                tr = pend_t[it]        # earliest-submitted ready TRAIN
                it += 1
                tr.t_start = max(t, tr.t_submit)
                dt = tr.size / self.bw
                t = tr.t_start + dt
                busy += dt
                self._finish(tr, tx_end=t)
                finished = stop_after_finish
                continue
            # link idle for TRAIN: advance STATE by one quantum
            nxt_t = pend_t[it].t_submit if it < len(pend_t) else float("inf")
            if rem_s is None and is_ < len(pend_s) and \
                    pend_s[is_].t_submit <= t:
                rem_s = pend_s[is_]
                is_ += 1
                rem_s.t_start = max(t, rem_s.t_submit)
                rem_bytes = rem_s.size
            if rem_s is not None:
                if rem_bytes <= 0:          # zero-byte transfer: instant
                    self._finish(rem_s, tx_end=t)
                    rem_s = None
                    finished = stop_after_finish
                    continue
                chunk = min(self.quantum, rem_bytes)
                dt = chunk / self.bw
                if t + dt > nxt_t:      # TRAIN arrives mid-quantum: yield
                    t = nxt_t           # (aborted quantum is retried later)
                    continue
                t += dt
                busy += dt
                rem_bytes -= chunk
                if rem_bytes <= 0:
                    self._finish(rem_s, tx_end=t)
                    rem_s = None
                    finished = stop_after_finish
                continue
            # nothing runnable: jump to the next submission — but never past
            # the window horizon: a submission at t >= until belongs to a
            # later window, and overshooting the clock to it would delay
            # transfers forwarded onto this link in between (breaking
            # windowed == drained)
            nxt_s = pend_s[is_].t_submit if is_ < len(pend_s) \
                else float("inf")
            nxt = min(nxt_t, nxt_s)
            if nxt >= until:
                break
            t = max(t, nxt)
        del pend_t[:it]                # prune consumed prefixes in one move
        del pend_s[:is_]
        self._rem, self._rem_bytes = rem_s, rem_bytes
        if stop_after_finish or until == float("inf"):
            self.now = t
        else:
            self.now = max(t, until)
        return busy

    def peek_next_finish(self, until: float = float("inf")
                         ) -> Optional[float]:
        """Transmission-end time of the FIRST transfer `run(until)` would
        complete from the current state, or None when no queued transfer
        finishes in the window. Pure dry-run — nothing mutates — mirroring
        `run`'s scheduling decisions exactly, including the stable
        submission-order tie-break the sorted queues encode
        (`tests/test_event_clock.py` asserts the two agree on randomized
        workloads with same-instant submissions). Cursors walk the sorted
        queues in place, so a peek costs only the quanta up to the first
        completion — no copies, no sorting."""
        t = self.now
        pend_t, pend_s = self._train, self._state
        it = is_ = 0                   # heads of the unconsumed queues
        rem = self._rem_bytes if self._rem is not None else None
        while t < until and (it < len(pend_t) or is_ < len(pend_s)
                             or rem is not None):
            if it < len(pend_t) and pend_t[it].t_submit <= t:
                tr = pend_t[it]
                return max(t, tr.t_submit) + tr.size / self.bw
            nxt_t = pend_t[it].t_submit if it < len(pend_t) else float("inf")
            if rem is None and is_ < len(pend_s) and \
                    pend_s[is_].t_submit <= t:
                rem = pend_s[is_].size
                is_ += 1
            if rem is not None:
                if rem <= 0:                # zero-byte transfer: instant
                    return t
                chunk = min(self.quantum, rem)
                dt = chunk / self.bw
                if t + dt > nxt_t:      # TRAIN arrives mid-quantum: yield
                    t = nxt_t
                    continue
                t += dt
                rem -= chunk
                if rem <= 0:
                    return t
                continue
            nxt_s = pend_s[is_].t_submit if is_ < len(pend_s) \
                else float("inf")
            nxt = min(nxt_t, nxt_s)
            if nxt == float("inf"):
                break
            t = max(t, nxt)
        return None

    def drain(self) -> float:
        """Run until every submitted transfer has finished; returns the final
        clock. A single pass: ``run(until=inf)`` processes arrivals in event
        order (aborted quanta retried in place), so the clock lands exactly
        on the last transmission end — no horizon slack to clamp away, and
        nothing to retry, however dense the TRAIN arrivals."""
        self.run(until=float("inf"))
        return self.now


# --------------------------------------------------------------------------- #
# Per-link topology: one LinkScheduler per edge (ISSUE 2 tentpole), grown
# into a hierarchical pod fabric with edge tiers + latency (ISSUE 3)
# --------------------------------------------------------------------------- #
Edge = Tuple[int, int]

# edge tiers: ICI = intra-pod ring link, DCN = inter-pod gateway hop
TIER_ICI = "ici"
TIER_DCN = "dcn"


class RoutingError(RuntimeError):
    """No usable route through the fabric.

    Raised by `LinkTopology.path` / `disjoint_paths` consumers,
    `split_bytes` (no candidate paths) and `least_loaded_edge` (no live
    edges). Subclasses `RuntimeError` so existing probe sites (the
    reliability controller's partition probe, `estimate_stream_seconds`'s
    unreachable guard) keep working, but carries the routing context the
    bare message used to bury in a string:

    * ``src`` / ``dst`` — the requested endpoints (None when the failure
      is not endpoint-specific, e.g. an empty live-edge set),
    * ``dark_nodes`` / ``dark_edges`` — the dark sets at raise time,
      sorted tuples, so handlers can report or react without re-querying
      a topology that may have changed since."""

    def __init__(self, message: str, *, src: Optional[int] = None,
                 dst: Optional[int] = None,
                 dark_nodes: Sequence[int] = (),
                 dark_edges: Sequence[Edge] = ()):
        super().__init__(message)
        self.src = src
        self.dst = dst
        self.dark_nodes: Tuple[int, ...] = tuple(sorted(dark_nodes))
        self.dark_edges: Tuple[Edge, ...] = tuple(sorted(dark_edges))


def edge_key(u: int, v: int) -> Edge:
    """Canonical (undirected) edge identity."""
    return (u, v) if u <= v else (v, u)


@dataclass
class PathTransfer:
    """One item moving hop-by-hop (store-and-forward) along an edge path.

    Duck-types the `Transfer` surface that `StreamTicket` consumes
    (`finished`, `t_finish`, `t_submit`), so transport tickets work unchanged
    whether a chunk crossed one edge or rode a multi-hop recovery path."""
    kind: str
    size: float
    t_submit: float
    path: Tuple[Edge, ...]
    hop: int = 0                       # index of the edge currently in flight
    transfer: Optional[Transfer] = None
    finished: bool = False
    t_finish: float = 0.0

    @property
    def edge(self) -> Optional[Edge]:
        return self.path[self.hop] if self.hop < len(self.path) else None

    @property
    def delivery_edge(self) -> Optional[Edge]:
        """The fabric edge whose far end hands the item to its consumer —
        the LAST hop of the routed path (None for local delivery). This is
        the edge per-edge accounting (e.g. the cluster's instant
        hidden/exposed books) should attribute the delivery to."""
        return self.path[-1] if self.path else None


class LinkTopology:
    """A graph of per-edge `LinkScheduler`s — the cluster fabric.

    * ``kind="ring"``: edge (i, i+1 mod n) for every i — the DP-ring fabric
      the paper's neighbor shards and allreduce actually use.
    * ``kind="full"``: every pair — an idealized fully-connected fabric.
    * `PodFabric` (subclass) builds the hierarchical tier: per-pod ICI rings
      joined by DCN gateway edges.

    Each edge is an independent TRAIN/STATE two-queue scheduler with its own
    bandwidth (bytes/s) and delivery latency (seconds), so contention is
    per-edge instead of uniformly smeared: a saturated hotspot edge delays
    only the streams routed across it. Every edge carries a *tier* tag
    (``TIER_ICI`` / ``TIER_DCN``); a flat topology is all-ICI. A failed
    node's incident edges go dark (``fail_node``) and ``path`` routes around
    them; individual edges can also be failed (``fail_edge``) to force
    multi-hop detours.

    Multi-hop items move store-and-forward: a chunk fully crosses one edge,
    then is submitted on the next at its arrival time (``_pump``). Edges
    advance in cross-edge EVENT ORDER (``run`` processes the globally
    earliest completion first and forwards its next hop at the true arrival
    instant), so a chunk crosses as many hops inside one ``run(until=...)``
    window as its exact schedule allows — windowed timings equal ``drain()``
    timings to float precision."""

    def __init__(self, n: int, bandwidth: float, quantum: float = 1 << 20,
                 kind: str = "ring",
                 edge_bw: Optional[Dict[Edge, float]] = None,
                 latency: float = 0.0,
                 edge_latency: Optional[Dict[Edge, float]] = None):
        assert kind in ("ring", "full"), kind
        assert n >= 1
        self.kind = kind
        if kind == "ring":
            edges = {edge_key(i, (i + 1) % n) for i in range(n)} if n > 1 \
                else set()
        else:
            edges = {(i, j) for i in range(n) for j in range(i + 1, n)}
        self._init_fabric(n, edges, {e: TIER_ICI for e in edges}, bandwidth,
                          quantum, edge_bw, latency, edge_latency)

    def _init_fabric(self, n: int, edges, tiers: Dict[Edge, str],
                     default_bw: float, quantum: float,
                     edge_bw: Optional[Dict[Edge, float]],
                     default_latency: float,
                     edge_latency: Optional[Dict[Edge, float]]) -> None:
        """Shared constructor core: one `LinkScheduler` per edge, with
        per-edge bandwidth (bytes/s), latency (s), and tier tag."""
        self.n = n
        self.default_bw = default_bw
        self.quantum = quantum
        bw = dict(edge_bw or {})
        lat = dict(edge_latency or {})
        self.edge_tier: Dict[Edge, str] = dict(tiers)
        self.links: Dict[Edge, LinkScheduler] = {
            e: LinkScheduler(bw.get(e, default_bw), quantum=quantum,
                             latency=lat.get(e, default_latency))
            for e in sorted(edges)}
        self.dark_nodes: set = set()
        self.dark_edges: set = set()
        # plan compilation (core/plan.py): `compile_plan` switches `run` to
        # the decoupled fast path (exact, skips the global peek/min event
        # loop for edges no pending multi-hop item couples); `_epoch` counts
        # topology-changing events (dark nodes/edges, bandwidth edits) so
        # compiled traffic plans and the BFS routing cache know when their
        # precomputed state went stale
        self.compile_plan = False
        self._epoch = 0
        self._path_cache: Dict[Tuple[int, int], Tuple[Edge, ...]] = {}
        # in-flight multi-hop items, keyed by the identity of the Transfer
        # currently carrying them: the event loop in `run` knows exactly
        # which transfer just finished, so forwarding is an O(1) dict pop
        # instead of a scan over every item in the fabric (keys stay valid:
        # a mapped Transfer is referenced by its PathTransfer, so its id
        # cannot be recycled while mapped)
        self._inflight: Dict[int, PathTransfer] = {}

    # ------------------------- graph queries ------------------------- #
    def edges(self) -> List[Edge]:
        return list(self.links)

    def tier(self, u: int, v: int) -> str:
        """Tier tag of edge (u, v): TIER_ICI or TIER_DCN."""
        return self.edge_tier[edge_key(u, v)]

    def tier_edges(self, tier: str) -> List[Edge]:
        return [e for e, t in self.edge_tier.items() if t == tier]

    def tiers(self) -> List[str]:
        return sorted(set(self.edge_tier.values()))

    def edge(self, u: int, v: int) -> LinkScheduler:
        return self.links[edge_key(u, v)]

    def set_bandwidth(self, u: int, v: int, bandwidth: float) -> None:
        self.links[edge_key(u, v)].bw = bandwidth
        self._bump_epoch()

    def edge_up(self, u: int, v: int) -> bool:
        e = edge_key(u, v)
        return (e in self.links and e not in self.dark_edges
                and u not in self.dark_nodes and v not in self.dark_nodes)

    def live_edges(self) -> List[Edge]:
        return [e for e in self.links if self.edge_up(*e)]

    def neighbors(self, u: int) -> List[int]:
        out = []
        for a, b in self.links:
            if a == u and self.edge_up(a, b):
                out.append(b)
            elif b == u and self.edge_up(a, b):
                out.append(a)
        return sorted(out)

    # ------------------------- failure state ------------------------- #
    @property
    def epoch(self) -> int:
        """Monotone topology-change counter: bumped whenever dark state or
        bandwidth changes. A compiled `TrafficPlan` (core/plan.py) snapshots
        it at compile time and refuses to replay once it diverges; the BFS
        routing cache is dropped on every bump."""
        return self._epoch

    def _bump_epoch(self) -> None:
        self._epoch += 1
        self._path_cache.clear()

    def fail_node(self, wid: int) -> None:
        self.dark_nodes.add(wid)
        self._bump_epoch()

    def restore_node(self, wid: int) -> None:
        self.dark_nodes.discard(wid)
        self._bump_epoch()

    def fail_edge(self, u: int, v: int) -> None:
        self.dark_edges.add(edge_key(u, v))
        self._bump_epoch()

    def restore_edge(self, u: int, v: int) -> None:
        self.dark_edges.discard(edge_key(u, v))
        self._bump_epoch()

    # ------------------------- routing ------------------------- #
    def path(self, src: int, dst: int,
             blocked: Optional[set] = None) -> List[Edge]:
        """Shortest live path src -> dst (BFS), as a list of edges. The
        endpoints are assumed up (a recovering node's pod is created before
        its state streams); intermediate dark nodes/edges are routed around.
        `blocked` adds extra edges to avoid (used for edge-disjoint
        alternate paths).

        Unblocked lookups hit a routing cache keyed (src, dst) that lives
        until the next topology change (`_bump_epoch` clears it), so the
        per-step routes of a steady fabric cost one BFS per epoch instead
        of one per submission."""
        if not blocked:
            hit = self._path_cache.get((src, dst))
            if hit is not None:
                return list(hit)
        p = self._bfs(src, dst, blocked or set())
        if p is None:
            raise RoutingError(
                f"no live path {src} -> {dst} "
                f"(dark nodes {sorted(self.dark_nodes)}, "
                f"dark edges {sorted(self.dark_edges)})",
                src=src, dst=dst, dark_nodes=self.dark_nodes,
                dark_edges=self.dark_edges)
        if not blocked:
            self._path_cache[(src, dst)] = tuple(p)
        return p

    def _bfs(self, src: int, dst: int, blocked: set
             ) -> Optional[List[Edge]]:
        if src == dst:
            return []
        prev: Dict[int, int] = {src: src}
        frontier = [src]
        while frontier and dst not in prev:
            nxt = []
            for u in frontier:
                for a, b in self.links:
                    e = edge_key(a, b)
                    if e in self.dark_edges or e in blocked:
                        continue
                    for x, y in ((a, b), (b, a)):
                        if x != u or y in prev:
                            continue
                        # intermediate nodes must be live; dst itself is
                        # allowed (its pod is up by the time state moves)
                        if y != dst and y in self.dark_nodes:
                            continue
                        if u != src and u in self.dark_nodes:
                            continue
                        prev[y] = u
                        nxt.append(y)
            frontier = nxt
        if dst not in prev:
            return None
        hops = []
        node = dst
        while node != src:
            hops.append(edge_key(prev[node], node))
            node = prev[node]
        return hops[::-1]

    def disjoint_paths(self, src: int, dst: int, k: int = 2
                       ) -> List[List[Edge]]:
        """Up to `k` edge-disjoint live paths src -> dst, shortest first.

        On a ring these are exactly the two directions around it; on a
        `PodFabric` the second path detours the pod-level gateway ring the
        other way, and with `dcn_uplinks > 1` further paths climb the
        slack uplink rings (each pod exposes extra DCN-attached nodes, so
        k=4 cross-pod routing is ICI-fanned across two independent gateway
        rings × two ring directions). Greedy shortest-first with
        accumulated edge blocking; the k-path routing policy splits a
        stream's bytes across the result by residual bandwidth
        (`split_bytes`)."""
        paths: List[List[Edge]] = []
        blocked: set = set()
        for _ in range(max(k, 1)):
            p = self._bfs(src, dst, blocked)
            if p is None:
                break
            paths.append(p)
            if not p:                   # src == dst: nothing to disjoin
                break
            blocked |= set(p)
        return paths

    def split_bytes(self, paths: Sequence[Sequence[Edge]], nbytes: float
                    ) -> List[float]:
        """Divide `nbytes` across `paths` so all directions finish together.

        Each path is modeled as a pipe of rate ``r`` (its bottleneck edge's
        bandwidth, bytes/s) that only starts delivering after an offset ``c``
        (seconds): the worst per-edge queued backlog on the path plus the
        path's summed delivery latency. Water-filling solves
        ``sum_i r_i * max(0, T - c_i) = nbytes`` for the common finish time
        T; the returned byte shares are ``r_i * max(0, T - c_i)``. On an
        idle symmetric ring the two directions get exactly half each — the
        bidirectional split that halves recovery time; over k idle
        equal-rate paths each gets ``nbytes / k``."""
        if not paths:
            raise RoutingError("split_bytes needs at least one path",
                               dark_nodes=self.dark_nodes,
                               dark_edges=self.dark_edges)
        infos = []
        for p in paths:
            if not p:                   # local delivery: infinite rate
                return [nbytes] + [0.0] * (len(paths) - 1)
            r = min(self.links[e].bw for e in p)
            backlog = max(self.links[e].pending_bytes() / self.links[e].bw
                          for e in p)
            lat = sum(self.links[e].latency for e in p)
            infos.append((r, backlog + lat))
        order = sorted(range(len(infos)), key=lambda i: infos[i][1])
        finish = None
        active = 0
        for m in range(1, len(order) + 1):
            rs = sum(infos[i][0] for i in order[:m])
            cs = sum(infos[i][0] * infos[i][1] for i in order[:m])
            t = (nbytes + cs) / rs
            nxt = infos[order[m]][1] if m < len(order) else float("inf")
            if t <= nxt:
                finish, active = t, m
                break
        assert finish is not None
        shares = [0.0] * len(paths)
        for i in order[:active]:
            r, c = infos[i]
            shares[i] = r * max(0.0, finish - c)
        # rounding guard: shares must sum to exactly nbytes
        drift = nbytes - sum(shares)
        shares[order[0]] += drift
        return shares

    def least_loaded_edge(self, kind: Optional[str] = None) -> Edge:
        """The live edge with the least queued *drain seconds*
        (queued bytes / bandwidth; faster edge wins ties) — where full
        checkpoint streams go so they stay off busy training edges. On a
        `PodFabric` this is tier-aware placement: an idle ICI edge beats an
        idle DCN edge, but once the ICI ring is saturated with TRAIN backlog
        the slack DCN tier wins."""
        live = self.live_edges()
        if not live:
            raise RoutingError("no live edges in the topology",
                               dark_nodes=self.dark_nodes,
                               dark_edges=self.dark_edges)
        return min(live, key=lambda e: (
            self.links[e].pending_bytes(kind) / self.links[e].bw,
            1.0 / self.links[e].bw, e))

    # ------------------------- submission ------------------------- #
    def submit_path(self, kind: str, size: float, t: float,
                    path: Sequence[Edge]) -> PathTransfer:
        """Put one `size`-byte item on an edge path at simulation time `t`
        (seconds). Empty path = local delivery."""
        pt = PathTransfer(kind, size, t, tuple(edge_key(*e) for e in path))
        if not pt.path:
            pt.finished = True
            pt.t_finish = t
            return pt
        pt.transfer = self.links[pt.path[0]].submit(kind, size, t)
        self._inflight[id(pt.transfer)] = pt
        return pt

    def cancel_path(self, pt: PathTransfer) -> bool:
        """Withdraw a multi-hop item that has not moved a single byte yet.

        Only valid while the item is still queued (not started) on its
        FIRST hop: once any edge transmitted part of it, those bytes are on
        the wire and the item must run to delivery. Returns True when the
        item was withdrawn (its first-hop transfer dequeued and the
        `_inflight` mapping dropped); False when it is too late. Withdrawal
        is pure queue surgery — no dark/bandwidth state changes — so it
        deliberately does NOT bump the topology epoch and compiled
        `TrafficPlan`s stay valid across a re-balance."""
        if pt.finished or pt.transfer is None or pt.hop != 0:
            return False
        if not self.links[pt.path[0]].cancel(pt.transfer):
            return False
        del self._inflight[id(pt.transfer)]
        pt.transfer = None
        return True

    def submit_train_edge(self, u: int, v: int, nbytes: float, t: float
                          ) -> Transfer:
        return self.edge(u, v).submit("TRAIN", nbytes, t)

    def submit_train_ring(self, nbytes_per_edge: float, t: float
                          ) -> List[Transfer]:
        """One step's ring-allreduce volume, edge by edge: every live edge
        carries 2(n-1)/n of the gradient bytes (`step_traffic`), so TRAIN
        preemption is per-edge instead of smeared over a global link."""
        # simlint: disable=SIM006 -- self.links is built by insertion from
        # sorted(edges) in _init_fabric and never rekeyed, so its iteration
        # order is deterministic; this is the per-step hot path and a
        # sorted() here costs O(E log E) every iteration for nothing.
        return [sch.submit("TRAIN", nbytes_per_edge, t)
                for e, sch in self.links.items() if self.edge_up(*e)]

    def submit_train_tiers(self, tier_bytes: Dict[str, float], t: float
                           ) -> List[Transfer]:
        """One step's hierarchical-allreduce volume: each live edge carries
        its TIER's per-edge wire bytes (`tier_bytes[TIER_ICI]` for the
        intra-pod reduce-scatter + allgather, `tier_bytes[TIER_DCN]` for the
        inter-pod shard allreduce over the gateway ring). Tiers absent from
        `tier_bytes`, or mapped to 0 bytes, submit nothing."""
        out = []
        # simlint: disable=SIM006 -- same deterministic insertion order as
        # submit_train_ring (links built from sorted(edges)); per-step hot
        # path, gated by the fleet-bench wall_s trend.
        for e, sch in self.links.items():
            if not self.edge_up(*e):
                continue
            nbytes = tier_bytes.get(self.edge_tier[e], 0.0)
            if nbytes > 0:
                out.append(sch.submit("TRAIN", nbytes, t))
        return out

    # ------------------------- simulation ------------------------- #
    def _advance(self, pt: PathTransfer) -> Optional[Edge]:
        """One store-and-forward step for an item whose current leg landed:
        submit it on its next edge at the arrival instant (returning that
        edge) or deliver it (returning None). The caller has already
        removed the finished leg's mapping from `_inflight`."""
        pt.hop += 1
        if pt.hop < len(pt.path):
            nxt = pt.path[pt.hop]
            pt.transfer = self.links[nxt].submit(
                pt.kind, pt.size, pt.transfer.t_finish)
            self._inflight[id(pt.transfer)] = pt
            return nxt
        pt.finished = True
        pt.t_finish = pt.transfer.t_finish
        return None

    def _pump(self) -> set:
        """Full-scan fallback of `_advance`: forward every in-flight item
        whose current leg landed (the event loop in `run` forwards each
        completion as it happens; this catches transfers finished by any
        out-of-band `LinkScheduler.run`). Returns the edges that received
        forwarded submissions."""
        touched: set = set()
        for key, pt in list(self._inflight.items()):
            if pt.transfer.finished:
                del self._inflight[key]
                nxt = self._advance(pt)
                if nxt is not None:
                    touched.add(nxt)
        return touched

    @property
    def idle(self) -> bool:
        return not self._inflight and \
            all(sch.idle for sch in self.links.values())

    def pending_bytes(self, kind: Optional[str] = None) -> float:
        return sum(sch.pending_bytes(kind) for sch in self.links.values())

    @property
    def clock(self) -> float:
        return max((sch.now for sch in self.links.values()), default=0.0)

    def run(self, until: float) -> float:
        """Advance the fabric to `until` in cross-edge EVENT ORDER.

        Completions are processed globally earliest-first: the edge whose
        next transfer finishes soonest advances exactly to that completion
        (``stop_after_finish``), the completion's forwarded hop (if any) is
        submitted on its next edge at the true arrival instant, and only
        then is the next-earliest completion considered. Every other edge's
        clock still trails the event frontier at that moment, so a
        forwarded submission is never clamped to a window boundary — a
        multi-hop stream crosses as many hops inside one window as its
        exact store-and-forward schedule allows, and windowed timings equal
        drained timings. Finally each edge coasts to `until` (residual
        STATE quanta, clock advance). Returns total link-busy seconds.

        With `compile_plan` set (FabricConfig(compile_plan=True)) the same
        window runs on the decoupled fast path: only the edges a pending
        multi-hop item still couples go through the global event loop;
        every other edge advances independently in one `LinkScheduler.run`
        call. Cross-edge ordering matters solely for forwarding decisions,
        so the timings are identical (property-tested in
        tests/test_traffic_plan.py) while the O(edges^2) peek/min scan
        drops to O(coupled edges^2 + edges)."""
        if self.compile_plan:
            return self._run_decoupled(until)
        busy = self._run_events(until)
        self._pump()
        return busy

    def _run_decoupled(self, until: float) -> float:
        """Exact window advance without the global event loop: edges in the
        remaining path of some in-flight multi-hop item must still advance
        in cross-edge event order (their completions forward submissions),
        but that closure is usually tiny; the rest of the fabric advances
        edge-by-edge, independently."""
        coupled: set = set()
        for pt in self._inflight.values():
            if pt.hop < len(pt.path) - 1:
                coupled.update(pt.path[pt.hop:])
        busy = 0.0
        if coupled:
            busy += self._run_events(until, coupled)
        for e, sch in self.links.items():
            if e not in coupled:
                busy += sch.run(until)
        self._pump()
        return busy

    def _run_events(self, until: float,
                    edges: Optional[set] = None) -> float:
        """The cross-edge event loop over `edges` (default: every edge):
        process completions globally earliest-first, forwarding each
        finished hop at its true arrival instant, then coast each edge to
        `until`. Forwarded submissions always land inside `edges` — the
        caller passes a closure over the remaining hops of every pending
        multi-hop item (or all edges)."""
        links = self.links if edges is None else \
            {e: self.links[e] for e in edges}
        busy = 0.0
        peek: Dict[Edge, Optional[float]] = {
            e: sch.peek_next_finish(until) for e, sch in links.items()}
        while True:
            nxt = [(t, e) for e, t in peek.items() if t is not None]
            if not nxt:
                break
            _, e = min(nxt)
            sch = links[e]
            before = sch.n_finished
            busy += sch.run(until, stop_after_finish=True)
            if sch.n_finished == before:   # peek promised a completion
                raise RuntimeError(f"event clock stalled on edge {e}")
            peek[e] = sch.peek_next_finish(until)
            # forward the item the completed transfer was carrying (if any)
            # at its exact arrival instant — O(1), no fabric scan
            pt = self._inflight.pop(id(sch.done[-1]), None)
            if pt is not None:
                f = self._advance(pt)
                if f is not None:          # new submission: refresh its peek
                    peek[f] = links[f].peek_next_finish(until)
        for sch in links.values():
            busy += sch.run(until)
        return busy

    def drain(self) -> float:
        """Run until all transfers (and every forwarded hop) land: a single
        event-ordered pass over the queue — `run` with an infinite horizon
        forwards each hop at its exact completion instant, so whole
        multi-hop chains complete in one call and the returned clock is the
        true last-delivery transmission end (no horizon slack, no retry
        rounds)."""
        self.run(until=float("inf"))
        return self.clock


# --------------------------------------------------------------------------- #
# Hierarchical pod fabric: ICI rings × DCN gateway hops (ISSUE 3 tentpole)
# --------------------------------------------------------------------------- #
class PodFabric(LinkTopology):
    """Hierarchical, heterogeneous fabric: `n_pods` pods of `pod_size` nodes.

    Node ``p * pod_size + i`` is node `i` of pod `p`. Inside each pod the
    nodes form an ICI ring at `ici_bw` bytes/s (the fast tier); node 0 of
    each pod is its *gateway*, and the gateways form a pod-level ring of DCN
    edges at `dcn_bw` bytes/s (the slow tier) with per-edge delivery latency
    `dcn_latency` seconds. Cross-pod traffic therefore rides
    ICI -> gateway -> DCN -> gateway -> ICI, store-and-forward, and a
    darkened pod forces DCN detours the other way around the gateway ring.

    ``dcn_uplinks`` provisions extra pod-level rings: uplink ``j`` of pod
    ``p`` is node ``p * pod_size + j * pod_size // dcn_uplinks`` (uplink 0
    is the gateway), and the j-th uplinks of all pods form their own DCN
    ring. The default (1) reproduces the classic single-gateway fabric
    edge-for-edge; with 2 uplink rings a cross-pod stream has up to four
    edge-disjoint paths (two ring directions × two uplink rings), which is
    what k=4 recovery striping rides.

    ``edge_bw`` / ``edge_latency`` override individual edges (hotspots);
    `fail_pod` darkens every node of a pod at once (`inject_storm` drives
    correlated failures from a seed)."""

    def __init__(self, n_pods: int, pod_size: int, ici_bw: float,
                 dcn_bw: float, *, quantum: float = 1 << 20,
                 ici_latency: float = 0.0, dcn_latency: float = 0.0,
                 edge_bw: Optional[Dict[Edge, float]] = None,
                 edge_latency: Optional[Dict[Edge, float]] = None,
                 dcn_uplinks: int = 1):
        assert n_pods >= 1 and pod_size >= 1
        assert dcn_uplinks >= 1
        self.kind = "pods"
        self.n_pods = n_pods
        self.pod_size = pod_size
        self.ici_bw = ici_bw
        self.dcn_bw = dcn_bw
        self.ici_latency = ici_latency
        self.dcn_latency = dcn_latency
        # distinct uplink offsets cap at pod_size (offsets collide beyond)
        self.dcn_uplinks = min(dcn_uplinks, pod_size)
        tiers: Dict[Edge, str] = {}
        for p in range(n_pods):
            base = p * pod_size
            if pod_size > 1:
                for i in range(pod_size if pod_size > 2 else 1):
                    e = edge_key(base + i, base + (i + 1) % pod_size)
                    tiers[e] = TIER_ICI
        if n_pods > 1:
            for j in range(self.dcn_uplinks):
                for p in range(n_pods if n_pods > 2 else 1):
                    e = edge_key(self.uplink(p, j),
                                 self.uplink((p + 1) % n_pods, j))
                    tiers[e] = TIER_DCN
        bw = {e: (ici_bw if t == TIER_ICI else dcn_bw)
              for e, t in tiers.items()}
        bw.update(edge_bw or {})
        lat = {e: (ici_latency if t == TIER_ICI else dcn_latency)
               for e, t in tiers.items()}
        lat.update(edge_latency or {})
        self._init_fabric(n_pods * pod_size, set(tiers), tiers, ici_bw,
                          quantum, bw, 0.0, lat)

    # ------------------------- pod queries ------------------------- #
    def pod_of(self, node: int) -> int:
        return node // self.pod_size

    def pod_nodes(self, pod: int) -> List[int]:
        base = pod * self.pod_size
        return list(range(base, base + self.pod_size))

    def gateway(self, pod: int) -> int:
        """The pod's primary DCN-attached node (node 0 of the pod)."""
        return pod * self.pod_size

    def uplink(self, pod: int, j: int = 0) -> int:
        """The pod's j-th DCN-attached node (uplink 0 is the gateway);
        uplinks are spread evenly around the pod's ICI ring so their DCN
        rings stay edge-disjoint from each other AND from the intra-pod
        hops between them."""
        return pod * self.pod_size + (j * self.pod_size) // self.dcn_uplinks

    # ------------------------- failure state ------------------------- #
    def fail_pod(self, pod: int) -> None:
        """Darken the whole pod: every node (and so every incident ICI and
        DCN edge) goes dark — the correlated failure domain the ByteDance
        robustness report stresses."""
        for node in self.pod_nodes(pod):
            self.fail_node(node)

    def restore_pod(self, pod: int) -> None:
        for node in self.pod_nodes(pod):
            self.restore_node(node)

    def dark_pods(self) -> List[int]:
        """Pods with every node dark."""
        return [p for p in range(self.n_pods)
                if all(n in self.dark_nodes for n in self.pod_nodes(p))]


@dataclass(frozen=True)
class StormReport:
    """What a seeded failure storm darkened."""
    seed: int
    pods: Tuple[int, ...]              # fully-darkened pods
    nodes: Tuple[int, ...]             # every darkened node
    edges: Tuple[Edge, ...]            # extra correlated edge failures


def inject_storm(fabric: LinkTopology, seed: int, *, pods: int = 1,
                 edge_failures: int = 0) -> StormReport:
    """Correlated failure storm, reproducible from `seed`.

    Picks `pods` distinct victim pods (uniformly, without replacement) and
    darkens each whole pod; then fails `edge_failures` extra live edges,
    preferring edges *incident to the victim pods' gateway neighbors* — the
    blast radius of a ToR/fabric event is spatially clustered, so recovery
    traffic must race around the darkened region over the surviving DCN
    hops. On a flat `LinkTopology` (no pods), `pods` is ignored and the
    storm is `edge_failures` clustered edge failures around a random seed
    edge."""
    rng = np.random.default_rng(seed)
    dark_before = set(fabric.dark_nodes)
    hit_pods: List[int] = []
    if isinstance(fabric, PodFabric) and pods > 0:
        avail = [p for p in range(fabric.n_pods)
                 if p not in fabric.dark_pods()]
        take = min(pods, len(avail))
        hit_pods = sorted(int(p) for p in
                          rng.choice(avail, size=take, replace=False))
        for p in hit_pods:
            fabric.fail_pod(p)
    hit_nodes = sorted(set(fabric.dark_nodes) - dark_before)
    # correlated extra edge failures: rank live edges by graph distance to
    # the storm center and knock out the nearest ones
    hit_edges: List[Edge] = []
    live = fabric.live_edges()
    if edge_failures > 0 and live:
        if hit_pods and isinstance(fabric, PodFabric):
            center = {fabric.gateway((p + d) % fabric.n_pods)
                      for p in hit_pods for d in (-1, 1)}
        else:
            seed_edge = live[int(rng.integers(len(live)))]
            center = set(seed_edge)
        def dist(e: Edge) -> Tuple[int, Edge]:
            # modular node distance, so ring-wraparound edges count as
            # close to a blast at the seam
            d = min(min(abs(x - c), fabric.n - abs(x - c))
                    for x in e for c in center) if center else 0
            return (d, e)
        for e in sorted(live, key=dist)[:edge_failures]:
            fabric.fail_edge(*e)
            hit_edges.append(e)
    return StormReport(seed, tuple(hit_pods), tuple(hit_nodes),
                       tuple(hit_edges))


def submit_chunked_path(topo: LinkTopology, kind: str, nbytes: float,
                        t: float, path: Sequence[Edge],
                        quantum: Optional[float] = None) -> List[PathTransfer]:
    """Submit `nbytes` as quantum-sized items along an edge path — the
    per-link analogue of `submit_chunked` (recovery fetches, modeled
    checkpoint volumes)."""
    q = topo.quantum if quantum is None else quantum
    n = max(1, int(np.ceil(nbytes / q))) if nbytes > 0 else 1
    out, left = [], nbytes
    for _ in range(n):
        sz = min(q, left)
        out.append(topo.submit_path(kind, max(sz, 0.0), t, path))
        left -= sz
    return out


def submit_chunked(sched: LinkScheduler, kind: str, nbytes: float, t: float,
                   quantum: Optional[float] = None) -> List[Transfer]:
    """Submit `nbytes` as quantum-sized transfers (last one short); the
    canonical way recovery/checkpoint volumes enter the scheduler."""
    q = sched.quantum if quantum is None else quantum
    n = max(1, int(np.ceil(nbytes / q))) if nbytes > 0 else 1
    out, left = [], nbytes
    for _ in range(n):
        sz = min(q, left)
        out.append(sched.submit(kind, max(sz, 0.0), t))
        left -= sz
    return out


def ring_allreduce_time(size_bytes: float, n: int, bandwidth: float,
                        latency: float = 15e-6, efficiency: float = 1.0
                        ) -> float:
    """Ring allreduce wall time (seconds): `size_bytes` bytes over an
    n-node ring at `bandwidth` bytes/s with per-message `latency` seconds:
    2(n-1)/n * size / (BW*eff) + 2(n-1)*lat."""
    if n <= 1:
        return 0.0
    steps = 2 * (n - 1)
    return (steps / n) * size_bytes / (bandwidth * efficiency) \
        + steps * latency
