"""Compiled traffic plans — fleet-scale fabric simulation (ROADMAP item).

The event-driven clock in `core/lccl.py` is exact but pays one Python frame
per transfer event; at fleet scale (thousands of edges, multi-day traces)
that is the wall-clock bottleneck. This module compiles a *periodic*
submitted traffic pattern — the per-edge TRAIN allreduce plus STATE stream
chunks one training step puts on every edge (`train/step.py`,
`ckpt/stream.py`) — into a static **TrafficPlan**, the way an op compiler
lowers a graph through scheduling stages:

1. **route**: the pattern is per-edge (routing already resolved via the
   epoch-cached `LinkTopology.path` tables), so the plan only needs the live
   edges and their schedulers.
2. **schedule**: edges are grouped into *classes* by (bandwidth, latency,
   link quantum, submission list). One real `LinkScheduler` simulates a
   single period per class — the template. The template must drain within
   the period (link idle again before the next step's traffic arrives);
   otherwise the pattern is not steady-state and compilation refuses
   (`PlanUnsupported`) so the caller falls back to the exact per-event path.
3. **lower**: N steady-state steps replay as vectorized numpy algebra —
   completion i of step s finishes at ``t0 + s*period + template[i]`` — and
   `apply` advances the schedulers' clocks/counters in O(edges) total,
   batching all same-edge completions instead of walking them one event at
   a time.

Replayed timings match the interpreted event loop to float precision
(`np.testing.assert_allclose(..., rtol=1e-12)`, the same discipline as
`tests/test_event_clock.py`): the only divergence is summation order inside
one period (template sums at base 0, the interpreter accumulates from
``s*period``), a few ulp.

Cache invalidation: a plan snapshots `LinkTopology.epoch` at compile time.
Any topology-changing event (dark node/edge, bandwidth edit — failures,
storms, elastic shrink) bumps the epoch, the plan turns `stale`, and
`apply` refuses to run it. Cross the event on the exact path, then
recompile.

Units follow `core/lccl.py`: bytes, bytes/second, seconds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.lccl import (TIER_DCN, TIER_ICI, Edge, LinkScheduler,
                             LinkTopology, edge_key)

__all__ = ["PlanUnsupported", "Submission", "TrafficPlan", "PlanReplay",
           "compile_traffic_plan", "steady_state_pattern"]

# one per-period submission on an edge: (kind, nbytes, offset seconds into
# the period). Offsets must lie in [0, period).
Submission = Tuple[str, float, float]


class PlanUnsupported(RuntimeError):
    """The pattern/topology cannot replay as a compiled plan (overcommitted
    period, dark edge in the pattern, stale epoch, mid-flight scheduler
    state). Callers fall back to the exact per-event path."""


@dataclass
class PlanClass:
    """One edge class's compiled single-period template."""
    bw: float
    latency: float
    quantum: float
    subs: Tuple[Submission, ...]
    edges: Tuple[Edge, ...]
    rel_finish: np.ndarray             # delivery times of one period, base 0
    rel_clock: float                   # scheduler clock at period drain
    busy: float                        # link-busy seconds per period
    kinds: Tuple[str, ...]             # completion kinds, template order
    train_bytes: float = 0.0           # TRAIN payload per period
    train_tx: float = 0.0              # TRAIN transmit seconds per period


@dataclass(frozen=True)
class PlanReplay:
    """What one `TrafficPlan.apply` advanced, in aggregate."""
    n_steps: int
    events: int                        # interpreter completions batched away
    busy: float                        # total link-busy seconds
    t_end: float                       # every replayed edge's clock after


class TrafficPlan:
    """A compiled steady-state traffic pattern over a `LinkTopology`.

    Built by `compile_traffic_plan`; valid while `topology.epoch` equals the
    snapshot taken at compile time (`stale` otherwise). `finish_times` gives
    any edge's exact per-completion delivery times over N steps without
    touching the schedulers; `apply` advances the fabric's schedulers by N
    steps in O(edges) — clocks and completion counters move, but the
    individual `Transfer` records are batched away (the `done` lists do not
    materialize; that is the point)."""

    def __init__(self, topology: LinkTopology, period: float,
                 classes: List[PlanClass]):
        self.topology = topology
        self.period = period
        self.classes = classes
        self.epoch = topology.epoch
        self.n_edges = sum(len(c.edges) for c in classes)
        self.events_per_step = sum(
            len(c.rel_finish) * len(c.edges) for c in classes)
        self._class_of: Dict[Edge, PlanClass] = {
            e: c for c in classes for e in c.edges}

    @property
    def stale(self) -> bool:
        """True once the topology changed since compilation (failure, storm,
        restore, bandwidth edit) — the plan must be recompiled."""
        return self.epoch != self.topology.epoch

    def finish_times(self, u: int, v: int, n_steps: int,
                     t0: float = 0.0) -> np.ndarray:
        """Delivery times of every completion on edge (u, v) over `n_steps`
        periods starting at `t0`, in completion order — vectorized:
        ``(t0 + s*period) + template``."""
        c = self._class_of[edge_key(u, v)]
        if len(c.rel_finish) == 0:
            return np.empty((n_steps, 0))
        starts = t0 + self.period * np.arange(n_steps)
        return (starts[:, None] + c.rel_finish[None, :]).reshape(-1)

    def apply(self, n_steps: int, t0: float = 0.0) -> PlanReplay:
        """Advance every planned edge's scheduler by `n_steps` steady-state
        periods starting at `t0`, without per-event work.

        Preconditions (PlanUnsupported otherwise): the plan is not stale,
        and every planned edge's scheduler is idle with its clock at or
        before `t0` — exactly the state the interpreter leaves a
        steady-state edge in at a period boundary. Afterward each scheduler
        sits at ``t0 + n_steps*period`` with `n_finished` advanced by its
        per-period completion count, which is where the exact event loop
        would leave it (the batched `Transfer` records themselves are not
        materialized)."""
        if n_steps <= 0:
            return PlanReplay(0, 0, 0.0, t0)
        if self.stale:
            raise PlanUnsupported(
                f"stale plan: compiled at topology epoch {self.epoch}, "
                f"now {self.topology.epoch} — recompile after the "
                "topology change")
        links = self.topology.links
        for c in self.classes:
            for e in c.edges:
                sch = links[e]
                if not sch.idle or sch.now > t0:
                    raise PlanUnsupported(
                        f"edge {e} is not at a steady-state boundary "
                        f"(idle={sch.idle}, now={sch.now}, t0={t0}); "
                        "drain the fabric on the exact path first")
        t_end = t0 + n_steps * self.period
        busy = 0.0
        events = 0
        for c in self.classes:
            k = len(c.rel_finish)
            for e in c.edges:
                sch = links[e]
                sch.now = t_end
                sch.n_finished += n_steps * k
                sch.train_bytes_done += n_steps * c.train_bytes
                sch.train_tx_seconds += n_steps * c.train_tx
            busy += n_steps * c.busy * len(c.edges)
            events += n_steps * k * len(c.edges)
        return PlanReplay(n_steps, events, busy, t_end)


def compile_traffic_plan(topology: LinkTopology,
                         pattern: Dict[Edge, Sequence[Submission]],
                         period: float) -> TrafficPlan:
    """Compile one step's per-edge traffic into a `TrafficPlan`.

    `pattern` maps each edge to its per-period submissions
    ``(kind, nbytes, offset)``; `period` is the steady-state step length in
    seconds. Edges with identical (bandwidth, latency, quantum, submissions)
    share one simulated template, so a homogeneous 4096-node fabric compiles
    in a handful of `LinkScheduler` runs. Raises `PlanUnsupported` when an
    edge is dark or one period's traffic does not drain within the period
    (the pattern is not steady-state — fall back to the exact path)."""
    if period <= 0:
        raise PlanUnsupported(f"period must be positive, got {period}")
    groups: Dict[Tuple, List[Edge]] = {}
    for e, subs in pattern.items():
        e = edge_key(*e)
        if not topology.edge_up(*e):
            raise PlanUnsupported(f"pattern covers dark edge {e}")
        sch = topology.links[e]
        norm = tuple((str(kind), float(size), float(off))
                     for kind, size, off in subs)
        for kind, size, off in norm:
            if not 0.0 <= off < period:
                raise PlanUnsupported(
                    f"submission offset {off} outside [0, {period}) "
                    f"on edge {e}")
        key = (sch.bw, sch.latency, sch.quantum, norm)
        groups.setdefault(key, []).append(e)
    classes: List[PlanClass] = []
    for (bw, latency, quantum, subs), edges in sorted(groups.items()):
        ref = LinkScheduler(bw, quantum=quantum, latency=latency)
        for kind, size, off in subs:
            ref.submit(kind, size, off)
        busy = ref.run(until=float("inf"))
        if ref.now > period:
            raise PlanUnsupported(
                f"period overcommitted: one period's traffic on edges "
                f"{edges[:3]}{'...' if len(edges) > 3 else ''} drains at "
                f"{ref.now:.6g}s > period {period:.6g}s")
        classes.append(PlanClass(
            bw=bw, latency=latency, quantum=quantum, subs=subs,
            edges=tuple(sorted(edges)),
            rel_finish=np.array([tr.t_finish for tr in ref.done]),
            rel_clock=ref.now, busy=busy,
            kinds=tuple(tr.kind for tr in ref.done),
            train_bytes=ref.train_bytes_done,
            train_tx=ref.train_tx_seconds))
    return TrafficPlan(topology, period, classes)


def steady_state_pattern(fabric: LinkTopology, profile,
                         state_quantum: Optional[float] = None
                         ) -> Dict[Edge, Tuple[Submission, ...]]:
    """The per-edge periodic pattern one training step submits on `fabric`.

    `profile` is a `train/step.py:TrafficProfile` (duck-typed:
    `train_bytes`, `state_bytes`, `dcn_bytes`): every live ICI edge carries
    the intra-pod allreduce volume as TRAIN plus the instant-checkpoint
    shard as quantum-chunked STATE (each worker permutes its shard one ring
    hop, so each ring edge carries exactly one shard per step); every live
    DCN edge carries the inter-pod shard-allreduce volume as TRAIN. All
    submissions land at offset 0, matching `SimCluster.step` /
    `submit_step_traffic`."""
    q = float(state_quantum if state_quantum is not None
              else getattr(fabric, "quantum", 1 << 20))
    pattern: Dict[Edge, Tuple[Submission, ...]] = {}
    for e in fabric.live_edges():
        tier = fabric.edge_tier.get(e, TIER_ICI)
        train = profile.dcn_bytes if tier == TIER_DCN else profile.train_bytes
        subs: List[Submission] = []
        if train > 0:
            subs.append(("TRAIN", float(train), 0.0))
        if tier == TIER_ICI and profile.state_bytes > 0:
            left = float(profile.state_bytes)
            while left > 0:
                subs.append(("STATE", min(q, left), 0.0))
                left -= q
        pattern[e] = tuple(subs)
    return pattern
