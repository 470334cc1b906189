"""Pluggable recovery policies for the cluster simulator (paper §5 + the
"All is Not Lost" head-to-head from PAPERS.md).

`SimCluster.recover()` keeps the orchestration legs (detection, replacement
pods, lazy backup) and delegates the *state* leg to a `RecoveryPolicy`:

  plan(cluster, failed, faults)  -> RecoveryPlan     (what moves where, ETA)
  execute(plan)                  -> RecoveryReport   (state rebuilt, timeline)

Three policies ship:

  * `StreamRecovery` — FFTrainer's behavior, carved out of the old
    `SimCluster._recover_from_neighbors` / `_recover_from_full` bodies
    timing-identically: failed workers' shards stream from their DP-ring
    backup holders as chunked STATE traffic over the live fabric, falling
    back to the periodic full checkpoint (with rollback) when the neighbor
    copy died too.
  * `ComputeRecovery` — checkpoint-free: healthy neighbors replay redundant
    compute (train/step.py `ReplayCostModel`) to rebuild the lost shards.
    Costs worker compute-seconds, submits NO STATE traffic, and therefore
    stays viable when `inject_storm` has darkened the cross-pod edges.
  * `HybridRecovery` — per-failed-worker choice by estimated completion
    time: streamable shards race over the fabric while the rest recompute;
    the state leg is the max of the two racing legs.

The optimizer-vector flatten/shard helpers live here too (they are recovery
plumbing).

Port of ``repro.runtime.recovery``: the policies, plans and reports are the
reference's, line for line. What differs is where the state lives: the
cluster's state tree holds tensors on its device, `_flatten_opt` copies them
into one host fp32 vector in the reference's leaf order (layers stacked, as
``lax.scan`` keeps them), and a recovery writes the rebuilt vector back into
those tensors in place.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import (Any, ClassVar, Dict, List, Optional, Protocol, Sequence,
                    Tuple, Union, runtime_checkable)

import numpy as np
import torch

from repro_torch.ckpt.stream import ChunkedStream, StreamAssembler
from repro_torch.optim import cast_params
from repro_torch.train.step import (ReplayCost, ReplayCostModel,
                                    replay_compute_cost)
from repro_torch.tree import (Stacked, copy_from_numpy_, host_dtype, tree_flatten,
                              tree_leaves, tree_unflatten)

PyTree = Any


# --------------------------------------------------------------------------- #
# Optimizer-vector plumbing (moved from runtime/cluster.py)
# --------------------------------------------------------------------------- #
def _flatten_opt(opt: PyTree) -> Tuple[np.ndarray, Any]:
    """The opt tree as one host fp32 vector, leaves in the reference's
    order, each raveled; every tensor (every layer of a ``Stacked`` leaf) is
    copied off its device straight into its place in the vector."""
    leaves, treedef = tree_flatten(opt)
    sizes = [int(np.prod(l.shape)) for l in leaves]
    vec = np.empty(sum(sizes), np.float32)
    off = 0
    for leaf, n in zip(leaves, sizes):
        for t in (leaf.layers if isinstance(leaf, Stacked) else [leaf]):
            k = t.numel()
            torch.from_numpy(vec[off:off + k]).copy_(t.detach().reshape(-1))
            off += k
    shapes = [(tuple(l.shape), host_dtype(l.dtype)) for l in leaves]
    return vec, (treedef, shapes)


def _unflatten_opt(vec: np.ndarray, meta) -> PyTree:
    """The host tree (numpy leaves) of a vector laid out by `_flatten_opt`."""
    treedef, shapes = meta
    leaves, off = [], 0
    for shape, dtype in shapes:
        n = int(np.prod(shape))
        leaves.append(vec[off:off + n].reshape(shape).astype(dtype))
        off += n
    return tree_unflatten(treedef, leaves)


def shard_slices(n: int, dp: int) -> List[slice]:
    per = (n + dp - 1) // dp
    return [slice(i * per, min((i + 1) * per, n)) for i in range(dp)]


# --------------------------------------------------------------------------- #
# Fault scripting + typed errors
# --------------------------------------------------------------------------- #
class RecoveryError(RuntimeError):
    """A recovery request the chosen policy cannot honor (e.g. interrupting
    a chunk transfer that the policy never performs)."""


@dataclass(frozen=True)
class FaultScript:
    """What goes wrong DURING recovery (the consolidated form of the old
    `recover(hardware=, interrupt_after_chunks=, corrupt_chunks=)` kwargs).

    `hardware` — the failure lost host RAM too (slower pod creation).
    `interrupt_after_chunks` — a second failure strikes mid-transfer: the
    recovery stream stops after that many chunks; partial chunks are
    retained and the next `recover()` resumes from them.
    `corrupt_chunks` — flip a byte in that many recovery chunks on the wire
    (first missing chunks, stream by stream in worker order); the CRC
    rejects them and the NACK path retransmits.
    `mid_stream_degrade` — ``(u, v, factor)``: while the recovery streams
    are in flight, edge (u, v)'s bandwidth is multiplied by `factor` at
    `degrade_at_s` seconds after the state leg starts (a gray link browning
    out mid-transfer). The transport's k-path re-balancer then reassigns
    the not-yet-started chunks over the surviving paths' residual capacity
    (or the allocation stays static with re-balancing disabled)."""
    hardware: bool = False
    interrupt_after_chunks: Optional[int] = None
    corrupt_chunks: int = 0
    mid_stream_degrade: Optional[Tuple[int, int, float]] = None
    degrade_at_s: float = 0.0


def orchestration_timeline(cluster, faults: FaultScript) -> Dict[str, float]:
    """The recovery legs every policy shares: failure detection and
    replacement-pod creation (hardware pods re-image, §6.2), with
    dependency install pre-pulled away (Table 5).

    The detection leg prefers the cluster's MEASURED latency when its
    reliability loop detected the breakdown on the sim clock
    (`runtime/reliability.py`); the analytic `DetectionTimeline` worst case
    is the fallback for manually scripted inject-then-recover flows."""
    measured = getattr(cluster, "_measured_detection", None)
    detection = (float(measured) if measured is not None
                 else cluster.detection.detection_time())
    return {
        "detection": detection,
        "pod_creation": 7.0 if faults.hardware else 0.5,
        "dependency_install": 0.0,
    }


# --------------------------------------------------------------------------- #
# Reports + plans
# --------------------------------------------------------------------------- #
@dataclass
class RecoveryReport:
    kind: str                          # software | hardware | fallback | interrupted
    recovered_from: str                # neighbor | full_ckpt | neighbor_partial
                                       # | compute_replay | neighbor+compute
    resume_iteration: int
    rolled_back_iterations: int
    timeline: Dict[str, float]
    total_time: float
    elastic_dp: Optional[int] = None
    # StateStream chunk accounting for (partial, resumable) transfers
    chunks_total: int = 0              # chunks the recovery needs overall
    chunks_sent: int = 0               # chunks moved in THIS attempt
    chunks_reused: int = 0             # chunks surviving from a prior attempt
    # policy-level accounting (which resource this recovery spent)
    policy: str = "stream"             # name of the policy that executed
    state_bytes_streamed: float = 0.0  # STATE bytes this recovery put on wire
    compute_seconds: float = 0.0       # replay compute burned (checkpoint-free)
    # wall seconds the chunk streams themselves took on the fabric (the
    # scheduler's finish minus submit) — finer grained than the timeline's
    # network_and_state leg, which is floored by pod-allocation constants,
    # so k-path striping and mid-transfer re-balancing stay visible
    stream_seconds: float = 0.0


@dataclass(frozen=True)
class StreamLeg:
    """One failed worker whose shard streams from its backup holder."""
    wid: int
    holder: Optional[int]
    est_bytes: float
    est_seconds: float


@dataclass(frozen=True)
class ComputeLeg:
    """One failed worker whose shard is rebuilt by replaying compute."""
    wid: int
    replayers: Tuple[int, ...]
    cost: ReplayCost


@dataclass
class RecoveryPlan:
    """A policy's decision for one recovery: which failed worker recovers by
    which mechanism, plus the shared orchestration context. `execute`
    consumes exactly one plan."""
    policy: str                        # planning policy name
    mode: str                          # neighbor | full | compute | mixed
    cluster: Any
    failed: List[int]
    faults: FaultScript
    timeline: Dict[str, float]
    t_start: float
    legs: List[Union[StreamLeg, ComputeLeg]] = field(default_factory=list)
    # routing budget for the stream legs: max edge-disjoint paths each
    # recovery stream stripes across (None = the transport's route_k)
    route_k: Optional[int] = None

    @property
    def stream_legs(self) -> List[StreamLeg]:
        return [l for l in self.legs if isinstance(l, StreamLeg)]

    @property
    def compute_legs(self) -> List[ComputeLeg]:
        return [l for l in self.legs if isinstance(l, ComputeLeg)]

    @property
    def est_state_bytes(self) -> float:
        return float(sum(l.est_bytes for l in self.stream_legs))

    @property
    def est_compute_seconds(self) -> float:
        return float(sum(l.cost.compute_seconds for l in self.compute_legs))


@runtime_checkable
class RecoveryPolicy(Protocol):
    """The pluggable recovery interface: `plan` decides (cheap, no state
    moves), `execute` rebuilds the cluster's training state and returns the
    report. `SimCluster.recover()` calls both in sequence."""
    name: str

    def plan(self, cluster, failed: List[int],
             faults: FaultScript = FaultScript(), *,
             timeline: Optional[Dict[str, float]] = None,
             t_start: Optional[float] = None) -> RecoveryPlan: ...

    def execute(self, plan: RecoveryPlan) -> RecoveryReport: ...


def _plan_context(cluster, faults: FaultScript,
                  timeline: Optional[Dict[str, float]],
                  t_start: Optional[float]
                  ) -> Tuple[Dict[str, float], float]:
    """Default orchestration context for a standalone `plan()` call (recover()
    passes both in explicitly after running the lazy-backup leg)."""
    tl = dict(timeline) if timeline is not None \
        else orchestration_timeline(cluster, faults)
    t0 = t_start if t_start is not None else cluster.sim_time + sum(tl.values())
    return tl, t0


def estimate_stream_seconds(topology, src: Optional[int], dst: int,
                            nbytes: float, k: int = 2) -> float:
    """Idle-fabric ETA for streaming `nbytes` src -> dst over up to `k`
    edge-disjoint live paths (the transport's k-path striped routing):
    per-path bottleneck rates sum, the worst path latency is paid once.
    Used by `HybridRecovery` to race a stream leg against a compute leg
    and by table5 to validate the simulated k-path state leg; returns
    inf when no live path exists (the storm cut the holder off)."""
    if src is None:
        return float("inf")
    if src == dst:
        return 0.0
    try:
        paths = topology.disjoint_paths(src, dst, k=k)
    except Exception:  # noqa: BLE001 - no route == unstreamable
        return float("inf")
    paths = [p for p in paths if p]
    if not paths:
        return float("inf")
    rate, latency = 0.0, 0.0
    for p in paths:
        rate += min(topology.edge(*e).bw for e in p)
        latency = max(latency,
                      sum(topology.edge(*e).latency for e in p))
    return nbytes / max(rate, 1.0) + latency


def _replay_wall(legs: Sequence[ComputeLeg]) -> float:
    """Elapsed replay time for a set of compute legs: each replayer works
    its legs serially, legs with disjoint replayers run in parallel."""
    if not legs:
        return 0.0
    per_replayer: Dict[int, float] = {}
    wall = 0.0
    for leg in legs:
        if not leg.replayers:
            wall = max(wall, leg.cost.wall_seconds)
            continue
        for r in leg.replayers:
            per_replayer[r] = per_replayer.get(r, 0.0) + leg.cost.wall_seconds
    if per_replayer:
        wall = max(wall, max(per_replayer.values()))
    return wall


def _pick_replayers(cluster, wid: int, failed: List[int]) -> Tuple[int, ...]:
    """The healthy ring neighbors that replay for `wid` (paper-adjacent:
    the workers already holding overlapping activations/replicas). Falls
    back to any healthy worker when both neighbors are down."""
    dp = cluster.dp
    down = set(failed)
    nbrs = [(wid - 1) % dp, (wid + 1) % dp]
    picked = tuple(n for n in dict.fromkeys(nbrs)
                   if n != wid and n not in down and cluster.workers[n].alive)
    if picked:
        return picked
    return tuple(w.wid for w in cluster.workers
                 if w.alive and w.wid not in down)[:2]


# --------------------------------------------------------------------------- #
# StreamRecovery — today's behavior, timing-identical
# --------------------------------------------------------------------------- #
@dataclass
class StreamRecovery:
    """FFTrainer's stream-based recovery: chunked STATE traffic from the
    DP-ring backup holders, full-checkpoint fallback when the neighbor copy
    is gone. The execute path is the old `SimCluster._recover_from_*` code,
    moved — timings are bit-identical (pinned in
    tests/test_recovery_policy.py). `route_k` caps how many edge-disjoint
    paths each recovery stream stripes across (None = the transport's
    default, normally 2)."""
    route_k: Optional[int] = None
    name: ClassVar[str] = "stream"

    def _effective_k(self, cluster) -> int:
        return self.route_k if self.route_k is not None \
            else getattr(cluster.transport, "route_k", 2)

    def plan(self, cluster, failed: List[int],
             faults: FaultScript = FaultScript(), *,
             timeline: Optional[Dict[str, float]] = None,
             t_start: Optional[float] = None) -> RecoveryPlan:
        tl, t0 = _plan_context(cluster, faults, timeline, t_start)
        failed = sorted(failed)
        if cluster._recoverable_from_neighbors(failed):
            ldp, old_of, new_of = cluster._shard_layout()
            nbytes = cluster.shard_nbytes()
            k = self._effective_k(cluster)
            legs: List[Union[StreamLeg, ComputeLeg]] = []
            for wid in failed:
                holder = new_of[(old_of[wid] + 1) % ldp]
                legs.append(StreamLeg(
                    wid, holder, nbytes,
                    estimate_stream_seconds(cluster.topology, holder, wid,
                                            nbytes, k=k)))
            return RecoveryPlan(self.name, "neighbor", cluster, failed,
                                faults, tl, t0, legs, route_k=self.route_k)
        if faults.interrupt_after_chunks is not None:
            raise RecoveryError(
                "interrupt_after_chunks models a failure mid neighbor-"
                "stream; this recovery fell back to the full checkpoint "
                "(no resumable chunk transfer to interrupt)")
        return RecoveryPlan(self.name, "full", cluster, failed, faults,
                            tl, t0)

    def execute(self, plan: RecoveryPlan) -> RecoveryReport:
        if plan.mode == "full":
            return _execute_full(plan)
        return _execute_neighbor_streams(
            plan, stream_wids=[l.wid for l in plan.stream_legs])


# --------------------------------------------------------------------------- #
# ComputeRecovery — checkpoint-free, zero fabric bytes
# --------------------------------------------------------------------------- #
@dataclass
class ComputeRecovery:
    """Checkpoint-free recovery: healthy ring neighbors replay redundant
    compute to rebuild every failed worker's shard at the modeled
    `ReplayCostModel.recompute_rate`. Submits NO STATE traffic, so a
    storm-darkened DCN does not slow it down — the cost lands on the
    replayers' compute budget instead (`RecoveryReport.compute_seconds`).
    Rebuilds the CURRENT iteration's state (the replayers still hold it),
    so there is never a rollback — including the adjacent-double-hardware
    case where stream recovery must fall back to an old full checkpoint."""
    cost_model: ReplayCostModel = field(default_factory=ReplayCostModel)
    name: ClassVar[str] = "compute"

    def plan(self, cluster, failed: List[int],
             faults: FaultScript = FaultScript(), *,
             timeline: Optional[Dict[str, float]] = None,
             t_start: Optional[float] = None) -> RecoveryPlan:
        if faults.interrupt_after_chunks is not None:
            raise RecoveryError(
                "interrupt_after_chunks models a failure mid neighbor-"
                "stream; compute-based recovery replays compute and has no "
                "chunk transfer to interrupt")
        if faults.corrupt_chunks:
            raise RecoveryError(
                "corrupt_chunks corrupts recovery chunks on the wire; "
                "compute-based recovery streams no chunks")
        if faults.mid_stream_degrade is not None:
            raise RecoveryError(
                "mid_stream_degrade browns out an edge under an in-flight "
                "recovery stream; compute-based recovery streams no chunks")
        tl, t0 = _plan_context(cluster, faults, timeline, t_start)
        failed = sorted(failed)
        nbytes = cluster.shard_nbytes()
        legs: List[Union[StreamLeg, ComputeLeg]] = []
        for wid in failed:
            replayers = _pick_replayers(cluster, wid, failed)
            legs.append(ComputeLeg(wid, replayers, replay_compute_cost(
                nbytes, n_replayers=max(len(replayers), 1),
                model=self.cost_model)))
        return RecoveryPlan(self.name, "compute", cluster, failed, faults,
                            tl, t0, legs)

    def execute(self, plan: RecoveryPlan) -> RecoveryReport:
        cluster = plan.cluster
        wall = _replay_wall(plan.compute_legs)
        timeline = plan.timeline
        timeline["replay_compute"] = wall
        cluster.sim_time = max(cluster.sim_time, plan.t_start + wall)
        # the replayers reconstruct the shard the failed worker held at the
        # CURRENT iteration — the simulator's state tree is already the
        # global truth, so recovery is a no-op on data and a pure cost on
        # time: zero rollback, zero fabric bytes
        total = sum(timeline.values())
        return RecoveryReport(
            "hardware" if plan.faults.hardware else "software",
            "compute_replay", cluster.iteration, 0, timeline, total,
            policy=self.name, state_bytes_streamed=0.0,
            compute_seconds=plan.est_compute_seconds)


# --------------------------------------------------------------------------- #
# HybridRecovery — per-failed-worker race: fabric vs compute
# --------------------------------------------------------------------------- #
@dataclass
class HybridRecovery:
    """Per-failed-worker choice by estimated completion time: a shard whose
    backup holder is reachable over a fast live path streams; one whose
    stream ETA loses to the replay ETA (or whose backup died with it)
    recomputes. The state leg is the slower of the two racing legs — both
    run concurrently. `route_k` caps how many edge-disjoint paths each
    stream leg stripes across (None = the transport's default); the
    stream-vs-compute race uses the SAME k for its ETA, so a wider routing
    budget honestly tilts the race toward streaming."""
    cost_model: ReplayCostModel = field(default_factory=ReplayCostModel)
    route_k: Optional[int] = None
    name: ClassVar[str] = "hybrid"

    def _effective_k(self, cluster) -> int:
        return self.route_k if self.route_k is not None \
            else getattr(cluster.transport, "route_k", 2)

    def plan(self, cluster, failed: List[int],
             faults: FaultScript = FaultScript(), *,
             timeline: Optional[Dict[str, float]] = None,
             t_start: Optional[float] = None) -> RecoveryPlan:
        if faults.interrupt_after_chunks is not None:
            raise RecoveryError(
                "interrupt_after_chunks is only meaningful for the pure "
                "stream policy (hybrid legs race; use StreamRecovery to "
                "model a mid-transfer interruption)")
        tl, t0 = _plan_context(cluster, faults, timeline, t_start)
        failed = sorted(failed)
        ldp, old_of, new_of = cluster._shard_layout()
        nbytes = cluster.shard_nbytes()
        k = self._effective_k(cluster)
        legs: List[Union[StreamLeg, ComputeLeg]] = []
        for wid in failed:
            o = old_of[wid]
            kind, _src = cluster._slice_source(o, ldp, new_of)
            holder = new_of[(o + 1) % ldp] if kind != "none" else None
            est_stream = estimate_stream_seconds(cluster.topology, holder,
                                                 wid, nbytes, k=k)
            replayers = _pick_replayers(cluster, wid, failed)
            cost = replay_compute_cost(nbytes,
                                       n_replayers=max(len(replayers), 1),
                                       model=self.cost_model)
            if est_stream <= cost.wall_seconds:
                legs.append(StreamLeg(wid, holder, nbytes, est_stream))
            else:
                legs.append(ComputeLeg(wid, replayers, cost))
        return RecoveryPlan(self.name, "mixed", cluster, failed, faults,
                            tl, t0, legs, route_k=self.route_k)

    def execute(self, plan: RecoveryPlan) -> RecoveryReport:
        return _execute_neighbor_streams(
            plan, stream_wids=[l.wid for l in plan.stream_legs],
            compute_legs=plan.compute_legs)


_POLICIES = {
    "stream": StreamRecovery,
    "compute": ComputeRecovery,
    "hybrid": HybridRecovery,
}


def resolve_policy(spec: Union[str, RecoveryPolicy, None]) -> RecoveryPolicy:
    """Coerce a policy spec — None (default stream), a name, or an already-
    built policy instance — into a RecoveryPolicy."""
    if spec is None:
        return StreamRecovery()
    if isinstance(spec, str):
        try:
            return _POLICIES[spec]()
        except KeyError:
            raise ValueError(
                f"unknown recovery policy {spec!r}; "
                f"choose from {sorted(_POLICIES)}") from None
    if callable(getattr(spec, "plan", None)) and \
            callable(getattr(spec, "execute", None)):
        return spec
    raise TypeError(f"not a RecoveryPolicy: {spec!r}")


# --------------------------------------------------------------------------- #
# Execution machinery (the old SimCluster._recover_from_* bodies)
# --------------------------------------------------------------------------- #
def _execute_neighbor_streams(plan: RecoveryPlan, stream_wids: List[int],
                              compute_legs: Sequence[ComputeLeg] = ()
                              ) -> RecoveryReport:
    """Move `stream_wids`' shards as chunked STATE traffic from their
    backup holders (verbatim from the old `_recover_from_neighbors`), with
    optional concurrent `compute_legs` racing the streams (hybrid). With no
    compute legs the timings are bit-identical to the pre-refactor path."""
    cluster = plan.cluster
    timeline = plan.timeline
    faults = plan.faults
    acct0 = cluster.transport.accounting()["state_bytes"]
    compute_wids = {l.wid for l in compute_legs}
    ldp, old_of, new_of = cluster._shard_layout()
    # consistency: earliest globally-available version (§4.2), over the
    # snapshot layout's shard slices. Slices that a compute leg rebuilds
    # need no surviving snapshot — replay reconstructs the CURRENT state.
    versions = {}
    for o in range(ldp):
        kind, src_wid = cluster._slice_source(o, ldp, new_of)
        if kind == "none":
            assert new_of.get(o) in compute_wids, \
                f"layout slice {o} has no source and no compute leg"
            continue
        keeper = (cluster.workers[src_wid].engine.own if kind == "own"
                  else cluster.workers[src_wid].engine.neighbor)
        versions[o] = keeper.latest().iteration
    target = min(versions.values()) if versions else cluster.iteration
    if compute_wids:
        # replay rebuilds current-iteration state; mixing it with a
        # rolled-back stream target would splice two iterations
        assert target == cluster.iteration, \
            "hybrid compute legs need the stream target at the current " \
            "iteration (no snapshot rollback to splice against)"
    rolled = cluster.iteration - target
    # drop partial transfers aimed at a version we no longer want
    cluster._pending_recovery = {k: v for k, v in
                                 cluster._pending_recovery.items()
                                 if k[1] == target}

    # ---- move the failed workers' shards as chunked STATE traffic ----
    # each stream rides the shortest LIVE edge path holder -> newcomer:
    # adjacent edge normally, multi-hop around dark nodes/edges otherwise
    t0 = plan.t_start
    chunks_total = chunks_sent = chunks_reused = 0
    tickets, inflight = [], {}
    budget = faults.interrupt_after_chunks
    corrupt_left = faults.corrupt_chunks
    interrupted = False
    for wid in sorted(stream_wids):
        holder_wid = new_of[(old_of[wid] + 1) % ldp]
        holder = cluster.workers[holder_wid]
        key = (wid, target)
        if key in cluster._pending_recovery:
            stream, asm = cluster._pending_recovery[key]
            chunks_reused += asm.received
        else:
            stream = holder.engine.export_stream(target, which="neighbor")
            asm = StreamAssembler.for_stream(stream)
            cluster._pending_recovery[key] = (stream, asm)
        chunks_total += stream.n_chunks
        missing = asm.missing()
        take = missing
        if budget is not None:
            take = missing[:max(budget - chunks_sent, 0)]
            if len(take) < len(missing):
                interrupted = True
        # wire corruption: the CRC rejects these on delivery and the
        # NACK path retransmits each one immediately
        for seq in take[:corrupt_left]:
            cluster.transport.corrupt_once(stream.stream_id, seq)
        corrupt_left -= min(corrupt_left, len(take))
        if take:
            tickets.append(cluster.transport.send(
                stream, t0, assembler=asm, seqs=take,
                src=holder_wid, dst=wid, k=plan.route_k))
            chunks_sent += len(take)
        inflight[wid] = (stream, asm)
    if faults.mid_stream_degrade is not None and tickets:
        # a gray link browns out UNDER the in-flight streams: run the
        # fabric to the degrade instant, apply it (epoch bump), and let the
        # drain's entry check re-balance the not-yet-started chunks over
        # the surviving paths' residual capacity
        u, v, factor = faults.mid_stream_degrade
        cluster.transport.run(until=t0 + max(float(faults.degrade_at_s),
                                             0.0))
        cluster.degrade_edge(int(u), int(v), float(factor))
    cluster.transport.drain()
    bytes_streamed = cluster.transport.accounting()["state_bytes"] - acct0

    if interrupted:
        # the second failure struck mid-transfer: time (and the link
        # clock) advance to where the partial transfer stopped, so the
        # resumed recovery does NOT re-pay this attempt's transfer time
        finish = max([tk.finish_time for tk in tickets
                      if tk.finish_time is not None], default=t0)
        cluster.sim_time = max(cluster.sim_time, finish)
        timeline["network_and_state"] = finish - t0
        total = sum(timeline.values())
        return RecoveryReport("interrupted", "neighbor_partial", target,
                              0, timeline, total,
                              chunks_total=chunks_total,
                              chunks_sent=chunks_sent,
                              chunks_reused=chunks_reused,
                              policy=plan.policy,
                              state_bytes_streamed=bytes_streamed,
                              stream_seconds=finish - t0)

    # ---- every stream landed: rebuild the optimizer vector, slice by
    # slice of the SNAPSHOT layout (which differs from the live
    # numbering only across an elastic shrink) ----
    vec, meta = _flatten_opt(cluster.state["opt"])
    slices = shard_slices(len(vec), ldp)
    for o in range(ldp):
        owner = new_of.get(o)
        if owner is not None and owner in inflight:
            stream, asm = inflight[owner]
            # NACK retransmission heals CRC rejects in-stream, so
            # `rejected > 0` is fine as long as assembly completed
            assert asm.complete, \
                f"stream {stream.stream_id} incomplete"
            vec[slices[o]] = asm.to_flat_dict()["shard"]
            cluster._pending_recovery.pop((owner, target), None)
        elif owner is not None and owner in compute_wids:
            # replay leg: the replayers rebuild this slice at the current
            # iteration — the simulator vector already holds the truth, so
            # the slice stands as-is (zero fabric bytes moved for it)
            continue
        else:
            kind, src_wid = cluster._slice_source(o, ldp, new_of)
            keeper = (cluster.workers[src_wid].engine.own if kind == "own"
                      else cluster.workers[src_wid].engine.neighbor)
            snap = keeper.get(target)
            assert snap is not None, \
                f"version {target} missing for layout slice {o}"
            vec[slices[o]] = snap.state["shard"]
    cluster._layout = None         # live numbering is authoritative again
    # the rebuilt opt state goes back into the device tensors in place, and
    # the params are cast from its master
    copy_from_numpy_(cluster.state["opt"], _unflatten_opt(vec, meta))
    cast_params(cluster.state["opt"]["master"], cluster.state["params"])
    cluster.state["step"].fill_(target)
    cluster.iteration = target

    # timeline: network recovery overlaps state loading (§5.2); the
    # state leg is the SCHEDULER's finish time for the recovery chunks,
    # so TRAIN traffic sharing the link delays recovery emergently. A
    # concurrent replay leg (hybrid) races the streams: the state leg is
    # whichever finishes last.
    n = cluster.dp
    t_net = 0.5 + 0.001 * n
    finish = max([tk.finish_time for tk in tickets if tk.finish_time
                  is not None], default=t0)
    replay_wall = _replay_wall(compute_legs)
    cluster.sim_time = max(cluster.sim_time, finish, t0 + replay_wall)
    t_state = (finish - t0) + 0.2 if stream_wids else 0.0
    timeline["network_and_state"] = max(t_net, t_state, replay_wall)
    total = sum(timeline.values())
    if compute_legs and inflight:
        source = "neighbor+compute"
    elif compute_legs:
        source = "compute_replay"
    else:
        source = "neighbor"
    return RecoveryReport("hardware" if faults.hardware else "software",
                          source, target, rolled, timeline, total,
                          chunks_total=chunks_total,
                          chunks_sent=chunks_sent,
                          chunks_reused=chunks_reused,
                          policy=plan.policy,
                          state_bytes_streamed=bytes_streamed,
                          compute_seconds=float(sum(
                              l.cost.compute_seconds for l in compute_legs)),
                          stream_seconds=finish - t0 if stream_wids else 0.0)


def _execute_full(plan: RecoveryPlan) -> RecoveryReport:
    """Restore from the periodic full checkpoint with rollback (verbatim
    from the old `_recover_from_full`)."""
    cluster = plan.cluster
    timeline = plan.timeline
    eng0 = cluster.workers[0].engine
    eng0.writer.drain()
    it = eng0.latest_full()
    assert it is not None, "no full checkpoint available (insurance gap)"
    like = cluster.state
    restored = eng0.restore_full(it, like)

    # integrity: re-chunk the restored artifact and check it against the
    # per-chunk CRC manifest written at save time
    from repro_torch.ckpt.storage import load_manifest, verify_manifest
    manifest = load_manifest(eng0._full_path(it))
    chunks_total = 0
    if manifest is not None:
        stream = ChunkedStream.from_pytree(
            manifest["stream_id"], restored,
            quantum=int(manifest.get("quantum", cluster.quantum)))
        blob = b"".join(c.payload for c in stream.chunks)
        bad = verify_manifest(manifest, blob)
        assert not bad, f"full ckpt it{it}: corrupt chunks {bad}"
        chunks_total = stream.n_chunks

    copy_from_numpy_(cluster.state, restored)
    rolled = cluster.iteration - it
    cluster.iteration = it
    full_bytes = sum(np.asarray(l).nbytes for l in tree_leaves(restored))
    # serial reload from storage, still through the link model
    from repro_torch.runtime.failover import FailoverCosts, schedule_state_phase
    t_state = 1.0 + schedule_state_phase(full_bytes,
                                         FailoverCosts().storage_bw,
                                         quantum=max(full_bytes, 1.0))
    timeline["network_and_state"] = max(0.5 + 0.001 * cluster.dp, t_state)
    total = sum(timeline.values())
    return RecoveryReport("fallback", "full_ckpt", it, rolled,
                          timeline, total, chunks_total=chunks_total,
                          chunks_sent=chunks_total, policy=plan.policy)
