"""Failover timeline orchestration (paper Fig. 1, Table 5).

Models both flows over the same recovery steps:
  serial (PyTorch/Gemini-style):   detect -> pod -> deps -> network -> state
  FFTrainer (overlapped):          detect -> pod (pre-pulled) ->
                                   max(network-recovery, state-load)   [§5.2]
plus lazy backup running in parallel with pod creation (§4.2).

The state-movement phase is no longer a closed-form `bytes / bandwidth`
constant: it is *derived from a LinkScheduler run*. Recovery state moves as
chunk-granular STATE traffic through the TRAIN/STATE two-queue link model
(§5.3), so concurrent TRAIN traffic (healthy DP groups resuming their
allreduce) preempts recovery chunks and delays the timeline exactly as it
would on the wire. Pass a `LinkTopology` + edge `path` and the state leg is
scheduled per-edge instead: recovery rides a (possibly multi-hop) path of
per-link schedulers while the allreduce loads every ring edge, so a single
hotspot edge bottlenecks the timeline by exactly its residual bandwidth.

On a hierarchical `PodFabric` the state leg can also be scheduled across
SEVERAL edge-disjoint paths at once (`paths=`): the bytes are water-filled
over up to k paths by residual bandwidth (`LinkTopology.split_bytes`) —
both ring directions, both ways around the DCN gateway ring past a darkened
pod, and any extra `dcn_uplinks` gateway rings — so the timeline's state
leg is the k paths' combined residual capacity, and cross-pod recovery is
bounded by the aggregate DCN bandwidth plus the per-hop delivery latency.
Pass `topology.disjoint_paths(src, dst, k=k)` to reproduce exactly what the
live transport stripes over (`TopologyTransport(route_k=k)`).

Orchestration steps we can only model (Docker pulls, pod scheduling) keep the
paper's measured Table 5 values; connection building is calibrated on our
lock-free init (fig8)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Sequence, Tuple

from repro_torch.core.detection import DetectionTimeline
from repro_torch.core.lccl import (Edge, LinkScheduler, LinkTopology,
                             submit_chunked, submit_chunked_path)

# (t_submit_seconds, bytes) pairs of TRAIN traffic sharing the link
TrainTraffic = Sequence[Tuple[float, float]]


@dataclass(frozen=True)
class FailoverCosts:
    # paper Table 5 measured values (seconds)
    detection_baseline: float = 15.0
    pod_creation_baseline: float = 392.0
    dependency_baseline: float = 421.0
    detection_fft: float = 6.0
    pod_creation_fft: float = 7.0
    dependency_fft: float = 0.0
    # bandwidths for state movement (bytes/s)
    neighbor_bw: float = 50e9          # ICI link (instant ckpt fetch)
    storage_bw: float = 1e9            # remote storage (baseline reload)
    dcn_bw: float = 5e9                # inter-pod gateway hop (cross-pod)
    dcn_latency: float = 1e-3          # per-DCN-hop delivery latency (s)
    # network-recovery scaling (calibrated on our lock-free init, fig8)
    conn_base: float = 0.5
    conn_per_worker: float = 0.001
    conn_per_worker_baseline: float = 0.08
    # state-movement constants: link ramp (instant) / storage handshake
    state_ramp_fft: float = 0.2
    state_ramp_baseline: float = 2.0
    quantum: float = 4 << 20           # STATE preemption granularity


def schedule_state_phase(state_bytes: float, bandwidth: float, *,
                         quantum: float = 4 << 20,
                         train_traffic: TrainTraffic = (),
                         t0: float = 0.0,
                         scheduler: Optional[LinkScheduler] = None,
                         topology: Optional[LinkTopology] = None,
                         path: Optional[Sequence[Edge]] = None,
                         paths: Optional[Sequence[Sequence[Edge]]] = None
                         ) -> float:
    """Wall seconds to move `state_bytes` (bytes) of recovery state through
    a TRAIN/STATE link scheduler at `bandwidth` bytes/s, chunked at
    `quantum` granularity (bytes).

    Any `train_traffic` submitted on the same link preempts the recovery
    chunks — the returned duration grows by exactly the schedule the link
    model produces, not by a hand-tuned contention factor.

    With a `topology` (and an edge `path` through it), the recovery chunks
    move store-and-forward along the path's per-edge schedulers while the
    TRAIN traffic loads EVERY ring edge (the healthy groups' allreduce) —
    the timeline then derives from per-edge contention, and a single hotspot
    edge on the path bottlenecks recovery by exactly its residual bandwidth.
    Per-edge delivery latency accrues per hop, so a DCN detour pays its
    latency on every gateway crossing.

    `paths` (up to k edge-disjoint paths) enables k-path striping: the
    volume is water-filled across the paths by residual bandwidth
    (`LinkTopology.split_bytes`), so on an idle symmetric ring both
    directions carry half and the state leg halves; with k=4 disjoint
    DCN routes an idle cross-pod leg quarters (minus per-hop latency and
    pipeline-fill, which the per-edge schedulers model exactly).

    The returned duration is exact: the fabric clock is event-ordered, so
    `drain()` is a single pass that forwards every hop at its true arrival
    instant — the timeline derives from one window with no horizon slack
    (and, equivalently, would be identical measured through `run(until=)`
    windows)."""
    if topology is not None:
        routes = [list(p) for p in paths] if paths else \
            ([list(path)] if path else None)
        assert routes, "per-link scheduling needs an edge path (or paths)"
        shares = topology.split_bytes(routes, state_bytes) \
            if len(routes) > 1 else [state_bytes]
        pts = []
        for p, share in zip(routes, shares):
            if share <= 0:
                continue
            pts += submit_chunked_path(topology, "STATE", share, t0, p,
                                       quantum)
        for t, nbytes in train_traffic:
            topology.submit_train_ring(nbytes, t)
        topology.drain()
        return max(pt.t_finish for pt in pts) - t0
    sched = scheduler or LinkScheduler(bandwidth, quantum=quantum)
    chunks = submit_chunked(sched, "STATE", state_bytes, t0, quantum)
    for t, nbytes in train_traffic:
        sched.submit("TRAIN", nbytes, t)
    sched.drain()
    return max(tr.t_finish for tr in chunks) - t0


def fftrainer_timeline(n_workers: int, state_bytes_per_worker: float,
                       costs: FailoverCosts = FailoverCosts(),
                       detection: Optional[DetectionTimeline] = None,
                       train_traffic: TrainTraffic = (),
                       scheduler: Optional[LinkScheduler] = None,
                       topology: Optional[LinkTopology] = None,
                       path: Optional[Sequence[Edge]] = None,
                       paths: Optional[Sequence[Sequence[Edge]]] = None
                       ) -> Dict[str, float]:
    detection = detection if detection is not None else DetectionTimeline()
    t_net = costs.conn_base + costs.conn_per_worker * n_workers
    t_state = costs.state_ramp_fft + schedule_state_phase(
        state_bytes_per_worker, costs.neighbor_bw, quantum=costs.quantum,
        train_traffic=train_traffic, scheduler=scheduler,
        topology=topology, path=path, paths=paths)
    tl = {
        # lower-bounded by our measured heartbeat path; paper measured 6 s
        "detection": max(detection.detection_time(), costs.detection_fft),
        "pod_creation": costs.pod_creation_fft,
        "dependency_install": costs.dependency_fft,
        # role/rank decoupling overlaps the two (§5.2); the state leg comes
        # from the scheduler run above, so TRAIN preemption surfaces here
        "network_and_state": max(t_net, t_state),
    }
    tl["total"] = sum(v for k, v in tl.items())
    return tl


def compute_recovery_timeline(n_workers: int, state_bytes_per_worker: float,
                              costs: FailoverCosts = FailoverCosts(),
                              detection: Optional[DetectionTimeline] = None,
                              replay: Optional["ReplayCostModel"] = None,
                              n_replayers: int = 2) -> Dict[str, float]:
    """Checkpoint-free recovery flow ("All is Not Lost", PAPERS.md): same
    orchestration legs as FFTrainer, but the state leg is a REPLAY leg —
    healthy neighbors rebuild the lost worker's state by redundant compute
    at the modeled recompute rate (train/step.py `ReplayCostModel`). No
    fabric bytes move, so the leg is independent of link bandwidth, TRAIN
    contention, and storm damage; the bill lands on `replay_compute`
    seconds instead (plus `compute_seconds_burned`, the total worker
    compute spent, reported out-of-timeline)."""
    from repro_torch.train.step import ReplayCostModel, replay_compute_cost
    detection = detection if detection is not None else DetectionTimeline()
    cost = replay_compute_cost(state_bytes_per_worker,
                               n_replayers=n_replayers,
                               model=replay or ReplayCostModel())
    tl = {
        "detection": max(detection.detection_time(), costs.detection_fft),
        "pod_creation": costs.pod_creation_fft,
        "dependency_install": costs.dependency_fft,
        # network setup overlaps the replay exactly like it overlaps the
        # stream leg in `fftrainer_timeline` (§5.2)
        "replay_compute": max(costs.conn_base
                              + costs.conn_per_worker * n_workers,
                              cost.wall_seconds),
    }
    tl["total"] = sum(tl.values())
    tl["compute_seconds_burned"] = cost.compute_seconds
    return tl


def hybrid_recovery_timeline(n_workers: int, state_bytes_per_worker: float,
                             costs: FailoverCosts = FailoverCosts(),
                             detection: Optional[DetectionTimeline] = None,
                             replay: Optional["ReplayCostModel"] = None,
                             n_replayers: int = 2,
                             train_traffic: TrainTraffic = (),
                             scheduler: Optional[LinkScheduler] = None,
                             topology: Optional[LinkTopology] = None,
                             path: Optional[Sequence[Edge]] = None,
                             paths: Optional[Sequence[Sequence[Edge]]] = None
                             ) -> Dict[str, float]:
    """Per-worker race between the stream leg and the replay leg: the state
    phase takes whichever finishes first (both start once pods are up).
    The closed-form analogue of `HybridRecovery` in runtime/recovery.py —
    useful for the table5 what-if rows without building a cluster."""
    from repro_torch.train.step import ReplayCostModel, replay_compute_cost
    detection = detection if detection is not None else DetectionTimeline()
    t_net = costs.conn_base + costs.conn_per_worker * n_workers
    t_stream = costs.state_ramp_fft + schedule_state_phase(
        state_bytes_per_worker, costs.neighbor_bw, quantum=costs.quantum,
        train_traffic=train_traffic, scheduler=scheduler,
        topology=topology, path=path, paths=paths)
    t_replay = replay_compute_cost(state_bytes_per_worker,
                                   n_replayers=n_replayers,
                                   model=replay or ReplayCostModel()
                                   ).wall_seconds
    tl = {
        "detection": max(detection.detection_time(), costs.detection_fft),
        "pod_creation": costs.pod_creation_fft,
        "dependency_install": costs.dependency_fft,
        "network_and_state": max(t_net, min(t_stream, t_replay)),
    }
    tl["total"] = sum(tl.values())
    return tl


def baseline_timeline(n_workers: int, state_bytes_per_worker: float,
                      costs: FailoverCosts = FailoverCosts(),
                      train_traffic: TrainTraffic = ()
                      ) -> Dict[str, float]:
    t_net = costs.conn_base + costs.conn_per_worker_baseline * n_workers
    # serial reload from remote storage — same link model, storage bandwidth,
    # whole-artifact chunks (no FFTrainer quantum preemption to exploit)
    t_state = costs.state_ramp_baseline + schedule_state_phase(
        state_bytes_per_worker, costs.storage_bw,
        quantum=max(state_bytes_per_worker, 1.0),
        train_traffic=train_traffic)
    tl = {
        "detection": costs.detection_baseline,
        "pod_creation": costs.pod_creation_baseline,
        "dependency_install": costs.dependency_baseline,
        "network_recovery": t_net,
        "state_recovery": t_state,      # serial: after network
    }
    tl["total"] = sum(tl.values())
    return tl
