"""Adversarial scenario fleet — a declarative layer over `SimCluster`.

A `Scenario` is data: the cluster shape, the reliability-loop knobs, and a
seeded list of timed `Event`s (failures, storms, gray-link degradations,
stragglers, scripted recovery attempts). `run_scenario` replays it
deterministically on the sim clock and returns a `Verdict` — rollback
count, measured detection latency, exposed seconds, migrations,
quarantines, adapted cadence — that `tests/test_scenario_fleet.py` pins
per scenario. The corpus covers the gray-failure playbook ByteDance's
infra paper says dominates real fleets (PAPERS.md): multi-wave storms,
concurrent recovery races, lazy-backup pressure during recovery, gateway
oversubscription, mid-transfer link degradation, persistent stragglers.

The runner models a synchronous job honestly: after a failure event the
training loop STALLS (the collective hangs on the dead worker) and the
clock advances in idle windows until the reliability loop's heartbeat scan
detects the breakdown — recovery then starts with the *measured* detection
leg already elapsed. Nothing reads wall time, so the same scenario always
produces the same verdict, bit for bit.

Port of ``repro.runtime.scenarios``: the scenarios, the runner and the
verdicts are the reference's, line for line, and replay to the same pinned
verdicts. The cluster trains the port's model on `device`: CUDA when the
caller names none (raising without a GPU, as `SimCluster` does),
``device="cpu"`` for the plain path. `Scenario` keeps the reference's
fabric figures (50e9 / 5e9) and passes them to `FabricConfig` explicitly,
so the port's H100-cluster defaults never reach a scenario.

Adding a scenario: append an `Event` list to a `Scenario` in `corpus()`
(or build your own and call `run_scenario`), run it once to see the
verdict, and pin the fields you care about in the fleet test. Event
actions:

  ``fail``              params: wids, hardware=False — kill workers NOW;
                        training stalls until detection + recovery
  ``storm``             params: seed, pods=1, edge_failures=0 — seeded
                        correlated storm (`SimCluster.inject_storm`)
  ``recover``           params: FaultScript fields (hardware,
                        interrupt_after_chunks, corrupt_chunks,
                        mid_stream_degrade=(u, v, factor), degrade_at_s),
                        policy — scripted recovery attempt (waits out
                        detection first); without one, the runner
                        auto-recovers
  ``degrade_edge``      params: u, v, factor — gray failure: the link
                        silently runs at factor x its current rate
  ``heal_edge``         params: u, v — repair + lift quarantine
  ``straggler``         params: wid, factor — worker runs factor x slower
  ``clear_straggler``   params: wid
"""
from __future__ import annotations

import dataclasses
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.recovery import FaultScript
from repro_torch.runtime.reliability import ReliabilityConfig

__all__ = ["Event", "Scenario", "Verdict", "run_scenario", "build_cluster",
           "corpus", "random_scenario", "FAST_DETECTION"]

# the corpus default: a snappy control loop (5 Hz heartbeat/scan) so a
# 10-step scenario detects and recovers in a handful of idle windows;
# detection_time() = 0.2 + 0.2 + 0.01 = 0.41 s
FAST_DETECTION = ReliabilityConfig(heartbeat_period=0.2, scan_period=0.2,
                                   notify_latency=0.01, ckpt_cost_s=0.05)


@dataclass(frozen=True)
class Event:
    """One timed action. `at_step` is the training step BEFORE which the
    event applies; same-step events apply in list order."""
    at_step: int
    action: str
    params: Tuple[Tuple[str, Any], ...] = ()

    @staticmethod
    def make(at_step: int, action: str, **params) -> "Event":
        return Event(at_step, action, tuple(sorted(params.items())))

    def kwargs(self) -> Dict[str, Any]:
        return dict(self.params)


def ev(at_step: int, action: str, **params) -> Event:
    """Shorthand constructor: ``ev(5, "fail", wids=[1])``."""
    return Event.make(at_step, action, **params)


@dataclass(frozen=True)
class Scenario:
    """A declarative adversarial run. Everything needed to reproduce it is
    in this dataclass — same scenario, same verdict."""
    name: str
    steps: int = 10
    dp: int = 4
    pods: int = 1
    global_batch: int = 8
    link_bw: float = 50e9
    dcn_bw: float = 5e9
    quantum: int = 0                    # stream chunk bytes; 0 = default
    full_every: int = 50
    t_iter: float = 0.05
    recovery: str = "stream"
    # k-path routing surface: stripe budget for split-policy
    # streams, DCN uplinks per pod, and whether in-flight stripes
    # re-balance on a topology-epoch bump (False pins the static split)
    route_k: int = 2
    dcn_uplinks: int = 1
    rebalance: bool = True
    reliability: ReliabilityConfig = FAST_DETECTION
    events: Tuple[Event, ...] = ()
    seed: int = 0


@dataclass
class Verdict:
    """What the scenario did to the job — the pinned surface."""
    name: str
    steps_completed: int = 0
    final_iteration: int = 0
    recoveries: int = 0
    rollbacks: int = 0                  # recoveries that lost iterations
    rolled_back_iterations: int = 0
    interrupted: int = 0                # recovery attempts cut mid-transfer
    detection_latency_s: Optional[float] = None   # last measured
    detections: int = 0                 # failure incidents detected on-clock
    exposed_seconds: float = 0.0
    mitigations: int = 0                # straggler role migrations
    gray_quarantined: int = 0           # links quarantined by the loop
    gray_tolerated: int = 0             # gray but irreplaceable (no detour)
    final_full_every: Optional[int] = None        # adapted cadence, if any
    state_bytes_streamed: float = 0.0
    chunks_reused: int = 0
    recovery_total_s: float = 0.0       # sum over completed recoveries
    # k-path striping surface: wall seconds the recovery chunk streams
    # spent on the fabric (finer than recovery_total_s, which is floored
    # by pod-allocation constants), plus the transport's re-balance books
    stream_seconds: float = 0.0         # sum over all recovery attempts
    rebalances: int = 0                 # mid-transfer re-balance passes
    chunks_rebalanced: int = 0          # chunks moved between paths

    def pinned(self) -> Dict[str, Any]:
        """The deterministic comparison dict the fleet test asserts."""
        d = dataclasses.asdict(self)
        d["detection_latency_s"] = (
            None if self.detection_latency_s is None
            else round(self.detection_latency_s, 9))
        d["exposed_seconds"] = round(self.exposed_seconds, 9)
        d["state_bytes_streamed"] = round(self.state_bytes_streamed, 3)
        d["recovery_total_s"] = round(self.recovery_total_s, 9)
        d["stream_seconds"] = round(self.stream_seconds, 9)
        return d


def _tiny_arch():
    from repro_torch.configs import get_arch, reduce_for_smoke
    return dataclasses.replace(reduce_for_smoke(get_arch("qwen3-0.6b")),
                               dtype="float32")


def _cluster_kwargs(sc: Scenario, ckpt_dir, *, global_batch: int,
                    seq_len: int) -> Dict[str, Any]:
    """The `SimCluster` keywords a scenario's cluster is wired with: its
    optimizer schedule, checkpoint cadence, fabric and reliability knobs,
    at the given batch and sequence length."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.cluster import ClusterConfig, FabricConfig
    cc = ClusterConfig(dp=sc.dp, global_batch=global_batch, seq_len=seq_len,
                       hp=AdamWConfig(lr=1e-3, warmup_steps=2,
                                      total_steps=max(50, sc.steps + 10)),
                       ckpt_dir=Path(ckpt_dir), full_every=sc.full_every,
                       seed=sc.seed, t_iter_model=sc.t_iter)
    fc = FabricConfig(link_bw=sc.link_bw, pods=sc.pods, dcn_bw=sc.dcn_bw,
                      route_k=sc.route_k, dcn_uplinks=sc.dcn_uplinks,
                      rebalance=sc.rebalance,
                      **({"quantum": sc.quantum} if sc.quantum else {}))
    return dict(cluster=cc, fabric=fc, recovery=sc.recovery,
                reliability=sc.reliability)


def build_cluster(sc: Scenario, ckpt_dir, *, device=None):
    """A `SimCluster` wired exactly as `run_scenario` would build it —
    public so benchmarks can drive the same loop step by step. It trains
    on `device`: CUDA unless the caller names another."""
    from repro_torch.runtime.cluster import SimCluster
    return SimCluster(_tiny_arch(), device=device,
                      **_cluster_kwargs(sc, ckpt_dir,
                                        global_batch=sc.global_batch,
                                        seq_len=16))


class _Runner:
    def __init__(self, sc: Scenario, cluster):
        self.sc = sc
        self.clu = cluster
        self.verdict = Verdict(name=sc.name)
        self._last_hw = False

    # ------------------------- event dispatch ------------------------- #
    def apply(self, e: Event) -> None:
        clu, kw = self.clu, e.kwargs()
        if e.action == "fail":
            self._last_hw = bool(kw.get("hardware", False))
            clu.inject_failure(list(kw["wids"]), hardware=self._last_hw)
        elif e.action == "storm":
            self._last_hw = False
            clu.inject_storm(kw["seed"], pods=kw.get("pods", 1),
                             edge_failures=kw.get("edge_failures", 0))
        elif e.action == "recover":
            self.recover_now(kw)
        elif e.action == "degrade_edge":
            clu.degrade_edge(kw["u"], kw["v"], kw["factor"])
        elif e.action == "heal_edge":
            clu.heal_edge(kw["u"], kw["v"])
        elif e.action == "straggler":
            clu.set_straggler(kw["wid"], kw["factor"])
        elif e.action == "clear_straggler":
            clu.clear_straggler(kw["wid"])
        else:
            raise ValueError(f"unknown scenario action {e.action!r}")

    # ------------------------- detection + recovery ------------------------- #
    def wait_for_detection(self) -> None:
        """Training is stalled on a dead worker: advance the clock in
        idle windows until the heartbeat scan declares the breakdown."""
        clu = self.clu
        down = [w.wid for w in clu.workers if not w.alive]
        budget = int(np.ceil(
            (clu.detection.detection_time() / clu.t_iter_model))) + 4
        for _ in range(budget):
            if set(down) <= set(clu.reliability.detected):
                break
            clu.advance_idle(clu.t_iter_model)
        else:
            raise AssertionError(
                f"{self.sc.name}: workers {down} not detected within "
                f"{budget} idle windows — the liveness loop is broken")

    def recover_now(self, kw: Dict[str, Any]) -> None:
        clu, v = self.clu, self.verdict
        if all(w.alive for w in clu.workers):
            return                      # scripted recover with nobody down
        self.wait_for_detection()
        v.detections = len(clu.reliability.detection_times)
        v.detection_latency_s = clu.reliability.last_detection_latency
        msd = kw.get("mid_stream_degrade")
        faults = FaultScript(
            hardware=bool(kw.get("hardware", self._last_hw)),
            interrupt_after_chunks=kw.get("interrupt_after_chunks"),
            corrupt_chunks=int(kw.get("corrupt_chunks", 0)),
            mid_stream_degrade=(None if msd is None else
                                (int(msd[0]), int(msd[1]), float(msd[2]))),
            degrade_at_s=float(kw.get("degrade_at_s", 0.0)))
        rep = clu.recover(faults, policy=kw.get("policy"))
        v.stream_seconds += getattr(rep, "stream_seconds", 0.0) or 0.0
        if rep.kind == "interrupted":
            v.interrupted += 1
            return
        v.recoveries += 1
        v.recovery_total_s += rep.total_time
        v.state_bytes_streamed += rep.state_bytes_streamed
        v.chunks_reused += getattr(rep, "chunks_reused", 0) or 0
        if rep.rolled_back_iterations > 0:
            v.rollbacks += 1
            v.rolled_back_iterations += rep.rolled_back_iterations

    # ------------------------- the replay ------------------------- #
    def run(self) -> Verdict:
        sc, clu, v = self.sc, self.clu, self.verdict
        by_step: Dict[int, List[Event]] = {}
        for e in sc.events:
            by_step.setdefault(e.at_step, []).append(e)
        for s in range(sc.steps):
            for e in by_step.get(s, ()):
                self.apply(e)
            if any(not w.alive for w in clu.workers):
                # no scripted recovery handled it: the job self-drives
                self.recover_now({})
            clu.step()
            v.steps_completed += 1
        v.final_iteration = clu.iteration
        v.exposed_seconds = clu.exposed_seconds
        v.mitigations = sum(1 for e in clu.reliability.events
                            if e.kind == "straggler_migrate")
        gray = [e for e in clu.reliability.events if e.kind == "gray_edge"]
        v.gray_quarantined = sum(1 for e in gray
                                 if e.detail.get("quarantined"))
        v.gray_tolerated = sum(1 for e in gray
                               if not e.detail.get("quarantined"))
        v.final_full_every = clu.reliability.current_full_every
        v.rebalances = getattr(clu.transport, "rebalances", 0)
        v.chunks_rebalanced = getattr(clu.transport, "chunks_rebalanced", 0)
        if v.detection_latency_s is None:
            v.detection_latency_s = clu.reliability.last_detection_latency
        v.detections = len(clu.reliability.detection_times)
        return v


def run_scenario(sc: Scenario,
                 ckpt_dir=Path(tempfile.gettempdir()) / "repro_torch_scenarios",
                 *, device=None) -> Verdict:
    """Replay `sc` deterministically on `device` (CUDA unless the caller
    names another) and return its `Verdict`."""
    clu = build_cluster(sc, Path(ckpt_dir) / sc.name, device=device)
    return _Runner(sc, clu).run()


# --------------------------------------------------------------------------- #
# The pinned corpus
# --------------------------------------------------------------------------- #
def corpus() -> List[Scenario]:
    """The adversarial fleet. Order is stable; names are the pytest ids."""
    return [
        # one clean software death: the baseline every other scenario is
        # read against — detect on-clock, stream the shard back, 0 rollback
        Scenario(name="clean_software_failure", steps=10, events=(
            ev(5, "fail", wids=[1]),
        )),
        # two failures in the same scan: one incident, one recovery racing
        # two concurrent multi-hop fetches — still 0 rollback (backups of
        # non-adjacent workers both survive)
        Scenario(name="recovery_race_concurrent", steps=10, events=(
            ev(5, "fail", wids=[1, 3]),
        )),
        # rolling two-wave storm on a pod fabric: each wave darkens a pod,
        # kills its workers (software), and leaves storm edges dark through
        # the recovery — streams detour over the DCN gateway ring
        Scenario(name="multi_wave_storm", steps=12, dp=8, pods=2,
                 global_batch=16, events=(
            ev(4, "storm", seed=3, pods=1),
            ev(8, "storm", seed=4, pods=1),
        )),
        # lazy-backup pressure: a starved fabric (200 MB/s links) makes the
        # rank-0 lazy stream and the recovery chunks fight for the wire —
        # recovery still completes without rollback, just slower
        Scenario(name="lazy_backup_pressure", steps=10, link_bw=2e8,
                 events=(
            ev(6, "fail", wids=[2]),
        )),
        # gateway oversubscription: one shared DCN uplink silently degrades
        # to 20% while cross-pod traffic rides it; the loop quarantines it
        # from observed throughput and the gateway ring reroutes the other
        # way (4 pods => the DCN ring has a detour to route through)
        Scenario(name="gateway_oversubscription", steps=12, dp=8, pods=4,
                 global_batch=16, events=(
            ev(3, "degrade_edge", u=0, v=2, factor=0.2),
        )),
        # the 2-pod variant: the degraded uplink is the ONLY path between
        # the pods — fencing it would partition the job, so the loop
        # detects the gray link but TOLERATES it (slow beats severed)
        Scenario(name="gateway_oversubscription_no_detour", steps=10, dp=8,
                 pods=2, global_batch=16, events=(
            ev(3, "degrade_edge", u=0, v=4, factor=0.2),
        )),
        # mid-transfer degradation: recovery is interrupted after 2 chunks
        # (16 KiB chunking makes the shard a many-chunk stream), then the
        # resumed recovery's delivery link browns out UNDER the in-flight
        # stream — the transport re-balances the not-yet-started chunks
        # onto the surviving ring direction (slow links so the state leg
        # dominates and the re-balance is visible in recovery_total_s)
        Scenario(name="mid_transfer_degradation", steps=10, link_bw=2e8,
                 quantum=1 << 14, events=(
            ev(5, "fail", wids=[1]),
            ev(5, "recover", interrupt_after_chunks=2),
            ev(5, "recover", mid_stream_degrade=(1, 2, 0.05),
               degrade_at_s=3e-4),
        )),
        # the same brown-out with re-balancing DISABLED: chunks stay
        # pinned to their original paths and ride out the degraded wire —
        # the static-2-path baseline the re-balanced verdict is read
        # against (recovery_total_s strictly larger)
        Scenario(name="mid_transfer_degradation_static", steps=10,
                 link_bw=2e8, quantum=1 << 14, rebalance=False, events=(
            ev(5, "fail", wids=[1]),
            ev(5, "recover", interrupt_after_chunks=2),
            ev(5, "recover", mid_stream_degrade=(1, 2, 0.05),
               degrade_at_s=3e-4),
        )),
        # k>2 striping: with 4 DCN uplinks per pod every node is a
        # gateway, so the cross-pod stream 4 -> 3 has THREE edge-disjoint
        # paths (node 4's full fabric degree) and a route_k=3 budget
        # stripes the shard across all of them
        Scenario(name="cross_pod_k3_stripe", steps=10, dp=8, pods=2,
                 global_batch=16, dcn_bw=1e8, dcn_uplinks=4, route_k=3,
                 quantum=1 << 14, events=(
            ev(5, "fail", wids=[3]),
        )),
        # k>2 re-balancing: the same 3-path stripe loses most of its
        # primary DCN uplink mid-transfer; the remaining chunks re-balance
        # onto the two surviving paths' residual capacity
        Scenario(name="cross_pod_k3_rebalance", steps=10, dp=8, pods=2,
                 global_batch=16, dcn_bw=1e8, dcn_uplinks=4, route_k=3,
                 quantum=1 << 14, events=(
            ev(5, "fail", wids=[3]),
            ev(5, "recover", mid_stream_degrade=(0, 4, 0.1),
               degrade_at_s=1e-4),
        )),
        # a persistent 2x straggler: EWMAs flag it after min_observations
        # steps and its role migrates to a spare — the cluster's step time
        # returns to the healthy pace (speedup == straggler factor)
        Scenario(name="persistent_straggler", steps=12, events=(
            ev(3, "straggler", wid=2, factor=2.0),
        )),
        # a gray ICI link at 30% of spec: quarantined from observed
        # throughput; training (and any later recovery) routes around it
        Scenario(name="gray_link_degradation", steps=10, events=(
            ev(3, "degrade_edge", u=2, v=3, factor=0.3),
        )),
        # two failure incidents => an observed MTBF => Young–Daly cadence
        # pushed to every worker's checkpoint engine
        Scenario(name="adaptive_cadence", steps=14, events=(
            ev(4, "fail", wids=[1]),
            ev(10, "fail", wids=[3]),
        )),
        # adjacent double HARDWARE failure under the stream policy: worker
        # 1's backup lived in worker 2's host RAM — both gone, multi-level
        # insurance falls back to the periodic full checkpoint WITH rollback
        Scenario(name="hardware_double_stream_rollback", steps=10,
                 full_every=4, events=(
            ev(7, "fail", wids=[1, 2], hardware=True),
        )),
        # the same double hardware failure under ComputeRecovery: neighbors
        # replay compute, zero bytes streamed, zero rollback — exactly
        # where FCR/"all is not lost" predicts checkpoint-free survival
        Scenario(name="hardware_double_compute_free", steps=10,
                 full_every=4, recovery="compute", events=(
            ev(7, "fail", wids=[1, 2], hardware=True),
        )),
    ]


def random_scenario(seed: int) -> Scenario:
    """A seeded random adversarial scenario (hypothesis sweep): software
    failures, stragglers, and gray links only — the regime where FCR
    predicts every recovery is rollback-free. Pure function of `seed`."""
    rng = np.random.default_rng(seed)
    steps = int(rng.integers(7, 12))
    events: List[Event] = []
    wids = list(rng.permutation(np.arange(1, 4)))
    n_events = int(rng.integers(1, 3))
    used_steps: set = set()
    for i in range(n_events):
        s = int(rng.integers(2, steps - 1))
        while s in used_steps:
            s = int(rng.integers(2, steps - 1))
        used_steps.add(s)
        kind = int(rng.integers(0, 3))
        if kind == 0:
            events.append(ev(s, "fail", wids=[int(wids[i])]))
        elif kind == 1:
            events.append(ev(s, "straggler", wid=int(wids[i]),
                             factor=float(rng.uniform(1.8, 3.0))))
        else:
            u = int(rng.integers(0, 4))
            events.append(ev(s, "degrade_edge", u=u, v=(u + 1) % 4,
                             factor=float(rng.uniform(0.1, 0.4))))
    events.sort(key=lambda e: e.at_step)
    return Scenario(name=f"random_{seed}", steps=steps,
                    events=tuple(events), seed=seed)
