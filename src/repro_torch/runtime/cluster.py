"""DP-ring cluster simulation with REAL training-state movement.

The cluster trains an actual (smoke-scale) model: one jit'd step computes the
global SPMD step, and the ZeRO-unique optimizer state is split into `dp`
contiguous shards — worker i owns shard i and, per the paper's neighboring
redundancy, worker (i+1) % dp holds a copy of it in host RAM (two versions,
consistency §4.2). Failure/recovery therefore moves REAL bytes and the
integration tests assert bitwise state equality against an uninterrupted run.

Failure semantics (paper §6.2, Table 3):
  * software failure: worker process dies, host RAM (backups) survives;
  * hardware failure: host dies — its shard AND the backup it held are lost;
    recovery needs the neighbor's copy; if worker i and i+1 both died, the
    instant checkpoint is lost and we fall back to the periodic full CKPT
    (multi-level insurance) with rollback;
  * healthy workers perform lazy backup (DP rank 0 persists redundant state).

Port of ``repro.runtime.cluster``: the simulation is the reference's, line
for line; the step trains the port's model of any family it builds
(``model.loss``: on CUDA the flash kernel, and for the SSM and the hybrid the
SSD kernel, each under autograd) with the port's AdamW on the cluster's device,
CUDA unless the caller names another (``device="cpu"``): with no device
named and no GPU, the constructor raises. The training state stays on the
device between steps; each step's instant checkpoint copies the optimizer
state off it into one host fp32 vector (``_flatten_opt``), laid out as the
reference's, which the workers shard, keep and stream.
"""
from __future__ import annotations

import dataclasses
import tempfile
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.ckpt.engine import CkptEngine, CkptEngineConfig
from repro_torch.ckpt.stream import (DEFAULT_QUANTUM, ChunkedStream,
                                     StreamAssembler, TopologyTransport)
from repro_torch.configs import ArchConfig
from repro_torch.core.consistency import reconcile
from repro_torch.core.controller import StateController
from repro_torch.core.detection import DetectionTimeline
from repro_torch.core.lccl import (Edge, LinkTopology, PodFabric, StormReport,
                                   edge_key, inject_storm)
from repro_torch.data.indexer import TidIndexer
from repro_torch.data.loader import PrefetchingLoader, SyntheticTokens
from repro_torch.models import build_model
from repro_torch.models.transformer import resolve_device
from repro_torch.optim import (AdamWConfig, adamw_update, cast_params,
                               cosine_schedule)
from repro_torch.roofline import hw
# recovery machinery lives in runtime/recovery.py
from repro_torch.runtime.recovery import (FaultScript, RecoveryError,
                                          RecoveryPolicy, RecoveryReport,
                                          _flatten_opt, orchestration_timeline,
                                          resolve_policy, shard_slices)
from repro_torch.runtime.reliability import (ReliabilityConfig,
                                             ReliabilityController,
                                             ReliabilityEvent)
from repro_torch.train.state import grad_tree, init_state
from repro_torch.train.step import step_traffic, submit_step_traffic
from repro_torch.tree import copy_from_numpy_, tree_leaves

PyTree = Any

__all__ = [
    "ClusterConfig", "FabricConfig", "FaultScript", "RecoveryError",
    "RecoveryPolicy", "RecoveryReport", "ReliabilityConfig",
    "SimCluster", "Worker", "shard_slices",
]


# --------------------------------------------------------------------------- #
# Configuration surface
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ClusterConfig:
    """Model/batch knobs of a simulated cluster (what trains)."""
    dp: int = 4
    global_batch: int = 8
    seq_len: int = 16
    dataset_size: int = 4096
    hp: AdamWConfig = field(
        default_factory=lambda: AdamWConfig(warmup_steps=2, total_steps=100))
    ckpt_dir: Path = field(
        default_factory=lambda: Path(tempfile.gettempdir()) / "repro_torch_ckpt")
    full_every: int = 50
    seed: int = 0
    t_iter_model: float = 0.05         # modeled wall seconds per iteration


@dataclass(frozen=True)
class FabricConfig:
    """Fabric knobs of a simulated cluster (what the bytes ride).

    `compile_plan=True` switches `LinkTopology.run` onto the decoupled fast
    path (exact timings, but only edges coupled by a pending multi-hop item
    pay the global event loop — see `repro/core/plan.py`) and keeps the BFS
    routing tables epoch-cached across steps.

    The default bandwidths are an H100 cluster's (``roofline/hw.py``): an
    NVLink 4 edge inside a node, an NDR InfiniBand port between nodes
    (``pods``). Times on this fabric are simulated, never the card's."""
    link_bw: float = hw.FABRIC_LINK_BW
    quantum: int = DEFAULT_QUANTUM
    topology: str = "ring"
    edge_bw: Optional[Dict[Edge, float]] = None
    pods: int = 1
    dcn_bw: float = hw.FABRIC_DCN_BW
    ici_latency: float = 0.0
    dcn_latency: float = 0.0
    compile_plan: bool = False
    # routing budget for split-policy recovery/backup streams: max
    # edge-disjoint paths to stripe each stream across (k=2 reproduces the
    # historical both-ring-directions split bit-exactly)
    route_k: int = 2
    # DCN uplinks per pod on a PodFabric (each uplink forms its own
    # gateway ring; 1 reproduces the historical single-gateway fabric)
    dcn_uplinks: int = 1
    # re-run split_bytes over surviving paths when the topology epoch
    # bumps mid-transfer (False pins chunks to their original paths)
    rebalance: bool = True


@dataclass
class Worker:
    wid: int
    alive: bool = True
    host_alive: bool = True           # hardware failure kills host RAM too
    engine: Optional[CkptEngine] = None
    loader: Optional[PrefetchingLoader] = None
    step_times: List[float] = field(default_factory=list)


class SimCluster:
    def __init__(self, cfg: ArchConfig,
                 cluster: Optional[ClusterConfig] = None,
                 fabric: Optional[FabricConfig] = None,
                 recovery: Union[str, RecoveryPolicy, None] = None,
                 reliability: Optional[ReliabilityConfig] = None,
                 *, device=None,
                 clock: Optional[Callable[[], float]] = None):
        """Build a simulated cluster from `ClusterConfig` (model/batch
        knobs) + `FabricConfig` (link knobs) + a recovery policy
        ("stream" | "compute" | "hybrid" or a `RecoveryPolicy` instance)
        + a `ReliabilityConfig` for the self-driving control loop
        (heartbeat/scan cadence, straggler + gray-link policy, adaptive
        checkpoint cadence — defaults match `DetectionTimeline`).

        The model trains on `device`: CUDA when none is named, raising when
        there is no GPU. Given a host `clock` (seconds, e.g.
        `time.perf_counter`), `step` records the wall time of its parts in
        `last_step_timing`; the sim clock never reads it."""
        cc = cluster if cluster is not None else ClusterConfig()
        fc = fabric if fabric is not None else FabricConfig()
        self.cluster_config = cc
        self.fabric_config = fc
        self.recovery_policy: RecoveryPolicy = resolve_policy(recovery)
        dp, global_batch, seed = cc.dp, cc.global_batch, cc.seed
        self.cfg = cfg
        self.dp = dp
        self.active_dp = dp
        self.global_batch = global_batch
        self.seq_len = cc.seq_len
        self.hp = cc.hp
        self.device = resolve_device(device)
        self.model = build_model(cfg, device=self.device)
        # weights drawn on the host and copied over: one seed gives the same
        # weights, and so the same run, on every device (a CUDA generator
        # draws other numbers from the same seed)
        self.state = init_state(self.model, torch.Generator().manual_seed(seed))
        self.iteration = 0
        rc = reliability if reliability is not None else ReliabilityConfig()
        self.reliability_config = rc
        self.controller = StateController(dp=dp, pp=1, tp=1,
                                          global_batch=global_batch,
                                          heartbeat_timeout=rc.timeout)
        self.indexer = TidIndexer(cc.dataset_size, global_batch, seed=seed)
        self.source = SyntheticTokens(cc.dataset_size, cc.seq_len,
                                      cfg.vocab_size, seed=seed)
        # the analytic timeline mirrors the live loop's cadence, so the
        # measured detection latency validates against detection_time()
        self.detection = DetectionTimeline(
            heartbeat_period=rc.heartbeat_period,
            controller_scan_period=rc.scan_period,
            notify_latency=rc.notify_latency)
        # per-link fabric: one LinkScheduler per edge. The train loop's
        # allreduce volume loads every edge (TRAIN, per tier on a pod
        # fabric); each checkpoint artifact rides its routed edge path
        # (STATE chunks), so TRAIN/STATE contention is per-edge and per-tier
        # instead of smeared over one global link. With `pods > 1` the dp
        # workers are grouped into that many ICI rings joined by a DCN
        # gateway ring (`PodFabric`) — cross-pod streams pay the DCN
        # bandwidth and per-hop latency
        self.quantum = fc.quantum
        self.link_bw = fc.link_bw
        self.topology_kind = fc.topology
        self.t_iter_model = cc.t_iter_model
        self.sim_time = 0.0
        self.pods = fc.pods
        self.dcn_bw = fc.dcn_bw
        self.ici_latency = fc.ici_latency
        self.dcn_latency = fc.dcn_latency
        self.route_k = fc.route_k
        self.dcn_uplinks = fc.dcn_uplinks
        if fc.pods > 1 and dp % fc.pods != 0:
            raise ValueError(
                f"pods={fc.pods} must divide dp={dp} to build a PodFabric "
                f"(every pod gets dp/pods workers)")
        self.topology = self._build_fabric(dp, fc.edge_bw)
        self.transport = TopologyTransport(self.topology, route_k=fc.route_k,
                                           auto_rebalance=fc.rebalance)
        self.last_storm: Optional[StormReport] = None
        self.instant_hidden = 0        # instant-ckpt drained within the iter
        self.instant_exposed = 0       # ... spilled past the boundary
        # per-edge view of the same condition (adjacent ring edge per worker)
        self.edge_instant_hidden: Dict[Edge, int] = {}
        self.edge_instant_exposed: Dict[Edge, int] = {}
        eng_cfg = CkptEngineConfig(out_dir=Path(cc.ckpt_dir),
                                   full_every=cc.full_every,
                                   quantum=fc.quantum)
        self.workers = [
            Worker(w,
                   engine=CkptEngine(dataclasses.replace(eng_cfg), worker_id=w,
                                     transport=self.transport),
                   loader=PrefetchingLoader(self.source, self.indexer, w, dp))
            for w in range(dp)
        ]
        self._step = self._make_step()
        self._opt_meta = None
        self._grad_bytes: Optional[float] = None
        # partial recovery transfers, keyed (failed_wid, target_iteration)
        self._pending_recovery: Dict[Tuple[int, int],
                                     Tuple[ChunkedStream, StreamAssembler]] = {}
        # shard layout the held snapshots were taken under; diverges from the
        # live (dp, wid) numbering only across an elastic shrink with a
        # recovery still pending (resume-after-rescale)
        self._layout: Optional[Dict[str, Any]] = None
        self._lazy_done_at: Optional[int] = None
        self.loss_history: List[float] = []
        self._clock = clock
        self.last_step_timing: Dict[str, Optional[float]] = {}
        # --- self-driving reliability loop (runtime/reliability.py) --- #
        # per-worker slowdown multipliers (scenario-injected stragglers)
        self._slow_factor: Dict[int, float] = {}
        # last step's per-worker modeled durations, consumed by the loop
        self.last_step_times: Optional[Dict[int, float]] = None
        # sim seconds trained while the instant checkpoint spilled past the
        # iteration boundary (the exposed complement of FCR)
        self.exposed_seconds = 0.0
        # the loop's on-clock detection replaces the analytic leg in the
        # next recover(): latency measured from fault injection, and a flag
        # that the sim clock already advanced THROUGH the detection window
        self._measured_detection: Optional[float] = None
        self._detection_elapsed = False
        # provisioned bandwidth of scenario-degraded edges (heal restores)
        self._spec_bw_edges: Dict[Edge, float] = {}
        # everybody beats at attach (a fresh heartbeat table reads -inf,
        # which a scan would misread as a pre-start breakdown)
        for w in self.workers:
            self.controller.beat(w.wid, now=0.0)
        self.reliability = ReliabilityController(self, rc)

    def shard_nbytes(self) -> float:
        """Bytes of one worker's unique optimizer-state shard under the
        snapshot layout (float32 flattened vector / layout dp) — the volume
        a recovery policy must move or recompute per failed worker."""
        n = int(sum(int(np.prod(l.shape))
                    for l in tree_leaves(self.state["opt"])))
        ldp = self._shard_layout()[0]
        per = (n + ldp - 1) // ldp
        return float(per * 4)

    # ------------------------------------------------------------------ #
    def _build_fabric(self, dp: int,
                      edge_bw: Optional[Dict[Edge, float]] = None
                      ) -> LinkTopology:
        """The fabric for `dp` workers: a flat ring/full mesh, or — when
        `pods > 1` divides dp — a hierarchical `PodFabric` of ICI rings
        joined by a DCN gateway ring. The constructor rejects a
        non-dividing pod count; an elastic shrink that breaks divisibility
        degrades to a flat ring with a warning."""
        topo: Optional[LinkTopology] = None
        if self.pods > 1:
            if dp % self.pods == 0 and dp // self.pods >= 1:
                topo = PodFabric(self.pods, dp // self.pods, self.link_bw,
                                 self.dcn_bw, quantum=self.quantum,
                                 ici_latency=self.ici_latency,
                                 dcn_latency=self.dcn_latency,
                                 edge_bw=edge_bw,
                                 dcn_uplinks=self.dcn_uplinks)
            else:
                warnings.warn(
                    f"dp={dp} no longer divides into pods={self.pods} after "
                    f"rescale; the fabric degrades to a flat ring",
                    RuntimeWarning, stacklevel=2)
        if topo is None:
            topo = LinkTopology(dp, self.link_bw, quantum=self.quantum,
                                kind=self.topology_kind, edge_bw=edge_bw,
                                latency=self.ici_latency)
        topo.compile_plan = self.fabric_config.compile_plan
        return topo

    # ------------------------------------------------------------------ #
    def _make_step(self):
        """The global step: loss and gradients, then AdamW and the params
        cast from the master. The state is updated in place on the device
        (the counterpart of the reference's donated buffers)."""
        model, hp = self.model, self.hp

        def step(state, batch):
            model.zero_grad(set_to_none=True)
            loss, aux = model.loss(batch)
            loss.backward()
            lr = cosine_schedule(state["step"], lr=hp.lr,
                                 warmup_steps=hp.warmup_steps,
                                 total_steps=hp.total_steps)
            adamw_update(grad_tree(model), state["opt"], state["step"], hp, lr)
            cast_params(state["opt"]["master"], state["params"])
            state["step"].add_(1)
            return state, loss.detach()

        return step

    def _assemble_batch(self) -> Dict[str, torch.Tensor]:
        parts = []
        for w in self.workers[:self.active_dp]:
            parts.append(w.loader.get(self.iteration))
        return {"tokens": torch.from_numpy(np.concatenate(parts, axis=0))
                .to(self.device)}

    def load_state(self, host: Any) -> None:
        """Write a host state tree in the reference's layout ({"step",
        "params", "opt"} with numpy leaves, e.g. the JAX package's
        ``init_state`` through ``np.asarray``) into the cluster's state, so
        that two clusters start from the same state."""
        copy_from_numpy_(self.state, host)

    def _shard_and_backup(self) -> None:
        """Instant checkpoint: split unique opt state into dp shards; worker
        (i+1) stores worker i's shard (the in-step ppermute, host view) AND
        streams it as chunked STATE traffic over its adjacent fabric edge."""
        t0 = self._now()
        vec, meta = _flatten_opt(self.state["opt"])
        t1 = self._now()
        self._opt_meta = meta
        slices = shard_slices(len(vec), self.dp)
        it = self.iteration
        active = self.active_dp
        shards = {i: vec[slices[i]].copy() for i in range(active)}
        for i, w in enumerate(self.workers[:active]):
            # predecessor's shard lands in this worker's host RAM
            nbr_shard = ({"shard": shards[(i - 1) % active]}
                         if (w.alive and w.host_alive) else None)
            w.engine.on_step(it, {"shard": shards[i]}, nbr_shard,
                             t=self.sim_time)
            self.controller.report_ckpt(i, it)
        self._record("flatten_ms", t0, t1)
        self._record("shard_ms", t1)

    def step_traffic_profile(self):
        """This step's wire volumes (train/step.py accounting). On a pod
        fabric the allreduce is two-level: intra-pod ring volume per ICI
        edge plus the inter-pod shard allreduce per DCN edge."""
        if self._grad_bytes is None:
            self._grad_bytes = float(sum(
                int(np.prod(l.shape)) * 4
                for l in tree_leaves(self.state["params"])))
        if isinstance(self.topology, PodFabric):
            from repro_torch.train.step import hierarchical_step_traffic
            return hierarchical_step_traffic(self._grad_bytes,
                                             self.topology.n_pods,
                                             self.topology.pod_size)
        return step_traffic(self._grad_bytes, self.active_dp)

    def _now(self) -> Optional[float]:
        return self._clock() if self._clock is not None else None

    def _record(self, key: str, t0: Optional[float],
                t1: Optional[float] = None) -> None:
        if t0 is not None:
            t1 = self._now() if t1 is None else t1
            self.last_step_timing[key] = (t1 - t0) * 1e3

    def step(self) -> float:
        """One training iteration and its instant checkpoint. With a host
        clock, fills `last_step_timing` with the wall ms of its parts:
        `compute_ms` (the model step, waited for), `device_ms` (the same
        by CUDA events, None off CUDA), `flatten_ms` (the opt state copied
        to one host vector), `shard_ms` (sharding, keeping and chunking
        the shards), `fabric_ms` (the link model's event loop) and
        `step_ms` (all of it)."""
        t_step = self._now()
        self.last_step_timing = {}
        batch = self._assemble_batch()
        # the allreduce volume for this step goes on EVERY live ring edge
        # (per-edge TRAIN), preempting any in-flight STATE chunks there
        submit_step_traffic(self.transport, self.step_traffic_profile(),
                            self.sim_time)
        events = None
        if self._clock is not None and self.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        t0 = self._now()
        self.state, loss = self._step(self.state, batch)
        if events is not None:
            events[1].record()
        loss = float(loss)             # waits for the step, as block_until_ready
        self._record("compute_ms", t0)
        if t0 is not None:
            self.last_step_timing["device_ms"] = None
        if events is not None:
            events[1].synchronize()
            self.last_step_timing["device_ms"] = events[0].elapsed_time(
                events[1])
        self.iteration += 1
        self._shard_and_backup()
        # per-worker MODELED durations (sim seconds, never wall time): the
        # synchronous step paces at the slowest worker, so an injected
        # straggler stretches everyone's iteration — exactly what the
        # reliability loop's EWMAs watch for
        step_times: Dict[int, float] = {}
        for w in self.workers[:self.active_dp]:
            w.engine.maybe_full_checkpoint(
                self.iteration, self.state if w.wid == 0 else
                {"marker": np.zeros(1)}, t=self.sim_time)
            dt_w = self.t_iter_model * self._slow_factor.get(w.wid, 1.0)
            step_times[w.wid] = dt_w
            w.step_times.append(dt_w)
        # advance the link model one modeled iteration in a single window:
        # the fabric clock is event-ordered, so a cross-pod (multi-hop)
        # instant stream lands at its exact store-and-forward instant inside
        # the iteration it was submitted in. Instant-ckpt chunks that drain
        # before the boundary were hidden (the FCR condition, emergent from
        # the transport instead of Eq. 2) — tracked globally and per
        # delivering fabric edge
        dt = max(step_times.values()) if step_times else self.t_iter_model
        self.sim_time += dt
        # live workers heartbeat ON THE SIM CLOCK at the step boundary — a
        # dead worker's slot freezes and the liveness scan finds it
        for w in self.workers[:self.active_dp]:
            if w.alive:
                self.controller.beat(w.wid, now=self.sim_time)
        self.last_step_times = step_times
        t0 = self._now()
        self.transport.run(until=self.sim_time)
        self._record("fabric_ms", t0)
        tickets = []
        for w in self.workers[:self.active_dp]:
            tk = w.engine.last_instant_ticket
            if tk is None:
                continue
            tickets.append(tk)
            # book the verdict on the fabric edge that DELIVERED the shard —
            # the last hop of the path the stream actually rode. On a pod
            # fabric, consecutive wids across a pod boundary have no direct
            # edge, so the raw (src, dst) pair would be a phantom key
            # invisible to per-edge summaries
            e = tk.delivery_edge
            if e is None:              # single-node fabric: local delivery
                src, dst = self.transport.instant_route(w.wid)
                e = edge_key(src, dst)
            book = (self.edge_instant_hidden if tk.complete
                    else self.edge_instant_exposed)
            book[e] = book.get(e, 0) + 1
        if tickets:
            if all(tk.complete for tk in tickets):
                self.instant_hidden += 1
            else:
                self.instant_exposed += 1
                self.exposed_seconds += dt
        self.reliability.tick(self.sim_time)
        self.loss_history.append(float(loss))
        self._record("step_ms", t_step)
        return float(loss)

    def run(self, n_steps: int) -> List[float]:
        return [self.step() for _ in range(n_steps)]

    # ------------------------------------------------------------------ #
    # Self-driving reliability surface (gray failures, stragglers, stalls)
    # ------------------------------------------------------------------ #
    def advance_idle(self, dt: float) -> List[ReliabilityEvent]:
        """Advance the sim clock `dt` seconds with training STALLED — the
        collective hangs on a failed worker, no step completes. Live
        workers still heartbeat (their processes are fine), the fabric
        drains, and the reliability loop scans: this is the window in which
        on-clock failure detection happens. Returns the loop's events."""
        self.sim_time += dt
        self.transport.run(until=self.sim_time)
        for w in self.workers[:self.active_dp]:
            if w.alive:
                self.controller.beat(w.wid, now=self.sim_time)
        return self.reliability.tick(self.sim_time)

    def set_straggler(self, wid: int, factor: float) -> None:
        """Worker `wid` now takes `factor` x the modeled iteration time
        (thermal throttling, a sick HBM stack, a noisy neighbor...)."""
        self._slow_factor[wid] = float(factor)

    def clear_straggler(self, wid: int) -> None:
        self._slow_factor.pop(wid, None)

    def degrade_edge(self, u: int, v: int, factor: float) -> None:
        """Silently degrade link (u, v) to `factor` x its current rate — a
        gray failure: the link is up, routing still uses it, but traffic
        crawls. Only the reliability loop's observed-throughput scan can
        tell (`set_bandwidth` is the fabric model's knob, not a signal any
        worker receives)."""
        e = edge_key(u, v)
        sch = self.topology.links[e]
        self._spec_bw_edges.setdefault(e, sch.bw)
        self.topology.set_bandwidth(u, v, sch.bw * factor)

    def heal_edge(self, u: int, v: int) -> None:
        """Repair a degraded link to its provisioned rate and lift any
        quarantine the reliability loop placed on it."""
        e = edge_key(u, v)
        spec = self._spec_bw_edges.pop(e, None)
        if spec is not None:
            self.topology.set_bandwidth(u, v, spec)
        self.reliability.release_edge(u, v)

    # ------------------------------------------------------------------ #
    # Failure injection + recovery
    # ------------------------------------------------------------------ #
    def inject_failure(self, wids: List[int], *, hardware: bool = False
                       ) -> None:
        self.reliability.note_failure(wids, self.sim_time)
        for wid in wids:
            self.workers[wid].alive = False
            # the node's ring edges go dark: nothing routes through it
            self.topology.fail_node(wid)
            if hardware:
                self.workers[wid].host_alive = False
                # host RAM gone: its own + neighbor backups are lost
                self.workers[wid].engine.own = type(
                    self.workers[wid].engine.own)(2)
                self.workers[wid].engine.neighbor = type(
                    self.workers[wid].engine.neighbor)(2)

    def inject_storm(self, seed: int, *, pods: int = 1,
                     edge_failures: int = 0) -> StormReport:
        """Correlated failure storm, reproducible from `seed` (lccl
        `inject_storm`): whole pods darken at once and every worker in them
        dies (software — processes gone, host RAM survives), plus
        `edge_failures` extra clustered edge failures. Storm-darkened EDGES
        persist through `recover()` (only the failed workers' nodes relight
        when their replacement pods come up), so recovery streams must race
        around the damage — over the DCN gateway ring when a whole pod sits
        between holder and newcomer."""
        report = inject_storm(self.topology, seed, pods=pods,
                              edge_failures=edge_failures)
        dead = [wid for wid in report.nodes if wid < len(self.workers)]
        self.reliability.note_failure(dead, self.sim_time)
        for wid in dead:
            self.workers[wid].alive = False
        self.last_storm = report
        return report

    # ----------------------- shard layout plumbing ----------------------- #
    # Snapshots are sliced by the (dp, wid) numbering in force when they were
    # taken. After an elastic shrink with a recovery still pending, the live
    # numbering differs; `_shard_layout` maps between the two so the resumed
    # recovery reassembles the optimizer vector with the SNAPSHOT layout.
    def _shard_layout(self) -> Tuple[int, Dict[int, int], Dict[int, int]]:
        """(layout_dp, old_of: live wid -> layout wid, new_of: inverse)."""
        if self._layout is None:
            ident = {i: i for i in range(self.dp)}
            return self.dp, dict(ident), dict(ident)
        old_of = dict(self._layout["old_of"])
        return self._layout["dp"], old_of, {o: n for n, o in old_of.items()}

    def _slice_source(self, old_slice: int, ldp: int,
                      new_of: Dict[int, int]) -> Tuple[str, Optional[int]]:
        """Where old shard-slice `old_slice` comes from: ("own", live wid) if
        its owner is healthy, else ("neighbor", live wid of its ring-successor
        backup holder), else ("none", None)."""
        owner = new_of.get(old_slice)
        if owner is not None and self.workers[owner].alive and \
                self.workers[owner].host_alive and \
                self.workers[owner].engine.own.latest() is not None:
            return "own", owner
        holder = new_of.get((old_slice + 1) % ldp)
        if holder is not None and self.workers[holder].host_alive and \
                self.workers[holder].engine.neighbor.latest() is not None:
            return "neighbor", holder
        return "none", None

    def _recoverable_from_neighbors(self, failed: List[int]) -> bool:
        ldp, _, new_of = self._shard_layout()
        for o in range(ldp):
            kind, _ = self._slice_source(o, ldp, new_of)
            if kind == "none":
                return False
        return True

    def recover(self, faults: Optional[FaultScript] = None, *,
                policy: Union[str, RecoveryPolicy, None] = None
                ) -> RecoveryReport:
        """Recover every failed worker via a `RecoveryPolicy`.

        `faults` scripts what goes wrong DURING recovery (hardware loss,
        mid-transfer interruption, wire corruption) — see `FaultScript`.

        `policy` overrides the cluster's configured recovery policy for
        this one recovery ("stream" | "compute" | "hybrid" or an
        instance). A policy that cannot honor the fault script (e.g.
        interrupting a chunk transfer it never performs) raises
        `RecoveryError`."""
        faults = faults or FaultScript()
        pol = resolve_policy(policy) if policy is not None \
            else self.recovery_policy
        failed = [w.wid for w in self.workers if not w.alive]
        assert failed, "no failed workers"
        # replacement pods come up before state moves: their ring edges
        # relight, while any OTHER dark node keeps its edges dark and
        # recovery paths route around it
        for wid in failed:
            self.topology.restore_node(wid)
        timeline = orchestration_timeline(self, faults)

        # lazy backup: healthy DP rank 0 persists redundant state (params).
        # It goes on the wire NOW, overlapping the detection/pod-creation
        # window (§4.2) — recovery chunks only start once pods are up, so
        # the lazy stream has the link to itself first
        rank0 = self.workers[0]
        if rank0.alive and self._lazy_done_at != self.iteration:
            # once per iteration: a resumed recovery must not re-save and
            # re-stream the multi-GB redundant state it already persisted
            rank0.engine.lazy_backup(self.iteration,
                                     {"params": self.state["params"]},
                                     is_dp_rank0=True, t=self.sim_time)
            self._lazy_done_at = self.iteration
        t_orch = sum(timeline.values())
        if self._detection_elapsed:
            # the reliability loop detected this breakdown ON the sim clock
            # (advance_idle windows) — the detection leg already elapsed, so
            # the streams must not wait through it a second time. The
            # timeline still reports it (measured): it is part of the
            # failover the job experienced.
            t_orch -= timeline.get("detection", 0.0)

        plan = pol.plan(self, failed, faults, timeline=timeline,
                        t_start=self.sim_time + t_orch)
        report = pol.execute(plan)
        if report.kind == "interrupted":
            # workers stay down; their edges go dark again
            for wid in failed:
                self.topology.fail_node(wid)
            return report              # partial chunks retained

        for wid in failed:
            self.workers[wid].alive = True
            self.workers[wid].host_alive = True
            self.controller.beat(wid, now=self.sim_time)
            self.workers[wid].loader.repartition(self.active_dp)
        self.reliability.on_recovered(failed)
        self._measured_detection = None
        self._detection_elapsed = False
        # a completed recovery repairs the storm's fabric damage along with
        # the pods: the recovery STREAMS had to race around the dark edges
        # (DCN detours), but the healed job trains on a whole fabric again
        if self.last_storm is not None:
            for e in self.last_storm.edges:
                self.topology.restore_edge(*e)
            self.last_storm = None
        return report

    # ------------------------------------------------------------------ #
    # Elastic rescale (no spare capacity): shrink DP, repartition data
    # ------------------------------------------------------------------ #
    def shrink(self, lost: List[int]) -> int:
        """Shrink DP by dropping `lost` workers (no spare capacity).

        A shrink can strike mid-recovery: partial recovery streams whose
        target worker SURVIVES the rescale are kept (their assemblers retain
        every received chunk) and the next `recover()` resumes them. The
        shard layout the pending snapshots/streams were sliced under is
        remembered in `_layout` so the resumed recovery reassembles
        correctly; streams aimed at removed workers are dropped with them."""
        old_dp = self.dp
        keep = [w for w in self.workers if w.wid not in lost]
        wid_map = {w.wid: new_id for new_id, w in enumerate(keep)}
        layout_old_of = {}
        if self._layout is None:
            # live numbering == snapshot layout until now
            layout_dp, prev_old_of = old_dp, {i: i for i in range(old_dp)}
        else:                           # stacked shrinks: compose mappings
            layout_dp = self._layout["dp"]
            prev_old_of = self._layout["old_of"]
        for old_wid, new_wid in wid_map.items():
            layout_old_of[new_wid] = prev_old_of[old_wid]
        # keep partial recovery streams for surviving workers (key on the
        # new numbering); streams for removed workers die with them
        self._pending_recovery = {
            (wid_map[wid], target): sa
            for (wid, target), sa in self._pending_recovery.items()
            if wid in wid_map}
        self.workers = keep
        for new_id, w in enumerate(self.workers):
            w.wid = new_id
            w.engine.worker_id = new_id
        self.dp = len(self.workers)
        self.active_dp = self.dp
        still_failed = [w.wid for w in self.workers if not w.alive]
        self._layout = ({"dp": layout_dp, "old_of": layout_old_of}
                        if (self._pending_recovery or still_failed)
                        else None)
        self.controller.shrink_dp(lost)
        per = self.global_batch // max(self.active_dp, 1)
        self.global_batch = per * self.active_dp
        self.controller.global_batch = self.global_batch
        self.indexer = TidIndexer(self.indexer.dataset_size,
                                  self.global_batch, seed=self.indexer.seed)
        for i, w in enumerate(self.workers):
            w.loader = PrefetchingLoader(self.source, self.indexer, i,
                                         self.active_dp)
        # the fabric rescales with the job: fresh per-edge fabric at the new
        # size; in-flight hops on the old fabric are lost (assemblers keep
        # their received chunks, so resumed recoveries only move `missing()`).
        # Surviving edges keep their configured bandwidth (hotspot edges stay
        # throttled); newly-adjacent pairs get the default. A pod fabric is
        # rebuilt at the same pod count while the shrunk dp still divides
        # into it; otherwise it degrades to a flat ring (`_build_fabric`).
        kept_bw = {edge_key(wid_map[a], wid_map[b]): sch.bw
                   for (a, b), sch in self.topology.links.items()
                   if a in wid_map and b in wid_map}
        if isinstance(self.topology, PodFabric):
            # renumbering reshuffles which pairs are ICI vs DCN: the rebuilt
            # fabric's tier defaults are authoritative, old per-edge
            # overrides would mislabel tier bandwidths
            kept_bw = None
        self.topology = self._build_fabric(self.dp, kept_bw)
        self.transport = TopologyTransport(self.topology)
        for w in self.workers:
            w.engine.transport = self.transport
            if not w.alive:
                self.topology.fail_node(w.wid)
        # the reliability loop's index-keyed books (EWMAs, quarantines, spec
        # snapshots) are meaningless under the new numbering/fabric
        self._slow_factor.clear()
        self._spec_bw_edges.clear()
        self.last_step_times = None
        for w in self.workers:
            if w.alive:
                self.controller.beat(w.wid, now=self.sim_time)
        self.reliability.on_rescale()
        return self.dp
