"""The pure-Python parts of the reference's ``repro.train.step``: per-step
link-traffic accounting and the replay-compute cost model, which the
simulated cluster and the recovery policies read.

``build_train_step`` (the sharded multi-device step with the in-step
neighbor backup) is not ported yet: ROADMAP §1 item 9. The one-device step
is ``SimCluster``'s (``runtime/cluster.py``). ``razor`` arguments take any
object with ``unique_bytes_per_device_ring`` (the reference's ``RazorPlan``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


# --------------------------------------------------------------------------- #
# Link-traffic accounting (paper §5.3): what one training iteration puts on
# the wire, per worker (all volumes in bytes). The runtime submits
# `train_bytes` as TRAIN traffic to the StateStream transport — the volume
# that preempts checkpoint chunks — while the instant-ckpt shard rides the
# fabric as STATE. On a hierarchical PodFabric the allreduce is two-level
# (intra-pod ring + inter-pod gateway ring), so the profile carries a
# per-tier wire volume.
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class TrafficProfile:
    train_bytes: float   # per-ICI-edge gradient allreduce volume (preempting)
    state_bytes: float   # razor-unique instant-ckpt shard, one DP-ring hop
    dcn_bytes: float = 0.0  # per-DCN-edge inter-pod allreduce volume


def step_traffic(grad_bytes: float, dp: int,
                 razor: Optional[Any] = None,
                 state_bytes: Optional[float] = None) -> TrafficProfile:
    """Per-iteration wire volumes for one worker (flat DP ring). Ring
    allreduce moves 2(dp-1)/dp of the gradient bytes; the instant checkpoint
    moves the razor-unique optimizer shard one hop along the DP ring."""
    wire = 2.0 * (dp - 1) / dp * grad_bytes if dp > 1 else 0.0
    if state_bytes is None:
        state_bytes = float(razor.unique_bytes_per_device_ring) if razor \
            else 0.0
    return TrafficProfile(wire, state_bytes)


def hierarchical_step_traffic(grad_bytes: float, n_pods: int, pod_size: int,
                              razor: Optional[Any] = None,
                              state_bytes: Optional[float] = None
                              ) -> TrafficProfile:
    """Per-iteration wire volumes for the two-level allreduce on a
    `PodFabric` (bytes).

    Intra-pod: ring reduce-scatter + allgather over the `pod_size`-node ICI
    ring moves ``2(s-1)/s * grad_bytes`` across every ICI edge
    (`train_bytes`). Inter-pod: after the reduce-scatter each node holds a
    ``grad_bytes / s`` shard; the gateways allreduce those shards around the
    `n_pods`-pod DCN ring, putting ``2(P-1)/P * grad_bytes / s`` on every
    DCN edge (`dcn_bytes`). Degenerates to `step_traffic` shapes when
    P == 1 (no DCN leg) or s == 1 (pure DCN ring of gateways)."""
    s, p = pod_size, n_pods
    ici = 2.0 * (s - 1) / s * grad_bytes if s > 1 else 0.0
    shard = grad_bytes / max(s, 1)
    dcn = 2.0 * (p - 1) / p * shard if p > 1 else 0.0
    if state_bytes is None:
        state_bytes = float(razor.unique_bytes_per_device_ring) if razor \
            else 0.0
    return TrafficProfile(ici, state_bytes, dcn)


# --------------------------------------------------------------------------- #
# Checkpoint-free replay-compute cost model ("All is Not Lost", PAPERS.md):
# instead of streaming a lost worker's state over the fabric, its pipeline/DP
# neighbors re-execute redundant compute to rebuild the shard from their own
# replicas — recovery then costs worker compute-seconds instead of fabric
# bytes, which is exactly the currency that stays cheap when a storm has
# darkened the cross-pod links.
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ReplayCostModel:
    """Knobs for compute-based (checkpoint-free) recovery.

    `recompute_rate` is how many bytes of lost optimizer/param state one
    replaying worker can rebuild per second of redundant compute (forward
    replay at the training step rate, amortized). `replay_overhead`
    multiplies the state volume: redundant compute interleaves with the
    replayer's own step, so rebuilding B bytes burns more than B worth of
    step time. `setup_seconds` is the fixed cost of re-materializing
    activations and swapping the replay schedule in."""
    recompute_rate: float = 2e9        # bytes of state rebuilt / s / replayer
    replay_overhead: float = 1.25      # redundant-compute amplification
    setup_seconds: float = 0.5         # schedule swap + activation re-mat


@dataclass(frozen=True)
class ReplayCost:
    """One failed worker's replay bill: `wall_seconds` is the elapsed time
    with the replayers working in parallel; `compute_seconds` is the total
    worker compute burned (the resource compute-based recovery spends
    instead of fabric bytes)."""
    wall_seconds: float
    compute_seconds: float
    bytes_rebuilt: float
    n_replayers: int


def replay_compute_cost(state_bytes: float, n_replayers: int = 2,
                        model: ReplayCostModel = ReplayCostModel()
                        ) -> ReplayCost:
    """Cost of rebuilding `state_bytes` of a lost worker's state by replaying
    redundant compute on `n_replayers` healthy neighbors. The replayers
    split the replay evenly, so wall time divides by their count while the
    total compute burned does not. Submits NO fabric traffic."""
    n = max(int(n_replayers), 1)
    burn = state_bytes * model.replay_overhead / model.recompute_rate
    wall = model.setup_seconds + burn / n
    return ReplayCost(wall_seconds=wall, compute_seconds=burn,
                      bytes_rebuilt=float(state_bytes), n_replayers=n)


def submit_step_traffic(transport, profile: TrafficProfile, t: float):
    """Put one iteration's allreduce volume on the fabric, edge by edge.

    A ring allreduce moves 2(n-1) messages of S/n bytes across EVERY ring
    edge, so the per-edge wire volume equals the per-worker volume
    (`profile.train_bytes`) — on a `TopologyTransport` this loads each live
    ring edge with exactly that, and checkpoint STATE chunks then contend
    per-edge; on a single-link transport it degrades to the global
    submission. A profile with a `dcn_bytes` leg (hierarchical allreduce)
    loads each tier with its own volume instead. Returns the submitted
    transfer(s)."""
    if profile.dcn_bytes and hasattr(transport, "submit_train_tiers"):
        from repro_torch.core.lccl import TIER_DCN, TIER_ICI
        return transport.submit_train_tiers(
            {TIER_ICI: profile.train_bytes, TIER_DCN: profile.dcn_bytes}, t)
    return transport.submit_train(profile.train_bytes, t)
