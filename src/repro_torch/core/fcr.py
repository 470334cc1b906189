"""Free Checkpointing Ratio (paper §4.2, Eq. 2):

    FCR = s * b * V / (2 * C)   —  free (fully-hidden) CKPT iff FCR >= 1

s: tokens/sequence, b: per-device batch, V: per-device backup-link bandwidth
(bytes/s), C: per-device FLOP/s. Derivation: T_c = 6 s b phi / C must cover
T'_ckpt = 12 phi / V.

The port's own copy of ``repro.core.fcr``, with the same functions, names
and signatures. Its defaults are an H100's (``roofline/hw.py``): the backup
link is one direction of an NVLink 4 edge (450 GB/s, `FABRIC_LINK_BW`) and C
is the card's dense bf16 tensor-core peak (989 TFLOP/s). The per-tier and
per-edge verdicts read the port's own `PodFabric` / `LinkTopology`
(``core/lccl.py``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List

from repro_torch.roofline import hw


def fcr(s: float, b: float, v: float, c: float) -> float:
    return (s * b * v) / (2.0 * c)


def is_free(s: float, b: float, v: float, c: float) -> bool:
    return fcr(s, b, v, c) >= 1.0


def tpu_fcr(seq_len: int, global_batch: int, dp: int,
            link_bw: float = hw.FABRIC_LINK_BW,
            peak_flops: float = hw.PEAK_FLOPS["bfloat16"]) -> float:
    """FCR for a data-parallel job: per-device batch = global_batch / dp.
    The name is the reference's; the defaults are the H100's (one NVLink 4
    direction, the bf16 tensor-core peak), not a TPU's."""
    return fcr(seq_len, global_batch / dp, link_bw, peak_flops)


@dataclass(frozen=True)
class FcrSample:
    seq_len: int
    batch_per_device: int
    bandwidth: float
    flops: float

    @property
    def value(self) -> float:
        return fcr(self.seq_len, self.batch_per_device, self.bandwidth,
                   self.flops)

    @property
    def free(self) -> bool:
        return self.value >= 1.0


def sweep(seq_lens: Iterable[int], batches: Iterable[int],
          bandwidths: Iterable[float], flops: Iterable[float]
          ) -> List[FcrSample]:
    """Parameter sweep behind the paper's Fig. 9 parallel-coordinates plot."""
    out = []
    for s in seq_lens:
        for b in batches:
            for v in bandwidths:
                for c in flops:
                    out.append(FcrSample(s, b, v, c))
    return out


def _tier_worst_edge(fabric):
    """Yield (tier, bandwidth, latency) for each non-empty tier: the tier's
    minimum edge bandwidth and maximum edge latency — the conservative
    representative both the closed-form and emergent per-tier verdicts are
    judged at, so they can't diverge."""
    for t in fabric.tiers():
        edges = fabric.tier_edges(t)
        if edges:
            yield (t, min(fabric.edge(*e).bw for e in edges),
                   max(fabric.edge(*e).latency for e in edges))


def fcr_per_tier(fabric, s: float, b: float, c: float) -> dict:
    """Closed-form FCR (Eq. 2) per fabric *tier*: for each tier (ICI ring /
    DCN gateway hops of a `PodFabric`) evaluate `fcr` at the tier's worst
    (minimum-bandwidth) edge. A tier's checkpoint traffic is free iff its
    value >= 1, so on a hierarchical fabric the instant checkpoint can be
    free on the ICI tier while the same volume would be exposed on DCN —
    exactly why tier-aware stream placement keeps instant shards on ICI and
    spills only slack-tolerant artifacts to DCN. Eq. 2 has no latency
    term; `fcr_hidden_per_tier` (emergent) accounts for it."""
    return {t: fcr(s, b, v, c) for t, v, _ in _tier_worst_edge(fabric)}


def fcr_hidden_per_tier(fabric, s: float, b: float, c: float,
                        phi: float = 1e9, *, iters: int = 3,
                        quantum: float = 4 << 20,
                        train_traffic=()) -> dict:
    """Per-tier FCR hiding verdict, emergent from the transport: every tier
    is judged by its worst edge's `fcr_hidden_emergent` run, including the
    tier's delivery latency (a DCN chunk lands `latency` seconds after
    transmission ends, so a tier can be exposed even when Eq. 2 says
    free). On an idle zero-latency fabric this reduces exactly to
    ``fcr_per_tier(...) >= 1`` tier by tier (the closed form); with
    `train_traffic` sharing the links, hiding demands genuine surplus on
    that tier."""
    return {t: fcr_hidden_emergent(s, b, v, c, phi, iters=iters,
                                   quantum=quantum, latency=lat,
                                   train_traffic=train_traffic)
            for t, v, lat in _tier_worst_edge(fabric)}


def fcr_hidden_per_edge(topology, s: float, b: float, c: float,
                        phi: float = 1e9, *, iters: int = 3,
                        quantum: float = 4 << 20,
                        train_traffic=(),
                        edge_train_traffic=None) -> dict:
    """Per-edge FCR hiding over a `LinkTopology` ring: every edge carries its
    neighbor-shard STATE chunks at that edge's OWN bandwidth, plus the
    ring-allreduce TRAIN volume every edge sees (`train_traffic`, (t, bytes)
    pairs) and any `edge_train_traffic[{edge}]` extras. Returns
    {edge: hidden?}.

    On a dedicated ring (no TRAIN traffic) each edge's verdict reduces
    exactly to the closed form `is_free(s, b, v_edge, c)` — Eq. 2, but now a
    hotspot or asymmetric edge fails hiding on precisely that edge while the
    rest of the ring stays free."""
    extra = edge_train_traffic or {}
    out = {}
    for e in topology.edges():
        sched = topology.edge(*e)
        traffic = list(train_traffic) + list(extra.get(e, ()))
        out[e] = fcr_hidden_emergent(s, b, sched.bw, c, phi, iters=iters,
                                     quantum=quantum, latency=sched.latency,
                                     train_traffic=traffic)
    return out


def fcr_hidden_emergent(s: float, b: float, v: float, c: float,
                        phi: float = 1e9, *, iters: int = 3,
                        quantum: float = 4 << 20, latency: float = 0.0,
                        train_traffic=()) -> bool:
    """The FCR hiding condition, EMERGENT from the StateStream transport
    instead of Eq. 2: drive each iteration's razor checkpoint (12·φ bytes of
    chunked STATE traffic) through a TRAIN/STATE link scheduler between
    compute boundaries T_c = 6·s·b·φ/C apart, and report whether every
    iteration's chunks drained before the next boundary. `latency`
    (seconds) is the link's delivery latency: the last chunk lands that
    much after its transmission ends, so a high-latency link can be
    exposed even when Eq. 2 says free.

    On a dedicated zero-latency backup link this reduces exactly to
    `is_free` (FCR >= 1); with `train_traffic` sharing the link — (t,
    bytes) pairs — hiding demands genuine surplus capacity, which no
    closed form captures."""
    from repro_torch.core.lccl import LinkScheduler, submit_chunked

    t_c = 6.0 * s * b * phi / c
    ckpt_bytes = 12.0 * phi
    sched = LinkScheduler(v, quantum=min(quantum, max(ckpt_bytes, 1.0)),
                          latency=latency)
    per_iter: List[List] = []
    for i in range(iters):
        per_iter.append(submit_chunked(sched, "STATE", ckpt_bytes, i * t_c))
    for t, nbytes in train_traffic:
        sched.submit("TRAIN", nbytes, t)
    # one exact pass: drain's event-ordered clock records every chunk's true
    # finish instant (windowed advancement would produce identical times),
    # so the per-iteration verdict below reads the exact schedule
    sched.drain()
    eps = 1e-9 * max(t_c, 1.0)
    return all(tr.t_finish <= (i + 1) * t_c + eps
               for i, trs in enumerate(per_iter) for tr in trs)
