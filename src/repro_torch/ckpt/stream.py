"""StateStream — unified chunked checkpoint transport (paper §4.2 + §5.3).

Every checkpoint artifact — instant neighbor shards, full async fallbacks,
lazy backups, recovery fetches — is cut into fixed-size CRC'd quanta
(`StreamChunk`) and scheduled as STATE traffic on the modeled fabric, while
the train loop submits its gradient-allreduce volume as TRAIN traffic.
Preemption, overlap, and the FCR hiding condition then *emerge* from the one
transport model instead of living in three hand-tuned formulas.

Units: chunk/stream sizes are bytes, `quantum` is bytes, all transport
timestamps (`t`, finish times) are seconds on the simulation clock, and
bandwidths inherited from the fabric are bytes/second.

Layers:

  * `ChunkedStream`   — producer: pytree/array -> ordered chunks, per-chunk
                        CRC32, plus the metadata needed to rebuild the pytree.
  * `StreamAssembler` — consumer: accepts chunks in any order, verifies CRCs,
                        dedupes, and reports what is still `missing()` — the
                        basis of resumable partial transfers.
  * `StreamTransport` — binds streams to one shared `LinkScheduler` (the
                        PR-1 single-link model, kept for analytic baselines):
                        each chunk becomes one STATE transfer; finished
                        transfers are pumped into their assemblers; TRAIN
                        traffic submitted through the same object preempts
                        every stream.
  * `TopologyTransport` — the fabric variant: routes each stream onto
                        `LinkTopology` / `PodFabric` edge paths. Neighbor
                        shards ride the adjacent ring edge; recovery fetches
                        split across both ring directions by residual
                        bandwidth (bidirectional routing); lazy backups fan
                        out over the source's incident edges onto whichever
                        tier has slack; full artifacts pick the least-loaded
                        live edge. Contention is per-edge, per-tier — never
                        smeared.

Both transports heal corruption with NACK-driven retransmission: a chunk the
assembler rejects on CRC is re-submitted immediately (alone), instead of
waiting for a full `missing()` resend pass.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.lccl import (Edge, LinkScheduler, LinkTopology, PathTransfer,
                             RoutingError, Transfer, edge_key)
from repro_torch.tree import (keystr, to_numpy, tree_flatten,
                              tree_flatten_with_path, tree_unflatten)

PyTree = Any
DEFAULT_QUANTUM = 1 << 20          # 1 MiB — the paper's chunk granularity


# --------------------------------------------------------------------------- #
# Chunk format
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class StreamChunk:
    """One transport quantum of a checkpoint artifact."""
    stream_id: str
    seq: int                       # chunk index within the stream
    n_chunks: int
    offset: int                    # byte offset of payload in the artifact
    payload: bytes
    crc: int                       # CRC32 of payload
    total_bytes: int               # artifact size

    @property
    def nbytes(self) -> int:
        return len(self.payload)

    def verify(self) -> bool:
        return zlib.crc32(self.payload) == self.crc

    def manifest_entry(self) -> Dict[str, int]:
        return {"seq": self.seq, "offset": self.offset,
                "nbytes": self.nbytes, "crc": self.crc}


def _leaf_records(tree: PyTree) -> List[Tuple[str, np.ndarray]]:
    return [(keystr(path), np.ascontiguousarray(to_numpy(leaf)))
            for path, leaf in tree_flatten_with_path(tree)]


class ChunkedStream:
    """A checkpoint artifact cut into CRC'd fixed-size quanta.

    `quantum` is the chunk size in bytes (the last chunk may be short);
    `data` is the serialized artifact. `meta` carries enough layout
    information (leaf key, dtype, shape, byte offset) to rebuild the
    original pytree from the reassembled byte blob.
    """

    def __init__(self, stream_id: str, data: bytes,
                 meta: Optional[List[Tuple[str, str, Tuple[int, ...], int]]]
                 = None, quantum: int = DEFAULT_QUANTUM):
        assert quantum > 0
        self.stream_id = stream_id
        self.meta = meta
        self.quantum = quantum
        self.total_bytes = len(data)
        n = max(1, math.ceil(len(data) / quantum))
        self.chunks: List[StreamChunk] = []
        for i in range(n):
            payload = data[i * quantum:(i + 1) * quantum]
            self.chunks.append(StreamChunk(
                stream_id, i, n, i * quantum, payload,
                zlib.crc32(payload), self.total_bytes))

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    def manifest(self) -> Dict[str, Any]:
        return {"stream_id": self.stream_id, "n_chunks": self.n_chunks,
                "total_bytes": self.total_bytes, "quantum": self.quantum,
                "chunks": [c.manifest_entry() for c in self.chunks]}

    # ------------------------- constructors ------------------------- #
    @classmethod
    def from_array(cls, stream_id: str, arr: np.ndarray,
                   quantum: int = DEFAULT_QUANTUM) -> "ChunkedStream":
        arr = np.ascontiguousarray(arr)
        meta = [("", arr.dtype.str, tuple(arr.shape), 0)]
        return cls(stream_id, arr.tobytes(), meta, quantum)

    @classmethod
    def from_pytree(cls, stream_id: str, tree: PyTree,
                    quantum: int = DEFAULT_QUANTUM) -> "ChunkedStream":
        parts, meta, off = [], [], 0
        for key, arr in _leaf_records(tree):
            raw = arr.tobytes()
            meta.append((key, arr.dtype.str, tuple(arr.shape), off))
            parts.append(raw)
            off += len(raw)
        return cls(stream_id, b"".join(parts), meta, quantum)


class StreamAssembler:
    """Receives chunks (any order, possibly across multiple recovery
    attempts), verifies per-chunk CRCs, and rebuilds the artifact. Chunks
    already accepted survive an interrupted transfer — `missing()` is exactly
    what a resumed transfer still has to move."""

    def __init__(self, stream_id: str, n_chunks: int, total_bytes: int,
                 meta=None):
        self.stream_id = stream_id
        self.n_chunks = n_chunks
        self.total_bytes = total_bytes
        self.meta = meta
        self._parts: Dict[int, StreamChunk] = {}
        self.rejected = 0              # CRC failures

    @classmethod
    def for_stream(cls, stream: ChunkedStream) -> "StreamAssembler":
        return cls(stream.stream_id, stream.n_chunks, stream.total_bytes,
                   stream.meta)

    def offer(self, chunk: StreamChunk) -> bool:
        """Accept a chunk; returns True when it was new and CRC-valid."""
        if chunk.stream_id != self.stream_id:
            return False
        if not chunk.verify():
            self.rejected += 1
            return False
        if chunk.seq in self._parts:
            return False               # duplicate (retransmit): drop
        self._parts[chunk.seq] = chunk
        return True

    @property
    def received(self) -> int:
        return len(self._parts)

    @property
    def received_bytes(self) -> int:
        return sum(c.nbytes for c in self._parts.values())

    def missing(self) -> List[int]:
        return [i for i in range(self.n_chunks) if i not in self._parts]

    @property
    def complete(self) -> bool:
        return not self.missing()

    # ------------------------- reassembly ------------------------- #
    def data(self) -> bytes:
        assert self.complete, \
            f"stream {self.stream_id}: {len(self.missing())} chunks missing"
        return b"".join(self._parts[i].payload for i in range(self.n_chunks))

    def to_array(self) -> np.ndarray:
        assert self.meta and len(self.meta) == 1
        _, dt, shape, _ = self.meta[0]
        return np.frombuffer(self.data(), dtype=np.dtype(dt)).reshape(shape)

    def to_flat_dict(self) -> Dict[str, np.ndarray]:
        assert self.meta is not None, "stream carries no pytree metadata"
        blob = self.data()
        out = {}
        for key, dt, shape, off in self.meta:
            dtype = np.dtype(dt)
            n = int(np.prod(shape)) if shape else 1
            arr = np.frombuffer(blob, dtype=dtype, count=n, offset=off)
            out[key] = arr.reshape(shape)
        return out

    def to_pytree(self, like: PyTree) -> PyTree:
        """Rebuild into the structure of `like` (arrays or structs)."""
        flat = self.to_flat_dict()
        _, treedef = tree_flatten(like)
        return tree_unflatten(treedef, [flat[keystr(p)] for p, _ in
                                        tree_flatten_with_path(like)])


# --------------------------------------------------------------------------- #
# Transport
# --------------------------------------------------------------------------- #
@dataclass
class StreamTicket:
    """Handle for one (possibly partial) stream submission."""
    stream_id: str
    transfers: List[Transfer]
    chunks: List[StreamChunk]
    assembler: Optional[StreamAssembler] = None
    submitted_at: float = 0.0

    @property
    def complete(self) -> bool:
        return all(tr.finished for tr in self.transfers)

    @property
    def finish_time(self) -> Optional[float]:
        """Link-time instant the last chunk landed (None while in flight).
        Exact per hop: the fabric's event-ordered clock forwards and
        finishes each chunk at its true store-and-forward instant, whether
        the window it rode in was ``run(until=...)`` or ``drain()``."""
        if not self.transfers:
            return self.submitted_at
        if not self.complete:
            return None
        return max(tr.t_finish for tr in self.transfers)

    @property
    def delivery_edge(self):
        """The fabric edge that hands this stream to its consumer — the
        last hop of its routed path (`PathTransfer.delivery_edge`). None on
        a single-link transport or for local delivery. Single-path policies
        ("shortest", e.g. instant neighbor shards) put every chunk on the
        same path, so the first routed transfer is authoritative."""
        for tr in self.transfers:
            edge = getattr(tr, "delivery_edge", None)
            if edge is not None:
                return edge
        return None

    @property
    def bytes_moved(self) -> int:
        return sum(c.nbytes for c in self.chunks)


@dataclass
class _PendingChunk:
    """A chunk in flight: its transfer (or multi-hop PathTransfer), payload,
    destination assembler, the ticket it belongs to, and retransmit count."""
    transfer: Any                       # Transfer | PathTransfer
    chunk: StreamChunk
    assembler: Optional[StreamAssembler]
    ticket: Optional[StreamTicket] = None
    attempts: int = 0


@dataclass
class _StripeState:
    """Routing context of one striped (multi-path) stream in flight.

    Kept by `TopologyTransport` for every src+dst split send so the
    transport can re-run the split when the fabric changes under the
    stream: `epoch` is the topology epoch the current chunk allocation was
    computed at — when it trails `topology.epoch`, a `rebalance()` cancels
    the stream's never-started chunks and re-stripes them over the
    surviving paths' residual capacity. `paths` tracks the CURRENT route
    set (refreshed on every re-balance), which is also what NACK
    retransmits pick their least-loaded live path from."""
    ticket: StreamTicket
    src: int
    dst: int
    policy: str
    k: int
    epoch: int
    paths: List[List[Edge]]


class _NackingTransport:
    """Shared delivery + NACK machinery for both transport flavors.

    On delivery, a chunk the assembler rejects on CRC triggers an immediate
    per-chunk retransmit of the pristine payload (`nacks_sent`), bounded by
    `max_retransmits` — chunk-level healing without waiting for a full
    `missing()` resend pass. Byte-flips can be injected for tests via
    `corrupt_once` (the next delivery of that chunk arrives corrupted)."""

    max_retransmits = 8

    def _init_counters(self) -> None:
        self._pending: List[_PendingChunk] = []
        self.streams_sent = 0
        self.train_bytes_submitted = 0.0
        self.state_bytes_submitted = 0.0
        self.chunks_delivered = 0
        self.nacks_sent = 0
        self._corrupt_once: Dict[Tuple[str, int], int] = {}

    def accounting(self) -> Dict[str, float]:
        """Plan-level byte accounting snapshot: what this transport has put
        on the wire so far, by traffic class. Recovery policies diff two
        snapshots around an `execute()` to bill a plan for exactly the
        STATE bytes it streamed (a `ComputeRecovery` bill is zero)."""
        return {
            "train_bytes": float(self.train_bytes_submitted),
            "state_bytes": float(self.state_bytes_submitted),
            "chunks_delivered": float(self.chunks_delivered),
            "nacks_sent": float(self.nacks_sent),
            "streams_sent": float(self.streams_sent),
        }

    def corrupt_once(self, stream_id: str, seq: int, times: int = 1) -> None:
        """Arrange for the next `times` deliveries of (stream_id, seq) to
        arrive with a flipped byte — exercises the CRC-reject -> NACK path
        (and, past `max_retransmits`, the give-up path)."""
        key = (stream_id, seq)
        self._corrupt_once[key] = self._corrupt_once.get(key, 0) + times

    def instant_route(self, wid: int) -> Tuple[Optional[int], Optional[int]]:
        """(src, dst) for worker `wid`'s instant neighbor shard; the plain
        single-link transport has no notion of placement."""
        return None, None

    def _resend(self, pend: "_PendingChunk", t: float) -> None:
        raise NotImplementedError

    def _open_ticket(self, stream: ChunkedStream, t: float,
                     assembler: Optional[StreamAssembler],
                     seqs: Optional[Sequence[int]]
                     ) -> Tuple[List[StreamChunk], StreamTicket]:
        """Resolve the chunk subset (default: what the assembler is still
        missing) and open its ticket. The ticket is retained only while its
        chunks are in flight — holding every ticket (and its payloads) for
        the life of the transport would pin gigabytes over a long run."""
        if seqs is None:
            seqs = (assembler.missing() if assembler is not None
                    else range(stream.n_chunks))
        chunks = [stream.chunks[i] for i in seqs]
        return chunks, StreamTicket(stream.stream_id, [], chunks, assembler,
                                    submitted_at=t)

    def _drain_links(self) -> float:
        raise NotImplementedError

    def _links_idle(self) -> bool:
        raise NotImplementedError

    def drain(self, max_rounds: int = 16) -> float:
        """Run the link(s) until every stream — NACK retransmits and
        multi-hop forwards included — has landed; returns the clock. The
        fabric itself drains in a single event-ordered pass (multi-hop
        chains complete inside one `_drain_links` call); the loop here only
        re-runs for chunks the delivery step re-submitted (CRC-rejected
        NACK resends), so it is bounded by `max_retransmits`."""
        for _ in range(max_rounds):
            t = self._drain_links()
            if self.pump() == 0 and self._links_idle():
                return t
        raise RuntimeError(f"{type(self).__name__}.drain did not converge "
                           "(unbounded retransmission?)")

    def _deliver(self, pend: "_PendingChunk", t: float) -> None:
        """Offer a landed chunk to its assembler; NACK-retransmit on CRC
        rejection."""
        asm = pend.assembler
        if asm is None:
            return
        chunk = pend.chunk
        key = (chunk.stream_id, chunk.seq)
        wire_chunk = chunk
        if self._corrupt_once.get(key, 0) > 0 and chunk.payload:
            self._corrupt_once[key] -= 1
            if self._corrupt_once[key] <= 0:
                del self._corrupt_once[key]
            flipped = bytes([chunk.payload[0] ^ 0xFF]) + chunk.payload[1:]
            wire_chunk = dataclasses.replace(chunk, payload=flipped)
        rejected_before = asm.rejected
        accepted = asm.offer(wire_chunk)
        if accepted or asm.rejected == rejected_before:
            return                      # landed, or duplicate: nothing owed
        if pend.attempts < self.max_retransmits:
            self.nacks_sent += 1
            self._resend(pend, t)

    def pump(self) -> int:
        """Deliver every finished chunk to its assembler (NACK-resending CRC
        rejects)."""
        delivered = 0
        still = []
        for pend in self._pending:
            if pend.transfer.finished:
                self._deliver(pend, pend.transfer.t_finish)
                delivered += 1
            else:
                still.append(pend)
        self._pending = still
        self.chunks_delivered += delivered
        return delivered


class StreamTransport(_NackingTransport):
    """Shared single-link transport. One `LinkScheduler` carries BOTH the
    train loop's allreduce volume (TRAIN, preempting) and every checkpoint
    stream (STATE, chunk-granular). Finished STATE transfers are pumped into
    their stream's assembler, so data delivery and link timing come from the
    same simulation."""

    def __init__(self, scheduler: LinkScheduler):
        self.scheduler = scheduler
        self._init_counters()

    # ------------------------- submission ------------------------- #
    def submit_train(self, nbytes: float, t: float) -> Transfer:
        self.train_bytes_submitted += nbytes
        return self.scheduler.submit("TRAIN", nbytes, t)

    def send(self, stream: ChunkedStream, t: float,
             assembler: Optional[StreamAssembler] = None,
             seqs: Optional[Sequence[int]] = None,
             src: Optional[int] = None, dst: Optional[int] = None,
             policy: str = "split", k: Optional[int] = None) -> StreamTicket:
        """Submit a stream's chunks as STATE traffic at link-time `t`
        (seconds; chunk sizes in bytes).

        `seqs` restricts to a subset of chunk indices — used to resume a
        partial transfer (send only `assembler.missing()`) or to model a
        transfer interrupted after N chunks. `src`/`dst`/`policy`/`k` are
        accepted for interface parity with `TopologyTransport` and ignored
        (one link has no routing)."""
        chunks, ticket = self._open_ticket(stream, t, assembler, seqs)
        for c in chunks:
            tr = self.scheduler.submit("STATE", float(c.nbytes), t)
            ticket.transfers.append(tr)
            self._pending.append(_PendingChunk(tr, c, assembler, ticket))
            self.state_bytes_submitted += c.nbytes
        self.streams_sent += 1
        return ticket

    def _resend(self, pend: _PendingChunk, t: float) -> None:
        tr = self.scheduler.submit("STATE", float(pend.chunk.nbytes), t)
        if pend.ticket is not None:
            pend.ticket.transfers.append(tr)
        self._pending.append(_PendingChunk(tr, pend.chunk, pend.assembler,
                                           pend.ticket, pend.attempts + 1))
        self.state_bytes_submitted += pend.chunk.nbytes

    # ------------------------- progress ------------------------- #
    def pump(self) -> int:
        delivered = super().pump()
        if delivered:
            # prune the scheduler's done-list (a long run finishes millions
            # of chunk transfers; nothing needs them once delivered)
            self.scheduler.done.clear()
        return delivered

    def run(self, until: float) -> float:
        busy = self.scheduler.run(until)
        self.pump()
        return busy

    def _drain_links(self) -> float:
        return self.scheduler.drain()

    def _links_idle(self) -> bool:
        return self.scheduler.idle


class TopologyTransport(_NackingTransport):
    """Per-link transport: streams are routed onto `LinkTopology` /
    `PodFabric` edge paths.

    Routing rules (ISSUE 2, tiered + bidirectional since ISSUE 3, k-path
    striped since ISSUE 10):
      * instant neighbor shards — the adjacent ring edge (`instant_route`,
        ``policy="shortest"``: one hop, nothing to split);
      * recovery fetches (src AND dst given) — split across up to `k`
        edge-disjoint live paths (default ``route_k=2``: both ring
        directions; on a `PodFabric` both ways around the gateway ring, and
        with `dcn_uplinks > 1` up to k=4 over the slack uplink rings) with
        bytes divided by residual bandwidth (`LinkTopology.split_bytes`),
        chunks striped path-by-path in share order;
      * lazy backups (src given, dst None) — split across the source's
        incident live edges by residual bandwidth: the state drains onto
        whichever tier (ICI ring direction or DCN uplink) has slack;
      * full artifacts (no src/dst) — the least-loaded live edge by queued
        drain seconds, tier-aware (a TRAIN-saturated ICI ring loses to an
        idle DCN hop).

    Striped streams additionally RE-BALANCE mid-transfer: every src+dst
    split send records its route set + the topology epoch it was computed
    at (`_StripeState`), and when the fabric changes under an in-flight
    stream — a `set_bandwidth` (gray-link degrade), a reliability-
    controller quarantine (`fail_edge`), any dark-state change — the next
    `run`/`drain` notices the epoch mismatch and `rebalance()` cancels the
    stream's never-started chunks (`LinkTopology.cancel_path`), re-runs
    the split over the surviving paths' residual capacity, and re-submits
    them. Bytes already delivered or on the wire are never re-sent, ticket
    accounting stays exact, and the re-balance itself bumps no epoch, so
    compiled `TrafficPlan`s stay valid.

    TRAIN volume is submitted edge-by-edge (`submit_train` loads every live
    ring edge with the per-edge allreduce bytes; `submit_train_tiers` loads
    each tier with its own hierarchical-allreduce volume), so a hotspot edge
    delays exactly the streams crossing it."""

    def __init__(self, topology: LinkTopology, route_k: int = 2,
                 auto_rebalance: bool = True):
        self.topology = topology
        self.route_k = route_k          # default split width for send/routes
        self.auto_rebalance = auto_rebalance
        self.rebalances = 0             # re-balance passes that moved chunks
        self.chunks_rebalanced = 0      # chunks reassigned across all passes
        self._stripes: List[_StripeState] = []
        self._init_counters()

    # ------------------------- submission ------------------------- #
    def submit_train(self, nbytes_per_edge: float, t: float) -> List[Transfer]:
        trs = self.topology.submit_train_ring(nbytes_per_edge, t)
        self.train_bytes_submitted += nbytes_per_edge * len(trs)
        return trs

    def submit_train_tiers(self, tier_bytes, t: float) -> List[Transfer]:
        """Hierarchical allreduce: per-edge TRAIN bytes by tier
        ({TIER_ICI: ..., TIER_DCN: ...}, bytes per edge)."""
        trs = self.topology.submit_train_tiers(tier_bytes, t)
        self.train_bytes_submitted += sum(tr.size for tr in trs)
        return trs

    def submit_train_edge(self, u: int, v: int, nbytes: float, t: float
                          ) -> Transfer:
        self.train_bytes_submitted += nbytes
        return self.topology.submit_train_edge(u, v, nbytes, t)

    def instant_route(self, wid: int) -> Tuple[int, int]:
        """Worker `wid`'s instant shard arrives from its DP-ring predecessor
        over the adjacent edge."""
        return (wid - 1) % self.topology.n, wid

    def routes(self, src: Optional[int], dst: Optional[int], nbytes: float,
               policy: str = "split", k: Optional[int] = None
               ) -> List[Tuple[List[Edge], float]]:
        """Resolve the edge paths a `nbytes` stream rides and the byte share
        each carries. Returns [(path, share_bytes), ...]; an empty path is
        local delivery. `k` is the routing budget for the split policy —
        the maximum number of edge-disjoint paths to stripe across
        (defaults to the transport's `route_k`); fewer may exist."""
        topo = self.topology
        if k is None:
            k = self.route_k
        if src is not None and dst is not None:
            if src == dst:
                return [([], nbytes)]
            if policy == "shortest":
                return [(topo.path(src, dst), nbytes)]
            paths = topo.disjoint_paths(src, dst, k=k)
            if not paths:
                raise RoutingError(
                    f"no live path {src} -> {dst} "
                    f"(dark nodes {sorted(topo.dark_nodes)}, "
                    f"dark edges {sorted(topo.dark_edges)})",
                    src=src, dst=dst, dark_nodes=topo.dark_nodes,
                    dark_edges=topo.dark_edges)
            shares = topo.split_bytes(paths, nbytes)
            return [(p, s) for p, s in zip(paths, shares) if s > 0] \
                or [(paths[0], nbytes)]
        if src is not None:
            # lazy backup: fan out over the source's incident live edges by
            # residual bandwidth — both ring directions, and on a PodFabric
            # a gateway's DCN uplinks too (tier slack, not topology habit)
            fans = [[edge_key(src, nb)] for nb in topo.neighbors(src)]
            if not fans:
                return [([], nbytes)]   # isolated node: local delivery
            shares = topo.split_bytes(fans, nbytes)
            return [(p, s) for p, s in zip(fans, shares) if s > 0] \
                or [(fans[0], nbytes)]
        if not topo.live_edges():
            return [([], nbytes)]       # single-node fabric: local delivery
        # full artifacts: least queued drain-seconds (TRAIN included), so
        # they stay off busy training edges and off slow tiers
        return [([topo.least_loaded_edge()], nbytes)]

    def send(self, stream: ChunkedStream, t: float,
             assembler: Optional[StreamAssembler] = None,
             seqs: Optional[Sequence[int]] = None,
             src: Optional[int] = None, dst: Optional[int] = None,
             policy: str = "split", k: Optional[int] = None) -> StreamTicket:
        """Submit a stream's chunks as STATE traffic along routed edge paths
        at link-time `t` (seconds).

        With `src`/`dst` the chunks ride up to `k` edge-disjoint live paths
        between the two nodes (store-and-forward per hop; `k` defaults to
        the transport's `route_k`), bytes split by residual bandwidth and
        chunks striped path-by-path; ``policy="shortest"`` forces the
        single BFS path. With only `src`, chunks fan out over its incident
        edges (lazy placement). `seqs` resumes a partial transfer, as in
        `StreamTransport.send`. Striped sends register for mid-transfer
        re-balancing (see class docstring)."""
        chunks, ticket = self._open_ticket(stream, t, assembler, seqs)
        nbytes = float(sum(c.nbytes for c in chunks))
        routed = self.routes(src, dst, nbytes, policy, k)
        self._stripe(chunks, routed, t, assembler, ticket, count_bytes=True)
        if src is not None and dst is not None and src != dst \
                and policy == "split":
            self._stripes.append(_StripeState(
                ticket, src, dst, policy,
                self.route_k if k is None else k, self.topology.epoch,
                [p for p, _ in routed]))
        self.streams_sent += 1
        return ticket

    def _stripe(self, chunks: Sequence[StreamChunk],
                routed: Sequence[Tuple[List[Edge], float]], t: float,
                assembler: Optional[StreamAssembler],
                ticket: StreamTicket, *, count_bytes: bool,
                attempts_by_seq: Optional[Dict[int, int]] = None) -> None:
        """Hand chunks to paths in order, each path taking its byte share.
        `count_bytes=False` replays chunks a re-balance withdrew before
        they moved — already billed at their original submission, so
        re-striping them must not double-count `state_bytes_submitted`
        (`attempts_by_seq` likewise carries their retransmit counts over)."""
        quota = [share for _, share in routed]
        which = 0
        for c in chunks:
            while which < len(routed) - 1 and quota[which] < c.nbytes / 2:
                which += 1
            quota[which] -= c.nbytes
            path = routed[which][0]
            pt = self.topology.submit_path("STATE", float(c.nbytes), t, path)
            ticket.transfers.append(pt)
            if count_bytes:
                self.state_bytes_submitted += c.nbytes
            pend = _PendingChunk(
                pt, c, assembler, ticket,
                attempts_by_seq.get(c.seq, 0) if attempts_by_seq else 0)
            if pt.finished:             # empty path: local, lands instantly
                self._deliver(pend, t)
                self.chunks_delivered += 1
            else:
                self._pending.append(pend)

    # ------------------------- re-balancing ------------------------- #
    def _stripe_of(self, ticket: Optional[StreamTicket]
                   ) -> Optional[_StripeState]:
        for st in self._stripes:
            if st.ticket is ticket:
                return st
        return None

    def _path_load(self, path: Sequence[Edge]) -> float:
        """A path's start offset in split_bytes' model: worst per-edge
        queued drain seconds plus summed delivery latency."""
        topo = self.topology
        return max(topo.links[e].pending_bytes() / topo.links[e].bw
                   for e in path) \
            + sum(topo.links[e].latency for e in path)

    def _maybe_rebalance(self) -> None:
        """Re-balance when the fabric changed under an in-flight striped
        stream — the topology epoch moved past the epoch a stripe's chunk
        allocation was computed at (degrades, quarantines, dark-state
        changes all bump it)."""
        if not (self.auto_rebalance and self._stripes):
            return
        epoch = self.topology.epoch
        if any(st.epoch != epoch for st in self._stripes):
            self.rebalance()

    def rebalance(self, t: Optional[float] = None) -> int:
        """Re-run the k-path split for every striped in-flight stream over
        the CURRENT topology and reassign the chunks that have not started
        moving (withdrawable via `LinkTopology.cancel_path`) — delivered or
        on-the-wire bytes are never re-sent. Re-submission happens at `t`
        (default: the fabric clock, i.e. the instant the change was
        noticed), never before a chunk's original submit time. Returns the
        number of chunks reassigned; cancel/resubmit is pure queue surgery,
        so no topology epoch is bumped and compiled plans stay valid."""
        t_now = self.topology.clock if t is None else t
        moved = 0
        for st in self._stripes:
            moved += self._rebalance_stripe(st, t_now)
        if moved:
            self.rebalances += 1
            self.chunks_rebalanced += moved
        return moved

    def _rebalance_stripe(self, st: _StripeState, t: float) -> int:
        st.epoch = self.topology.epoch
        withdrawn: List[Tuple[_PendingChunk, PathTransfer]] = []
        for pend in self._pending:
            if pend.ticket is st.ticket and \
                    isinstance(pend.transfer, PathTransfer):
                old = pend.transfer
                if self.topology.cancel_path(old):
                    withdrawn.append((pend, old))
        if not withdrawn:
            return 0
        gone_pend = {id(p) for p, _ in withdrawn}
        self._pending = [p for p in self._pending
                         if id(p) not in gone_pend]
        gone_tr = {id(old) for _, old in withdrawn}
        st.ticket.transfers = [tr for tr in st.ticket.transfers
                               if id(tr) not in gone_tr]
        chunks = [p.chunk for p, _ in withdrawn]
        attempts = {p.chunk.seq: p.attempts for p, _ in withdrawn}
        assembler = withdrawn[0][0].assembler
        nbytes = float(sum(c.nbytes for c in chunks))
        # never submit before the chunks' original submit time
        t_sub = max(t, max(old.t_submit for _, old in withdrawn))
        try:
            routed = self.routes(st.src, st.dst, nbytes, st.policy, st.k)
        except RoutingError:
            # destination cut off: put the chunks back on their old paths
            # (they will NACK/stall exactly as the static allocation would)
            for pend, old in withdrawn:
                pt = self.topology.submit_path(
                    "STATE", float(pend.chunk.nbytes),
                    max(t, old.t_submit), old.path)
                st.ticket.transfers.append(pt)
                self._pending.append(_PendingChunk(
                    pt, pend.chunk, pend.assembler, st.ticket,
                    pend.attempts))
            return 0
        st.paths = [p for p, _ in routed]
        self._stripe(chunks, routed, t_sub, assembler, st.ticket,
                     count_bytes=False, attempts_by_seq=attempts)
        return len(chunks)

    def _retransmit_path(self, st: _StripeState,
                         fallback: Tuple[Edge, ...]) -> Sequence[Edge]:
        """The current least-loaded LIVE path of a striped stream's route
        set — where its NACK retransmits go, so resends also benefit from
        re-balancing instead of pinning to the (possibly degraded or
        quarantined) original path."""
        live = [p for p in st.paths
                if p and all(self.topology.edge_up(*e) for e in p)]
        if not live:
            live = [p for p in
                    self.topology.disjoint_paths(st.src, st.dst, st.k) if p]
            if not live:
                return fallback
            st.paths = live
        return min(live, key=lambda p: (self._path_load(p), p))

    def _resend(self, pend: _PendingChunk, t: float) -> None:
        path: Sequence[Edge] = pend.transfer.path \
            if isinstance(pend.transfer, PathTransfer) else ()
        st = self._stripe_of(pend.ticket)
        if st is not None:
            path = self._retransmit_path(st, tuple(path))
        pt = self.topology.submit_path("STATE", float(pend.chunk.nbytes), t,
                                       path)
        if pend.ticket is not None:
            pend.ticket.transfers.append(pt)
        nxt = _PendingChunk(pt, pend.chunk, pend.assembler, pend.ticket,
                            pend.attempts + 1)
        self.state_bytes_submitted += pend.chunk.nbytes
        if pt.finished:
            self._deliver(nxt, t)
            self.chunks_delivered += 1
        else:
            self._pending.append(nxt)

    # ------------------------- progress ------------------------- #
    def pump(self) -> int:
        delivered = super().pump()
        if delivered:
            # prune every edge's done-list (counters survive; a long run
            # finishes millions of chunk transfers nothing needs afterwards)
            for sch in self.topology.links.values():
                sch.done.clear()
            # retire routing state of streams with nothing left in flight
            self._stripes = [st for st in self._stripes
                             if any(p.ticket is st.ticket
                                    for p in self._pending)]
        return delivered

    def run(self, until: float) -> float:
        self._maybe_rebalance()
        busy = self.topology.run(until)
        self.pump()
        return busy

    def _drain_links(self) -> float:
        self._maybe_rebalance()
        return self.topology.drain()

    def _links_idle(self) -> bool:
        return self.topology.idle


def stream_pytree(transport: StreamTransport, stream_id: str, tree: PyTree,
                  t: float, quantum: int = DEFAULT_QUANTUM
                  ) -> Tuple[StreamTicket, StreamAssembler]:
    """Chunk a pytree and put it on the wire; returns (ticket, assembler)."""
    stream = ChunkedStream.from_pytree(stream_id, tree, quantum)
    asm = StreamAssembler.for_stream(stream)
    ticket = transport.send(stream, t, assembler=asm)
    return ticket, asm
